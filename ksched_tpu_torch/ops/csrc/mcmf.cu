// The general-graph MCMF solve as one cooperative CUDA kernel on Hopper.
//
// Replaces ksched_tpu/ops/mcmf_pallas.py::_mcmf_kernel (the pl.pallas_call
// in mcmf_loop_pallas): Bellman-Ford price tightening (at most
// `tighten_sweeps` sweeps), a saturate, then the eps-scaling phase loop of
// synchronous push/relabel supersteps, all in one launch. It computes what
// the Pallas kernel computes, bit for bit: flow, steps, converged and
// p_overflow (and so the scan-CSR solve of solver/csr_solver.py).
//
// Layout. The residual entries (each arc's forward and backward entry),
// sorted by source node, are the kernel's inputs, one int32 table each:
// sign (+1 / -1, 0 on the pad), cap, signed scaled cost, source supply,
// the segment id of the entry's source node (segments are the contiguous
// runs the head flags open; the pad entries form one trailing segment),
// the partner entry (the same arc's other entry) and the partner's
// segment id. Per entry the kernel keeps the arc's flow; per segment the
// source node's potential; the excess is the segment's supply less its
// flow sum. The one cross-entry read of the TPU kernel, perm(x) =
// x[partner], becomes p[pseg] (a price) or delta[partner] (a push).
//
// The grid. One block of 1024 threads per SM, launched cooperatively so
// that every block is resident, as many blocks as the entries need at 32
// per warp (ops/mcmf.py mcmf_grid). Global warp w owns `chunk` consecutive
// entries (a multiple of 32), so each block owns a contiguous range; the
// per-segment loops stride over the whole grid. Blocks meet at grid
// barriers (Grid::sync: one atomic per block on a counter in the scratch
// header); a grid-wide decision (any node active, any price changed) is
// an atomicMax of the decision's ordinal into a header word before the
// barrier, read back after it. Every table one block writes and another
// reads is read only after a barrier, through ordinary coherent loads.
//
// Segment reductions. Integer add (mod 2^32), max and min are associative
// and commutative, so any order gives the Pallas kernel's bits: the
// lanes of a warp reduce the runs of equal segment among their 32
// consecutive entries and each run's last lane applies the run's value to
// the segment's accumulator with one atomic, from whichever SM holds it.
// The maximal-push prefix (the exclusive in-segment sum of admissible
// residuals) is ordered and carried on three levels: a warp scans its
// chunk 32 at a time with a running carry; pass B leaves each warp's tail
// (its sum since its last segment head) in shared memory and each block's
// (its warps' tails back to its last warp with a head) and head flag in
// global memory; pass C starts each warp from the warp tails back to the
// last earlier warp of its block with a head or, where there is none,
// from all of them plus the block tails back to the last earlier block
// with a head (the warp reads those 32 at a time).
//
// A superstep is three passes over the entries and three grid barriers:
// B (excess test, residuals, admissibility, relabel bounds, tails; the
// active test rides on its barrier), C (the pushes) and D (the flows,
// the next flow sums, then the relabels). What bounds it on this card:
// at the 10k x 1k shape (R = 256 rows of 512 lanes: 131,072 entries,
// 128 blocks, one 32-entry step per warp per pass) the three barriers and
// each pass's chain of dependent L2 gathers and atomics, not bytes (the 21
// live tables take 11 MB, inside the 50 MB L2) nor arithmetic: 13.6 us a
// superstep on an H100, 4.8 of them in barriers (PERF.md).
//
// The soltel ring (ksched_tpu/ops/mcmf_pallas.py's fifth output): with
// tel_cap > 0 (the kTel instantiation) every active superstep writes one
// int32 row of 8 at ring row steps % tel_cap: eps, the segments with
// positive excess and their excess sum (read at the superstep's start,
// in pass B), the units pushed (pass C), the segments relabelled (pass
// D), the forward entries with zero residual before the push and the
// admissible entries (pass B), and a 0. A phase change writes no row.
// Each thread counts in registers; a warp sums its counts and adds them
// to the block's words in shared memory; each block adds those, once per
// grid barrier the superstep already has (Grid::sync flushes them before
// it arrives), into six header words. The six words are double-buffered
// by step parity: block 0's thread 0 reads and clears the last
// superstep's buffer at the top of the next iteration (or, for the last
// superstep, after the loop) and writes its row, and clears the current
// buffer when the iteration turns out to be a phase change. No barrier is
// added (result[3] is the same with the ring on and off), and integer
// atomics give the same bits in any order. With tel_cap = 0 the kernel
// counts nothing.
//
// Arithmetic is int32 with two's-complement wrap (transport_common.cuh's
// helpers), as in the JAX package. Sentinels: BIG = 1 << 30,
// BIG_D = 1 << 28, the potential guard 1 << 30.

#include <climits>

#include "transport_common.cuh"

namespace {

constexpr int kPGuard = 1 << 30;

__device__ __forceinline__ int wneg(int a) {
  return static_cast<int>(0u - static_cast<unsigned>(a));
}
__device__ __forceinline__ int wabs(int a) { return a < 0 ? wneg(a) : a; }
// sign * x for sign in {-1, 0, +1}
__device__ __forceinline__ int smul(int sign, int x) {
  return sign > 0 ? x : (sign < 0 ? wneg(x) : 0);
}
__device__ __forceinline__ int resid(int sign, int cap, int f) {
  return sign > 0 ? wsub(cap, f) : (sign < 0 ? f : 0);
}

struct Add {
  __device__ int operator()(int a, int b) const { return wadd(a, b); }
  __device__ void atomic(int* p, int v) const { atomicAdd(p, v); }
};
struct Max {
  __device__ int operator()(int a, int b) const { return max(a, b); }
  __device__ void atomic(int* p, int v) const { atomicMax(p, v); }
};
struct Min {
  __device__ int operator()(int a, int b) const { return min(a, b); }
  __device__ void atomic(int* p, int v) const { atomicMin(p, v); }
};

// Each lane holds one entry of segment s (s < 0 on lanes past the end of
// the chunk); a segment's lanes are contiguous. Reduces v over each run of
// equal s and applies the run's value to acc[s] from its last lane.
template <class Op>
__device__ __forceinline__ void run_reduce(int s, int v, int* acc, Op op) {
  const int lane = threadIdx.x & 31;
  const int below = __shfl_up_sync(kFull, s, 1);
  const unsigned starts = __ballot_sync(kFull, lane == 0 || below != s);
  const int rs = 31 - __clz(starts & (kFull >> (31 - lane)));
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(kFull, v, d);
    if (lane - d >= rs) v = op(t, v);
  }
  const bool last = lane == 31 || ((starts >> (lane + 1)) & 1u);
  if (last && s >= 0) op.atomic(acc + s, v);
}

// In-segment inclusive sum of v over the warp's 32 lanes, segments opened
// by `head`; lanes before the warp's first head continue `carry`, the sum
// of the segment's entries before lane 0. Returns the inclusive value and
// moves carry to lane 31's.
__device__ __forceinline__ int head_scan(int v, bool head, int& carry) {
  const int lane = threadIdx.x & 31;
  const unsigned upto = __ballot_sync(kFull, head) & (kFull >> (31 - lane));
  const int rs = upto ? 31 - __clz(upto) : 0;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(kFull, v, d);
    if (lane - d >= rs) v = wadd(t, v);
  }
  if (!upto) v = wadd(v, carry);
  carry = __shfl_sync(kFull, v, 31);
  return v;
}

// The carry into block b's first entry: the block tails back to the last
// block before b with a segment head (block 0 always has one: entry 0
// opens a segment). Called by a whole warp; 32 blocks per step.
__device__ int block_carry(const int* btail, const int* bflag, int b) {
  const int lane = threadIdx.x & 31;
  int sum = 0;
  for (int top = b - 1; top >= 0; top -= 32) {
    const int j = top - lane;  // lane 0 holds the nearest block
    const int t = j >= 0 ? btail[j] : 0;
    const unsigned heads = __ballot_sync(kFull, j >= 0 && bflag[j] != 0);
    if (heads) {
      const int first = __ffs(heads) - 1;
      return wadd(sum, warp_sum(lane <= first ? t : 0));
    }
    sum = wadd(sum, warp_sum(t));
  }
  return sum;
}

// header words in front of the per-block slots: the barrier counter, the
// decision flag, the end flags, then the soltel counters of cols 1..6 in
// two buffers (all zeroed before each launch)
constexpr int kTelCounters = 6;
constexpr int kBarWord = 0, kFlagWord = 1, kEndWord = 2, kTelWord = 3,
              kHeadWords = kTelWord + 2 * kTelCounters;

__device__ __forceinline__ unsigned ld_acquire(const int* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// The grid's barriers and grid-wide decisions. Every block takes the same
// branches, so every block meets every barrier and counts the same
// decisions. With kTel, a barrier also adds the block's soltel counts
// (s_tel, in shared memory) to the header buffer `tel_add`.
template <bool kTel = false>
struct Grid {
  int* hdr;
  int* s_tel = nullptr;    // kTelCounters words of shared memory
  int* tel_add = nullptr;  // the header buffer they are added to
  int barriers = 0;   // barriers met so far
  int decisions = 0;  // decisions taken so far

  // All blocks meet: what any block wrote before it is visible to every
  // block after it. One atomic per block on a counter whose top bit flips
  // when the last block arrives (block 0 adds 2^31 - (blocks - 1), every
  // other block 1), as cooperative_groups' grid sync does; the counter
  // starts at 0. Returns header word `word` as read after the barrier.
  __device__ int sync(int word = kFlagWord) {
    __shared__ int s_word;
    __syncthreads();
    if (threadIdx.x == 0) {
      if constexpr (kTel) {
        for (int k = 0; k < kTelCounters; ++k) {
          if (s_tel[k]) atomicAdd(tel_add + k, s_tel[k]);
          s_tel[k] = 0;
        }
      }
      const unsigned add = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
      unsigned* bar = reinterpret_cast<unsigned*>(hdr + kBarWord);
      __threadfence();
      const unsigned old = atomicAdd(bar, add);
      while (((old ^ ld_acquire(hdr + kBarWord)) & 0x80000000u) == 0) {
      }
      __threadfence();
      s_word = static_cast<int>(ld_acquire(hdr + word));
    }
    __syncthreads();
    ++barriers;
    return s_word;
  }

  // Whether `mine` (read on thread 0) holds on any block. The decision's
  // ordinal grows, so the flag word never needs a reset; the kernel puts
  // a barrier between one decision's read and the next one's writes.
  __device__ bool any_block(bool mine) {
    const int d = ++decisions;
    if (threadIdx.x == 0 && mine) atomicMax(hdr + kFlagWord, d);
    return sync() == d;
  }
  __device__ bool any(bool v) { return any_block(__syncthreads_or(v) != 0); }
};

struct Args {
  const int* sign;     // [E] +1 fwd, -1 bwd, 0 pad
  const int* cap;      // [E] arc capacity per entry
  const int* sc;       // [E] signed scaled cost per entry
  const int* sup;      // [E] source-node supply per entry
  const int* seg;      // [E] segment id (nondecreasing, from 0)
  const int* pseg;     // [E] the partner entry's segment id
  const int* partner;  // [E] the partner entry
  const int* hs;       // [E] segment-start flags
  const int* f0;       // [E] start flow per entry
  int* f;              // [E] out: flow per entry
  int* result;         // [4] out: steps, converged, p_overflow, barriers
  int* scratch;        // ksched_mcmf_scratch_words(E, blocks) words
  int* tel;            // [tel_cap, 8] out: the soltel ring (zeroed)
  int E, eps0, alpha, max_supersteps, tighten_sweeps, chunk, tel_cap;
};

// soltel counter slots (cols 1..6 of a row) in s_tel and the buffers
enum { kTActive, kTExcess, kTPushed, kTRelabels, kTSaturated, kTWork };

// add a warp's sum of v to the block's counter k (kTel only)
template <bool kTel>
__device__ __forceinline__ void tel_count(int* s_tel, int k, int v) {
  if constexpr (kTel) {
    v = warp_sum(v);
    if ((threadIdx.x & 31) == 0 && v) atomicAdd(s_tel + k, v);
  }
}

// one ring row at `step`: eps, then cols 1..6 from `buf`, read and cleared
__device__ void tel_row(int* ring, int cap, int step, int eps, int* buf) {
  int* row = ring + 8 * (step % cap);
  row[0] = eps;
  for (int k = 0; k < kTelCounters; ++k) row[1 + k] = atomicExch(buf + k, 0);
  row[7] = 0;
}

// scratch tables of E words: delta, radm (per entry); sup, p, d, acc0, acc1,
// sumr, best, pushed, mins (per segment; E bounds their count); then the
// header words and two slots per block (its tail and head flag)
constexpr int kScratchTables = 11;

template <bool kTel>
__global__ void __launch_bounds__(kThreads, 1) mcmf_kernel(Args a) {
  __shared__ int s_tail[kWarps];
  __shared__ int s_flag[kWarps];
  __shared__ int s_tel[kTelCounters];
  if (threadIdx.x < kTelCounters) s_tel[threadIdx.x] = 0;
  const int E = a.E;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nseg = a.seg[E - 1] + 1;
  // global warp gw owns entries [wbeg, wend): `chunk` (a multiple of 32)
  // each, so block b owns a contiguous range
  const int gw = blockIdx.x * kWarps + warp;
  const int wbeg = min(E, gw * a.chunk), wend = min(E, wbeg + a.chunk);
  // per-segment (and per-entry elementwise) loops stride over the grid
  const int g0 = blockIdx.x * kThreads + tid, gstride = gridDim.x * kThreads;

  int* delta = a.scratch;
  int* radm = delta + E;
  int* sup_s = radm + E;
  int* p_s = sup_s + E;
  int* d_s = p_s + E;
  int* acc0 = d_s + E;  // flow sums, double-buffered across supersteps
  int* acc1 = acc0 + E;
  int* sumr = acc1 + E;
  int* best = sumr + E;
  int* pushed = best + E;
  int* mins = pushed + E;
  int* btail = mins + E + kHeadWords;
  int* bflag = btail + gridDim.x;
  int* f = a.f;
  Grid<kTel> grid{mins + E, s_tel};
  int* const tel_buf = grid.hdr + kTelWord;  // two buffers of kTelCounters
  const bool tel_writer = kTel && blockIdx.x == 0 && tid == 0;

  // the excess of segment s under the flow sums acc
  auto excess = [&](const int* acc_c, int s) { return wsub(sup_s[s], acc_c[s]); };

  // ---- prologue: flow, segment supplies, the start excess ----
  for (int s = g0; s < nseg; s += gstride) {
    acc0[s] = 0;
    mins[s] = INT_MAX;
    sumr[s] = 0;
    best[s] = INT_MIN;
    pushed[s] = 0;
  }
  for (int i = g0; i < E; i += gstride) {
    f[i] = a.f0[i];
    if (i == 0 || a.hs[i]) sup_s[a.seg[i]] = a.sup[i];
  }
  grid.sync();
  for (int b = wbeg; b < wend; b += 32) {
    const int i = b + lane;
    const bool ok = i < wend;
    run_reduce(ok ? a.seg[i] : -1, ok ? smul(a.sign[i], a.f0[i]) : 0, acc0, Add());
  }
  grid.sync();

  // ---- tighten: Bellman-Ford over residual reduced costs ----
  for (int s = g0; s < nseg; s += gstride)
    d_s[s] = excess(acc0, s) < 0 ? 0 : kBigD;
  grid.sync();
  bool changed = true;
  for (int it = 0; changed && it < a.tighten_sweeps; ++it) {
    for (int b = wbeg; b < wend; b += 32) {
      const int i = b + lane;
      const bool ok = i < wend;
      int cand = kBigD;
      if (ok && resid(a.sign[i], a.cap[i], f[i]) > 0)
        cand = wadd(a.sc[i], d_s[a.pseg[i]]);
      run_reduce(ok ? a.seg[i] : -1, cand, mins, Min());
    }
    grid.sync();
    bool ch = false;
    for (int s = g0; s < nseg; s += gstride) {
      const int d = d_s[s];
      const int d2 = max(min(d, mins[s]), -kBigD);
      ch |= d2 != d;
      d_s[s] = d2;
      mins[s] = INT_MAX;
    }
    changed = grid.any(ch);
  }
  for (int s = g0; s < nseg; s += gstride) {
    p_s[s] = wneg(min(d_s[s], kBigD));
    acc0[s] = 0;
  }
  grid.sync();

  // saturate every residual entry with a nonzero reduced cost (rc < 0:
  // full, rc > 0: empty) and accumulate the new flow's per-segment sum
  auto saturate = [&](int* acc_out) {
    for (int b = wbeg; b < wend; b += 32) {
      const int i = b + lane;
      const bool ok = i < wend;
      int s = -1, v = 0;
      if (ok) {
        s = a.seg[i];
        const int sg = a.sign[i];
        const int rcf = smul(sg, wsub(wadd(a.sc[i], p_s[s]), p_s[a.pseg[i]]));
        const int fi = rcf < 0 ? a.cap[i] : (rcf > 0 ? 0 : f[i]);
        f[i] = fi;
        v = smul(sg, fi);
      }
      run_reduce(s, v, acc_out, Add());
    }
  };
  saturate(acc0);
  grid.sync();

  // ---- the phase loop ----
  int eps = a.eps0, steps = 0, cur = 0;
  bool done = false, pending = false;  // pending: a superstep's row unwritten
  while (steps < a.max_supersteps) {
    const int* acc_c = cur ? acc1 : acc0;
    int* acc_n = cur ? acc0 : acc1;
    if constexpr (kTel) {
      // the last superstep's counts are complete (its barriers are met)
      if (tel_writer && pending)
        tel_row(a.tel, a.tel_cap, steps - 1, eps,
                tel_buf + kTelCounters * ((steps - 1) & 1));
      pending = false;
      grid.tel_add = tel_buf + kTelCounters * (steps & 1);
    }
    // pass B: the active test, residuals, admissibility, the relabel
    // bounds, chunk tails (acc_n was last read before the last barrier)
    bool act = false;
    int t_act = 0, t_exc = 0, t_sat = 0, t_work = 0;
    for (int s = g0; s < nseg; s += gstride) {
      const int e = excess(acc_c, s);
      act |= e > 0;
      if (kTel && e > 0) {
        ++t_act;
        t_exc = wadd(t_exc, e);
      }
      acc_n[s] = 0;
    }
    {
      int carry = 0;
      bool any_head = false;
      for (int b = wbeg; b < wend; b += 32) {
        const int i = b + lane;
        const bool ok = i < wend;
        int s = -1, r = 0, ra = 0, cand = -kBig;
        bool head = false;
        if (ok) {
          s = a.seg[i];
          head = a.hs[i] != 0;
          r = resid(a.sign[i], a.cap[i], f[i]);
          const int pq = p_s[a.pseg[i]];
          const int sc = a.sc[i];
          const int rc = wsub(wadd(sc, p_s[s]), pq);
          if (r > 0 && rc < 0 && excess(acc_c, s) > 0) ra = r;
          if (r > 0) cand = wsub(pq, sc);
          radm[i] = ra;
          if (kTel) {
            t_sat += a.sign[i] > 0 && r == 0;
            t_work += ra > 0;
          }
        }
        run_reduce(s, r, sumr, Add());
        run_reduce(s, cand, best, Max());
        any_head |= __any_sync(kFull, head);
        head_scan(ra, head, carry);
      }
      if (lane == 0) {
        s_tail[warp] = carry;
        s_flag[warp] = any_head;
      }
    }
    tel_count<kTel>(s_tel, kTActive, t_act);
    tel_count<kTel>(s_tel, kTExcess, t_exc);
    tel_count<kTel>(s_tel, kTSaturated, t_sat);
    tel_count<kTel>(s_tel, kTWork, t_work);
    const bool block_act = __syncthreads_or(act) != 0;
    if (warp == 0) {
      // this block's tail: its warps' tails back to its last warp with a head
      const unsigned fl = __ballot_sync(kFull, s_flag[lane] != 0);
      const int j0 = fl ? 31 - __clz(fl) : 0;
      const int t = warp_sum(lane >= j0 ? s_tail[lane] : 0);
      if (lane == 0) {
        btail[blockIdx.x] = t;
        bflag[blockIdx.x] = fl != 0;
      }
    }
    if (!grid.any_block(block_act)) {
      if (eps <= 1) {
        done = true;
        break;
      }
      // a phase change writes no row: drop pass B's counts (all added
      // before the barrier just met)
      if (tel_writer)
        for (int k = 0; k < kTelCounters; ++k) atomicExch(grid.tel_add + k, 0);
      // a phase change: pass B's relabel bounds are void
      for (int s = g0; s < nseg; s += gstride) {
        sumr[s] = 0;
        best[s] = INT_MIN;
      }
      saturate(acc_n);
      eps = max(1, eps / a.alpha);
      cur ^= 1;
      grid.sync();
      continue;
    }
    // pass C: the maximal push, front to back in each segment
    if (wbeg < wend) {
      // the carry into this chunk: warp tails back to the last warp of
      // this block with a head, else all of them and the block's carry
      const unsigned fl = __ballot_sync(kFull, lane < warp && s_flag[lane]);
      const int j0 = fl ? 31 - __clz(fl) : 0;
      int carry = warp_sum(lane >= j0 && lane < warp ? s_tail[lane] : 0);
      if (!fl) carry = wadd(carry, block_carry(btail, bflag, blockIdx.x));
      int t_push = 0;
      for (int b = wbeg; b < wend; b += 32) {
        const int i = b + lane;
        const bool ok = i < wend;
        int s = -1, ra = 0, ex = 0;
        bool head = false;
        if (ok) {
          s = a.seg[i];
          head = a.hs[i] != 0;
          ra = radm[i];
          ex = excess(acc_c, s);
        }
        const int excl = wsub(head_scan(ra, head, carry), ra);
        const int dl = ok ? clip0(wsub(ex, excl), ra) : 0;
        if (ok) delta[i] = dl;
        if (kTel) t_push = wadd(t_push, dl);
        run_reduce(s, dl, pushed, Add());
      }
      tel_count<kTel>(s_tel, kTPushed, t_push);
    }
    grid.sync();
    // pass D: flows from every push and its partner's (all deltas are
    // complete), the next flow sums; then the relabels (prices read in
    // pass B, bounds and push sums complete) and the bounds' reset
    for (int b = wbeg; b < wend; b += 32) {
      const int i = b + lane;
      const bool ok = i < wend;
      int s = -1, v = 0;
      if (ok) {
        s = a.seg[i];
        const int sg = a.sign[i];
        const int fi = wadd(f[i], smul(sg, wsub(delta[i], delta[a.partner[i]])));
        f[i] = fi;
        v = smul(sg, fi);
      }
      run_reduce(s, v, acc_n, Add());
    }
    int t_rel = 0;
    for (int s = g0; s < nseg; s += gstride) {
      if (excess(acc_c, s) > 0 && pushed[s] == 0 && sumr[s] > 0) {
        p_s[s] = wsub(best[s], eps);
        if (kTel) ++t_rel;
      }
      sumr[s] = 0;
      best[s] = INT_MIN;
      pushed[s] = 0;
    }
    tel_count<kTel>(s_tel, kTRelabels, t_rel);
    ++steps;
    pending = true;
    cur ^= 1;
    grid.sync();
  }
  // the budget ran out after a superstep: its row (its barriers are met)
  if (tel_writer && pending)
    tel_row(a.tel, a.tel_cap, steps - 1, eps, tel_buf + kTelCounters * ((steps - 1) & 1));

  // ---- converged = done & max|excess| == 0; p_overflow = max|p| >= 2^30 ----
  bool pos = false, zero = false, ovf = false;
  for (int s = g0; s < nseg; s += gstride) {
    const int e = wabs(excess(cur ? acc1 : acc0, s));
    pos |= e > 0;
    zero |= e == 0;
    ovf |= wabs(p_s[s]) >= kPGuard;
  }
  const int bits = (__syncthreads_or(pos) ? 1 : 0) | (__syncthreads_or(zero) ? 2 : 0) |
                   (__syncthreads_or(ovf) ? 4 : 0);
  if (tid == 0 && bits) atomicOr(grid.hdr + kEndWord, bits);
  const int all = grid.sync(kEndWord);
  if (blockIdx.x == 0 && tid == 0) {
    a.result[0] = steps;
    a.result[1] = done && !(all & 1) && (all & 2);
    a.result[2] = (all & 4) != 0;
    a.result[3] = grid.barriers;
  }
}

// `n` grid barriers and nothing else: the barrier's own cost, for timing
__global__ void __launch_bounds__(kThreads, 1) barrier_kernel(int* hdr, int n) {
  Grid<> grid{hdr};
  for (int k = 0; k < n; ++k) grid.sync();
}

cudaError_t launch(const void* kernel, int blocks, void** params, int* hdr,
                   cudaStream_t stream) {
  cudaError_t rc = cudaMemsetAsync(hdr, 0, kHeadWords * sizeof(int), stream);
  if (rc == cudaSuccess)
    rc = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads), params, 0,
                                     stream);
  // read, and so clear, the launch's error: a refused launch must not
  // fail the next one
  const cudaError_t last = cudaGetLastError();
  return rc != cudaSuccess ? rc : last;
}

}  // namespace

extern "C" long long ksched_mcmf_scratch_words(int E, int blocks) {
  return static_cast<long long>(kScratchTables) * E + kHeadWords + 2LL * blocks;
}

// Blocks of the kernel one SM holds at once, with or without the ring
// (cudaOccupancy..., the fewer of the two), or minus the CUDA error code.
extern "C" int ksched_mcmf_blocks_per_sm() {
  int n0 = 0, n1 = 0;
  cudaError_t rc =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n0, mcmf_kernel<false>, kThreads, 0);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n1, mcmf_kernel<true>, kThreads, 0);
  return rc == cudaSuccess ? min(n0, n1) : -static_cast<int>(rc);
}

extern "C" int ksched_mcmf_solve(const int* sign, const int* cap, const int* sc,
                                 const int* sup, const int* seg, const int* pseg,
                                 const int* partner, const int* hs, const int* f0,
                                 int* f, int* result, int* scratch, int* tel, int E,
                                 int eps0, int alpha, int max_supersteps,
                                 int tighten_sweeps, int blocks, int chunk, int tel_cap,
                                 void* stream) {
  if (blocks < 1 || chunk < 32 || chunk % 32 != 0 || tel_cap < 0 ||
      (tel_cap > 0 && tel == nullptr) ||
      static_cast<long long>(blocks) * kWarps * chunk < E)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{sign, cap, sc, sup, seg, pseg, partner, hs, f0, f, result, scratch, tel,
         E, eps0, alpha, max_supersteps, tighten_sweeps, chunk, tel_cap};
  void* params[] = {&a};
  const void* kernel = tel_cap > 0 ? reinterpret_cast<const void*>(mcmf_kernel<true>)
                                   : reinterpret_cast<const void*>(mcmf_kernel<false>);
  return static_cast<int>(launch(kernel, blocks, params,
                                 scratch + static_cast<long long>(kScratchTables) * E,
                                 static_cast<cudaStream_t>(stream)));
}

// Resources of kernel `k` (0: the solve without the ring, 1: with it,
// 2: the barrier probe) into out[5] (func_attrs). Returns 0, -1 for no
// such k, or a cudaError_t code.
extern "C" int ksched_mcmf_kernel_attrs(int k, int* out) {
  const void* kernels[] = {reinterpret_cast<const void*>(mcmf_kernel<false>),
                           reinterpret_cast<const void*>(mcmf_kernel<true>),
                           reinterpret_cast<const void*>(barrier_kernel)};
  if (k < 0 || k >= 3) return -1;
  return func_attrs(kernels[k], out);
}

// `n` grid barriers of `blocks` blocks; hdr: kHeadWords words of scratch
extern "C" int ksched_mcmf_barrier_probe(int* hdr, int blocks, int n, void* stream) {
  void* params[] = {&hdr, &n};
  return static_cast<int>(launch(reinterpret_cast<const void*>(barrier_kernel), blocks,
                                 params, hdr, static_cast<cudaStream_t>(stream)));
}
