// The general-graph MCMF solve as one CUDA kernel on Hopper.
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
// source node's potential and excess. The one cross-entry read of the
// TPU kernel, perm(x) = x[partner], becomes p[pseg] (a price) or
// delta[partner] (a push).
//
// Segment reductions. Integer add (mod 2^32), max and min are associative
// and commutative, so any order gives the Pallas kernel's bits: the
// lanes of a warp reduce the runs of equal segment among their 32
// consecutive entries and each run's last lane applies the run's value to
// the segment's accumulator with one atomic. The maximal-push prefix (the
// exclusive in-segment sum of admissible residuals) is ordered: each warp
// owns a contiguous chunk of entries and scans it 32 at a time with a
// running carry; the carry into a chunk comes from the chunk tails the
// warps published in the pass before (a segmented scan over 32 values).
//
// What bounds it on this card. At the 10k x 1k shape (R = 256 rows of 512
// lanes: 131,072 entries) the 22 live tables take 11.5 MB: beyond one
// block's 227 KB of shared memory, inside the 50 MB L2. The design is the
// simplest right one: one block of 1024 threads and one launch per solve,
// state in global memory (L2 resident), a superstep = three passes over
// the entries and two over the segments, four block barriers. It is bound
// by one SM's issue rate and L2 latency along the superstep chain (325 us
// per superstep at R = 256 on an H100, PERF.md), far from its bytes or
// operations bound; a cooperative grid (one block per SM, grid-wide
// barriers, cross-block carries) is the next design.
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
  int* result;         // [3] out: steps, converged, p_overflow
  int* scratch;        // kScratchTables * E words
  int E, eps0, alpha, max_supersteps, tighten_sweeps;
};

// scratch tables of E words: delta, radm (per entry); sup, p, d, exc,
// acc[2], sumr, best, pushed, mins (per segment; E bounds their count)
constexpr int kScratchTables = 12;

__global__ void __launch_bounds__(kThreads, 1) mcmf_kernel(Args a) {
  __shared__ int s_tail[kWarps];
  __shared__ int s_flag[kWarps];
  const int E = a.E;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nseg = a.seg[E - 1] + 1;
  // warp `warp` owns entries [wbeg, wend): a multiple of 32 per warp
  const int chunk = (E + kThreads - 1) / kThreads * 32;
  const int wbeg = min(E, warp * chunk), wend = min(E, wbeg + chunk);

  int* delta = a.scratch;
  int* radm = delta + E;
  int* sup_s = radm + E;
  int* p_s = sup_s + E;
  int* d_s = p_s + E;
  int* exc_s = d_s + E;
  int* acc[2] = {exc_s + E, exc_s + 2 * E};
  int* sumr = exc_s + 3 * E;
  int* best = sumr + E;
  int* pushed = best + E;
  int* mins = pushed + E;
  int* f = a.f;

  // ---- prologue: flow, segment supplies, the start excess ----
  for (int s = tid; s < nseg; s += kThreads) {
    acc[0][s] = 0;
    mins[s] = INT_MAX;
  }
  for (int i = tid; i < E; i += kThreads) {
    f[i] = a.f0[i];
    if (i == 0 || a.hs[i]) sup_s[a.seg[i]] = a.sup[i];
  }
  __syncthreads();
  for (int b = wbeg; b < wend; b += 32) {
    const int i = b + lane;
    const bool ok = i < wend;
    run_reduce(ok ? a.seg[i] : -1, ok ? smul(a.sign[i], f[i]) : 0, acc[0], Add());
  }
  __syncthreads();

  // ---- tighten: Bellman-Ford over residual reduced costs ----
  for (int s = tid; s < nseg; s += kThreads)
    d_s[s] = wsub(sup_s[s], acc[0][s]) < 0 ? 0 : kBigD;
  __syncthreads();
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
    __syncthreads();
    bool ch = false;
    for (int s = tid; s < nseg; s += kThreads) {
      const int d = d_s[s];
      const int d2 = max(min(d, mins[s]), -kBigD);
      ch |= d2 != d;
      d_s[s] = d2;
      mins[s] = INT_MAX;
    }
    changed = __syncthreads_or(ch) != 0;
  }
  for (int s = tid; s < nseg; s += kThreads) {
    p_s[s] = wneg(min(d_s[s], kBigD));
    acc[0][s] = 0;
  }
  __syncthreads();

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
  saturate(acc[0]);
  __syncthreads();

  // ---- the phase loop ----
  int eps = a.eps0, steps = 0, cur = 0;
  bool done = false;
  while (steps < a.max_supersteps) {
    int* acc_c = acc[cur];
    int* acc_n = acc[cur ^ 1];
    bool act = false;
    for (int s = tid; s < nseg; s += kThreads) {
      const int e = wsub(sup_s[s], acc_c[s]);
      exc_s[s] = e;
      act |= e > 0;
      acc_n[s] = 0;
      sumr[s] = 0;
      best[s] = INT_MIN;
      pushed[s] = 0;
    }
    if (!__syncthreads_or(act)) {
      if (eps <= 1) {
        done = true;
        break;
      }
      saturate(acc_n);
      eps = max(1, eps / a.alpha);
      cur ^= 1;
      __syncthreads();
      continue;
    }
    // pass B: residuals, admissibility, the relabel bounds, chunk tails
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
          if (r > 0 && rc < 0 && exc_s[s] > 0) ra = r;
          if (r > 0) cand = wsub(pq, sc);
          radm[i] = ra;
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
    __syncthreads();
    // pass C: the maximal push, front to back in each segment
    {
      // the carry into this chunk: tails back to the last chunk with a head
      const unsigned fl = __ballot_sync(kFull, lane < warp && s_flag[lane]);
      const int j0 = fl ? 31 - __clz(fl) : 0;
      int carry = warp_sum(lane >= j0 && lane < warp ? s_tail[lane] : 0);
      for (int b = wbeg; b < wend; b += 32) {
        const int i = b + lane;
        const bool ok = i < wend;
        int s = -1, ra = 0, ex = 0;
        bool head = false;
        if (ok) {
          s = a.seg[i];
          head = a.hs[i] != 0;
          ra = radm[i];
          ex = exc_s[s];
        }
        const int excl = wsub(head_scan(ra, head, carry), ra);
        const int dl = ok ? clip0(wsub(ex, excl), ra) : 0;
        if (ok) delta[i] = dl;
        run_reduce(s, dl, pushed, Add());
      }
    }
    __syncthreads();
    // pass D: flows from every push and its partner's (all deltas are
    // complete), the next excess sums; relabels (prices read in pass B)
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
    for (int s = tid; s < nseg; s += kThreads)
      if (exc_s[s] > 0 && pushed[s] == 0 && sumr[s] > 0)
        p_s[s] = wsub(best[s], eps);
    ++steps;
    cur ^= 1;
    __syncthreads();
  }

  // ---- converged = done & max|excess| == 0; p_overflow = max|p| >= 2^30 ----
  bool pos = false, zero = false, ovf = false;
  for (int s = tid; s < nseg; s += kThreads) {
    const int e = wabs(wsub(sup_s[s], acc[cur][s]));
    pos |= e > 0;
    zero |= e == 0;
    ovf |= wabs(p_s[s]) >= kPGuard;
  }
  pos = __syncthreads_or(pos) != 0;
  zero = __syncthreads_or(zero) != 0;
  ovf = __syncthreads_or(ovf) != 0;
  if (tid == 0) {
    a.result[0] = steps;
    a.result[1] = done && !pos && zero;
    a.result[2] = ovf;
  }
}

}  // namespace

extern "C" long long ksched_mcmf_scratch_words(int E) {
  return static_cast<long long>(kScratchTables) * E;
}

extern "C" int ksched_mcmf_solve(const int* sign, const int* cap, const int* sc,
                                 const int* sup, const int* seg, const int* pseg,
                                 const int* partner, const int* hs, const int* f0,
                                 int* f, int* result, int* scratch, int E, int eps0,
                                 int alpha, int max_supersteps, int tighten_sweeps,
                                 void* stream) {
  Args a{sign, cap, sc, sup, seg, pseg, partner, hs, f0, f, result, scratch,
         E, eps0, alpha, max_supersteps, tighten_sweeps};
  mcmf_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
