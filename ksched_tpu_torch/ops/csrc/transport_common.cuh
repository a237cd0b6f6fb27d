// What the transport kernels (transport.cu, transport_tiered.cu) share:
// the block shape, int32 arithmetic with two's-complement wrap, warp
// scans, the phase probe, the state layout and the row passes over the
// row-split plan.
//
// Arithmetic is int32 with wrap (the same as the plain versions'
// tensors), through unsigned adds so nothing is undefined. Sentinels
// match solver/layered.py: BIG = 1 << 30, BIG_D = 1 << 28.
//
// Row passes. Row r < C is a source row of the [C, Mp] tiles; row C is
// the sink, whose cells are the [Mp] vectors z and pm. The host's plan
// (ops/transport.py `row_plan`) cuts rows 0..C into slices, each a whole
// number of 4-column groups: with C + 1 < 32 rows (`split`) slice w is
// warp w's, a contiguous, ascending run of one row's groups, and a row's
// slices sit on consecutive warps in column order; otherwise slice r is
// row r, whole, and warp w takes rows w, w + 32, ... A lane reads and
// writes a group as one int4: the tiles' row stride `ld` is Mp rounded
// up to a group and every array starts on 16 bytes, so a warp's 32
// groups are 512 consecutive bytes, four conflict-free wavefronts. The
// columns past Mp are dead columns (no capacity, no flow), inert in
// every pass.
//
// A row's ordered push prefix is split the same way (phase A, then B):
//   A. each warp sweeps its slice once: per cell the admissible residual
//      (stored over the push tile), and the slice's totals — flow,
//      admissible units, the relabel extremum — into one word per slice;
//      beside it, a thread per column tests its column excess (which
//      the column passes that move flow keep up to date). One block
//      barrier (it also ORs the activity test). Then each warp reads the
//      32 slices' totals and, with a segmented warp scan, gets its row's
//      excess and the admissible units of its row's earlier slices;
//   B. each warp scans its slice again from that carry and writes each
//      cell's push clip(excess - prefix, 0, residual). One barrier.
// The relabel of a row (pushed nothing while active) reads the slices'
// extremum and pushed flags after B's barrier, in the column phase, so
// it costs no barrier of its own: a superstep is three barriers, as
// with one warp per row. The bits are those of one sweep: int32
// addition with wrap is associative and commutative, so a prefix summed
// as earlier slices' totals plus the slice's own scan is the one-sweep
// prefix, and max, min and any do not depend on order.

#pragma once

#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 4;  // columns per lane access (one int4)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBig = 1 << 30;
constexpr int kBigD = 1 << 28;

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}
// jnp.clip(x, 0, hi) == minimum(maximum(x, 0), hi)
__device__ __forceinline__ int clip0(int x, int hi) { return min(max(x, 0), hi); }
__device__ __forceinline__ int sum4(int4 v) {
  return wadd(wadd(v.x, v.y), wadd(v.z, v.w));
}

__device__ __forceinline__ int warp_sum(int v) {
  return static_cast<int>(__reduce_add_sync(kFull, static_cast<unsigned>(v)));
}

__device__ __forceinline__ int warp_incl_scan(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v = wadd(v, t);
  }
  return v;
}

// Inclusive scan within runs of lanes: `first` is the first lane of
// this lane's run. (Five shuffles; a reduction with one lane mask per
// run measured slower on the H100; PERF.md, section 6.)
__device__ __forceinline__ int warp_seg_scan(int v, int lane, int first) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(kFull, v, d);
    if (lane - d >= first) v = wadd(v, t);
  }
  return v;
}

// The optional phase probe, compiled in only for a launch that asks
// for it (Probe<true>; a launch without one runs the empty Probe<false>
// and pays nothing): thread 0 adds the clock64() time from one phase
// barrier to the next into one shared counter per phase and, at the
// end, stores the counters and the whole launch's cycles to `out`.
// Thread 0 passes every barrier, so each counter is the block's own time
// in that phase.
constexpr int kProbeExcess = 0;   // phase A: excess test, admissible sweep
constexpr int kProbeRow = 1;      // phase B: the rows' push prefix
constexpr int kProbeColumn = 2;   // the column phase and row relabels
constexpr int kProbePhase = 3;    // a phase start: saturate or refine
constexpr int kProbeTotal = 4;    // the whole launch, prologue included

__shared__ long long s_probe[kProbeTotal + 1];  // the counters, the start

template <bool kOn>
struct Probe {
  long long* out;
  long long last;

  __device__ explicit Probe(long long* cycles) : out(cycles) {
    if (threadIdx.x == 0) {
      last = clock64();
      for (int k = 0; k < kProbeTotal; ++k) s_probe[k] = 0;
      s_probe[kProbeTotal] = last;
    }
  }
  // start timing from here, counting nothing before
  __device__ void lap() {
    if (threadIdx.x == 0) last = clock64();
  }
  __device__ void mark(int k) {
    if (threadIdx.x == 0) {
      const long long now = clock64();
      s_probe[k] += now - last;
      last = now;
    }
  }
  __device__ void finish() {
    if (threadIdx.x == 0) {
      for (int k = 0; k < kProbeTotal; ++k) out[k] = s_probe[k];
      out[kProbeTotal] = clock64() - s_probe[kProbeTotal];
    }
  }
};

template <>
struct Probe<false> {
  __device__ explicit Probe(long long*) {}
  __device__ void lap() {}
  __device__ void mark(int) {}
  __device__ void finish() {}
};

// The row-split plan, as ops/transport.py `RowPlan.pack` lays it out.
struct RowPlan {
  int split;          // 1: slice w is warp w's; 0: slice r is row r
  int row[kWarps];    // slice -> its row (C: the sink)
  int g0[kWarps];     // slice -> its first group
  int g1[kWarps];     // slice -> one past its last group
  int first[kWarps];  // row -> its first slice
  int count[kWarps];  // row -> its number of slices
};
constexpr int kPlanWords = 1 + 5 * kWarps;

// The state arrays, in the order of ops/transport.py `ARRAYS`; each
// kernel appends its cost tiles. Layout.off[k] >= 0 places array k at
// that word of shared memory, < 0 at word ~off of the global scratch.
enum CoreArray {
  kCap,       // [ld] column capacities
  kPm,        // [ld] machine (column) prices
  kZ,         // [ld] col->sink flow
  kEcol,      // [ld] column excess, sum_c y - z
  kDzb,       // [ld] sink push-back of the current superstep
  kSupply,    // [C]
  kPr0,       // [C] row prices, double buffered
  kPr1,
  kErow,      // [C] row excess (one warp per row)
  kSlFlow,    // [slices] flow sum
  kSlAdm,     // [slices] admissible units
  kSlExt,     // [slices] relabel extremum / price bound
  kSlPushed,  // [slices] pushed / any arc
  kY,         // [C, ld] flow
  kDf,        // [C, ld] forward pushes of the current superstep
  kCoreArrays
};
constexpr int kMaxArrays = kCoreArrays + 3;
struct Layout {
  int off[kMaxArrays];
};

// kShared: the layout put every array in shared memory (as at
// [4, 1024]), so every state pointer derives from the shared window and
// the compiler addresses the state as shared memory: 32-bit addresses
// and shared loads and stores, not generic ones.
template <bool kShared>
__device__ __forceinline__ int* place(const Layout& L, int k, int* smem, int* scratch) {
  const int o = L.off[k];
  if (kShared) return smem + o;
  return o >= 0 ? smem + o : scratch + ~o;
}

// The state both kernels share.
struct Core {
  int C, Mp, ld, S;  // rows, columns, row stride, slices
  int *cap, *pm, *z, *ecol, *dzb, *supply, *pr0, *pr1, *erow;
  int *sl_flow, *sl_adm, *sl_ext, *sl_pushed, *y, *df;

  template <bool kShared>
  __device__ void carve(const Layout& L, int* smem, int* scratch) {
    auto at = [&](int k) { return place<kShared>(L, k, smem, scratch); };
    cap = at(kCap);
    pm = at(kPm);
    z = at(kZ);
    ecol = at(kEcol);
    dzb = at(kDzb);
    supply = at(kSupply);
    pr0 = at(kPr0);
    pr1 = at(kPr1);
    erow = at(kErow);
    sl_flow = at(kSlFlow);
    sl_adm = at(kSlAdm);
    sl_ext = at(kSlExt);
    sl_pushed = at(kSlPushed);
    y = at(kY);
    df = at(kDf);
  }
};

__shared__ int s_psink[2];   // sink price, double buffered like pr
__shared__ int s_esink;      // sink excess (one warp per row)
__shared__ int s_total;      // sum(supply), wrapped
__shared__ RowPlan s_plan;   // the launch's plan, read by lane and by warp

// Copies the launch's plan (a kernel parameter) to s_plan, where a warp
// may read it at any index; the caller's next barrier publishes it.
__device__ __forceinline__ void load_plan(const RowPlan& plan) {
  const int* src = reinterpret_cast<const int*>(&plan);
  int* dst = reinterpret_cast<int*>(&s_plan);
  for (int i = threadIdx.x; i < kPlanWords; i += kThreads) dst[i] = src[i];
}

struct Slice {
  int row, g0, g1;
};
__device__ __forceinline__ Slice slice_of(const RowPlan& p, const Core& s, int sl) {
  return p.split ? Slice{p.row[sl], p.g0[sl], p.g1[sl]} : Slice{sl, 0, s.ld / kGroup};
}

__device__ __forceinline__ int4 ld4(const int* row, int g) {
  return reinterpret_cast<const int4*>(row)[g];
}
__device__ __forceinline__ void st4(int* row, int g, int4 v) {
  reinterpret_cast<int4*>(row)[g] = v;
}

// What a warp holds after phase A in split mode: lane l the excess of
// slice l's row; every lane the excess of the warp's own slice's row and
// the admissible units of that row's earlier slices.
struct RowState {
  int lane_e, e, carry;
};

// The lane's place in the plan (split mode): its slice's row and the
// row's first and last slice.
struct PlanLane {
  int row, first, last;
  __device__ PlanLane(const RowPlan& p, int lane) {
    row = p.row[lane];
    first = p.first[row];
    last = first + p.count[row] - 1;
  }
};

// Phase A of the row push over one slice [g0, g1) of a row: per group
// `cell(g, flow, ext)` returns the four admissible residuals (adding the
// group's flow to `flow` and folding relabel candidates into `ext`),
// which are stored over `out`'s group g; `adm` sums them.
template <class Cell>
__device__ __forceinline__ void sweep_admissible(const Slice& q, int* out, Cell cell,
                                                 int& flow, int& adm, int& ext) {
  for (int g = q.g0 + (threadIdx.x & 31); g < q.g1; g += 32) {
    const int4 a = cell(g, flow, ext);
    st4(out, g, a);
    adm = wadd(adm, sum4(a));
  }
}

// Phase A: the column excesses' test (a thread per column; each pass
// that moves flow keeps ecol = sum_c y - z of its own columns) and, per
// slice, the admissible residuals of its cells with the slice's totals;
// then
// the block barrier and, in split mode, each row's excess and each
// slice's carry from the slices' totals. `fwd(row)` gives the kernel's
// source-row cell for sweep_admissible; `ps` is the sink price. Returns, across
// the block, whether any excess is positive (kNonzero: nonzero).
template <bool kNonzero, class Fwd>
__device__ __forceinline__
bool phase_a(const Core& s, const RowPlan& plan, const PlanLane& pl,
             int ps, Fwd fwd, RowState& rs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bool flag = false;
  for (int m = threadIdx.x; m < s.Mp; m += kThreads) {
    const int e = s.ecol[m];
    flag |= kNonzero ? e != 0 : e > 0;
  }
  for (int sl = warp; sl < s.S; sl += kWarps) {
    const Slice q = slice_of(plan, s, sl);
    int flow = 0, adm = 0, ext = -kBig;
    if (q.row < s.C) {
      sweep_admissible(q, s.df + q.row * s.ld, fwd(q.row), flow, adm, ext);
    } else {  // the sink: push-back over z at cost 0
      sweep_admissible(q, s.dzb, [&](int g, int& fl, int& ex) {
        const int4 z4 = ld4(s.z, g), p4 = ld4(s.pm, g);
        const int zz[4] = {z4.x, z4.y, z4.z, z4.w}, pp[4] = {p4.x, p4.y, p4.z, p4.w};
        int a[4];
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          a[k] = 0;
          fl = wadd(fl, zz[k]);
          if (zz[k] > 0) {
            ex = max(ex, pp[k]);
            if (wsub(ps, pp[k]) < 0) a[k] = zz[k];
          }
        }
        return make_int4(a[0], a[1], a[2], a[3]);
      }, flow, adm, ext);
    }
    flow = warp_sum(flow);
    adm = warp_sum(adm);
    ext = __reduce_max_sync(kFull, ext);
    if (lane == 0) {
      s.sl_flow[sl] = flow;
      s.sl_adm[sl] = adm;
      s.sl_ext[sl] = ext;
    }
    if (!plan.split) {  // the slice is the whole row
      const int e = q.row < s.C ? wsub(s.supply[q.row], flow) : wsub(flow, s_total);
      if (lane == 0) (q.row < s.C ? s.erow[q.row] : s_esink) = e;
      flag |= kNonzero ? e != 0 : e > 0;
    }
  }
  bool active = __syncthreads_or(flag) != 0;
  if (plan.split) {
    const int flow = s.sl_flow[lane], adm = s.sl_adm[lane];
    const int tot = __shfl_sync(kFull, warp_seg_scan(flow, lane, pl.first), pl.last);
    const int e = pl.row < s.C ? wsub(s.supply[pl.row], tot) : wsub(tot, s_total);
    active |= __any_sync(kFull, kNonzero ? e != 0 : e > 0);
    rs.lane_e = e;
    rs.e = __shfl_sync(kFull, e, warp);
    rs.carry = __shfl_sync(kFull, wsub(warp_seg_scan(adm, lane, pl.first), adm), warp);
  }
  return active;
}

// Phase B over one slice: the ordered prefix of the admissible residuals
// stored in `buf` (from `carry`), each cell's push clip(e - prefix, 0,
// residual) written over them. Returns whether the slice pushed.
__device__ __forceinline__ bool slice_push(int* buf, const Slice& q, int e, int carry) {
  const int lane = threadIdx.x & 31;
  bool pushed = false;
  for (int base = q.g0; base < q.g1; base += 32) {
    const int g = base + lane;
    const int4 a = g < q.g1 ? ld4(buf, g) : make_int4(0, 0, 0, 0);
    const int local = sum4(a);
    const int incl = warp_incl_scan(local, lane);
    int run = wadd(carry, wsub(incl, local));
    int4 d;
    d.x = clip0(wsub(e, run), a.x);
    run = wadd(run, a.x);
    d.y = clip0(wsub(e, run), a.y);
    run = wadd(run, a.y);
    d.z = clip0(wsub(e, run), a.z);
    run = wadd(run, a.z);
    d.w = clip0(wsub(e, run), a.w);
    if (g < q.g1) st4(buf, g, d);
    pushed |= (d.x | d.y | d.z | d.w) != 0;
    carry = wadd(carry, __shfl_sync(kFull, incl, 31));
  }
  return __any_sync(kFull, pushed);
}

// Phase B: every slice's pushes, then the block barrier.
__device__ __forceinline__
void phase_b(const Core& s, const RowPlan& plan, const RowState& rs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int sl = warp; sl < s.S; sl += kWarps) {
    const Slice q = slice_of(plan, s, sl);
    const bool src = q.row < s.C;
    const int e = plan.split ? rs.e : (src ? s.erow[q.row] : s_esink);
    const bool pushed = slice_push(src ? s.df + q.row * s.ld : s.dzb, q, e,
                                   plan.split ? rs.carry : 0);
    if (lane == 0) s.sl_pushed[sl] = pushed;
  }
  __syncthreads();
}

// A warp per row r (0..C) folds the row's slices: `fold(r, lane < n,
// first + lane)` with n the row's slices from `first` — lanes past n
// hold no slice. The caller ends the pass with a barrier.
template <class Fold>
__device__ __forceinline__ void fold_rows(const Core& s, const RowPlan& plan, Fold fold) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r <= s.C; r += kWarps) {
    const int first = plan.split ? plan.first[r] : r;
    const int n = plan.split ? plan.count[r] : 1;
    fold(r, lane < n, first + (lane < n ? lane : 0));
  }
}

// The row relabels of a superstep (read after phase B's barrier): a row
// with positive excess that pushed nothing drops to its best candidate
// minus eps, into the other half of the price double buffer.
__device__ __forceinline__
void relabel_rows(const Core& s, const RowPlan& plan, const RowState& rs,
                  int cur, int eps) {
  const int* prc = cur ? s.pr1 : s.pr0;
  int* prn = cur ? s.pr0 : s.pr1;
  const int ps = s_psink[cur];
  fold_rows(s, plan, [&](int r, bool has, int sl) {
    const int ext = __reduce_max_sync(kFull, has ? s.sl_ext[sl] : -kBig);
    const bool pushed = __any_sync(kFull, has && s.sl_pushed[sl]);
    const int e = plan.split ? __shfl_sync(kFull, rs.lane_e, plan.first[r])
                             : (r < s.C ? s.erow[r] : s_esink);
    if ((threadIdx.x & 31) == 0) {
      const bool drop = e > 0 && !pushed;
      if (r < s.C) {
        prn[r] = drop ? wsub(ext, eps) : prc[r];
      } else {
        s_psink[cur ^ 1] = drop ? wsub(ext, eps) : ps;
      }
    }
  });
}

// The prologue's row pass: per slice whether any arc exists and the
// extremum `tight(row)(g, any, ext)` folds in (the sink: min of pm over
// live columns); then pr0[r] = any ? max : 0, psink = any ? min : 0, and
// sum(supply). Ends with a barrier.
template <class Tight>
__device__ __forceinline__
void tighten_rows(const Core& s, const RowPlan& plan, Tight tight) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int sl = warp; sl < s.S; sl += kWarps) {
    const Slice q = slice_of(plan, s, sl);
    bool any = false;
    int ext;
    if (q.row < s.C) {
      int mx = -kBigD;
      const auto cell = tight(q.row);
      for (int g = q.g0 + lane; g < q.g1; g += 32) cell(g, any, mx);
      ext = __reduce_max_sync(kFull, mx);
    } else {
      int mn = kBigD;
      for (int g = q.g0 + lane; g < q.g1; g += 32) {
        const int4 c4 = ld4(s.cap, g), p4 = ld4(s.pm, g);
        const int cc[4] = {c4.x, c4.y, c4.z, c4.w}, pp[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          if (cc[k] > 0) {
            any = true;
            mn = min(mn, pp[k]);
          }
        }
      }
      ext = __reduce_min_sync(kFull, mn);
    }
    any = __any_sync(kFull, any);
    if (lane == 0) {
      s.sl_ext[sl] = ext;
      s.sl_pushed[sl] = any;
    }
  }
  __syncthreads();
  fold_rows(s, plan, [&](int r, bool has, int sl) {
    const bool any = __any_sync(kFull, has && s.sl_pushed[sl]);
    if (r < s.C) {
      const int mx = __reduce_max_sync(kFull, has ? s.sl_ext[sl] : -kBigD);
      if (lane == 0) s.pr0[r] = any ? mx : 0;
    } else {
      const int mn = __reduce_min_sync(kFull, has ? s.sl_ext[sl] : kBigD);
      int total = 0;
      for (int c = lane; c < s.C; c += 32) total = wadd(total, s.supply[c]);
      total = warp_sum(total);
      if (lane == 0) {
        s_psink[0] = any ? mn : 0;
        s_total = total;
      }
    }
  });
  __syncthreads();
}

// The row pass of a price-refine wave: per slice the least bound
// `bound(row)(g, b)` folds in (the sink: pm + eps over col->sink
// residuals); then pr[r] = max(min(pr[r], bound), -BIG_D), and psink
// likewise. Ends with a barrier.
template <class Bound>
__device__ __forceinline__
void refine_rows(const Core& s, const RowPlan& plan, int* pr, int cur,
                 int eps, Bound bound) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ps = s_psink[cur];
  for (int sl = warp; sl < s.S; sl += kWarps) {
    const Slice q = slice_of(plan, s, sl);
    int b = kBig;
    if (q.row < s.C) {
      const auto cell = bound(q.row);
      for (int g = q.g0 + lane; g < q.g1; g += 32) cell(g, b);
    } else {
      for (int g = q.g0 + lane; g < q.g1; g += 32) {
        const int4 c4 = ld4(s.cap, g), z4 = ld4(s.z, g), p4 = ld4(s.pm, g);
        const int cc[4] = {c4.x, c4.y, c4.z, c4.w}, zz[4] = {z4.x, z4.y, z4.z, z4.w};
        const int pp[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          if (wsub(cc[k], zz[k]) > 0) b = min(b, wadd(pp[k], eps));
        }
      }
    }
    b = __reduce_min_sync(kFull, b);
    if (lane == 0) s.sl_ext[sl] = b;
  }
  __syncthreads();
  fold_rows(s, plan, [&](int r, bool has, int sl) {
    const int b = __reduce_min_sync(kFull, has ? s.sl_ext[sl] : kBig);
    if (lane == 0) {
      if (r < s.C) {
        pr[r] = max(min(pr[r], b), -kBigD);
      } else {
        s_psink[cur] = max(min(ps, b), -kBigD);
      }
    }
  });
  __syncthreads();
}

// ---- host side of a launch ----

// The plan and the layout from the host's words (ops/transport.py):
// kPlanWords ints, then `arrays` offsets.
void read_plan(const int* plan, const int* layout, int arrays, RowPlan* p, Layout* L) {
  static_assert(sizeof(RowPlan) == kPlanWords * sizeof(int), "RowPlan is packed");
  std::memcpy(p, plan, sizeof(RowPlan));
  std::memset(L, 0, sizeof(Layout));
  std::memcpy(L->off, layout, arrays * sizeof(int));
}

// Whether the layout put all `arrays` in shared memory.
bool all_shared(const Layout& L, int arrays) {
  for (int k = 0; k < arrays; ++k) {
    if (L.off[k] < 0) return false;
  }
  return true;
}

// The instance of a transport kernel template<bool kShared, bool kProbe>
// a launch runs: the state all in shared memory or not, a probe or not.
template <class Kernel>
Kernel pick(bool shared, bool probe, Kernel ss, Kernel sn, Kernel gs, Kernel gn) {
  return shared ? (probe ? ss : sn) : (probe ? gs : gn);
}

// Dynamic shared memory one block of `kernel` may use on the current
// device: the opt-in limit less the kernel's static shared variables.
// Negative: minus a cudaError_t code.
template <class Kernel>
long long smem_budget(Kernel kernel) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes fa;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  return static_cast<long long>(optin) - static_cast<long long>(fa.sharedSizeBytes);
}

// What the loaded library holds for `kernel`, the counterpart of the
// resource report the JAX package reads from a compiled program: out[0]
// registers a thread, out[1] local (spill) bytes a thread, out[2] static
// shared bytes, out[3] max threads a block, out[4] blocks an SM holds at
// once at kThreads threads and no dynamic shared memory. Returns a
// cudaError_t code (0 = filled).
inline int func_attrs(const void* kernel, int* out) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(fa.sharedSizeBytes);
  out[3] = fa.maxThreadsPerBlock;
  out[4] = blocks;
  return 0;
}

}  // namespace

extern "C" const char* ksched_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
