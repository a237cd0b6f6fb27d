// The tiered (continuation-priced) layered-transport solve, one launch
// per solve: the preemption-on round's solve.
//
// Replaces ksched_tpu/ops/transport_pallas.py::_transport_kernel_tiered
// and computes what it computes, bit for bit: each cell (row c, column
// m) is two parallel arcs — the first R[c,m] units (the residents) at
// wLo, the rest at wHi — with the canonical cheapest-first split
// yA = min(y, R), yB = y - yA. Cold price tightening against wLo (no
// carried prices), then the eps-scaling phase loop with saturate or
// `refine_waves` price-refine waves between phases; each superstep is a
// synchronous maximal push plus jump relabel over both tiers. The plain
// PyTorch version is solver/layered.py `_solve_transport_tiered`.
//
// What bounds it: neither bytes nor operations (ops/transport.py), but
// the latency of a chain of dependent supersteps on one SM. The layout
// answers with B1's (transport.cu): one block of 1024 threads, state on
// chip, three barriers a superstep; every row pass (the admissible sweep
// and push prefix, the refine wave's row bounds, the prologue's
// tightening) runs on all 32 warps over the host's row-split plan with
// conflict-free int4 access (transport_common.cuh). Per cell the forward
// admissible residual is tier A's at wLo plus tier B's at wHi. Row C is
// the sink (tier-less, as in B1).
//   - column phases: a thread owns column m and walks the 1 + 2C
//     entries of the column prefix in the order of transport_pallas.py:
//     352-361 — the sink, then the dear tier over rows ascending, then
//     the cheap tier over rows ascending. The dear pass folds its
//     backward pushes into the forward-push tile df (df -= db_hi), so
//     the cheap pass, which still reads the old y for yA, finishes each
//     cell with y += df - db_lo.
// State: the vectors of B1 and five [C, ld] tiles — y, df, the clamped
// resident tile R (R = min(R_in, U), U = min(supply, col_cap), written
// by the prologue), wLo and wHi — in shared memory while they fit (all
// of them at [4, 1024]: 80 KB of tiles), the rest in global memory, as
// the host's layout places them (ops/transport.py `layout`).

#include "transport_common.cuh"

namespace {

// the tiered kernel's tiles, after the shared arrays
enum TieredArray { kR = kCoreArrays, kWlo, kWhi, kTieredArrays };

struct State : Core {
  int* r;    // [C, ld] resident capacity, clamped to U
  int* wlo;  // [C, ld] scaled cheap-tier costs
  int* whi;  // [C, ld] scaled dear-tier costs
};

// Phase A's cell of source row `row`: per group the forward admissible
// residual over both tiers, the flow, and the relabel candidates
// pm - wLo (tier A residual) and pm - wHi (tier B residual).
__device__ __forceinline__ auto forward_cell(const State& s, int row, const int* prc) {
  const int sup = s.supply[row], prr = prc[row];
  const int off = row * s.ld;
  const int *pm = s.pm, *cap = s.cap, *rt = s.r + off, *yt = s.y + off;
  const int *lot = s.wlo + off, *hit = s.whi + off;
  return [=](int g, int& flow, int& best) {
    const int4 p4 = ld4(pm, g), c4 = ld4(cap, g), r4 = ld4(rt, g), y4 = ld4(yt, g);
    const int4 l4 = ld4(lot, g), h4 = ld4(hit, g);
    const int pp[4] = {p4.x, p4.y, p4.z, p4.w}, cc[4] = {c4.x, c4.y, c4.z, c4.w};
    const int rv[4] = {r4.x, r4.y, r4.z, r4.w}, yv[4] = {y4.x, y4.y, y4.z, y4.w};
    const int lv[4] = {l4.x, l4.y, l4.z, l4.w}, hv[4] = {h4.x, h4.y, h4.z, h4.w};
    int a[4];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const int pmm = pp[k], rr = rv[k], yy = yv[k], lo = lv[k], hi = hv[k];
      const int ya = min(yy, rr), yb = wsub(yy, ya);
      const int rA = wsub(rr, ya);
      const int rB = wsub(wsub(min(sup, cc[k]), rr), yb);
      flow = wadd(flow, yy);
      a[k] = 0;
      if (rA > 0) {
        best = max(best, wsub(pmm, lo));
        if (wsub(wadd(lo, prr), pmm) < 0) a[k] = rA;
      }
      if (rB > 0) {
        best = max(best, wsub(pmm, hi));
        if (wsub(wadd(hi, prr), pmm) < 0) a[k] = wadd(a[k], rB);
      }
    }
    return make_int4(a[0], a[1], a[2], a[3]);
  };
}

// One synchronous push/relabel superstep (transport_superstep_tiered),
// after phase A (the admissible sweep and the excesses, in the loop).
template <class P>
__device__ __forceinline__
void superstep(const State& s, const RowPlan& plan, const RowState& rs,
               int cur, int eps, P& probe) {
  // ---- phase B: forward pushes over both tiers; sink push-back ----
  phase_b(s, plan, rs);
  probe.mark(kProbeRow);

  // ---- column phase: the sink push, then the dear-tier and the
  // cheap-tier backward pushes, the flow update and the column relabel,
  // all from the old prices, and the new column excess; the row
  // relabels ----
  const int* prc = cur ? s.pr1 : s.pr0;
  const int ps = s_psink[cur];
  relabel_rows(s, plan, rs, cur, eps);
  for (int m = threadIdx.x; m < s.Mp; m += kThreads) {
    const int zz = s.z[m], pmm = s.pm[m], ec = s.ecol[m];
    const int rs_ = wsub(s.cap[m], zz);
    const int adm_s = (rs_ > 0 && wsub(pmm, ps) < 0) ? rs_ : 0;
    const int ds = clip0(ec, adm_s);
    bool pushed = ds != 0;
    int run = adm_s;  // exclusive prefix: sink entry first
    int cand = -kBig;
    for (int c = 0; c < s.C; ++c) {  // dear tier (cost -wHi backward)
      const int i = c * s.ld + m;
      const int yy = s.y[i], hi = s.whi[i], prr = prc[c];
      const int yb = wsub(yy, min(yy, s.r[i]));
      int ab = 0;
      if (yb > 0) {
        cand = max(cand, wadd(prr, hi));
        if (wsub(wsub(pmm, prr), hi) < 0) ab = yb;
      }
      const int db = clip0(wsub(ec, run), ab);
      run = wadd(run, ab);
      pushed |= db != 0;
      s.df[i] = wsub(s.df[i], db);
    }
    int flow = 0;
    for (int c = 0; c < s.C; ++c) {  // cheap tier (cost -wLo backward)
      const int i = c * s.ld + m;
      const int yy = s.y[i], lo = s.wlo[i], prr = prc[c];
      const int ya = min(yy, s.r[i]);
      int al = 0;
      if (ya > 0) {
        cand = max(cand, wadd(prr, lo));
        if (wsub(wsub(pmm, prr), lo) < 0) al = ya;
      }
      const int dl = clip0(wsub(ec, run), al);
      run = wadd(run, al);
      pushed |= dl != 0;
      const int y2 = wsub(wadd(yy, s.df[i]), dl);
      s.y[i] = y2;
      flow = wadd(flow, y2);
    }
    cand = max(cand, rs_ > 0 ? ps : -kBig);
    const int z2 = wsub(wadd(zz, ds), s.dzb[m]);
    s.z[m] = z2;
    s.ecol[m] = wsub(flow, z2);
    s.pm[m] = (ec > 0 && !pushed) ? wsub(cand, eps) : pmm;
  }
  __syncthreads();
  probe.mark(kProbeColumn);
}

// Phase start: saturate (eps_sat = 0) or partial saturate
// (transport_saturate_eps_tiered) at eps_sat, per tier; the column
// excesses of the new flow.
__device__ __forceinline__
void saturate(const State& s, const int* pr, int ps, int eps_sat) {
  for (int m = threadIdx.x; m < s.Mp; m += kThreads) {
    const int pmm = s.pm[m], cp = s.cap[m];
    int flow = 0;
    for (int c = 0; c < s.C; ++c) {
      const int i = c * s.ld + m;
      const int rr = s.r[i], yy = s.y[i];
      const int rcl = wsub(wadd(s.wlo[i], pr[c]), pmm);
      const int rch = wsub(wadd(s.whi[i], pr[c]), pmm);
      const int ya = min(yy, rr), yb = wsub(yy, ya);
      const int ya2 = rcl < -eps_sat ? rr : (rcl > eps_sat ? 0 : ya);
      const int yb2 = rch < -eps_sat ? wsub(min(s.supply[c], cp), rr)
                                     : (rch > eps_sat ? 0 : yb);
      const int y2 = wadd(ya2, yb2);
      s.y[i] = y2;
      flow = wadd(flow, y2);
    }
    const int rcs = wsub(pmm, ps);
    int zz = s.z[m];
    if (rcs < -eps_sat) {
      zz = cp;
    } else if (rcs > eps_sat) {
      zz = 0;
    }
    s.z[m] = zz;
    s.ecol[m] = wsub(flow, zz);
  }
  __syncthreads();
}

// One tiered price-refine wave (_price_refine_tiered's body) at eps, in
// place.
__device__ __forceinline__
void refine_wave(const State& s, const RowPlan& plan, int* pr, int cur,
                 int eps) {
  const int ps = s_psink[cur];
  // pm <= wLo + pr + eps over tier-A forward residuals, <= wHi + pr +
  // eps over tier-B ones, <= psink + eps over sink->col residuals
  for (int m = threadIdx.x; m < s.Mp; m += kThreads) {
    const int cp = s.cap[m];
    int bound = kBig;
    for (int c = 0; c < s.C; ++c) {
      const int i = c * s.ld + m;
      const int rr = s.r[i], yy = s.y[i];
      const int ya = min(yy, rr), yb = wsub(yy, ya);
      if (wsub(rr, ya) > 0) bound = min(bound, wadd(wadd(s.wlo[i], pr[c]), eps));
      if (wsub(wsub(min(s.supply[c], cp), rr), yb) > 0)
        bound = min(bound, wadd(wadd(s.whi[i], pr[c]), eps));
    }
    int p2 = max(min(s.pm[m], bound), -kBigD);
    p2 = min(p2, s.z[m] > 0 ? wadd(ps, eps) : kBig);
    s.pm[m] = p2;
  }
  __syncthreads();
  // pr <= pm - wLo + eps over tier-A backward residuals, <= pm - wHi +
  // eps over tier-B ones; psink <= pm + eps over col->sink residuals
  refine_rows(s, plan, pr, cur, eps, [&](int row) {
    const int off = row * s.ld;
    const int *pm = s.pm, *rt = s.r + off, *yt = s.y + off;
    const int *lot = s.wlo + off, *hit = s.whi + off;
    return [=](int g, int& b) {
      const int4 p4 = ld4(pm, g), r4 = ld4(rt, g), y4 = ld4(yt, g);
      const int4 l4 = ld4(lot, g), h4 = ld4(hit, g);
      const int pp[4] = {p4.x, p4.y, p4.z, p4.w}, rv[4] = {r4.x, r4.y, r4.z, r4.w};
      const int yv[4] = {y4.x, y4.y, y4.z, y4.w};
      const int lv[4] = {l4.x, l4.y, l4.z, l4.w}, hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        const int ya = min(yv[k], rv[k]), yb = wsub(yv[k], ya);
        if (ya > 0) b = min(b, wadd(wsub(pp[k], lv[k]), eps));
        if (yb > 0) b = min(b, wadd(wsub(pp[k], hv[k]), eps));
      }
    };
  });
}

template <bool kShared, bool kProbe>
__global__ void __launch_bounds__(kThreads, 1)
transport_tiered_kernel(const int* __restrict__ wlo_in,
                        const int* __restrict__ whi_in,
                        const int* __restrict__ r_in,
                        const int* __restrict__ supply_in,
                        const int* __restrict__ cap_in,
                        const int* __restrict__ eps_in,
                        int* __restrict__ y_out, int* __restrict__ pm_out,
                        int* __restrict__ result, int* __restrict__ scratch,
                        int C, int Mp, int alpha, int max_supersteps,
                        int refine_waves, const RowPlan plan_in, const Layout layout,
                        long long* __restrict__ cycles) {
  extern __shared__ int4 smem4[];
  int* smem = reinterpret_cast<int*>(smem4);
  int eps = *eps_in;
  Probe<kProbe> probe(cycles);
  load_plan(plan_in);  // published by the prologue's barrier
  const RowPlan& plan = s_plan;

  // ---- the state, where the host's layout put it ----
  State s;
  s.C = C;
  s.Mp = Mp;
  s.ld = (Mp + kGroup - 1) / kGroup * kGroup;
  s.S = plan_in.split ? kWarps : C + 1;
  s.carve<kShared>(layout, smem, scratch);
  s.r = place<kShared>(layout, kR, smem, scratch);
  s.wlo = place<kShared>(layout, kWlo, smem, scratch);
  s.whi = place<kShared>(layout, kWhi, smem, scratch);
  const int ld = s.ld;

  // ---- prologue, column phase: inputs in, zero flow, the resident
  // tile clamped to U, cold prices (0 on live columns, dead ones sunk
  // to -BIG_D); the columns past Mp dead ----
  for (int m = threadIdx.x; m < ld; m += kThreads) {
    const bool live = m < Mp;
    const int cp = live ? cap_in[m] : 0;
    s.cap[m] = cp;
    s.pm[m] = cp > 0 ? 0 : -kBigD;
    s.z[m] = 0;
    s.ecol[m] = 0;
    for (int c = 0; c < C; ++c) {
      const int i = c * ld + m, j = c * Mp + m;
      s.y[i] = 0;
      s.r[i] = live ? min(r_in[j], min(supply_in[c], cp)) : 0;
      s.wlo[i] = live ? wlo_in[j] : 0;
      s.whi[i] = live ? whi_in[j] : 0;
    }
  }
  for (int r = threadIdx.x; r < C; r += kThreads) s.supply[r] = supply_in[r];
  __syncthreads();

  // ---- prologue, row pass: tightening against the cheap tier,
  // pr = max_{U>0}(pm - wLo) (0 with no arc); psink = min_{cap>0} pm
  // (0 with no live column); sum(supply) ----
  tighten_rows(s, plan, [&](int row) {
    const int sup = s.supply[row];
    const int *pm = s.pm, *cap = s.cap, *lot = s.wlo + row * ld;
    return [=](int g, bool& any, int& mx) {
      const int4 c4 = ld4(cap, g), p4 = ld4(pm, g), l4 = ld4(lot, g);
      const int cc[4] = {c4.x, c4.y, c4.z, c4.w}, pp[4] = {p4.x, p4.y, p4.z, p4.w};
      const int lv[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        if (min(sup, cc[k]) > 0) {
          any = true;
          mx = max(mx, wsub(pp[k], lv[k]));
        }
      }
    };
  });

  // ---- the phase loop, as in B1 ----
  const PlanLane pl(plan, threadIdx.x & 31);
  RowState rs{};
  probe.lap();
  int steps = 0, cur = 0;
  bool done = false;
  const auto fwd = [&](int row) { return forward_cell(s, row, cur ? s.pr1 : s.pr0); };
  while (!done && steps < max_supersteps) {
    const bool active = phase_a<false>(s, plan, pl, s_psink[cur], fwd, rs);
    probe.mark(kProbeExcess);
    if (active) {
      superstep(s, plan, rs, cur, eps, probe);
      cur ^= 1;
      ++steps;
    } else if (eps <= 1) {
      done = true;
    } else {
      eps = max(1, eps / alpha);  // eps >= 2 > 0: truncation == floor
      int* pr = cur ? s.pr1 : s.pr0;
      if (refine_waves > 0) {
        for (int k = 0; k < refine_waves; ++k) refine_wave(s, plan, pr, cur, eps);
        saturate(s, pr, s_psink[cur], eps);
      } else {
        saturate(s, pr, s_psink[cur], 0);
      }
      probe.mark(kProbePhase);
    }
  }
  const bool unbalanced = phase_a<true>(s, plan, pl, s_psink[cur], fwd, rs);
  probe.mark(kProbeExcess);

  // ---- epilogue: outputs out ----
  for (int m = threadIdx.x; m < Mp; m += kThreads) {
    pm_out[m] = s.pm[m];
    for (int c = 0; c < C; ++c) y_out[c * Mp + m] = s.y[c * ld + m];
  }
  if (threadIdx.x == 0) {
    result[0] = steps;
    result[1] = (done && !unbalanced) ? 1 : 0;
  }
  probe.finish();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of this kernel may use on the current
// device: the opt-in limit less the kernel's static shared variables.
// Negative: minus a cudaError_t code.
long long ksched_transport_tiered_smem_budget() {
  return smem_budget(transport_tiered_kernel<false, false>);
}

// Launch one tiered solve on `stream`. Pointers are device pointers
// except `plan` (kPlanWords ints: ops/transport.py RowPlan.pack) and
// `layout` (kTieredArrays ints: ops/transport.py layout), which are
// host memory; eps_in holds the start eps (an int32 on the device);
// `cycles`, when not null, receives the phase probe (kProbeTotal + 1
// int64). Returns a cudaError_t code (0 = launched).
int ksched_transport_tiered_solve(const void* wlo, const void* whi,
                                  const void* r, const void* supply,
                                  const void* cap, const void* eps_in,
                                  void* y, void* pm, void* result,
                                  void* scratch, const int* plan,
                                  const int* layout, int smem_bytes, int C,
                                  int Mp, int alpha, int max_supersteps,
                                  int refine_waves, void* cycles, void* stream) {
  RowPlan p;
  Layout L;
  read_plan(plan, layout, kTieredArrays, &p, &L);
  const auto kernel = pick(
      all_shared(L, kTieredArrays), cycles != nullptr,
      transport_tiered_kernel<true, true>, transport_tiered_kernel<true, false>,
      transport_tiered_kernel<false, true>, transport_tiered_kernel<false, false>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  kernel<<<1, kThreads, static_cast<size_t>(smem_bytes),
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(wlo), static_cast<const int*>(whi),
      static_cast<const int*>(r), static_cast<const int*>(supply),
      static_cast<const int*>(cap), static_cast<const int*>(eps_in),
      static_cast<int*>(y), static_cast<int*>(pm), static_cast<int*>(result),
      static_cast<int*>(scratch), C, Mp, alpha, max_supersteps, refine_waves, p, L,
      static_cast<long long*>(cycles));
  return cudaGetLastError();
}

// Resources of instantiation `k` of the kernel (0: state in shared
// memory with the probe, 1: shared, 2: global with the probe, 3: global)
// into out[5] (func_attrs). Returns 0, -1 for no such k, or a
// cudaError_t code.
int ksched_transport_tiered_kernel_attrs(int k, int* out) {
  const void* kernels[] = {
      reinterpret_cast<const void*>(transport_tiered_kernel<true, true>),
      reinterpret_cast<const void*>(transport_tiered_kernel<true, false>),
      reinterpret_cast<const void*>(transport_tiered_kernel<false, true>),
      reinterpret_cast<const void*>(transport_tiered_kernel<false, false>)};
  if (k < 0 || k >= 4) return -1;
  return func_attrs(kernels[k], out);
}

}  // extern "C"
