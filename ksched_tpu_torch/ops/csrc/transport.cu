// The dense layered-transport min-cost-flow solve, one launch per solve.
//
// Replaces ksched_tpu/ops/transport_pallas.py::_transport_kernel and
// computes what it computes, bit for bit: price tightening from the
// carried machine prices pm0, then the eps-scaling phase loop (eps /=
// alpha) with saturate or `refine_waves` price-refine waves between
// phases; each superstep is a synchronous maximal push plus jump
// relabel. The plain PyTorch version is solver/layered.py
// `_solve_transport`.
//
// What bounds it: neither bytes nor operations (ops/transport.py), but
// the latency of a chain of dependent supersteps, each a few block-wide
// barriers apart, on one SM. The layout answers by keeping the state on
// chip, the launch count at one and every pass on all 32 warps. One
// block of 1024 threads runs the whole solve, in two kinds of pass
// separated by barriers:
//   - column passes: a thread owns column m (striding by 1024 when
//     Mp > 1024) and walks the C rows itself, in ascending row order —
//     the column-direction exclusive prefix (sink entry first, then the
//     backward col->row entries) runs in-thread, in the same order as
//     transport_pallas.py:146-152;
//   - row passes: the row push (:140-143), the sink push-back (:155-157)
//     and the rows' price bounds run over the host's row-split plan, all
//     32 warps on slices of rows 0..C (row C the sink) with one int4 per
//     lane, conflict-free; the push prefix in two phases around one
//     barrier (transport_common.cuh).
// Every update of a superstep is computed from the old state: phase A
// stores the admissible residuals in the [C, ld] tile `df` and the
// sink's in `dzb`, phase B turns them into pushes, the row relabels
// write the new row prices to the other half of a double buffer (the
// sink price likewise), and the column phase then reads the old row
// prices and writes y, z and pm of its own column in place.
// State: the vectors and the y, df and wS tiles in shared memory while
// they fit (all of them at [4, 1024]), the rest in global memory, as the
// host's layout places them (ops/transport.py `layout`).

#include "transport_common.cuh"

namespace {

// this kernel's tile, after the shared arrays
enum TransportArray { kW = kCoreArrays, kTransportArrays };

struct State : Core {
  int* w;  // [C, ld] scaled costs
};

// Phase A's cell of source row `row`: per group the forward admissible
// residual, the flow, and the relabel candidate pm - wS over forward
// residuals.
__device__ __forceinline__ auto forward_cell(const State& s, int row, const int* prc) {
  const int sup = s.supply[row], prr = prc[row];
  const int off = row * s.ld;
  const int *pm = s.pm, *cap = s.cap, *wt = s.w + off, *yt = s.y + off;
  return [=](int g, int& flow, int& best) {
    const int4 p4 = ld4(pm, g), c4 = ld4(cap, g), w4 = ld4(wt, g), y4 = ld4(yt, g);
    const int pp[4] = {p4.x, p4.y, p4.z, p4.w}, cc[4] = {c4.x, c4.y, c4.z, c4.w};
    const int wv[4] = {w4.x, w4.y, w4.z, w4.w}, yv[4] = {y4.x, y4.y, y4.z, y4.w};
    int a[4];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const int rf = wsub(min(sup, cc[k]), yv[k]);
      flow = wadd(flow, yv[k]);
      a[k] = 0;
      if (rf > 0) {
        best = max(best, wsub(pp[k], wv[k]));
        if (wsub(wadd(wv[k], prr), pp[k]) < 0) a[k] = rf;
      }
    }
    return make_int4(a[0], a[1], a[2], a[3]);
  };
}

// One synchronous push/relabel superstep (transport_superstep), after
// phase A (the admissible sweep and the excesses, in the loop).
template <class P>
__device__ __forceinline__
void superstep(const State& s, const RowPlan& plan, const RowState& rs,
               int cur, int eps, P& probe) {
  // ---- phase B: forward pushes; sink push-back ----
  phase_b(s, plan, rs);
  probe.mark(kProbeRow);

  // ---- column phase: sink push, backward pushes, flow update, column
  // relabels — all from the old prices — and the new column excess;
  // the row relabels ----
  const int* prc = cur ? s.pr1 : s.pr0;
  const int ps = s_psink[cur];
  relabel_rows(s, plan, rs, cur, eps);
  for (int m = threadIdx.x; m < s.Mp; m += kThreads) {
    const int zz = s.z[m], pmm = s.pm[m], ec = s.ecol[m];
    const int rsk = wsub(s.cap[m], zz);
    const int adm_s = (rsk > 0 && wsub(pmm, ps) < 0) ? rsk : 0;
    const int ds = clip0(ec, adm_s);
    bool pushed = ds != 0;
    int run = adm_s;  // exclusive prefix: sink entry first
    int cand = -kBig, flow = 0;
    for (int c = 0; c < s.C; ++c) {
      const int i = c * s.ld + m;
      const int yy = s.y[i], ww = s.w[i], prr = prc[c];
      const int rcb = wsub(wsub(pmm, prr), ww);
      const int ab = (yy > 0 && rcb < 0) ? yy : 0;
      const int db = clip0(wsub(ec, run), ab);
      run = wadd(run, ab);
      pushed |= db != 0;
      if (yy > 0) cand = max(cand, wadd(prr, ww));
      const int y2 = wsub(wadd(yy, s.df[i]), db);
      s.y[i] = y2;
      flow = wadd(flow, y2);
    }
    cand = max(cand, rsk > 0 ? ps : -kBig);
    const int z2 = wsub(wadd(zz, ds), s.dzb[m]);
    s.z[m] = z2;
    s.ecol[m] = wsub(flow, z2);
    s.pm[m] = (ec > 0 && !pushed) ? wsub(cand, eps) : pmm;
  }
  __syncthreads();
  probe.mark(kProbeColumn);
}

// Phase start: saturate (eps_sat = 0) or partial saturate
// (transport_saturate_eps) at eps_sat; the column excesses of the new
// flow.
__device__ __forceinline__
void saturate(const State& s, const int* pr, int ps, int eps_sat) {
  for (int m = threadIdx.x; m < s.Mp; m += kThreads) {
    const int pmm = s.pm[m], cp = s.cap[m];
    int flow = 0;
    for (int c = 0; c < s.C; ++c) {
      const int i = c * s.ld + m;
      const int rcf = wsub(wadd(s.w[i], pr[c]), pmm);
      int yy = s.y[i];
      if (rcf < -eps_sat) {
        yy = min(s.supply[c], cp);
      } else if (rcf > eps_sat) {
        yy = 0;
      }
      s.y[i] = yy;
      flow = wadd(flow, yy);
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

// One price-refine wave (_price_refine's body) at eps, in place.
__device__ __forceinline__
void refine_wave(const State& s, const RowPlan& plan, int* pr, int cur,
                 int eps) {
  const int ps = s_psink[cur];
  // pm <= wS + pr + eps over forward residuals, pm <= psink + eps
  // over sink->col residuals
  for (int m = threadIdx.x; m < s.Mp; m += kThreads) {
    const int cp = s.cap[m];
    int bound = kBig;
    for (int c = 0; c < s.C; ++c) {
      const int i = c * s.ld + m;
      if (wsub(min(s.supply[c], cp), s.y[i]) > 0)
        bound = min(bound, wadd(wadd(s.w[i], pr[c]), eps));
    }
    int p2 = max(min(s.pm[m], bound), -kBigD);
    p2 = min(p2, s.z[m] > 0 ? wadd(ps, eps) : kBig);
    s.pm[m] = p2;
  }
  __syncthreads();
  // pr <= pm - wS + eps over backward residuals; psink <= pm + eps
  // over col->sink residuals
  refine_rows(s, plan, pr, cur, eps, [&](int row) {
    const int off = row * s.ld;
    const int *pm = s.pm, *wt = s.w + off, *yt = s.y + off;
    return [=](int g, int& b) {
      const int4 p4 = ld4(pm, g), w4 = ld4(wt, g), y4 = ld4(yt, g);
      const int pp[4] = {p4.x, p4.y, p4.z, p4.w}, wv[4] = {w4.x, w4.y, w4.z, w4.w};
      const int yv[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        if (yv[k] > 0) b = min(b, wadd(wsub(pp[k], wv[k]), eps));
      }
    };
  });
}

template <bool kShared, bool kProbe>
__global__ void __launch_bounds__(kThreads, 1)
transport_kernel(const int* __restrict__ w_in, const int* __restrict__ supply_in,
                 const int* __restrict__ cap_in, const int* __restrict__ pm_init,
                 const int* __restrict__ eps_in, int* __restrict__ y_out,
                 int* __restrict__ pm_out, int* __restrict__ result,
                 int* __restrict__ scratch,
                 int C, int Mp, int eps, int alpha, int max_supersteps,
                 int refine_waves, const RowPlan plan_in, const Layout layout,
                 long long* __restrict__ cycles) {
  extern __shared__ int4 smem4[];
  int* smem = reinterpret_cast<int*>(smem4);
  if (eps_in) eps = *eps_in;  // the start eps, from device memory
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
  s.w = place<kShared>(layout, kW, smem, scratch);
  const int ld = s.ld;

  // ---- prologue, column phase: inputs in, zero flow, clamped prices
  // (dead columns sunk to -BIG_D); the columns past Mp dead ----
  for (int m = threadIdx.x; m < ld; m += kThreads) {
    const bool live = m < Mp;
    const int cp = live ? cap_in[m] : 0;
    s.cap[m] = cp;
    const int p0 = pm_init && live ? pm_init[m] : 0;
    s.pm[m] = cp > 0 ? min(max(p0, -kBigD), kBigD) : -kBigD;
    s.z[m] = 0;
    s.ecol[m] = 0;
    for (int c = 0; c < C; ++c) {
      const int i = c * ld + m;
      s.y[i] = 0;
      s.w[i] = live ? w_in[c * Mp + m] : 0;
    }
  }
  for (int r = threadIdx.x; r < C; r += kThreads) s.supply[r] = supply_in[r];
  __syncthreads();

  // ---- prologue, row pass: pr = max_{U>0}(pm - wS) (0 with no arc);
  // psink = min_{cap>0} pm (0 with no live column); sum(supply) ----
  tighten_rows(s, plan, [&](int row) {
    const int sup = s.supply[row];
    const int *pm = s.pm, *cap = s.cap, *wt = s.w + row * ld;
    return [=](int g, bool& any, int& mx) {
      const int4 c4 = ld4(cap, g), p4 = ld4(pm, g), w4 = ld4(wt, g);
      const int cc[4] = {c4.x, c4.y, c4.z, c4.w}, pp[4] = {p4.x, p4.y, p4.z, p4.w};
      const int wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        if (min(sup, cc[k]) > 0) {
          any = true;
          mx = max(mx, wsub(pp[k], wv[k]));
        }
      }
    };
  });

  // ---- the phase loop; every thread holds the same eps/steps/done/cur,
  // since each decision comes from a block-wide barrier-reduction and,
  // with split rows, warp reductions of the same words ----
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
long long ksched_transport_smem_budget() {
  return smem_budget(transport_kernel<false, false>);
}

// Launch one solve on `stream`. Pointers are device pointers except
// `plan` (kPlanWords ints: ops/transport.py RowPlan.pack) and `layout`
// (kTransportArrays ints: ops/transport.py layout), which are host
// memory; pm_init may be null (cold start); eps_in, when not null, holds
// the start eps (an int32 on the device) and replaces `eps`; `cycles`,
// when not null, receives the phase probe (kProbeTotal + 1 int64).
// Returns a cudaError_t code (0 = launched).
int ksched_transport_solve(const void* w, const void* supply, const void* cap,
                           const void* pm_init, const void* eps_in, void* y,
                           void* pm, void* result, void* scratch, const int* plan,
                           const int* layout, int smem_bytes, int C, int Mp,
                           int eps, int alpha, int max_supersteps,
                           int refine_waves, void* cycles, void* stream) {
  RowPlan p;
  Layout L;
  read_plan(plan, layout, kTransportArrays, &p, &L);
  const auto kernel = pick(all_shared(L, kTransportArrays), cycles != nullptr,
                           transport_kernel<true, true>, transport_kernel<true, false>,
                           transport_kernel<false, true>, transport_kernel<false, false>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  kernel<<<1, kThreads, static_cast<size_t>(smem_bytes),
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(w), static_cast<const int*>(supply),
      static_cast<const int*>(cap), static_cast<const int*>(pm_init),
      static_cast<const int*>(eps_in), static_cast<int*>(y),
      static_cast<int*>(pm), static_cast<int*>(result),
      static_cast<int*>(scratch), C, Mp, eps, alpha, max_supersteps,
      refine_waves, p, L, static_cast<long long*>(cycles));
  return cudaGetLastError();
}

// Resources of instantiation `k` of the kernel (0: state in shared
// memory with the probe, 1: shared, 2: global with the probe, 3: global)
// into out[5] (func_attrs). Returns 0, -1 for no such k, or a
// cudaError_t code.
int ksched_transport_kernel_attrs(int k, int* out) {
  const void* kernels[] = {
      reinterpret_cast<const void*>(transport_kernel<true, true>),
      reinterpret_cast<const void*>(transport_kernel<true, false>),
      reinterpret_cast<const void*>(transport_kernel<false, true>),
      reinterpret_cast<const void*>(transport_kernel<false, false>)};
  if (k < 0 || k >= 4) return -1;
  return func_attrs(kernels[k], out);
}

}  // extern "C"
