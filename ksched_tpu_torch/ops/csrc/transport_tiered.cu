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
// PyTorch version is solver/layered.py `_solve_transport_tiered`; see
// ops/transport.py for what bounds the transport kernels and why each
// is one block.
//
// Layout: B1's (transport.cu). One block of 1024 threads runs the whole
// solve; decisions come from __syncthreads_or, so every thread holds
// the same eps/steps/done.
//   - row phases: a warp owns row r and sweeps its columns in ascending
//     order, 128 at a time; per cell the forward admissible residual is
//     tier A's at wLo plus tier B's at wHi, then B1's row prefix. Row C
//     is the sink (tier-less, as in B1).
//   - column phases: a thread owns column m and walks the 1 + 2C
//     entries of the column prefix in the order of transport_pallas.py:
//     352-361 — the sink, then the dear tier over rows ascending, then
//     the cheap tier over rows ascending. The dear pass folds its
//     backward pushes into the forward-push tile df (df -= db_hi), so
//     the cheap pass, which still reads the old y for yA, finishes each
//     cell with y += df - db_lo.
// State: the vectors of B1 and five [C, Mp] tiles — y, df, the clamped
// resident tile R (R = min(R_in, U), U = min(supply, col_cap), written
// by the prologue), wLo and wHi — in shared memory while they fit (all
// of them at [4, 1024]: 80 KB of tiles), the rest in global memory.

#include "transport_common.cuh"

namespace {

// which groups of state live in shared memory (else global memory)
constexpr int kSmemVec = 1;   // every [Mp] and [C] vector
constexpr int kSmemY = 2;     // the flow tile y
constexpr int kSmemDf = 4;    // the forward-push tile df
constexpr int kSmemR = 8;     // the clamped resident tile R
constexpr int kSmemLo = 16;   // a copy of the cheap-tier cost tile wLo
constexpr int kSmemHi = 32;   // a copy of the dear-tier cost tile wHi

struct State {
  int C, Mp;
  const int* wlo;     // [C, Mp] scaled cheap-tier costs
  const int* whi;     // [C, Mp] scaled dear-tier costs
  int* r;             // [C, Mp] resident capacity, clamped to U
  int* y;             // [C, Mp] flow (both tiers)
  int* df;            // [C, Mp] forward pushes of the current superstep
  const int* supply;  // [C]
  const int* cap;     // [Mp]
  int* z;             // [Mp] col->sink flow
  int* pm;            // [Mp] machine (column) prices
  int* ecol;          // [Mp] column excess
  int* dzb;           // [Mp] sink push-back of the current superstep
  int* pr0;           // [C] row prices, double buffered
  int* pr1;
  int* erow;          // [C] row excess
};

__shared__ int s_psink[2];   // sink price, double buffered like pr
__shared__ int s_esink;      // sink excess
__shared__ int s_total;      // sum(supply), wrapped

__device__ __forceinline__ int cell(const State& s, int r, int m) {
  return r * s.Mp + m;
}

template <bool kNonzero>
__device__ bool excess_phase(const State& s) {
  return block_excesses<kNonzero>(s.C, s.Mp, s.y, s.z, s.supply, s_total,
                                  s.ecol, s.erow, &s_esink);
}

// One synchronous push/relabel superstep (transport_superstep_tiered).
__device__ void superstep(const State& s, int cur, int eps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int* prc = cur ? s.pr1 : s.pr0;
  int* prn = cur ? s.pr0 : s.pr1;
  const int ps = s_psink[cur];

  // ---- row phase: forward pushes over both tiers, row relabels; sink
  // push-back ----
  for (int r = warp; r <= s.C; r += kWarps) {
    int carry = 0;
    bool pushed = false;
    if (r < s.C) {
      const int prr = prc[r], er = s.erow[r], sup = s.supply[r];
      int best = -kBig;
      for (int base = 0; base < s.Mp; base += kChunk) {
        const int m0 = base + lane * kPerLane;
        int ra[kPerLane];
        int local = 0;
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) {
          const int m = m0 + k;
          int a = 0;
          if (m < s.Mp) {
            const int i = cell(s, r, m);
            const int pmm = s.pm[m], rr = s.r[i], yy = s.y[i];
            const int lo = s.wlo[i], hi = s.whi[i];
            const int ya = min(yy, rr), yb = wsub(yy, ya);
            const int rA = wsub(rr, ya);
            const int rB = wsub(wsub(min(sup, s.cap[m]), rr), yb);
            if (rA > 0) {
              best = max(best, wsub(pmm, lo));
              if (wsub(wadd(lo, prr), pmm) < 0) a = rA;
            }
            if (rB > 0) {
              best = max(best, wsub(pmm, hi));
              if (wsub(wadd(hi, prr), pmm) < 0) a = wadd(a, rB);
            }
          }
          ra[k] = a;
          local = wadd(local, a);
        }
        const int incl = warp_incl_scan(local, lane);
        int run = wadd(carry, wsub(incl, local));
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) {
          const int m = m0 + k;
          if (m < s.Mp) {
            const int d = clip0(wsub(er, run), ra[k]);
            s.df[cell(s, r, m)] = d;
            pushed |= d != 0;
          }
          run = wadd(run, ra[k]);
        }
        carry = wadd(carry, __shfl_sync(kFull, incl, 31));
      }
      pushed = __any_sync(kFull, pushed);
      best = __reduce_max_sync(kFull, best);
      if (lane == 0) prn[r] = (er > 0 && !pushed) ? wsub(best, eps) : prr;
    } else {
      const int es = s_esink;
      int cand = -kBig;
      for (int base = 0; base < s.Mp; base += kChunk) {
        const int m0 = base + lane * kPerLane;
        int za[kPerLane];
        int local = 0;
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) {
          const int m = m0 + k;
          int a = 0;
          if (m < s.Mp) {
            const int zz = s.z[m], pmm = s.pm[m];
            if (zz > 0) {
              cand = max(cand, pmm);
              if (wsub(ps, pmm) < 0) a = zz;
            }
          }
          za[k] = a;
          local = wadd(local, a);
        }
        const int incl = warp_incl_scan(local, lane);
        int run = wadd(carry, wsub(incl, local));
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) {
          const int m = m0 + k;
          if (m < s.Mp) {
            const int d = clip0(wsub(es, run), za[k]);
            s.dzb[m] = d;
            pushed |= d != 0;
          }
          run = wadd(run, za[k]);
        }
        carry = wadd(carry, __shfl_sync(kFull, incl, 31));
      }
      pushed = __any_sync(kFull, pushed);
      cand = __reduce_max_sync(kFull, cand);
      if (lane == 0) s_psink[cur ^ 1] = (es > 0 && !pushed) ? wsub(cand, eps) : ps;
    }
  }
  __syncthreads();

  // ---- column phase: the sink push, then the dear-tier and the
  // cheap-tier backward pushes, the flow update and the column relabel,
  // all from the old prices ----
  for (int m = threadIdx.x; m < s.Mp; m += kThreads) {
    const int zz = s.z[m], pmm = s.pm[m], ec = s.ecol[m];
    const int rs = wsub(s.cap[m], zz);
    const int adm_s = (rs > 0 && wsub(pmm, ps) < 0) ? rs : 0;
    const int ds = clip0(ec, adm_s);
    bool pushed = ds != 0;
    int run = adm_s;  // exclusive prefix: sink entry first
    int cand = -kBig;
    for (int c = 0; c < s.C; ++c) {  // dear tier (cost -wHi backward)
      const int i = cell(s, c, m);
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
    for (int c = 0; c < s.C; ++c) {  // cheap tier (cost -wLo backward)
      const int i = cell(s, c, m);
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
      s.y[i] = wsub(wadd(yy, s.df[i]), dl);
    }
    cand = max(cand, rs > 0 ? ps : -kBig);
    s.z[m] = wsub(wadd(zz, ds), s.dzb[m]);
    s.pm[m] = (ec > 0 && !pushed) ? wsub(cand, eps) : pmm;
  }
  __syncthreads();
}

// Phase start: saturate (eps_sat = 0) or partial saturate
// (transport_saturate_eps_tiered) at eps_sat, per tier.
__device__ void saturate(const State& s, const int* pr, int ps, int eps_sat) {
  for (int m = threadIdx.x; m < s.Mp; m += kThreads) {
    const int pmm = s.pm[m], cp = s.cap[m];
    for (int c = 0; c < s.C; ++c) {
      const int i = cell(s, c, m);
      const int rr = s.r[i], yy = s.y[i];
      const int rcl = wsub(wadd(s.wlo[i], pr[c]), pmm);
      const int rch = wsub(wadd(s.whi[i], pr[c]), pmm);
      const int ya = min(yy, rr), yb = wsub(yy, ya);
      const int ya2 = rcl < -eps_sat ? rr : (rcl > eps_sat ? 0 : ya);
      const int yb2 = rch < -eps_sat ? wsub(min(s.supply[c], cp), rr)
                                     : (rch > eps_sat ? 0 : yb);
      s.y[i] = wadd(ya2, yb2);
    }
    const int rcs = wsub(pmm, ps);
    if (rcs < -eps_sat) {
      s.z[m] = cp;
    } else if (rcs > eps_sat) {
      s.z[m] = 0;
    }
  }
  __syncthreads();
}

// One tiered price-refine wave (_price_refine_tiered's body) at eps, in
// place.
__device__ void refine_wave(const State& s, int* pr, int cur, int eps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ps = s_psink[cur];
  // pm <= wLo + pr + eps over tier-A forward residuals, <= wHi + pr +
  // eps over tier-B ones, <= psink + eps over sink->col residuals
  for (int m = threadIdx.x; m < s.Mp; m += kThreads) {
    const int cp = s.cap[m];
    int bound = kBig;
    for (int c = 0; c < s.C; ++c) {
      const int i = cell(s, c, m);
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
  for (int r = warp; r <= s.C; r += kWarps) {
    int bound = kBig;
    if (r < s.C) {
      for (int m = lane; m < s.Mp; m += 32) {
        const int i = cell(s, r, m);
        const int yy = s.y[i];
        const int ya = min(yy, s.r[i]), yb = wsub(yy, ya);
        if (ya > 0) bound = min(bound, wadd(wsub(s.pm[m], s.wlo[i]), eps));
        if (yb > 0) bound = min(bound, wadd(wsub(s.pm[m], s.whi[i]), eps));
      }
      bound = __reduce_min_sync(kFull, bound);
      if (lane == 0) pr[r] = max(min(pr[r], bound), -kBigD);
    } else {
      for (int m = lane; m < s.Mp; m += 32) {
        if (wsub(s.cap[m], s.z[m]) > 0) bound = min(bound, wadd(s.pm[m], eps));
      }
      bound = __reduce_min_sync(kFull, bound);
      if (lane == 0) s_psink[cur] = max(min(ps, bound), -kBigD);
    }
  }
  __syncthreads();
}

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
                        int refine_waves, int flags) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int eps = *eps_in;

  // ---- carve the state: shared memory where the plan put it, else
  // the inputs/outputs themselves or the global scratch ----
  State s;
  s.C = C;
  s.Mp = Mp;
  int* sp = smem;
  int* gp = scratch;
  const bool sv = flags & kSmemVec;
  auto take = [&](bool in_smem, int n) {
    int* p = in_smem ? sp : gp;
    (in_smem ? sp : gp) += n;
    return p;
  };
  int* cap_s = sv ? take(true, Mp) : nullptr;
  int* sup_s = sv ? take(true, C) : nullptr;
  s.cap = sv ? cap_s : cap_in;
  s.supply = sv ? sup_s : supply_in;
  s.pm = sv ? take(true, Mp) : pm_out;
  s.z = take(sv, Mp);
  s.ecol = take(sv, Mp);
  s.dzb = take(sv, Mp);
  s.pr0 = take(sv, C);
  s.pr1 = take(sv, C);
  s.erow = take(sv, C);
  s.y = (flags & kSmemY) ? take(true, C * Mp) : y_out;
  s.df = take(flags & kSmemDf, C * Mp);
  s.r = take(flags & kSmemR, C * Mp);
  int* lo_s = (flags & kSmemLo) ? take(true, C * Mp) : nullptr;
  int* hi_s = (flags & kSmemHi) ? take(true, C * Mp) : nullptr;
  s.wlo = lo_s ? lo_s : wlo_in;
  s.whi = hi_s ? hi_s : whi_in;

  // ---- prologue, column phase: inputs in, zero flow, the resident
  // tile clamped to U, cold prices (0 on live columns, dead ones sunk
  // to -BIG_D) ----
  for (int m = threadIdx.x; m < Mp; m += kThreads) {
    const int cp = cap_in[m];
    if (cap_s) cap_s[m] = cp;
    s.pm[m] = cp > 0 ? 0 : -kBigD;
    s.z[m] = 0;
    for (int c = 0; c < C; ++c) {
      const int i = c * Mp + m;
      s.y[i] = 0;
      s.r[i] = min(r_in[i], min(supply_in[c], cp));
      if (lo_s) lo_s[i] = wlo_in[i];
      if (hi_s) hi_s[i] = whi_in[i];
    }
  }
  if (sup_s) {
    for (int r = threadIdx.x; r < C; r += kThreads) sup_s[r] = supply_in[r];
  }
  __syncthreads();

  // ---- prologue, row phase: tightening against the cheap tier,
  // pr = max_{U>0}(pm - wLo) (0 with no arc); psink = min_{cap>0} pm
  // (0 with no live column); sum(supply) ----
  for (int r = warp; r <= C; r += kWarps) {
    if (r < C) {
      const int sup = s.supply[r];
      int mx = -kBigD;
      bool any = false;
      for (int m = lane; m < Mp; m += 32) {
        if (min(sup, s.cap[m]) > 0) {
          any = true;
          mx = max(mx, wsub(s.pm[m], s.wlo[r * Mp + m]));
        }
      }
      any = __any_sync(kFull, any);
      mx = __reduce_max_sync(kFull, mx);
      if (lane == 0) s.pr0[r] = any ? mx : 0;
    } else {
      int mn = kBigD, total = 0;
      bool any = false;
      for (int m = lane; m < Mp; m += 32) {
        if (s.cap[m] > 0) {
          any = true;
          mn = min(mn, s.pm[m]);
        }
      }
      for (int c = lane; c < C; c += 32) total = wadd(total, s.supply[c]);
      any = __any_sync(kFull, any);
      mn = __reduce_min_sync(kFull, mn);
      total = warp_sum(total);
      if (lane == 0) {
        s_psink[0] = any ? mn : 0;
        s_total = total;
      }
    }
  }
  __syncthreads();

  // ---- the phase loop, as in B1 ----
  int steps = 0, cur = 0;
  bool done = false;
  while (!done && steps < max_supersteps) {
    if (excess_phase<false>(s)) {
      superstep(s, cur, eps);
      cur ^= 1;
      ++steps;
    } else if (eps <= 1) {
      done = true;
    } else {
      eps = max(1, eps / alpha);  // eps >= 2 > 0: truncation == floor
      int* pr = cur ? s.pr1 : s.pr0;
      if (refine_waves > 0) {
        for (int k = 0; k < refine_waves; ++k) refine_wave(s, pr, cur, eps);
        saturate(s, pr, s_psink[cur], eps);
      } else {
        saturate(s, pr, s_psink[cur], 0);
      }
    }
  }
  const bool unbalanced = excess_phase<true>(s);

  // ---- epilogue: outputs out of shared memory ----
  for (int m = threadIdx.x; m < Mp; m += kThreads) {
    if (sv) pm_out[m] = s.pm[m];
    if (flags & kSmemY) {
      for (int c = 0; c < C; ++c) y_out[c * Mp + m] = s.y[c * Mp + m];
    }
  }
  if (threadIdx.x == 0) {
    result[0] = steps;
    result[1] = (done && !unbalanced) ? 1 : 0;
  }
}

// Which state groups go to shared memory: the vectors first, then the
// y, df, R, wLo and wHi tiles while they fit. Returns the dynamic bytes.
long long plan_smem(int C, int Mp, long long budget, int* flags) {
  const long long vec = 5LL * Mp + 4LL * C, tile = 1LL * C * Mp;
  long long used = 0;
  int f = 0;
  if (vec * 4 <= budget) {
    f |= kSmemVec;
    used = vec;
    const int tiles[5] = {kSmemY, kSmemDf, kSmemR, kSmemLo, kSmemHi};
    for (int bit : tiles) {
      if ((used + tile) * 4 <= budget) {
        f |= bit;
        used += tile;
      }
    }
  }
  *flags = f;
  return used * 4;
}

}  // namespace

extern "C" {

// int32 words of global scratch one solve may need (vectors, df and R).
long long ksched_transport_tiered_scratch_words(int C, int Mp) {
  return 3LL * Mp + 3LL * C + 2LL * C * Mp;
}

// Launch one tiered solve on `stream`. Pointers are device pointers;
// eps_in holds the start eps (an int32 on the device). Returns a
// cudaError_t code (0 = launched).
int ksched_transport_tiered_solve(const void* wlo, const void* whi,
                                  const void* r, const void* supply,
                                  const void* cap, const void* eps_in,
                                  void* y, void* pm, void* result,
                                  void* scratch, int C, int Mp, int alpha,
                                  int max_supersteps, int refine_waves,
                                  void* stream) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  // room for the kernel's static shared variables
  const long long budget = static_cast<long long>(optin) - 256;
  int flags = 0;
  const long long bytes = plan_smem(C, Mp, budget, &flags);
  err = cudaFuncSetAttribute(transport_tiered_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  transport_tiered_kernel<<<1, kThreads, static_cast<size_t>(bytes),
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(wlo), static_cast<const int*>(whi),
      static_cast<const int*>(r), static_cast<const int*>(supply),
      static_cast<const int*>(cap), static_cast<const int*>(eps_in),
      static_cast<int*>(y), static_cast<int*>(pm), static_cast<int*>(result),
      static_cast<int*>(scratch), C, Mp, alpha, max_supersteps, refine_waves,
      flags);
  return cudaGetLastError();
}

}  // extern "C"
