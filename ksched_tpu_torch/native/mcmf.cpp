// Native min-cost max-flow library: the framework's in-process equivalent
// of the reference's external Flowlessly C++ binary
// (scheduling/flow/placement/solver.go:31-34; build/Dockerfile:11-12).
//
// Where the reference streams DIMACS text to a solver daemon over pipes,
// this library takes flat arrays (src/dst/cap/cost/excess) in-process and
// writes per-arc flows back — the same "arrays in, arrays out" wire format
// the JAX/TPU backend uses, so all backends sit behind one seam.
//
// Two algorithms, mirroring Flowlessly's successive_shortest_path and
// cost_scaling flags (solver.go:32):
//   0 = successive shortest paths (multi-source Dijkstra + Johnson
//       potentials, Bellman-Ford bootstrap for negative costs) — exact,
//       the parity oracle.
//   1 = cost-scaling push-relabel (Goldberg-Tarjan) with FIFO discharge —
//       the fast path; node prices persist in an opaque context so
//       incremental rounds warm-start, the property Flowlessly's daemon
//       mode provides (solver.go:60-90).
//
// Build: g++ -O3 -shared -fPIC (see build.py). No external deps.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <limits>
#include <queue>
#include <vector>

namespace {

constexpr int64_t kInf = std::numeric_limits<int64_t>::max() / 4;

// Residual graph: two directed edges per live input arc, stored so that
// edge 2k is arc k forward and 2k+1 its reverse (pair = e ^ 1).
struct Residual {
  int32_t n = 0;
  int64_t ne = 0;               // number of residual edges (2 * live arcs)
  std::vector<int32_t> to;      // head of each residual edge
  std::vector<int32_t> tail;    // tail of each residual edge
  std::vector<int64_t> resid;   // residual capacity
  std::vector<int64_t> cost;    // edge cost (reverse = -forward)
  std::vector<int64_t> arc_of;  // input arc index for edge (for flow readback)
  std::vector<int64_t> first;   // CSR row pointer [n+1]
  std::vector<int64_t> adj;     // CSR payload: residual edge ids
};

void build_residual(Residual &g, int32_t n, int64_t m, const int32_t *src,
                    const int32_t *dst, const int32_t *cap,
                    const int32_t *cost) {
  g.n = n;
  g.to.clear();
  g.tail.clear();
  g.resid.clear();
  g.cost.clear();
  g.arc_of.clear();
  for (int64_t k = 0; k < m; ++k) {
    if (cap[k] <= 0) continue;  // padded / deleted arc slot
    int32_t u = src[k], v = dst[k];
    g.tail.push_back(u);
    g.to.push_back(v);
    g.resid.push_back(cap[k]);
    g.cost.push_back(cost[k]);
    g.arc_of.push_back(k);
    g.tail.push_back(v);
    g.to.push_back(u);
    g.resid.push_back(0);
    g.cost.push_back(-static_cast<int64_t>(cost[k]));
    g.arc_of.push_back(k);
  }
  g.ne = static_cast<int64_t>(g.to.size());
  g.first.assign(static_cast<size_t>(n) + 1, 0);
  for (int64_t e = 0; e < g.ne; ++e) g.first[g.tail[e] + 1]++;
  for (int32_t v = 0; v < n; ++v) g.first[v + 1] += g.first[v];
  g.adj.assign(g.ne, 0);
  std::vector<int64_t> pos(g.first.begin(), g.first.end() - 1);
  for (int64_t e = 0; e < g.ne; ++e) g.adj[pos[g.tail[e]]++] = e;
}

// ---------------------------------------------------------------------------
// Algorithm 0: successive shortest paths.
// ---------------------------------------------------------------------------

int32_t solve_ssp(Residual &g, std::vector<int64_t> &excess, int64_t *iters) {
  const int32_t n = g.n;
  std::vector<int64_t> pot(n, 0);

  bool has_negative = false;
  for (int64_t e = 0; e < g.ne; e += 2)
    if (g.resid[e] > 0 && g.cost[e] < 0) {
      has_negative = true;
      break;
    }
  if (has_negative) {  // Bellman-Ford potential bootstrap
    for (int32_t round = 0; round <= n; ++round) {
      bool changed = false;
      for (int64_t e = 0; e < g.ne; ++e) {
        if (g.resid[e] <= 0) continue;
        int64_t cand = pot[g.tail[e]] + g.cost[e];
        if (cand < pot[g.to[e]]) {
          pot[g.to[e]] = cand;
          changed = true;
        }
      }
      if (!changed) break;
      if (round == n) return 4;  // negative cycle
    }
  }

  std::vector<int64_t> dist(n);
  std::vector<int64_t> parent(n);  // residual edge id into node, -1 = none
  using QE = std::pair<int64_t, int32_t>;
  int64_t augmentations = 0;

  for (;;) {
    std::priority_queue<QE, std::vector<QE>, std::greater<QE>> pq;
    std::fill(dist.begin(), dist.end(), kInf);
    std::fill(parent.begin(), parent.end(), int64_t{-1});
    bool any_supply = false;
    for (int32_t v = 0; v < n; ++v)
      if (excess[v] > 0) {
        dist[v] = 0;
        pq.emplace(0, v);
        any_supply = true;
      }
    if (!any_supply) break;
    int32_t demand = -1;
    while (!pq.empty()) {
      auto [d, v] = pq.top();
      pq.pop();
      if (d > dist[v]) continue;
      if (excess[v] < 0) {
        demand = v;
        break;
      }
      for (int64_t i = g.first[v]; i < g.first[v + 1]; ++i) {
        int64_t e = g.adj[i];
        if (g.resid[e] <= 0) continue;
        int32_t w = g.to[e];
        int64_t nd = d + g.cost[e] + pot[v] - pot[w];
        if (nd < dist[w]) {
          dist[w] = nd;
          parent[w] = e;
          pq.emplace(nd, w);
        }
      }
    }
    if (demand < 0) return 1;  // supply cannot reach any demand
    int64_t dt = dist[demand];
    for (int32_t v = 0; v < n; ++v)
      pot[v] += std::min(dist[v], dt);
    // bottleneck along the path
    int64_t bottleneck = -excess[demand];
    for (int32_t v = demand; parent[v] >= 0; v = g.tail[parent[v]])
      bottleneck = std::min(bottleneck, g.resid[parent[v]]);
    int32_t source = demand;
    while (parent[source] >= 0) source = g.tail[parent[source]];
    bottleneck = std::min(bottleneck, excess[source]);
    for (int32_t v = demand; parent[v] >= 0; v = g.tail[parent[v]]) {
      g.resid[parent[v]] -= bottleneck;
      g.resid[parent[v] ^ 1] += bottleneck;
    }
    excess[source] -= bottleneck;
    excess[demand] += bottleneck;
    ++augmentations;
  }
  *iters = augmentations;
  return 0;
}

// ---------------------------------------------------------------------------
// Algorithm 1: cost-scaling push-relabel.
//
// eps-optimality invariant: every residual edge e has reduced cost
// rc(e) = cost(e) + p[tail] - p[head] >= -eps. Costs are pre-scaled by
// (n + 1) so the eps == 1 phase yields an exact optimum for the original
// integer costs. Prices p persist across calls via SolverCtx (warm start).
// ---------------------------------------------------------------------------

struct SolverCtx {
  std::vector<int64_t> prices;
  int64_t supersteps = 0;  // total discharge operations, for stats
};

int32_t solve_cost_scaling(Residual &g, std::vector<int64_t> &excess,
                           SolverCtx *ctx, int64_t *iters) {
  const int32_t n = g.n;
  const int64_t scale = static_cast<int64_t>(n) + 1;
  int64_t max_c = 0;
  for (int64_t e = 0; e < g.ne; e += 2)
    max_c = std::max(max_c, std::abs(g.cost[e]));
  std::vector<int64_t> c(g.ne);
  for (int64_t e = 0; e < g.ne; ++e) c[e] = g.cost[e] * scale;

  std::vector<int64_t> local_prices;
  std::vector<int64_t> &p =
      (ctx != nullptr) ? ctx->prices : local_prices;
  if (static_cast<int32_t>(p.size()) != n) p.assign(n, 0);

  std::vector<int64_t> cur(n);  // current-arc pointers
  std::deque<int32_t> active;
  std::vector<uint8_t> in_queue(n, 0);
  int64_t total_discharges = 0;

  int64_t eps = std::max<int64_t>(1, max_c * scale);
  constexpr int64_t kAlpha = 8;

  for (;;) {
    // Make the pseudoflow eps-optimal: saturate negative-reduced-cost arcs.
    for (int64_t e = 0; e < g.ne; ++e) {
      if (g.resid[e] <= 0) continue;
      int64_t rc = c[e] + p[g.tail[e]] - p[g.to[e]];
      if (rc < -eps) {
        int64_t amt = g.resid[e];
        g.resid[e] = 0;
        g.resid[e ^ 1] += amt;
        excess[g.tail[e]] -= amt;
        excess[g.to[e]] += amt;
      }
    }
    active.clear();
    std::fill(in_queue.begin(), in_queue.end(), 0);
    for (int32_t v = 0; v < n; ++v) {
      cur[v] = g.first[v];
      if (excess[v] > 0) {
        active.push_back(v);
        in_queue[v] = 1;
      }
    }
    // Per-phase price floor: feasible discharge lowers a price by at most
    // O(n * eps); far past that means supply is cut off from all demand.
    int64_t p_min = 0;
    for (int32_t v = 0; v < n; ++v) p_min = std::min(p_min, p[v]);
    const int64_t floor =
        p_min - (kAlpha + 3) * (static_cast<int64_t>(n) + 2) * eps - 16;

    while (!active.empty()) {
      int32_t u = active.front();
      active.pop_front();
      in_queue[u] = 0;
      ++total_discharges;
      // discharge u
      while (excess[u] > 0) {
        bool pushed_or_scanned = false;
        for (; cur[u] < g.first[u + 1]; ++cur[u]) {
          int64_t e = g.adj[cur[u]];
          if (g.resid[e] <= 0) continue;
          int32_t w = g.to[e];
          if (c[e] + p[u] - p[w] < 0) {  // admissible
            int64_t amt = std::min(excess[u], g.resid[e]);
            g.resid[e] -= amt;
            g.resid[e ^ 1] += amt;
            excess[u] -= amt;
            excess[w] += amt;
            if (excess[w] > 0 && !in_queue[w] && w != u) {
              active.push_back(w);
              in_queue[w] = 1;
            }
            if (excess[u] == 0) {
              pushed_or_scanned = true;
              break;
            }
          }
        }
        if (excess[u] == 0) break;
        (void)pushed_or_scanned;
        // relabel: p[u] = max over residual (u,w) of (p[w] - c(u,w)) - eps
        // (the smallest decrease that makes one arc admissible; max keeps
        // rc >= -eps on every other residual arc out of u)
        int64_t best = -kInf;
        for (int64_t i = g.first[u]; i < g.first[u + 1]; ++i) {
          int64_t e = g.adj[i];
          if (g.resid[e] <= 0) continue;
          best = std::max(best, p[g.to[e]] - c[e]);
        }
        if (best <= -kInf) return 1;  // no residual arc at all: infeasible
        p[u] = best - eps;
        cur[u] = g.first[u];
        if (p[u] < floor) return 1;  // price divergence: infeasible
      }
    }
    if (eps == 1) break;
    eps = std::max<int64_t>(1, eps / kAlpha);
  }
  if (ctx != nullptr) ctx->supersteps = total_discharges;
  *iters = total_discharges;
  return 0;
}

}  // namespace

extern "C" {

void *ksched_mcmf_ctx_new() { return new SolverCtx(); }

void ksched_mcmf_ctx_free(void *ctx) {
  delete static_cast<SolverCtx *>(ctx);
}

// Returns 0 ok, 1 infeasible, 2 unbalanced excess, 3 bad args,
// 4 negative-cost cycle.
int32_t ksched_mcmf_solve(void *ctx_ptr, int32_t algorithm, int32_t n,
                          int64_t m, const int32_t *src, const int32_t *dst,
                          const int32_t *cap, const int32_t *cost,
                          const int64_t *excess_in, int64_t *flow_out,
                          int64_t *objective_out, int64_t *iters_out) {
  if (n <= 0 || m < 0 || !src || !dst || !cap || !cost || !excess_in ||
      !flow_out || !objective_out || !iters_out)
    return 3;
  for (int64_t k = 0; k < m; ++k)
    if (cap[k] > 0 && (src[k] < 0 || src[k] >= n || dst[k] < 0 || dst[k] >= n))
      return 3;
  int64_t balance = 0;
  for (int32_t v = 0; v < n; ++v) balance += excess_in[v];
  if (balance != 0) return 2;

  Residual g;
  build_residual(g, n, m, src, dst, cap, cost);
  std::vector<int64_t> excess(excess_in, excess_in + n);

  int64_t iters = 0;
  int32_t rc;
  if (algorithm == 0) {
    rc = solve_ssp(g, excess, &iters);
  } else {
    rc = solve_cost_scaling(g, excess, static_cast<SolverCtx *>(ctx_ptr),
                            &iters);
  }
  if (rc != 0) return rc;

  std::memset(flow_out, 0, static_cast<size_t>(m) * sizeof(int64_t));
  int64_t objective = 0;
  for (int64_t e = 0; e < g.ne; e += 2) {
    int64_t f = g.resid[e ^ 1];  // flow = reverse residual
    flow_out[g.arc_of[e]] = f;
    objective += f * g.cost[e];
  }
  *objective_out = objective;
  *iters_out = iters;
  return 0;
}

}  // extern "C"
