// muninn native graph kernels: the host engine of the graph analytics.
//
// Classic sequential algorithms over a flat edge list or CSR, the ones
// the reference uses (graph_tvf.c BFS/Dijkstra, graph_centrality.c
// Brandes, graph_community.c Leiden). They give the same results as the
// device fixpoints of muninn_tpu_torch/graph (same parent tie-breaks,
// same epsilon rules, same Leiden gain formula), so the routing in
// graph/routing.py can send an operation to whichever engine is faster
// at its size. A copy of muninn_tpu/native/src/muninn_graph.cpp with the
// same code.
//
// All entry points are a flat C ABI consumed through ctypes.

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <queue>
#include <random>
#include <vector>

namespace {

constexpr int32_t kIntInf = 1 << 30;  // matches traversal.INT_INF

struct Csr {
    std::vector<int32_t> offsets;  // [V+1]
    std::vector<int32_t> dst;      // [E]
    std::vector<float> w;          // [E]
    std::vector<int64_t> eid;      // [E] original edge index
};

// Counting-sort CSR preserving input order within a source (stable),
// keeping the original edge index for edge-aligned outputs.
Csr build_csr(const int32_t* src, const int32_t* dst, const float* w,
              int64_t e, int32_t v) {
    Csr c;
    c.offsets.assign(static_cast<size_t>(v) + 1, 0);
    for (int64_t i = 0; i < e; i++) c.offsets[static_cast<size_t>(src[i]) + 1]++;
    for (int32_t i = 0; i < v; i++) c.offsets[i + 1] += c.offsets[i];
    c.dst.resize(static_cast<size_t>(e));
    c.w.resize(static_cast<size_t>(e));
    c.eid.resize(static_cast<size_t>(e));
    std::vector<int32_t> cursor(c.offsets.begin(), c.offsets.end() - 1);
    for (int64_t i = 0; i < e; i++) {
        int32_t p = cursor[src[i]]++;
        c.dst[p] = dst[i];
        c.w[p] = w ? w[i] : 1.0f;
        c.eid[p] = i;
    }
    return c;
}

// Relative tie tolerance shared with the device kernels
// (traversal.sssp_with_parents, centrality._brandes_batch).
inline bool tight(double du, double wuv, double dv) {
    return std::abs(du + wuv - dv) <= 1e-9 * std::max(1.0, std::abs(dv));
}

void dijkstra(const Csr& c, int32_t v, int32_t start, std::vector<double>& dist) {
    dist.assign(static_cast<size_t>(v),
                std::numeric_limits<double>::infinity());
    dist[start] = 0.0;
    using Item = std::pair<double, int32_t>;
    std::priority_queue<Item, std::vector<Item>, std::greater<Item>> pq;
    pq.push({0.0, start});
    while (!pq.empty()) {
        auto [d, u] = pq.top();
        pq.pop();
        if (d > dist[u]) continue;
        for (int32_t p = c.offsets[u]; p < c.offsets[u + 1]; p++) {
            double nd = d + c.w[p];
            if (nd < dist[c.dst[p]]) {
                dist[c.dst[p]] = nd;
                pq.push({nd, c.dst[p]});
            }
        }
    }
}

}  // namespace

extern "C" {

// ───────────────────────── BFS ─────────────────────────

// Forward-CSR BFS. depth[V] = kIntInf unreached; parent[V] = -1 for
// root/unreached. Parent = minimum-index predecessor at the previous
// depth — the device kernel's deterministic segment-min choice
// (traversal.bfs_device): iterating the frontier in ascending node
// order with first-writer-wins yields exactly that.
void muninn_graph_bfs(const int32_t* offsets, const int32_t* dst, int32_t v,
                      int32_t start, int32_t max_depth, int32_t* depth,
                      int32_t* parent) {
    std::fill(depth, depth + v, kIntInf);
    std::fill(parent, parent + v, -1);
    depth[start] = 0;
    std::vector<int32_t> frontier{start}, next;
    int32_t d = 0;
    while (!frontier.empty() && d < max_depth) {
        next.clear();
        for (int32_t u : frontier) {  // ascending: frontier built in order
            for (int32_t p = offsets[u]; p < offsets[u + 1]; p++) {
                int32_t t = dst[p];
                if (depth[t] == kIntInf) {
                    depth[t] = d + 1;
                    parent[t] = u;
                    next.push_back(t);
                }
            }
        }
        std::sort(next.begin(), next.end());
        next.erase(std::unique(next.begin(), next.end()), next.end());
        frontier.swap(next);
        d++;
    }
}

// ───────────────────────── DFS ─────────────────────────

// Preorder DFS over a forward CSR; lowest-index neighbor visited first
// (the reference TVF's enumeration contract, graph_tvf.c:230-416 —
// same order as traversal.dfs_host). Fills parallel (order, depth,
// parent) arrays of capacity v; *n_out = rows written.
void muninn_graph_dfs(const int32_t* offsets, const int32_t* dst, int32_t v,
                      int32_t start, int32_t max_depth, int32_t* order,
                      int32_t* depth, int32_t* parent, int32_t* n_out) {
    std::vector<uint8_t> visited(static_cast<size_t>(v), 0);
    struct Frame { int32_t node, depth, parent; };
    std::vector<Frame> stack;
    stack.push_back({start, 0, -1});
    int32_t n = 0;
    while (!stack.empty()) {
        Frame f = stack.back();
        stack.pop_back();
        if (visited[f.node]) continue;
        visited[f.node] = 1;
        order[n] = f.node;
        depth[n] = f.depth;
        parent[n] = f.parent;
        n++;
        if (f.depth >= max_depth) continue;
        // push reversed so the lowest-index neighbor pops first
        for (int32_t p = offsets[f.node + 1] - 1; p >= offsets[f.node]; p--) {
            int32_t t = dst[p];
            if (!visited[t]) stack.push_back({t, f.depth + 1, f.node});
        }
    }
    *n_out = n;
}

// ───────────────────────── components ─────────────────────────

// Union-find with path halving (the reference's structure,
// graph_tvf.c:1204-1360), labels = min node index per component — the
// same labels the device min-label propagation converges to.
void muninn_graph_components(const int32_t* src, const int32_t* dst,
                             int64_t e, int32_t v, int32_t* comp) {
    std::vector<int32_t> par(static_cast<size_t>(v));
    for (int32_t i = 0; i < v; i++) par[i] = i;
    auto find = [&](int32_t x) {
        while (par[x] != x) {
            par[x] = par[par[x]];
            x = par[x];
        }
        return x;
    };
    for (int64_t i = 0; i < e; i++) {
        int32_t a = find(src[i]), b = find(dst[i]);
        if (a != b) par[std::max(a, b)] = std::min(a, b);
    }
    for (int32_t i = 0; i < v; i++) comp[i] = find(i);
}

// ───────────────────────── PageRank ─────────────────────────

// Power iteration with dangling redistribution — the device formula
// (pagerank.pagerank_device) in double accumulation.
void muninn_graph_pagerank(const int32_t* src, const int32_t* dst,
                           const float* w, const float* out_degree,
                           int64_t e, int32_t v, float damping,
                           int32_t iterations, int32_t weighted,
                           float* rank_out) {
    std::vector<double> rank(static_cast<size_t>(v), 1.0 / v);
    std::vector<double> share(static_cast<size_t>(e));
    for (int64_t i = 0; i < e; i++) {
        double deg = std::max(static_cast<double>(out_degree[src[i]]), 1e-30);
        share[i] = (weighted ? static_cast<double>(w[i]) : 1.0) / deg;
    }
    std::vector<double> pulled(static_cast<size_t>(v));
    for (int32_t it = 0; it < iterations; it++) {
        std::fill(pulled.begin(), pulled.end(), 0.0);
        double dangling = 0.0;
        for (int32_t u = 0; u < v; u++)
            if (out_degree[u] <= 0.0f) dangling += rank[u];
        for (int64_t i = 0; i < e; i++)
            pulled[dst[i]] += rank[src[i]] * share[i];
        double base = (1.0 - damping) / v;
        for (int32_t u = 0; u < v; u++)
            rank[u] = base + damping * (pulled[u] + dangling / v);
    }
    for (int32_t u = 0; u < v; u++) rank_out[u] = static_cast<float>(rank[u]);
}

// ───────────────────────── SSSP ─────────────────────────

// Dijkstra + tight-edge min-index parents: parent[t] = min src among
// edges with |dist[src]+w-dist[t]| within the device epsilon
// (traversal.sssp_with_parents).
void muninn_graph_sssp(const int32_t* src, const int32_t* dst, const float* w,
                       int64_t e, int32_t v, int32_t start, float* dist_out,
                       int32_t* parent) {
    Csr c = build_csr(src, dst, w, e, v);
    std::vector<double> dist;
    dijkstra(c, v, start, dist);
    std::fill(parent, parent + v, -1);
    for (int64_t i = 0; i < e; i++) {
        int32_t t = dst[i];
        if (t == start || !std::isfinite(dist[t])) continue;
        if (tight(dist[src[i]], w ? w[i] : 1.0, dist[t])) {
            if (parent[t] < 0 || src[i] < parent[t]) parent[t] = src[i];
        }
    }
    for (int32_t u = 0; u < v; u++)
        dist_out[u] = static_cast<float>(dist[u]);
}

// ───────────────────────── Brandes betweenness ─────────────────────────

// Per-source SSSP + forward sigma sweep + backward delta sweep over
// tight edges in distance order — the sequential form of the device
// Jacobi fixpoints (centrality._brandes_batch), same epsilon, same
// source-exclusion. node_cb[V] and (optional) edge_cb[E] accumulate
// RAW sums over the given sources; the Python wrapper applies
// sampling scale / undirected halving / normalization.
}  // extern "C" — the lane-templated helpers below need C++ linkage

namespace {

// Lane-batched exact unweighted Brandes: L sources advance one
// level-synchronous BFS together, so each edge is visited once per
// LEVEL per batch instead of once per SOURCE — the random-access cost
// of the per-source sweeps amortizes across the batch. The per-lane
// inner loops are BRANCH-FREE over all L lanes (compare -> mask ->
// blend), which g++ -march=native vectorizes to AVX-512 masked ops:
// one 512-bit vector holds 16 int32 distances or 16 float sigmas, so
// the whole lane dimension is 1-2 instructions per edge. sigma/delta
// are float like the device engine (centrality._brandes_batch uses
// f32 throughout); the fold into node_cb stays double.
//
// PRECISION BOUND (round-4 ADVICE): f32 holds path counts exactly only
// up to 2^24 (~1.7e7); beyond that sigma rounds, and at ~3.4e38 it
// overflows to inf (reciprocal 0 -> that source's delta contributions
// silently drop). Path counts grow combinatorially on dense/lattice
// graphs, so this host kernel's guarantee is WEAKER than the previous
// all-double sequential kernel — but identical to the device engine's,
// so host/device routing cannot change results. Graphs whose centrality
// demands exact astronomically-large path counts should use the
// weighted path (dijkstra-based, sigma in double below).
struct BrandesLevels {
    std::vector<int32_t> stamp;  // [V] last level the node was listed at
    std::vector<std::vector<int32_t>> levels;  // node list per level
    explicit BrandesLevels(int32_t v) : stamp(static_cast<size_t>(v), -1) {}
};

// Edge arrays pre-filtered to w > 0 once per call: the hot loops then
// carry no weight loads and no per-edge filter branch. eid maps the
// filtered position back to the caller's edge order (kept only for
// the edge-betweenness variant).
struct BrCsr {
    std::vector<int32_t> offsets;  // [V+1]
    std::vector<int32_t> dst;      // [E']
    std::vector<int64_t> eid;      // [E'] (empty unless want_edge)
};

BrCsr filter_positive(const Csr& c, int32_t v, bool want_edge) {
    BrCsr r;
    r.offsets.assign(static_cast<size_t>(v) + 1, 0);
    r.dst.reserve(c.dst.size());
    if (want_edge) r.eid.reserve(c.dst.size());
    for (int32_t u = 0; u < v; u++) {
        for (int32_t p = c.offsets[u]; p < c.offsets[u + 1]; p++) {
            if (c.w[p] <= 0.0f) continue;
            r.dst.push_back(c.dst[p]);
            if (want_edge) r.eid.push_back(c.eid[p]);
        }
        r.offsets[u + 1] = static_cast<int32_t>(r.dst.size());
    }
    return r;
}

// TD = per-lane distance type: int16_t when V <= 32767 (every finite
// distance < V fits), halving the dist-lane memory traffic; int32_t
// otherwise.
//
// Each node's whole per-batch state lives in ONE contiguous Row
// (dist | sigma | delta): an edge visit is a single random base
// address touching consecutive cache lines instead of three scattered
// streams — the loops here are L3-latency-bound, and one stream per
// visit means one TLB walk and a single hardware-prefetchable run.
template <int L, typename TD>
struct alignas(64) BrandesRow {
    TD dist[L];        // -1 = unreached
    float sigma[L];
    float delta[L];
};

template <int L, typename TD, bool WANT_EDGE>
void brandes_unw_batch(const BrCsr& c, int32_t v, const int32_t* sources,
                       int32_t nb, double* node_cb, double* edge_cb,
                       std::vector<BrandesRow<L, TD>>& rows_v,
                       BrandesLevels& sc) {
    using Row = BrandesRow<L, TD>;
    auto& levels = sc.levels;
    if (levels.empty()) levels.emplace_back();
    levels[0].clear();
    Row* __restrict rows = rows_v.data();
    for (int32_t b = 0; b < nb; b++) {
        int32_t s = sources[b];
        rows[s].dist[b] = 0;
        rows[s].sigma[b] = 1.0f;
        if (sc.stamp[s] != 0) {
            sc.stamp[s] = 0;
            levels[0].push_back(s);
        }
    }
    auto t0 = std::chrono::steady_clock::now();
    // forward: level-synchronous sigma propagation. Each edge is
    // visited once per LEVEL the source node is active at; per visit
    // the active lanes' discoveries and sigma adds happen as one
    // masked vector op each.
    int32_t max_d = 0;
    for (int32_t d = 0; ; d++) {
        if (d >= static_cast<int32_t>(levels.size()) || levels[d].empty())
            break;
        max_d = d;
        if (d + 1 >= static_cast<int32_t>(levels.size()))
            levels.emplace_back();
        levels[d + 1].clear();
        for (int32_t u : levels[d]) {
            const Row& ru = rows[u];
            // hoist u's active mask + masked sigma to locals once per
            // node: breaks aliasing with the written dst rows and keeps
            // the per-edge loop pure vector blends
            int32_t act[L];
            float sm[L];
            int32_t uact = 0;
            for (int32_t b = 0; b < L; b++) {
                act[b] = -static_cast<int32_t>(ru.dist[b] == d);
                sm[b] = act[b] ? ru.sigma[b] : 0.0f;
                uact |= act[b];
            }
            if (!uact) continue;
            const int32_t pe = c.offsets[u + 1];
            for (int32_t p = c.offsets[u]; p < pe; p++) {
                // the loop is L3-latency-bound on the scattered row
                // gathers below; prefetch a few edges ahead so misses
                // overlap
                if (p + 4 < pe) {
                    const char* rn = reinterpret_cast<const char*>(
                        &rows[c.dst[p + 4]]);
                    __builtin_prefetch(rn, 1);
                    __builtin_prefetch(rn + 64, 1);
                    __builtin_prefetch(rn + 128, 1);
                }
                Row& __restrict rt = rows[c.dst[p]];
                TD* __restrict dt = rt.dist;
                float* __restrict st = rt.sigma;
                int32_t newly = 0;
                for (int32_t b = 0; b < L; b++) {
                    const int32_t und =
                        act[b] & -static_cast<int32_t>(dt[b] < 0);
                    newly |= und;
                    dt[b] = und ? static_cast<TD>(d + 1) : dt[b];
                    st[b] += (act[b] & -static_cast<int32_t>(dt[b] == d + 1))
                                 ? sm[b] : 0.0f;
                }
                if (newly) {
                    const int32_t t = c.dst[p];
                    if (sc.stamp[t] != d + 1) {
                        sc.stamp[t] = d + 1;
                        levels[d + 1].push_back(t);
                    }
                }
            }
        }
    }
    auto t1 = std::chrono::steady_clock::now();
    // backward: per-level delta accumulation, deepest first. A node
    // appears in levels[d] for every d some lane first reached it at,
    // and only its dist==d lanes are touched at level d — lane b's
    // delta[t] is final once level dist[t][b] has been processed.
    for (int32_t d = max_d; d >= 0; d--) {
        // Reciprocal sigma IN PLACE, per lane at its own level: sigma
        // is frozen after the forward pass, and a lane with dist==d+1
        // was discovered, so its sigma is >= 1 — inversion is always
        // legal. Each (node, lane) inverts exactly once (level lists
        // are stamp-deduped, lanes at other distances untouched),
        // divisor rows are ready before the sweep below reads them,
        // and a node's OWN sm lanes (dist==d) are not inverted until
        // iteration d-1 — no extra array, no per-edge divisions.
        if (d + 1 <= max_d) {
            for (int32_t t : levels[d + 1]) {
                Row& __restrict rt = rows[t];
                for (int32_t b = 0; b < L; b++) {
                    const bool on = rt.dist[b] == d + 1;
                    const float den = on ? rt.sigma[b] : 1.0f;
                    rt.sigma[b] = on ? 1.0f / den : rt.sigma[b];
                }
            }
        }
        for (int32_t u : levels[d]) {
            Row& __restrict ru = rows[u];
            int32_t act[L];
            float sm[L];
            int32_t uact = 0;
            for (int32_t b = 0; b < L; b++) {
                act[b] = -static_cast<int32_t>(ru.dist[b] == d);
                sm[b] = act[b] ? ru.sigma[b] : 0.0f;
                uact |= act[b];
            }
            if (!uact) continue;
            float acc[L] = {};
            const int32_t pe = c.offsets[u + 1];
            for (int32_t p = c.offsets[u]; p < pe; p++) {
                if (p + 4 < pe) {
                    const char* rn = reinterpret_cast<const char*>(
                        &rows[c.dst[p + 4]]);
                    __builtin_prefetch(rn, 0);
                    __builtin_prefetch(rn + 64, 0);
                    __builtin_prefetch(rn + 128, 0);
                    __builtin_prefetch(rn + sizeof(Row) - 64, 0);
                }
                const Row& rt = rows[c.dst[p]];
                const TD* dt = rt.dist;
                const float* it = rt.sigma;   // reciprocal at dist d+1
                const float* et = rt.delta;
                float edge_sum = 0.0f;
                for (int32_t b = 0; b < L; b++) {
                    const int32_t on =
                        act[b] & -static_cast<int32_t>(dt[b] == d + 1);
                    const float contrib =
                        on ? sm[b] * it[b] * (1.0f + et[b]) : 0.0f;
                    acc[b] += contrib;
                    if (WANT_EDGE) edge_sum += contrib;
                }
                if (WANT_EDGE) edge_cb[c.eid[p]] += edge_sum;
            }
            for (int32_t b = 0; b < L; b++) ru.delta[b] += acc[b];
        }
    }
    auto t2 = std::chrono::steady_clock::now();
    // fold deltas into node_cb AFTER the whole sweep (every lane final)
    // and reset only the touched rows — full-array memsets per batch
    // would dominate at small graphs. stamp < 0 marks already-reset.
    for (int32_t d = 0; d <= max_d; d++) {
        for (int32_t u : levels[d]) {
            if (sc.stamp[u] < 0) continue;
            sc.stamp[u] = -1;
            Row& __restrict ru = rows[u];
            double acc = 0.0;
            for (int32_t b = 0; b < L; b++) {
                if (ru.dist[b] > 0) acc += static_cast<double>(ru.delta[b]);
                ru.dist[b] = -1;
                ru.sigma[b] = 0.0f;
                ru.delta[b] = 0.0f;
            }
            node_cb[u] += acc;
        }
    }
    if (std::getenv("MUNINN_BRANDES_PROF")) {
        auto t3 = std::chrono::steady_clock::now();
        auto us = [](auto a, auto b) {
            return std::chrono::duration_cast<std::chrono::microseconds>(
                       b - a).count();
        };
        static long long fw = 0, bw = 0, fo = 0;
        fw += us(t0, t1); bw += us(t1, t2); fo += us(t2, t3);
        std::fprintf(stderr, "[brandes] fw=%lld us bw=%lld us fold=%lld us\n",
                     fw, bw, fo);
    }
}

template <int L, typename TD>
void brandes_unw_all(const Csr& c0, int32_t v, const int32_t* sources,
                     int32_t n_sources, int32_t want_edge, double* node_cb,
                     double* edge_cb) {
    BrCsr c = filter_positive(c0, v, want_edge != 0);
    std::vector<BrandesRow<L, TD>> rows(static_cast<size_t>(v));
    for (auto& r : rows) {
        for (int32_t b = 0; b < L; b++) {
            r.dist[b] = -1;
            r.sigma[b] = 0.0f;
            r.delta[b] = 0.0f;
        }
    }
    BrandesLevels sc(v);
    for (int32_t s0 = 0; s0 < n_sources; s0 += L) {
        int32_t nb = std::min<int32_t>(L, n_sources - s0);
        if (want_edge)
            brandes_unw_batch<L, TD, true>(c, v, sources + s0, nb, node_cb,
                                           edge_cb, rows, sc);
        else
            brandes_unw_batch<L, TD, false>(c, v, sources + s0, nb, node_cb,
                                            edge_cb, rows, sc);
    }
}

}  // namespace

extern "C" {

void muninn_graph_brandes(const int32_t* src, const int32_t* dst,
                          const float* w, int64_t e, int32_t v,
                          const int32_t* sources, int32_t n_sources,
                          int32_t weighted, int32_t want_edge,
                          double* node_cb, double* edge_cb) {
    Csr c = build_csr(src, dst, w, e, v);
    std::fill(node_cb, node_cb + v, 0.0);
    if (want_edge) std::fill(edge_cb, edge_cb + e, 0.0);
    if (!weighted) {
        // lane width: 32 = two AVX-512 vectors of int32/float per row,
        // measured fastest at every point of the 100-10k benchmark
        // envelope (0.46 ms @ 100, 32 ms @ 1k, 1.19 s @ 5k — beats 16
        // by ~1.4x and 64 by ~1.2-1.4x: wider amortizes level sweeps
        // until the [V, L] rows blow the cache). Override for
        // experiments via MUNINN_BRANDES_LANES in {8,16,32,64}.
        int lanes = 32;
        if (const char* env = std::getenv("MUNINN_BRANDES_LANES"))
            lanes = std::atoi(env);
        // int16 lane distances whenever every finite distance (< V)
        // fits — true for the whole host-routed envelope
        const bool d16 = v <= 32767;
        switch (lanes) {
            case 8:
                d16 ? brandes_unw_all<8, int16_t>(c, v, sources, n_sources,
                                                  want_edge, node_cb, edge_cb)
                    : brandes_unw_all<8, int32_t>(c, v, sources, n_sources,
                                                  want_edge, node_cb, edge_cb);
                break;
            case 16:
                d16 ? brandes_unw_all<16, int16_t>(c, v, sources, n_sources,
                                                   want_edge, node_cb, edge_cb)
                    : brandes_unw_all<16, int32_t>(c, v, sources, n_sources,
                                                   want_edge, node_cb, edge_cb);
                break;
            case 64:
                d16 ? brandes_unw_all<64, int16_t>(c, v, sources, n_sources,
                                                   want_edge, node_cb, edge_cb)
                    : brandes_unw_all<64, int32_t>(c, v, sources, n_sources,
                                                   want_edge, node_cb, edge_cb);
                break;
            default:
                d16 ? brandes_unw_all<32, int16_t>(c, v, sources, n_sources,
                                                   want_edge, node_cb, edge_cb)
                    : brandes_unw_all<32, int32_t>(c, v, sources, n_sources,
                                                   want_edge, node_cb, edge_cb);
        }
        return;
    }
    std::vector<double> dist;
    std::vector<int32_t> idist(static_cast<size_t>(v));
    std::vector<double> sigma(static_cast<size_t>(v));
    std::vector<double> delta(static_cast<size_t>(v));
    std::vector<int32_t> order;
    order.reserve(static_cast<size_t>(v));
    for (int32_t si = 0; si < n_sources; si++) {
        int32_t s = sources[si];
        order.clear();
        if (weighted) {
            dijkstra(c, v, s, dist);
            // nodes reachable, ordered by distance ascending
            for (int32_t u = 0; u < v; u++)
                if (std::isfinite(dist[u])) order.push_back(u);
            std::sort(order.begin(), order.end(),
                      [&](int32_t a, int32_t b) { return dist[a] < dist[b]; });
        } else {
            // BFS with int32 distances (-1 = unreached); the queue IS
            // the distance-ascending order — no sort, no double math
            std::fill(idist.begin(), idist.end(), -1);
            idist[s] = 0;
            order.push_back(s);
            size_t head = 0;
            while (head < order.size()) {
                int32_t u = order[head++];
                for (int32_t p = c.offsets[u]; p < c.offsets[u + 1]; p++) {
                    int32_t t = c.dst[p];
                    if (idist[t] < 0) {
                        idist[t] = idist[u] + 1;
                        order.push_back(t);
                    }
                }
            }
        }
        // sigma: forward sweep
        std::fill(sigma.begin(), sigma.end(), 0.0);
        sigma[s] = 1.0;
        if (weighted) {
            for (int32_t u : order) {
                if (sigma[u] == 0.0) continue;
                for (int32_t p = c.offsets[u]; p < c.offsets[u + 1]; p++) {
                    int32_t t = c.dst[p];
                    if (c.w[p] > 0.0f && std::isfinite(dist[t]) &&
                        tight(dist[u], c.w[p], dist[t]))
                        sigma[t] += sigma[u];
                }
            }
        } else {
            for (int32_t u : order) {
                if (sigma[u] == 0.0) continue;
                int32_t dn = idist[u] + 1;
                for (int32_t p = c.offsets[u]; p < c.offsets[u + 1]; p++) {
                    int32_t t = c.dst[p];
                    if (c.w[p] > 0.0f && idist[t] == dn) sigma[t] += sigma[u];
                }
            }
        }
        // delta: backward accumulation over out-edges, nodes in reverse
        // distance order — when u is visited every deeper delta[t] is
        // final (tight edges strictly increase distance).
        std::fill(delta.begin(), delta.end(), 0.0);
        for (auto it = order.rbegin(); it != order.rend(); ++it) {
            int32_t u = *it;
            if (sigma[u] == 0.0) continue;
            int32_t dn = weighted ? 0 : idist[u] + 1;
            for (int32_t p = c.offsets[u]; p < c.offsets[u + 1]; p++) {
                int32_t t = c.dst[p];
                bool on_sp = weighted
                    ? (c.w[p] > 0.0f && std::isfinite(dist[t]) &&
                       tight(dist[u], c.w[p], dist[t]))
                    : (c.w[p] > 0.0f && idist[t] == dn);
                if (on_sp && sigma[t] > 0.0) {
                    double contrib = sigma[u] / sigma[t] * (1.0 + delta[t]);
                    delta[u] += contrib;
                    if (want_edge) edge_cb[c.eid[p]] += contrib;
                }
            }
        }
        for (int32_t u = 0; u < v; u++)
            if (u != s) node_cb[u] += delta[u];
    }
}

// ───────────────────────── closeness ─────────────────────────

// Per-source distance sums with the Wasserman-Faust reachable/(N-1)
// correction (graph_centrality.c:1404-1434 role; matches
// centrality.closeness).
void muninn_graph_closeness(const int32_t* src, const int32_t* dst,
                            const float* w, int64_t e, int32_t v,
                            int32_t weighted, int32_t normalized,
                            float* out) {
    Csr c = build_csr(src, dst, w, e, v);
    if (!weighted) {
        // 64-way bit-parallel multi-source BFS ("MS-BFS"): each uint64
        // lane is one source, frontier masks propagate along edges
        // with word-ORs, so the per-source BFS's random-access cost
        // amortizes over 64 sources. Distance sums are exact integers
        // — identical results to the scalar per-source BFS, measured
        // ~15x faster at the reference's 10k-node envelope point.
        std::vector<uint64_t> seen(static_cast<size_t>(v));
        std::vector<uint64_t> frontier(static_cast<size_t>(v));
        std::vector<uint64_t> next(static_cast<size_t>(v), 0);
        std::vector<int32_t> active, touched;
        active.reserve(static_cast<size_t>(v));
        touched.reserve(static_cast<size_t>(v));
        double sd[64];
        int64_t rc[64];
        for (int32_t base = 0; base < v; base += 64) {
            int32_t nb = std::min<int32_t>(64, v - base);
            std::fill(seen.begin(), seen.end(), 0);
            std::fill(sd, sd + 64, 0.0);
            std::fill(rc, rc + 64, 0);
            active.clear();
            for (int32_t b = 0; b < nb; b++) {
                seen[base + b] = 1ull << b;
                frontier[base + b] = 1ull << b;
                active.push_back(base + b);
            }
            int32_t d = 0;
            while (!active.empty()) {
                d++;
                touched.clear();
                for (int32_t u : active) {
                    uint64_t f = frontier[u];
                    for (int32_t p = c.offsets[u]; p < c.offsets[u + 1]; p++) {
                        int32_t t = c.dst[p];
                        if (next[t] == 0) touched.push_back(t);
                        next[t] |= f;
                    }
                }
                active.clear();
                for (int32_t t : touched) {
                    uint64_t nw = next[t] & ~seen[t];
                    next[t] = 0;
                    if (!nw) continue;
                    seen[t] |= nw;
                    frontier[t] = nw;
                    active.push_back(t);
                    uint64_t m = nw;
                    while (m) {
                        int b = __builtin_ctzll(m);
                        m &= m - 1;
                        sd[b] += d;
                        rc[b]++;
                    }
                }
            }
            for (int32_t b = 0; b < nb; b++) {
                double cval = sd[b] > 0.0
                    ? static_cast<double>(rc[b]) / sd[b] : 0.0;
                if (normalized && v > 1)
                    cval *= static_cast<double>(rc[b]) / (v - 1);
                out[base + b] = static_cast<float>(cval);
            }
        }
        return;
    }
    std::vector<double> dist;
    for (int32_t s = 0; s < v; s++) {
        double sd = 0.0;
        int64_t r = 0;
        dijkstra(c, v, s, dist);
        for (int32_t u = 0; u < v; u++) {
            if (u == s || !std::isfinite(dist[u])) continue;
            sd += dist[u];
            r++;
        }
        double cval = sd > 0.0 ? static_cast<double>(r) / sd : 0.0;
        if (normalized && v > 1) cval *= static_cast<double>(r) / (v - 1);
        out[s] = static_cast<float>(cval);
    }
}

// ───────────────────────── Leiden ─────────────────────────

namespace {

// Queue-based local moving (Traag 2019 Alg. 1 lines 2-13 /
// graph_community.c:150-231's gain formula). `restrict_to`: moves only
// between communities whose nodes share a restrict label (refinement);
// nullptr = unrestricted. Returns number of moves.
int64_t local_move(const Csr& c, int32_t v, double m, double gamma,
                   std::vector<int32_t>& comm, const int32_t* restrict_to,
                   const std::vector<double>& k, std::mt19937_64& rng) {
    std::vector<double> sigma(static_cast<size_t>(v), 0.0);
    for (int32_t u = 0; u < v; u++) sigma[comm[u]] += k[u];
    std::vector<int32_t> queue(static_cast<size_t>(v));
    for (int32_t i = 0; i < v; i++) queue[i] = i;
    std::shuffle(queue.begin(), queue.end(), rng);
    std::vector<uint8_t> in_queue(static_cast<size_t>(v), 1);
    std::vector<double> wvc(static_cast<size_t>(v), 0.0);  // scratch W(v,C)
    std::vector<int32_t> touched;
    size_t head = 0;
    int64_t moves = 0;
    while (head < queue.size()) {
        int32_t u = queue[head++];
        in_queue[u] = 0;
        int32_t cu = comm[u];
        touched.clear();
        double w_own = 0.0;
        for (int32_t p = c.offsets[u]; p < c.offsets[u + 1]; p++) {
            int32_t t = c.dst[p];
            if (t == u) continue;  // self-loops don't count toward W(v,C)
            if (restrict_to && restrict_to[t] != restrict_to[u]) continue;
            int32_t ct = comm[t];
            if (ct == cu) {
                w_own += c.w[p];
            } else {
                if (wvc[ct] == 0.0) touched.push_back(ct);
                wvc[ct] += c.w[p];
            }
        }
        double best_gain = 1e-12;  // moves need strictly positive gain
        int32_t best_c = -1;
        for (int32_t ct : touched) {
            double gain = (wvc[ct] - w_own) / m +
                          gamma * k[u] * (sigma[cu] - k[u] - sigma[ct]) /
                              (2.0 * m * m);
            if (gain > best_gain ||
                (gain == best_gain && best_c >= 0 && ct < best_c)) {
                best_gain = gain;
                best_c = ct;
            }
        }
        for (int32_t ct : touched) wvc[ct] = 0.0;
        if (best_c >= 0) {
            sigma[cu] -= k[u];
            sigma[best_c] += k[u];
            comm[u] = best_c;
            moves++;
            // re-enqueue neighbors not in the new community
            for (int32_t p = c.offsets[u]; p < c.offsets[u + 1]; p++) {
                int32_t t = c.dst[p];
                if (t != u && comm[t] != best_c && !in_queue[t]) {
                    in_queue[t] = 1;
                    queue.push_back(t);
                }
            }
        }
    }
    return moves;
}

int32_t renumber(std::vector<int32_t>& labels) {
    std::vector<int32_t> map(labels.size(), -1);
    int32_t next = 0;
    // stable by smallest label value (matches np.unique-based renumber)
    std::vector<int32_t> seen(labels.begin(), labels.end());
    std::sort(seen.begin(), seen.end());
    seen.erase(std::unique(seen.begin(), seen.end()), seen.end());
    for (int32_t s : seen) map[s] = next++;
    for (auto& l : labels) l = map[l];
    return next;
}

double modularity_q(const int32_t* src, const int32_t* dst, const float* w,
                    int64_t e, const std::vector<int32_t>& labels,
                    double gamma) {
    // Q over the undirected both-direction COO (community.modularity)
    double two_m = 0.0, intra = 0.0;
    for (int64_t i = 0; i < e; i++) {
        two_m += w[i];
        if (labels[src[i]] == labels[dst[i]]) intra += w[i];
    }
    if (two_m <= 0.0) return 0.0;
    int32_t nc = 0;
    for (int32_t l : labels) nc = std::max(nc, l + 1);
    std::vector<double> ksum(static_cast<size_t>(nc), 0.0);
    for (int64_t i = 0; i < e; i++) ksum[labels[src[i]]] += w[i];
    double pen = 0.0;
    for (double kc : ksum) pen += (kc / two_m) * (kc / two_m);
    return intra / two_m - gamma * pen;
}

}  // namespace

// Full Leiden over the undirected 'both' COO (each edge in both
// orientations). Writes labels int32[V] renumbered 0..k-1; returns
// final modularity. Mirrors the device loop's structure
// (community.leiden): phase-1 local moving from the current meta
// partition, singleton refinement restricted to phase-1 communities,
// fallback to phase 1 when refinement only fragments, aggregation
// initialized with the phase-1 partition, stop when Q stops improving.
double muninn_graph_leiden(const int32_t* src, const int32_t* dst,
                           const float* w, int64_t e, int32_t v,
                           float resolution, int32_t max_rounds,
                           uint64_t seed, int32_t* labels_out) {
    std::mt19937_64 rng(seed);
    double gamma = resolution;
    std::vector<int32_t> labels(static_cast<size_t>(v));
    for (int32_t i = 0; i < v; i++) labels[i] = i;
    std::vector<int32_t> cur_src(src, src + e), cur_dst(dst, dst + e);
    std::vector<float> cur_w(w, w + e);
    int32_t cur_n = v;
    std::vector<int32_t> node_map(static_cast<size_t>(v));
    for (int32_t i = 0; i < v; i++) node_map[i] = i;
    std::vector<int32_t> init_comm(static_cast<size_t>(v));
    for (int32_t i = 0; i < v; i++) init_comm[i] = i;

    double prev_q = -std::numeric_limits<double>::infinity();
    for (int32_t round = 0; round < max_rounds; round++) {
        int64_t ce = static_cast<int64_t>(cur_src.size());
        Csr c = build_csr(cur_src.data(), cur_dst.data(), cur_w.data(), ce,
                          cur_n);
        double m = 0.0;
        for (float ww : cur_w) m += ww;
        m /= 2.0;
        if (m <= 0.0) break;
        std::vector<double> k(static_cast<size_t>(cur_n), 0.0);
        for (int64_t i = 0; i < ce; i++) k[cur_src[i]] += cur_w[i];

        // phase 1
        std::vector<int32_t> comm = init_comm;
        local_move(c, cur_n, m, gamma, comm, nullptr, k, rng);
        std::vector<int32_t> comm_r = comm;
        int32_t nc1 = renumber(comm_r);

        // phase 2: singleton refinement restricted to phase-1 communities
        std::vector<int32_t> refined(static_cast<size_t>(cur_n));
        for (int32_t i = 0; i < cur_n; i++) refined[i] = i;
        local_move(c, cur_n, m, gamma, refined, comm_r.data(), k, rng);
        std::vector<int32_t> refined_r = refined;
        int32_t ncr = renumber(refined_r);

        const std::vector<int32_t>& use = (ncr > nc1) ? comm_r : refined_r;
        int32_t nc = (ncr > nc1) ? nc1 : ncr;

        // project to original nodes, measure Q on the ORIGINAL graph
        std::vector<int32_t> full(static_cast<size_t>(v));
        for (int32_t i = 0; i < v; i++) full[i] = use[node_map[i]];
        double q = modularity_q(src, dst, w, e, full, gamma);
        if (q <= prev_q + 1e-9) break;
        prev_q = q;
        labels = full;

        if (nc == cur_n) break;
        // next round's init: phase-1 community of each refined super-node
        std::vector<int32_t> rep(static_cast<size_t>(nc), 0);
        for (int32_t i = 0; i < cur_n; i++) rep[use[i]] = i;
        std::vector<int32_t> next_init(static_cast<size_t>(nc));
        for (int32_t ci = 0; ci < nc; ci++) next_init[ci] = comm_r[rep[ci]];
        // aggregate: contract `use`, merge parallel edges
        std::vector<int32_t> ns, nd;
        std::vector<float> nw;
        if (static_cast<int64_t>(nc) * nc <= std::max<int64_t>(4096, 2 * ce)) {
            // dense nc x nc accumulation: O(e + nc^2), replacing the
            // O(e log e) comparator sort that dominated tiny-N rounds
            // (emitted ascending (src, dst) like the sort path)
            std::vector<double> wmat(static_cast<size_t>(nc) * nc, 0.0);
            for (int64_t i = 0; i < ce; i++)
                wmat[static_cast<size_t>(use[cur_src[i]]) * nc +
                     use[cur_dst[i]]] += cur_w[i];
            for (int32_t a = 0; a < nc; a++)
                for (int32_t b = 0; b < nc; b++) {
                    double ww = wmat[static_cast<size_t>(a) * nc + b];
                    if (ww != 0.0) {
                        ns.push_back(a);
                        nd.push_back(b);
                        nw.push_back(static_cast<float>(ww));
                    }
                }
        } else {
            std::vector<int64_t> keys(static_cast<size_t>(ce));
            std::vector<int64_t> order(static_cast<size_t>(ce));
            for (int64_t i = 0; i < ce; i++) {
                keys[i] = static_cast<int64_t>(use[cur_src[i]]) * nc +
                          use[cur_dst[i]];
                order[i] = i;
            }
            std::sort(order.begin(), order.end(),
                      [&](int64_t a, int64_t b) { return keys[a] < keys[b]; });
            int64_t i = 0;
            while (i < ce) {
                int64_t key = keys[order[i]];
                double acc = 0.0;
                while (i < ce && keys[order[i]] == key)
                    acc += cur_w[order[i++]];
                ns.push_back(static_cast<int32_t>(key / nc));
                nd.push_back(static_cast<int32_t>(key % nc));
                nw.push_back(static_cast<float>(acc));
            }
        }
        cur_src.swap(ns);
        cur_dst.swap(nd);
        cur_w.swap(nw);
        for (int32_t i2 = 0; i2 < v; i2++) node_map[i2] = use[node_map[i2]];
        init_comm = next_init;
        cur_n = nc;
    }
    std::vector<int32_t> final_labels = labels;
    renumber(final_labels);
    std::memcpy(labels_out, final_labels.data(),
                static_cast<size_t>(v) * sizeof(int32_t));
    if (!std::isfinite(prev_q))
        prev_q = modularity_q(src, dst, w, e, labels, gamma);
    return prev_q;
}

}  // extern "C"

// ───────────────────────── node2vec ─────────────────────────

namespace {

inline uint64_t xs64(uint64_t& s) {
    s ^= s << 13; s ^= s >> 7; s ^= s << 17;
    return s;
}

inline double urand(uint64_t& s) {
    return static_cast<double>(xs64(s) >> 11) * (1.0 / 9007199254740992.0);
}

}  // namespace

extern "C" {

// Host fast path for small graphs (reference src/node2vec.c role;
// same capability as the device trainer in models/node2vec.py):
// p/q-biased second-order random walks (per-row cumulative-weight
// sampling, binary-search neighbor membership) + SGNS with a sigmoid
// LUT and a deg^0.75 cdf-sampled negative distribution, linear LR
// decay to a 1e-4 floor. Sequential — the small-N regime where every
// device dispatch costs more than the whole training run.
// Writes raw (unnormalized) embeddings out[v*dim]; the Python wrapper
// L2-normalizes like the reference (:539-585).
void muninn_node2vec_train(
    const int32_t* src, const int32_t* dst, const float* w, int64_t e,
    int32_t v, int32_t dim, float p, float q, int32_t num_walks,
    int32_t walk_length, int32_t window, int32_t neg, float lr0,
    int32_t epochs, uint64_t seed, float* out) {
    Csr c = build_csr(src, dst, w, e, v);
    // sort each adjacency row by dst (binary membership + stable cdf)
    for (int32_t u = 0; u < v; u++) {
        int32_t lo = c.offsets[u], hi = c.offsets[u + 1];
        std::vector<std::pair<int32_t, float>> row;
        row.reserve(hi - lo);
        for (int32_t pp = lo; pp < hi; pp++)
            row.push_back({c.dst[pp], c.w[pp]});
        std::sort(row.begin(), row.end());
        for (int32_t pp = lo; pp < hi; pp++) {
            c.dst[pp] = row[pp - lo].first;
            c.w[pp] = row[pp - lo].second;
        }
    }
    // per-row weight prefix sums (first-order sampling)
    std::vector<double> cumw(c.dst.size());
    for (int32_t u = 0; u < v; u++) {
        double acc = 0.0;
        for (int32_t pp = c.offsets[u]; pp < c.offsets[u + 1]; pp++) {
            acc += std::max(c.w[pp], 0.0f);
            cumw[pp] = acc;
        }
    }
    auto is_neighbor = [&](int32_t u, int32_t y) {
        const int32_t* b = c.dst.data() + c.offsets[u];
        const int32_t* en = c.dst.data() + c.offsets[u + 1];
        return std::binary_search(b, en, y);
    };
    // deg^0.75 unigram table, O(1) sampling (reference :274-303 and
    // the device build_negative_table law)
    constexpr int32_t kNegTab = 1 << 17;
    std::vector<int32_t> negtab(kNegTab);
    {
        std::vector<double> degw(static_cast<size_t>(v), 0.0);
        for (int32_t u = 0; u < v; u++)
            for (int32_t pp = c.offsets[u]; pp < c.offsets[u + 1]; pp++)
                degw[u] += std::max(c.w[pp], 0.0f);
        double total = 0.0;
        for (int32_t u = 0; u < v; u++)
            total += std::pow(std::max(degw[u], 1e-12), 0.75);
        int32_t u = 0;
        double acc = std::pow(std::max(degw[0], 1e-12), 0.75);
        for (int32_t i = 0; i < kNegTab; i++) {
            double want = (i + 0.5) / kNegTab * total;
            while (acc < want && u + 1 < v) {
                u++;
                acc += std::pow(std::max(degw[u], 1e-12), 0.75);
            }
            negtab[i] = u;
        }
    }
    // sigmoid LUT (reference :244-271 structure: 1000 bins over ±6)
    constexpr int kSig = 1024;
    constexpr float kSigMax = 6.0f;
    float sig_lut[kSig + 1];
    for (int i = 0; i <= kSig; i++) {
        float x = (2.0f * i / kSig - 1.0f) * kSigMax;
        sig_lut[i] = 1.0f / (1.0f + std::exp(-x));
    }
    auto sigmoid = [&](float x) {
        if (x >= kSigMax) return 1.0f;
        if (x <= -kSigMax) return 0.0f;
        return sig_lut[static_cast<int>((x / kSigMax + 1.0f) * 0.5f * kSig)];
    };

    if (walk_length < 1) walk_length = 1;  // walk[0] = start always exists
    uint64_t rng = seed ? seed : 0x9e3779b97f4a7c15ULL;
    std::vector<float> syn0(static_cast<size_t>(v) * dim);
    std::vector<float> syn1(static_cast<size_t>(v) * dim, 0.0f);
    for (auto& x : syn0) x = (urand(rng) - 0.5) / dim;
    std::vector<int32_t> walk(static_cast<size_t>(walk_length));
    std::vector<double> biased(64);
    std::vector<float> accum(static_cast<size_t>(dim));

    const float lr_floor = lr0 * 1e-4f;
    const int64_t total = static_cast<int64_t>(epochs) * num_walks;
    int64_t step_i = 0;
    for (int32_t ep = 0; ep < epochs; ep++) {
        for (int32_t wk = 0; wk < num_walks; wk++) {
            float lr = std::max(
                lr0 * (1.0f - static_cast<float>(step_i) / total), lr_floor);
            step_i++;
            for (int32_t s0 = 0; s0 < v; s0++) {
                // --- one p/q walk from s0 ---
                int32_t len = 0;
                walk[len++] = s0;
                int32_t prev = -1, cur = s0;
                while (len < walk_length) {
                    int32_t lo = c.offsets[cur], hi = c.offsets[cur + 1];
                    if (lo == hi) break;
                    int32_t nxt;
                    if (prev < 0) {
                        // first-order: cumulative weight binary search
                        double r = urand(rng) * cumw[hi - 1];
                        nxt = c.dst[std::lower_bound(&cumw[lo], &cumw[hi], r)
                                    - cumw.data()];
                    } else {
                        if (static_cast<size_t>(hi - lo) > biased.size())
                            biased.resize(hi - lo);
                        double acc = 0.0;
                        for (int32_t pp = lo; pp < hi; pp++) {
                            int32_t y = c.dst[pp];
                            double b = (y == prev) ? 1.0 / p
                                       : (is_neighbor(prev, y) ? 1.0
                                                               : 1.0 / q);
                            acc += std::max(c.w[pp], 0.0f) * b;
                            biased[pp - lo] = acc;
                        }
                        double r = urand(rng) * acc;
                        int32_t j = static_cast<int32_t>(
                            std::lower_bound(biased.data(),
                                             biased.data() + (hi - lo), r)
                            - biased.data());
                        nxt = c.dst[lo + std::min(j, hi - lo - 1)];
                    }
                    prev = cur;
                    cur = nxt;
                    walk[len++] = cur;
                }
                // --- SGNS over window pairs ---
                for (int32_t i = 0; i < len; i++) {
                    int32_t ctr = walk[i];
                    float* s0v = &syn0[static_cast<size_t>(ctr) * dim];
                    int32_t jlo = std::max(i - window, 0);
                    int32_t jhi = std::min(i + window, len - 1);
                    for (int32_t j = jlo; j <= jhi; j++) {
                        if (j == i) continue;
                        std::fill(accum.begin(), accum.end(), 0.0f);
                        for (int32_t t = 0; t < neg + 1; t++) {
                            int32_t tgt;
                            float label;
                            if (t == 0) {
                                tgt = walk[j];
                                label = 1.0f;
                            } else {
                                tgt = negtab[xs64(rng) & (kNegTab - 1)];
                                if (tgt == walk[j]) continue;
                                label = 0.0f;
                            }
                            float* s1v =
                                &syn1[static_cast<size_t>(tgt) * dim];
                            // 8-lane partial sums: a plain scalar dot
                            // is a serial reduction the compiler may
                            // not vectorize (no -ffast-math); this
                            // form maps to one vmulps+vaddps per 8
                            float lanes[8] = {0, 0, 0, 0, 0, 0, 0, 0};
                            const int32_t dv = dim & ~7;
                            for (int32_t d2 = 0; d2 < dv; d2 += 8)
                                for (int32_t l = 0; l < 8; l++)
                                    lanes[l] += s0v[d2 + l] * s1v[d2 + l];
                            float f = 0.0f;
                            for (int32_t l = 0; l < 8; l++) f += lanes[l];
                            for (int32_t d2 = dv; d2 < dim; d2++)
                                f += s0v[d2] * s1v[d2];
                            float g = (label - sigmoid(f)) * lr;
                            for (int32_t d2 = 0; d2 < dim; d2++) {
                                accum[d2] += g * s1v[d2];
                                s1v[d2] += g * s0v[d2];
                            }
                        }
                        for (int32_t d2 = 0; d2 < dim; d2++)
                            s0v[d2] += accum[d2];
                    }
                }
            }
        }
    }
    std::memcpy(out, syn0.data(),
                static_cast<size_t>(v) * dim * sizeof(float));
}

}  // extern "C"
