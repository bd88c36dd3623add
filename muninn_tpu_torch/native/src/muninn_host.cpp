// muninn native host runtime: the host-side data plumbing that feeds
// the device, in the role the reference's C files play around SQLite:
//
//  - string-id interning (the graph_load.c DJB2 hash map, :56-123)
//  - CSR construction by counting sort (graph_csr.c:20-83) and
//    delta merge (graph_csr.c:175-325)
//  - Jaro-Winkler batch scoring for the ER cascade (string_sim.c:11-96)
//
// A copy of muninn_tpu/native/src/muninn_host.cpp with the same code.
// Exposed as a flat C ABI consumed through ctypes; strings cross the
// boundary as (byte buffer, offsets) pairs to avoid per-string
// marshaling.

#include <cstdint>
#include <cstring>
#include <deque>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>
#include <algorithm>

extern "C" {

// ───────────────────────── interning ─────────────────────────

struct InternTable {
    std::unordered_map<std::string, int32_t> map;
    std::vector<std::string> ids;
};

void* muninn_intern_new() { return new InternTable(); }

void muninn_intern_free(void* h) { delete static_cast<InternTable*>(h); }

int32_t muninn_intern_size(void* h) {
    return static_cast<int32_t>(static_cast<InternTable*>(h)->ids.size());
}

// Intern n strings packed in buf with offsets[n+1]; writes dense int32
// indices to out. Returns the table size after interning.
int32_t muninn_intern_add(void* h, const char* buf, const int64_t* offsets,
                          int64_t n, int32_t* out) {
    auto* t = static_cast<InternTable*>(h);
    t->map.reserve(t->map.size() + static_cast<size_t>(n));
    for (int64_t i = 0; i < n; i++) {
        std::string s(buf + offsets[i],
                      static_cast<size_t>(offsets[i + 1] - offsets[i]));
        auto it = t->map.find(s);
        if (it == t->map.end()) {
            int32_t idx = static_cast<int32_t>(t->ids.size());
            t->map.emplace(s, idx);
            t->ids.push_back(std::move(s));
            out[i] = idx;
        } else {
            out[i] = it->second;
        }
    }
    return static_cast<int32_t>(t->ids.size());
}

// Lookup without inserting; unknown strings get -1.
void muninn_intern_find(void* h, const char* buf, const int64_t* offsets,
                        int64_t n, int32_t* out) {
    auto* t = static_cast<InternTable*>(h);
    for (int64_t i = 0; i < n; i++) {
        std::string_view s(buf + offsets[i],
                           static_cast<size_t>(offsets[i + 1] - offsets[i]));
        auto it = t->map.find(std::string(s));
        out[i] = (it == t->map.end()) ? -1 : it->second;
    }
}

// Copy the id table back as a packed buffer. Caller passes a buffer of
// total_bytes (query with muninn_intern_bytes) and offsets[n+1].
int64_t muninn_intern_bytes(void* h) {
    auto* t = static_cast<InternTable*>(h);
    int64_t total = 0;
    for (const auto& s : t->ids) total += static_cast<int64_t>(s.size());
    return total;
}

void muninn_intern_dump(void* h, char* buf, int64_t* offsets) {
    auto* t = static_cast<InternTable*>(h);
    int64_t pos = 0;
    int64_t i = 0;
    for (const auto& s : t->ids) {
        offsets[i++] = pos;
        std::memcpy(buf + pos, s.data(), s.size());
        pos += static_cast<int64_t>(s.size());
    }
    offsets[i] = pos;
}

// ───────────────────────── CSR ─────────────────────────

// Counting-sort CSR build: O(E + V). offsets[v+1], sorted src/dst/w out.
void muninn_csr_build(const int32_t* src, const int32_t* dst, const float* w,
                      int64_t e, int32_t v, int32_t* offsets,
                      int32_t* out_src, int32_t* out_dst, float* out_w) {
    std::vector<int64_t> counts(static_cast<size_t>(v) + 1, 0);
    for (int64_t i = 0; i < e; i++) counts[static_cast<size_t>(src[i]) + 1]++;
    for (int32_t i = 0; i < v; i++) counts[i + 1] += counts[i];
    for (int32_t i = 0; i <= v; i++) offsets[i] = static_cast<int32_t>(counts[i]);
    std::vector<int64_t> cursor(counts.begin(), counts.end() - 1);
    for (int64_t i = 0; i < e; i++) {
        int64_t p = cursor[src[i]]++;
        out_src[p] = src[i];
        out_dst[p] = dst[i];
        out_w[p] = w ? w[i] : 1.0f;
    }
}

// Delta merge (graph_csr.c:175-325 role): edges (src,dst,w) plus ops
// arrays; op 0 = insert, 1 = delete. Deltas replay IN ORDER and a
// delete removes only the FIRST live matching (src,dst) occurrence —
// existing edges scan before same-batch inserts — matching the
// reference's sequential apply loop (graph_csr.c:219-247: linear scan,
// remove one, break). Returns new edge count; outputs must be sized
// e + n_ins. When non-null, `removed_pos` (sized >= #deletes) receives
// the ascending ORIGINAL positions of removed pre-existing edges and
// `*n_removed` their count — block-granular persistence uses these to
// shrink only the owning blocks (graph_csr.c:341-478 role).
int64_t muninn_csr_apply_delta(
    const int32_t* src, const int32_t* dst, const float* w, int64_t e,
    const int32_t* d_src, const int32_t* d_dst, const float* d_w,
    const uint8_t* d_op, int64_t nd,
    int32_t* out_src, int32_t* out_dst, float* out_w,
    int64_t* removed_pos, int64_t* n_removed) {
    auto pack = [](int32_t s, int32_t d) {
        return (static_cast<int64_t>(s) << 32) | static_cast<uint32_t>(d);
    };
    // FIFO queues of live existing-edge indices, built lazily on the
    // first delete and ONLY for keys this batch actually deletes (an
    // all-edges map costs tens of seconds in allocator churn at 10M
    // edges; the delete-key-restricted scan is one O(E) pass).
    std::unordered_map<int64_t, std::vector<int64_t>> existing;
    std::unordered_map<int64_t, size_t> existing_next;
    bool existing_built = false;
    auto build_existing = [&]() {
        for (int64_t i = 0; i < nd; i++)
            if (d_op[i] != 0) existing[pack(d_src[i], d_dst[i])];
        for (int64_t j = 0; j < e; j++) {
            auto it = existing.find(pack(src[j], dst[j]));
            if (it != existing.end()) it->second.push_back(j);
        }
        existing_built = true;
    };
    std::vector<uint8_t> removed(static_cast<size_t>(e), 0);
    // edges inserted by this batch, with their own removal flags
    std::vector<int32_t> ns, ndst;
    std::vector<float> nw;
    std::vector<uint8_t> nrem;
    std::unordered_map<int64_t, std::deque<int64_t>> fresh;
    for (int64_t i = 0; i < nd; i++) {
        int64_t key = pack(d_src[i], d_dst[i]);
        if (d_op[i] == 0) {
            fresh[key].push_back(static_cast<int64_t>(ns.size()));
            ns.push_back(d_src[i]);
            ndst.push_back(d_dst[i]);
            nw.push_back(d_w ? d_w[i] : 1.0f);
            nrem.push_back(0);
        } else {
            if (!existing_built) build_existing();
            auto it = existing.find(key);
            size_t& nx = existing_next[key];
            if (it != existing.end() && nx < it->second.size()) {
                removed[static_cast<size_t>(it->second[nx])] = 1;
                nx++;
            } else {
                auto jt = fresh.find(key);
                if (jt != fresh.end() && !jt->second.empty()) {
                    nrem[static_cast<size_t>(jt->second.front())] = 1;
                    jt->second.pop_front();
                }
            }
        }
    }
    int64_t n = 0;
    int64_t nr = 0;
    for (int64_t i = 0; i < e; i++) {
        if (removed[static_cast<size_t>(i)]) {
            if (removed_pos) removed_pos[nr] = i;
            nr++;
            continue;
        }
        out_src[n] = src[i];
        out_dst[n] = dst[i];
        out_w[n] = w ? w[i] : 1.0f;
        n++;
    }
    if (n_removed) *n_removed = nr;
    for (size_t i = 0; i < ns.size(); i++) {
        if (nrem[i]) continue;
        out_src[n] = ns[i];
        out_dst[n] = ndst[i];
        out_w[n] = nw[i];
        n++;
    }
    return n;
}

// ───────────────────────── Jaro-Winkler ─────────────────────────

static double jaro(const char* a, int64_t la, const char* b, int64_t lb) {
    if (la == 0 && lb == 0) return 1.0;
    if (la == 0 || lb == 0) return 0.0;
    int64_t window = std::max<int64_t>(la, lb) / 2 - 1;
    if (window < 0) window = 0;
    std::vector<uint8_t> ma(static_cast<size_t>(la), 0), mb(static_cast<size_t>(lb), 0);
    int64_t matches = 0;
    for (int64_t i = 0; i < la; i++) {
        int64_t lo = std::max<int64_t>(0, i - window);
        int64_t hi = std::min<int64_t>(lb, i + window + 1);
        for (int64_t j = lo; j < hi; j++) {
            if (!mb[j] && a[i] == b[j]) {
                ma[i] = mb[j] = 1;
                matches++;
                break;
            }
        }
    }
    if (matches == 0) return 0.0;
    // transpositions: matched chars out of order
    int64_t t = 0, j = 0;
    for (int64_t i = 0; i < la; i++) {
        if (!ma[i]) continue;
        while (!mb[j]) j++;
        if (a[i] != b[j]) t++;
        j++;
    }
    double m = static_cast<double>(matches);
    return (m / la + m / lb + (m - t / 2.0) / m) / 3.0;
}

// Jaro-Winkler with the standard 4-char prefix bonus * 0.1
// (string_sim.c:11-96 behavior).
double muninn_jaro_winkler(const char* a, int64_t la, const char* b, int64_t lb) {
    double j = jaro(a, la, b, lb);
    int64_t prefix = 0;
    int64_t maxp = std::min<int64_t>({la, lb, 4});
    for (int64_t i = 0; i < maxp; i++) {
        if (a[i] == b[i]) prefix++;
        else break;
    }
    return j + prefix * 0.1 * (1.0 - j);
}

// Batch: n pairs packed as (buf_a, off_a[n+1]) x (buf_b, off_b[n+1]).
void muninn_jaro_winkler_batch(const char* buf_a, const int64_t* off_a,
                               const char* buf_b, const int64_t* off_b,
                               int64_t n, double* out) {
    for (int64_t i = 0; i < n; i++) {
        out[i] = muninn_jaro_winkler(
            buf_a + off_a[i], off_a[i + 1] - off_a[i],
            buf_b + off_b[i], off_b[i + 1] - off_b[i]);
    }
}

}  // extern "C"
