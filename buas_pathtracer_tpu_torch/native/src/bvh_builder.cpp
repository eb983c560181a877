// Host-side native BVH builder: top-down binned-SAH (Wald 2007) over item
// AABBs, plus threaded (skip-link) subtree flattening.  Byte-for-byte copy
// of buas_pathtracer_tpu/native/src/bvh_builder.cpp (apart from this
// header), so the PyTorch port packs the same tables as the JAX package.
// Native equivalent of the reference's C++ builder (Raytracer/bvh.cpp
// :138-213 binned partition, :222-287 recursion).  The threaded flattener
// feeds ops/bvh.py's flatten_world_bvh.
//
// Exposed C ABI (ctypes): handle-based because node counts are not known up
// front.  All arrays are row-major float32/int32 matching numpy defaults.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>

namespace {

constexpr int N_BINS = 16;

struct V3 {
    float x, y, z;
};

static inline V3 vmin(const V3 &a, const V3 &b) {
    return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline V3 vmax(const V3 &a, const V3 &b) {
    return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
static inline float surface_area(const V3 &lo, const V3 &hi) {
    float dx = std::max(hi.x - lo.x, 0.0f);
    float dy = std::max(hi.y - lo.y, 0.0f);
    float dz = std::max(hi.z - lo.z, 0.0f);
    return 2.0f * (dx * dy + dy * dz + dz * dx);
}

struct BuildResult {
    std::vector<float> lo, hi;        // (N,3)
    std::vector<int32_t> left_first;  // (N,)
    std::vector<int32_t> count;       // (N,)
    std::vector<int8_t> axis;         // (N,)
    std::vector<int32_t> order;       // (M,)
};

struct Range {
    int32_t node, s, e;
};

}  // namespace

extern "C" {

// Build a binned-SAH BVH over M item AABBs.  Returns an opaque handle and
// the node count; fetch arrays with bvh_fetch, release with bvh_release.
void *bvh_build(const float *item_lo, const float *item_hi, int32_t m,
                int32_t max_leaf_size, int32_t *out_n_nodes) {
    auto *res = new BuildResult();
    const V3 *lo = reinterpret_cast<const V3 *>(item_lo);
    const V3 *hi = reinterpret_cast<const V3 *>(item_hi);

    std::vector<V3> centers(m);
    for (int i = 0; i < m; i++) {
        centers[i] = {0.5f * (lo[i].x + hi[i].x), 0.5f * (lo[i].y + hi[i].y),
                      0.5f * (lo[i].z + hi[i].z)};
    }
    res->order.resize(m);
    for (int i = 0; i < m; i++) res->order[i] = i;

    size_t cap = std::max<size_t>(2 * (size_t)m, 4);
    res->lo.resize(cap * 3);
    res->hi.resize(cap * 3);
    res->left_first.assign(cap, 0);
    res->count.assign(cap, 0);
    res->axis.assign(cap, 0);

    int32_t node_count = 1;
    std::vector<Range> stack;
    stack.push_back({0, 0, m});
    std::vector<int32_t> tmp;

    while (!stack.empty()) {
        Range r = stack.back();
        stack.pop_back();
        int32_t *idx = res->order.data() + r.s;
        int32_t cnt = r.e - r.s;

        V3 blo = lo[idx[0]], bhi = hi[idx[0]];
        for (int32_t k = 1; k < cnt; k++) {
            blo = vmin(blo, lo[idx[k]]);
            bhi = vmax(bhi, hi[idx[k]]);
        }
        res->lo[r.node * 3 + 0] = blo.x;
        res->lo[r.node * 3 + 1] = blo.y;
        res->lo[r.node * 3 + 2] = blo.z;
        res->hi[r.node * 3 + 0] = bhi.x;
        res->hi[r.node * 3 + 1] = bhi.y;
        res->hi[r.node * 3 + 2] = bhi.z;

        int32_t mid = -1;
        int best_axis = 0;
        if (cnt > max_leaf_size) {
            // widest centroid axis (bvh.cpp:141-151 picks per-axis extents)
            V3 cmin = centers[idx[0]], cmax = centers[idx[0]];
            for (int32_t k = 1; k < cnt; k++) {
                cmin = vmin(cmin, centers[idx[k]]);
                cmax = vmax(cmax, centers[idx[k]]);
            }
            float ext[3] = {cmax.x - cmin.x, cmax.y - cmin.y, cmax.z - cmin.z};
            best_axis = ext[1] > ext[0] ? 1 : 0;
            if (ext[2] > ext[best_axis]) best_axis = 2;
            float extent = ext[best_axis];
            float cmin_a = best_axis == 0 ? cmin.x : (best_axis == 1 ? cmin.y : cmin.z);

            if (extent > 1e-12f) {
                // binned SAH, 16 bins, incremental L/R sweeps (bvh.cpp:138-213)
                float scale = N_BINS * (1.0f - 1e-6f) / extent;
                V3 bin_lo[N_BINS], bin_hi[N_BINS];
                int64_t bin_n[N_BINS] = {0};
                for (int b = 0; b < N_BINS; b++) {
                    bin_lo[b] = {INFINITY, INFINITY, INFINITY};
                    bin_hi[b] = {-INFINITY, -INFINITY, -INFINITY};
                }
                for (int32_t k = 0; k < cnt; k++) {
                    const V3 &c = centers[idx[k]];
                    float ca = best_axis == 0 ? c.x : (best_axis == 1 ? c.y : c.z);
                    int b = std::min((int)((ca - cmin_a) * scale), N_BINS - 1);
                    bin_lo[b] = vmin(bin_lo[b], lo[idx[k]]);
                    bin_hi[b] = vmax(bin_hi[b], hi[idx[k]]);
                    bin_n[b]++;
                }
                V3 llo[N_BINS], lhi[N_BINS], rlo[N_BINS], rhi[N_BINS];
                llo[0] = bin_lo[0];
                lhi[0] = bin_hi[0];
                for (int b = 1; b < N_BINS; b++) {
                    llo[b] = vmin(llo[b - 1], bin_lo[b]);
                    lhi[b] = vmax(lhi[b - 1], bin_hi[b]);
                }
                rlo[N_BINS - 1] = bin_lo[N_BINS - 1];
                rhi[N_BINS - 1] = bin_hi[N_BINS - 1];
                for (int b = N_BINS - 2; b >= 0; b--) {
                    rlo[b] = vmin(rlo[b + 1], bin_lo[b]);
                    rhi[b] = vmax(rhi[b + 1], bin_hi[b]);
                }
                int64_t ln = 0;
                double best_cost = INFINITY;
                int best_b = -1;
                int64_t total = cnt;
                for (int b = 0; b < N_BINS - 1; b++) {
                    ln += bin_n[b];
                    int64_t rn = total - ln;
                    if (ln == 0 || rn == 0) continue;
                    double cost = (double)surface_area(llo[b], lhi[b]) * ln +
                                  (double)surface_area(rlo[b + 1], rhi[b + 1]) * rn;
                    if (cost < best_cost) {
                        best_cost = cost;
                        best_b = b;
                    }
                }
                if (best_b >= 0) {
                    double leaf_cost = (double)surface_area(blo, bhi) * cnt;
                    if (!(best_cost >= leaf_cost && cnt <= max_leaf_size)) {
                        // stable partition: bins <= best_b go left
                        tmp.clear();
                        tmp.reserve(cnt);
                        int32_t w = 0;
                        for (int32_t k = 0; k < cnt; k++) {
                            const V3 &c = centers[idx[k]];
                            float ca = best_axis == 0 ? c.x
                                       : (best_axis == 1 ? c.y : c.z);
                            int b = std::min((int)((ca - cmin_a) * scale), N_BINS - 1);
                            if (b <= best_b)
                                idx[w++] = idx[k];
                            else
                                tmp.push_back(idx[k]);
                        }
                        std::memcpy(idx + w, tmp.data(), tmp.size() * sizeof(int32_t));
                        mid = r.s + w;
                    }
                }
            }
        }

        if (mid < 0 && cnt > max_leaf_size) {
            // forced median split: degenerate centroid extent (coincident
            // items) must never emit a leaf larger than max_leaf_size —
            // wide rows inline at most (row_w-8)/9 triangles.
            mid = r.s + cnt / 2;
        }
        if (mid < 0) {
            res->left_first[r.node] = r.s;
            res->count[r.node] = cnt;
            continue;
        }
        int32_t left = node_count;
        node_count += 2;
        res->left_first[r.node] = left;
        res->count[r.node] = 0;
        res->axis[r.node] = (int8_t)best_axis;
        stack.push_back({left + 1, mid, r.e});
        stack.push_back({left, r.s, mid});
    }

    res->lo.resize((size_t)node_count * 3);
    res->hi.resize((size_t)node_count * 3);
    res->left_first.resize(node_count);
    res->count.resize(node_count);
    res->axis.resize(node_count);
    *out_n_nodes = node_count;
    return res;
}

void bvh_fetch(void *handle, float *lo, float *hi, int32_t *left_first,
               int32_t *count, int8_t *axis, int32_t *order) {
    auto *res = static_cast<BuildResult *>(handle);
    std::memcpy(lo, res->lo.data(), res->lo.size() * sizeof(float));
    std::memcpy(hi, res->hi.data(), res->hi.size() * sizeof(float));
    std::memcpy(left_first, res->left_first.data(),
                res->left_first.size() * sizeof(int32_t));
    std::memcpy(count, res->count.data(), res->count.size() * sizeof(int32_t));
    std::memcpy(axis, res->axis.data(), res->axis.size() * sizeof(int8_t));
    std::memcpy(order, res->order.data(), res->order.size() * sizeof(int32_t));
}

void bvh_release(void *handle) { delete static_cast<BuildResult *>(handle); }

// Flatten one mesh-BVH subtree into threaded (skip-link) arrays under a
// world transform, DFS preorder: internal -> i+1 on hit, miss link past the
// subtree otherwise.  One output node per build node; caller preallocates
// n_nodes entries and passes the emit base offset so subtrees from several
// instances concatenate into the unified array (ops/bvh.py
// flatten_world_bvh).  AABBs are transformed by all-8-corners
// (scene.cpp:224-236) and padded by `pad` (flat-geometry epsilon).
void bvh_flatten_subtree(
    const float *n_lo, const float *n_hi, const int32_t *left_first,
    const int32_t *count, int32_t n_nodes, const float *fwd /* (3,4) */,
    float pad, int32_t tri_base, int32_t inst, int32_t base,
    int32_t kind_internal, int32_t kind_leaf,
    float *out_lo, float *out_hi, int32_t *out_miss, int8_t *out_kind,
    int32_t *out_first, int32_t *out_count, int32_t *out_inst) {
    // iterative DFS with explicit (build_node, state) stack; emit position
    // advances in preorder, miss links patched when a subtree closes.
    struct Frame {
        int32_t node;
        int32_t emitted_at;  // -1 until emitted
    };
    std::vector<Frame> stack;
    stack.reserve(64);
    stack.push_back({0, -1});
    int32_t at = 0;  // local emit cursor

    // First pass: emit in preorder, record subtree sizes to patch miss links.
    // A node's miss link = base + (its preorder index + subtree size).
    // Compute subtree sizes bottom-up without recursion: since children of
    // node i are left_first[i] and left_first[i]+1, do a reverse preorder
    // scan after laying out preorder order.
    std::vector<int32_t> pre(n_nodes);   // preorder position -> build node
    std::vector<int32_t> sz(n_nodes, 1); // subtree size per build node
    {
        std::vector<int32_t> s2;
        s2.push_back(0);
        int32_t p = 0;
        while (!s2.empty()) {
            int32_t ni = s2.back();
            s2.pop_back();
            pre[p++] = ni;
            if (count[ni] == 0) {
                int32_t l = left_first[ni];
                s2.push_back(l + 1);
                s2.push_back(l);
            }
        }
        for (int32_t q = n_nodes - 1; q >= 0; q--) {
            int32_t ni = pre[q];
            if (count[ni] == 0) {
                int32_t l = left_first[ni];
                sz[ni] = 1 + sz[l] + sz[l + 1];
            }
        }
    }

    for (int32_t q = 0; q < n_nodes; q++) {
        int32_t ni = pre[q];
        // transform AABB: all 8 corners through fwd
        const float *lo3 = n_lo + ni * 3;
        const float *hi3 = n_hi + ni * 3;
        float wlo[3] = {INFINITY, INFINITY, INFINITY};
        float whi[3] = {-INFINITY, -INFINITY, -INFINITY};
        for (int c = 0; c < 8; c++) {
            float px = (c & 1) ? hi3[0] : lo3[0];
            float py = (c & 2) ? hi3[1] : lo3[1];
            float pz = (c & 4) ? hi3[2] : lo3[2];
            for (int rrow = 0; rrow < 3; rrow++) {
                float v = fwd[rrow * 4 + 0] * px + fwd[rrow * 4 + 1] * py +
                          fwd[rrow * 4 + 2] * pz + fwd[rrow * 4 + 3];
                wlo[rrow] = std::min(wlo[rrow], v);
                whi[rrow] = std::max(whi[rrow], v);
            }
        }
        // outputs are subtree-local (q); `base` offsets miss-link VALUES so
        // subtrees concatenate into the unified array without re-patching
        out_lo[q * 3 + 0] = wlo[0] - pad;
        out_lo[q * 3 + 1] = wlo[1] - pad;
        out_lo[q * 3 + 2] = wlo[2] - pad;
        out_hi[q * 3 + 0] = whi[0] + pad;
        out_hi[q * 3 + 1] = whi[1] + pad;
        out_hi[q * 3 + 2] = whi[2] + pad;
        out_miss[q] = base + q + sz[ni];
        out_inst[q] = inst;
        if (count[ni] > 0) {
            out_kind[q] = (int8_t)kind_leaf;
            out_first[q] = tri_base + left_first[ni];
            out_count[q] = count[ni];
        } else {
            out_kind[q] = (int8_t)kind_internal;
            out_first[q] = 0;
            out_count[q] = 0;
        }
    }
    (void)at;
    (void)stack;
}

}  // extern "C"
