// Copy of buas_pathtracer_tpu/native/src/wide_collapse.cpp (apart from these
// two lines), so the PyTorch port packs the same row tables.
// Native wide-BVH collapse: convert a binary SAH subtree into 8-wide
// self-describing rows (ops/wide_bvh.py row encoding).  The Python collapse
// is ~25 s for an 870k-triangle mesh; this is the production path.
//
// Children of a wide node are chosen by repeatedly expanding the
// largest-surface-area internal candidate until 8 slots fill (standard
// collapse).  Leaf candidates become triangle rows (<= 6 world-space
// triangles inline); rows for a wide node's children are allocated as a
// contiguous block of 8 (empty slots get degenerate point AABBs so the
// strict slab test misses).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>

namespace {

constexpr int MAX_WIDE = 16;
constexpr int KIND_INTERNAL = 0;
constexpr int KIND_TRIS = 1;
constexpr int KIND_EMPTY = 3;

struct CollapseCtx {
    const float *lo, *hi;          // world AABBs per binary node (n,3)
    const int32_t *left_first, *count;
    const float *tri_a, *tri_e1, *tri_e2;  // (T,3) world-space, leaf-ordered
    int32_t tri_base, inst, row_base;
    float pad;
    int wide, row_w;               // node width / floats per row
    std::vector<float> rows;       // emitted rows, row_w floats each
    // subtree triangle ranges (leaf-ordered => contiguous): any subtree
    // whose total fits one row merges into ONE full leaf, instead of the
    // binary builder's half-empty leaves hanging off 2-child internals
    // (measured on the 61k-tri bench scene: mean wide arity 4.34, mean
    // leaf fill 4.5/6, 46% of child slots empty — a leaf iteration costs
    // the same at 1 or 6 triangles, so sparse rows are pure waste)
    std::vector<int32_t> sub_first, sub_count;
};

static void subtree_ranges(CollapseCtx &c, int32_t root) {
    // iterative post-order (builder trees can be deep on degenerate input)
    std::vector<int32_t> st{root};
    std::vector<int32_t> order;
    while (!st.empty()) {
        int32_t n = st.back(); st.pop_back();
        order.push_back(n);
        if (c.count[n] == 0) {
            st.push_back(c.left_first[n]);
            st.push_back(c.left_first[n] + 1);
        }
    }
    for (auto it = order.rbegin(); it != order.rend(); ++it) {
        int32_t n = *it;
        if (c.count[n] > 0) {
            c.sub_first[n] = c.left_first[n];
            c.sub_count[n] = c.count[n];
        } else {
            int32_t l = c.left_first[n];
            c.sub_first[n] = std::min(c.sub_first[l], c.sub_first[l + 1]);
            c.sub_count[n] = c.sub_count[l] + c.sub_count[l + 1];
        }
    }
}

static inline float sa(const float *lo, const float *hi) {
    float dx = std::max(hi[0] - lo[0], 0.0f);
    float dy = std::max(hi[1] - lo[1], 0.0f);
    float dz = std::max(hi[2] - lo[2], 0.0f);
    return 2.0f * (dx * dy + dy * dz + dz * dx);
}

static int32_t alloc_rows(CollapseCtx &c, int n) {
    int32_t base = (int32_t)(c.rows.size() / c.row_w);
    c.rows.resize(c.rows.size() + (size_t)n * c.row_w, 0.0f);
    for (int k = 0; k < n; k++)
        c.rows[(base + k) * (size_t)c.row_w] = (float)KIND_EMPTY;
    return base;
}

static void fill_leaf_range(CollapseCtx &c, int32_t first, int32_t cnt,
                            int32_t idx) {
    float *row = c.rows.data() + (size_t)idx * c.row_w;
    // builders guarantee leaves fit one row (forced median split); clamp
    // as defense so a violated invariant can never write past the row.
    const int32_t wide_leaf = (c.row_w - 8) / 9;
    if (cnt > wide_leaf) cnt = wide_leaf;
    row[0] = (float)KIND_TRIS;
    row[1] = (float)cnt;
    row[2] = (float)(c.tri_base + first);
    row[3] = (float)c.inst;
    for (int k = 0; k < cnt; k++) {
        int s = 8 + 9 * k;
        const float *a = c.tri_a + (size_t)(first + k) * 3;
        const float *e1 = c.tri_e1 + (size_t)(first + k) * 3;
        const float *e2 = c.tri_e2 + (size_t)(first + k) * 3;
        std::memcpy(row + s, a, 12);
        std::memcpy(row + s + 3, e1, 12);
        std::memcpy(row + s + 6, e2, 12);
    }
}

static void fill_leaf(CollapseCtx &c, int32_t node, int32_t idx) {
    // merged terminal: the whole subtree's contiguous leaf-ordered range
    fill_leaf_range(c, c.sub_first[node], c.sub_count[node], idx);
}

// Chunk-repack a small subtree: collect its SAH leaves in leaf order and
// greedily merge ADJACENT leaf ranges while a row holds them (<= wide_leaf
// triangles).  The subtree then emits as ONE wide node whose children are
// the packed rows (AABB = union of member leaf boxes) instead of a
// binary-topology cascade of 2-child internals over half-empty leaves.
// Returns the group count, or -1 if the node shouldn't be chunked (too
// many leaves/groups — caller expands normally).
struct ChunkGroup {
    int32_t first, cnt;
    float lo[3], hi[3];
};

static int chunk_groups(CollapseCtx &c, int32_t node, ChunkGroup *groups) {
    // BALANCED range chunking: the subtree's contiguous leaf-ordered range
    // cut into ceil(T/wide_leaf) near-equal rows, AABBs recomputed from
    // the triangles themselves.  (Greedy merging of SAH leaf ranges kept
    // their boundaries and left rows 4.6/6 full — leaf order is already
    // spatially coherent, so re-cut boxes stay tight.)
    const int32_t wide_leaf = (c.row_w - 8) / 9;
    int32_t T = c.sub_count[node];
    int32_t first = c.sub_first[node];
    int ng = (int)((T + wide_leaf - 1) / wide_leaf);
    if (ng > c.wide) return -1;
    int32_t base = T / ng, extra = T % ng, cur = first;
    for (int g = 0; g < ng; g++) {
        int32_t cnt = base + (g < extra ? 1 : 0);
        ChunkGroup &gr = groups[g];
        gr.first = cur;
        gr.cnt = cnt;
        for (int q = 0; q < 3; q++) {
            gr.lo[q] = 3.0e38f;
            gr.hi[q] = -3.0e38f;
        }
        for (int k = 0; k < cnt; k++) {
            const float *a = c.tri_a + (size_t)(cur + k) * 3;
            const float *e1 = c.tri_e1 + (size_t)(cur + k) * 3;
            const float *e2 = c.tri_e2 + (size_t)(cur + k) * 3;
            for (int q = 0; q < 3; q++) {
                float v0 = a[q], v1 = a[q] + e1[q], v2 = a[q] + e2[q];
                gr.lo[q] = std::min(std::min(gr.lo[q], v0),
                                    std::min(v1, v2));
                gr.hi[q] = std::max(std::max(gr.hi[q], v0),
                                    std::max(v1, v2));
            }
        }
        cur += cnt;
    }
    return ng;
}

// Expansion candidate: a binary subtree (node >= 0) or a packed chunk row
// (node == -1, with its own triangle range + AABB).  Small subtrees expand
// DIRECTLY into their chunk rows inside the parent's slots, so the parent
// fills toward 8 children instead of mirroring binary topology (the bench
// scene's collapse previously averaged 4.34 children with 46% empty slots
// and 1910 two-child internals over half-empty leaves).
struct Cand {
    int32_t node, first, cnt;
    float lo[3], hi[3];
};

static void cand_node(CollapseCtx &c, int32_t n, Cand &out) {
    out.node = n;
    out.first = out.cnt = 0;
    for (int q = 0; q < 3; q++) {
        out.lo[q] = c.lo[(size_t)n * 3 + q];
        out.hi[q] = c.hi[(size_t)n * 3 + q];
    }
}

// returns subtree wide-depth
static int emit_into(CollapseCtx &c, int32_t node, int32_t idx) {
    const int32_t wide_leaf = (c.row_w - 8) / 9;
    if (c.count[node] > 0 || c.sub_count[node] <= wide_leaf) {
        fill_leaf(c, node, idx);
        return 1;
    }
    Cand cands[2 * MAX_WIDE];
    int n_cands = 2;
    cand_node(c, c.left_first[node], cands[0]);
    cand_node(c, c.left_first[node] + 1, cands[1]);
    for (;;) {
        int best = -1;
        float best_sa = -1.0f;
        for (int i = 0; i < n_cands; i++) {
            int32_t n = cands[i].node;
            if (n >= 0 && c.count[n] == 0 && c.sub_count[n] > wide_leaf) {
                float s = sa(cands[i].lo, cands[i].hi);
                if (s > best_sa) { best_sa = s; best = i; }
            }
        }
        if (best < 0) break;
        int32_t bn = cands[best].node;
        if (c.sub_count[bn] <= c.wide * wide_leaf) {
            ChunkGroup groups[MAX_WIDE];
            int ng = chunk_groups(c, bn, groups);
            if (ng > 0 && n_cands - 1 + ng <= c.wide) {
                cands[best] = cands[--n_cands];
                for (int g = 0; g < ng; g++) {
                    Cand &o = cands[n_cands++];
                    o.node = -1;
                    o.first = groups[g].first;
                    o.cnt = groups[g].cnt;
                    for (int q = 0; q < 3; q++) {
                        o.lo[q] = groups[g].lo[q];
                        o.hi[q] = groups[g].hi[q];
                    }
                }
                continue;
            }
        }
        if (n_cands >= c.wide) break;
        int32_t l = c.left_first[bn];
        cand_node(c, l, cands[best]);
        cand_node(c, l + 1, cands[n_cands++]);
    }
    int32_t child_base = alloc_rows(c, c.wide);
    {
        float *row = c.rows.data() + (size_t)idx * c.row_w;
        row[0] = (float)KIND_INTERNAL;
        row[1] = (float)(c.row_base + child_base);
        for (int i = 0; i < c.wide; i++) {
            int s = 2 + 6 * i;
            if (i < n_cands) {
                for (int q = 0; q < 3; q++) {
                    row[s + q] = cands[i].lo[q] - c.pad;
                    row[s + 3 + q] = cands[i].hi[q] + c.pad;
                }
            } else {
                // degenerate point box: strict slab test (tn < tf) misses
                for (int q = 0; q < 6; q++) row[s + q] = 3.0e38f;
            }
        }
    }
    int depth = 0;
    for (int i = 0; i < n_cands; i++) {
        if (cands[i].node >= 0) {
            depth = std::max(depth,
                             emit_into(c, cands[i].node, child_base + i));
        } else {
            fill_leaf_range(c, cands[i].first, cands[i].cnt, child_base + i);
            depth = std::max(depth, 1);
        }
    }
    return depth + 1;
}

}  // namespace

extern "C" {

// Collapse the binary subtree rooted at `root` into wide rows.  The FIRST
// emitted row (local index 0) is the subtree's wide root; child_base links
// are pre-offset by `row_base` (the caller's global row cursor).  Returns a
// handle; fetch with wide_fetch (row count known from out_n_rows).
void *wide_collapse(const float *world_lo, const float *world_hi,
                    const int32_t *left_first, const int32_t *count,
                    int32_t n_nodes, int32_t root,
                    const float *tri_a, const float *tri_e1,
                    const float *tri_e2,
                    int32_t tri_base, int32_t inst, int32_t row_base,
                    float pad, int32_t wide, int32_t row_w,
                    int32_t *out_n_rows, int32_t *out_depth) {
    auto *c = new CollapseCtx{world_lo, world_hi, left_first, count,
                              tri_a, tri_e1, tri_e2,
                              tri_base, inst, row_base, pad,
                              (int)wide, (int)row_w, {}, {}, {}};
    c->sub_first.assign((size_t)n_nodes, 0);
    c->sub_count.assign((size_t)n_nodes, 0);
    subtree_ranges(*c, root);
    alloc_rows(*c, 1);  // local row 0 = subtree root
    *out_depth = emit_into(*c, root, 0);
    *out_n_rows = (int32_t)(c->rows.size() / c->row_w);
    return c;
}

void wide_fetch(void *handle, float *out_rows) {
    auto *c = static_cast<CollapseCtx *>(handle);
    std::memcpy(out_rows, c->rows.data(), c->rows.size() * sizeof(float));
}

void wide_release(void *handle) { delete static_cast<CollapseCtx *>(handle); }

}  // extern "C"
