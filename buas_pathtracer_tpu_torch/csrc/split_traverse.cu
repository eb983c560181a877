// split_traverse<OCCLUSION>: closest-hit / any-hit walk of the split tables
// of big scenes (ops/wide_bvh.py split_for_dma), one instantiation of the
// walk core in walk.cuh.
//
// Replaces the TPU kernels buas_pathtracer_tpu/ops/pallas_packet.py
// _kernel_v7 (:616, the grouped walk _kernel_v5 with DMA=True) and
// _kernel_v4 (:1216, block-lockstep walk with a 16-slot leaf-DMA ring).
// Both compute one function: the unified walk over a RESIDENT table of
// internal and analytic-prim rows (64 floats) and a LEAF table of merged
// triangle leaves (128 floats, up to 12 triangles).  On the TPU the split
// keeps the internal tree in VMEM and streams leaf rows from HBM through an
// explicit DMA ring; on Hopper the caches do that job.
//
// Links: a stack entry carries a signed link, >= 0 a resident row, -(l+1)
// leaf row l.  An internal resident row holds its 8 child links in lanes
// 50..57 and their kinds, 2 bits each, in lane 58, exact float values
// decoded with (int); lane 1 (the unified child_base) is not read.  EMPTY
// children (dropped padding rows, merged-away leaf slots) carry link 0, the
// root's, and are never pushed.
//
// What bounds the walk on an H100 and what the design does about it:
// walk.cuh.  On the stress scene the two tables (7.8 MB resident + 34.8 MB
// leaf) fit the 50 MB L2; a merged leaf is entered whenever any member's
// box is hit and then tests all its triangles (1.72x the unified walk's
// triangle tests on the stress waves, PERF.md).

#include "walk.cuh"

namespace {

// no minimum of blocks per SM: the compiler's choice (90-92 registers,
// no spills, five blocks) measured 0.7-1.7% faster on the stress waves
// than the six that wide_traverse.cu asks for (PERF.md, the walks' step
// table)
constexpr int MIN_BLOCKS = 1;

__global__ void __launch_bounds__(walk::THREADS, MIN_BLOCKS)
split_traverse_closest(walk::Split tab, walk::Args a) {
  walk::run<walk::Split, false>(tab, a);
}

__global__ void __launch_bounds__(walk::THREADS, MIN_BLOCKS)
split_traverse_occlusion(walk::Split tab, walk::Args a) {
  walk::run<walk::Split, true>(tab, a);
}

// The counted walks: the same walks, also counting live rays and leaf-row
// fetches and marking the leaf rows fetched (walk.cuh, COUNT).  Launched
// when the caller passes the counters, which ops/packet.py does for the
// walks of a traced frame; their names carry the walk's, so a profile
// counts them as the frame's split walks.
__global__ void __launch_bounds__(walk::THREADS, MIN_BLOCKS)
split_traverse_closest_counted(walk::Split tab, walk::Args a) {
  walk::run<walk::Split, false, true>(tab, a);
}

__global__ void __launch_bounds__(walk::THREADS, MIN_BLOCKS)
split_traverse_occlusion_counted(walk::Split tab, walk::Args a) {
  walk::run<walk::Split, true, true>(tab, a);
}

using Kernel = void (*)(walk::Split, walk::Args);

// mode: 1 occlusion, + 2 counted
Kernel kernel_of(int mode) {
  static const Kernel k[4] = {split_traverse_closest, split_traverse_occlusion,
                              split_traverse_closest_counted,
                              split_traverse_occlusion_counted};
  return k[mode & 3];
}

}  // namespace

extern "C" int split_traverse_launch(
    const void *res, const void *leaf, int n, const void *ox, const void *oy,
    const void *oz, const void *dx, const void *dy, const void *dz,
    const void *t0, const void *ign, int occlusion, void *t_out,
    void *prim_out, void *tri_out, void *bv_out, void *bw_out, void *stats,
    void *next, void *steps, void *counts, void *leaf_bits, int blocks,
    void *stream) {
  const walk::Args a = walk::make_args(
      n, ox, oy, oz, dx, dy, dz, t0, ign, t_out, prim_out, tri_out, bv_out,
      bw_out, stats, next, steps, counts, leaf_bits);
  const walk::Split tab{static_cast<const float4 *>(res),
                        static_cast<const float4 *>(leaf)};
  // the counters and the bitmap (both or neither) select the counted walk
  if ((counts == nullptr) != (leaf_bits == nullptr))
    return (int)cudaErrorInvalidValue;
  return walk::launch(kernel_of((occlusion ? 1 : 0) + (counts ? 2 : 0)), tab,
                      a, blocks, stream);
}

// blocks of walk::THREADS resident on the card, queried once per mode
extern "C" int split_traverse_blocks(int occlusion) {
  static int cached[2] = {0, 0};
  int &c = cached[occlusion ? 1 : 0];
  if (c == 0)
    c = walk::resident_blocks(occlusion ? split_traverse_occlusion
                                        : split_traverse_closest);
  return c;
}

// the same for the counted walks
extern "C" int split_traverse_counted_blocks(int occlusion) {
  static int cached[2] = {0, 0};
  int &c = cached[occlusion ? 1 : 0];
  if (c == 0) c = walk::resident_blocks(kernel_of(occlusion ? 3 : 2));
  return c;
}

extern "C" int split_traverse_max_stack() { return walk::STACK; }
