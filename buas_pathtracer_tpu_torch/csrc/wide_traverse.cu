// wide_traverse<OCCLUSION>: closest-hit / any-hit walk of the unified
// 8-wide row table (ops/wide_bvh.py row encoding), one instantiation of the
// walk core in walk.cuh.
//
// Replaces the TPU kernels buas_pathtracer_tpu/ops/pallas_packet.py
// _kernel_v2 (:406, block-lockstep walk, the primary wave), _kernel_v5 in
// its VEC=True, G=8 form (:639, grouped walk, bounce and shadow waves) and
// the v1 _kernel (:71, lockstep walk that evaluates every node body).  All
// three compute this function; their schedules are Mosaic's.
//
// The table: 64-float rows; an internal row's children are rows
// child_base + 0..7 (lane 1) and their kinds lanes 50..57; a triangle leaf
// holds up to 6 triangles (lanes 8 + 9k).  What bounds the walk on an H100
// and what the design does about it: walk.cuh.  On the bench scene the
// table (5.2 MB) sits in the 50 MB L2; on the stress scene (62.6 MB, 22 MB
// of it EMPTY padding that no walk reads) the rows a wave touches do.

#include "walk.cuh"

namespace {

// six blocks of 128 threads per SM (80 registers a thread, 38-44 bytes
// spilled): 1.2-2.6% faster on the bench waves than the compiler's choice
// (~88 registers, five blocks), measured in turns (PERF.md, the walks' step
// table); on the split walk it was slower, so split_traverse.cu keeps five
constexpr int MIN_BLOCKS = 6;

__global__ void __launch_bounds__(walk::THREADS, MIN_BLOCKS)
wide_traverse_closest(walk::Unified tab, walk::Args a) {
  walk::run<walk::Unified, false>(tab, a);
}

__global__ void __launch_bounds__(walk::THREADS, MIN_BLOCKS)
wide_traverse_occlusion(walk::Unified tab, walk::Args a) {
  walk::run<walk::Unified, true>(tab, a);
}

}  // namespace

extern "C" int wide_traverse_launch(
    const void *rows, int n, const void *ox, const void *oy, const void *oz,
    const void *dx, const void *dy, const void *dz, const void *t0,
    const void *ign, int occlusion, void *t_out, void *prim_out,
    void *tri_out, void *bv_out, void *bw_out, void *stats, void *next,
    void *steps, int blocks, void *stream) {
  const walk::Args a = walk::make_args(
      n, ox, oy, oz, dx, dy, dz, t0, ign, t_out, prim_out, tri_out, bv_out,
      bw_out, stats, next, steps);
  const walk::Unified tab{static_cast<const float4 *>(rows)};
  return walk::launch(
      occlusion ? wide_traverse_occlusion : wide_traverse_closest, tab, a,
      blocks, stream);
}

// blocks of walk::THREADS resident on the card, queried once per mode
extern "C" int wide_traverse_blocks(int occlusion) {
  static int cached[2] = {0, 0};
  int &c = cached[occlusion ? 1 : 0];
  if (c == 0)
    c = walk::resident_blocks(occlusion ? wide_traverse_occlusion
                                        : wide_traverse_closest);
  return c;
}

extern "C" int wide_traverse_max_stack() { return walk::STACK; }
