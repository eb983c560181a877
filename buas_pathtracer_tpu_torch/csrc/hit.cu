// hit_record: the hit record of a closest-hit query, one launch after the
// walk (ops/traverse_wide.py intersect_scene).
//
// This kernel replaces no TPU kernel: the JAX package computes the same
// record in XLA, with one-hot matmuls and MXU transposes
// (buas_pathtracer_tpu/ops/traverse_wide.py:615-749).  On the H100 the port
// ran it as ~190 PyTorch ops a query: (N, 16) row gathers of prim_nrm16 and
// wtri_nrm16 for every lane, clamped to row 0, and elementwise ops over
// their transposed, strided views.  That cost ~6 ms of device time and ~3 ms
// of the host's launches a bounce at 1080p (PERF.md, section 5), and each
// op was a pass over every lane, most of them dead after a few bounces.
// Here each lane is one thread (grid-stride) that reads its ray and the
// walk's outputs, the one row its hit needs, and writes the record.  The
// lane logic and its arithmetic are in hit.cuh.
//
// Layout: every per-lane input and output is SoA and unit-stride, so reads
// and writes are coalesced; prim and tri are read as the walk wrote them
// (int32).  The rows come through the read-only path as four 16-byte loads.
//
// What bounds it on an H100: memory bytes.  Every lane reads its ray (24 B),
// t (4) and prim (4) and writes hit id, material id and triangle (24) and
// point and normal (24): 80 B.  On top of that, by what the lane hit:
//  - mesh: tri 4, bary v and w 8, prim_mat 8, its wtri_nrm16 row 64: 164 B;
//  - analytic (sphere or box): tri 4, prim_mat 8, its prim_nrm16 row 64:
//    156 B;
//  - plane: plane_idx 8, the plane's normal 12 and material 8: 108 B;
//  - miss or dead lane: plane_idx 8: 88 B.
// A row or table entry that many lanes read counts once in the bound: at
// 2,073,600 lanes, 182 MB (0.054 ms at 3.35 TB/s) when every lane misses,
// 340 MB (0.10 ms) when every lane hits a distinct triangle.

#include <cuda_runtime.h>

#include "hit.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int64_t MAX_BLOCKS = 1 << 20;  // the loop strides past this

__global__ void __launch_bounds__(THREADS) hit_record_kernel(hit::Args a) {
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < a.n;
       i += stride)
    hit::record_lane(a, i);
}

}  // namespace

extern "C" int hit_args_size() { return (int)sizeof(hit::Args); }

extern "C" int hit_record_launch(const hit::Args *a, void *stream) {
  if (a->n <= 0) return (int)cudaSuccess;
  int64_t blocks = (a->n + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  hit_record_kernel<<<(unsigned)blocks, THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(*a);
  return (int)cudaGetLastError();
}
