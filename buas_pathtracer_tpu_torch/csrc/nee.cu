// nee_sample: next-event estimation's samples and the shadow wave's set-up,
// one launch a bounce between shade_hit and the occlusion walk
// (integrators/advanced.py _nee).
//
// This kernel replaces no TPU kernel: on the TPU, XLA fuses NEE into the
// frame program.  On the H100 the port ran it as ~190-230 PyTorch ops a
// bounce: 1,840 of a bench frame's 3,430 launches and 31 of its 45 device
// ms (PERF.md, section 5), each op a pass over every lane, dead or not,
// with an (N, 16) gather of the picked light's row and strided ops over its
// transposed view, then a concatenation of the light and environment
// queries into one wave.  Here each lane is one thread that reads its
// alive flag, NEE flag, RNG state, hit point and oriented normal (shade_hit's
// scratch), draws the plain version's samples, reads its light row and
// environment texel through the read-only path, and writes the samples'
// terms for shade_next and its queries straight into the shadow wave: the
// light's in lanes [0, n), the environment's in [n, 2n), with t0 already
// shortened by the plane pass and the ignored prim as int32, as the walk
// reads them.  The lane logic and its arithmetic are in nee.cuh.
//
// What bounds it on an H100: memory bytes.  A lane NEE serves reads 34 B
// (alive 1, NEE flag 1, RNG state 8, normal 12, point 12), 4-24 more at
// bounce 0 (first-bounce bases), and writes its RNG state (8); a light
// sample adds its terms (20), slot (4) and query (33: o 12, d 12, t0 4,
// ignored prim 4, flags 1); an environment sample its terms (20), query
// (33) and the reads of its alias entry and texel (28).  A live lane NEE
// does not serve reads 10 B and writes 8 + 5 a query kind (t0, flags); a
// dead lane reads 1 B and writes 5 a query kind.  The light rows come from
// cache.  A bench bounce (2 lights, no environment) at 2,073,600 lanes all
// served moves 99 B a lane, 0.21 GB, 0.061 ms at 3.35 TB/s; at 17% live
// lanes, ~0.045 GB.

#include <cuda_runtime.h>

#include "nee.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) nee_sample_kernel(shade::Args a) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i < a.n) shade::nee_lane(a, i);
}

}  // namespace

extern "C" int nee_sample_launch(const shade::Args *a, void *stream) {
  if (a->n <= 0) return (int)cudaSuccess;
  const int64_t blocks = (a->n + THREADS - 1) / THREADS;
  nee_sample_kernel<<<(unsigned)blocks, THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(*a);
  return (int)cudaGetLastError();
}
