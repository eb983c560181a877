// The lane logic of csrc/hit.cuh on the host, for the CPU tests
// (tests/test_torch_hit.py): every lane in turn.  Built with g++
// -ffp-contract=off.
#include "../../buas_pathtracer_tpu_torch/csrc/hit.cuh"

extern "C" int hit_args_size() { return (int)sizeof(hit::Args); }

extern "C" void hit_record_host(const hit::Args *a) {
  for (int64_t i = 0; i < a->n; ++i) hit::record_lane(*a, i);
}
