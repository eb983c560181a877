// The lane logic of csrc/shade.cuh and csrc/nee.cuh on the host, for the
// CPU tests (tests/test_torch_shade.py): every lane in turn, the counts
// summed into stats as the kernels' last block does.  Built with g++
// -ffp-contract=off.
#include "../../buas_pathtracer_tpu_torch/csrc/nee.cuh"

extern "C" int shade_args_size() { return (int)sizeof(shade::Args); }

extern "C" void shade_hit_host(const shade::Args *a) {
  long long rays = 0;
  for (int64_t i = 0; i < a->n; ++i) rays += shade::shade_hit_lane(*a, i);
  a->stats[0] = a->stats[0] + (float)rays;
  a->stats[1] = a->stats[1] + (float)*a->node_visits;
  a->stats[2] = a->stats[2] + (float)*a->tri_tests;
}

extern "C" void nee_sample_host(const shade::Args *a) {
  for (int64_t i = 0; i < a->n; ++i) shade::nee_lane(*a, i);
}

extern "C" void shade_next_host(const shade::Args *a) {
  int cnt[2] = {0, 0};
  for (int64_t i = 0; i < a->n; ++i) shade::shade_next_lane(*a, i, cnt);
  if (a->nee) a->stats[0] = a->stats[0] + (float)cnt[0];
  if (a->env_nee) a->stats[0] = a->stats[0] + (float)cnt[1];
}
