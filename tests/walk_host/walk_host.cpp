// The walk core of csrc/walk.cuh run on the host: every block's warps at
// once, each warp as 32 threads (cuda_host.h), so the blocks compete for
// the ray counter as on the card.  Built with g++ by
// tests/test_torch_walk.py; the C functions take the arguments of
// wide_traverse_launch / split_traverse_launch, without the stream.
#include "cuda_host.h"
#include <thread>
#include <vector>
#include "walk.cuh"

template <class Tab, bool OCC>
static void emu_run(Tab tab, walk::Args a, int blocks) {
  const int threads = blocks * walk::THREADS;
  std::vector<Warp> warps(threads / 32);
  std::vector<std::thread> th;
  for (int t = 0; t < threads; ++t)
    th.emplace_back([&, t] {
      threadIdx.x = t % walk::THREADS;
      cur_warp = &warps[t / 32];
      walk::run<Tab, OCC>(tab, a);
    });
  for (auto &x : th) x.join();
}

extern "C" int emu_wide(const void *rows, int n, const void *ox, const void *oy, const void *oz,
    const void *dx, const void *dy, const void *dz, const void *t0, const void *ign, int occ,
    void *t_out, void *prim_out, void *tri_out, void *bv_out, void *bw_out, void *stats,
    void *next, void *steps, int blocks) {
  walk::Args a = walk::make_args(n, ox, oy, oz, dx, dy, dz, t0, ign, t_out, prim_out, tri_out,
                                 bv_out, bw_out, stats, next, steps);
  walk::Unified tab{(const float4 *)rows};
  if (n <= 0) return 0;
  if (occ) emu_run<walk::Unified, true>(tab, a, blocks);
  else emu_run<walk::Unified, false>(tab, a, blocks);
  return 0;
}
extern "C" int emu_split(const void *res, const void *leaf, int n, const void *ox, const void *oy,
    const void *oz, const void *dx, const void *dy, const void *dz, const void *t0,
    const void *ign, int occ, void *t_out, void *prim_out, void *tri_out, void *bv_out,
    void *bw_out, void *stats, void *next, void *steps, int blocks) {
  walk::Args a = walk::make_args(n, ox, oy, oz, dx, dy, dz, t0, ign, t_out, prim_out, tri_out,
                                 bv_out, bw_out, stats, next, steps);
  walk::Split tab{(const float4 *)res, (const float4 *)leaf};
  if (n <= 0) return 0;
  if (occ) emu_run<walk::Split, true>(tab, a, blocks);
  else emu_run<walk::Split, false>(tab, a, blocks);
  return 0;
}
