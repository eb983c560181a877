// The triangle-stream core of csrc/tristream.cuh run on the host: every
// block of the (ray tiles) x (splits) grid at once, each warp as 32 threads
// and each block with its own barrier and staging array (cuda_host.h), so
// the blocks race for the keys as on the card; then the finish step per
// ray.  Built with g++ by tests/test_torch_tristream.py; emu_tristream takes
// the arguments of tristream_closest_launch, without the stream.
#include "cuda_host.h"
#include <memory>
#include <thread>
#include <vector>
#include "tristream.cuh"

extern "C" int emu_tristream(const void *tris, int n_tris, int n, const void *ox,
    const void *oy, const void *oz, const void *dx, const void *dy, const void *dz,
    void *keys, int splits, void *t_out, void *id_out, void *u_out, void *v_out) {
  if (n <= 0) return 0;
  const tri::Args a{(const float *)tris, n_tris, n, splits, (const float *)ox,
                    (const float *)oy, (const float *)oz, (const float *)dx,
                    (const float *)dy, (const float *)dz, (unsigned long long *)keys,
                    (float *)t_out, (int *)id_out, (float *)u_out, (float *)v_out};
  for (int i = 0; i < n; ++i) a.keys[i] = tri::NO_HIT;
  const int tiles = (n + tri::BLOCK_RAYS - 1) / tri::BLOCK_RAYS;
  const int blocks = tiles * splits;
  std::vector<std::unique_ptr<Block>> bars;
  std::vector<std::vector<float>> stages;
  for (int b = 0; b < blocks; ++b) {
    bars.emplace_back(new Block(tri::THREADS));
    stages.emplace_back(tri::TILE * tri::STAGE_W);
  }
  std::vector<Warp> warps(blocks * tri::THREADS / 32);
  std::vector<std::thread> th;
  for (int t = 0; t < blocks * tri::THREADS; ++t)
    th.emplace_back([&, t] {
      const int b = t / tri::THREADS;
      threadIdx.x = t % tri::THREADS;
      blockIdx.x = b % tiles;
      blockIdx.y = b / tiles;
      cur_warp = &warps[t / 32];
      cur_block = bars[b].get();
      tri::stream_block(a, stages[b].data(), blockIdx.x, blockIdx.y);
    });
  for (auto &x : th) x.join();
  for (int i = 0; i < n; ++i) tri::finish(a, i);
  return 0;
}
