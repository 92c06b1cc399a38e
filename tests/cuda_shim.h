// A CPU stand-in for the CUDA features of csrc/bucket_step.cu, so that its
// kernel body compiles under g++ (C++20) and runs on the host:
//
//   g++ -std=c++20 -O1 -ffp-contract=off -pthread -include cuda_shim.h ...
//
// Every CUDA thread is a std::thread, and the blocks run one after the
// other.  __syncwarp() is a std::barrier of the warp, __syncthreads()
// and the named barriers (bar.sync, bar.arrive) std::barriers of the
// block; __shfl_xor_sync writes each lane's value to a per-warp slot,
// waits at the warp's barrier and reads its partner's slot (two slot
// arrays are used in turn, so one barrier a shuffle suffices).  Dynamic
// shared memory is a buffer per block.  With -ffp-contract=off g++ rounds every float
// multiply and add apart, as nvcc does with --fmad=false.
#pragma once

#include <barrier>
#include <cmath>
#include <cstddef>
#include <thread>
#include <vector>

#define BUCKET_STEP_SHIM 1
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)

namespace shim {

struct Index {
  unsigned x, y, z;
};

struct Warp {
  std::barrier<> bar{32};
  float slots[2][32];
};

// a block: its warps, __syncthreads and two named barriers (bar.sync /
// bar.arrive ids 1 and 2), each of every thread of the block
struct Block {
  explicit Block(int threads)
      : warps(threads / 32), all(threads), named1(threads), named2(threads) {}
  std::vector<Warp> warps;
  std::barrier<> all, named1, named2;
};

struct Thread {
  unsigned lane = 0;
  int turn = 0;
  Warp* warp = nullptr;
  Block* block = nullptr;
  float* smem = nullptr;
};

inline thread_local Thread self;
inline thread_local Index thread_index, block_index;

// Runs body() as `blocks` blocks of `threads` threads (whole warps), one
// block after the other, each with `smem_floats` floats of shared memory.
template <class Body>
void launch(int blocks, int threads, std::size_t smem_floats,
            const Body& body) {
  for (int b = 0; b < blocks; ++b) {
    Block block(threads);
    std::vector<float> smem(smem_floats + 1);
    std::vector<std::thread> pool;
    for (unsigned t = 0; t < static_cast<unsigned>(threads); ++t)
      pool.emplace_back([&, t] {
        self = Thread{t % 32, 0, &block.warps[t / 32], &block, smem.data()};
        thread_index = Index{t, 0, 0};
        block_index = Index{static_cast<unsigned>(b), 0, 0};
        body();
      });
    for (auto& t : pool) t.join();
  }
}

inline std::barrier<>& named(int id) {
  return id == 1 ? self.block->named1 : self.block->named2;
}

inline void named_sync(int id) { named(id).arrive_and_wait(); }

inline void named_arrive(int id) {
  auto token = named(id).arrive();
  (void)token;
}

}  // namespace shim

#define threadIdx shim::thread_index
#define blockIdx shim::block_index
#define DYNAMIC_SMEM(name) float* name = shim::self.smem

inline void __syncwarp(unsigned = 0xffffffffu) {
  shim::self.warp->bar.arrive_and_wait();
}

inline void __syncthreads() { shim::self.block->all.arrive_and_wait(); }

inline float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  shim::Thread& t = shim::self;
  t.warp->slots[t.turn][t.lane] = v;
  t.warp->bar.arrive_and_wait();
  const float got = t.warp->slots[t.turn][t.lane ^ lane_mask];
  t.turn ^= 1;
  return got;
}
