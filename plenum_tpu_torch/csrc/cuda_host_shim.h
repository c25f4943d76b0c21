// Host C++ stand-ins for the CUDA built-ins the kernels in this directory
// use, so that their device code compiles with g++ (-std=c++20) and runs
// on the CPU: one std::thread per CUDA thread, the blocks of a launch one
// after another (so a __shared__ array is a static one), every warp
// collective (__shfl_sync, __ballot_sync, __syncwarp) a barrier among the
// lanes of its mask, and __syncthreads a barrier among the block's
// threads (all of which must reach it, as the kernels here see to). Slow, but it runs the kernels' own arithmetic,
// indexing and lane-group exchanges; build with -fsanitize=address to
// catch a load outside a buffer.
#pragma once
#include <algorithm>
#include <bit>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __constant__
#define __shared__ static
#define __launch_bounds__(...)

using std::max;
using std::min;

struct alignas(16) uint4 {
  uint32_t x, y, z, w;
};
struct alignas(8) uint2 {
  uint32_t x, y;
};
inline uint4 make_uint4(uint32_t x, uint32_t y, uint32_t z, uint32_t w) {
  return uint4{x, y, z, w};
}
struct dim3h {
  int x = 0, y = 0, z = 0;
};

inline thread_local dim3h threadIdx, blockIdx;
inline dim3h blockDim, gridDim;

// The lanes of one warp. Each mask has its own barrier and two banks of
// value slots, used by turns: a collective writes the bank of its
// barrier's generation, so the next one on the same mask cannot overwrite
// values that a slower lane has still to read.
struct HostMask {
  std::condition_variable cv;
  int arrived = 0;
  uint64_t gen = 0;
  uint64_t slot[2][32];
  unsigned char value[2][32][64];   // host_shfl_value's banks
};
struct HostWarp {
  std::mutex mu;
  std::map<uint32_t, HostMask> masks;
};
inline thread_local HostWarp* host_warp = nullptr;

// Publish `bits` for this lane among the lanes of `mask`, wait for all of
// them, and return the bank that holds everyone's values.
inline const uint64_t* host_exchange(uint32_t mask, uint64_t bits) {
  HostWarp& w = *host_warp;
  std::unique_lock<std::mutex> lk(w.mu);
  HostMask& m = w.masks[mask];
  const uint64_t gen = m.gen;
  uint64_t* bank = m.slot[gen & 1];
  bank[threadIdx.x & 31] = bits;
  if (++m.arrived == std::popcount(mask)) {
    m.arrived = 0;
    ++m.gen;
    m.cv.notify_all();
  } else {
    m.cv.wait(lk, [&] { return m.gen != gen; });
  }
  return bank;
}

inline void __syncwarp(uint32_t mask = 0xffffffffu) { host_exchange(mask, 0); }

// A shuffle of a whole value of up to 64 bytes, one barrier for all of its
// words (the kernels' shuffle of a field element word by word, as one).
#define CUDA_HOST_SHIM 1
template <class T>
T host_shfl_value(uint32_t mask, const T& v, int src) {
  static_assert(sizeof(T) <= 64, "a value shuffle moves at most 64 bytes");
  HostWarp& w = *host_warp;
  std::unique_lock<std::mutex> lk(w.mu);
  HostMask& m = w.masks[mask];
  const uint64_t gen = m.gen;
  std::memcpy(m.value[gen & 1][threadIdx.x & 31], &v, sizeof(T));
  if (++m.arrived == std::popcount(mask)) {
    m.arrived = 0;
    ++m.gen;
    m.cv.notify_all();
  } else {
    m.cv.wait(lk, [&] { return m.gen != gen; });
  }
  T r;
  std::memcpy(&r, m.value[gen & 1][src & 31], sizeof(T));
  return r;
}

// The threads of one block.
struct HostBlock {
  std::mutex mu;
  std::condition_variable cv;
  int arrived = 0;
  uint64_t gen = 0;
};
inline thread_local HostBlock* host_block = nullptr;

inline void __syncthreads() {
  HostBlock& b = *host_block;
  std::unique_lock<std::mutex> lk(b.mu);
  const uint64_t gen = b.gen;
  if (++b.arrived == blockDim.x) {
    b.arrived = 0;
    ++b.gen;
    b.cv.notify_all();
  } else {
    b.cv.wait(lk, [&] { return b.gen != gen; });
  }
}

template <class T>
T __shfl_sync(uint32_t mask, T v, int src, int = 32) {
  static_assert(sizeof(T) <= 8, "a shuffle moves at most 64 bits");
  uint64_t bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  bits = host_exchange(mask, bits)[src & 31];
  T r;
  std::memcpy(&r, &bits, sizeof(T));
  return r;
}

template <class T>
T __shfl_xor_sync(uint32_t mask, T v, int o, int = 32) {
  return __shfl_sync(mask, v, (threadIdx.x & 31) ^ o);
}

inline uint32_t __ballot_sync(uint32_t mask, bool pred) {
  const uint64_t* bank = host_exchange(mask, pred);
  uint32_t votes = 0;
  for (int l = 0; l < 32; ++l)
    if ((mask >> l) & 1 && bank[l]) votes |= 1u << l;
  return votes;
}

inline uint32_t __funnelshift_l(uint32_t lo, uint32_t hi, uint32_t s) {
  s &= 31;
  return s ? (hi << s) | (lo >> (32 - s)) : hi;
}
inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, uint32_t s) {
  s &= 31;
  return s ? (lo >> s) | (hi << (32 - s)) : lo;
}
// Byte k of the result is byte (s >> 4k) & 7 of y:x (selectors 0..7).
inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s) {
  const uint64_t v = (uint64_t)y << 32 | x;
  uint32_t r = 0;
  for (int k = 0; k < 4; ++k)
    r |= (uint32_t)(v >> (8 * ((s >> (4 * k)) & 7)) & 0xff) << (8 * k);
  return r;
}
template <class T>
T __ldg(const T* p) {
  return *p;
}
template <class T>
T __ldcg(const T* p) {
  return *p;
}
inline uint32_t atomicOr(uint32_t* p, uint32_t v) {
  return __atomic_fetch_or(p, v, __ATOMIC_RELAXED);
}
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_RELAXED);
}

// kernel<<<grid, block>>>(args...) on the host.
template <class K, class... A>
void host_launch(int grid, int block, K kernel, A... args) {
  blockDim.x = block;
  gridDim.x = grid;
  for (int b = 0; b < grid; ++b) {
    std::vector<std::unique_ptr<HostWarp>> warps;
    for (int i = 0; i < (block + 31) / 32; ++i)
      warps.push_back(std::make_unique<HostWarp>());
    HostBlock barrier;
    std::vector<std::thread> threads;
    for (int t = 0; t < block; ++t)
      threads.emplace_back([&, t] {
        threadIdx.x = t;
        blockIdx.x = b;
        host_warp = warps[t / 32].get();
        host_block = &barrier;
        kernel(args...);
      });
    for (auto& th : threads) th.join();
  }
}
