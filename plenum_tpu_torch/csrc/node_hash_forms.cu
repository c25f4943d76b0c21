// One Merkle node hash H(0x01 || l || r) in three forms, as kernels whose
// SASS instructions plenum_tpu_torch/node_hash_sass.py counts:
//
// node_hash_padded: the level step before sha256_node_levels, two
//   pre-padded blocks of words made elsewhere, loaded and compressed as
//   sha256_compress_kernel does at nblocks = 2 (its block loop unrolled);
// node_hash_unfolded: the digests read and block 1 formed as
//   sha256_node_levels_kernel does, block 2's zero words taken from an
//   argument so that nvcc cannot fold them;
// node_hash_folded: sha256_node as sha256_node_levels_kernel runs it.
//
// Not built by ops/cuda_lib.py: nothing at run time calls these kernels.
#include "sha256.cu"

__device__ __forceinline__ void sha256_iv(uint32_t st[8]) {
  st[0] = 0x6a09e667; st[1] = 0xbb67ae85; st[2] = 0x3c6ef372;
  st[3] = 0xa54ff53a; st[4] = 0x510e527f; st[5] = 0x9b05688c;
  st[6] = 0x1f83d9ab; st[7] = 0x5be0cd19;
}

extern "C" __global__ void node_hash_padded(const uint4* words, uint4* out) {
  const int i = threadIdx.x;
  uint32_t st[8];
  sha256_iv(st);
#pragma unroll
  for (int blk = 0; blk < 2; ++blk) {
    uint32_t w[16];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 v = words[(2 * i + blk) * 4 + q];
      w[4 * q] = v.x; w[4 * q + 1] = v.y; w[4 * q + 2] = v.z;
      w[4 * q + 3] = v.w;
    }
    sha256_compress_block(st, w);
  }
  out[2 * i] = make_uint4(st[0], st[1], st[2], st[3]);
  out[2 * i + 1] = make_uint4(st[4], st[5], st[6], st[7]);
}

extern "C" __global__ void node_hash_unfolded(const uint8_t* in, uint8_t* out,
                                              uint32_t zero) {
  const int i = threadIdx.x;
  uint32_t l[8], r[8], st[8], w[16];
  load_digest(in + 64 * i, l);
  load_digest(in + 64 * i + 32, r);
  sha256_iv(st);
  node_block1(l, r, w);
  sha256_compress_block(st, w);
  w[0] = (r[7] << 24) | 0x00800000u;
#pragma unroll
  for (int k = 1; k < 15; ++k) w[k] = zero;
  w[15] = 65 * 8 + zero;
  sha256_compress_block(st, w);
  store_digest(out + 32 * i, st);
}

extern "C" __global__ void node_hash_folded(const uint8_t* in, uint8_t* out) {
  const int i = threadIdx.x;
  uint32_t l[8], r[8], st[8];
  load_digest(in + 64 * i, l);
  load_digest(in + 64 * i + 32, r);
  sha256_node(l, r, st);
  store_digest(out + 32 * i, st);
}
