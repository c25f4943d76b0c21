// Microkernels that measure what the card issues of SHA-256's work, for
// plenum_tpu_torch/sha256_ceilings.py (built by ops/cuda_lib.py like the
// kernels; nothing on the port's paths calls them):
//
// ceil_mix_kernel<ADDS>: the compression's own mix of SHF, LOP3 and IADD3
//   (or, with ADDS_ALL, its adds as IMADs: sha256_compress_block_t), a
//   chain of compressions in registers per thread and no memory, at the
//   compress kernel's launch bounds: many independent chains, one a thread.
// ceil_op_kernel<OP>: eight independent chains a thread of one opcode (SHF,
//   LOP3, IADD3 or IMAD, as inline PTX so that the compiler neither folds
//   nor swaps them) or of one opcode and IMAD in turns.
// ceil_node_chain_kernel<ADDS>: one thread hashes L dependent Merkle nodes
//   in registers, node i + 1 = H(0x01 || node i || node i) (sha256_node's
//   two compressions, adds routed by ADDS): the latency of one node, the
//   floor of one level of an append.
// ceil_empty: an empty launch.
// sha256_compress_kernel<ADDS> in both routings of its adds.
//
// Thread 0 of CTA 0 of the mix and op kernels records clock64() and the
// global timer at the start and the end of its loop, so the tool reads the
// SM clock under load.
#include "sha256.cu"

#define CEIL_THREADS COMPRESS_THREADS

enum { OP_SHF, OP_LOP3, OP_IADD3, OP_IMAD, OP_SHF_IMAD, OP_LOP3_IMAD,
       OP_IADD3_IMAD, OP_COUNT };

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void stamp(long long* clocks, int at) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    clocks[at] = clock64();
    clocks[at + 1] = global_ns();
  }
}

template <int ADDS>
__global__ void __launch_bounds__(CEIL_THREADS, 4)
ceil_mix_kernel(uint4* out, int iters, long long* clocks) {
  const uint32_t seed = blockIdx.x * CEIL_THREADS + threadIdx.x;
  uint32_t st[8], w[16];
#pragma unroll
  for (int k = 0; k < 8; ++k) st[k] = seed * 0x9e3779b9u + k;
#pragma unroll
  for (int k = 0; k < 16; ++k) w[k] = seed ^ (k * 0x85ebca6bu);
  stamp(clocks, 0);
#pragma unroll 1
  for (int i = 0; i < iters; ++i) sha256_compress_block_t<ADDS>(st, w);
  stamp(clocks, 2);
  out[seed] = make_uint4(st[0] ^ st[4], st[1] ^ st[5], st[2] ^ st[6],
                         st[3] ^ st[7]);
}

// One step of chain c: x op (y, z); `one` is 1 at run time.
template <int OP>
__device__ __forceinline__ uint32_t op_step(uint32_t x, uint32_t y,
                                            uint32_t z, uint32_t one, int c) {
  const int op = OP < OP_SHF_IMAD ? OP
                 : (c & 1) ? OP_IMAD : OP - OP_SHF_IMAD;
  uint32_t r;
  if (op == OP_SHF)
    asm volatile("shf.r.wrap.b32 %0, %1, %2, 7;" : "=r"(r) : "r"(x), "r"(y));
  else if (op == OP_LOP3)
    asm volatile("lop3.b32 %0, %1, %2, %3, 0xCA;"
                 : "=r"(r) : "r"(x), "r"(y), "r"(z));
  else if (op == OP_IADD3)
    asm volatile("add.u32 %0, %1, %2;\n\tadd.u32 %0, %0, %3;"
                 : "=r"(r) : "r"(x), "r"(y), "r"(z));
  else
    asm volatile("mad.lo.u32 %0, %1, %2, %3;"
                 : "=r"(r) : "r"(x), "r"(one), "r"(y));
  return r;
}

template <int OP>
__global__ void __launch_bounds__(CEIL_THREADS, 4)
ceil_op_kernel(uint32_t* out, int iters, uint32_t one, long long* clocks) {
  const uint32_t seed = blockIdx.x * CEIL_THREADS + threadIdx.x;
  const uint32_t y = seed * 0x9e3779b9u | 1u, z = seed ^ 0x5bd1e995u;
  uint32_t x[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) x[c] = seed + c;
  stamp(clocks, 0);
#pragma unroll 1
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < 16; ++u) {
#pragma unroll
      for (int c = 0; c < 8; ++c) x[c] = op_step<OP>(x[c], y, z, one, c);
    }
  }
  stamp(clocks, 2);
  out[seed] = x[0] ^ x[1] ^ x[2] ^ x[3] ^ x[4] ^ x[5] ^ x[6] ^ x[7];
}

template <int ADDS>
__global__ void ceil_node_chain_kernel(const uint8_t* in, uint8_t* out,
                                       int L) {
  uint32_t d[8], st[8];
  load_digest(in, d);
  for (int i = 0; i < L; ++i) {
    uint32_t w[16];
    node_block1(d, d, w);
    st[0] = 0x6a09e667; st[1] = 0xbb67ae85; st[2] = 0x3c6ef372;
    st[3] = 0xa54ff53a; st[4] = 0x510e527f; st[5] = 0x9b05688c;
    st[6] = 0x1f83d9ab; st[7] = 0x5be0cd19;
    sha256_compress_block_t<ADDS>(st, w);
    uint32_t tail[16] = {(d[7] << 24) | 0x00800000u, 0, 0, 0, 0, 0, 0, 0,
                         0, 0, 0, 0, 0, 0, 0, 65 * 8};
    sha256_compress_block_t<ADDS>(st, tail);
#pragma unroll
    for (int k = 0; k < 8; ++k) d[k] = st[k];
  }
  store_digest(out, d);
}

__global__ void ceil_empty_kernel() {}

// The two routings of the adds as one switch over a template argument.
#define ADDS_SWITCH(mode, CALL)                \
  switch (mode) {                              \
    case ADDS_ALU: { CALL(ADDS_ALU); break; }  \
    case ADDS_ALL: { CALL(ADDS_ALL); break; }  \
    default: return (int)cudaErrorInvalidValue; \
  }

#define OP_SWITCH(op, CALL)                            \
  switch (op) {                                        \
    case OP_SHF: { CALL(OP_SHF); break; }              \
    case OP_LOP3: { CALL(OP_LOP3); break; }            \
    case OP_IADD3: { CALL(OP_IADD3); break; }          \
    case OP_IMAD: { CALL(OP_IMAD); break; }            \
    case OP_SHF_IMAD: { CALL(OP_SHF_IMAD); break; }    \
    case OP_LOP3_IMAD: { CALL(OP_LOP3_IMAD); break; }  \
    case OP_IADD3_IMAD: { CALL(OP_IADD3_IMAD); break; } \
    default: return (int)cudaErrorInvalidValue;        \
  }

// out: [grid * 256] uint4; clocks: 4 int64 (clock64 and global ns at the
// start and end of CTA 0's loop). One launch of `grid` CTAs on `stream`.
extern "C" int ceil_mix(int mode, int grid, int iters, void* out,
                        void* clocks, void* stream) {
#define LAUNCH_MIX(M)                                                   \
  ceil_mix_kernel<M><<<grid, CEIL_THREADS, 0, (cudaStream_t)stream>>>( \
      (uint4*)out, iters, (long long*)clocks)
  ADDS_SWITCH(mode, LAUNCH_MIX)
  return (int)cudaGetLastError();
}

// out: [grid * 256] uint32; clocks as ceil_mix's.
extern "C" int ceil_op(int op, int grid, int iters, void* out, void* clocks,
                       void* stream) {
#define LAUNCH_OP(O)                                                   \
  ceil_op_kernel<O><<<grid, CEIL_THREADS, 0, (cudaStream_t)stream>>>( \
      (uint32_t*)out, iters, 1u, (long long*)clocks)
  OP_SWITCH(op, LAUNCH_OP)
  return (int)cudaGetLastError();
}

// *ctas = resident CTAs per SM of kernel `which` (0: ceil_mix_kernel, 1:
// ceil_op_kernel, 2: sha256_compress_kernel) at template argument `arg`.
extern "C" int ceil_occupancy(int which, int arg, int* ctas) {
  cudaError_t e = cudaErrorInvalidValue;
#define OCC(KERNEL)                                                 \
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, KERNEL, \
                                                    CEIL_THREADS, 0)
#define OCC_MIX(M) OCC(ceil_mix_kernel<M>)
#define OCC_OP(O) OCC(ceil_op_kernel<O>)
#define OCC_COMPRESS(M) OCC(sha256_compress_kernel<M>)
  if (which == 0) {
    ADDS_SWITCH(arg, OCC_MIX)
  } else if (which == 1) {
    OP_SWITCH(arg, OCC_OP)
  } else if (which == 2) {
    ADDS_SWITCH(arg, OCC_COMPRESS)
  }
  return (int)e;
}

// sha256_compress's kernel with its adds routed by `mode`.
extern "C" int ceil_compress(int mode, const void* words, const void* nvalid,
                             void* out, int B, int nblocks, void* stream) {
  if (B <= 0 || nblocks <= 0) return 0;
#define LAUNCH_COMPRESS(M)                                              \
  sha256_compress_kernel<M><<<compress_grid(B), COMPRESS_THREADS, 0,    \
                              (cudaStream_t)stream>>>(                  \
      (const uint4*)words, (const int32_t*)nvalid, (uint4*)out, B, nblocks)
  ADDS_SWITCH(mode, LAUNCH_COMPRESS)
  return (int)cudaGetLastError();
}

// in: one 32-byte digest; out: the digest after L dependent node hashes,
// their adds routed by `mode`. One thread.
extern "C" int ceil_node_chain(int mode, const void* in, void* out, int L,
                               void* stream) {
#define LAUNCH_CHAIN(M)                                         \
  ceil_node_chain_kernel<M><<<1, 1, 0, (cudaStream_t)stream>>>( \
      (const uint8_t*)in, (uint8_t*)out, L)
  ADDS_SWITCH(mode, LAUNCH_CHAIN)
  return (int)cudaGetLastError();
}

extern "C" int ceil_empty(void* stream) {
  ceil_empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
