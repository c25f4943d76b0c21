// BLS12-381 share aggregation on the card: B sets of compressed G1 points
// (signature shares) or G2 points (public keys), each summed.
//
// Replaces the JAX package's XLA device programs (not Pallas kernels):
//   bls_g1_aggregate  <- _aggregate_kernel     plenum_tpu/ops/bls381_jax.py:363
//   bls_g2_aggregate  <- _g2_aggregate_kernel  plenum_tpu/ops/bls381_pairing.py:342
//
// Bound: operations (ops/bls381.py g1_aggregate_cost, g2_aggregate_cost):
// each distinct share decompressed once, n - 1 mixed additions a job, one
// inversion for the launch's results. Design: a block per job, a thread per
// share (striding past the block), RCB complete additions (the JAX tower's
// padd_rcb), a tree sum in shared memory, the result normalized to
// (x, y, 1) or (0, 1, 0) by thread 0. A G2 job is one chain on one thread
// at the end (its inversion), so its time is latency.

#include "bls381_core.cuh"

// G1 aggregate: a block per job, a thread per share.
__global__ void __launch_bounds__(AGG_THREADS)
bls_g1_aggregate_kernel(const int32_t* x12, const u8* sign, const u8* inf,
                        const u8* valid, int n, int32_t* X, int32_t* Y,
                        int32_t* Z, u8* ok_out) {
  __shared__ proj<fp> sh[AGG_THREADS];
  __shared__ u32 bad;
  const int job = blockIdx.x, tid = threadIdx.x;
  if (tid == 0) bad = 0;
  __syncthreads();
  proj<fp> acc;
  set_identity(&acc);
  for (int j = tid; j < n; j += AGG_THREADS) {
    const size_t s = (size_t)job * n + j;
    proj<fp> p;
    if (!g1_decompress(&p.X, &p.Y, x12 + s * BLS_LIMBS12, sign[s], inf[s],
                       valid[s]))
      atomicOr(&bad, 1u);
    if (valid[s] && !inf[s]) {          // a job with a bad share is void
      p.Z = FP_ONE;
      rcb_add(&acc, &acc, &p);
    }
  }
  sh[tid] = acc;
  __syncthreads();
  for (int half = AGG_THREADS / 2; half > 0; half >>= 1) {
    if (tid < half) rcb_add(&sh[tid], &sh[tid], &sh[tid + half]);
    __syncthreads();
  }
  if (tid == 0) {
    if (bad) set_identity(&sh[0]);
    store_g1(X + (size_t)job * BLS_LIMBS12, Y + (size_t)job * BLS_LIMBS12,
             Z + (size_t)job * BLS_LIMBS12, &sh[0]);
    ok_out[job] = bad == 0;
  }
}

// G2 aggregate: the same over fp2.
__global__ void __launch_bounds__(AGG_THREADS)
bls_g2_aggregate_kernel(const int32_t* c1, const int32_t* c0, const u8* sign,
                        const u8* inf, const u8* valid, int n, int32_t* X,
                        int32_t* Y, int32_t* Z, u8* ok_out) {
  __shared__ proj<fp2> sh[AGG_THREADS];
  __shared__ u32 bad;
  const int job = blockIdx.x, tid = threadIdx.x;
  if (tid == 0) bad = 0;
  __syncthreads();
  proj<fp2> acc;
  set_identity(&acc);
  for (int j = tid; j < n; j += AGG_THREADS) {
    const size_t s = (size_t)job * n + j;
    proj<fp2> p;
    if (!g2_decompress(&p.X, &p.Y, c1 + s * BLS_LIMBS12,
                       c0 + s * BLS_LIMBS12, sign[s], inf[s], valid[s]))
      atomicOr(&bad, 1u);
    if (valid[s] && !inf[s]) {
      fp2_zero(&p.Z);
      p.Z.c0 = FP_ONE;
      rcb_add(&acc, &acc, &p);
    }
  }
  sh[tid] = acc;
  __syncthreads();
  for (int half = AGG_THREADS / 2; half > 0; half >>= 1) {
    if (tid < half) rcb_add(&sh[tid], &sh[tid], &sh[tid + half]);
    __syncthreads();
  }
  if (tid == 0) {
    const size_t o = (size_t)job * 2 * BLS_LIMBS12;
    if (bad) set_identity(&sh[0]);
    store_g2(X + o, Y + o, Z + o, &sh[0]);
    ok_out[job] = bad == 0;
  }
}

// ------------------------------------------------------------ C entries
// Each launches on `stream`, reads nothing back and returns the CUDA error
// of its launches (0 when they were accepted).

extern "C" {

int bls_g1_aggregate(const int32_t* x12, const u8* sign, const u8* inf,
                     const u8* valid, int B, int n, int32_t* X, int32_t* Y,
                     int32_t* Z, u8* ok, cudaStream_t stream) {
  if (B <= 0) return 0;
  LAUNCH(bls_g1_aggregate_kernel, B, AGG_THREADS, stream, x12, sign, inf,
         valid, n, X, Y, Z, ok);
  return cudaGetLastError();
}

int bls_g2_aggregate(const int32_t* c1, const int32_t* c0, const u8* sign,
                     const u8* inf, const u8* valid, int B, int n, int32_t* X,
                     int32_t* Y, int32_t* Z, u8* ok, cudaStream_t stream) {
  if (B <= 0) return 0;
  LAUNCH(bls_g2_aggregate_kernel, B, AGG_THREADS, stream, c1, c0, sign, inf,
         valid, n, X, Y, Z, ok);
  return cudaGetLastError();
}
}  // extern "C"
