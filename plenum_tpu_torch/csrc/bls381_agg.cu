// BLS12-381 share aggregation on the card: B jobs over D distinct
// compressed G1 points (signature shares) or G2 points (public keys), each
// job the sum of the points its row of a [B, n] index names.
//
// Replaces the JAX package's XLA device programs (not Pallas kernels):
//   bls_g1_aggregate  <- _aggregate_kernel     plenum_tpu/ops/bls381_jax.py:363
//   bls_g2_aggregate  <- _g2_aggregate_kernel  plenum_tpu/ops/bls381_pairing.py:342
//
// Bound: operations (ops/bls381.py g1_aggregate_cost, g2_aggregate_cost):
// each distinct share decompressed once, n - 1 mixed additions a job, one
// inversion for the launch's results. What sets the time is latency: a
// point's decompression is a chain of ~460 dependent products (its square
// root), a job's sum a chain of additions, a normalization an inversion,
// and one thread's products serialize on its carry flag.
//
// Design: three launches behind one C entry. (1) Prep: each distinct point
// decompressed once (the host packs each distinct encoding once, with the
// index), to affine Montgomery (x, y) and a status (finite, infinity, bad);
// G1 a thread a point, its square root (q+1)/4 by a sliding window; G2 a
// pair of lanes a key, the root by the norm (two fixed powers in fp, a
// candidate a lane; g2_decompress_norm). (2) Sum: a block
// a job; each sextet sums a strided share of the job's points from the
// table by mixed additions (its first point loaded as it is), the sextets'
// sums then a tree of complete additions through shared memory; each
// addition's products split over the sextet's lanes (fp: a lane a product;
// fp2: a trio a product), two levels of products an addition. A bad point
// voids its job. (3) Store: a warp a job, its lane 0 normalizing to
// standard-domain (x, y, 1) or (0, 1, 0) with one inversion by safegcd
// (tens of microseconds against Fermat's ~0.5 ms).

#include "bls381_core.cuh"

#define ST_FINITE 0
#define ST_INF 1
#define ST_BAD 2             // not a valid encoding, or not on the curve
#define G1_SUM_THREADS 128   // 20 sextets a job
#define G2_SUM_THREADS 256   // 8 sextets a job

#define G2_KEYS_PER_WARP 16  // a pair of lanes a key

__device__ __forceinline__ u8 point_status(bool ok, u8 inf) {
  return !ok ? ST_BAD : inf ? ST_INF : ST_FINITE;
}

// Launch 1, G1: a thread a distinct point.
__global__ void __launch_bounds__(AGG_PREP_THREADS)
bls_g1_agg_prep_kernel(const int32_t* x12, const u8* sign, const u8* inf,
                       const u8* valid, int D, aff<fp>* table, u8* status) {
  const int t = blockIdx.x * AGG_PREP_THREADS + threadIdx.x;
  if (t >= D) return;
  aff<fp> p;
  p.x = p.y = FP_ZERO;
  const bool ok = g1_decompress(&p.x, &p.y, x12 + (size_t)t * BLS_LIMBS12,
                                sign[t], inf[t], valid[t]);
  table[t] = p;
  status[t] = point_status(ok, inf[t]);
}

// Launch 1, G2: a pair of lanes a distinct key.
__global__ void __launch_bounds__(AGG_PREP_THREADS)
bls_g2_agg_prep_kernel(const int32_t* c1, const int32_t* c0, const u8* sign,
                       const u8* inf, const u8* valid, int D,
                       aff<fp2>* table, u8* status) {
  const int slot = (threadIdx.x & 31) >> 1;
  const int k = (blockIdx.x * (AGG_PREP_THREADS / 32) + (threadIdx.x >> 5))
      * G2_KEYS_PER_WARP + slot;
  if (k >= D) return;
  aff<fp2> p;
  fp2_zero(&p.x);
  fp2_zero(&p.y);
  const int32_t* a1 = c1 + (size_t)k * BLS_LIMBS12;
  const int32_t* a0 = c0 + (size_t)k * BLS_LIMBS12;
  const lane_span g = lane_group<2>();
  const bool ok = g2_decompress_norm(&p.x, &p.y, a1, a0, sign[k], inf[k],
                                     valid[k], g);
  if (g.l == 0) {
    table[k] = p;
    status[k] = point_status(ok, inf[k]);
  }
}

// Launch 2: block `job` sums the points index[job, 0..n) names; sums[job]
// the projective sum, bad[job] set when one of them is bad or an index
// lies outside [0, D).
template <class F, int THREADS>
__device__ __forceinline__ void agg_sum(const aff<F>* table, const u8* status,
                                        int D, const int32_t* index, int n,
                                        proj<F>* sums, u8* bad_out) {
  constexpr int GROUPS = THREADS / 32 * (32 / (6 * parts<F>::n));
  __shared__ proj<F> part[GROUPS];
  __shared__ sx_buf<F> xbuf[GROUPS];
  __shared__ u32 bad;
  const int job = blockIdx.x, gi = sextet_index<F>();
  const sextet g = lane_sextet<F>(gi >= 0 ? &xbuf[gi] : nullptr);
  if (threadIdx.x == 0) bad = 0;
  __syncthreads();
  if (gi >= 0) {
    proj<F> acc;
    set_identity(&acc);
    bool started = false;
    for (int j = gi; j < n; j += GROUPS) {
      const int d = index[(size_t)job * n + j];
      const u8 st = (unsigned)d < (unsigned)D ? status[d] : ST_BAD;
      if (st == ST_BAD) atomicOr(&bad, 1u);
      if (st != ST_FINITE) continue;
      const aff<F> a = table[d];
      if (started) {
        sx_madd(g, &acc, &acc, &a);
      } else {                            // (x, y, 1)
        acc.Z = acc.Y;
        acc.X = a.x;
        acc.Y = a.y;
        started = true;
      }
    }
    if (g.l == 0) part[gi] = acc;
  }
  __syncthreads();
  for (int s = 1; s < GROUPS; s <<= 1) {
    if (gi >= 0 && gi % (2 * s) == 0 && gi + s < GROUPS) {
      proj<F> a = part[gi];
      const proj<F> b = part[gi + s];
      sx_add(g, &a, &a, &b);
      if (g.l == 0) part[gi] = a;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    sums[job] = part[0];
    bad_out[job] = bad != 0;
  }
}

__global__ void __launch_bounds__(G1_SUM_THREADS)
bls_g1_agg_sum_kernel(const aff<fp>* table, const u8* status, int D,
                      const int32_t* index, int n, proj<fp>* sums, u8* bad) {
  agg_sum<fp, G1_SUM_THREADS>(table, status, D, index, n, sums, bad);
}

__global__ void __launch_bounds__(G2_SUM_THREADS)
bls_g2_agg_sum_kernel(const aff<fp2>* table, const u8* status, int D,
                      const int32_t* index, int n, proj<fp2>* sums,
                      u8* bad) {
  agg_sum<fp2, G2_SUM_THREADS>(table, status, D, index, n, sums, bad);
}

// Launch 3: a warp a job, lane 0 normalizing (the identity and ok 0 for a
// job with a bad point).
__device__ __forceinline__ int store_job() {
  return (threadIdx.x & 31) ? -1
      : blockIdx.x * (AGG_STORE_THREADS / 32) + (threadIdx.x >> 5);
}

__global__ void __launch_bounds__(AGG_STORE_THREADS)
bls_g1_agg_store_kernel(const proj<fp>* sums, const u8* bad, int B,
                        int32_t* X, int32_t* Y, int32_t* Z, u8* ok) {
  const int job = store_job();
  if (job < 0 || job >= B) return;
  proj<fp> p = sums[job];
  if (bad[job]) set_identity(&p);
  const size_t o = (size_t)job * BLS_LIMBS12;
  normalize_g1(X + o, Y + o, Z + o, &p);
  ok[job] = !bad[job];
}

__global__ void __launch_bounds__(AGG_STORE_THREADS)
bls_g2_agg_store_kernel(const proj<fp2>* sums, const u8* bad, int B,
                        int32_t* X, int32_t* Y, int32_t* Z, u8* ok) {
  const int job = store_job();
  if (job < 0 || job >= B) return;
  proj<fp2> p = sums[job];
  if (bad[job]) set_identity(&p);
  const size_t o = (size_t)job * 2 * BLS_LIMBS12;
  normalize_g2(X + o, Y + o, Z + o, &p);
  ok[job] = !bad[job];
}

// ------------------------------------------------------------ C entries
// Each enqueues its launches on `stream`, reads nothing back and returns
// the CUDA error of its launches (0 when they were accepted).

template <class F>
struct agg_scratch {
  aff<F>* table;
  u8* status;
  proj<F>* sums;
  u8* bad;
  size_t bytes;
};

template <class F>
static agg_scratch<F> agg_layout(void* base, int B, int D) {
  agg_scratch<F> s;
  u8* p = (u8*)base;
  size_t at = 0;
  s.table = (aff<F>*)(p + at);
  at += align16((size_t)D * sizeof(aff<F>));
  s.status = p + at;
  at += align16(D);
  s.sums = (proj<F>*)(p + at);
  at += align16((size_t)B * sizeof(proj<F>));
  s.bad = p + at;
  at += align16(B);
  s.bytes = at;
  return s;
}

static int div_up(int a, int b) { return (a + b - 1) / b; }

extern "C" {

// the scratch bytes of an aggregate launch of B jobs over D distinct points
int bls_g1_aggregate_scratch_bytes(int B, int D) {
  return (int)agg_layout<fp>(nullptr, B, D).bytes;
}

int bls_g2_aggregate_scratch_bytes(int B, int D) {
  return (int)agg_layout<fp2>(nullptr, B, D).bytes;
}

// B jobs of n points, index [B * n] into the D distinct packed points (a
// job with an index outside [0, D) is void, as one with a bad point); its
// stages first..last (0: decompression, 1: sums, 2: normalization; 0..2
// the whole aggregate): a later stage reads what the earlier ones left in
// `scratch`.
int bls_g1_aggregate(const int32_t* x12, const u8* sign, const u8* inf,
                     const u8* valid, int D, const int32_t* index, int B,
                     int n, void* scratch, int32_t* X, int32_t* Y, int32_t* Z,
                     u8* ok, int first, int last, cudaStream_t stream) {
  if (B <= 0) return 0;
  const agg_scratch<fp> s = agg_layout<fp>(scratch, B, D);
  int err = 0;
  if (first <= 0 && last >= 0 && D > 0) {
    LAUNCH(bls_g1_agg_prep_kernel, div_up(D, AGG_PREP_THREADS),
           AGG_PREP_THREADS, stream, x12, sign, inf, valid, D, s.table,
           s.status);
    if ((err = cudaGetLastError())) return err;
  }
  if (first <= 1 && last >= 1) {
    LAUNCH(bls_g1_agg_sum_kernel, B, G1_SUM_THREADS, stream,
           (const aff<fp>*)s.table, (const u8*)s.status, D, index, n, s.sums,
           s.bad);
    if ((err = cudaGetLastError())) return err;
  }
  if (first <= 2 && last >= 2) {
    LAUNCH(bls_g1_agg_store_kernel, div_up(B, AGG_STORE_THREADS / 32),
           AGG_STORE_THREADS, stream, (const proj<fp>*)s.sums,
           (const u8*)s.bad, B, X, Y, Z, ok);
    err = cudaGetLastError();
  }
  return err;
}

int bls_g2_aggregate(const int32_t* c1, const int32_t* c0, const u8* sign,
                     const u8* inf, const u8* valid, int D,
                     const int32_t* index, int B, int n, void* scratch,
                     int32_t* X, int32_t* Y, int32_t* Z, u8* ok, int first,
                     int last, cudaStream_t stream) {
  if (B <= 0) return 0;
  const agg_scratch<fp2> s = agg_layout<fp2>(scratch, B, D);
  int err = 0;
  if (first <= 0 && last >= 0 && D > 0) {
    const int keys = AGG_PREP_THREADS / 32 * G2_KEYS_PER_WARP;
    LAUNCH(bls_g2_agg_prep_kernel, div_up(D, keys), AGG_PREP_THREADS,
           stream, c1, c0, sign, inf, valid, D, s.table, s.status);
    if ((err = cudaGetLastError())) return err;
  }
  if (first <= 1 && last >= 1) {
    LAUNCH(bls_g2_agg_sum_kernel, B, G2_SUM_THREADS, stream,
           (const aff<fp2>*)s.table, (const u8*)s.status, D, index, n, s.sums,
           s.bad);
    if ((err = cudaGetLastError())) return err;
  }
  if (first <= 2 && last >= 2) {
    LAUNCH(bls_g2_agg_store_kernel, div_up(B, AGG_STORE_THREADS / 32),
           AGG_STORE_THREADS, stream, (const proj<fp2>*)s.sums,
           (const u8*)s.bad, B, X, Y, Z, ok);
    err = cudaGetLastError();
  }
  return err;
}
}  // extern "C"
