// The BLS12-381 G1 multi-scalar multiply on the card: sum_i s_i P_i over
// compressed points, scalars mod r as 64 base-16 digits.
//
// Replaces the JAX package's XLA device program (not a Pallas kernel):
//   bls_g1_msm  <- _msm_kernel  plenum_tpu/ops/bls381_pairing.py:285
//
// Bound: operations (ops/bls381_pairing.py msm_cost): each distinct point
// decompressed once, then the bucket method at its best window: a mixed
// addition for each finite point and window whose digit is not zero, the
// running sums over the 2^c - 1 buckets, c doublings and an addition
// between windows. Design: the bucket method over c-bit windows, c from the
// call's N (ops/bls381_pairing.py msm_window, the width msm_cost picks when
// every window is nonzero). Launch 1 decompresses each distinct point (the
// host packs them once, with an index a scalar) and re-slices every
// scalar's 64 nibbles into its windows. Launch 2, a block a window, sorts
// the window's points into their buckets (counts, a scan, a scatter) and
// sums each bucket with mixed additions, a thread a bucket, so that a
// warp's lanes add at once. Launch 3 runs each window's bucket sums in
// segments; launch 4, one block, combines the segments, then the windows
// (c doublings and an addition each, Horner), and normalizes. Launches 3
// and 4 split each addition's and doubling's independent products over six
// lanes (sextets): one thread's products are one chain of carry flags, so
// a chain of additions on one thread takes a multiply's latency per
// product. What stays on one thread: a point's decompression, the final
// inversion.

#include "bls381_core.cuh"

// MSM, launch 1: a thread per distinct point (decompressed to affine
// Montgomery, its finite flag; an undecodable one sets *bad) and a thread
// per scalar (its 255 bits, from 64 nibbles most significant first, cut
// into W windows of c bits, window w into win[w N + i]).
__global__ void __launch_bounds__(MSM_THREADS)
bls_msm_prep_kernel(const int32_t* x12, const u8* sign, const u8* inf,
                    const u8* valid, int D, const int32_t* digits, int N,
                    int c, int W, fp2* pts, u8* finite, uint16_t* win,
                    u32* bad) {
  const int t = blockIdx.x * MSM_THREADS + threadIdx.x;
  if (t < D) {
    fp2 p;
    p.c0 = FP_ZERO;
    p.c1 = FP_ZERO;
    if (!g1_decompress(&p.c0, &p.c1, x12 + (size_t)t * BLS_LIMBS12, sign[t],
                       inf[t], valid[t]))
      atomicOr(bad, 1u);
    pts[t] = p;
    finite[t] = valid[t] && !inf[t];
  }
  if (t < N) {
    u32 s[9];
#pragma unroll
    for (int j = 0; j < 9; j++) s[j] = 0;
    for (int k = 0; k < 64; k++) {
      const int pos = 4 * (63 - k);
      s[pos >> 5] |= ((u32)digits[(size_t)t * 64 + k] & 15) << (pos & 31);
    }
    const u32 mask = c >= 32 ? 0xffffffffu : (1u << c) - 1;
    for (int w = 0; w < W; w++) {
      const int o = c * w, lo = o >> 5, sh = o & 31;
      u32 v = s[lo] >> sh;
      if (sh && lo + 1 < 9) v |= s[lo + 1] << (32 - sh);
      win[(size_t)w * N + t] = (uint16_t)(v & mask);
    }
  }
}

// MSM, launch 2: block w sorts window w's finite points by their digit
// there (counts, a scan on thread 0, a scatter: start[b] .. start[b + 1]
// in order[]) and then sums each bucket b, a thread (striding) a bucket, by
// mixed additions; a warp's 32 buckets add their points at once. The order
// within a bucket depends on the atomics, the sum does not.
__global__ void __launch_bounds__(MSM_BUCKET_THREADS)
bls_msm_bucket_kernel(const uint16_t* win, const int32_t* index, int N,
                      int c, const fp2* pts, const u8* finite, int* start,
                      int* order, proj<fp>* bucket) {
  const int w = blockIdx.x, nb = 1 << c, T = blockDim.x, tid = threadIdx.x;
  const uint16_t* row = win + (size_t)w * N;
  int* cnt = start + (size_t)w * (nb + 1);
  int* ord = order + (size_t)w * N;
  for (int b = tid; b <= nb; b += T) cnt[b] = 0;
  __syncthreads();
  for (int i = tid; i < N; i += T) {
    const int v = row[i];
    if (v && finite[index[i]]) atomicAdd(&cnt[v], 1);
  }
  __syncthreads();
  if (tid == 0) {                        // exclusive scan: cnt[b] = start
    int at = 0;
    for (int b = 0; b < nb; b++) {
      const int n = cnt[b];
      cnt[b] = at;
      at += n;
    }
    cnt[nb] = at;
  }
  __syncthreads();
  for (int i = tid; i < N; i += T) {     // cnt[v] moves to bucket v's end
    const int v = row[i];
    if (v && finite[index[i]]) ord[atomicAdd(&cnt[v], 1)] = i;
  }
  __syncthreads();
  for (int b = 1 + tid; b < nb; b += T) {
    proj<fp> acc;
    set_identity(&acc);
    for (int k = cnt[b - 1]; k < cnt[b]; k++) {
      const fp2 p = pts[index[ord[k]]];
      rcb_madd(&acc, &acc, &p.c0, &p.c1);
    }
    bucket[(size_t)w * nb + b] = acc;
  }
}

// MSM, launch 3: sextet (w, s) of W * seg runs the sums over segment s of
// window w's buckets, L = 2^c / seg of them (b from (s+1) L down to
// s L + 1): run = sum S_b, acc = sum (b - s L) S_b.
__global__ void __launch_bounds__(MSM_THREADS)
bls_msm_segment_kernel(const proj<fp>* bucket, int c, int W, int seg,
                       proj<fp>* part) {
  const int sx = sextet_index();
  if (sx < 0) return;
  const int t = blockIdx.x * (MSM_THREADS / 32 * 5) + sx;
  const int nb = 1 << c, L = nb / seg;
  if (t >= W * seg) return;
  const sextet g = lane_sextet();
  const int w = t / seg, s = t % seg;
  proj<fp> run, acc;
  set_identity(&run);
  set_identity(&acc);
  for (int b = (s + 1) * L; b > s * L; b--) {
    if (b < nb) {
      const proj<fp> B = bucket[(size_t)w * nb + b];
      sx_add(g, &run, &run, &B);
    }
    sx_add(g, &acc, &acc, &run);
  }
  if (g.l == 0) {
    part[2 * t] = acc;
    part[2 * t + 1] = run;
  }
}

// MSM, launch 4, one block of MSM_WINDOW_THREADS: sextet w (striding) the
// window's
//   T_w = sum_s acc_s + L sum_s s run_s
// (a running sum over the segments, then log2 L doublings); then sextet 0
// Horner over the windows (c doublings and an addition each), and its lane
// 0 the normalized result (the identity and ok 0 when a point did not
// decode).
__global__ void __launch_bounds__(MSM_WINDOW_THREADS)
bls_msm_window_kernel(const proj<fp>* part, int c, int W, int seg,
                      proj<fp>* window, const u32* bad, int32_t* X,
                      int32_t* Y, int32_t* Z, u8* ok_out) {
  const int sx = sextet_index(), L = (1 << c) / seg;
  const sextet g = lane_sextet();
  if (sx >= 0) {
    for (int w = sx; w < W; w += MSM_WINDOW_THREADS / 32 * 5) {
      proj<fp> r2, a2;
      set_identity(&r2);
      set_identity(&a2);
      for (int s = seg - 1; s >= 1; s--) {
        const proj<fp> run = part[2 * (w * seg + s) + 1];
        sx_add(g, &r2, &r2, &run);
        sx_add(g, &a2, &a2, &r2);
      }
      for (int l = L; l > 1; l >>= 1) sx_dbl(g, &a2, &a2);
      for (int s = 0; s < seg; s++) {
        const proj<fp> acc = part[2 * (w * seg + s)];
        sx_add(g, &a2, &a2, &acc);
      }
      if (g.l == 0) window[w] = a2;
    }
  }
  __syncthreads();
  if (sx == 0) {
    proj<fp> acc = window[W - 1];
    for (int w = W - 2; w >= 0; w--) {
      for (int d = 0; d < c; d++) sx_dbl(g, &acc, &acc);
      const proj<fp> T = window[w];
      sx_add(g, &acc, &acc, &T);
    }
    if (g.l == 0) {
      if (*bad) set_identity(&acc);
      store_g1(X, Y, Z, &acc);
      ok_out[0] = *bad == 0;
    }
  }
}

// ------------------------------------------------------------ C entries
// Each launches on `stream`, reads nothing back and returns the CUDA error
// of its launches (0 when they were accepted).

extern "C" {

// the segments a window's buckets are cut into: a power of two, at most
// 2^c
int bls_msm_segments(int c) { return c >= 4 ? 16 : 1 << c; }

struct msm_scratch {
  fp2* pts;
  u8* finite;
  uint16_t* win;
  int* start;
  int* order;
  proj<fp>* bucket;
  proj<fp>* part;
  proj<fp>* window;
  u32* bad;
  size_t bytes;
};

static msm_scratch msm_layout(void* base, int N, int D, int c) {
  msm_scratch s;
  u8* p = (u8*)base;
  size_t at = 0;
  const int W = (255 + c - 1) / c, seg = bls_msm_segments(c);
  s.bad = (u32*)(p + at);                // first: the caller zeroes it
  at += 16;
  s.pts = (fp2*)(p + at);
  at += align16((size_t)D * sizeof(fp2));
  s.finite = p + at;
  at += align16(D);
  s.win = (uint16_t*)(p + at);
  at += align16((size_t)W * N * sizeof(uint16_t));
  s.start = (int*)(p + at);
  at += align16((size_t)W * (((size_t)1 << c) + 1) * sizeof(int));
  s.order = (int*)(p + at);
  at += align16((size_t)W * N * sizeof(int));
  s.bucket = (proj<fp>*)(p + at);
  at += align16((size_t)W * ((size_t)1 << c) * sizeof(proj<fp>));
  s.part = (proj<fp>*)(p + at);
  at += align16((size_t)2 * W * seg * sizeof(proj<fp>));
  s.window = (proj<fp>*)(p + at);
  at += align16((size_t)W * sizeof(proj<fp>));
  s.bytes = at;
  return s;
}

// the scratch bytes of an MSM over N scalars and D distinct points at
// window c; its first 16 bytes (the flag word) must be zero
int bls_msm_scratch_bytes(int N, int D, int c) {
  return (int)msm_layout(nullptr, N, D, c).bytes;
}

// sum_i s_i P_index[i] over D distinct packed points, N scalars as [N, 64]
// nibbles, window width c (1..16)
int bls_g1_msm(const int32_t* x12, const u8* sign, const u8* inf,
               const u8* valid, int D, const int32_t* index,
               const int32_t* digits, int N, int c, void* scratch,
               int32_t* X, int32_t* Y, int32_t* Z, u8* ok,
               cudaStream_t stream) {
  if (N <= 0 || D <= 0) return 0;
  if (c < 1 || c > 16) return 1;         // cudaErrorInvalidValue
  const msm_scratch s = msm_layout(scratch, N, D, c);
  const int W = (255 + c - 1) / c, seg = bls_msm_segments(c);
  const int n = D > N ? D : N;
  LAUNCH(bls_msm_prep_kernel, (n + MSM_THREADS - 1) / MSM_THREADS,
         MSM_THREADS, stream, x12, sign, inf, valid, D, digits, N, c, W,
         s.pts, s.finite, s.win, s.bad);
  int err = cudaGetLastError();
  if (err) return err;
  const int bt = (1 << c) < MSM_BUCKET_THREADS ? (1 << c)
                                               : MSM_BUCKET_THREADS;
  LAUNCH(bls_msm_bucket_kernel, W, bt, stream, (const uint16_t*)s.win,
         index, N, c, (const fp2*)s.pts, (const u8*)s.finite, s.start,
         s.order, s.bucket);
  if ((err = cudaGetLastError())) return err;
  const int per_block = MSM_THREADS / 32 * 5;     // sextets a block
  LAUNCH(bls_msm_segment_kernel, (W * seg + per_block - 1) / per_block,
         MSM_THREADS, stream, (const proj<fp>*)s.bucket, c, W, seg, s.part);
  if ((err = cudaGetLastError())) return err;
  LAUNCH(bls_msm_window_kernel, 1, MSM_WINDOW_THREADS, stream,
         (const proj<fp>*)s.part, c, W, seg, s.window, (const u32*)s.bad, X,
         Y, Z, ok);
  return cudaGetLastError();
}
}  // extern "C"
