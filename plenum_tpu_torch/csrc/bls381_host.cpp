// The C entries of bls381.cu, bls381_agg.cu and bls381_msm.cu run on the
// CPU through cuda_host_shim.h, for tests without a card:
//
//   g++ -std=c++20 -O1 -pthread -o bls381_host bls381_host.cpp
//   bls381_host pairing|g1agg|g2agg|msm|fp|pow|inv IN OUT
//
// IN holds three int32 (B, P and K; B, n and D; B, n and D; N, D and the
// window width c; the operand count n; n and the chain; n), then the
// packed arrays in the order of the entry's arguments (12-bit limbs and
// indices as int32, a flag a byte, MSM digits as int32; for fp, n and n
// elements as 12 little-endian uint32 words each; for pow, n elements of
// the chain's field, an fp2 as c0 then c1; for inv, n nonzero
// standard-domain elements). OUT receives the entry's outputs in order:
// verdict[B] and decode_ok[B] bytes; or X, Y, Z (int32 limbs) and ok
// bytes; or for fp the n Montgomery products a_i b_i R^-1 and then the n
// squares a_i^2 R^-1; for pow the n powers a_i^e (Montgomery in and out)
// of chain 0: fp (q+1)/4, 1: fp (q-3)/4, 2: fp2 (q-3)/4, 3: fp2 (q-1)/2;
// for inv the n inverses by safegcd. The Montgomery multiplies the run
// made, the squarings among them and the inversions' multiply-adds are
// printed on stdout as {"fp_muls": n, "fp_sqrs": s, "int_mads": m}.
#define BLS381_COUNT_MULS
#include <cstdio>
#include <memory>
#include <string>
#include <vector>

#include "cuda_host_shim.h"
#include "bls381.cu"
#include "bls381_agg.cu"
#include "bls381_msm.cu"

struct Reader {
  std::vector<uint8_t> buf;
  size_t pos = 0;
  std::vector<std::unique_ptr<uint8_t[]>> owned;
  template <class T>
  const T* take(size_t n) {
    const size_t bytes = n * sizeof(T);
    if (pos + bytes > buf.size()) return nullptr;
    // a heap copy of exactly these bytes, so that a sanitizer sees any
    // load past the array (operator new[] aligns it for any T here)
    owned.emplace_back(new uint8_t[bytes ? bytes : 1]);
    std::memcpy(owned.back().get(), buf.data() + pos, bytes);
    pos += bytes;
    return reinterpret_cast<const T*>(owned.back().get());
  }
};

static bool read_file(const char* path, std::vector<uint8_t>& out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  uint8_t chunk[4096];
  size_t n;
  while ((n = std::fread(chunk, 1, sizeof chunk, f)) > 0)
    out.insert(out.end(), chunk, chunk + n);
  std::fclose(f);
  return true;
}

static bool write_parts(const char* path,
                        std::initializer_list<std::pair<const void*, size_t>>
                            parts) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return false;
  for (auto& p : parts) std::fwrite(p.first, 1, p.second, f);
  std::fclose(f);
  return true;
}

int main(int argc, char** argv) {
  if (argc != 4) {
    std::fprintf(stderr, "usage: %s pairing|g1agg|g2agg|msm|fp|pow|inv IN OUT\n",
                 argv[0]);
    return 2;
  }
  const std::string mode = argv[1];
  Reader in;
  if (!read_file(argv[2], in.buf)) return 2;
  const int32_t* hdr = in.take<int32_t>(3);
  if (!hdr) return 2;
  const int a = hdr[0], b = hdr[1], c = hdr[2];
  const size_t L = BLS_LIMBS12;
  int rc = 0;
  if (mode == "pairing") {
    const size_t s = (size_t)a * b, k = (size_t)c;
    auto g1x = in.take<int32_t>(s * L);
    auto g1s = in.take<uint8_t>(s), g1i = in.take<uint8_t>(s),
         g1v = in.take<uint8_t>(s);
    auto kidx = in.take<int32_t>(s);
    auto g2c1 = in.take<int32_t>(k * L), g2c0 = in.take<int32_t>(k * L);
    auto g2s = in.take<uint8_t>(k), g2i = in.take<uint8_t>(k),
         g2v = in.take<uint8_t>(k);
    if (!g2v || in.pos != in.buf.size()) return 2;
    std::vector<uint8_t> scratch(bls_pairing_scratch_bytes(a, b, c) + 16);
    std::vector<uint8_t> verdict(a), ok(a);
    rc = bls_pairing_stages(g1x, g1s, g1i, g1v, kidx, g2c1, g2c0, g2s, g2i,
                            g2v, a, b, c, scratch.data(), verdict.data(),
                            ok.data(), 0, 2, nullptr);
    write_parts(argv[3], {{verdict.data(), verdict.size()},
                          {ok.data(), ok.size()}});
  } else if (mode == "g1agg" || mode == "g2agg") {
    const bool g2 = mode == "g2agg";
    const size_t d = (size_t)c, w = g2 ? 2 * L : L;
    auto xa = in.take<int32_t>(d * L);
    auto xb = g2 ? in.take<int32_t>(d * L) : nullptr;
    auto sg = in.take<uint8_t>(d), inf = in.take<uint8_t>(d),
         val = in.take<uint8_t>(d);
    auto index = in.take<int32_t>((size_t)a * b);
    if (!index || in.pos != in.buf.size()) return 2;
    std::vector<uint8_t> scratch(
        g2 ? bls_g2_aggregate_scratch_bytes(a, c)
           : bls_g1_aggregate_scratch_bytes(a, c));
    std::vector<int32_t> X(a * w), Y(a * w), Z(a * w);
    std::vector<uint8_t> ok(a);
    rc = g2 ? bls_g2_aggregate(xa, xb, sg, inf, val, c, index, a, b,
                               scratch.data(), X.data(), Y.data(), Z.data(),
                               ok.data(), 0, 2, nullptr)
            : bls_g1_aggregate(xa, sg, inf, val, c, index, a, b,
                               scratch.data(), X.data(), Y.data(), Z.data(),
                               ok.data(), 0, 2, nullptr);
    write_parts(argv[3], {{X.data(), X.size() * 4}, {Y.data(), Y.size() * 4},
                          {Z.data(), Z.size() * 4}, {ok.data(), ok.size()}});
  } else if (mode == "msm") {
    const size_t n = (size_t)a, d = (size_t)b;
    auto x = in.take<int32_t>(d * L);
    auto sg = in.take<uint8_t>(d), inf = in.take<uint8_t>(d),
         val = in.take<uint8_t>(d);
    auto index = in.take<int32_t>(n);
    auto digits = in.take<int32_t>(n * 64);
    if (!digits || in.pos != in.buf.size()) return 2;
    std::vector<uint8_t> scratch(bls_msm_scratch_bytes(a, b, c), 0);
    std::vector<int32_t> X(L), Y(L), Z(L);
    uint8_t ok = 0;
    rc = bls_g1_msm(x, sg, inf, val, b, index, digits, a, c, scratch.data(),
                    X.data(), Y.data(), Z.data(), &ok, nullptr);
    write_parts(argv[3], {{X.data(), L * 4}, {Y.data(), L * 4},
                          {Z.data(), L * 4}, {&ok, 1}});
  } else if (mode == "fp") {
    const size_t n = (size_t)a;
    auto xs = in.take<fp>(n), ys = in.take<fp>(n);
    if (!ys || in.pos != in.buf.size()) return 2;
    std::vector<fp> prod(n), sq(n);
    for (size_t i = 0; i < n; i++) {
      fp_mul(&prod[i], &xs[i], &ys[i]);
      fp_sqr(&sq[i], &xs[i]);
    }
    write_parts(argv[3], {{prod.data(), n * sizeof(fp)},
                          {sq.data(), n * sizeof(fp)}});
  } else if (mode == "pow") {
    const size_t n = (size_t)a;
    const int chain = b;
    const fp e = chain == 0 ? EXP_SQRT : chain == 3 ? EXP_HALF : EXP_SQRT34;
    if (chain < 2) {
      auto xs = in.take<fp>(n);
      if (!xs || in.pos != in.buf.size()) return 2;
      std::vector<fp> out(n);
      for (size_t i = 0; i < n; i++) pow_window(&out[i], &xs[i], &e, fp_ops());
      write_parts(argv[3], {{out.data(), n * sizeof(fp)}});
    } else {
      auto xs = in.take<fp2>(n);
      if (!xs || in.pos != in.buf.size()) return 2;
      std::vector<fp2> out(n);
      for (size_t i = 0; i < n; i++) pow_window(&out[i], &xs[i], &e, solo());
      write_parts(argv[3], {{out.data(), n * sizeof(fp2)}});
    }
  } else if (mode == "inv") {
    const size_t n = (size_t)a;
    auto xs = in.take<fp>(n);
    if (!xs || in.pos != in.buf.size()) return 2;
    std::vector<fp> out(n);
    for (size_t i = 0; i < n; i++) fp_inv_var(&out[i], &xs[i]);
    write_parts(argv[3], {{out.data(), n * sizeof(fp)}});
  } else {
    return 2;
  }
  std::printf("{\"fp_muls\": %llu, \"fp_sqrs\": %llu, \"int_mads\": %llu}\n",
              (unsigned long long)bls_fp_muls,
              (unsigned long long)bls_fp_sqrs,
              (unsigned long long)bls_int_mads);
  return rc;
}
