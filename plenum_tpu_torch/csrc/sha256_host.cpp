// sha256.cu's kernels run on the CPU through cuda_host_shim.h, for tests
// without a card:
//
//   g++ -std=c++20 -O1 -pthread -o sha256_host sha256_host.cpp
//   sha256_host levels SPLIT IN OUT
//   sha256_host ragged PREFIX DATA OFFSETS OUT
//   sha256_host ragged_be PREFIX DATA OFFSETS OUT
//   sha256_host append GROUPS SPEC TREE OUT
//   sha256_host compress NBLOCKS WORDS NVALID OUT
//
// levels: IN holds n 32-byte digests; SPLIT the levels of each launch,
// comma-separated (ops/sha256.py::node_level_split); OUT receives the
// levels as the launches of ops/sha256.py::sha256_node_levels_cuda leave
// them, one after another, each launch fed the last level of the one
// before. ragged: DATA holds the raw bytes, OFFSETS B + 1 int64,
// PREFIX -1 or a byte; OUT receives B * 32 digest-state bytes, then the
// 16-byte tail with the error word; ragged_be, B * 32 big-endian digest
// bytes, then the 16 bytes of the error word. append: TREE holds rows of
// 32-byte digests; SPEC is C:R1:P1:N1[:R2:P2:N2...], the first row of the
// first group's child level, then for each parent level of the append its
// first row and its window of new parents (first, count); GROUPS the
// levels of each group, comma-separated (ops/merkle.py::append_groups);
// OUT receives TREE after the launches of sha256_append_groups, as
// ops/sha256.py::sha256_append_groups_cuda makes them. compress: WORDS
// holds [B, NBLOCKS, 16] uint32 words, NVALID [B] int32 block counts; OUT
// receives the [B, 8] uint32 digest state.
#include <cstdio>
#include <cstdlib>
#include <string>
#include <vector>

#include "cuda_host_shim.h"
#include "sha256.cu"

static std::vector<uint8_t> read_file(const char* path) {
  std::vector<uint8_t> out;
  FILE* f = std::fopen(path, "rb");
  if (!f) return out;
  uint8_t buf[4096];
  size_t n;
  while ((n = std::fread(buf, 1, sizeof buf, f)) > 0)
    out.insert(out.end(), buf, buf + n);
  std::fclose(f);
  return out;
}

static int write_file(const char* path, const uint8_t* p, size_t n) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return 2;
  std::fwrite(p, 1, n, f);
  std::fclose(f);
  return 0;
}

static int levels_main(const char* split_arg, const char* in_path,
                       const char* out_path) {
  std::vector<int> split;
  for (const char* p = split_arg; *p;) {
    char* end;
    const long lv = std::strtol(p, &end, 10);
    if (end == p || lv < 1 || lv > NODE_LEVELS) return 2;
    split.push_back((int)lv);
    p = *end == ',' ? end + 1 : end;
  }
  int levels = 0;
  for (int lv : split) levels += lv;
  std::vector<uint8_t> digests = read_file(in_path);
  const int64_t n = (int64_t)digests.size() / 32;
  if (levels < 1 || (int64_t)digests.size() != 32 * n) return 2;
  int64_t rows = 0;
  for (int k = 1; k <= levels; ++k) rows += n >> k;
  // heap copies of exactly the buffers' sizes, so that a sanitizer sees any
  // access past them
  uint8_t* in = new uint8_t[32 * n + 1];
  std::memcpy(in, digests.data(), 32 * n);
  uint8_t* out = new uint8_t[32 * rows + 1];
  const uint8_t* src = in;
  uint8_t* dst = out;
  int64_t n_in = n;
  for (int lv : split) {
    if (n_in < 2) break;
    host_launch(node_levels_grid(n_in), NODE_THREADS,
                sha256_node_levels_kernel, src, n_in, dst, lv);
    for (int k = 1; k < lv; ++k) dst += 32 * (n_in >> k);
    src = dst;                      // the launch's last level feeds the next
    n_in >>= lv;
    dst += 32 * n_in;
  }
  const int rc = write_file(out_path, out, 32 * rows);
  delete[] in;
  delete[] out;
  return rc;
}

static int ragged_main(int prefix, const char* data_path,
                       const char* offsets_path, const char* out_path,
                       int big_endian) {
  std::vector<uint8_t> data = read_file(data_path);
  std::vector<uint8_t> off_bytes = read_file(offsets_path);
  std::vector<int64_t> offsets(off_bytes.size() / 8);
  std::memcpy(offsets.data(), off_bytes.data(), off_bytes.size());
  const int B = (int)offsets.size() - 1;
  if (B < 1 || prefix < -1 || prefix > 255) return 2;
  std::vector<uint4> out(2 * (size_t)B + 1, uint4{~0u, ~0u, ~0u, ~0u});
  uint32_t* err = (uint32_t*)&out[2 * (size_t)B];
  std::memset(err, 0, 16);
  uint8_t* d = new uint8_t[data.size() + (data.empty() ? 1 : 0)];
  std::memcpy(d, data.data(), data.size());
  host_launch((B + RAGGED_THREADS - 1) / RAGGED_THREADS, RAGGED_THREADS,
              sha256_ragged_kernel, (const uint8_t*)d, (int64_t)data.size(),
              (const int64_t*)offsets.data(), prefix, out.data(), err, B,
              big_endian);
  delete[] d;
  return write_file(out_path, (const uint8_t*)out.data(),
                    32 * (size_t)B + 16);
}

static bool parse_list(const char* arg, char sep, std::vector<int64_t>* v) {
  for (const char* p = arg; *p;) {
    char* end;
    v->push_back(std::strtoll(p, &end, 10));
    if (end == p) return false;
    p = *end == sep ? end + 1 : end;
  }
  return true;
}

static int append_main(const char* groups_arg, const char* spec,
                       const char* tree_path, const char* out_path) {
  std::vector<int64_t> g, v;
  if (!parse_list(groups_arg, ',', &g) || !parse_list(spec, ':', &v))
    return 2;
  const int levels = (int)(v.size() - 1) / 3;
  std::vector<int> group_levels(g.begin(), g.end());
  int64_t total = 0;
  for (int64_t k : g) total += k;
  if (levels < 1 || v.size() != (size_t)(1 + 3 * levels) || total != levels)
    return 2;
  std::vector<uint8_t> tree = read_file(tree_path);
  uint8_t* buf = new uint8_t[tree.size() + 1];
  std::memcpy(buf, tree.data(), tree.size());
  std::vector<uint8_t*> level(1 + levels);
  std::vector<int64_t> p0s(levels), cnts(levels);
  level[0] = buf + 32 * v[0];
  for (int j = 0; j < levels; ++j) {
    level[1 + j] = buf + 32 * v[1 + 3 * j];
    p0s[j] = v[2 + 3 * j];
    cnts[j] = v[3 + 3 * j];
  }
  int launches = 0;
  const int e = append_groups_each(
      level.data(), p0s.data(), cnts.data(), group_levels.data(),
      (int)group_levels.size(),
      [](int grid, const AppendWindows& a) {
        host_launch(grid, NODE_THREADS, sha256_append_levels_kernel, a);
        return 0;
      },
      &launches);
  const int rc = e ? 2 : write_file(out_path, buf, tree.size());
  delete[] buf;
  return rc;
}

static int compress_main(int nblocks, const char* words_path,
                         const char* nvalid_path, const char* out_path) {
  std::vector<uint8_t> words = read_file(words_path);
  std::vector<uint8_t> nvalid = read_file(nvalid_path);
  const int B = (int)(nvalid.size() / 4);
  if (nblocks < 1 || B < 1 || words.size() != 64 * (size_t)B * nblocks)
    return 2;
  uint4* w = new uint4[words.size() / 16];
  std::memcpy(w, words.data(), words.size());
  int32_t* nv = new int32_t[B];
  std::memcpy(nv, nvalid.data(), nvalid.size());
  uint4* out = new uint4[2 * (size_t)B];
  host_launch(compress_grid(B), COMPRESS_THREADS,
              sha256_compress_kernel<ADDS_ALL>, (const uint4*)w,
              (const int32_t*)nv, out, B, nblocks);
  const int rc = write_file(out_path, (const uint8_t*)out, 32 * (size_t)B);
  delete[] w;
  delete[] nv;
  delete[] out;
  return rc;
}

int main(int argc, char** argv) {
  const std::string mode = argc > 1 ? argv[1] : "";
  if (mode == "levels" && argc == 5)
    return levels_main(argv[2], argv[3], argv[4]);
  if ((mode == "ragged" || mode == "ragged_be") && argc == 6)
    return ragged_main(std::atoi(argv[2]), argv[3], argv[4], argv[5],
                       mode == "ragged_be");
  if (mode == "append" && argc == 6)
    return append_main(argv[2], argv[3], argv[4], argv[5]);
  if (mode == "compress" && argc == 6)
    return compress_main(std::atoi(argv[2]), argv[3], argv[4], argv[5]);
  std::fprintf(stderr,
               "usage: %s levels SPLIT IN OUT\n"
               "       %s ragged|ragged_be PREFIX DATA OFFSETS OUT\n"
               "       %s append GROUPS SPEC TREE OUT\n"
               "       %s compress NBLOCKS WORDS NVALID OUT\n",
               argv[0], argv[0], argv[0], argv[0]);
  return 2;
}
