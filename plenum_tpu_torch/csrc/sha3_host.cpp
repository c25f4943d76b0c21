// sha3.cu's kernels run on the CPU through cuda_host_shim.h, for tests
// without a card:
//
//   g++ -std=c++20 -O1 -pthread -o sha3_host sha3_host.cpp
//   sha3_host LANES EQ DATA OFFSETS [REFS] OUT
//
// DATA holds the raw bytes, OFFSETS B + 1 int64 and REFS B * 32 bytes (EQ
// 1 only). OUT receives what the card's entry writes: B * 32 digest bytes
// (EQ 0) or B verdict bytes rounded up to 16 (EQ 1), then the 16-byte
// tail with the error word.
#include <cstdio>
#include <vector>

#include "cuda_host_shim.h"
#include "sha3.cu"

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

int main(int argc, char** argv) {
  if (argc < 6) {
    std::fprintf(stderr, "usage: %s LANES EQ DATA OFFSETS [REFS] OUT\n",
                 argv[0]);
    return 2;
  }
  const int lanes = std::atoi(argv[1]);
  const bool eq = std::atoi(argv[2]) != 0;
  if ((lanes != 1 && lanes != 5) || argc != (eq ? 7 : 6)) return 2;
  std::vector<uint8_t> data = read_file(argv[3]);
  std::vector<uint8_t> off_bytes = read_file(argv[4]);
  std::vector<int64_t> offsets(off_bytes.size() / 8);
  std::memcpy(offsets.data(), off_bytes.data(), off_bytes.size());
  const int B = (int)offsets.size() - 1;
  if (B < 1) return 2;
  std::vector<uint64_t> refs(eq ? 4 * (size_t)B : 0);
  if (eq) {
    std::vector<uint8_t> r = read_file(argv[5]);
    if (r.size() != 32 * (size_t)B) return 2;
    std::memcpy(refs.data(), r.data(), r.size());
  }
  const size_t payload = eq ? ((size_t)B + 15) / 16 * 16 : 32 * (size_t)B;
  std::vector<uint64_t> out((payload + 16) / 8, ~0ull);
  uint8_t* o = (uint8_t*)out.data();
  uint32_t* err = (uint32_t*)(o + payload);
  std::memset(err, 0, 16);
  // a heap copy of exactly nbytes, so that a sanitizer sees any load past it
  uint8_t* d = new uint8_t[data.size() + (data.empty() ? 1 : 0)];
  std::memcpy(d, data.data(), data.size());
  const int grid = sha3_grid(lanes, B);
  const int64_t nbytes = (int64_t)data.size();
  const int64_t* off = offsets.data();
  const uint64_t* r = eq ? refs.data() : nullptr;
  auto kernel = lanes == 5 ? (eq ? sha3_kernel<5, true> : sha3_kernel<5, false>)
                           : (eq ? sha3_kernel<1, true> : sha3_kernel<1, false>);
  host_launch(grid, SHA3_THREADS, kernel, (const uint8_t*)d, nbytes, off, r,
              o, err, B);
  delete[] d;
  FILE* f = std::fopen(argv[eq ? 6 : 5], "wb");
  if (!f) return 2;
  std::fwrite(o, 1, payload + 16, f);
  std::fclose(f);
  return 0;
}
