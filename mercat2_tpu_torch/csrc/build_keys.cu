// Key build for the k-mer count path: packed transport words + window
// validity -> masked sort-key columns.
//
// Replaces: the Pallas TPU kernel build_keys_pallas
// (mercat2_tpu/ops/pallas_finalize.py:420-493, body _build_keys_kernel
// :352-417), which unpacks the words, builds a log-tree rolling pack in
// VMEM and masks invalid windows in one pass.
//
// What bounds it on an H100: device-memory bytes. Per window it reads
// bits/8 bytes of packed words (neighbouring windows share them through
// L1/L2) and one validity byte, and writes 4 bytes per key word; at k=21,
// bits=2 that is ~9.25 bytes per window, with no arithmetic worth naming.
//
// What the design does about it: no intermediate touches device memory.
// Window i's payload starts at bit i*bits of the big-endian stream, and
// for bits in {1, 2, 4} every key word is a run of at most 32 bits of that
// stream, so it is read straight out of two neighbouring transport words
// with one 64-bit shift: O(1) work per key word, not the log tree (which
// existed because the TPU kernel had no unaligned access). One thread per
// window, so consecutive threads write consecutive addresses of each
// output column and every store is coalesced.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void build_keys_kernel(const uint32_t* __restrict__ words,
                                  long long n_words,
                                  const uint8_t* __restrict__ valid,
                                  uint32_t* __restrict__ out, long long p,
                                  int bits, int payload, int kb0,
                                  int tiebreak) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < p;
       i += stride) {
    const bool ok = valid[i] != 0;
    long long bit = i * bits;  // stream bit where this key word starts
    for (int w = 0; w < payload; ++w) {
      const int len = (w == 0) ? kb0 : 32;  // key bits in this word
      uint32_t v = 0xFFFFFFFFu;
      if (ok) {
        const long long q = bit >> 5;
        const int o = (int)(bit & 31);
        const uint64_t hi = words[q];
        const uint64_t lo = (q + 1 < n_words) ? words[q + 1] : 0u;
        const uint64_t x = (hi << 32) | lo;
        const uint64_t mask = (len == 32) ? 0xFFFFFFFFull : ((1ull << len) - 1);
        v = (uint32_t)((x >> (64 - o - len)) & mask);
      }
      out[(long long)w * p + i] = v;
      bit += len;
    }
    if (tiebreak) out[(long long)payload * p + i] = ok ? 0u : 0xFFFFFFFFu;
  }
}

}  // namespace

// words: uint32[n_words]; valid: uint8[>= p]; out: uint32[payload + tiebreak][p].
// Returns cudaGetLastError() after the launch.
extern "C" int m2t_build_keys(const void* words, long long n_words,
                              const void* valid, void* out, long long p,
                              int bits, int payload, int kb0, int tiebreak,
                              void* stream) {
  if (p <= 0) return 0;
  const int threads = 256;
  long long blocks = (p + threads - 1) / threads;
  if (blocks > (1ll << 20)) blocks = 1ll << 20;  // grid-stride beyond this
  build_keys_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, n_words, (const uint8_t*)valid, (uint32_t*)out,
      p, bits, payload, kb0, tiebreak);
  return (int)cudaGetLastError();
}
