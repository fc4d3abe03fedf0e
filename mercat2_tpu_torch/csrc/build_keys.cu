// Key build for the k-mer count path: packed transport words + window
// validity -> masked sort-key columns.
//
// Replaces: the Pallas TPU kernel build_keys_pallas
// (mercat2_tpu/ops/pallas_finalize.py:420-493, body _build_keys_kernel
// :352-417), which unpacks the words, builds a log-tree rolling pack in
// VMEM and masks invalid windows in one pass. That kernel takes bits in
// {1, 2, 4}; for bits in {3, 5, 6} the JAX package computes the same keys
// outside Pallas (unpack_codes + the serial chain of ops/kmer_pack.py +
// build_keyed_words), and for bits in {7, 8} in its uint8 stream path
// (count_kmers_device), and this file replaces those too. The port packs
// every width: 7 and 8 bits ride four symbols a word.
//
// What bounds it on an H100: device-memory bytes. Per window it reads
// bits/8 bytes of packed words (neighbouring windows share them through
// L1/L2) and one validity byte, and writes 4 bytes per key word; at k=21,
// bits=2 that is ~9.25 bytes per window, with no arithmetic worth naming.
//
// What the design does about it: no intermediate touches device memory,
// one thread per window, so consecutive threads write consecutive
// addresses of each output column and every store is coalesced.
//
// - bits in {1, 2, 4, 8} (bits | 32): window i's payload starts at bit
//   i*bits of the big-endian stream and every key word is a run of at most
//   32 bits of it, read straight out of two neighbouring transport words
//   with one 64-bit shift: O(1) work per key word, not the log tree (which
//   existed because the TPU kernel had no unaligned access).
// - bits in {3, 5, 6, 7} (bits does not divide 32): the host packs
//   per = 32 / bits whole symbols into each word and leaves its low
//   32 - per*bits bits zero, so the stream is not contiguous and a key
//   word can straddle symbols and up to three transport words. Key word w
//   covers bits [b0, b0 + len) of the window's k*bits-bit string; the
//   thread shifts the at most ceil(32/bits) + 1 symbols that overlap it
//   into a 64-bit register (<= 42 bits, at 7), then shifts and masks once.
//
// Codes of 128 and above (an 8-bit codec of more than 128 symbols) set
// bit 31 of a word; every word is handled as uint32, so nothing here
// depends on sign.

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

// bits in {3, 5, 6, 7}: symbol g sits in word g / PER at slot g % PER, slot 0
// in the most significant bits. BITS is a template argument so that every
// division and remainder by PER and BITS is by a constant.
template <int BITS>
__global__ void build_keys_split_kernel(const uint32_t* __restrict__ words,
                                        const uint8_t* __restrict__ valid,
                                        uint32_t* __restrict__ out,
                                        long long p, int payload, int kb0,
                                        int tiebreak) {
  constexpr int PER = 32 / BITS;
  constexpr uint32_t SYM_MASK = (1u << BITS) - 1u;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < p;
       i += stride) {
    const bool ok = valid[i] != 0;
    const long long q0 = i / PER;  // window i's first symbol: word, slot
    const int r0 = (int)(i - q0 * PER);
    int b0 = 0;  // first bit of this key word in the window's string
    for (int w = 0; w < payload; ++w) {
      const int len = (w == 0) ? kb0 : 32;
      uint32_t v = 0xFFFFFFFFu;
      if (ok) {
        const int s_first = b0 / BITS;
        const int s_last = (b0 + len - 1) / BITS;
        long long q = q0 + (r0 + s_first) / PER;
        int r = (r0 + s_first) % PER;
        uint32_t cur = words[q];
        uint64_t acc = 0;
        for (int s = s_first; s <= s_last; ++s) {
          acc = (acc << BITS) | ((cur >> (32 - BITS * (r + 1))) & SYM_MASK);
          if (++r == PER && s < s_last) {
            r = 0;
            cur = words[++q];
          }
        }
        // acc holds string bits [s_first*BITS, (s_last+1)*BITS)
        const int drop = (s_last + 1) * BITS - (b0 + len);
        const uint64_t mask = (len == 32) ? 0xFFFFFFFFull : ((1ull << len) - 1);
        v = (uint32_t)((acc >> drop) & mask);
      }
      out[(long long)w * p + i] = v;
      b0 += len;
    }
    if (tiebreak) out[(long long)payload * p + i] = ok ? 0u : 0xFFFFFFFFu;
  }
}

}  // namespace

// words: uint32[n_words]; valid: uint8[>= p]; out: uint32[payload + tiebreak][p].
// bits in 1..8 (the wrapper refuses others); the caller guarantees
// n_words * (32 / bits) >= p + k - 1.
// Returns cudaGetLastError() after the launch.
extern "C" int m2t_build_keys(const void* words, long long n_words,
                              const void* valid, void* out, long long p,
                              int bits, int payload, int kb0, int tiebreak,
                              void* stream) {
  if (p <= 0) return 0;
  const int threads = 256;
  long long blocks = (p + threads - 1) / threads;
  if (blocks > (1ll << 20)) blocks = 1ll << 20;  // grid-stride beyond this
  const uint32_t* w = (const uint32_t*)words;
  const uint8_t* v = (const uint8_t*)valid;
  uint32_t* o = (uint32_t*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (bits) {
    case 3:
      build_keys_split_kernel<3><<<(unsigned)blocks, threads, 0, st>>>(
          w, v, o, p, payload, kb0, tiebreak);
      break;
    case 5:
      build_keys_split_kernel<5><<<(unsigned)blocks, threads, 0, st>>>(
          w, v, o, p, payload, kb0, tiebreak);
      break;
    case 6:
      build_keys_split_kernel<6><<<(unsigned)blocks, threads, 0, st>>>(
          w, v, o, p, payload, kb0, tiebreak);
      break;
    case 7:
      build_keys_split_kernel<7><<<(unsigned)blocks, threads, 0, st>>>(
          w, v, o, p, payload, kb0, tiebreak);
      break;
    default:  // 1, 2, 4, 8: bits divide 32
      build_keys_kernel<<<(unsigned)blocks, threads, 0, st>>>(
          w, n_words, v, o, p, bits, payload, kb0, tiebreak);
  }
  return (int)cudaGetLastError();
}
