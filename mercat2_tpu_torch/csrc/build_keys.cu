// Key build for the k-mer count path: packed transport words + window
// validity + file starts -> the sort-key column(s) that torch.sort takes.
//
// Replaces: the Pallas TPU kernel build_keys_pallas
// (mercat2_tpu/ops/pallas_finalize.py:420-493, body _build_keys_kernel
// :352-417), which unpacks the words, builds a log-tree rolling pack in
// VMEM and masks invalid windows in one pass. That kernel takes bits in
// {1, 2, 4}; for bits in {3, 5, 6} the JAX package computes the same keys
// outside Pallas (unpack_codes + the serial chain of ops/kmer_pack.py +
// build_keyed_words), and for bits in {7, 8} in its uint8 stream path
// (count_kmers_device), and this file replaces those too. The port packs
// every width: 7 and 8 bits ride four symbols a word. It also does what the
// JAX package (and this port before the fused key build) ran after the
// key build as whole-column passes: the file-id tag (embedded in word 0, or
// a leading fid word that replaces the tie-break word), the fuse of a
// 2-word key into one int64 with its sign bit flipped (so that signed
// order is unsigned order), and the count of valid windows.
//
// What bounds it on an H100: device-memory bytes. Per window it reads
// bits/8 bytes of packed words and one validity byte, and writes 4 bytes
// per key word (8 for the fused int64); at k=21, bits=2 that is ~9.25 bytes
// per window, with little arithmetic.
//
// What the design does about it: each block takes a tile of 2048
// consecutive windows. It stages the tile's span of transport words (and
// the k-1 symbols after it) once in shared memory with coalesced loads, the
// tile's validity with 16-byte loads, and the launch's file starts. Each
// thread then computes 4 consecutive windows at a time (two groups) and
// stores each output column as one 16-byte vector (two for int64), so
// every store of a warp covers 512 contiguous bytes. Valid windows are
// counted with a warp reduce, one shared-memory add a warp and one global
// atomicAdd a block, into the device scalar n_valid.
//
// - bits in {1, 2, 4, 8} (bits | 32): window i's payload starts at bit
//   i*bits of the big-endian stream and every key word is a run of at most
//   32 bits of it, read out of two neighbouring staged words with one
//   64-bit shift: O(1) work per key word, not the log tree (which existed
//   because the TPU kernel had no unaligned access).
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

constexpr int kThreads = 256;
constexpr int kGroup = 4;   // consecutive windows a thread computes at once
constexpr int kSteps = 2;   // groups a thread takes in a tile
constexpr int kTile = kThreads * kGroup * kSteps;  // windows a block
constexpr int kMaxK = 256;
constexpr int kMaxFiles = kThreads;
// staged words: the tile's symbols and k-1 after them, at >= 4 symbols a
// word, plus the word a straddling key word reads past the last one
constexpr int kSpanWords = (kTile + kMaxK - 1 + 3) / 4 + 2;

struct Params {
  const uint32_t* words;
  long long n_words;
  const uint8_t* valid;
  const int* starts;  // n_files file starts (symbol = window index), sorted
  int n_files;
  void* out;          // int64[p] when fused, else int32 columns of stride ld
  long long ld;
  unsigned long long* n_valid;
  long long p;
  int k;
  int payload;        // key words of the k-mer itself
  int kb0;            // key bits in payload word 0
  int tiebreak;       // mode 0: one more column, 0 valid / ~0 invalid
  int fid_mode;       // 0 none, 1 embedded in word 0, 2 leading fid word
  int fid_shift;      // mode 1: fid << fid_shift OR-ed into word 0
  int n_cols;         // columns written (2 and fused: one int64 column)
  int fused;
};

// upper_bound(starts, i) - 1: the file of window i (torch.searchsorted
// with right=True, minus one)
__device__ __forceinline__ int file_of(const int* s, int n, long long i) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((long long)s[mid] <= i) lo = mid + 1; else hi = mid;
  }
  return lo - 1;
}

// Payload word w of the window whose first symbol is symbol si of the
// staged words sw (symbol 0 in the most significant bits of sw[0]).
template <int BITS>
__device__ __forceinline__ uint32_t payload_word(const uint32_t* sw, int si,
                                                 int w, int kb0) {
  constexpr int PER = 32 / BITS;
  const int len = (w == 0) ? kb0 : 32;
  const int b0 = (w == 0) ? 0 : kb0 + 32 * (w - 1);
  const uint64_t mask = (len == 32) ? 0xFFFFFFFFull : ((1ull << len) - 1);
  if constexpr (32 % BITS == 0) {
    const int bit = si * BITS + b0;
    const int q = bit >> 5;
    const int o = bit & 31;
    const uint64_t x = ((uint64_t)sw[q] << 32) | sw[q + 1];
    return (uint32_t)((x >> (64 - o - len)) & mask);
  } else {
    constexpr uint32_t SYM_MASK = (1u << BITS) - 1u;
    const int s_first = b0 / BITS;
    const int s_last = (b0 + len - 1) / BITS;
    int q = (si + s_first) / PER;
    int r = (si + s_first) % PER;
    uint32_t cur = sw[q];
    uint64_t acc = 0;
    for (int s = s_first; s <= s_last; ++s) {
      acc = (acc << BITS) | ((cur >> (32 - BITS * (r + 1))) & SYM_MASK);
      if (++r == PER && s < s_last) {
        r = 0;
        cur = sw[++q];
      }
    }
    // acc holds string bits [s_first*BITS, (s_last+1)*BITS)
    const int drop = (s_last + 1) * BITS - (b0 + len);
    return (uint32_t)((acc >> drop) & mask);
  }
}

// Output column c of one window, as the plain twin lays the columns out.
template <int BITS>
__device__ __forceinline__ uint32_t column(const Params& P, const uint32_t* sw,
                                           int si, int c, bool ok, int fid) {
  if (P.fid_mode == 2) {
    if (c == 0) return ok ? (uint32_t)fid : 0xFFFFFFFFu;
    return ok ? payload_word<BITS>(sw, si, c - 1, P.kb0) : 0xFFFFFFFFu;
  }
  if (c == P.payload) return ok ? 0u : 0xFFFFFFFFu;  // the tie-break word
  uint32_t v = ok ? payload_word<BITS>(sw, si, c, P.kb0) : 0xFFFFFFFFu;
  if (P.fid_mode == 1 && c == 0) v |= (uint32_t)((long long)fid << P.fid_shift);
  return v;
}

template <int BITS>
__global__ void __launch_bounds__(kThreads)
build_keys_kernel(const Params P) {
  constexpr int PER = 32 / BITS;
  __shared__ uint32_t sw[kSpanWords];
  __shared__ __align__(16) uint8_t sv[kTile];
  __shared__ int s_starts[kMaxFiles];
  __shared__ unsigned int s_count;

  const int t = threadIdx.x;
  const long long base = (long long)blockIdx.x * kTile;
  const long long w_lo = base / PER;
  // symbols of sw[0] before the tile's first (bits | 32: none; else the
  // tile may start inside a word)
  const int off = (int)(base - w_lo * PER);
  const long long w_end = (base + kTile + P.k - 2) / PER + 2;  // exclusive
  const int span = (int)((w_end < P.n_words ? w_end : P.n_words) - w_lo);
  for (int j = t; j < kSpanWords; j += kThreads)
    sw[j] = (j < span) ? P.words[w_lo + j] : 0u;
  // validity, 16 bytes a thread where the chunk lies inside [0, p)
  for (int j = t; j < kTile / 16; j += kThreads) {
    const long long i = base + 16LL * j;
    if (i + 16 <= P.p) {
      reinterpret_cast<uint4*>(sv)[j] =
          reinterpret_cast<const uint4*>(P.valid + base)[j];
    } else {
      for (int b = 0; b < 16; ++b) sv[16 * j + b] = (i + b < P.p) ? P.valid[i + b] : 0;
    }
  }
  if (t < P.n_files) s_starts[t] = P.starts[t];
  if (t == 0) s_count = 0;
  __syncthreads();

  unsigned int n_ok = 0;
#pragma unroll
  for (int step = 0; step < kSteps; ++step) {
    const int li0 = (step * kThreads + t) * kGroup;
    const long long i0 = base + li0;
    if (i0 >= P.p) break;
    bool ok[kGroup];
    int fid[kGroup];
    const uint32_t v4 = *reinterpret_cast<const uint32_t*>(sv + li0);  // 4 flags
    int f = P.fid_mode ? file_of(s_starts, P.n_files, i0) : 0;
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      ok[g] = (i0 + g < P.p) && ((v4 >> (8 * g)) & 0xFFu) != 0;
      n_ok += ok[g];
      // the group's later windows: the file moves on at most past a start
      while (P.fid_mode && f + 1 < P.n_files && (long long)s_starts[f + 1] <= i0 + g) ++f;
      fid[g] = f;
    }
    const bool whole = i0 + kGroup <= P.p;
    if (P.fused) {
      long long v[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const uint64_t hi = column<BITS>(P, sw, off + li0 + g, 0, ok[g], fid[g]);
        const uint64_t lo = column<BITS>(P, sw, off + li0 + g, 1, ok[g], fid[g]);
        v[g] = (long long)(((hi << 32) | lo) ^ 0x8000000000000000ull);
      }
      long long* o = (long long*)P.out + i0;
      if (whole) {
        reinterpret_cast<longlong2*>(o)[0] = make_longlong2(v[0], v[1]);
        reinterpret_cast<longlong2*>(o)[1] = make_longlong2(v[2], v[3]);
      } else {
#pragma unroll
        for (int g = 0; g < kGroup; ++g)
          if (i0 + g < P.p) o[g] = v[g];
      }
    } else {
      for (int c = 0; c < P.n_cols; ++c) {
        uint32_t v[kGroup];
#pragma unroll
        for (int g = 0; g < kGroup; ++g)
          v[g] = column<BITS>(P, sw, off + li0 + g, c, ok[g], fid[g]);
        uint32_t* o = (uint32_t*)P.out + (long long)c * P.ld + i0;
        if (whole) {
          reinterpret_cast<uint4*>(o)[0] = make_uint4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int g = 0; g < kGroup; ++g)
            if (i0 + g < P.p) o[g] = v[g];
        }
      }
    }
  }
  // valid windows: warp reduce, a shared add a warp, a global add a block
  n_ok = __reduce_add_sync(0xffffffffu, n_ok);
  if ((t & 31) == 0) atomicAdd(&s_count, n_ok);
  __syncthreads();
  if (t == 0 && s_count) atomicAdd(P.n_valid, (unsigned long long)s_count);
}

template <int BITS>
void launch(const Params& P, cudaStream_t s) {
  const long long blocks = (P.p + kTile - 1) / kTile;
  build_keys_kernel<BITS><<<(unsigned)blocks, kThreads, 0, s>>>(P);
}

}  // namespace

// words: uint32[n_words]; valid: uint8[>= p], 16-byte aligned; starts:
// int32[n_files] (n_files <= 256; unread when fid_mode is 0); n_valid: one
// uint64 on the device, zeroed by the caller, to which the count of valid
// windows is added. fused != 0: out is int64[p] (n_cols must be 2); else
// out holds n_cols int32 columns of stride ld (a multiple of 4), 16-byte
// aligned. bits in 1..8, 1 <= k <= 256 (the wrapper refuses others); the
// caller guarantees n_words * (32 / bits) >= p + k - 1.
// Returns cudaGetLastError() after the launch.
extern "C" int m2t_build_keys(const void* words, long long n_words,
                              const void* valid, const void* starts,
                              int n_files, void* out, long long ld,
                              void* n_valid, long long p, int k, int bits,
                              int payload, int kb0, int tiebreak, int fid_mode,
                              int fid_shift, int n_cols, int fused,
                              void* stream) {
  if (p <= 0) return 0;
  if (k < 1 || k > kMaxK || n_files < 0 || n_files > kMaxFiles ||
      (fused && n_cols != 2) || (!fused && (ld & 3)))
    return (int)cudaErrorInvalidValue;
  Params P{(const uint32_t*)words, n_words, (const uint8_t*)valid,
           (const int*)starts, fid_mode ? n_files : 0, out, ld,
           (unsigned long long*)n_valid, p, k, payload, kb0, tiebreak,
           fid_mode, fid_shift, n_cols, fused};
  cudaStream_t s = (cudaStream_t)stream;
  switch (bits) {
    case 1: launch<1>(P, s); break;
    case 2: launch<2>(P, s); break;
    case 3: launch<3>(P, s); break;
    case 4: launch<4>(P, s); break;
    case 5: launch<5>(P, s); break;
    case 6: launch<6>(P, s); break;
    case 7: launch<7>(P, s); break;
    case 8: launch<8>(P, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
