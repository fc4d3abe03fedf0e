// Finalize for the k-mer count path: sorted key rows -> the runs that
// occur at least min_count times, compacted in sorted order, with counts.
//
// Replaces: the Pallas TPU kernel finalize_sorted_pallas
// (mercat2_tpu/ops/pallas_finalize.py:251-344, body _finalize_kernel
// :147-248), and the XLA finalizes of the uniform path
// (_finalize_sorted_u64 and _finalize_sorted, mercat2_tpu/ops/finalize.py).
// The TPU kernel walked its tiles in order on one core, carried the open
// run across tiles and could emit at most 128 survivors per tile (a denser
// tile forced an overflow retry through XLA). Here the blocks run in no
// order, so nothing is carried: every row decides for itself.
//
// Semantics (both input forms): rows i < n_valid take part; row i starts
// a run if i == 0 or key[i] != key[i-1]; a run starting at i survives iff
// i + m - 1 < n_valid and key[i + m - 1] == key[i] (sorted keys: equal
// endpoints mean an equal span), m = max(min_count, 1). Its count is
// end - i + 1, end the last valid row equal to key[i], found by a
// galloping then binary search on equality: O(log run), so a poly-A run
// thousands of rows long costs a dozen probes, not a forward scan.
//
// What bounds it on an H100: device-memory bytes. The key column is read
// once (8 bytes a row for fused keys, 4n for n word columns); survivors
// are few and their writes small, and every output row is written once
// as a filler before the survivors overwrite theirs.
//
// What the design does about it: one pass over the keys, in one launch
// with a decoupled look-back (a scan chained across tiles), after a small
// init grid.
// - The init grid writes every output row as a filler (the key of row
//   p - 1, count 0, as the plain twin has rows [n_out, rows)) and zeroes
//   the look-back's status words and ticket, so that nothing waits for
//   n_out.
// - Each block takes a ticket (an atomic counter, so that every tile it
//   waits on is held by a block that is running) and stages that tile of
//   256 * items rows, one row before it and kHalo rows after it in shared
//   memory: one 1-D TMA bulk copy a column (cp.async.bulk, completing on
//   an mbarrier), so the whole stage is in flight at once and no thread
//   spends instructions on addresses. Only rows below n_valid are read.
// - The survive test compares staged rows (a probe i + m - 1 beyond the
//   halo, m - 1 > kHalo, reads device memory). Each warp's ballot of its
//   32 rows goes into a mask word; one block scan over the <= 128 mask
//   counts (warp shuffles, three barriers a tile, none a row) ranks them.
// - Warp 0 publishes the tile's survivor count, looks back over the tiles
//   before it 32 at a time (a count, or an inclusive prefix where a tile
//   has one) and publishes the tile's inclusive prefix; the last tile
//   writes n_out.
// - The tile's survivors are then spread over all threads (thread t takes
//   survivors t, t + 256, ...): each finds its row from the masks, gallops
//   to its run end in the stage (device memory only for a run that leaves
//   it) and writes its key and count at offset + rank when that is below
//   rows (the cap).
// There is no per-tile emission cap: n_out is exact and the caller
// retries with a larger cap only when n_out > cap. Tried on the H100 and
// slower: persistent blocks that stage their next tile during the
// look-back (fewer blocks fit an SM), and 512- or 1024-thread blocks.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxItems = 16;
constexpr int kMaxMasks = kMaxItems * kWarps;  // mask words a tile
constexpr int kHalo = 64;                      // rows staged after the tile
constexpr int kStageBudget = 48 * 1024;  // shared memory of a tile's stage
constexpr unsigned long long kFlagA = 1ull << 62;  // survivor count of the tile
constexpr unsigned long long kFlagP = 2ull << 62;  // inclusive prefix
constexpr unsigned long long kValue = 0xFFFFFFFFull;

// n sorted key columns of element type E (n = 1, E = int64 for fused keys;
// E = int32 for word columns), column c at keys + c * ld.
template <class E>
struct Keys {
  const E* keys;
  long long ld;
  int n;
  E* out;  // column c at out + c * rows
  long long rows;
};

template <class E>
__host__ __device__ constexpr int vec_rows() { return 16 / (int)sizeof(E); }

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Wait until the mbarrier at mbar completes the phase of the given parity.
__device__ __forceinline__ void mbar_wait(unsigned long long* mbar, unsigned phase) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(mbar)), "r"(phase) : "memory");
}

// The staged rows of a tile; NC columns (0: n, known at run time only).
template <class E, int NC>
struct Stage {
  const E* sh;     // column c at sh + c * cap_rows, row lo at index 0
  long long lo;    // first row of the stage's index space
  long long st_lo, st_hi;  // rows actually staged: [st_lo, st_hi)
  int cap_rows;
  const E* keys;   // the columns in device memory, for rows off the stage
  long long ld;
  int n;
  __device__ __forceinline__ int cols() const { return NC ? NC : n; }
  __device__ __forceinline__ E get(int c, long long row) const {
    if (row >= st_lo && row < st_hi) return sh[c * cap_rows + (int)(row - lo)];
    return keys[c * ld + row];
  }
  __device__ __forceinline__ bool eq(long long a, long long b) const {
    for (int c = 0; c < cols(); ++c)
      if (get(c, a) != get(c, b)) return false;
    return true;
  }
  // rows lo + a and lo + b, both known to be staged
  __device__ __forceinline__ bool eq_staged(int a, int b) const {
    for (int c = 0; c < cols(); ++c)
      if (sh[c * cap_rows + a] != sh[c * cap_rows + b]) return false;
    return true;
  }
};

// Stage the rows [lo, lo + cap_rows) of the tile at base that lie in
// [0, nv) into sh: the whole 16-byte chunks by one 1-D TMA bulk copy a
// column (thread 0 issues them; they complete on the mbarrier at mbar),
// the ragged ends, fewer than 16 bytes at each, by plain loads. Returns
// the stage's bookkeeping.
template <class E, int NC>
__device__ __forceinline__ Stage<E, NC> stage_tile(const Keys<E>& K, E* sh,
                                                   long long base, long long nv,
                                                   int cap_rows, unsigned long long* mbar) {
  constexpr int A = vec_rows<E>();
  const long long lo = base - A;
  Stage<E, NC> S{sh, lo, lo < 0 ? 0 : lo, 0, cap_rows, K.keys, K.ld, K.n};
  S.st_hi = lo + cap_rows < nv ? lo + cap_rows : nv;
  if (S.st_hi < S.st_lo) S.st_hi = S.st_lo;
  const long long a_lo = (S.st_lo + A - 1) / A * A;  // st_lo >= 0
  long long a_hi = S.st_hi / A * A;
  if (a_hi < a_lo) a_hi = a_lo;
  const unsigned bytes = (unsigned)((a_hi - a_lo) * (long long)sizeof(E));
  const int cols = S.cols();
  if (threadIdx.x == 0) {
    const unsigned mb = smem_u32(mbar);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(mb), "r"(bytes * cols) : "memory");
    for (int c = 0; bytes && c < cols; ++c)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];\n"
          ::"r"(smem_u32(sh + c * cap_rows + (a_lo - lo))), "l"(K.keys + c * K.ld + a_lo),
            "r"(bytes), "r"(mb) : "memory");
  }
  for (int q = threadIdx.x; q < cols * 2 * A; q += kThreads) {
    const int c = q / (2 * A);
    const int e = q - c * 2 * A;  // < A: the head [st_lo, a_lo), else the tail
    const long long row = e < A ? S.st_lo + e : a_hi + (e - A);
    if (e < A ? (row < a_lo && row < S.st_hi) : row < S.st_hi)
      sh[c * cap_rows + (int)(row - lo)] = K.keys[c * K.ld + row];
  }
  return S;
}

// One tile a block; the tile is the block's ticket, so that every tile
// it waits on in the look-back is held by a block that is running.
template <class E, int NC>
__global__ void __launch_bounds__(kThreads)
finalize_kernel(const Keys<E> K, long long p, const long long* nvp, int m,
                int items, unsigned long long* status, int n_tiles,
                int* n_out, int* counts) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ unsigned int masks[kMaxMasks];
  __shared__ unsigned int prefix[kMaxMasks];
  __shared__ unsigned int wsum[4];
  __shared__ unsigned int s_excl;
  __shared__ int s_tile;
  __shared__ __align__(8) unsigned long long mbar;

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int tile_rows = kThreads * items;
  constexpr int A = vec_rows<E>();
  const int cap_rows = tile_rows + A + kHalo;
  const int n_cols = NC ? NC : K.n;
  const long long nv0 = *nvp;
  const long long nv = nv0 < 0 ? 0 : (nv0 > p ? p : nv0);
  const int n_masks = items * kWarps;
  const bool in_halo = m - 1 <= kHalo;

  if (t == 0) {
    s_tile = (int)atomicAdd(&status[n_tiles], 1ull);
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(&mbar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int tile = s_tile;
  const long long base = (long long)tile * tile_rows;
  const Stage<E, NC> S =
      stage_tile<E, NC>(K, reinterpret_cast<E*>(smem_raw), base, nv, cap_rows, &mbar);
  mbar_wait(&mbar, 0);
  __syncthreads();

  // survive flags: row base + j * 256 + t, one ballot word per warp and
  // item. Rows i - 1 and i + m - 1 < nv are staged when m - 1 <= kHalo.
  for (int j = 0; j < items; ++j) {
    const int li = j * kThreads + t + A;  // stage index of row i
    const long long i = S.lo + li;
    bool f = false;
    if (i < nv) {
      const long long e = i + m - 1;
      if (in_halo)
        f = (i == 0 || !S.eq_staged(li, li - 1)) && e < nv && S.eq_staged(li, li + m - 1);
      else
        f = (i == 0 || !S.eq(i, i - 1)) && e < nv && S.eq(i, e);
    }
    const unsigned b = __ballot_sync(0xffffffffu, f);
    if (lane == 0) masks[j * kWarps + warp] = b;
  }
  __syncthreads();

  // exclusive scan of the mask counts (<= 128: warps 0-3)
  unsigned int incl = 0, mine = 0;
  if (t < 128) {
    mine = (t < n_masks) ? __popc(masks[t]) : 0u;
    incl = mine;
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) wsum[warp] = incl;
  }
  __syncthreads();
  if (t < 128) {
    unsigned int before = 0;
    for (int q = 0; q < warp; ++q) before += wsum[q];
    prefix[t] = before + incl - mine;
  }
  const unsigned int agg = wsum[0] + wsum[1] + wsum[2] + wsum[3];

  // decoupled look-back: warp 0
  if (warp == 0) {
    unsigned int excl = 0;
    if (tile == 0) {
      if (lane == 0) atomicExch(&status[0], kFlagP | agg);
    } else {
      if (lane == 0) atomicExch(&status[tile], kFlagA | agg);
      long long j = tile - 1;  // lane l reads tile j - l
      while (true) {
        unsigned long long w;
        unsigned int pmask, need;
        do {
          const long long jt = j - lane;
          w = kFlagP;  // tiles before 0: an inclusive prefix of 0
          if (jt >= 0) w = *(volatile unsigned long long*)&status[jt];
          pmask = __ballot_sync(0xffffffffu, (w >> 62) == 2);
          need = pmask ? (pmask ^ (pmask - 1)) : 0xffffffffu;  // lanes <= first P
        } while (__ballot_sync(0xffffffffu, (w >> 62) == 0) & need);
        const unsigned v = (need >> lane) & 1u ? (unsigned)(w & kValue) : 0u;
        excl += __reduce_add_sync(0xffffffffu, v);
        if (pmask) break;
        j -= 32;
      }
      if (lane == 0)
        atomicExch(&status[tile], kFlagP | (unsigned long long)(excl + agg));
    }
    if (lane == 0) {
      s_excl = excl;
      if (tile == n_tiles - 1) *n_out = (int)(excl + agg);
    }
  }
  __syncthreads();

  // survivors: thread t takes the tile's survivors t, t + 256, ...; the
  // q-th is bit q - prefix[w] of the last mask word w with prefix[w] <= q
  const unsigned int tile_excl = s_excl;
  for (unsigned int q = t; q < agg; q += kThreads) {
    const long long r = (long long)tile_excl + q;
    if (r >= K.rows) break;
    int w = 0, w_hi = n_masks;
    while (w_hi - w > 1) {
      const int mid = (w + w_hi) >> 1;
      if (prefix[mid] <= q) w = mid; else w_hi = mid;
    }
    unsigned int b = masks[w];
    for (unsigned int skip = q - prefix[w]; skip; --skip) b &= b - 1;
    const long long i = base + (w / kWarps) * kThreads + (w % kWarps) * 32 + (__ffs(b) - 1);
    // gallop, then bisect, for the last valid row equal to row i
    long long lo_ = i + m - 1;  // known equal
    long long hi = nv;          // first row known unequal (or the end)
    long long step = 1;
    while (lo_ + step < nv && S.eq(i, lo_ + step)) {
      lo_ += step;
      step <<= 1;
    }
    if (lo_ + step < hi) hi = lo_ + step;
    while (hi - lo_ > 1) {
      const long long mid = lo_ + (hi - lo_) / 2;
      if (S.eq(i, mid)) lo_ = mid; else hi = mid;
    }
    for (int c = 0; c < n_cols; ++c) K.out[c * K.rows + r] = S.get(c, i);
    counts[r] = (int)(lo_ - i + 1);
  }
}

// Before the finalize: every output row a filler (the key of row p - 1,
// count 0), which the survivors then overwrite, and the look-back's status
// words and ticket zeroed.
template <class E>
__global__ void init_kernel(const Keys<E> K, long long p,
                            unsigned long long* status, long long status_len,
                            int* counts) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long r = first; r < K.rows; r += stride) {
    for (int c = 0; c < K.n; ++c) K.out[c * K.rows + r] = K.keys[c * K.ld + p - 1];
    counts[r] = 0;
  }
  for (long long r = first; r < status_len; r += stride) status[r] = 0;
}

template <class E>
int items_for(int n) {
  // the largest power of two <= kMaxItems whose stage fits the budget
  int items = kMaxItems;
  while (items > 1 &&
         (long long)n * (kThreads * items + vec_rows<E>() + kHalo) * (long long)sizeof(E) >
             kStageBudget)
    items >>= 1;
  return items;
}

template <class E, int NC>
int launch(const Keys<E>& K, long long p, const long long* nvp, int m,
           unsigned long long* status, long long status_len, int* n_out,
           int* counts, cudaStream_t stream) {
  const int items = items_for<E>(K.n);
  const int tile_rows = kThreads * items;
  const long long n_tiles = (p + tile_rows - 1) / tile_rows;
  if (status_len < n_tiles + 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)K.n * (tile_rows + vec_rows<E>() + kHalo) * sizeof(E);
  cudaError_t err = cudaFuncSetAttribute(
      finalize_kernel<E, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long init_rows = K.rows > n_tiles + 1 ? K.rows : n_tiles + 1;
  const long long blocks = (init_rows + kThreads * 4 - 1) / (kThreads * 4);
  init_kernel<E><<<(unsigned)blocks, kThreads, 0, stream>>>(K, p, status, n_tiles + 1,
                                                          counts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  finalize_kernel<E, NC><<<(unsigned)n_tiles, kThreads, smem, stream>>>(
      K, p, nvp, m, items, status, (int)n_tiles, n_out, counts);
  return (int)cudaGetLastError();
}

}  // namespace

// Rows of the tile a launch of n key columns of the given element size
// takes (the wrapper sizes the status array with it).
extern "C" int m2t_finalize_tile_rows(int u64, int n_words) {
  return kThreads * (u64 ? items_for<long long>(1) : items_for<int>(n_words));
}

// u64 != 0: keys is int64[p] and out_keys int64[rows]; else keys is
// int32[n_words] columns of stride ld (16-byte aligned, ld a multiple of
// 4) and out_keys int32[n_words][rows]. n_valid is one int64 on the
// device. status holds >= ceil(p / tile rows) + 1 uint64 (tile rows from
// m2t_finalize_tile_rows) of scratch, which the launch zeroes first.
// Returns cudaGetLastError() after the launches.
extern "C" int m2t_finalize(int u64, const void* keys, int n_words, long long ld,
                            long long p, const void* n_valid, int min_count,
                            long long rows, void* status, long long status_len,
                            void* n_out, void* out_keys, void* out_counts,
                            void* stream) {
  if (p <= 0) return 0;
  if (n_words < 1 || rows < 1 || (!u64 && (ld & 3))) return (int)cudaErrorInvalidValue;
  const int m = min_count < 1 ? 1 : min_count;
  cudaStream_t s = (cudaStream_t)stream;
  const long long* nvp = (const long long*)n_valid;
  unsigned long long* st = (unsigned long long*)status;
  if (u64) {
    Keys<long long> K{(const long long*)keys, p, 1, (long long*)out_keys, rows};
    return launch<long long, 1>(K, p, nvp, m, st, status_len, (int*)n_out,
                                (int*)out_counts, s);
  }
  Keys<int> K{(const int*)keys, ld, n_words, (int*)out_keys, rows};
  return launch<int, 0>(K, p, nvp, m, st, status_len, (int*)n_out, (int*)out_counts, s);
}
