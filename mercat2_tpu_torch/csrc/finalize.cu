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
// What bounds it on an H100: device-memory bytes. The count pass and the
// scatter pass each read the key column once (8 bytes a row for fused
// keys; the neighbour and +m-1 probes hit L1/L2), so ~16 bytes a row in
// all; survivors are few and their writes are small.
//
// What the design does about it: three launches and no intermediate per
// row in device memory. (1) a count pass writes one survivor count per
// 4096-row tile; (2) one block scans the tile counts into offsets and
// writes n_out; (3) the scatter pass recomputes the flags, ranks them
// inside the tile with warp ballots, and writes each survivor's key and
// count at offset + rank when that is below rows (the cap); its threads
// also fill rows [n_out, rows) with the last row's key and count 0.
// There is no per-tile emission cap: n_out is exact and the caller
// retries with a larger cap only when n_out > cap.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;  // must match TILE in finalize_kernel.py
constexpr int kWarps = kThreads / 32;

// One sorted int64 column (fused 2-word keys).
struct U64Keys {
  const long long* s;
  long long* out;
  long long rows;
  __device__ __forceinline__ bool eq(long long i, long long j) const {
    return s[i] == s[j];
  }
  __device__ __forceinline__ void put(long long r, long long i) const {
    out[r] = s[i];
  }
};

// n sorted int32 columns, column c at w[c * p].
struct WordKeys {
  const int* w;
  int* out;
  long long rows;
  long long p;
  int n;
  __device__ __forceinline__ bool eq(long long i, long long j) const {
    for (int c = 0; c < n; ++c)
      if (w[c * p + i] != w[c * p + j]) return false;
    return true;
  }
  __device__ __forceinline__ void put(long long r, long long i) const {
    for (int c = 0; c < n; ++c) out[c * rows + r] = w[c * p + i];
  }
};

__device__ __forceinline__ long long clamp_nv(const long long* nvp, long long p) {
  long long nv = *nvp;
  return nv < 0 ? 0 : (nv > p ? p : nv);
}

template <class K>
__device__ __forceinline__ bool survives(const K& key, long long i,
                                         long long nv, int m) {
  if (i >= nv) return false;
  if (i > 0 && key.eq(i, i - 1)) return false;  // not a run start
  const long long j = i + m - 1;
  return j < nv && key.eq(i, j);
}

template <class K>
__global__ void count_kernel(K key, long long p, const long long* nvp, int m,
                             int* block_counts) {
  const long long nv = clamp_nv(nvp, p);
  const long long base = (long long)blockIdx.x * kTile;
  int total = 0;
  for (int it = 0; it < kItems; ++it) {
    const long long i = base + (long long)it * kThreads + threadIdx.x;
    const int f = (i < p) && survives(key, i, nv, m);
    total += __syncthreads_count(f);
  }
  if (threadIdx.x == 0) block_counts[blockIdx.x] = total;
}

// One block: exclusive scan of the tile counts, and the total as n_out.
__global__ void scan_kernel(const int* block_counts, long long n_blocks,
                            int* offsets, int* n_out) {
  __shared__ long long sh[1024];
  const int t = threadIdx.x;
  const long long chunk = (n_blocks + blockDim.x - 1) / blockDim.x;
  const long long b0 = t * chunk;
  const long long b1 = (b0 + chunk < n_blocks) ? b0 + chunk : n_blocks;
  long long local = 0;
  for (long long b = b0; b < b1; ++b) local += block_counts[b];
  sh[t] = local;
  __syncthreads();
  for (int off = 1; off < (int)blockDim.x; off <<= 1) {
    const long long v = (t >= off) ? sh[t - off] : 0;
    __syncthreads();
    sh[t] += v;
    __syncthreads();
  }
  long long run = sh[t] - local;
  for (long long b = b0; b < b1; ++b) {
    offsets[b] = (int)run;
    run += block_counts[b];
  }
  if (t == (int)blockDim.x - 1) *n_out = (int)sh[t];
}

template <class K>
__global__ void scatter_kernel(K key, long long p, const long long* nvp, int m,
                               const int* offsets, const int* n_out,
                               int* counts) {
  __shared__ int warp_tot[kWarps];
  const long long nv = clamp_nv(nvp, p);
  const long long base = (long long)blockIdx.x * kTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  long long rank = offsets[blockIdx.x];
  for (int it = 0; it < kItems; ++it) {
    const long long i = base + (long long)it * kThreads + threadIdx.x;
    const bool f = (i < p) && survives(key, i, nv, m);
    const unsigned ballot = __ballot_sync(0xffffffffu, f);
    if (lane == 0) warp_tot[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
    for (int q = 0; q < kWarps; ++q) {
      if (q < warp) before += warp_tot[q];
      total += warp_tot[q];
    }
    __syncthreads();  // warp_tot is rewritten by the next item
    const long long r = rank + before + __popc(ballot & ((1u << lane) - 1u));
    if (f && r < key.rows) {
      // gallop, then bisect, for the last valid row equal to row i
      long long lo = i + m - 1;  // known equal
      long long hi = nv;         // first row known unequal (or the end)
      long long step = 1;
      while (lo + step < nv && key.eq(i, lo + step)) {
        lo += step;
        step <<= 1;
      }
      if (lo + step < hi) hi = lo + step;
      while (hi - lo > 1) {
        const long long mid = lo + (hi - lo) / 2;
        if (key.eq(i, mid)) lo = mid; else hi = mid;
      }
      key.put(r, i);
      counts[r] = (int)(lo - i + 1);
    }
    rank += total;
  }
  // filler rows after the survivors: the last row's key, count 0
  const long long first = *n_out;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long r = first + (long long)blockIdx.x * kThreads + threadIdx.x;
       r < key.rows; r += stride) {
    key.put(r, p - 1);
    counts[r] = 0;
  }
}

template <class K>
int launch(const K& key, long long p, const long long* nvp, int m,
           int* block_counts, int* offsets, int* n_out, int* counts,
           cudaStream_t stream) {
  const long long n_blocks = (p + kTile - 1) / kTile;
  count_kernel<K><<<(unsigned)n_blocks, kThreads, 0, stream>>>(key, p, nvp, m,
                                                              block_counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_kernel<<<1, 1024, 0, stream>>>(block_counts, n_blocks, offsets, n_out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scatter_kernel<K><<<(unsigned)n_blocks, kThreads, 0, stream>>>(
      key, p, nvp, m, offsets, n_out, counts);
  return (int)cudaGetLastError();
}

}  // namespace

// u64 != 0: keys is int64[p] and out_keys int64[rows]; else keys is
// int32[n_words][p] and out_keys int32[n_words][rows]. n_valid is one int64
// on the device. block_counts and offsets hold ceil(p / 4096) int32 each.
// Returns cudaGetLastError() after the launches.
extern "C" int m2t_finalize(int u64, const void* keys, int n_words,
                            long long p, const void* n_valid, int min_count,
                            long long rows, void* block_counts, void* offsets,
                            void* n_out, void* out_keys, void* out_counts,
                            void* stream) {
  if (p <= 0) return 0;
  const int m = min_count < 1 ? 1 : min_count;
  cudaStream_t s = (cudaStream_t)stream;
  const long long* nvp = (const long long*)n_valid;
  if (u64) {
    U64Keys key{(const long long*)keys, (long long*)out_keys, rows};
    return launch(key, p, nvp, m, (int*)block_counts, (int*)offsets,
                  (int*)n_out, (int*)out_counts, s);
  }
  WordKeys key{(const int*)keys, (int*)out_keys, rows, p, n_words};
  return launch(key, p, nvp, m, (int*)block_counts, (int*)offsets,
                (int*)n_out, (int*)out_counts, s);
}
