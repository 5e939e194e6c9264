// rowids: the row ids of a (B, W) batch of answer words, every answer's
// set bits below n_rows in ascending order, the answers back to back in
// one flat int64 output: what np.flatnonzero(ewah.unpack_bits(words[b],
// n_rows)) gives for each b, concatenated.
//
// Not a port of a TPU kernel: it replaces the host's unpack_bits and
// flatnonzero on the row-id entry (core/query.py TorchBackend
// execute_many), which widened every word of every answer on the host.
//
// Two launches over tiles of kTile words, one block a (tile, answer):
//   count  each block takes the popcount of its tile, every bit at or past
//          n_rows masked off (a "not" in the plan sets the padding bits of
//          the last word), and writes it; the block that finishes last
//          (a counter in the scratch, zeroed before the launch) scans all
//          the tiles' counts into each tile's exclusive offset in the flat
//          output and writes each answer's total;
//   write  each block re-reads its tile a round of kThreads words at a
//          time, ranks its words' set bits within the block (__popc, a
//          warp scan with __shfl_up_sync, then the warps' totals), stages
//          the round's row ids in shared memory and stores them to the
//          output at the tile's offset, consecutive threads to consecutive
//          ids, so the stores coalesce.
// The host reads the totals between the two launches to size the output.
// Bound on the H100: bytes, the words read twice and 8 B an id written at
// 3.35 TB/s; the DBGEN cell's largest answer (13.5 M ids of 436,812
// words) is 111.5 MB, about 33 us.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRounds = 4;
constexpr int kTile = kThreads * kRounds;   // kernels/rowids.TILE
constexpr int kWarps = kThreads / 32;
constexpr int kWordBits = 32;

// Word i of a row with its bits at or past n_rows cleared (0 past the
// row).
__device__ __forceinline__ uint32_t masked_word(const uint32_t* row,
                                                long long i, int n_words,
                                                long long n_rows) {
  if (i >= n_words) return 0u;
  const long long left = n_rows - i * kWordBits;
  if (left <= 0) return 0u;
  const uint32_t w = __ldg(row + i);
  return left >= kWordBits ? w : w & ((1u << left) - 1u);
}

// Exclusive scan of v over the block's threads in thread order, and the
// block's total.  Every thread of the block calls it.
template <typename T>
__device__ __forceinline__ T block_scan(T v, T& total, T* warp_total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T o = __shfl_up_sync(0xFFFFFFFFu, inc, d);
    if (lane >= d) inc += o;
  }
  if (lane == 31) warp_total[warp] = inc;
  __syncthreads();
  T pre = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w == warp) pre = total;
    total += warp_total[w];
  }
  __syncthreads();   // warp_total is read before the next scan writes it
  return pre + inc - v;
}

// The last block of the count launch: the tiles' counts, in place, to
// their exclusive offsets across the whole batch, and each answer's
// total.  Reads bypass L1, which may hold nothing another block wrote.
__device__ __forceinline__ void scan_counts(long long* offsets,
                                            long long* totals, int B,
                                            int n_tiles,
                                            long long* warp_total) {
  const long long n = static_cast<long long>(B) * n_tiles;
  const long long per = (n + kThreads - 1) / kThreads;
  const long long lo = min(n, threadIdx.x * per);
  const long long hi = min(n, lo + per);
  long long sum = 0;
  for (long long i = lo; i < hi; ++i) sum += __ldcg(offsets + i);
  long long all;
  long long at = block_scan(sum, all, warp_total);
  for (long long i = lo; i < hi; ++i) {
    const long long c = __ldcg(offsets + i);
    offsets[i] = at;
    at += c;
  }
  __syncthreads();
  for (int b = threadIdx.x; b < B; b += kThreads) {
    const long long start = __ldcg(offsets + static_cast<long long>(b) *
                                                 n_tiles);
    const long long end =
        b + 1 < B ? __ldcg(offsets + static_cast<long long>(b + 1) * n_tiles)
                  : all;
    totals[b] = end - start;
  }
}

__global__ void __launch_bounds__(kThreads)
rowids_kernel_count(const uint32_t* __restrict__ words, int B, int n_words,
                    long long n_rows, int n_tiles, long long* offsets,
                    long long* __restrict__ totals, unsigned int* done) {
  __shared__ int warp_count[kWarps];
  __shared__ long long warp_offset[kWarps];
  __shared__ bool last;
  const int b = blockIdx.y;
  const int tile = blockIdx.x;
  const uint32_t* row = words + static_cast<long long>(b) * n_words;
  const long long first = static_cast<long long>(tile) * kTile + threadIdx.x;
  int c = 0;
#pragma unroll
  for (int r = 0; r < kRounds; ++r)
    c += __popc(masked_word(row, first + r * kThreads, n_words, n_rows));
  int count;
  block_scan(c, count, warp_count);
  if (threadIdx.x == 0) {
    offsets[static_cast<long long>(b) * n_tiles + tile] = count;
    __threadfence();   // the count is visible before the block is counted
    last = atomicAdd(done, 1u) == gridDim.x * gridDim.y - 1;
  }
  __syncthreads();
  if (last) scan_counts(offsets, totals, B, n_tiles, warp_offset);
}

__global__ void __launch_bounds__(kThreads)
rowids_kernel_write(const uint32_t* __restrict__ words, int n_words,
                    long long n_rows, int n_tiles,
                    const long long* __restrict__ offsets,
                    long long* __restrict__ ids) {
  __shared__ int staged[kThreads * kWordBits];
  __shared__ int warp_total[kWarps];
  const int b = blockIdx.y;
  const int tile = blockIdx.x;
  const uint32_t* row = words + static_cast<long long>(b) * n_words;
  long long at = offsets[static_cast<long long>(b) * n_tiles + tile];
#pragma unroll 1
  for (int r = 0; r < kRounds; ++r) {
    const long long i =
        static_cast<long long>(tile) * kTile + r * kThreads + threadIdx.x;
    uint32_t w = masked_word(row, i, n_words, n_rows);
    int total;
    int pos = block_scan(static_cast<int>(__popc(w)), total, warp_total);
    const int row0 = static_cast<int>(i * kWordBits);
    while (w != 0u) {
      staged[pos++] = row0 + __ffs(w) - 1;
      w &= w - 1u;
    }
    __syncthreads();
    for (int k = threadIdx.x; k < total; k += kThreads)
      ids[at + k] = staged[k];
    at += total;
    __syncthreads();   // staged is read before the next round writes it
  }
}

}  // namespace

REPRO_EXPORT int launch_rowids_count(int device, const void* words, int B,
                                     int n_words, long long n_rows,
                                     void* offsets, void* totals, void* done,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(done, 0, sizeof(unsigned int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (n_words + kTile - 1) / kTile;
  rowids_kernel_count<<<dim3(n_tiles, B), kThreads, 0, s>>>(
      static_cast<const uint32_t*>(words), B, n_words, n_rows, n_tiles,
      static_cast<long long*>(offsets), static_cast<long long*>(totals),
      static_cast<unsigned int*>(done));
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT int launch_rowids_write(int device, const void* words, int B,
                                     int n_words, long long n_rows,
                                     const void* offsets, void* ids,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (n_words + kTile - 1) / kTile;
  rowids_kernel_write<<<dim3(n_tiles, B), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), n_words, n_rows, n_tiles,
      static_cast<const long long*>(offsets), static_cast<long long*>(ids));
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT int rowids_tile_words() { return kTile; }
