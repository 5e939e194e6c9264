// ewah_encode: the canonical EWAH stream of each row of a (B, n) batch of
// words and their classes, for any n.
//
// Not a port of a TPU kernel: the reference compresses with jnp scans and
// scatters (src/repro/core/ewah_jax.py compress), one marker a (clean,
// dirty) group, so at most MAX_DIRTY words a row, and on the host
// (core/ewah.py compress) past that.  This kernel writes what
// ewah.compress writes at every row length: a clean run split at
// MAX_CLEAN, a dirty run at MAX_DIRTY.
//
// A word's part of the stream depends on its class c, its offset r in its
// run, the run's length L and, for a clean run, the length nd of the dirty
// run right after it.  A clean word writes one marker where r % MAX_CLEAN
// == 0; a dirty word writes itself, after a marker where r % MAX_DIRTY ==
// 0 and either r > 0 or the run opens the row.  So where each word goes
// depends on c and r alone (an exclusive scan of those counts), and only
// the markers' values wait for L and nd: the thread that holds a run's
// last word writes them.  The last word of a dirty run also writes the
// last marker of the clean run before it, which carries the dirty count.
//
// Two launches over tiles of TILE words, one block a (tile, row):
//   tiles  each tile reduces its run starts to a Runs summary (first and
//          last run start, the start before the last, the last run's
//          class, the stream words of the runs between first and last);
//   write  each tile reduces the summaries of the tiles before it, which
//          gives the run open at its first word and that run's output
//          offset, then scans its own threads' summaries the same way and
//          walks its words: dirty words to their offsets, markers of the
//          runs that end in it.
// The combine of two summaries needs no more than their run starts: the
// words between a's last start and b's first all belong to one run, whose
// stream words follow from its start, class and length in closed form.
// No block waits on another, and the only scratch is a summary a tile.
// Bound on the H100: bytes, 12 B a word (read the word and its class,
// write the stream) at 3.35 TB/s.
#include "common.cuh"

namespace {

constexpr int kMaxClean = 65535;   // ewah.MAX_CLEAN
constexpr int kMaxDirty = 32767;   // ewah.MAX_DIRTY
constexpr int kThreads = 256;
constexpr int kPerThread = 16;
constexpr int kTile = kThreads * kPerThread;   // kernels/ewah_encode.TILE
constexpr int kWarps = kThreads / 32;
constexpr int kNone = -1;
constexpr int kSentinel = 3;       // the class of a word outside the row

// A stretch of a row, as far as the stream's layout needs: the first and
// last run start in it (kNone if none), the start of the run before the
// last where that lies in the stretch (else kNone), the last run's class,
// and the stream words the runs from the first start to the last write.
struct Runs {
  int f, l, pl, kl, cnt;
};

__device__ __forceinline__ Runs no_runs() {
  return {kNone, kNone, kNone, 0, 0};
}

// Stream words of the first len words of a run that starts at s with
// class k.
__device__ __forceinline__ int run_words(int s, int k, int len) {
  if (len <= 0) return 0;
  if (k < 2) return (len + kMaxClean - 1) / kMaxClean;
  return len + (len + kMaxDirty - 1) / kMaxDirty - (s > 0 ? 1 : 0);
}

// a, then b right after it.
__device__ __forceinline__ Runs combine(const Runs& a, const Runs& b) {
  if (b.f == kNone) return a;
  if (a.f == kNone) return b;
  return {a.f, b.l, b.f != b.l ? b.pl : a.l, b.kl,
          a.cnt + run_words(a.l, a.kl, b.f - a.l) + b.cnt};
}

__device__ __forceinline__ Runs shfl_up(const Runs& v, int d) {
  const unsigned all = 0xFFFFFFFFu;
  return {__shfl_up_sync(all, v.f, d), __shfl_up_sync(all, v.l, d),
          __shfl_up_sync(all, v.pl, d), __shfl_up_sync(all, v.kl, d),
          __shfl_up_sync(all, v.cnt, d)};
}

// Exclusive scan of the threads' summaries in thread order, and their
// whole combine.  Every thread of the block calls it.
__device__ __forceinline__ void block_scan(const Runs& v, Runs& excl,
                                           Runs& total, Runs* warp_total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Runs inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Runs o = shfl_up(inc, d);
    if (lane >= d) inc = combine(o, inc);
  }
  const Runs before = shfl_up(inc, 1);
  if (lane == 31) warp_total[warp] = inc;
  __syncthreads();
  Runs pre = no_runs();
  total = no_runs();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w == warp) pre = total;
    total = combine(total, warp_total[w]);
  }
  excl = lane == 0 ? pre : combine(pre, before);
  __syncthreads();   // warp_total is read before the next scan writes it
}

// Shared-memory index with a word of padding every 32: a thread's 16
// consecutive words sit in distinct banks from its neighbours'.
__host__ __device__ constexpr int pad(int x) { return x + (x >> 5); }

constexpr int kKindSlots = kTile + 2;   // the tile, a word each side

// The tile's classes into sk: slot x holds word base + x - 1, kSentinel
// outside the row.
__device__ __forceinline__ void load_kinds(int* sk, const int* krow,
                                           int base, int n) {
  for (int x = threadIdx.x; x < kKindSlots; x += kThreads) {
    const int i = base + x - 1;
    sk[pad(x)] = i >= 0 && i < n ? __ldg(krow + i) : kSentinel;
  }
}

__device__ __forceinline__ int kind_at(const int* sk, int j) {
  return sk[pad(j + 1)];
}

// The summary of this thread's words of the tile.
__device__ __forceinline__ Runs thread_runs(const int* sk, int base, int n) {
  Runs acc = no_runs();
  const int j0 = threadIdx.x * kPerThread;
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const int j = j0 + q;
    const int i = base + j;
    const int k = kind_at(sk, j);
    if (i < n && (i == 0 || k != kind_at(sk, j - 1))) {
      if (acc.f == kNone) {
        acc = {i, i, kNone, k, 0};
      } else {
        acc.cnt += run_words(acc.l, acc.kl, i - acc.l);
        acc.pl = acc.l;
        acc.l = i;
        acc.kl = k;
      }
    }
  }
  return acc;
}

__device__ __forceinline__ uint32_t marker(int c, int n_clean, int n_dirty) {
  return (static_cast<uint32_t>(c) << 31) |
         (static_cast<uint32_t>(n_clean) << 15) |
         static_cast<uint32_t>(n_dirty);
}

__device__ __forceinline__ void put(uint32_t* out, int pos, int capacity,
                                    uint32_t v) {
  if (pos < capacity) out[pos] = v;
}

// The markers of the run [s, e] of class k, whose first stream word is at
// os; ps starts the run before it, next is the class after it.  Returns
// whether the run needs more than one marker's count.
__device__ __forceinline__ bool end_run(uint32_t* out, int capacity,
                                        const int* krow, int s, int e, int k,
                                        int ps, int os, int next) {
  const int len = e - s + 1;
  if (k < 2) {
    const int chunks = (len + kMaxClean - 1) / kMaxClean;
    for (int c = 0; c + 1 < chunks; ++c)
      put(out, os + c, capacity, marker(k, kMaxClean, 0));
    // before a dirty run, the dirty run's last word writes the last marker
    if (next != 2)
      put(out, os + chunks - 1, capacity,
          marker(k, len - (chunks - 1) * kMaxClean, 0));
    return len > kMaxClean;
  }
  const int chunks = (len + kMaxDirty - 1) / kMaxDirty;
  if (s == 0) {
    for (int c = 0; c < chunks; ++c)
      put(out, os + c * (kMaxDirty + 1), capacity,
          marker(0, 0, min(kMaxDirty, len - c * kMaxDirty)));
  } else {
    const int lp = s - ps;   // the clean run before, [ps, s)
    put(out, os - 1, capacity,
        marker(__ldg(krow + s - 1), lp - (lp - 1) / kMaxClean * kMaxClean,
               min(kMaxDirty, len)));
    for (int c = 1; c < chunks; ++c)
      put(out, os + c * kMaxDirty + c - 1, capacity,
          marker(0, 0, min(kMaxDirty, len - c * kMaxDirty)));
  }
  return len > kMaxDirty;
}

__global__ void __launch_bounds__(kThreads)
ewah_encode_kernel_tiles(const int* __restrict__ kind, int n, int n_tiles,
                         Runs* __restrict__ sums, int* __restrict__ overflow) {
  __shared__ int sk[pad(kKindSlots) + 1];
  __shared__ Runs warp_total[kWarps];
  const int b = blockIdx.y;
  const int base = blockIdx.x * kTile;
  load_kinds(sk, kind + static_cast<long long>(b) * n, base, n);
  __syncthreads();
  Runs excl, total;
  block_scan(thread_runs(sk, base, n), excl, total, warp_total);
  if (threadIdx.x == 0) {
    sums[static_cast<long long>(b) * n_tiles + blockIdx.x] = total;
    if (blockIdx.x == 0) overflow[b] = 0;
  }
}

__global__ void __launch_bounds__(kThreads)
ewah_encode_kernel_write(const uint32_t* __restrict__ words,
                         const int* __restrict__ kind, int n, int n_tiles,
                         int capacity, const Runs* __restrict__ sums,
                         uint32_t* __restrict__ streams,
                         int* __restrict__ lengths,
                         int* __restrict__ overflow) {
  __shared__ int sk[pad(kKindSlots) + 1];
  __shared__ uint32_t sw[pad(kTile) + 1];
  __shared__ Runs warp_total[kWarps];
  const int b = blockIdx.y;
  const int tile = blockIdx.x;
  const int base = tile * kTile;
  const long long row = static_cast<long long>(b) * n;
  const int* krow = kind + row;
  load_kinds(sk, krow, base, n);
  for (int x = threadIdx.x; x < kTile; x += kThreads) {
    const int i = base + x;
    sw[pad(x)] = i < n ? __ldg(words + row + i) : 0u;
  }

  // the tiles before this one, in order: the run open at its first word
  const Runs* rs = sums + static_cast<long long>(b) * n_tiles;
  const int per = (tile + kThreads - 1) / kThreads;
  const int t1 = min(tile, (static_cast<int>(threadIdx.x) + 1) * per);
  Runs acc = no_runs();
  for (int t = threadIdx.x * per; t < t1; ++t) acc = combine(acc, rs[t]);
  Runs excl, carry;
  block_scan(acc, excl, carry, warp_total);   // its barrier covers sk, sw
  Runs total;
  block_scan(thread_runs(sk, base, n), excl, total, warp_total);
  const Runs x = combine(carry, excl);

  uint32_t* out = streams + static_cast<long long>(b) * capacity;
  const int j0 = threadIdx.x * kPerThread;
  int s = x.l, k = x.kl, ps = x.pl, os = x.cnt;
  int pos = s == kNone ? 0 : os + run_words(s, k, base + j0 - s);
  bool split = false;
#pragma unroll 1
  for (int j = j0; j < j0 + kPerThread && base + j < n; ++j) {
    const int i = base + j;
    const int ki = kind_at(sk, j);
    if (i == 0 || ki != kind_at(sk, j - 1)) {
      ps = s;
      s = i;
      k = ki;
      os = pos;
    }
    const int r = i - s;
    if (k < 2) {
      pos += r % kMaxClean == 0;
    } else {
      pos += r % kMaxDirty == 0 && (r > 0 || s == 0);
      put(out, pos, capacity, sw[pad(j)]);
      ++pos;
    }
    const int next = kind_at(sk, j + 1);
    if (next != k)
      split |= end_run(out, capacity, krow, s, i, k, ps, os, next);
    if (i == n - 1) lengths[b] = pos;
  }
  if (split) overflow[b] = 1;
}

}  // namespace

REPRO_EXPORT int launch_ewah_encode(int device, const void* words,
                                    const void* kind, int B, int n,
                                    int capacity, void* streams,
                                    void* lengths, void* overflow,
                                    void* sums, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (n + kTile - 1) / kTile;
  const dim3 grid(n_tiles, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ewah_encode_kernel_tiles<<<grid, kThreads, 0, s>>>(
      static_cast<const int*>(kind), n, n_tiles, static_cast<Runs*>(sums),
      static_cast<int*>(overflow));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ewah_encode_kernel_write<<<grid, kThreads, 0, s>>>(
      static_cast<const uint32_t*>(words), static_cast<const int*>(kind), n,
      n_tiles, capacity, static_cast<const Runs*>(sums),
      static_cast<uint32_t*>(streams), static_cast<int*>(lengths),
      static_cast<int*>(overflow));
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT int ewah_encode_tile_words() { return kTile; }

REPRO_EXPORT int ewah_encode_summary_words() {
  return static_cast<int>(sizeof(Runs) / sizeof(int));
}
