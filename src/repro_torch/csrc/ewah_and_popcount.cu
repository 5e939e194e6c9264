// ewah_and_popcount: popcount(A AND B) over a batch of EWAH stream pairs,
// with the number of steps the dual-cursor walk takes.
//
// Not a port of a TPU kernel: it takes over from the reference's in-graph
// walk, a lax.while_loop (src/repro/core/ewah_stream.py and_popcount).
// Each step consumes an overlap of two clean runs, one dirty word against
// a clean word, or two dirty words, then reloads a cursor whose counts
// both reached 0 from its next marker; the walk ends when either stream
// is exhausted, when a marker with no clean and no dirty word is loaded,
// or after (array size of A) + (array size of B) + 4 steps.  Reads clamp
// to a pair's own array size, as the reference clamps to its arrays'.
//
// One thread walks one pair: the walk is serial within a pair and
// branchy, so nothing inside a pair runs in parallel.  A pair's words are
// read in order, so the cache lines a thread touches are reused by its
// next steps.  Bound on the H100: bytes, each stream word read once and
// two int32 written a pair, at 3.35 TB/s; a chain of dependent loads
// keeps a thread far from it, which is the price of the simple design.
#include "common.cuh"

namespace {

struct Cursor {
  int i;  // next word of the stream
  int c;  // clean words left in the current marker's run
  int t;  // the run's type: 1 all ones, 0 all zeros
  int d;  // dirty words left after the clean run
};

__device__ __forceinline__ uint32_t word_at(const uint32_t* s, int i,
                                            int size) {
  return size > 0 ? __ldg(s + min(i, size - 1)) : 0u;
}

__device__ __forceinline__ void load(const uint32_t* s, int len, int size,
                                     Cursor& k) {
  if (k.c == 0 && k.d == 0 && k.i < len) {
    const uint32_t w = word_at(s, k.i, size);
    k.i += 1;
    k.t = static_cast<int>((w >> 31) & 1u);
    k.c = static_cast<int>((w >> 15) & 0xFFFFu);
    k.d = static_cast<int>(w & 0x7FFFu);
  }
}

__global__ void __launch_bounds__(128)
ewah_and_popcount_kernel(int B, const uint32_t* __restrict__ sa, int ca,
                         const int* __restrict__ la,
                         const int* __restrict__ na,
                         const uint32_t* __restrict__ sb, int cb,
                         const int* __restrict__ lb,
                         const int* __restrict__ nb, int* __restrict__ count,
                         int* __restrict__ iters) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= B) return;
  const uint32_t* a = sa + static_cast<long long>(p) * ca;
  const uint32_t* b = sb + static_cast<long long>(p) * cb;
  const int len_a = la[p], len_b = lb[p];
  const int size_a = min(na[p], ca), size_b = min(nb[p], cb);
  const long long cap = static_cast<long long>(size_a) + size_b + 4;
  Cursor x{0, 0, 0, 0}, y{0, 0, 0, 0};
  load(a, len_a, size_a, x);
  load(b, len_b, size_b, y);
  uint32_t acc = 0;  // wraps as the reference's int32 sum does
  int it = 0;
  while ((x.c > 0 || x.d > 0) && (y.c > 0 || y.d > 0) && it < cap) {
    if (x.c > 0 && y.c > 0) {  // two clean runs: take their overlap
      const int n = max(min(x.c, y.c), 1);
      if (x.t & y.t) acc += static_cast<uint32_t>(n) * 32u;
      x.c -= n;
      y.c -= n;
    } else if (x.c > 0) {  // clean A, one dirty word of B
      if (x.t) acc += __popc(word_at(b, y.i, size_b));
      x.c -= 1;
      y.i += 1;
      y.d -= 1;
    } else if (y.c > 0) {  // one dirty word of A, clean B
      if (y.t) acc += __popc(word_at(a, x.i, size_a));
      y.c -= 1;
      x.i += 1;
      x.d -= 1;
    } else {  // two dirty words
      acc += __popc(word_at(a, x.i, size_a) & word_at(b, y.i, size_b));
      x.i += 1;
      x.d -= 1;
      y.i += 1;
      y.d -= 1;
    }
    load(a, len_a, size_a, x);
    load(b, len_b, size_b, y);
    ++it;
  }
  count[p] = static_cast<int>(acc);
  iters[p] = it;
}

}  // namespace

REPRO_EXPORT int launch_ewah_and_popcount(int device, int B, const void* sa,
                                          int ca, const void* la,
                                          const void* na, const void* sb,
                                          int cb, const void* lb,
                                          const void* nb, void* count,
                                          void* iters, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 128;
  ewah_and_popcount_kernel<<<(B + threads - 1) / threads, threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      B, static_cast<const uint32_t*>(sa), ca, static_cast<const int*>(la),
      static_cast<const int*>(na), static_cast<const uint32_t*>(sb), cb,
      static_cast<const int*>(lb), static_cast<const int*>(nb),
      static_cast<int*>(count), static_cast<int*>(iters));
  return static_cast<int>(cudaGetLastError());
}
