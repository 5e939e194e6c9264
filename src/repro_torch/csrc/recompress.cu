// recompress: per-word EWAH class and run-start flag.
//
// Replaces the TPU kernel recompress_kernel (src/repro/kernels/recompress.py).
// For each word w with predecessor p (the caller shifts each row by one word
// and puts a sentinel of the opposite class before word 0, so runs never
// cross rows): kind = class(w), start = class(w) != class(p).
//
// One thread per 4 words, 16-byte accesses where alignment allows.
// Bound on the H100: bytes, 16 B a word (read w and p, write kind and
// start) at 3.35 TB/s.
#include "common.cuh"

template <int V>
__global__ void __launch_bounds__(256)
recompress_kernel(long long n_vec, const uint32_t* __restrict__ w,
                  const uint32_t* __restrict__ p, int* __restrict__ kind,
                  int* __restrict__ start) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n_vec; i += stride) {
    uint32_t a[V], b[V], k[V], s[V];
    load_words<V>(w, i, a);
    load_words<V>(p, i, b);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int ka = word_class(a[v]);
      k[v] = static_cast<uint32_t>(ka);
      s[v] = ka != word_class(b[v]) ? 1u : 0u;
    }
    store_words<V>(kind, i, k);
    store_words<V>(start, i, s);
  }
}

REPRO_EXPORT int launch_recompress(int device, const void* w, const void* p,
                                   long long n, void* kind, void* start,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = n % 4 == 0 && aligned16(w) && aligned16(p) &&
                   aligned16(kind) && aligned16(start);
  REPRO_LAUNCH_VEC(recompress_kernel, vec, n,
                   static_cast<cudaStream_t>(stream),
                   static_cast<const uint32_t*>(w),
                   static_cast<const uint32_t*>(p), static_cast<int*>(kind),
                   static_cast<int*>(start));
  return static_cast<int>(cudaGetLastError());
}
