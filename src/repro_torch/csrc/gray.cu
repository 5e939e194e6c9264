// gray: binary to Gray code, x ^ (x >> 1), or back, the prefix-xor
// cascade x ^= x >> s for s = 1, 2, 4, 8, 16.
//
// Replaces the TPU kernel gray_kernel (src/repro/kernels/gray.py), which
// runs the same chain on (64, 128) tiles.  The direction is a runtime
// argument (one compiled kernel).  Every shift is logical: the words are
// uint32 here, int32 bit-views on the torch side.
//
// One thread per 4 words, 16-byte accesses where alignment allows.
// Bound on the H100: bytes, 8 B a word (read x, write the result) at
// 3.35 TB/s.
#include "common.cuh"

__device__ __forceinline__ uint32_t gray_word(uint32_t x, int inverse) {
  if (!inverse) return x ^ (x >> 1);
#pragma unroll
  for (int s = 1; s < 32; s *= 2) x ^= x >> s;
  return x;
}

template <int V>
__global__ void __launch_bounds__(256)
gray_kernel(long long n_vec, const uint32_t* __restrict__ x, int inverse,
            uint32_t* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n_vec; i += stride) {
    uint32_t w[V];
    load_words<V>(x, i, w);
#pragma unroll
    for (int v = 0; v < V; ++v) w[v] = gray_word(w[v], inverse);
    store_words<V>(out, i, w);
  }
}

REPRO_EXPORT int launch_gray(int device, const void* x, long long n,
                             int inverse, void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = n % 4 == 0 && aligned16(x) && aligned16(out);
  REPRO_LAUNCH_VEC(gray_kernel, vec, n, static_cast<cudaStream_t>(stream),
                   static_cast<const uint32_t*>(x), inverse != 0 ? 1 : 0,
                   static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
