// slicefold: sequential left fold over m slice planes, one op per step.
//
// Replaces the TPU kernel slicefold_kernel (src/repro/kernels/slicefold.py).
// r = ((x[0] op[0] x[1]) op[1] x[2]) ... : the bit-sliced comparison circuit,
// whose order carries meaning, so each thread folds all m planes in order.
// The m - 1 step ops (0 and, 1 or, 2 xor) are a small int8 device array
// read by every thread in lockstep.
//
// One thread per 4 words, 16-byte accesses where alignment allows.
// Bound on the H100: bytes, 4 B a word per plane read plus 4 B a word
// written, at 3.35 TB/s.
#include "common.cuh"

template <int V>
__global__ void __launch_bounds__(256)
slicefold_kernel(long long n_vec, const uint32_t* __restrict__ x, int m,
                 long long plane_words, const int8_t* __restrict__ ops,
                 uint32_t* __restrict__ r) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n_vec; i += stride) {
    uint32_t acc[V], p[V];
    load_words<V>(x, i, acc);
#pragma unroll 1
    for (int s = 1; s < m; ++s) {
      load_words<V>(x + static_cast<long long>(s) * plane_words, i, p);
      const int op = ops[s - 1];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = apply_op(op, acc[v], p[v]);
    }
    store_words<V>(r, i, acc);
  }
}

REPRO_EXPORT int launch_slicefold(int device, const void* x, int m,
                                  long long n, const void* ops, void* r,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = n % 4 == 0 && aligned16(x) && aligned16(r);
  REPRO_LAUNCH_VEC(slicefold_kernel, vec, n,
                   static_cast<cudaStream_t>(stream),
                   static_cast<const uint32_t*>(x), m, n,
                   static_cast<const int8_t*>(ops),
                   static_cast<uint32_t*>(r));
  return static_cast<int>(cudaGetLastError());
}
