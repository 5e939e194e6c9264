// wordops: r = a op b plus the EWAH class of each result word.
//
// Replaces the TPU kernel wordops_kernel (src/repro/kernels/wordops.py).
// op: 0 = and, 1 = or, 2 = xor, a runtime argument (one compiled kernel).
// The wrapper's tree fold (kernels/ops.py wordops_fold) launches it once
// per tree level, as the reference does.
//
// One thread per 4 words, 16-byte accesses where alignment allows.
// Bound on the H100: bytes, 16 B a word (read a and b, write r and cls) at
// 3.35 TB/s.
#include "common.cuh"

template <int V>
__global__ void __launch_bounds__(256)
wordops_kernel(long long n_vec, const uint32_t* __restrict__ a,
               const uint32_t* __restrict__ b, int op,
               uint32_t* __restrict__ r, int* __restrict__ cls) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n_vec; i += stride) {
    uint32_t x[V], y[V], c[V];
    load_words<V>(a, i, x);
    load_words<V>(b, i, y);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      x[v] = apply_op(op, x[v], y[v]);
      c[v] = static_cast<uint32_t>(word_class(x[v]));
    }
    store_words<V>(r, i, x);
    store_words<V>(cls, i, c);
  }
}

REPRO_EXPORT int launch_wordops(int device, const void* a, const void* b,
                                long long n, int op, void* r, void* cls,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (op < 0 || op > 2) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = n % 4 == 0 && aligned16(a) && aligned16(b) &&
                   aligned16(r) && aligned16(cls);
  REPRO_LAUNCH_VEC(wordops_kernel, vec, n, static_cast<cudaStream_t>(stream),
                   static_cast<const uint32_t*>(a),
                   static_cast<const uint32_t*>(b), op,
                   static_cast<uint32_t*>(r), static_cast<int*>(cls));
  return static_cast<int>(cudaGetLastError());
}
