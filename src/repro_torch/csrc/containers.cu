// containers: the two kernels of the Roaring container fold.
//
// Replace the TPU kernels containerops_kernel and member_kernel
// (src/repro/kernels/containers.py).  TorchBackend._container_fold batches
// each fold round's same-chunk container pairs into one launch of each.
//
// containerops_kernel: out = a op b over (P, 2048) words of expanded
// container pairs, op 0 = and, 1 = or, 2 = and-not (a & ~b), a runtime
// argument, so one compiled kernel serves all three.  One thread per 4
// words, 16-byte accesses where alignment allows.  Bound on the H100:
// bytes, 12 B a word (read a and b, write out) at 3.35 TB/s.
//
// member_kernel: the array-with-bitmap intersection of an "and" round.
// One thread per position; it gathers the bitmap word that holds the
// position itself (the TPU wrapper gathers with take_along_axis before its
// kernel) and tests the bit: out = bit (pos & 31) of words[p][pos >> 5],
// 0 for padding (-1) and any position outside the row's W words.  Bound on
// the H100: bytes, 8 B a position (read the position, write the flag) plus
// the bitmap rows read once, at 3.35 TB/s.
#include "common.cuh"

__device__ __forceinline__ uint32_t container_op(int op, uint32_t a,
                                                 uint32_t b) {
  return op == 0 ? (a & b) : (op == 1 ? (a | b) : (a & ~b));
}

template <int V>
__global__ void __launch_bounds__(256)
containerops_kernel(long long n_vec, const uint32_t* __restrict__ a,
                    const uint32_t* __restrict__ b, int op,
                    uint32_t* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n_vec; i += stride) {
    uint32_t x[V], y[V];
    load_words<V>(a, i, x);
    load_words<V>(b, i, y);
#pragma unroll
    for (int v = 0; v < V; ++v) x[v] = container_op(op, x[v], y[v]);
    store_words<V>(out, i, x);
  }
}

__global__ void __launch_bounds__(256)
member_kernel(long long n, int L, const int* __restrict__ pos,
              const uint32_t* __restrict__ words, int W,
              uint32_t* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const uint32_t n_bits = static_cast<uint32_t>(W) * 32u;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const int q = __ldg(pos + i);
    uint32_t hit = 0u;
    // one unsigned compare rejects the -1 padding and positions past W
    if (static_cast<uint32_t>(q) < n_bits) {
      const long long row = i / L;
      const uint32_t w = __ldg(words + row * W + (q >> 5));
      hit = (w >> (static_cast<uint32_t>(q) & 31u)) & 1u;
    }
    out[i] = hit;
  }
}

REPRO_EXPORT int launch_containerops(int device, const void* a, const void* b,
                                     long long n, int op, void* out,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (op < 0 || op > 2) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = n % 4 == 0 && aligned16(a) && aligned16(b) &&
                   aligned16(out);
  REPRO_LAUNCH_VEC(containerops_kernel, vec, n,
                   static_cast<cudaStream_t>(stream),
                   static_cast<const uint32_t*>(a),
                   static_cast<const uint32_t*>(b), op,
                   static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT int launch_member(int device, const void* pos, long long P,
                               int L, const void* words, int W, void* out,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (L <= 0 || W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = P * L;
  const int threads = 256;
  member_kernel<<<grid_for(n, threads), threads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      n, L, static_cast<const int*>(pos),
      static_cast<const uint32_t*>(words), W, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
