// moe_route: top-k expert ids -> packed k-of-E dispatch words.
// Bit j of words[w][e] is set iff expert e is among the k ids of token
// 32w + j; a duplicate id sets one bit, and -1 or any id >= E sets none.
//
// Replaces the TPU kernel moe_route_kernel (src/repro/kernels/moe_route.py),
// which compares a (256, k) id tile against a 128-expert iota and shifts
// and sums the one-hot into words.  Here one warp owns one word row, 32
// tokens: lane j reads token 32w + j's k ids (k a runtime argument), and
// for each chunk of 32 experts builds its own 32-bit mask of the experts it
// hit in that chunk.  One __ballot_sync per expert of the chunk then gives
// that expert's word directly; lane b keeps the ballot of expert e0 + b and
// the warp stores the chunk's 32 words with one coalesced 128-byte store.
// Lanes past T take part with an empty mask, so the tail word's bits stay 0.
//
// Bound on the H100: bytes, 4 B per id read plus 4 B per output word, at
// 3.35 TB/s.
#include "common.cuh"

__global__ void __launch_bounds__(256)
moe_route_kernel(long long T, int k, const int* __restrict__ eids,
                 int n_experts, uint32_t* __restrict__ words) {
  const int lane = threadIdx.x & 31;
  const long long n_rows = (T + 31) / 32;
  const long long warps = static_cast<long long>(gridDim.x) * (blockDim.x / 32);
  for (long long w = (static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x) / 32;
       w < n_rows; w += warps) {  // warp-uniform: every lane shares w
    const long long t = w * 32 + lane;
    const int* ids = eids + t * k;
    for (int e0 = 0; e0 < n_experts; e0 += 32) {
      const uint32_t width = n_experts - e0 < 32 ? n_experts - e0 : 32;
      uint32_t mask = 0u;
      if (t < T) {
        for (int i = 0; i < k; ++i) {
          // one unsigned compare drops -1, ids past E and other chunks
          const uint32_t d = static_cast<uint32_t>(__ldg(ids + i)) -
                             static_cast<uint32_t>(e0);
          if (d < width) mask |= 1u << d;
        }
      }
      uint32_t mine = 0u;
#pragma unroll
      for (int b = 0; b < 32; ++b) {
        const uint32_t word = __ballot_sync(0xFFFFFFFFu, (mask >> b) & 1u);
        if (lane == b) mine = word;
      }
      if (static_cast<uint32_t>(lane) < width)
        words[w * n_experts + e0 + lane] = mine;
    }
  }
}

REPRO_EXPORT int launch_moe_route(int device, const void* eids, long long T,
                                  int k, int n_experts, void* words,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (T <= 0 || k <= 0 || n_experts <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const long long n_threads = ((T + 31) / 32) * 32;
  moe_route_kernel<<<grid_for(n_threads, threads), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      T, k, static_cast<const int*>(eids), n_experts,
      static_cast<uint32_t*>(words));
  return static_cast<int>(cudaGetLastError());
}
