// bitpack: pack (R, C) booleans into (ceil(R/32), C) words, bit j of
// words[w][c] = bits[32w + j][c] (the paper's Algorithm 1 "wordize" step).
//
// Replaces the TPU kernel bitpack_kernel (src/repro/kernels/bitpack.py),
// which shifts and sums a (256, 128) tile per grid step.  Here one thread
// owns V neighbouring columns of one output word row and loops over its 32
// input rows: each row is one load of V bytes, so with V = 16 a warp reads
// 512 consecutive bytes of a row with sixteen-byte loads and writes its
// words with 16-byte stores (V = 1 where C is not a multiple of 16).  The
// reads stay coalesced along C without staging through shared memory,
// which a ballot-per-column design would need.  Rows past R (the last
// word's tail) are not read and their bits stay 0.  Any nonzero byte
// counts as a set bit (torch.bool holds 0 or 1).
//
// Bound on the H100: bytes, R * C one-byte reads plus 4 B per output word,
// at 3.35 TB/s.
#include "common.cuh"

template <int V>
__device__ __forceinline__ void load_bytes(const uint8_t* p, uint32_t (&b)[V]) {
  if constexpr (V == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t q[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 16; ++i) b[i] = (q[i / 4] >> (8 * (i % 4))) & 0xFFu;
  } else {
    b[0] = __ldg(p);
  }
}

template <int V>
__global__ void __launch_bounds__(256)
bitpack_kernel(long long R, long long C, const uint8_t* __restrict__ bits,
               uint32_t* __restrict__ words) {
  const long long groups = C / V;                 // column groups per row
  const long long n = ((R + 31) / 32) * groups;   // one item per (word, group)
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const long long w = i / groups;
    const long long c = (i - w * groups) * V;
    const long long r0 = w * 32;
    const int rows = R - r0 < 32 ? static_cast<int>(R - r0) : 32;
    uint32_t acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0u;
    const uint8_t* p = bits + r0 * C + c;
#pragma unroll 8
    for (int j = 0; j < rows; ++j) {
      uint32_t b[V];
      load_bytes<V>(p + j * C, b);
#pragma unroll
      for (int v = 0; v < V; ++v)
        acc[v] |= static_cast<uint32_t>(b[v] != 0u) << j;
    }
    uint32_t* o = words + w * C + c;
    if constexpr (V == 1) {
      o[0] = acc[0];
    } else {
#pragma unroll
      for (int v = 0; v < V; v += 4)
        *reinterpret_cast<uint4*>(o + v) =
            make_uint4(acc[v], acc[v + 1], acc[v + 2], acc[v + 3]);
    }
  }
}

template <int V>
static void launch(long long R, long long C, const void* bits, void* words,
                   cudaStream_t stream) {
  const int threads = 256;
  const long long n = ((R + 31) / 32) * (C / V);
  bitpack_kernel<V><<<grid_for(n, threads), threads, 0, stream>>>(
      R, C, static_cast<const uint8_t*>(bits), static_cast<uint32_t*>(words));
}

REPRO_EXPORT int launch_bitpack(int device, const void* bits, long long R,
                                long long C, void* words, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (R <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // every row start is as aligned as the base when C is a multiple of 16
  if (C % 16 == 0 && aligned16(bits) && aligned16(words)) {
    launch<16>(R, C, bits, words, s);
  } else {
    launch<1>(R, C, bits, words, s);
  }
  return static_cast<int>(cudaGetLastError());
}
