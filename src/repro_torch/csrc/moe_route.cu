// moe_route: top-k expert ids -> packed k-of-E dispatch words.
// Bit j of words[w][e] is set iff expert e is among the k ids of token
// 32w + j; a duplicate id sets one bit, and -1 or any id >= E sets none.
//
// Replaces the TPU kernel moe_route_kernel (src/repro/kernels/moe_route.py),
// which compares a (256, k) id tile against a 128-expert iota and shifts
// and sums the one-hot into words.
//
// Bound on the H100: bytes, 4 B per id read plus 4 B per output word, at
// 3.35 TB/s.  The design reads each id from device memory once, in
// contiguous 16-byte pieces, and keeps the bit transpose cheap:
//
// * A block of w warps owns a tile of w word rows (32w tokens).  The
//   tile's ids are one contiguous span, staged into shared memory with
//   cp.async (16 bytes a copy when the base is 16-byte aligned and k % 4
//   == 0, else 4 bytes).  MR_STAGES stages: the block's next grid-stride
//   tiles are in flight while it packs this one (more stages, or other
//   block sizes, gained nothing in trials on the H100; PERF.md).
// * Lane j of warp r builds token 32(tile row r) + j's hit mask over up to
//   NC x 32 experts at once (NC registers) from shared memory, 16 bytes a
//   read where k % 4 == 0.  Each lane starts its walk over its ids at a
//   lane-dependent rotation, which keeps the warp's reads free of bank
//   conflicts for every k.  More experts take further passes over the
//   staged ids; device memory is never read again.
// * Each 32 x 32 bit block (32 tokens x 32 experts) is transposed in
//   registers by a five-stage __shfl_xor_sync butterfly, after which lane
//   b holds expert e0 + b's word: one coalesced store a chunk, cut to the
//   experts that exist where E is not a multiple of 32.
// * Lanes past T take part with an empty mask, so the tail word's bits
//   stay 0.
// * k beyond what two stages of a 32-token row hold (908 ids a token in
//   the H100's 227 KB) is not staged: the same walk reads each token's
//   ids from device memory, once for each pass over the experts.
#include "common.cuh"

namespace {

constexpr int MR_MAX_WARPS = 8;   // word rows a tile
constexpr int MR_STAGES = 2;
constexpr unsigned FULL = 0xFFFFFFFFu;

// In-register transpose of a 32 x 32 bit matrix held one row a lane:
// bit l of lane b's result is bit b of lane l's x.  Stage j swaps the
// off-diagonal j x j blocks of every 2j x 2j block.
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
  constexpr uint32_t kMask[5] = {0x0000FFFFu, 0x00FF00FFu, 0x0F0F0F0Fu,
                                 0x33333333u, 0x55555555u};
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const int j = 16 >> s;
    const bool up = lane & j;
    const uint32_t got = __shfl_xor_sync(FULL, up ? x << j : x >> j, j);
    const uint32_t keep = up ? ~kMask[s] : kMask[s];
    x = (x & keep) | (got & ~keep);
  }
  return x;
}

// Sets bit d of the NC-word mask m where d < width (d unsigned, so -1 and
// ids of other passes drop out), without indexing registers by value.
template <int NC>
__device__ __forceinline__ void hit(uint32_t (&m)[NC], uint32_t d,
                                    uint32_t width) {
  const uint32_t bit = d < width ? 1u << (d & 31u) : 0u;
#pragma unroll
  for (int c = 0; c < NC; ++c)
    m[c] |= ((d >> 5) == static_cast<uint32_t>(c)) ? bit : 0u;
}

}  // namespace

template <int NC, bool VEC>
__global__ void __launch_bounds__(MR_MAX_WARPS * 32)
moe_route_kernel(long long T, int k, const int* __restrict__ eids,
                 int n_experts, int staged, int copy_16,
                 uint32_t* __restrict__ words) {
  extern __shared__ __align__(16) uint32_t stage[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long tile_tokens = 32LL * warps;
  const long long n_tiles = (T + tile_tokens - 1) / tile_tokens;
  const int stage_words = staged ? static_cast<int>(tile_tokens) * k : 0;

  auto fetch = [&](long long t, int s) {
    const long long t0 = t * tile_tokens;
    const long long n_tok = T - t0 < tile_tokens ? T - t0 : tile_tokens;
    const int n = static_cast<int>(n_tok) * k;
    const int* src = eids + t0 * k;
    uint32_t* dst = stage + s * stage_words;
    if (staged && copy_16) {
      for (int i = threadIdx.x * 4; i < n; i += blockDim.x * 4)
        copy16(dst + i, src + i);
    } else if (staged) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) copy4(dst + i, src + i);
    }
    commit();  // an empty group where nothing is staged
  };

  // lane-dependent start of the walk over a token's ids: g = gcd(units,
  // banks a phase) spreads the lanes that would share a bank
  const int units = VEC ? k >> 2 : k;
  const int low = units & -units;
  const int rot = VEC ? (((lane & 7) * (low < 8 ? low : 8)) >> 3)
                      : ((lane * (low < 32 ? low : 32)) >> 5);

  // MR_STAGES - 1 tiles in flight ahead of the one being packed
#pragma unroll
  for (int j = 0; j < MR_STAGES - 1; ++j) {
    const long long tj = blockIdx.x + static_cast<long long>(j) * gridDim.x;
    if (tj < n_tiles) fetch(tj, j);
    else commit();  // empty groups keep wait_groups exact
  }
  int s = 0;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long ahead = t + (MR_STAGES - 1) * static_cast<long long>(
                                    gridDim.x);
    if (ahead < n_tiles) fetch(ahead, s == 0 ? MR_STAGES - 1 : s - 1);
    else commit();
    wait_groups<MR_STAGES - 1>();
    __syncthreads();

    const long long row = t * warps + warp;
    const long long token = row * 32 + lane;
    if (row * 32 < T) {  // warp-uniform
      const uint32_t* ids =
          staged ? stage + s * stage_words + (warp * 32 + lane) * k
                 : reinterpret_cast<const uint32_t*>(eids) +
                       (token < T ? token : 0) * k;
      for (int g0 = 0; g0 < n_experts; g0 += NC * 32) {
        const int left = n_experts - g0;
        const uint32_t width = left < NC * 32 ? left : NC * 32;
        uint32_t m[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) m[c] = 0u;
        if (token < T) {
          int v = rot;
          for (int i = 0; i < units; ++i) {
            if constexpr (VEC) {
              const uint4 q = reinterpret_cast<const uint4*>(ids)[v];
              hit<NC>(m, q.x - g0, width);
              hit<NC>(m, q.y - g0, width);
              hit<NC>(m, q.z - g0, width);
              hit<NC>(m, q.w - g0, width);
            } else {
              hit<NC>(m, ids[v] - g0, width);
            }
            if (++v == units) v = 0;
          }
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int e = g0 + c * 32;
          if (e < n_experts) {  // warp-uniform
            const uint32_t word = transpose32(m[c], lane);
            if (e + lane < n_experts) words[row * n_experts + e + lane] = word;
          }
        }
      }
    }
    __syncthreads();  // stage s is refilled by a later iteration's fetch
    s = s + 1 == MR_STAGES ? 0 : s + 1;
  }
}

namespace {

// row_bytes: two stages of a word row's ids, 0 where they are not staged.
template <int NC, bool VEC>
cudaError_t launch(long long T, int k, const int* eids, int n_experts,
                   uint32_t* words, cudaStream_t stream, int sms, int optin,
                   long long row_bytes) {
  // word rows a tile: up to 8, fewer where k makes two stages too large
  const long long n_rows = (T + 31) / 32;
  long long warps = row_bytes ? optin / row_bytes : MR_MAX_WARPS;
  if (warps > MR_MAX_WARPS) warps = MR_MAX_WARPS;
  if (warps > n_rows) warps = n_rows;
  const int threads = static_cast<int>(warps) * 32;
  const size_t smem = static_cast<size_t>(warps * row_bytes);
  auto kernel = moe_route_kernel<NC, VEC>;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  const long long n_tiles = (n_rows + warps - 1) / warps;
  long long blocks = static_cast<long long>(per_sm < 1 ? 1 : per_sm) * sms;
  if (blocks > n_tiles) blocks = n_tiles;
  const int copy_16 = k % 4 == 0 && aligned16(eids);
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      T, k, eids, n_experts, row_bytes != 0, copy_16, words);
  return cudaGetLastError();
}

}  // namespace

REPRO_EXPORT int launch_moe_route(int device, const void* eids, long long T,
                                  int k, int n_experts, void* words,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (T <= 0 || k <= 0 || n_experts <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0, optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int* ids = static_cast<const int*>(eids);
  uint32_t* out = static_cast<uint32_t*>(words);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // a 32-token row's ids staged twice, where they fit in a block
  long long row_bytes = static_cast<long long>(MR_STAGES) * 32 * k * 4;
  if (row_bytes > optin) row_bytes = 0;
  // 16-byte reads of a token's ids: from shared memory, or (not staged)
  // from an aligned base
  const bool vec = k % 4 == 0 && (row_bytes != 0 || aligned16(eids));
  if (n_experts <= 32)
    err = vec ? launch<1, true>(T, k, ids, n_experts, out, s, sms, optin,
                                row_bytes)
              : launch<1, false>(T, k, ids, n_experts, out, s, sms, optin,
                                 row_bytes);
  else if (n_experts <= 64)
    err = vec ? launch<2, true>(T, k, ids, n_experts, out, s, sms, optin,
                                row_bytes)
              : launch<2, false>(T, k, ids, n_experts, out, s, sms, optin,
                                 row_bytes);
  else
    err = vec ? launch<4, true>(T, k, ids, n_experts, out, s, sms, optin,
                                row_bytes)
              : launch<4, false>(T, k, ids, n_experts, out, s, sms, optin,
                                 row_bytes);
  return static_cast<int>(err);
}
