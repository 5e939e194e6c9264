// histmm: attribute-value histogram, counts[v] = #{i : vals[i] == v} for v
// in [0, V), as float32; values outside [0, V) are dropped.
//
// Replaces the TPU kernel histmm_kernel (src/repro/kernels/histmm.py),
// which builds a one-hot tile and multiplies it by a ones vector on the
// matrix unit, carrying the sum across sequential grid steps.  On Hopper
// blocks run in parallel and in no order, so partial counts meet through
// atomics.
//
// Bound on the H100: bytes, 4 B a value read plus 4 B a bin written, at
// 3.35 TB/s: about 1.2 us at a million values, less than one launch.  So
// a call is one launch, which writes the float32 counts itself (no memset
// and no conversion pass).  Where the counts live follows V; the plan
// (regime, block size, grid) comes from plan() in kernels/histmm.py:
//
// * shared (4 bytes a bin within a block's 227 KB): a private histogram in
//   the block's shared memory, one shared atomic a value (the card merges
//   a warp's adds to one address, so few bins do not serialise).  The grid
//   keeps about as many partial copies as the values fill (plan()), since
//   each is flushed bin by bin.
// * global (larger V): every value adds into device memory.
//
// A grid of one block writes the floats with plain stores.  In a larger
// grid partial counts meet in device memory:
// * below 2**24 values (every count exact in float32, whatever the order
//   of the additions) they add as floats straight into `out`, four bins
//   an add (16-byte float atomics), which the caller hands over zeroed;
//   the launch zeroes `next`, the buffer the caller hands over on its next
//   call, so no call needs a memset;
// * from 2**24 values on they add into a uint32 scratch vector that the
//   caller keeps zeroed; the grid, launched cooperatively, meets at one
//   grid-wide barrier, and each block then converts a contiguous range of
//   the counts to float32 (rounded once, as the reference rounds its
//   integer counts) and zeroes it again.
//
// Tried and dropped (PERF.md): one histogram spread over a thread
// block cluster's distributed shared memory with remote atomics and
// __match_any_sync aggregation; copies summed across a cluster through
// distributed shared memory; the barrier and conversion below 2**24
// values; counters in registers for V <= 32.  None was faster at the
// timed shapes.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

enum Regime { SHARED = 0, GLOBAL = 1 };

// Values VEC * i .. VEC * i + VEC - 1; past n they read as 0xFFFFFFFF,
// which no histogram holds.  VEC = 4 needs a 16-byte aligned base.
template <int VEC>
__device__ __forceinline__ void load_vals(const uint32_t* p, long long n,
                                          long long i, uint32_t (&w)[VEC]) {
  if constexpr (VEC == 4) {
    if (4 * i + 4 <= n) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + i);
      w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    w[j] = VEC * i + j < n ? __ldg(p + VEC * i + j) : 0xFFFFFFFFu;
}

// This block's contiguous range of the V bins.
__device__ __forceinline__ void block_range(uint32_t V, uint32_t& lo,
                                            uint32_t& hi) {
  const uint32_t per = (V + gridDim.x - 1) / gridDim.x;
  lo = blockIdx.x * per < V ? blockIdx.x * per : V;
  hi = lo + per < V ? lo + per : V;
}

// Zeroes this block's range of the next call's output (null: none).
__device__ __forceinline__ void zero_next(float* next, uint32_t V) {
  if (next == nullptr) return;
  uint32_t lo, hi;
  block_range(V, lo, hi);
  for (uint32_t x = lo + threadIdx.x; x < hi; x += blockDim.x) next[x] = 0.f;
}

// After the exact path's adds into the scratch: the grid meets, and each
// block converts its range to float32 and zeroes the scratch again.
__device__ __forceinline__ void convert(uint32_t V, uint32_t* scratch,
                                        float* out) {
  __threadfence();
  if (gridDim.x > 1) cg::this_grid().sync();
  else __syncthreads();
  uint32_t lo, hi;
  block_range(V, lo, hi);
  for (uint32_t x = lo + threadIdx.x; x < hi; x += blockDim.x) {
    out[x] = static_cast<float>(__ldcg(scratch + x));
    scratch[x] = 0u;
  }
}

// The end of the shared regime: the block's counts of bins [0, V) are in
// `bins` (shared memory, after a barrier).  One block writes the floats; a
// larger grid adds its nonzero counts as floats into the zeroed `out`, or
// (exact, scratch not null) into the scratch.
__device__ __forceinline__ void finish(const uint32_t* bins, uint32_t V,
                                       uint32_t* scratch, float* out) {
  if (gridDim.x == 1) {
    for (uint32_t x = threadIdx.x; x < V; x += blockDim.x)
      out[x] = static_cast<float>(bins[x]);
    return;
  }
  if (scratch) {
    for (uint32_t x = threadIdx.x; x < V; x += blockDim.x)
      if (bins[x]) atomicAdd(scratch + x, bins[x]);
    convert(V, scratch, out);
    return;
  }
  // four bins an add where all four exist (16-byte float adds, Hopper)
  for (uint32_t q = threadIdx.x; 4 * q < V; q += blockDim.x) {
    const uint4 c = reinterpret_cast<const uint4*>(bins)[q];
    if ((c.x | c.y | c.z | c.w) == 0u) continue;
    if (4 * q + 4 <= V) {
      atomicAdd(reinterpret_cast<float4*>(out) + q,
                make_float4(c.x, c.y, c.z, c.w));
    } else {
      const uint32_t part[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (uint32_t j = 0; j < 4; ++j)
        if (4 * q + j < V && part[j])
          atomicAdd(out + 4 * q + j, static_cast<float>(part[j]));
    }
  }
}

}  // namespace

// shared: the block's private histogram of V bins.
template <int VEC>
__global__ void __launch_bounds__(1024)
hist_shared_kernel(const uint32_t* __restrict__ vals, long long n, uint32_t V,
                   uint32_t* __restrict__ scratch, float* __restrict__ out,
                   float* __restrict__ next) {
  extern __shared__ __align__(16) uint32_t bins[];  // V rounded up to 4
  for (uint32_t q = threadIdx.x; 4 * q < V; q += blockDim.x)
    reinterpret_cast<uint4*>(bins)[q] = make_uint4(0u, 0u, 0u, 0u);
  zero_next(next, V);
  __syncthreads();
  const long long n_vec = (n + VEC - 1) / VEC;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n_vec; i += stride) {
    uint32_t w[VEC];
    load_vals<VEC>(vals, n, i, w);
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      if (w[j] < V) atomicAdd(bins + w[j], 1u);
  }
  __syncthreads();
  finish(bins, V, scratch, out);
}

// global: every value adds into the zeroed `out`, or (exact) into the
// scratch, which the grid then converts.
template <int VEC>
__global__ void __launch_bounds__(1024)
hist_global_kernel(const uint32_t* __restrict__ vals, long long n, uint32_t V,
                   uint32_t* __restrict__ scratch, float* __restrict__ out,
                   float* __restrict__ next) {
  zero_next(next, V);
  const long long n_vec = (n + VEC - 1) / VEC;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n_vec; i += stride) {
    uint32_t w[VEC];
    load_vals<VEC>(vals, n, i, w);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      if (w[j] >= V) continue;
      if (scratch) atomicAdd(scratch + w[j], 1u);
      else atomicAdd(out + w[j], 1.f);
    }
  }
  if (scratch) convert(V, scratch, out);
}

namespace {

// One launch; the exact path's grid of more than one block is cooperative
// (all blocks resident at once, so that they may meet at the barrier).
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), int blocks, int threads,
                   int smem, bool cooperative, cudaStream_t stream,
                   Args... args) {
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (!cooperative || blocks == 1) {
    kernel<<<blocks, threads, smem, stream>>>(args...);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int VEC>
cudaError_t run(int regime, int blocks, int threads, int smem,
                const uint32_t* v, long long n, uint32_t V, uint32_t* scratch,
                float* out, float* next, cudaStream_t s) {
  const bool coop = scratch != nullptr;
  if (regime == GLOBAL)
    return launch(hist_global_kernel<VEC>, blocks, threads, 0, coop, s, v, n,
                  V, scratch, out, next);
  return launch(hist_shared_kernel<VEC>, blocks, threads, smem, coop, s, v, n,
                V, scratch, out, next);
}

}  // namespace

// What plan() needs to know of the card: its SMs and the shared memory a
// block may opt into.
REPRO_EXPORT int histogram_device_limits(int device, int* sms, int* optin) {
  cudaError_t err =
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 device);
  return static_cast<int>(err);
}

// vals: (n,) int32; out: (V,) float32.  Below 2**24 values (scratch null)
// `out` is zero on entry unless the grid is one block of the shared
// regime, and the launch zeroes `next` (V floats, or null).  From
// 2**24 values on, `scratch` is V uint32 words, zero on entry and on
// return.  regime, blocks, threads and smem come from plan() in
// kernels/histmm.py and are checked here.
REPRO_EXPORT int launch_histogram(int device, const void* vals, long long n,
                                  int V, int regime, int blocks,
                                  int threads, int smem, void* scratch,
                                  void* out, void* next, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool ok =
      n >= 0 && V >= 1 && (regime == SHARED || regime == GLOBAL) &&
      threads >= 32 && threads <= 1024 && threads % 32 == 0 && blocks >= 1 &&
      (regime != SHARED || smem >= 16LL * ((V + 3) / 4)) &&
      (reinterpret_cast<uintptr_t>(out) & 15u) == 0 &&
      smem >= 0 && (scratch != nullptr) == (n >= (1LL << 24));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const uint32_t* v = static_cast<const uint32_t*>(vals);
  uint32_t* sc = static_cast<uint32_t*>(scratch);
  float* o = static_cast<float*>(out);
  float* nx = static_cast<float*>(next);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = aligned16(vals)
            ? run<4>(regime, blocks, threads, smem, v, n, V, sc, o, nx, s)
            : run<1>(regime, blocks, threads, smem, v, n, V, sc, o, nx, s);
  return static_cast<int>(err);
}
