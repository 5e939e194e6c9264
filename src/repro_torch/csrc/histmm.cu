// histmm: attribute-value histogram, counts[v] = #{i : vals[i] == v} for v
// in [0, V), as float32; values outside [0, V) are dropped.
//
// Replaces the TPU kernel histmm_kernel (src/repro/kernels/histmm.py),
// which builds a one-hot tile and multiplies it by a ones vector on the
// matrix unit, carrying the sum across sequential grid steps.  On Hopper
// blocks run in parallel and in no order, so the sum goes through atomics:
//
// * V * 4 bytes within the shared memory a block may opt into (227 KB,
//   V <= 58,112): each block counts its grid-stride share of the values
//   into a private shared-memory histogram, then adds its nonzero bins to
//   the global counts with one atomic each (never more atomics than
//   values).  Above 48 KB the kernel is opted in with cudaFuncSetAttribute,
//   and the grid is as many blocks as fit on the card at that size.
// * Larger V (census-like's 99,761 values): one global atomic per value
//   on the counts, which live in L2.
//
// Counts accumulate as uint32 in a scratch vector the caller passes (it is
// zeroed here) and are converted to float32 once, by a second kernel:
// identical to the reference's float32 sums below 2**24.  A few bins
// taking most of the values (a 7-value column) serialise their atomics;
// that is slow but exact.
//
// Bound on the H100: bytes, 4 B a value read plus 4 B a bin written, at
// 3.35 TB/s.
#include "common.cuh"

template <int V>
__global__ void __launch_bounds__(512)
hist_shared_kernel(long long n_vec, const uint32_t* __restrict__ vals,
                   uint32_t n_bins, uint32_t* __restrict__ counts) {
  extern __shared__ uint32_t bins[];
  for (uint32_t b = threadIdx.x; b < n_bins; b += blockDim.x) bins[b] = 0u;
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n_vec; i += stride) {
    uint32_t w[V];
    load_words<V>(vals, i, w);
#pragma unroll
    for (int v = 0; v < V; ++v)  // one unsigned compare drops < 0 and >= V
      if (w[v] < n_bins) atomicAdd(&bins[w[v]], 1u);
  }
  __syncthreads();
  for (uint32_t b = threadIdx.x; b < n_bins; b += blockDim.x) {
    const uint32_t c = bins[b];
    if (c) atomicAdd(&counts[b], c);
  }
}

template <int V>
__global__ void __launch_bounds__(256)
hist_global_kernel(long long n_vec, const uint32_t* __restrict__ vals,
                   uint32_t n_bins, uint32_t* __restrict__ counts) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n_vec; i += stride) {
    uint32_t w[V];
    load_words<V>(vals, i, w);
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (w[v] < n_bins) atomicAdd(&counts[w[v]], 1u);
  }
}

__global__ void __launch_bounds__(256)
to_float_kernel(long long n, const uint32_t* __restrict__ counts,
                float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride)
    out[i] = static_cast<float>(counts[i]);
}

template <int V>
static cudaError_t count(int device, const uint32_t* vals, long long n,
                         uint32_t n_bins, uint32_t* counts,
                         cudaStream_t stream) {
  const long long n_vec = n / V;
  const size_t smem = static_cast<size_t>(n_bins) * sizeof(uint32_t);
  int optin = 0, sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (smem <= static_cast<size_t>(optin)) {
    const int threads = 512;
    err = cudaFuncSetAttribute(hist_shared_kernel<V>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    int per_sm = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, hist_shared_kernel<V>, threads, smem);
    if (err != cudaSuccess) return err;
    long long blocks = static_cast<long long>(per_sm < 1 ? 1 : per_sm) * sms;
    const long long need = (n_vec + threads - 1) / threads;
    if (blocks > need) blocks = need < 1 ? 1 : need;
    hist_shared_kernel<V><<<static_cast<unsigned>(blocks), threads, smem,
                            stream>>>(n_vec, vals, n_bins, counts);
  } else {
    const int threads = 256;
    hist_global_kernel<V><<<grid_for(n_vec, threads), threads, 0, stream>>>(
        n_vec, vals, n_bins, counts);
  }
  return cudaGetLastError();
}

REPRO_EXPORT int launch_histogram(int device, const void* vals, long long n,
                                  int n_bins, void* counts, void* out,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_bins <= 0 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* c = static_cast<uint32_t*>(counts);
  err = cudaMemsetAsync(c, 0, static_cast<size_t>(n_bins) * sizeof(uint32_t),
                        s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const uint32_t* v = static_cast<const uint32_t*>(vals);
    err = (n % 4 == 0 && aligned16(vals))
              ? count<4>(device, v, n, static_cast<uint32_t>(n_bins), c, s)
              : count<1>(device, v, n, static_cast<uint32_t>(n_bins), c, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  to_float_kernel<<<grid_for(n_bins, 256), 256, 0, s>>>(
      n_bins, c, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
