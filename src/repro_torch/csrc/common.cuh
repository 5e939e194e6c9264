// Shared helpers of the port's hand-written Hopper kernels.
//
// Every source in this directory is compiled on its own by nvcc into a
// shared library with a plain C interface (kernels/build.py) and called
// through ctypes.  Words are EWAH words: uint32 inside the kernels, int32
// bit-views on the torch side.  Each launch_* entry point launches on the
// stream it is given, allocates nothing, and returns cudaGetLastError().
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

// One copy per library; ctypes loads each library with RTLD_LOCAL.
REPRO_EXPORT const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// EWAH word class: 0 = clean-0, 1 = clean-1, 2 = dirty.
__device__ __forceinline__ int word_class(uint32_t w) {
  return w == 0u ? 0 : (w == 0xFFFFFFFFu ? 1 : 2);
}

// Binary word op ids shared with the Python side: 0 = and, 1 = or, 2 = xor.
__device__ __forceinline__ uint32_t apply_op(int op, uint32_t a, uint32_t b) {
  return op == 0 ? (a & b) : (op == 1 ? (a | b) : (a ^ b));
}

// V consecutive words per thread: V = 4 reads and writes 16 bytes at a time
// (the caller checks alignment and n % 4 == 0), V = 1 is the scalar path.
template <int V>
__device__ __forceinline__ void load_words(const uint32_t* p, long long i,
                                           uint32_t (&w)[V]) {
  if constexpr (V == 4) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + i);
    w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
  } else {
    w[0] = __ldg(p + i);
  }
}

template <int V, typename T>
__device__ __forceinline__ void store_words(T* p, long long i,
                                            const uint32_t (&w)[V]) {
  if constexpr (V == 4) {
    reinterpret_cast<uint4*>(p)[i] = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    p[i] = static_cast<T>(w[0]);
  }
}

// cp.async: a thread's copy from device memory to shared memory that
// runs while the thread goes on (16 bytes: both addresses 16-byte
// aligned; 4 bytes: 4-byte aligned), grouped by commit() and awaited by
// wait_groups<N>() (all but the N newest groups landed).
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

static inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Grid for a grid-stride loop over n items: enough blocks to fill the
// card's 132 SMs several times over, never more than the work needs.
static inline unsigned grid_for(long long n, int threads) {
  long long blocks = (n + threads - 1) / threads;
  const long long cap = 132LL * 16;
  if (blocks > cap) blocks = cap;
  return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

// Launch an elementwise kernel with 16-byte accesses when every pointer is
// 16-byte aligned and n is a multiple of 4, else with 4-byte accesses.
#define REPRO_LAUNCH_VEC(kernel, vec, n, stream, ...)                        \
  do {                                                                       \
    const int threads_ = 256;                                                \
    if (vec) {                                                               \
      kernel<4><<<grid_for((n) / 4, threads_), threads_, 0, stream>>>(       \
          (n) / 4, __VA_ARGS__);                                             \
    } else {                                                                 \
      kernel<1><<<grid_for((n), threads_), threads_, 0, stream>>>(           \
          (n), __VA_ARGS__);                                                 \
    }                                                                        \
  } while (0)
