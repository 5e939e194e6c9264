// planfuse: a whole lowered query plan in one launch.
//
// Replaces the TPU kernel planfuse_kernel (src/repro/kernels/planfuse.py,
// body _kernel).  The kernel interprets the static stack-machine tape from
// core.query.lower_plan over m decoded leaf planes and writes the root words
// and each root word's EWAH class (0 clean-0, 1 clean-1, 2 dirty):
//
//   (0, i)  PUSH  plane i          (1, 0)  NOT  top of stack
//   (2, k)  OP    pop b, pop a, push a <k> b   (k: 0 and, 1 or, 2 xor)
//
// One thread per 4 consecutive word positions (16-byte loads and stores
// where alignment allows).  The tape is copied into shared memory at block
// start as (opcode, arg) int pairs and read by every thread in lockstep, so
// the interpreter never diverges inside a warp; each thread keeps its
// operand stack in a local array of MAX_STACK_DEPTH entries.  One compiled
// kernel runs every tape: nothing is compiled per plan.
//
// Bound on the H100: bytes.  It reads each PUSHed plane once (4 B a word
// per PUSH) and writes r and kind (8 B a word); at 3.35 TB/s that is the
// least time.  The stack never leaves the SM's L1 at the depths the gate
// admits.
#include "common.cuh"

#ifndef MAX_TAPE_LEN
#error "MAX_TAPE_LEN comes from kernels/planfuse.py"
#endif
#ifndef MAX_STACK_DEPTH
#error "MAX_STACK_DEPTH comes from kernels/planfuse.py"
#endif

template <int V>
__global__ void __launch_bounds__(256)
planfuse_kernel(long long n_vec, const uint32_t* __restrict__ x,
                long long plane_words, const int* __restrict__ tape,
                int tape_len, uint32_t* __restrict__ r,
                int* __restrict__ kind) {
  __shared__ int2 s_tape[MAX_TAPE_LEN];
  for (int t = threadIdx.x; t < tape_len; t += blockDim.x) {
    s_tape[t] = make_int2(tape[2 * t], tape[2 * t + 1]);
  }
  __syncthreads();

  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n_vec; i += stride) {
    uint32_t stack[MAX_STACK_DEPTH][V];
    int sp = 0;
#pragma unroll 1
    for (int t = 0; t < tape_len; ++t) {
      const int2 ins = s_tape[t];
      if (ins.x == 0) {
        load_words<V>(x + static_cast<long long>(ins.y) * plane_words, i,
                      stack[sp]);
        ++sp;
      } else if (ins.x == 1) {
#pragma unroll
        for (int v = 0; v < V; ++v) stack[sp - 1][v] = ~stack[sp - 1][v];
      } else {
        --sp;
#pragma unroll
        for (int v = 0; v < V; ++v)
          stack[sp - 1][v] = apply_op(ins.y, stack[sp - 1][v], stack[sp][v]);
      }
    }
    uint32_t k[V];
#pragma unroll
    for (int v = 0; v < V; ++v) k[v] = static_cast<uint32_t>(word_class(stack[0][v]));
    store_words<V>(r, i, stack[0]);
    store_words<V>(kind, i, k);
  }
}

// x: (m, n) words; tape: (tape_len, 2) int32 on the device; r, kind: (n,).
// The caller has checked the tape (length, depth, plane ids).
REPRO_EXPORT int launch_planfuse(int device, const void* x, long long n,
                                 const void* tape, int tape_len, void* r,
                                 void* kind, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tape_len < 1 || tape_len > MAX_TAPE_LEN)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = n % 4 == 0 && aligned16(x) && aligned16(r) &&
                   aligned16(kind);
  REPRO_LAUNCH_VEC(planfuse_kernel, vec, n, static_cast<cudaStream_t>(stream),
                   static_cast<const uint32_t*>(x), n,
                   static_cast<const int*>(tape), tape_len,
                   static_cast<uint32_t*>(r), static_cast<int*>(kind));
  return static_cast<int>(cudaGetLastError());
}
