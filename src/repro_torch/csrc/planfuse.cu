// planfuse: a whole lowered query plan in one launch.
//
// Replaces the TPU kernel planfuse_kernel (src/repro/kernels/planfuse.py,
// body _kernel).  The kernel evaluates the stack-machine tape from
// core.query.lower_plan over m decoded leaf planes and writes the root
// words and each root word's EWAH class (0 clean-0, 1 clean-1, 2 dirty).
// The host splits the tape first (kernels/planfuse.py, split):
//
//   pushes  the plane ids in PUSH order;
//   code    one int per step, kind | op << 2 | slot << 4, with the
//           operand-stack slot of every step resolved on the host:
//             LOAD    st[slot] = next plane
//             LOADOP  st[slot] = st[slot] <op> next plane
//             NOT     st[slot] = ~st[slot]
//             OP      st[slot] = st[slot] <op> st[slot + 1]
//           (op: 0 and, 1 or, 2 xor).
//
// Bound on the H100: bytes.  It reads each PUSHed plane once (4 B a word
// per PUSH) and writes r and kind (8 B a word); at 3.35 TB/s that is the
// least time.  The design keeps loads in flight and the stack out of
// memory:
//
// * Planes stream through shared memory with cp.async.  A block takes one
//   tile of 256 x V word positions; thread t owns words V t .. V t + V - 1
//   of it.  Because the push list is known, each thread copies the words
//   it will read of the next pushes ahead of time (16-byte copies where a
//   plane's words are 16-byte aligned, 4-byte ones elsewhere) into its own
//   slots of a ring of stages, kAhead pushes ahead, and waits with
//   cp.async.wait_group for the oldest only.  No thread ever reads another
//   thread's words, so the pipeline needs no barrier at all.  (A TMA bulk
//   copy ring fed by a producer warp, with full / empty mbarriers, was
//   tried first and read less of the bound; PERF.md has both.)
// * The operand stack stays in registers: the kernel is instantiated per
//   depth class D in {2, 4, 8, 16} (the launcher picks the smallest D that
//   holds the program's slots), every step dispatches on its kind and op
//   and then on its slot with uniform switches, and every case indexes the
//   stack with constants, so there is no local-memory stack frame (ptxas
//   -v reports 0 bytes; chip_smoke checks it).  A PUSH followed by its OP
//   is one LOADOP step that never occupies a slot.
// * V (1, 2 or 4) follows n so that a small batch still gives every SM
//   two tiles; the ring is 32 KB a block (8, 16 or 32 stages), static
//   shared memory beside the 8 KB of code and push list, so an SM holds
//   up to five blocks.  One block a tile lets the hardware hand out the last
//   wave's tiles as blocks finish.
#include "common.cuh"

#ifndef MAX_TAPE_LEN
#error "MAX_TAPE_LEN comes from kernels/planfuse.py"
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kRingBytes = 32 * 1024;
constexpr int kMaxStages = 32;

enum { kLoad = 0, kLoadOp = 1, kNot = 2, kOp = 3 };

template <int V>
struct Ring {
  static constexpr int kTile = kThreads * V;  // word positions a tile
  static constexpr int kFit = kRingBytes / (kTile * 4);
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  // pushes in flight a thread; the two spare stages keep a copy from
  // landing in a stage the thread has just read
  static constexpr int kAhead = kStages - 2;
};

template <int OP>
__device__ __forceinline__ uint32_t op_of(uint32_t a, uint32_t b) {
  return OP == 0 ? (a & b) : (OP == 1 ? (a | b) : (a ^ b));
}

// One step of kind K and op OP at `slot` of the register stack.  The slot
// is uniform across the block, so the switch never diverges, and every
// case indexes `st` with constants.
template <int K, int OP, int D, int V>
__device__ __forceinline__ void step_at(uint32_t (&st)[D][V], int slot,
                                        const uint32_t (&w)[V]) {
#define PLANFUSE_SLOT(d)                                                   \
  case d:                                                                  \
    if constexpr (d < D) {                                                 \
      constexpr int e = d + 1 < D ? d + 1 : d;                             \
      _Pragma("unroll") for (int v = 0; v < V; ++v) {                      \
        if constexpr (K == kLoad)                                          \
          st[d][v] = w[v];                                                 \
        else if constexpr (K == kLoadOp)                                   \
          st[d][v] = op_of<OP>(st[d][v], w[v]);                            \
        else if constexpr (K == kNot)                                      \
          st[d][v] = ~st[d][v];                                            \
        else                                                               \
          st[d][v] = op_of<OP>(st[d][v], st[e][v]);                        \
      }                                                                    \
    }                                                                      \
    break;
  switch (slot) {
    PLANFUSE_SLOT(0) PLANFUSE_SLOT(1) PLANFUSE_SLOT(2) PLANFUSE_SLOT(3)
    PLANFUSE_SLOT(4) PLANFUSE_SLOT(5) PLANFUSE_SLOT(6) PLANFUSE_SLOT(7)
    PLANFUSE_SLOT(8) PLANFUSE_SLOT(9) PLANFUSE_SLOT(10) PLANFUSE_SLOT(11)
    PLANFUSE_SLOT(12) PLANFUSE_SLOT(13) PLANFUSE_SLOT(14) PLANFUSE_SLOT(15)
    default:
      break;
  }
#undef PLANFUSE_SLOT
}

// One step: a uniform switch on kind | op << 2, then on the slot.
template <int D, int V>
__device__ __forceinline__ void step(uint32_t (&st)[D][V], int ins,
                                     const uint32_t (&w)[V]) {
  const int slot = ins >> 4;
  switch (ins & 15) {
    case kLoad: step_at<kLoad, 0>(st, slot, w); break;
    case kLoadOp | 0 << 2: step_at<kLoadOp, 0>(st, slot, w); break;
    case kLoadOp | 1 << 2: step_at<kLoadOp, 1>(st, slot, w); break;
    case kLoadOp | 2 << 2: step_at<kLoadOp, 2>(st, slot, w); break;
    case kNot: step_at<kNot, 0>(st, slot, w); break;
    case kOp | 0 << 2: step_at<kOp, 0>(st, slot, w); break;
    case kOp | 1 << 2: step_at<kOp, 1>(st, slot, w); break;
    case kOp | 2 << 2: step_at<kOp, 2>(st, slot, w); break;
    default: break;
  }
}

}  // namespace

template <int D, int V>
__global__ void __launch_bounds__(kThreads)
planfuse_kernel(const uint32_t* __restrict__ x, long long n,
                const int* __restrict__ code, int code_len,
                const int* __restrict__ pushes, int n_push,
                uint32_t* __restrict__ r, int* __restrict__ kind,
                bool vec_out) {
  using R = Ring<V>;
  __shared__ int s_code[MAX_TAPE_LEN];
  __shared__ int s_push[MAX_TAPE_LEN];
  __shared__ __align__(16) uint32_t ring[R::kStages * R::kTile];

  for (int t = threadIdx.x; t < code_len; t += blockDim.x) s_code[t] = code[t];
  for (int t = threadIdx.x; t < n_push; t += blockDim.x) s_push[t] = pushes[t];
  __syncthreads();

  const int tid = threadIdx.x;
  const long long pos = static_cast<long long>(blockIdx.x) * R::kTile +
                        tid * V;
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(x) >> 2) & 3);
  uint32_t* mine = ring + tid * V;  // this thread's words of stage 0

  // The copy stream: this thread's words of every push in order, one
  // commit group a push (empty past the last push).
  int next = 0, fill = 0;
  auto issue = [&]() {
    if (next < n_push) {
      const long long base = static_cast<long long>(s_push[next++]) * n;
      uint32_t* dst = mine + fill * R::kTile;
      if (V == 4 && pos + 3 < n && ((mis + base) & 3) == 0) {
        copy16(dst, x + base + pos);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v)
          if (pos + v < n) copy4(dst + v, x + base + pos + v);
      }
    }
    commit();
    if (++fill == R::kStages) fill = 0;
  };
#pragma unroll 1
  for (int a = 0; a < R::kAhead; ++a) issue();

  uint32_t st[D][V];
  uint32_t w[V];
#pragma unroll
  for (int v = 0; v < V; ++v) w[v] = 0u;
#pragma unroll
  for (int d = 0; d < D; ++d)
#pragma unroll
    for (int v = 0; v < V; ++v) st[d][v] = 0u;
  int stage = 0;
#pragma unroll 1
  for (int i = 0; i < code_len; ++i) {
    const int ins = s_code[i];
    if ((ins & 3) <= kLoadOp) {
      issue();                   // kAhead + 1 pushes now pending
      wait_groups<R::kAhead>();  // so the oldest, this one, has landed
      const uint32_t* src = mine + stage * R::kTile;
      if constexpr (V == 4) {
        const uint4 u = *reinterpret_cast<const uint4*>(src);
        w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) w[v] = src[v];
      }
      if (++stage == R::kStages) stage = 0;
    }
    step<D, V>(st, ins, w);
  }

  if constexpr (V == 4) {
    if (vec_out && pos + 3 < n) {
      reinterpret_cast<uint4*>(r)[pos / 4] =
          make_uint4(st[0][0], st[0][1], st[0][2], st[0][3]);
      reinterpret_cast<int4*>(kind)[pos / 4] =
          make_int4(word_class(st[0][0]), word_class(st[0][1]),
                    word_class(st[0][2]), word_class(st[0][3]));
      return;
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    if (pos + v < n) {
      r[pos + v] = st[0][v];
      kind[pos + v] = word_class(st[0][v]);
    }
  }
}

namespace {

template <int D, int V>
void launch_dv(const uint32_t* x, long long n, const int* code, int code_len,
               const int* pushes, int n_push, uint32_t* r, int* kind,
               cudaStream_t stream) {
  const long long tiles = (n + Ring<V>::kTile - 1) / Ring<V>::kTile;
  // 16-byte stores when r and kind are 16-byte aligned (tiles start at a
  // multiple of 4 words)
  const bool vec_out = (reinterpret_cast<uintptr_t>(r) & 15) == 0 &&
                       (reinterpret_cast<uintptr_t>(kind) & 15) == 0;
  planfuse_kernel<D, V><<<static_cast<unsigned>(tiles), kThreads, 0,
                          stream>>>(x, n, code, code_len, pushes, n_push, r,
                                    kind, vec_out);
}

template <int V>
cudaError_t launch_v(int depth, const uint32_t* x, long long n,
                     const int* code, int code_len, const int* pushes,
                     int n_push, uint32_t* r, int* kind,
                     cudaStream_t stream) {
  switch (depth) {
    case 2:
      launch_dv<2, V>(x, n, code, code_len, pushes, n_push, r, kind, stream);
      break;
    case 4:
      launch_dv<4, V>(x, n, code, code_len, pushes, n_push, r, kind, stream);
      break;
    case 8:
      launch_dv<8, V>(x, n, code, code_len, pushes, n_push, r, kind, stream);
      break;
    case 16:
      launch_dv<16, V>(x, n, code, code_len, pushes, n_push, r, kind, stream);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// x: (m, n) words, 4-byte aligned; code (code_len,), pushes (n_push,)
// int32 on the device; depth: the register-stack class (2, 4, 8 or 16);
// r, kind: (n,).  The caller has split and checked the tape (slots below
// depth, plane ids below m).
REPRO_EXPORT int launch_planfuse(int device, const void* x, int m,
                                 long long n, const void* code, int code_len,
                                 const void* pushes, int n_push, int depth,
                                 void* r, void* kind, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (code_len < 1 || code_len > MAX_TAPE_LEN || n_push < 1 ||
      n_push > MAX_TAPE_LEN || m < 1 || n < 1 || n > (1LL << 31) ||
      (reinterpret_cast<uintptr_t>(x) & 3) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // words a thread: the most that still gives every SM two tiles
  const long long per_v = 2LL * sms * kThreads;
  const auto* xs = static_cast<const uint32_t*>(x);
  const auto* cs = static_cast<const int*>(code);
  const auto* ps = static_cast<const int*>(pushes);
  auto* rs = static_cast<uint32_t*>(r);
  auto* ks = static_cast<int*>(kind);
  auto st = static_cast<cudaStream_t>(stream);
  if (n >= 4 * per_v)
    err = launch_v<4>(depth, xs, n, cs, code_len, ps, n_push, rs, ks, st);
  else if (n >= 2 * per_v)
    err = launch_v<2>(depth, xs, n, cs, code_len, ps, n_push, rs, ks, st);
  else
    err = launch_v<1>(depth, xs, n, cs, code_len, ps, n_push, rs, ks, st);
  return static_cast<int>(err);
}
