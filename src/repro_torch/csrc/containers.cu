// containers: the two kernels of Roaring container operations.
//
// Replace the TPU kernels containerops_kernel and member_kernel
// (src/repro/kernels/containers.py).
//
// containerops_kernel: whole container folds in one launch.  Its unit is
// an output chunk: one (fold, chunk key) with its own left fold, a run of
// steps acc = acc <op> container (op 0 and, 1 or, 2 and-not; acc starts
// at 0).  A step names an array, bitmap or run container in compact form,
// or "absent", which reads as zero: that gives each op's short-circuit
// semantics without a branch.  The host (kernels/containers.py,
// pack_folds) uploads, once per call, a chunk table (out offset, words to
// write, first and last step), a step table (class | op << 2 | pool << 4,
// offset, length) and the payloads in flat pools: bitmap words, and
// array positions and run (start, end) pairs as uint16.  One block of 64
// threads takes one slice of 64 x V words of one output chunk, so a few
// chunks still fill the SMs; the accumulator lives in registers:
//
//   bitmap  16-byte loads (V = 4) of the slice's words;
//   array   the slice's positions, found by binary search (they are
//           sorted), scattered into a shared-memory slice with shared
//           atomics, then read back;
//   run     each thread finds the first run ending in its words by binary
//           search and ORs in the overlap of each run that follows.
//
// The block writes its slice of the fold's dense plane into the zeroed
// output.  Without a chunk table the kernel runs the pairwise form the
// TPU kernel computes (ops.container_pairs): chunk p is a[p] <op> b[p],
// two bitmap rows loaded at once, with no table to upload.
// Bound on the H100: bytes, the compact payload read once and the planes
// written once (pairs: read a and b, write out, 12 B a word), at 3.35 TB/s.
//
// member_kernel: the array-with-bitmap intersection of an "and" round,
// as the TPU kernel computes it: out = bit (pos & 31) of words[p][pos >> 5],
// 0 for padding (-1) and any position outside the row's W words.  It
// gathers the word that holds each position itself (the TPU wrapper
// gathers with take_along_axis before its kernel).  The one-launch fold
// does this work inside containerops_kernel, so only direct calls
// (ops.container_gallop) reach it.  Bound on the H100: bytes, 8 B a
// position (read the position, write the flag) plus each distinct word
// it touches read once, at 3.35 TB/s.  A block takes tiles of 1024
// positions of one row, 4 a thread: 16-byte position loads and flag
// stores where L % 4 == 0 and both pointers are aligned (else 4-byte
// ones, a warp's lanes on neighbouring positions), the tile's row found
// by one 32-bit division a tile, the 4 word gathers of a thread in
// flight at once through the read-only path; as many blocks as the SMs
// hold at once walk the tiles.
#include "common.cuh"

namespace {

constexpr int kFoldThreads = 64;
enum { kArray = 0, kBitmap = 1, kRun = 2, kAbsent = 3 };

__device__ __forceinline__ uint32_t container_op(int op, uint32_t a,
                                                 uint32_t b) {
  return op == 0 ? (a & b) : (op == 1 ? (a | b) : (a & ~b));
}

// First index in [0, n) whose value (at p[i * stride]) is >= key.
__device__ __forceinline__ int lower_bound(const uint16_t* p, int n,
                                           int stride, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (static_cast<int>(p[mid * stride]) < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// V words of a bitmap row from word w0 on (0 past the row's cw words); the
// launcher takes V = 4 only for 16-byte aligned rows.
template <int V>
__device__ __forceinline__ void load_bitmap(const uint32_t* row, int w0,
                                            int cw, uint32_t (&w)[V]) {
  if constexpr (V == 4) {
    if (w0 < cw) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(row + w0));
      w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
    }
  } else {
    if (w0 < cw) w[0] = __ldg(row + w0);
  }
}

// Bits lo..hi (0 <= lo <= hi <= 31) set.
__device__ __forceinline__ uint32_t bit_range(int lo, int hi) {
  return (0xFFFFFFFFu >> (31 - hi)) & (0xFFFFFFFFu << lo);
}

constexpr int kMemberThreads = 256;
constexpr int kMemberPer = 4;  // positions a thread takes from a tile
constexpr int kMemberTile = kMemberThreads * kMemberPer;

// Bit q of a W-word row (n_bits = 32 W); one unsigned compare rejects the
// -1 padding and positions past the row.
__device__ __forceinline__ uint32_t member_bit(const uint32_t* w,
                                               uint32_t n_bits, int q) {
  if (static_cast<uint32_t>(q) >= n_bits) return 0u;
  return (__ldg(w + (q >> 5)) >> (static_cast<uint32_t>(q) & 31u)) & 1u;
}

}  // namespace

template <int V>
__global__ void __launch_bounds__(kFoldThreads)
containerops_kernel(const int4* __restrict__ chunks,
                    const int4* __restrict__ steps, int cw, int pair_op,
                    const uint32_t* __restrict__ words0,
                    const uint32_t* __restrict__ words1,
                    const uint16_t* __restrict__ u16,
                    uint32_t* __restrict__ out) {
  constexpr int kSlice = kFoldThreads * V;
  __shared__ uint32_t s_bits[kSlice];
  const int slices = (cw + kSlice - 1) / kSlice;
  const int o = static_cast<int>(blockIdx.x / slices);
  const int s = static_cast<int>(blockIdx.x % slices);
  // pairs: no steps, the whole row written
  const int4 ch = chunks != nullptr ? chunks[o] : make_int4(0, cw, 0, 0);
  const long long out_at =
      chunks != nullptr ? ch.x : static_cast<long long>(o) * cw;
  const int w0 = s * kSlice + threadIdx.x * V;  // first word, in the chunk

  uint32_t acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0u;
  if (chunks == nullptr) {
    // pairs: a[o] op b[o], both loads in flight at once
    uint32_t b[V];
#pragma unroll
    for (int v = 0; v < V; ++v) b[v] = 0u;
    load_bitmap<V>(words0 + static_cast<long long>(o) * cw, w0, cw, acc);
    load_bitmap<V>(words1 + static_cast<long long>(o) * cw, w0, cw, b);
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = container_op(pair_op, acc[v], b[v]);
  }
#pragma unroll 1
  for (int i = ch.z; i < ch.w; ++i) {
    const int4 sp = steps[i];
    const int cls = sp.x & 3;
    const int op = (sp.x >> 2) & 3;
    uint32_t w[V];
#pragma unroll
    for (int v = 0; v < V; ++v) w[v] = 0u;
    if (cls == kBitmap) {
      load_bitmap<V>(((sp.x >> 4) & 1 ? words1 : words0) + sp.y, w0, cw, w);
    } else if (cls == kArray) {
      // block-uniform branch: every thread of the block takes it
      for (int j = threadIdx.x; j < kSlice; j += kFoldThreads) s_bits[j] = 0u;
      __syncthreads();
      const uint16_t* pos = u16 + sp.y;
      const int lo_bit = s * kSlice * 32;
      const int b = lower_bound(pos, sp.z, 1, lo_bit);
      const int e = lower_bound(pos, sp.z, 1, lo_bit + kSlice * 32);
      for (int j = b + threadIdx.x; j < e; j += kFoldThreads) {
        const int q = static_cast<int>(pos[j]) - lo_bit;
        atomicOr(&s_bits[q >> 5], 1u << (q & 31));
      }
      __syncthreads();
#pragma unroll
      for (int v = 0; v < V; ++v) w[v] = s_bits[threadIdx.x * V + v];
      __syncthreads();  // before the next array step clears the slice
    } else if (cls == kRun) {
      const uint16_t* runs = u16 + sp.y;  // (start, end) pairs, inclusive
      const int first = w0 * 32, last = (w0 + V) * 32 - 1;
      for (int j = lower_bound(runs + 1, sp.z, 2, first);
           j < sp.z && static_cast<int>(runs[2 * j]) <= last; ++j) {
        const int a = runs[2 * j], z = runs[2 * j + 1];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int wb = first + 32 * v;
          const int lo = a > wb ? a : wb;
          const int hi = z < wb + 31 ? z : wb + 31;
          if (lo <= hi) w[v] |= bit_range(lo - wb, hi - wb);
        }
      }
    }  // kAbsent: w stays 0
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = container_op(op, acc[v], w[v]);
  }

  uint32_t* dst = out + out_at + w0;
  if constexpr (V == 4) {
    // a fold's plane may start off a 16-byte boundary (W % 4 != 0)
    if (w0 + 3 < ch.y && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(acc[0], acc[1], acc[2], acc[3]);
      return;
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v)
    if (w0 + v < ch.y) dst[v] = acc[v];
}

__global__ void __launch_bounds__(kMemberThreads)
member_kernel(int n_tiles, int tiles_per_row, int L, int vec,
              const int* __restrict__ pos, const uint32_t* __restrict__ words,
              int W, uint32_t* __restrict__ out) {
  const uint32_t n_bits = static_cast<uint32_t>(W) * 32u;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int row = t / tiles_per_row;
    const int base = (t - row * tiles_per_row) * kMemberTile;
    const long long at = static_cast<long long>(row) * L;
    const uint32_t* w = words + static_cast<long long>(row) * W;
    int q[kMemberPer];
    uint32_t hit[kMemberPer];
    if (vec) {
      // L % 4 == 0: a thread's 4 positions lie in the row, 16-byte aligned
      const int j = base + threadIdx.x * kMemberPer;
      if (j >= L) continue;
      const int4 u = __ldg(reinterpret_cast<const int4*>(pos + at + j));
      q[0] = u.x; q[1] = u.y; q[2] = u.z; q[3] = u.w;
#pragma unroll
      for (int v = 0; v < kMemberPer; ++v) hit[v] = member_bit(w, n_bits, q[v]);
      *reinterpret_cast<uint4*>(out + at + j) =
          make_uint4(hit[0], hit[1], hit[2], hit[3]);
    } else {
#pragma unroll
      for (int v = 0; v < kMemberPer; ++v) {
        const int j = base + v * kMemberThreads + threadIdx.x;
        q[v] = j < L ? __ldg(pos + at + j) : -1;
      }
#pragma unroll
      for (int v = 0; v < kMemberPer; ++v) hit[v] = member_bit(w, n_bits, q[v]);
#pragma unroll
      for (int v = 0; v < kMemberPer; ++v) {
        const int j = base + v * kMemberThreads + threadIdx.x;
        if (j < L) out[at + j] = hit[v];
      }
    }
  }
}

// Fold form: chunks (n_chunks, 4) and steps (n_steps, 4) int32 tables,
// words0 the bitmap pool (words1 unused: pass the same pointer), u16 the
// array and run pool, out the zeroed planes.  Pairs form: chunks and
// steps null, n_chunks = P pairs of cw-word rows a (words0) and b
// (words1), op pair_op, out (P, cw).  The caller has checked the tables.
REPRO_EXPORT int launch_containerops(int device, const void* chunks,
                                     const void* steps, int n_chunks, int cw,
                                     int pair_op, const void* words0,
                                     const void* words1, const void* u16,
                                     void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_chunks < 1 || cw < 1 || pair_op < 0 || pair_op > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte loads when every bitmap row is whole 16-byte vectors (the
  // fold form's pool offsets are multiples of 2048 words)
  const bool vec = cw % 4 == 0 && aligned16(words0) && aligned16(words1);
  const int slice = kFoldThreads * (vec ? 4 : 1);
  const long long blocks =
      static_cast<long long>(n_chunks) * ((cw + slice - 1) / slice);
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const int4*>(chunks);
  const auto* s = static_cast<const int4*>(steps);
  const auto* a = static_cast<const uint32_t*>(words0);
  const auto* b = static_cast<const uint32_t*>(words1);
  const auto* u = static_cast<const uint16_t*>(u16);
  auto* o = static_cast<uint32_t*>(out);
  if (vec)
    containerops_kernel<4><<<static_cast<unsigned>(blocks), kFoldThreads, 0,
                             st>>>(c, s, cw, pair_op, a, b, u, o);
  else
    containerops_kernel<1><<<static_cast<unsigned>(blocks), kFoldThreads, 0,
                             st>>>(c, s, cw, pair_op, a, b, u, o);
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT int launch_member(int device, const void* pos, long long P,
                               int L, const void* words, int W, void* out,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (P <= 0 || L <= 0 || W <= 0 || W > (1 << 26))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long per_row = (L + kMemberTile - 1) / kMemberTile;
  const long long n_tiles = P * per_row;
  if (n_tiles > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  // blocks the SMs hold at once (every card this runs on is one model)
  static long long resident = 0;
  if (resident == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, member_kernel, kMemberThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    resident = static_cast<long long>(sms) * (per_sm < 1 ? 1 : per_sm);
  }
  const long long blocks = n_tiles < resident ? n_tiles : resident;
  const int vec = L % 4 == 0 && aligned16(pos) && aligned16(out);
  member_kernel<<<static_cast<unsigned>(blocks), kMemberThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<int>(n_tiles), static_cast<int>(per_row), L, vec,
      static_cast<const int*>(pos), static_cast<const uint32_t*>(words), W,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
