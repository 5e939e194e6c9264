// ewah_and_popcount: popcount(A AND B) over a batch of EWAH stream pairs,
// with the number of steps the dual-cursor walk takes.
//
// Not a port of a TPU kernel: it takes over from the reference's in-graph
// walk, a lax.while_loop (src/repro/core/ewah_stream.py and_popcount).
// Each step consumes an overlap of two clean runs, one dirty word against
// a clean word, or two dirty words, then reloads a cursor whose counts
// both reached 0 from its next marker; the walk ends when either stream
// is exhausted, when a marker with no clean and no dirty word is loaded,
// or after (array size of A) + (array size of B) + 4 steps.  Reads clamp
// to a pair's own array size, as the reference clamps to its arrays'.
//
// Bound on the H100: bytes, each stream word read once and two int32
// written a pair, at 3.35 TB/s.  Two routes, chosen by the host from the
// padded row widths (kernels/ewah_and_popcount.py):
//
// Short rows: ewah_and_popcount_kernel, one thread walks one pair.  Where
// a pair holds a few dozen words the walk is launch-sized and one launch
// is all the work.
//
// Wide rows: the walk's result is a sum over the words of the pair, so no
// pair's walk runs serially.  For a well-formed pair (length <= array size
// for both streams and no marker's dirty run past the length, so the step
// cap cannot bind), with W_X a stream's word total up to its first empty
// marker and W = min(W_A, W_B):
//   count      = sum over words p < W of popcount(a_p & b_p), a clean word
//                being its fill (mod 2^32, as the reference's int32 wraps);
//   iterations = #{p < W: a_p or b_p dirty}
//              + #{p < W: both clean, and A or B starts a marker's clean
//                 run at p}.
// The second term counts the walk's clean-overlap steps: an overlap step
// ends where either clean run ends, and a run that ends is followed by a
// dirty word, the walk's end, or the next marker's clean run; so every
// maximal stretch of clean-against-clean words the walk takes in one step
// begins at a clean-run start of A or of B.  The cap cannot bind since
// iterations <= len_A + len_B.  Two launches:
//
// 1. ewah_pair_chain_kernel resolves each stream's marker chain, one block
//    a stream (2B blocks), in super-windows of 8192 positions: every
//    position's exit from its 32-position window by shuffles
//    (ewah_chain.cuh, shared with ewah_decode), exits from 1024-position
//    windows by pointer jumping in shared memory (a thread's 16 jumps
//    gathered before any is stored), a walk of 8 exits from the chain
//    position carried in, and 32 steps down each 1024-window; then the
//    markers (the positions each window's entry reaches) and the words
//    each covers, summed 16 consecutive positions a thread for a block
//    scan of offsets (saturated at n_words) and ranks.  It reads each
//    word once, the next super-window's words in flight while this one
//    resolves, and writes the table decode's ewah_markers writes
//    ((position, offset) of the markers whose offset is below n_words),
//    their words, for every tile of AP_TILE positions the marker whose
//    span holds its first position, and the stream's W (n_words where the
//    table is cut), its table count and whether a dirty run passes its
//    length.  ewah_decode's cluster resolution takes one stream a cluster
//    and keeps its levels in device memory past 32,768 words; a block a
//    stream, all streams at once, suits a batch of long streams, but a
//    stream's super-windows follow one another on one SM, each a chain of
//    barrier-separated stages, so this phase is bound by that latency and
//    not by the card's bytes (PERF.md).
// 2. ewah_pair_tiles_kernel takes one block a (pair, side, tile of
//    AP_TILE stream positions): the tile's markers from the table, the
//    other stream's markers over the tile's logical words by a 32-ary
//    warp search, both staged in shared memory, then 8 consecutive
//    positions a thread:
//    - a dirty word of A at p < W: one step; popcount(a & b) with b the
//      word of B at p (its fill when clean);
//    - a dirty word of B at p < W where A is clean: one step; popcount(b)
//      where A's fill is 1;
//    - a marker whose clean run starts at o < W where the other stream is
//      clean: one step, and 32 a word of the two runs' overlap where both
//      fills are 1, counted on the side whose run starts later (A's on a
//      tie), so each overlap counts once.
//    Only the words that can set bits are read.  Warp shuffles reduce a
//    thread's count and steps, and one atomic a block adds them to the
//    pair's.  The work follows the stream positions, O(|A| + |B|) as the
//    paper's section 3 states, not the uncompressed words.
//    A pair that is not well formed, or whose W reaches n_words, is an
//    edge pair: the block of its first A tile walks it with the serial
//    walk on one thread and stores its result.
#include "ewah_chain.cuh"

#define AP_TILE 2048      // stream positions a tile of the second phase
#define CH_THREADS 512
#define CH_PER 16         // windows of 32 positions a warp (<= 16)
#define CH_SW (CH_THREADS * CH_PER)  // positions a super-window
#define CH_WIN (CH_SW / 32)
#define CH_W2 (CH_SW / 1024)
#define TL_THREADS 256
#define TL_PER (AP_TILE / TL_THREADS)  // consecutive positions a thread
#define TL_XCAP (AP_TILE + 2)
#define TL_YCAP 1024

namespace {

using ewah_chain::block_exclusive_scan;
using ewah_chain::cdiv;
using ewah_chain::clamp_len;
using ewah_chain::window_exit;

struct Cursor {
  int i;  // next word of the stream
  int c;  // clean words left in the current marker's run
  int t;  // the run's type: 1 all ones, 0 all zeros
  int d;  // dirty words left after the clean run
};

__device__ __forceinline__ uint32_t word_at(const uint32_t* s, int i,
                                            int size) {
  return size > 0 ? __ldg(s + min(i, size - 1)) : 0u;
}

__device__ __forceinline__ void load(const uint32_t* s, int len, int size,
                                     Cursor& k) {
  if (k.c == 0 && k.d == 0 && k.i < len) {
    const uint32_t w = word_at(s, k.i, size);
    k.i += 1;
    k.t = static_cast<int>((w >> 31) & 1u);
    k.c = static_cast<int>((w >> 15) & 0xFFFFu);
    k.d = static_cast<int>(w & 0x7FFFu);
  }
}

// The reference's walk of one pair on one thread.
__device__ void walk_pair(const uint32_t* a, int len_a, int size_a,
                          const uint32_t* b, int len_b, int size_b,
                          int* count, int* iters) {
  const long long cap = static_cast<long long>(size_a) + size_b + 4;
  Cursor x{0, 0, 0, 0}, y{0, 0, 0, 0};
  load(a, len_a, size_a, x);
  load(b, len_b, size_b, y);
  uint32_t acc = 0;  // wraps as the reference's int32 sum does
  int it = 0;
  while ((x.c > 0 || x.d > 0) && (y.c > 0 || y.d > 0) && it < cap) {
    if (x.c > 0 && y.c > 0) {  // two clean runs: take their overlap
      const int n = max(min(x.c, y.c), 1);
      if (x.t & y.t) acc += static_cast<uint32_t>(n) * 32u;
      x.c -= n;
      y.c -= n;
    } else if (x.c > 0) {  // clean A, one dirty word of B
      if (x.t) acc += __popc(word_at(b, y.i, size_b));
      x.c -= 1;
      y.i += 1;
      y.d -= 1;
    } else if (y.c > 0) {  // one dirty word of A, clean B
      if (y.t) acc += __popc(word_at(a, x.i, size_a));
      y.c -= 1;
      x.i += 1;
      x.d -= 1;
    } else {  // two dirty words
      acc += __popc(word_at(a, x.i, size_a) & word_at(b, y.i, size_b));
      x.i += 1;
      x.d -= 1;
      y.i += 1;
      y.d -= 1;
    }
    load(a, len_a, size_a, x);
    load(b, len_b, size_b, y);
    ++it;
  }
  *count = static_cast<int>(acc);
  *iters = it;
}

__global__ void __launch_bounds__(128)
ewah_and_popcount_kernel(int B, const uint32_t* __restrict__ sa, int ca,
                         const int* __restrict__ la,
                         const int* __restrict__ na,
                         const uint32_t* __restrict__ sb, int cb,
                         const int* __restrict__ lb,
                         const int* __restrict__ nb, int* __restrict__ count,
                         int* __restrict__ iters) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= B) return;
  walk_pair(sa + static_cast<long long>(p) * ca, la[p], min(na[p], ca),
            sb + static_cast<long long>(p) * cb, lb[p], min(nb[p], cb),
            count + p, iters + p);
}

// One side (A or B) of a batch and its marker table.
struct Side {
  const uint32_t* s;  // (B, C) streams
  int C;
  const int* len;     // (B,) lengths
  int2* tab;          // (B, C): (position, offset) of the table's markers
  uint32_t* wtab;     // (B, C): their words
  int* meta;          // (B, 3): table count, W, a dirty run past the length
  int* ptile;         // (B, n_tiles): the marker holding each tile's start
  int n_tiles;        // cdiv(C, AP_TILE)
};

__global__ void __launch_bounds__(CH_THREADS, 1)
ewah_pair_chain_kernel(int B, Side sa, Side sb, int n_words) {
  // E_1 and E_2 (1024-windows) of each position, minus q0; then the words
  // each position covers as a marker (0 elsewhere)
  __shared__ __align__(16) uint32_t s_buf[CH_SW];
  uint16_t* const e1 = reinterpret_cast<uint16_t*>(s_buf);
  uint16_t* const e2 = e1 + CH_SW;
  int* const cbuf = reinterpret_cast<int*>(s_buf);
  __shared__ int ent1[CH_WIN];    // first marker of each 32-window, or -1
  __shared__ int ent2[CH_W2];
  __shared__ uint32_t s_R[CH_WIN];  // the markers of each 32-window
  __shared__ int s_sum[32], s_cnt[32];
  __shared__ int s_x, s_empty, s_bad, s_ntab, s_cover;

  const bool on_b = blockIdx.x >= static_cast<unsigned>(B);
  const Side X = on_b ? sb : sa;
  const int row = on_b ? blockIdx.x - B : blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t* __restrict__ s = X.s + static_cast<long long>(row) * X.C;
  const int len = clamp_len(X.len, row, X.C);
  int2* __restrict__ tab = X.tab + static_cast<long long>(row) * X.C;
  uint32_t* __restrict__ wtab = X.wtab + static_cast<long long>(row) * X.C;
  int* __restrict__ ptile = X.ptile + static_cast<long long>(row) * X.n_tiles;
  if (tid == 0) {
    s_empty = 0x7FFFFFFF;
    s_bad = 0;
    s_ntab = 0;
    s_cover = 0;
  }

  // warp w owns the 32-windows 16w .. 16w + 15 of a super-window
  const int wbase = warp * CH_PER * 32;
  uint32_t cur[CH_PER], nxt[CH_PER];
  int nq = -1;  // the super-window nxt holds
  int x = 0;    // the chain's first position at or past q0
  int base_off = 0, base_rank = 0;
  while (x < len && base_off < n_words) {
    const int q0 = x & ~(CH_SW - 1);  // skips super-windows with no marker
    if (q0 == nq) {
#pragma unroll
      for (int u = 0; u < CH_PER; ++u) cur[u] = nxt[u];
    } else {
#pragma unroll
      for (int u = 0; u < CH_PER; ++u) {
        const int pos = q0 + wbase + u * 32 + lane;
        cur[u] = pos < len ? __ldg(s + pos) : 0u;
      }
    }
    nq = q0 + CH_SW;
#pragma unroll
    for (int u = 0; u < CH_PER; ++u) {  // in flight while this one resolves
      const int pos = nq + wbase + u * 32 + lane;
      nxt[u] = pos < len ? __ldg(s + pos) : 0u;
    }

    // E_1 and the window positions each chain visits
    uint32_t reach[CH_PER];
#pragma unroll
    for (int u = 0; u < CH_PER; ++u) {
      const int wb = q0 + wbase + u * 32;
      const int pos = wb + lane;
      reach[u] = 1u << lane;
      const int J = window_exit<true>(
          pos < len ? min(pos + 1 + static_cast<int>(cur[u] & 0x7FFFu), len)
                    : len,
          wb, min(wb + 32, len), reach[u]);
      e1[wbase + u * 32 + lane] = static_cast<uint16_t>(J - q0);  // < 40,960
    }
    __syncthreads();

    // E_2 by pointer jumping inside 1024-windows, in place after the first
    // round (a jump through an entry already updated is a longer correct
    // jump); a thread's CH_PER jumps are gathered before any is stored
    const int lenr = len - q0;
    int live = 0;
    {
      int j[CH_PER];
#pragma unroll
      for (int k = 0; k < CH_PER; ++k) j[k] = e1[tid + k * CH_THREADS];
#pragma unroll
      for (int k = 0; k < CH_PER; ++k) {
        const int i = tid + k * CH_THREADS;
        const int end = min(((i >> 10) + 1) << 10, lenr);
        if (j[k] < end) j[k] = e1[j[k]];
      }
#pragma unroll
      for (int k = 0; k < CH_PER; ++k) {
        const int i = tid + k * CH_THREADS;
        live |= j[k] < min(((i >> 10) + 1) << 10, lenr);
        e2[i] = static_cast<uint16_t>(j[k]);
      }
    }
    while (__syncthreads_or(live)) {
      live = 0;
      int j[CH_PER];
#pragma unroll
      for (int k = 0; k < CH_PER; ++k) j[k] = e2[tid + k * CH_THREADS];
#pragma unroll
      for (int k = 0; k < CH_PER; ++k) {
        const int i = tid + k * CH_THREADS;
        const int end = min(((i >> 10) + 1) << 10, lenr);
        if (j[k] < end) {
          j[k] = e2[j[k]];
          live |= j[k] < end;
        }
      }
#pragma unroll
      for (int k = 0; k < CH_PER; ++k)
        e2[tid + k * CH_THREADS] = static_cast<uint16_t>(j[k]);
    }

    // the walk over the 1024-windows' exits, then down each of them
    if (tid == 0) {
      int y = x - q0;
      for (int w2 = 0; w2 < CH_W2; ++w2) {
        const bool in = y < ((w2 + 1) << 10) && y < lenr;
        ent2[w2] = in ? y : -1;
        if (in) y = e2[y];
      }
      s_x = q0 + y;
    }
    __syncthreads();
    if (tid < CH_W2) {
      int y = ent2[tid];
      for (int w1 = tid * 32; w1 < (tid + 1) * 32; ++w1) {
        const bool in = y >= 0 && y < ((w1 + 1) << 5) && y < lenr;
        ent1[w1] = in ? y : -1;
        if (in) y = e1[y];
      }
    }
    __syncthreads();

    // the markers of each window and the words each covers, into cbuf
    // (e1 and e2 are free: the walks are done)
#pragma unroll
    for (int u = 0; u < CH_PER; ++u) {
      const int wi = (wbase >> 5) + u;
      const int en = ent1[wi];
      const uint32_t rr = __shfl_sync(0xFFFFFFFFu, reach[u],
                                      en >= 0 ? en - (wi << 5) : 0);
      const uint32_t R = en >= 0 ? rr : 0u;
      if (lane == 0) s_R[wi] = R;
      const int pos = q0 + (wi << 5) + lane;
      const int nd = static_cast<int>(cur[u] & 0x7FFFu);
      const int avail = len - pos - 1;
      cbuf[(wi << 5) + lane] =
          (R >> lane) & 1u
              ? static_cast<int>((cur[u] >> 15) & 0xFFFFu) +
                    (nd < avail ? nd : avail)
              : 0;
    }
    __syncthreads();

    // offsets and ranks: thread t sums the CH_PER positions from t * CH_PER
    // (read in a rotated order, so a warp's reads hit distinct banks), then
    // a block scan, then it writes its markers' table entries
    const int first = tid * CH_PER;
    const uint32_t bits =
        (s_R[first >> 5] >> (first & 31)) & ((1u << CH_PER) - 1u);
    int my_sum = 0, my_cnt = __popc(bits);
#pragma unroll
    for (int k = 0; k < CH_PER; ++k)  // <= 16 * 98,302
      my_sum += cbuf[first + ((k + (first >> 5)) & (CH_PER - 1))];
    my_sum = min(my_sum, n_words);
    const int2 tot = block_exclusive_scan(my_sum, my_cnt, n_words, s_sum,
                                          s_cnt);
    int empty = 0x7FFFFFFF, bad = 0, ntab = 0, cover = 0;
    int run = min(base_off + my_sum, n_words), rk = base_rank + my_cnt;
    for (uint32_t b = bits; b; b &= b - 1, ++rk) {
      const int pos = q0 + first + __ffs(b) - 1;
      const int c = cbuf[pos - q0];
      const int off = run;
      run = min(run + c, n_words);
      if (off >= n_words) break;
      const uint32_t w = __ldg(s + pos);
      const int nc = static_cast<int>((w >> 15) & 0xFFFFu);
      const int nd = static_cast<int>(w & 0x7FFFu);
      const int span_end = pos + 1 + c - nc;
      tab[rk] = make_int2(pos, off);
      wtab[rk] = w;
      for (int t = cdiv(pos, AP_TILE); t * AP_TILE < span_end; ++t)
        ptile[t] = rk;
      if (nc == 0 && nd == 0) empty = min(empty, off);
      bad |= nd > len - pos - 1;
      ntab = rk + 1;
      cover = span_end;
    }
    empty = static_cast<int>(__reduce_min_sync(0xFFFFFFFFu,
                                               static_cast<unsigned>(empty)));
    bad = __any_sync(0xFFFFFFFFu, bad);
    ntab = static_cast<int>(__reduce_max_sync(0xFFFFFFFFu,
                                              static_cast<unsigned>(ntab)));
    cover = static_cast<int>(__reduce_max_sync(0xFFFFFFFFu,
                                               static_cast<unsigned>(cover)));
    if (lane == 0) {
      if (empty != 0x7FFFFFFF) atomicMin(&s_empty, empty);
      if (bad) s_bad = 1;
      if (ntab) {
        atomicMax(&s_ntab, ntab);
        atomicMax(&s_cover, cover);
      }
    }
    base_off = min(base_off + tot.x, n_words);
    base_rank += tot.y;
    x = s_x;
    __syncthreads();  // s_x, ent1, ent2 and e1 / e2 are free again
  }
  __syncthreads();
  for (int t = cdiv(s_cover, AP_TILE) + tid; t < X.n_tiles; t += CH_THREADS)
    ptile[t] = -1;
  if (tid == 0) {
    int* meta = X.meta + 3LL * row;
    meta[0] = s_ntab;
    // W; n_words where the table is cut (the stream covers that many)
    meta[1] = base_off < n_words ? min(s_empty, base_off) : n_words;
    meta[2] = s_bad;
  }
}

// Table helpers of the second phase: a marker as (position, offset, word).
struct Mk {
  int pos, off;
  uint32_t w;
  __device__ __forceinline__ int nc() const {
    return static_cast<int>((w >> 15) & 0xFFFFu);
  }
  __device__ __forceinline__ int nd() const {
    return static_cast<int>(w & 0x7FFFu);
  }
  __device__ __forceinline__ bool ones() const { return (w >> 31) != 0u; }
};

// The numbers of table entries [0, n) whose offset is <= v0 and <= v1
// (offsets do not decrease), by one warp: 32 probes a value a round, the
// two searches' loads in flight together.
__device__ int2 warp_upper_bounds(const int2* __restrict__ tab, int n,
                                  int v0, int v1) {
  const int lane = threadIdx.x & 31;
  int lo[2] = {0, 0}, hi[2] = {n, n};
  const int v[2] = {v0, v1};
  while (hi[0] - lo[0] > 32 || hi[1] - lo[1] > 32) {
    int step[2];
    bool ok[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      step[s] = cdiv(hi[s] - lo[s], 32);
      const int k = lo[s] + lane * step[s];
      ok[s] = hi[s] - lo[s] > 32 && k < hi[s] && __ldg(&tab[k].y) <= v[s];
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (hi[s] - lo[s] <= 32) continue;  // uniform in the warp
      const int cnt = __popc(__ballot_sync(0xFFFFFFFFu, ok[s]));
      if (cnt == 0) {
        hi[s] = lo[s];
      } else {
        const int nlo = lo[s] + (cnt - 1) * step[s] + 1;
        hi[s] = min(lo[s] + cnt * step[s], hi[s]);
        lo[s] = nlo;
      }
    }
  }
  bool ok[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int k = lo[s] + lane;
    ok[s] = k < hi[s] && __ldg(&tab[k].y) <= v[s];
  }
  return make_int2(lo[0] + __popc(__ballot_sync(0xFFFFFFFFu, ok[0])),
                   lo[1] + __popc(__ballot_sync(0xFFFFFFFFu, ok[1])));
}

__global__ void __launch_bounds__(TL_THREADS)
ewah_pair_tiles_kernel(int B, Side sa, const int* __restrict__ na, Side sb,
                       const int* __restrict__ nb, int n_words,
                       uint32_t* __restrict__ count, int* __restrict__ iters) {
  __shared__ int xs_pos[TL_XCAP], xs_off[TL_XCAP];
  __shared__ uint32_t xs_w[TL_XCAP];
  __shared__ int ys_pos[TL_YCAP], ys_off[TL_YCAP];
  __shared__ uint32_t ys_w[TL_YCAP];
  // W, len of this side, k0, n of x, m0, n of y, edge, work
  __shared__ int s_info[8];
  __shared__ uint32_t s_acc[TL_THREADS / 32];
  __shared__ int s_steps[TL_THREADS / 32];

  const int per = sa.n_tiles + sb.n_tiles;
  const int p = blockIdx.x / per;
  const int j = blockIdx.x % per;
  const int side = j >= sa.n_tiles;  // 1: the tile is B's
  const int t = side ? j - sa.n_tiles : j;
  const Side X = side ? sb : sa;
  const Side Y = side ? sa : sb;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t* __restrict__ sx = X.s + static_cast<long long>(p) * X.C;
  const uint32_t* __restrict__ sy = Y.s + static_cast<long long>(p) * Y.C;
  const int2* __restrict__ tx = X.tab + static_cast<long long>(p) * X.C;
  const int2* __restrict__ ty = Y.tab + static_cast<long long>(p) * Y.C;
  const uint32_t* __restrict__ wx = X.wtab + static_cast<long long>(p) * X.C;
  const uint32_t* __restrict__ wy = Y.wtab + static_cast<long long>(p) * Y.C;

  if (warp == 0) {
    const int* ma = sa.meta + 3LL * p;
    const int* mb = sb.meta + 3LL * p;
    const int* pt = X.ptile + static_cast<long long>(p) * X.n_tiles;
    const int pt0 = pt[t], pt1 = t + 1 < X.n_tiles ? pt[t + 1] : -1;
    const int la = sa.len[p], lb = sb.len[p];
    const int wa = ma[1], wb = mb[1];
    const bool edge = la > min(na[p], sa.C) || lb > min(nb[p], sb.C) ||
                      ma[2] || mb[2] || wa >= n_words || wb >= n_words;
    const int W = min(wa, wb);
    const int lenx = max(side ? lb : la, 0);
    const int i0 = t * AP_TILE;
    int work = !edge && W > 0 && i0 < lenx;
    int k0 = 0, nxs = 0, m0 = 0, nys = 0;
    if (work) {
      // a well-formed stream's table covers every tile below its length
      k0 = pt0;
      const int k1 =
          (t + 1) * AP_TILE < lenx ? pt1 : (side ? mb[0] : ma[0]) - 1;
      nxs = k1 - k0 + 1;
      const int2 e0 = tx[k0], e1 = tx[k1];
      const Mk f{e0.x, e0.y, wx[k0]}, l{e1.x, e1.y, wx[k1]};
      // the tile's logical words [L0, L1): no position of the tile lies
      // below L0, and L1 is the end of its last marker's span
      const int L0 =
          i0 == f.pos ? f.off : f.off + f.nc() + (i0 - f.pos - 1);
      const int L1 = min(W, l.off + l.nc() + l.nd());
      work = L0 < W;
      if (work) {
        const int2 u =
            warp_upper_bounds(ty, side ? ma[0] : mb[0], L0, L1 - 1);
        m0 = u.x - 1;
        nys = u.y - m0;
      }
    }
    if (lane == 0) {
      s_info[0] = W;
      s_info[1] = lenx;
      s_info[2] = k0;
      s_info[3] = nxs;
      s_info[4] = m0;
      s_info[5] = nys;
      s_info[6] = edge;
      s_info[7] = work;
    }
  }
  __syncthreads();
  if (s_info[6]) {  // an edge pair: its first A tile walks it
    if (side == 0 && t == 0 && tid == 0)
      walk_pair(sa.s + static_cast<long long>(p) * sa.C, sa.len[p],
                min(na[p], sa.C), sb.s + static_cast<long long>(p) * sb.C,
                sb.len[p], min(nb[p], sb.C),
                reinterpret_cast<int*>(count) + p, iters + p);
    return;
  }
  if (!s_info[7]) return;
  const int W = s_info[0], lenx = s_info[1], k0 = s_info[2];
  const int nxs = s_info[3], m0 = s_info[4], nys = s_info[5];
  const bool staged = nys <= TL_YCAP;  // else Y's lookups search its table
  for (int k = tid; k < nxs; k += TL_THREADS) {
    const int2 e = tx[k0 + k];
    xs_pos[k] = e.x;
    xs_off[k] = e.y;
    xs_w[k] = wx[k0 + k];
  }
  if (staged) {
    for (int k = tid; k < nys; k += TL_THREADS) {
      const int2 e = ty[m0 + k];
      ys_pos[k] = e.x;
      ys_off[k] = e.y;
      ys_w[k] = wy[m0 + k];
    }
  }
  __syncthreads();

  const int i_first = t * AP_TILE + tid * TL_PER;
  const int i_end = min(t * AP_TILE + AP_TILE, lenx);
  uint32_t acc = 0;
  int steps = 0;
  int lx[TL_PER], ly[TL_PER];  // words to read: X's (-1 none), Y's (-1: ~0)
  // the X marker of the first position: the last staged one at or before it
  int kx = 0;
  {
    int a = 0, z = nxs - 1;
    while (a < z) {
      const int mid = (a + z + 1) >> 1;
      if (xs_pos[mid] <= i_first) a = mid; else z = mid - 1;
    }
    kx = a;
  }
  int ky = -1;
  // Y's marker holding logical word v (the last with offset <= v); v does
  // not decrease from call to call
  auto find_y = [&](int v) -> Mk {
    if (staged) {
      if (ky < 0) {
        int a = 0, z = nys - 1;
        while (a < z) {
          const int mid = (a + z + 1) >> 1;
          if (ys_off[mid] <= v) a = mid; else z = mid - 1;
        }
        ky = a;
      }
      while (ky + 1 < nys && ys_off[ky + 1] <= v) ++ky;
      return Mk{ys_pos[ky], ys_off[ky], ys_w[ky]};
    }
    int a = m0, z = m0 + nys - 1;
    while (a < z) {
      const int mid = (a + z + 1) >> 1;
      if (__ldg(&ty[mid].y) <= v) a = mid; else z = mid - 1;
    }
    const int2 e = ty[a];
    return Mk{e.x, e.y, __ldg(wy + a)};
  };
#pragma unroll
  for (int u = 0; u < TL_PER; ++u) {
    lx[u] = -1;
    ly[u] = -1;
    const int i = i_first + u;
    if (i >= i_end) continue;
    while (kx + 1 < nxs && xs_pos[kx + 1] <= i) ++kx;
    const Mk m{xs_pos[kx], xs_off[kx], xs_w[kx]};
    if (i == m.pos) {  // a marker: its clean run, if any
      const int o = m.off;
      if (m.nc() > 0 && o < W) {
        const Mk y = find_y(o);
        if (o < y.off + y.nc() && (side == 0 || y.off < o)) {
          ++steps;
          if (m.ones() && y.ones())
            acc += 32u * static_cast<uint32_t>(
                             min(min(o + m.nc(), y.off + y.nc()), W) - o);
        }
      }
    } else {  // a dirty word
      const int q = m.off + m.nc() + (i - m.pos - 1);
      if (q < W) {
        const Mk y = find_y(q);
        if (q < y.off + y.nc()) {  // the other stream is clean
          ++steps;
          if (y.ones()) lx[u] = i;
        } else if (side == 0) {  // two dirty words, counted on A's side
          ++steps;
          lx[u] = i;
          ly[u] = y.pos + 1 + (q - y.off - y.nc());
        }
      }
    }
  }
  uint32_t vx[TL_PER], vy[TL_PER];
#pragma unroll
  for (int u = 0; u < TL_PER; ++u) {
    vx[u] = lx[u] >= 0 ? __ldg(sx + lx[u]) : 0u;
    vy[u] = ly[u] >= 0 ? __ldg(sy + ly[u]) : 0xFFFFFFFFu;
  }
#pragma unroll
  for (int u = 0; u < TL_PER; ++u) acc += __popc(vx[u] & vy[u]);

  acc = __reduce_add_sync(0xFFFFFFFFu, acc);
  steps = static_cast<int>(
      __reduce_add_sync(0xFFFFFFFFu, static_cast<unsigned>(steps)));
  if (lane == 0) {
    s_acc[warp] = acc;
    s_steps[warp] = steps;
  }
  __syncthreads();
  if (tid == 0) {
    uint32_t a = 0;
    int n = 0;
    for (int k = 0; k < TL_THREADS / 32; ++k) {
      a += s_acc[k];
      n += s_steps[k];
    }
    if (a) atomicAdd(count + p, a);
    if (n) atomicAdd(iters + p, n);
  }
}

bool side_ok(int C, int n_tiles) {
  return C >= 1 && C < (1 << 30) && n_tiles == cdiv(C, AP_TILE);
}

}  // namespace

REPRO_EXPORT int launch_ewah_and_popcount(int device, int B, const void* sa,
                                          int ca, const void* la,
                                          const void* na, const void* sb,
                                          int cb, const void* lb,
                                          const void* nb, void* count,
                                          void* iters, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 128;
  ewah_and_popcount_kernel<<<(B + threads - 1) / threads, threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      B, static_cast<const uint32_t*>(sa), ca, static_cast<const int*>(la),
      static_cast<const int*>(na), static_cast<const uint32_t*>(sb), cb,
      static_cast<const int*>(lb), static_cast<const int*>(nb),
      static_cast<int*>(count), static_cast<int*>(iters));
  return static_cast<int>(cudaGetLastError());
}

namespace {

Side make_side(const void* s, int C, const void* len, void* tab, void* wtab,
               void* meta, void* ptile, int n_tiles) {
  return Side{static_cast<const uint32_t*>(s), C,
              static_cast<const int*>(len), static_cast<int2*>(tab),
              static_cast<uint32_t*>(wtab), static_cast<int*>(meta),
              static_cast<int*>(ptile), n_tiles};
}

}  // namespace

// Phase 1 for both sides: streams s (B, C) int32 with lengths (B,); per
// side the table tab (B, C, 2), wtab (B, C), meta (B, 3) and ptile
// (B, n_tiles), n_tiles = cdiv(C, tile); tile == AP_TILE; table offsets
// saturate at n_words in [1, 2^30).
REPRO_EXPORT int launch_ewah_pair_chain(
    int device, int B, int n_words, int tile, const void* sa, int ca,
    const void* la, void* tab_a, void* wtab_a, void* meta_a, void* ptile_a,
    int nt_a, const void* sb, int cb, const void* lb, void* tab_b,
    void* wtab_b, void* meta_b, void* ptile_b, int nt_b, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B < 1 || B >= (1 << 30) || tile != AP_TILE || n_words < 1 ||
      n_words >= (1 << 30) || !side_ok(ca, nt_a) || !side_ok(cb, nt_b))
    return static_cast<int>(cudaErrorInvalidValue);
  ewah_pair_chain_kernel<<<2 * B, CH_THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      B, make_side(sa, ca, la, tab_a, wtab_a, meta_a, ptile_a, nt_a),
      make_side(sb, cb, lb, tab_b, wtab_b, meta_b, ptile_b, nt_b), n_words);
  return static_cast<int>(cudaGetLastError());
}

// Phase 2: the tables phase 1 wrote, the array sizes na / nb (B,); adds
// into count and iters (B,) int32, which the caller zeroes.
REPRO_EXPORT int launch_ewah_pair_tiles(
    int device, int B, int n_words, int tile, const void* sa, int ca,
    const void* la, const void* na, void* tab_a, void* wtab_a, void* meta_a,
    void* ptile_a, int nt_a, const void* sb, int cb, const void* lb,
    const void* nb, void* tab_b, void* wtab_b, void* meta_b, void* ptile_b,
    int nt_b, void* count, void* iters, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B < 1 || tile != AP_TILE || n_words < 1 || n_words >= (1 << 30) ||
      !side_ok(ca, nt_a) || !side_ok(cb, nt_b))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(B) * (nt_a + nt_b);
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  ewah_pair_tiles_kernel<<<static_cast<unsigned>(blocks), TL_THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      B, make_side(sa, ca, la, tab_a, wtab_a, meta_a, ptile_a, nt_a),
      static_cast<const int*>(na),
      make_side(sb, cb, lb, tab_b, wtab_b, meta_b, ptile_b, nt_b),
      static_cast<const int*>(nb), n_words, static_cast<uint32_t*>(count),
      static_cast<int*>(iters));
  return static_cast<int>(cudaGetLastError());
}
