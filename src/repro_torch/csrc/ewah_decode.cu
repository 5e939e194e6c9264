// ewah_decode: expand a batch of EWAH streams into dense word planes.
//
// No TPU kernel counterpart: this replaces the reference's lax.scan decoder
// (src/repro/core/ewah_jax.py decompress), which torch cannot express.
//
// Stream r = b * m + j of a (B, m, C) batch is written to output row
// j * B + b, so the output is the (m, B, n_words) plane stack the plan
// kernels read without a transpose.  Two launches:
//
// 1. ewah_decode_kernel_markers resolves each stream's marker chain into a
//    marker table: the markers whose output offset is below n_words, in
//    order, as (position, offset) pairs, their count, and for every output
//    tile of 2^DEC_TILE_SHIFT words the last marker starting at or before
//    the tile's first word.  Every position i of a stream can be read as a
//    marker whose successor is next(i) = min(i + 1 + (w_i & 0x7FFF), len);
//    the markers are the orbit of position 0 under next.  G clusters of
//    DEC_CLUSTER blocks (as many as the card holds at once):
//    - Short streams: cluster c walks streams c, c + G, ..., a warp a
//      stream, 32 words a load, the steps inside a loaded window by
//      shuffles, for at most WALK_MAX = 32 markers (a constant, not the
//      marker count).  A stream that ends or fills n_words within them is
//      done: it pays one read of its markers and nothing else.
//    - Other streams are marked and go to whichever cluster claims them
//      first (an atomic compare-and-swap on the stream's count), so the
//      long streams of a batch spread over the clusters.  The claiming
//      cluster splits the stream's positions into one range a
//      block, aligned to windows of 32^n positions (32^(n+1) >= length; n =
//      2 at C = 32,768, 4,096 positions a block).  With windows of 32^l
//      positions at level l, E_l(i) is the first marker of i's chain (i
//      read as a marker) at or past the end of i's level-l window; level
//      n + 1 is the block's range.  Each block computes E_1 for its
//      positions by shuffles (a warp a 32-word window, 5 rounds) and E_l
//      from E_(l-1) by pointer jumping inside the level-l windows (a
//      window holds at most 32 of the level below: about 5 rounds, all in
//      its shared memory).  One thread then walks the blocks' exits from
//      position 0 (at most DEC_CLUSTER steps, through distributed shared
//      memory), each block walks its levels down from its entry (at most
//      32 steps a window), and a warp takes each 32-word window's markers
//      from its entry (shuffles, 5 rounds).  Depth: about 5 (n + 2) jump
//      rounds and 32 n walk steps, logarithmic in C and independent of the
//      marker count.  A scan over the block, then over the cluster, gives
//      every marker its rank and its output offset (the running sum of
//      clean + dirty words saturated at n_words, so nothing overflows).
//      The tables live in shared memory (uint16) for C <= 32,768, else in
//      a scratch area the wrapper allocates (uint32).
// 2. ewah_decode_kernel_expand writes the output over (stream, tile)
//    blocks: each block stages the tile's markers in shared memory, and
//    every output word finds its marker by binary search, then is the
//    clean fill or a dirty word read from the stream.  Words no marker
//    covers are written as 0, so the output needs no memset.
//
// Semantics follow the reference exactly: entries at or past `length` are
// ignored (length clamped to [0, C]), a dirty run cut by `length` stops
// there, and output positions at or past n_words are dropped.
//
// Bound on the H100: bytes.  Each stream's `length` words are read once
// and n_words words written once, at 3.35 TB/s.  The design reads a short
// stream's markers and dirty words once each; a long stream is read twice
// more to resolve it, spread over the cluster's SMs.
#include <cooperative_groups.h>

#include "ewah_chain.cuh"

namespace cg = cooperative_groups;

#define DEC_CLUSTER 8
#define DEC_TILE_SHIFT 11
#define MK_THREADS 512
#define WALK_MAX 32
#define SMEM_POS 4096  // positions a block holds for C <= 32,768
#define SMEM_LEVELS 3  // E_1, E_2 and the block's exit
#define EXP_THREADS 256
#define EXP_RECS 2048
#define EXP_PER 8

namespace {

using ewah_chain::block_exclusive_scan;
using ewah_chain::cdiv;
using ewah_chain::clamp_len;
using ewah_chain::window_exit;

// Tiles whose first word lies in [lo, hi) start inside marker k's span.
__device__ __forceinline__ void mark_tiles(int* tile_first, int lo, int hi,
                                           int k, int lane, int step) {
  constexpr int tile = 1 << DEC_TILE_SHIFT;
  for (int t = ((lo + tile - 1) >> DEC_TILE_SHIFT) + lane;
       t * static_cast<long long>(tile) < hi; t += step)
    tile_first[t] = k;
}

// The warp's bounded walk of a stream.  Returns true when the stream is
// resolved (it ends or fills n_words within WALK_MAX markers); lane k
// keeps marker k and writes its table entry and tiles at the end.
__device__ bool walk_stream(const uint32_t* __restrict__ s, int len,
                            int n_words, int2* __restrict__ tab,
                            int* __restrict__ tab_n,
                            int* __restrict__ tile_first, int lane) {
  int p = 0, op = 0, k = 0;
  int base = -32;
  uint32_t win = 0;
  int my_p = 0, my_op = 0, my_end = 0;
  while (p < len && op < n_words && k < WALK_MAX) {
    if (p >= base + 32) {
      base = p;
      win = p + lane < len ? s[p + lane] : 0u;
    }
    const uint32_t w = __shfl_sync(0xFFFFFFFFu, win, p - base);
    const int nd = static_cast<int>(w & 0x7FFFu);
    const int avail = len - (p + 1);
    const int next_op = op + static_cast<int>((w >> 15) & 0xFFFFu) +
                        (nd < avail ? nd : avail);  // < 2^30 + 2^17
    if (lane == k) {
      my_p = p;
      my_op = op;
      my_end = next_op;
    }
    ++k;
    p += 1 + nd;
    op = next_op;
  }
  if (p < len && op < n_words) return false;  // more than WALK_MAX markers
  if (lane < k) {
    tab[lane] = make_int2(my_p, my_op);
    mark_tiles(tile_first, my_op, lane == k - 1 ? n_words : my_end, lane, 0,
               1);
  }
  if (k == 0) mark_tiles(tile_first, 0, n_words, -1, lane, 32);
  if (lane == 0) tab_n[0] = k;
  return true;
}

// Levels of windows a stream of len positions needs: the smallest n >= 1
// with 32^(n+1) >= len.
__host__ __device__ __forceinline__ int exit_levels(long long len) {
  int n = 1;
  for (long long span = 1024; span < len; span <<= 5) ++n;
  return n;
}

// Positions of one block's range for C: the level-n windows split over the
// cluster.
__host__ __device__ __forceinline__ long long block_span(int C) {
  const int n = exit_levels(C);
  const long long w = 1LL << (5 * n);
  return ((C + w - 1) / w + DEC_CLUSTER - 1) / DEC_CLUSTER * w;
}

// uint32 words of one block's scratch for C (the device-memory route): the
// n + 1 exit tables, the marker bits and the window entries of every level.
__host__ __device__ __forceinline__ long long scratch_words(int C) {
  const long long span = block_span(C);
  const int n = exit_levels(C);
  long long ent = 1;
  for (int l = 1; l <= n; ++l) ent += (span + (1LL << (5 * l)) - 1) >> (5 * l);
  return (n + 1) * span + (span + 31) / 32 + ent;
}

// Where a block keeps its part of a stream's resolution: in its shared
// memory (Idx = uint16_t), or in its own area of the scratch, the areas
// `stride` uint32 words apart in block order (Idx = uint32_t).
template <typename Idx>
struct Work {
  Idx* tb;          // E_l at tb + (l - 1) * span, indexed by position - p0
  uint32_t* mbits;  // markers of each 32-word window of the range
  int* ent;         // window entries of levels 1 .. n, then the block's
  uint32_t* cbuf;   // clean + dirty words of each marker (aliases tb)
  long long stride;
};

// The same place as p in the cluster's block `owner`.
template <typename Idx, typename T>
__device__ __forceinline__ T* peer(cg::cluster_group& cluster,
                                   const Work<Idx>& wk, T* p, int owner) {
  if constexpr (sizeof(Idx) == 2) {
    return cluster.map_shared_rank(p, owner);
  } else {
    const long long d =
        (owner - static_cast<int>(cluster.block_rank())) * wk.stride;
    return reinterpret_cast<T*>(reinterpret_cast<uint32_t*>(p) + d);
  }
}

// End of position i's window at level shift sh (5 * level), cut at hi.
__device__ __forceinline__ int window_end(int i, int sh, int hi) {
  const long long e = (static_cast<long long>(i >> sh) + 1) << sh;
  return e < hi ? static_cast<int>(e) : hi;
}

// Entries of level l's windows in the range starting at p0 (span wide).
__device__ __forceinline__ int entry_offset(long long span, int l) {
  int o = 0;
  for (int k = 1; k < l; ++k)
    o += static_cast<int>((span + (1LL << (5 * k)) - 1) >> (5 * k));
  return o;
}

// Resolve stream s with the cluster: this block owns positions [p0, p1)
// (p1 = p0 + span cut at len).  Writes the stream's marker table.
template <typename Idx>
__device__ __forceinline__ void resolve_stream(
    cg::cluster_group& cluster, const uint32_t* __restrict__ s, int len,
    int n_words, long long span, Work<Idx> wk, int2* __restrict__ tab,
    int* __restrict__ tab_n, int* __restrict__ tile_first, int* s_sum,
    int* s_cnt, int* s_misc) {
  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = T >> 5;
  const int rank = static_cast<int>(cluster.block_rank());
  constexpr int U = 8;  // windows a warp loads at once
  const int n = exit_levels(len);
  const long long lo = rank * span;
  const int p0 = lo < len ? static_cast<int>(lo) : len;
  const int p1 = lo + span < len ? static_cast<int>(lo + span) : len;
  const int np = p1 - p0;
  const int nw1 = cdiv(np, 32);
  Idx* const tb = wk.tb;
  int* const ent_blk = wk.ent + entry_offset(span, n + 1);

  for (int l = 1; l <= n; ++l) {
    int* e = wk.ent + entry_offset(span, l);
    for (int w = tid; w < cdiv(np, 1 << (5 * l)); w += T) e[w] = -1;
  }
  if (tid == 0) ent_blk[0] = -1;
  // E_1 by shuffles, U windows' loads in flight a warp
  for (int w0 = warp; w0 < nw1; w0 += U * nwarps) {
    uint32_t wd[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int pos = p0 + (w0 + u * nwarps) * 32 + lane;
      wd[u] = pos < p1 ? __ldg(s + pos) : 0u;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int w = w0 + u * nwarps;
      if (w >= nw1) break;  // uniform in the warp
      const int wb = p0 + w * 32;
      const int pos = wb + lane;
      const int wend = min(wb + 32, p1);
      uint32_t unused = 0;
      const int J = window_exit<false>(
          pos < p1 ? min(pos + 1 + static_cast<int>(wd[u] & 0x7FFFu), len)
                   : len,
          wb, wend, unused);
      if (pos < p1) tb[pos - p0] = static_cast<Idx>(J);
    }
  }
  __syncthreads();

  // E_l from E_(l-1) inside level-l windows, level n + 1 being the range;
  // in place after the first round.  Every value a position holds is a
  // marker of its chain no later than its window's exit, so a jump through
  // a position already updated this round is still a correct longer jump.
  for (int l = 2; l <= n + 1; ++l) {
    const Idx* P = tb + (l - 2) * span;
    Idx* Q = tb + (l - 1) * span;
    int live = 0;
    for (int i = tid; i < np; i += T) {
      const int b = l <= n ? window_end(p0 + i, 5 * l, p1) : p1;
      int j = P[i];
      if (j < b) {
        j = P[j - p0];
        live |= j < b;
      }
      Q[i] = static_cast<Idx>(j);
    }
    while (__syncthreads_or(live)) {
      live = 0;
      for (int i = tid; i < np; i += T) {
        const int b = l <= n ? window_end(p0 + i, 5 * l, p1) : p1;
        int j = Q[i];
        if (j < b) {
          j = Q[j - p0];
          Q[i] = static_cast<Idx>(j);
          live |= j < b;
        }
      }
    }
  }
  cluster.sync();

  // The walk over the blocks' exits from position 0: each step is the
  // entry (first marker) of a block's range.
  if (rank == 0 && tid == 0) {
    for (int x = 0; x < len;) {
      const int owner = static_cast<int>(x / span);
      *peer(cluster, wk, ent_blk, owner) = x;
      const Idx* Eo = peer(cluster, wk, tb, owner) + n * span;
      x = Eo[x - owner * span];
    }
  }
  cluster.sync();

  // Down the levels from the block's entry: a thread a level-l window
  // walks E_(l-1) from its entry, at most 32 steps.
  for (int l = n + 1; l >= 2; --l) {
    const int* e = wk.ent + entry_offset(span, l);
    int* d = wk.ent + entry_offset(span, l - 1);
    const Idx* Ed = tb + (l - 2) * span;
    const int nwl = l <= n ? cdiv(np, 1 << (5 * l)) : (np > 0);
    for (int w = tid; w < nwl; w += T) {
      int x = e[w];
      if (x < 0) continue;
      const int end = l <= n ? window_end(x, 5 * l, p1) : p1;
      for (; x < end; x = Ed[x - p0]) d[(x - p0) >> (5 * (l - 1))] = x;
    }
    __syncthreads();
  }

  // The markers of each 32-word window and their word counts.  Warp w
  // takes windows [wa, wz), k of them, in turn; its lane i owns windows
  // [wa + i * wpt, wa + (i + 1) * wpt), so each thread's markers are
  // contiguous in rank and follow those of the threads before it.
  const int* e1 = wk.ent;
  const int kw = cdiv(nw1, nwarps), wpt = cdiv(kw, 32);
  const int wa = min(warp * kw, nw1), wz = min(wa + kw, nw1);
  int sum = 0, cnt = 0;
  for (int w0 = wa; w0 < wz; w0 += U) {
    uint32_t wd[U];
    int en[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int w = w0 + u;
      en[u] = w < wz ? e1[w] : -1;
      const int pos = p0 + w * 32 + lane;
      wd[u] = en[u] >= 0 && pos < p1 ? __ldg(s + pos) : 0u;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int w = w0 + u;
      if (w >= wz) break;  // uniform in the warp
      const int wb = p0 + w * 32;
      const int pos = wb + lane;
      uint32_t R = 0;  // the window's markers, bit = position - wb
      if (en[u] >= 0) {
        const int wend = min(wb + 32, p1);
        uint32_t reach = 1u << lane;
        window_exit<true>(
            pos < p1 ? min(pos + 1 + static_cast<int>(wd[u] & 0x7FFFu), len)
                     : len,
            wb, wend, reach);
        R = __shfl_sync(0xFFFFFFFFu, reach, en[u] - wb);
      }
      int c = 0;
      if ((R >> lane) & 1u) {
        const int nd = static_cast<int>(wd[u] & 0x7FFFu);
        const int avail = len - (pos + 1);
        c = static_cast<int>((wd[u] >> 15) & 0xFFFFu) +
            (nd < avail ? nd : avail);
        wk.cbuf[pos - p0] = static_cast<uint32_t>(c);
      }
      const int ws = static_cast<int>(
          __reduce_add_sync(0xFFFFFFFFu, static_cast<unsigned>(c)));
      if (lane == 0) wk.mbits[w] = R;
      if (lane == (w - wa) / wpt) {
        sum = min(sum + ws, n_words);
        cnt += __popc(R);
      }
    }
  }
  const int2 btot = block_exclusive_scan(sum, cnt, n_words, s_sum, s_cnt);

  // The cluster's scan: this block's base is the saturated sum of the
  // ranges before it; the cluster's marker count tells the last marker.
  if (tid == 0) {
    s_misc[0] = btot.x;
    s_misc[1] = btot.y;
  }
  cluster.sync();
  int base_sum = 0, base_cnt = 0, all_cnt = 0;
  for (int k = 0; k < static_cast<int>(cluster.num_blocks()); ++k) {
    const int* o = cluster.map_shared_rank(s_misc, k);
    if (k < rank) {
      base_sum = min(base_sum + o[0], n_words);
      base_cnt += o[1];
    }
    all_cnt += o[1];
  }
  // Table entries and tiles, a warp a window: ranks are consecutive, so
  // the stores are coalesced.  The last marker of the table (the stream's
  // last, or the last whose offset is below n_words) spans to n_words.
  int run_off = min(base_sum + sum, n_words), run_rank = base_cnt + cnt;
  for (int w = wa; w < wz; ++w) {
    const int owner = (w - wa) / wpt;
    const uint32_t R = wk.mbits[w];
    if (R == 0) continue;  // uniform in the warp
    const int boff = __shfl_sync(0xFFFFFFFFu, run_off, owner);
    const int brank = __shfl_sync(0xFFFFFFFFu, run_rank, owner);
    const int pos = p0 + w * 32 + lane;
    const bool mk = (R >> lane) & 1u;
    const int c = mk ? static_cast<int>(wk.cbuf[pos - p0]) : 0;
    int inc = c;  // <= 32 * 98,302: no overflow
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int a = __shfl_up_sync(0xFFFFFFFFu, inc, d);
      if (lane >= d) inc += a;
    }
    const int off = min(boff + inc - c, n_words);
    const int rk = brank + __popc(R & ((1u << lane) - 1u));
    if (mk && off < n_words) {
      const bool last = off + c >= n_words || rk == all_cnt - 1;
      tab[rk] = make_int2(pos, off);
      mark_tiles(tile_first, off, last ? n_words : off + c, rk, 0, 1);
      if (last) tab_n[0] = rk + 1;
    }
    const int wsum = __shfl_sync(0xFFFFFFFFu, inc, 31);
    if (lane == owner) {
      run_off = min(run_off + wsum, n_words);
      run_rank += __popc(R);
    }
  }
  __syncthreads();  // cbuf (the tables) and mbits are free for the next stream
}

// The next heavy row from `start` on (rows taken in order from `cursor`),
// claimed for this cluster by one atomic compare-and-swap; -1 when none is
// left.  Run by one whole block; every row is read once a pass, from L2.
__device__ long long claim_next(int* tab_n, int R, long long start,
                                long long& cursor, int heavy, int claimed,
                                int* s_red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  while (cursor < R) {
    const long long i = cursor + threadIdx.x;
    const long long r = (start + i) % R;
    const int cand = i < R && __ldcg(tab_n + r) == heavy
                         ? static_cast<int>(i - cursor)
                         : 0x7FFFFFFF;
    const int wmin = static_cast<int>(
        __reduce_min_sync(0xFFFFFFFFu, static_cast<unsigned>(cand)));
    if (lane == 0) s_red[warp] = wmin;
    __syncthreads();
    int first = 0x7FFFFFFF;
    for (int k = 0; k < nwarps; ++k) first = min(first, s_red[k]);
    __syncthreads();  // every thread has read s_red
    if (first == 0x7FFFFFFF) {
      cursor += blockDim.x;
      continue;
    }
    const long long rr = (start + cursor + first) % R;
    if (threadIdx.x == 0)
      s_red[0] = atomicCAS(tab_n + rr, heavy, claimed) == heavy;
    __syncthreads();
    const bool won = s_red[0];
    __syncthreads();
    cursor += first + 1;
    if (won) return rr;
  }
  return -1;
}

}  // namespace

__global__ void __cluster_dims__(DEC_CLUSTER, 1, 1)
    __launch_bounds__(MK_THREADS, 2)
    ewah_decode_kernel_markers(const uint32_t* __restrict__ streams, int C,
                               const int* __restrict__ lengths, int R,
                               int n_words, int n_tiles, int tag,
                               int2* __restrict__ tab, int* __restrict__ tab_n,
                               int* __restrict__ tile_first,
                               uint32_t* __restrict__ scratch) {
  __shared__ uint16_t s_tb[SMEM_LEVELS * SMEM_POS];
  __shared__ uint32_t s_mbits[SMEM_POS / 32];
  __shared__ int s_ent[SMEM_POS / 32 + SMEM_POS / 1024 + 1];
  __shared__ int s_sum[32], s_cnt[32], s_misc[2];
  __shared__ long long s_claim[1];
  cg::cluster_group cluster = cg::this_cluster();
  const int G = gridDim.x / DEC_CLUSTER;
  const int c = blockIdx.x / DEC_CLUSTER;
  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  // every warp of the cluster walks one of its streams; unresolved ones
  // are marked heavy (tab_n = -2 tag; tag changes from call to call, so
  // nothing left in the buffer from before reads as heavy)
  const int heavy = -2 * tag, claimed = heavy - 1;
  for (long long q = rank * nwarps + warp; c + q * G < R;
       q += DEC_CLUSTER * nwarps) {
    const long long r = c + q * G;
    const int len = clamp_len(lengths, r, C);
    if (!walk_stream(streams + r * C, len, n_words, tab + r * C, tab_n + r,
                     tile_first + r * n_tiles, lane) &&
        lane == 0)
      tab_n[r] = heavy;
  }
  __threadfence();
  cluster.sync();

  // The long streams go to whichever cluster claims them first: each
  // cluster scans all rows from its own starting point (its own streams are
  // marked by now, those of other clusters as they finish walking), so an
  // idle cluster takes over another's second long stream.
  const long long span = block_span(C);
  long long cursor = 0;
  const long long start = c * (R / G);
  while (true) {
    if (rank == 0) {
      const long long r = claim_next(tab_n, R, start, cursor, heavy, claimed,
                                     s_sum);
      if (threadIdx.x == 0)
        for (int k = 0; k < DEC_CLUSTER; ++k)
          *cluster.map_shared_rank(s_claim, k) = r;
    }
    cluster.sync();
    const long long r = s_claim[0];
    if (r < 0) break;
    const int len = clamp_len(lengths, r, C);
    if (scratch == nullptr) {  // C <= 32,768: span <= SMEM_POS
      Work<uint16_t> wk{s_tb, s_mbits, s_ent,
                        reinterpret_cast<uint32_t*>(s_tb), 0};
      resolve_stream(cluster, streams + r * C, len, n_words, span, wk,
                     tab + r * C, tab_n + r, tile_first + r * n_tiles, s_sum,
                     s_cnt, s_misc);
    } else {
      const long long stride = scratch_words(C);
      uint32_t* base = scratch + blockIdx.x * stride;
      const int n = exit_levels(C);
      Work<uint32_t> wk{base, base + (n + 1) * span,
                        reinterpret_cast<int*>(base + (n + 1) * span +
                                               (span + 31) / 32),
                        base, stride};
      resolve_stream(cluster, streams + r * C, len, n_words, span, wk,
                     tab + r * C, tab_n + r, tile_first + r * n_tiles, s_sum,
                     s_cnt, s_misc);
    }
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

__global__ void __launch_bounds__(EXP_THREADS)
ewah_decode_kernel_expand(const uint32_t* __restrict__ streams, int C,
                          const int* __restrict__ lengths, int m, int B,
                          int n_words, int n_tiles,
                          const int2* __restrict__ tab,
                          const int* __restrict__ tab_n,
                          const int* __restrict__ tile_first,
                          uint32_t* __restrict__ out) {
  __shared__ int rec_off[EXP_RECS];
  __shared__ int rec_pos[EXP_RECS];
  __shared__ uint32_t rec_w[EXP_RECS];

  const long long r = blockIdx.x / n_tiles;
  const int t = static_cast<int>(blockIdx.x % n_tiles);
  const int s0 = t << DEC_TILE_SHIFT;
  const int s1 = min(s0 + (1 << DEC_TILE_SHIFT), n_words);
  const uint32_t* s = streams + r * C;
  const int len = clamp_len(lengths, r, C);
  uint32_t* o = out + (static_cast<long long>(r % m) * B + r / m) *
                          static_cast<long long>(n_words);
  const int* tf = tile_first + r * n_tiles;
  const int k0 = tf[t];
  if (k0 < 0) {  // an empty stream
    for (int i = s0 + threadIdx.x; i < s1; i += blockDim.x) o[i] = 0u;
    return;
  }
  const int k1 = t + 1 < n_tiles ? tf[t + 1] : tab_n[r] - 1;
  const int nrec = k1 - k0 + 1;
  const int2* tr = tab + r * C + k0;
  const bool staged = nrec <= EXP_RECS;
  if (staged) {
    for (int j = threadIdx.x; j < nrec; j += blockDim.x) {
      const int2 e = tr[j];
      rec_pos[j] = e.x;
      rec_off[j] = e.y;
      rec_w[j] = __ldg(s + e.x);
    }
    __syncthreads();
  }
  // EXP_PER words a thread: every dirty load is issued before any store
  for (int i0 = s0 + threadIdx.x; i0 < s1;
       i0 += EXP_PER * static_cast<int>(blockDim.x)) {
    uint32_t v[EXP_PER];
#pragma unroll
    for (int u = 0; u < EXP_PER; ++u) {
      const int i = i0 + u * static_cast<int>(blockDim.x);
      v[u] = 0u;
      if (i >= s1) continue;
      int a = 0, z = nrec - 1;  // largest a with off[a] <= i
      while (a < z) {
        const int mid = (a + z + 1) >> 1;
        const int off = staged ? rec_off[mid] : tr[mid].y;
        if (off <= i) a = mid; else z = mid - 1;
      }
      int pos, off;
      uint32_t w;
      if (staged) {
        pos = rec_pos[a];
        off = rec_off[a];
        w = rec_w[a];
      } else {
        const int2 e = tr[a];
        pos = e.x;
        off = e.y;
        w = __ldg(s + pos);
      }
      const int nc = static_cast<int>((w >> 15) & 0xFFFFu);
      const int nd = static_cast<int>(w & 0x7FFFu);
      const int avail = len - (pos + 1);
      const int nd_eff = nd < avail ? nd : avail;
      const int d = i - off;
      if (d < nc)
        v[u] = (w >> 31) ? 0xFFFFFFFFu : 0u;
      else if (d - nc < nd_eff)
        v[u] = __ldg(s + pos + 1 + (d - nc));
    }
#pragma unroll
    for (int u = 0; u < EXP_PER; ++u) {
      const int i = i0 + u * static_cast<int>(blockDim.x);
      if (i < s1) o[i] = v[u];
    }
  }
}

namespace {

// Clusters of the markers kernel: one a stream, at most as many as the
// card holds at once (so that no cluster waits for a second wave).
unsigned marker_clusters(int R) {
  static int resident = 0;
  if (resident == 0) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(DEC_CLUSTER);
    cfg.blockDim = dim3(MK_THREADS);
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, ewah_decode_kernel_markers,
                                       &cfg) != cudaSuccess || n < 1)
      n = 16;
    resident = n;
  }
  return static_cast<unsigned>(R < resident ? R : resident);
}

bool valid_shape(int C, int n_words, int tile, int n_tiles) {
  return C >= 1 && C < (1 << 30) && n_words >= 1 && n_words < (1 << 30) &&
         tile == (1 << DEC_TILE_SHIFT) &&
         n_tiles == cdiv(n_words, 1 << DEC_TILE_SHIFT);
}

}  // namespace

// uint32 words of scratch the markers kernel needs for R streams of C
// words (0 where its tables fit in shared memory, C <= 32,768).
REPRO_EXPORT long long ewah_markers_scratch_words(int C, int R) {
  if (C < 1 || R < 1) return -1;
  if (block_span(C) <= SMEM_POS && exit_levels(C) + 1 <= SMEM_LEVELS)
    return 0;
  return static_cast<long long>(marker_clusters(R)) * DEC_CLUSTER *
         scratch_words(C);
}

// streams: (R, C) words, R = B * m; lengths: (R,) int32; tab: (R, C) int2;
// tab_n: (R,); tile_first: (R, n_tiles), tile = 2^DEC_TILE_SHIFT words;
// tag in [1, 2^29): differs from the previous calls' on the same tab_n;
// scratch: see above (or null).
REPRO_EXPORT int launch_ewah_markers(int device, const void* streams, int C,
                                     const void* lengths, int R, int n_words,
                                     int tile, int n_tiles, int tag, void* tab,
                                     void* tab_n, void* tile_first,
                                     void* scratch, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long need = ewah_markers_scratch_words(C, R);
  if (R < 1 || !valid_shape(C, n_words, tile, n_tiles) || need < 0 ||
      (need > 0 && scratch == nullptr) || tag < 1 || tag >= (1 << 29))
    return static_cast<int>(cudaErrorInvalidValue);
  ewah_decode_kernel_markers<<<marker_clusters(R) * DEC_CLUSTER, MK_THREADS,
                               0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(streams), C,
      static_cast<const int*>(lengths), R, n_words, n_tiles, tag,
      static_cast<int2*>(tab), static_cast<int*>(tab_n),
      static_cast<int*>(tile_first),
      need > 0 ? static_cast<uint32_t*>(scratch) : nullptr);
  return static_cast<int>(cudaGetLastError());
}

// out: (m, B, n_words); the table as launch_ewah_markers writes it.
REPRO_EXPORT int launch_ewah_expand(int device, const void* streams, int C,
                                    const void* lengths, int m, int B,
                                    int n_words, int tile, int n_tiles,
                                    const void* tab, const void* tab_n,
                                    const void* tile_first, void* out,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m < 1 || B < 1 || !valid_shape(C, n_words, tile, n_tiles))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(m) * B * n_tiles;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  ewah_decode_kernel_expand<<<static_cast<unsigned>(blocks), EXP_THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(streams), C,
      static_cast<const int*>(lengths), m, B, n_words, n_tiles,
      static_cast<const int2*>(tab), static_cast<const int*>(tab_n),
      static_cast<const int*>(tile_first), static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
