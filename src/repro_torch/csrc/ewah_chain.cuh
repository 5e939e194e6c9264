// Marker-chain primitives shared by ewah_decode.cu and
// ewah_and_popcount.cu.
//
// Every position i of an EWAH stream can be read as a marker whose
// successor is next(i) = min(i + 1 + (w_i & 0x7FFF), len); the stream's
// markers are the orbit of position 0 under next.  A warp resolves a
// 32-position window at once: lane i starts from next(pos_i) and jumps
// through the positions inside the window by shuffles, so after 5 rounds
// it holds E_1(i), the first position of i's chain at or past the window's
// end, and (on request) the bits of the window positions that chain
// visits.  Larger windows compose these exits by pointer jumping.
#pragma once

#include "common.cuh"

namespace ewah_chain {

__device__ __forceinline__ int clamp_len(const int* lengths, long long r,
                                         int C) {
  const int len = lengths[r];
  return len < 0 ? 0 : (len > C ? C : len);
}

__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

// Window exit by shuffles.  J is next(lane's position) (len for a lane
// past the stream); the window is [wb, wend).  Returns E_1 of the lane's
// position; with Reach, `reach` (which starts as the lane's own bit) gains
// the bit of every window position the lane's chain visits.
template <bool Reach>
__device__ __forceinline__ int window_exit(int J, int wb, int wend,
                                           uint32_t& reach) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 5; ++r) {
    const bool in = J < wend;
    const int src = in ? J - wb : lane;
    if constexpr (Reach) {
      const uint32_t rn = __shfl_sync(0xFFFFFFFFu, reach, src);
      const int jn = __shfl_sync(0xFFFFFFFFu, J, src);
      if (in) {
        reach |= rn;
        J = jn;
      }
    } else {
      const int jn = __shfl_sync(0xFFFFFFFFu, J, src);
      if (in) J = jn;
    }
  }
  return J;
}

// Exclusive scan over the block of (sum saturated at cap, count); the
// saturated sum is min(true sum, cap) since every term is non-negative, so
// combining saturated partial sums is exact.  Returns the block's totals.
// s_sum and s_cnt hold one int a warp.
__device__ __forceinline__ int2 block_exclusive_scan(int& sum, int& cnt,
                                                     int cap, int* s_sum,
                                                     int* s_cnt) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int is = sum, ic = cnt;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int a = __shfl_up_sync(0xFFFFFFFFu, is, d);
    const int c = __shfl_up_sync(0xFFFFFFFFu, ic, d);
    if (lane >= d) {
      is = min(is + a, cap);
      ic += c;
    }
  }
  if (lane == 31) {
    s_sum[warp] = is;
    s_cnt[warp] = ic;
  }
  int es = __shfl_up_sync(0xFFFFFFFFu, is, 1);
  int ec = __shfl_up_sync(0xFFFFFFFFu, ic, 1);
  if (lane == 0) es = ec = 0;
  __syncthreads();
  if (warp == 0) {
    int ws = lane < nwarps ? s_sum[lane] : 0;
    int wc = lane < nwarps ? s_cnt[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int a = __shfl_up_sync(0xFFFFFFFFu, ws, d);
      const int c = __shfl_up_sync(0xFFFFFFFFu, wc, d);
      if (lane >= d) {
        ws = min(ws + a, cap);
        wc += c;
      }
    }
    if (lane < nwarps) {
      s_sum[lane] = ws;
      s_cnt[lane] = wc;
    }
  }
  __syncthreads();
  if (warp > 0) {
    es = min(es + s_sum[warp - 1], cap);
    ec += s_cnt[warp - 1];
  }
  sum = es;
  cnt = ec;
  const int2 tot = make_int2(s_sum[nwarps - 1], s_cnt[nwarps - 1]);
  __syncthreads();  // s_sum / s_cnt are free again
  return tot;
}

}  // namespace ewah_chain
