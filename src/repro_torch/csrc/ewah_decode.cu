// ewah_decode: expand a batch of EWAH streams into dense word planes.
//
// No TPU kernel counterpart: this replaces the reference's lax.scan decoder
// (src/repro/core/ewah_jax.py decompress), which torch cannot express.
//
// One block per stream.  Stream r = b * m + j of a (B, m, C) batch is
// written to output row j * B + b, so the output is the (m, B, n_words)
// plane stack the plan kernels read without a transpose.  The block loops:
//   1. it copies a window of the stream into shared memory (coalesced);
//   2. thread 0 walks the markers inside the window and stages up to
//      DEC_RECS records (output position, first dirty word, clean count,
//      clean fill) in shared memory;
//   3. all threads write the records' output span [first, last) together:
//      each output word finds its record by binary search, then is either
//      the clean fill or a dirty word copied from the window (or from device
//      memory past the window's end).
// Words no marker covers are written as 0, so the output needs no memset.
// Semantics follow the reference exactly: entries at or past `length` are
// ignored, a dirty run cut by `length` stops there, and output positions at
// or past n_words are dropped.
//
// Bound on the H100: bytes.  Each stream's `length` words are read once and
// n_words words written once, at 3.35 TB/s.  The serial marker walk is
// latency-bound, not bandwidth-bound, on streams of many short runs: it
// reads shared memory only, and many blocks per SM hide it.
#include "common.cuh"

#define DEC_THREADS 256
#define DEC_WIN 4096
#define DEC_RECS 256

__global__ void __launch_bounds__(DEC_THREADS)
ewah_decode_kernel(const uint32_t* __restrict__ streams, int C,
                   const int* __restrict__ lengths, int m, int B,
                   int n_words, uint32_t* __restrict__ out) {
  __shared__ uint32_t win[DEC_WIN];
  __shared__ int rec_out[DEC_RECS + 1];
  __shared__ int rec_in[DEC_RECS];
  __shared__ int rec_nc[DEC_RECS];
  __shared__ uint32_t rec_fill[DEC_RECS];
  __shared__ int s_pos, s_opos, s_win, s_nrec;

  const int r = blockIdx.x;
  const uint32_t* s = streams + static_cast<long long>(r) * C;
  int len = lengths[r];
  len = len < 0 ? 0 : (len > C ? C : len);
  uint32_t* o = out + (static_cast<long long>(r % m) * B + r / m) *
                          static_cast<long long>(n_words);

  if (threadIdx.x == 0) {
    s_pos = 0;
    s_opos = 0;
    s_win = -2 * DEC_WIN;  // no window loaded yet
  }
  __syncthreads();

  int opos;
  while (true) {
    const int pos = s_pos;
    opos = s_opos;
    int wbase = s_win;
    __syncthreads();  // every thread has read the cursor before it moves
    if (pos >= len || opos >= n_words) break;
    if (pos >= wbase + DEC_WIN) {
      wbase = pos;
      for (int i = threadIdx.x; i < DEC_WIN && pos + i < len; i += blockDim.x)
        win[i] = s[pos + i];
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      int nrec = 0, p = pos, op = opos;
      while (nrec < DEC_RECS && p < len && p < wbase + DEC_WIN &&
             op < n_words) {
        const uint32_t w = win[p - wbase];
        const int nc = static_cast<int>((w >> 15) & 0xFFFFu);
        const int nd = static_cast<int>(w & 0x7FFFu);
        const int avail = len - (p + 1);
        const int nd_eff = nd < avail ? nd : avail;
        rec_out[nrec] = op;
        rec_in[nrec] = p + 1;
        rec_nc[nrec] = nc;
        rec_fill[nrec] = (w >> 31) ? 0xFFFFFFFFu : 0u;
        ++nrec;
        op += nc + nd_eff;
        p += 1 + nd;
      }
      rec_out[nrec] = op;  // end of the last record's span
      s_nrec = nrec;
      s_pos = p;
      s_opos = op;
      s_win = wbase;
    }
    __syncthreads();
    const int nrec = s_nrec;
    const int hi = min(rec_out[nrec], n_words);
    for (int oi = opos + static_cast<int>(threadIdx.x); oi < hi;
         oi += blockDim.x) {
      int a = 0, b = nrec - 1;  // largest a with rec_out[a] <= oi
      while (a < b) {
        const int mid = (a + b + 1) >> 1;
        if (rec_out[mid] <= oi) a = mid; else b = mid - 1;
      }
      const int off = oi - rec_out[a];
      uint32_t v;
      if (off < rec_nc[a]) {
        v = rec_fill[a];
      } else {
        const int ip = rec_in[a] + off - rec_nc[a];
        v = ip < wbase + DEC_WIN ? win[ip - wbase] : s[ip];
      }
      o[oi] = v;
    }
    __syncthreads();  // records and window are read before the next walk
  }
  for (int oi = (opos < n_words ? opos : n_words) + threadIdx.x; oi < n_words;
       oi += blockDim.x)
    o[oi] = 0u;
}

// streams: (R, C) words, R = B * m; lengths: (R,) int32; out: (m, B, n_words).
REPRO_EXPORT int launch_ewah_decode(int device, const void* streams, int C,
                                    const void* lengths, int m, int B,
                                    int n_words, void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m < 1 || B < 1 || C < 1 || n_words < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  ewah_decode_kernel<<<static_cast<unsigned>(m) * B, DEC_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(streams), C,
      static_cast<const int*>(lengths), m, B, n_words,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
