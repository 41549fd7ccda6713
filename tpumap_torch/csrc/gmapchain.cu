// K7a and K7b: the GMAP chain stage's sequential and gather-heavy work.
//
// Replaces: tpumap/ops/chain.py (vmapped over a group's problems inside
// tpumap/gmap/engine.py:_chain_pipeline_windows):
//   K7a chain_segments (chain.py:166-232) and engine.py:_compact_chain
//       (165-184): the stable argsort of the segments by qstart, the
//       max-plus DP over them with the float32 log1p gap cost, the
//       backtrack from the first best end, and the chain's first M valid
//       members in q order;
//   K7b region_oligos + region_index + anchors_from_query (chain.py:
//       31-116) at k <= 12 (the direct-address table branch): the
//       window's k-mer index and each query oligo's first max_occ hits
//       as anchors.
//
// K7a. Bound on the H100: a problem's S DP steps depend on each other
// (step j reads the scores of steps < j), so a problem costs S dependent
// block-wide reductions; its bytes (S segments in, M members out) take
// nanoseconds. Design: one block a problem, one thread a segment (S <=
// 1024). The block ranks the segments by (qstart key, index) in shared
// memory (a stable sort), then walks j: the threads i < j test whether j
// may follow i and compute their candidate (score_i less the gap cost,
// log1p in double then rounded, as the plain version computes it), each
// warp reduces its first maximum with shuffles and one thread reduces
// the warp maxima and sets score_j and prev_j. Thread 0 then walks the
// chain back and the block writes the members it marked, in q order.
// Float arithmetic uses the _rn intrinsics, so nvcc contracts nothing
// into an FMA the plain version does not have.
//
// K7b. Bound: the window's codes (R bytes and R valid flags) in and the
// anchors (Q x max_occ x 5 bytes) out; the index in between never leaves
// the SM but for a bucket list of R positions. Design: persistent blocks
// of 1,024 threads, each reusing one 4^k table of 16-bit entries (in
// shared memory up to k = 8, else in its scratch): (1) a count pass with
// shared-memory atomics that stops adding at 256 (only min(count, 255)
// is ever read: every test compares it with max_occ <= 128); (2) the
// table's counts saturated to a byte and an exclusive scan of
// min(count, max_occ) in rounds of 2,048 entries, the bucket starts;
// (3) an ordered scatter of each bucket's first max_occ positions: the
// block walks the window in tiles of 1,024 positions, __match_any_sync
// ranks equal oligos inside a warp, and warp 0 advances the buckets'
// cursors (each entry's high byte) warp by warp, so positions land in
// increasing order as tpumap's sort leaves them; (4) one thread an
// (oligo, lane) reads the anchors out.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int NEG = -(1 << 30);
constexpr int QKEY_INVALID = 1 << 30;
constexpr int DIAG_BIAS = 1 << 20;
constexpr int ANCHOR_INVALID = 0x7FFFFFFF;
constexpr int AB = 1024;            // K7b threads a block
constexpr int AW = AB / 32;
constexpr int SMEM_MAX = 227 * 1024;

// ------------------------------------------------------------ K7a

// (v, i) becomes the better of itself and (v2, i2): the larger value,
// the lower index on a tie (jnp.argmax's first maximum)
__device__ __forceinline__ void better(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  for (int off = 16; off; off >>= 1) {
    const float v2 = __shfl_down_sync(FULL, v, off);
    const int i2 = __shfl_down_sync(FULL, i, off);
    better(v, i, v2, i2);
  }
}

__global__ void __launch_bounds__(1024) chain_segments_kernel(
    const int32_t* __restrict__ diag, const int32_t* __restrict__ qstart,
    const int32_t* __restrict__ qend, const int32_t* __restrict__ weight,
    const bool* __restrict__ valid, int S, int M, int max_intron,
    float frac, int32_t* __restrict__ out_diag, int32_t* __restrict__ out_qs,
    int32_t* __restrict__ out_qe, bool* __restrict__ out_ok) {
  extern __shared__ int sm[];
  int* key = sm;                    // [S] sort key
  int* sd = key + S;                // [S] the segments in q order
  int* sqs = sd + S;
  int* sqe = sqs + S;
  int* sw = sqe + S;
  int* sv = sw + S;
  int* gs = sv + S;                 // [S] genomic start and end (biased)
  int* ge = gs + S;
  int* span = ge + S;
  float* score = reinterpret_cast<float*>(span + S);
  int* prev = reinterpret_cast<int*>(score + S);
  int* member = prev + S;
  float* rv = reinterpret_cast<float*>(member + S);   // [32] warp maxima
  int* ri = reinterpret_cast<int*>(rv + 32);          // [32] their indices
  int* nmem = ri + 32;

  const long long p = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int d = 0, qs = 0, qe = 0, w = 0, v = 0;
  if (t < S) {
    const long long o = p * S + t;
    d = diag[o];
    qs = qstart[o];
    qe = qend[o];
    w = weight[o];
    v = valid[o];
    key[t] = v ? qs : QKEY_INVALID;
  }
  __syncthreads();
  if (t < S) {                      // stable rank by key
    const int kt = key[t];
    int r = 0;
    for (int u = 0; u < S; ++u) {
      const int ku = key[u];
      r += (ku < kt) | ((ku == kt) & (u < t));
    }
    sd[r] = d;
    sqs[r] = qs;
    sqe[r] = qe;
    sw[r] = w;
    sv[r] = v;
  }
  __syncthreads();
  // thread i keeps segment i (in q order) in registers
  int qsi = 0, qei = 0, gei = 0, spi = 0, vi = 0;
  if (t < S) {
    qsi = sqs[t];
    qei = sqe[t];
    vi = sv[t];
    gei = sd[t] + qei;
    spi = max(qei - qsi + 1, 1);
    gs[t] = sd[t] + qsi;
    ge[t] = gei;
    span[t] = spi;
    score[t] = (float)NEG;
    member[t] = 0;
  }
  __syncthreads();
  for (int j = 0; j < S; ++j) {
    if (warp * 32 < j) {            // the warps holding some i < j
      float cv = (float)NEG;
      int ci = S;
      if (t < j && vi && sv[j]) {
        const int qsj = sqs[j], gsj = gs[j];
        const int overlap = max(qei - qsj + 1, 0);
        const int lim = (int)__fmul_rn((float)min(spi, span[j]), frac);
        if (qsj > qsi && gsj > gei && gsj - gei < max_intron &&
            overlap < lim) {
          const float gap =
              __fmul_rn((float)log1p((double)abs(gsj - gei)), 0.01f);
          cv = __fsub_rn(score[t], gap);
          ci = t;
        }
      }
      warp_argmax(cv, ci);
      if (lane == 0) {
        rv[warp] = cv;
        ri[warp] = ci;
      }
    }
    __syncthreads();
    if (t == 0) {
      float bv = (float)NEG;
      int bi = S;
      for (int x = 0; x < (j + 31) >> 5; ++x) better(bv, bi, rv[x], ri[x]);
      score[j] = sv[j] ? __fadd_rn((float)sw[j], fmaxf(bv, 0.0f))
                       : (float)NEG;
      prev[j] = bv > 0.0f ? bi : -1;
    }
    __syncthreads();
  }
  // the first best end, then the backtrack
  {
    float cv = t < S ? score[t] : __int_as_float(0xff800000);  // -inf
    int ci = t < S ? t : S;
    warp_argmax(cv, ci);
    if (lane == 0) {
      rv[warp] = cv;
      ri[warp] = ci;
    }
  }
  __syncthreads();
  if (t == 0) {
    float bv = rv[0];
    int cur = ri[0];
    for (int x = 1; x < (int)(blockDim.x >> 5); ++x)
      better(bv, cur, rv[x], ri[x]);
    int n = 0;
    for (; cur >= 0; cur = prev[cur], ++n) member[cur] = 1;
    *nmem = n;
  }
  __syncthreads();
  const long long ob = p * M;
  if (t < S && member[t]) {
    int m = 0;
    for (int u = 0; u < t; ++u) m += member[u];
    if (m < M) {
      const bool ok = sv[t];
      out_diag[ob + m] = ok ? sd[t] : 0;
      out_qs[ob + m] = ok ? sqs[t] : 0;
      out_qe[ob + m] = ok ? sqe[t] : 0;
      out_ok[ob + m] = ok;
    }
  }
  for (int m = *nmem + t; m < M; m += blockDim.x) {
    out_diag[ob + m] = 0;
    out_qs[ob + m] = 0;
    out_qe[ob + m] = 0;
    out_ok[ob + m] = false;
  }
}

// ------------------------------------------------------------ K7b

// the oligo starting at window position pos, or -1 where its k-window
// leaves the window or holds an invalid base
__device__ __forceinline__ int oligo_at(const uint8_t* __restrict__ c,
                                        const bool* __restrict__ v, int pos,
                                        int R, int k) {
  if (pos > R - k) return -1;
  int acc = 0;
  for (int j = 0; j < k; ++j) {
    if (!v[pos + j]) return -1;
    acc = (acc << 2) | c[pos + j];
  }
  return acc;
}

// inclusive block scan of x over AB threads; *total gets the block's sum
__device__ int block_scan(int x, int* wsum, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(FULL, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = wsum[lane];             // AW == 32
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL, s, off);
      if (lane >= off) s += y;
    }
    wsum[lane] = s;
  }
  __syncthreads();
  const int out = x + (warp ? wsum[warp - 1] : 0);
  *total = wsum[AW - 1];
  __syncthreads();
  return out;
}

__global__ void __launch_bounds__(AB, 1) region_anchors_kernel(
    const uint8_t* __restrict__ codes, const bool* __restrict__ rvalid,
    const int32_t* __restrict__ qolig, const bool* __restrict__ qvalid,
    int N, int R, int Q, int k, int max_occ, int keep, int table_global,
    int32_t* __restrict__ scratch, int32_t* __restrict__ diag_out,
    bool* __restrict__ ok_out) {
  extern __shared__ uint32_t smem[];
  const int T = 1 << (2 * k);
  const int TW = T / 2;             // table words, two 16-bit entries each
  const long long per_block = (long long)T + 1 + R + (table_global ? TW : 0);
  int32_t* starts = scratch + blockIdx.x * per_block;
  int32_t* lists = starts + T + 1;
  // entry o: bits 0-7 min(count, 255), bits 8-15 the bucket's cursor
  // (during the count pass the whole 16 bits count, below 256 + AB)
  volatile uint32_t* table =
      table_global ? reinterpret_cast<uint32_t*>(lists + R) : smem;
  int* tile_o = reinterpret_cast<int*>(smem + (table_global ? 0 : TW));
  int* tile_n = tile_o + AB;
  int* tile_b = tile_n + AB;
  int* wsum = tile_b + AB;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  for (long long p = blockIdx.x; p < N; p += gridDim.x) {
    const uint8_t* c = codes + p * R;
    const bool* v = rvalid + p * R;
    for (int x = t; x < TW; x += AB) table[x] = 0;
    __syncthreads();
    // (1) counts
    for (int pos = t; pos < R; pos += AB) {
      const int o = oligo_at(c, v, pos, R, k);
      if (o >= 0) {
        const int sh = 16 * (o & 1);
        if (((table[o >> 1] >> sh) & 0xFFFF) < 256)
          atomicAdd((uint32_t*)&table[o >> 1], 1u << sh);
      }
    }
    __syncthreads();
    // (2) saturate, and the bucket starts (a thread takes a word)
    int carry = 0;
    for (int base = 0; base < TW; base += AB) {
      const int x = base + t;
      int k0 = 0, k1 = 0;
      if (x < TW) {
        const uint32_t wv = table[x];
        const int c0 = min((int)(wv & 0xFFFF), 255);
        const int c1 = min((int)(wv >> 16), 255);
        table[x] = (uint32_t)c0 | ((uint32_t)c1 << 16);
        k0 = min(c0, max_occ);
        k1 = min(c1, max_occ);
      }
      int total;
      const int incl = block_scan(k0 + k1, wsum, &total);
      if (x < TW) {
        const int excl = carry + incl - k0 - k1;
        starts[2 * x] = excl;
        starts[2 * x + 1] = excl + k0;
      }
      carry += total;
    }
    __syncthreads();
    // (3) each kept bucket's first max_occ positions, in order
    for (int base = 0; base < R; base += AB) {
      const int pos = base + t;
      int o = pos < R ? oligo_at(c, v, pos, R, k) : -1;
      if (o >= 0 && !keep &&
          (int)((table[o >> 1] >> (16 * (o & 1))) & 0xFF) > max_occ)
        o = -1;                     // an overabundant oligo is never read
      const unsigned peers = __match_any_sync(FULL, o);
      const int leader = __ffs(peers) - 1;
      const int rank = __popc(peers & ((1u << lane) - 1));
      tile_o[t] = lane == leader ? o : -1;
      tile_n[t] = __popc(peers);
      __syncthreads();
      if (warp == 0) {
        for (int w = 0; w < AW; ++w) {
          const int oo = tile_o[w * 32 + lane];
          if (oo >= 0) {
            const int sh = 16 * (oo & 1) + 8;
            int cur = (table[oo >> 1] >> sh) & 0xFF;
            // cursors stop past max_occ: at most max_occ - 1 + 32 < 256
            if (cur < max_occ)
              cur = (atomicAdd((uint32_t*)&table[oo >> 1],
                               (uint32_t)tile_n[w * 32 + lane] << sh) >>
                     sh) & 0xFF;
            tile_b[w * 32 + lane] = cur;
          }
          __syncwarp();
        }
      }
      __syncthreads();
      if (o >= 0) {
        const int r = tile_b[warp * 32 + leader] + rank;
        if (r < max_occ) lists[starts[o] + r] = pos;
      }
    }
    __syncthreads();
    // (4) the anchors
    const long long ob = p * Q;
    for (long long x = t; x < (long long)Q * max_occ; x += AB) {
      const int q = (int)(x / max_occ), l = (int)(x % max_occ);
      int dv = ANCHOR_INVALID;
      bool ok = false;
      if (qvalid[ob + q]) {
        const int o = qolig[ob + q];
        const int cnt =
            o < T ? (int)((table[o >> 1] >> (16 * (o & 1))) & 0xFF) : 0;
        if (l < cnt && (keep || cnt <= max_occ)) {
          ok = true;
          dv = lists[starts[o] + l] - q + DIAG_BIAS;
        }
      }
      diag_out[ob * max_occ + x] = dv;
      ok_out[ob * max_occ + x] = ok;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int tt_chain_segments(const void* diag, const void* qstart,
                                 const void* qend, const void* weight,
                                 const void* valid, int N, int S, int M,
                                 int max_intron, float frac, void* out_diag,
                                 void* out_qs, void* out_qe, void* out_ok,
                                 void* stream) {
  if (S < 1 || S > 1024 || M < 1 || M > S) return (int)cudaErrorInvalidValue;
  const int threads = (S + 31) / 32 * 32;
  const int bytes = (12 * S + 65) * 4;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        chain_segments_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return (int)err;
  }
  chain_segments_kernel<<<N, threads, bytes, (cudaStream_t)stream>>>(
      (const int32_t*)diag, (const int32_t*)qstart, (const int32_t*)qend,
      (const int32_t*)weight, (const bool*)valid, S, M, max_intron, frac,
      (int32_t*)out_diag, (int32_t*)out_qs, (int32_t*)out_qe,
      (bool*)out_ok);
  return (int)cudaGetLastError();
}

extern "C" int tt_region_anchors(const void* codes, const void* rvalid,
                                 const void* qolig, const void* qvalid, int N,
                                 int R, int Q, int k, int max_occ, int keep,
                                 int G, int table_global, void* scratch,
                                 void* diag, void* ok, void* stream) {
  if (k < 1 || k > 12 || max_occ < 1 || max_occ > 128 || G < 1)
    return (int)cudaErrorInvalidValue;
  const int TW = (1 << (2 * k)) / 2;
  const int bytes = (table_global ? 0 : TW * 4) + (3 * AB + AW) * 4;
  if (bytes > SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        region_anchors_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return (int)err;
  }
  region_anchors_kernel<<<G, AB, bytes, (cudaStream_t)stream>>>(
      (const uint8_t*)codes, (const bool*)rvalid, (const int32_t*)qolig,
      (const bool*)qvalid, N, R, Q, k, max_occ, keep, table_global,
      (int32_t*)scratch, (int32_t*)diag, (bool*)ok);
  return (int)cudaGetLastError();
}
