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
// first-maximum reductions; its bytes (S segments in, M members out)
// take nanoseconds. Design: one warp a problem (four, two or one a block
// as their shared slices fit), no block barrier. The warp sorts its
// segments by (qstart key, index) with a bitonic sort in its slice (a
// stable order, as the plain version's stable argsort), then tests every
// pair once, off the DP's chain: a bit for each (j, i) where j may
// follow i (lane l tests j = l + 32 r against 32 i at a time, broadcast
// reads). The DP walks j with a lane holding the scores of segments
// lane, lane + 32, ... in registers (P = ceil(S / 32) of them): its
// candidates (score_i less the gap cost), its own first maximum, and one
// xor-shuffle argmax that leaves score_j and prev_j in every lane. The
// gap cost (log1p in double, rounded, as the plain version computes it)
// depends only on the gap, below max_intron for every candidate: it
// comes from a table of every gap's cost that the first call on a device
// fills (a double log1p for each of S(S-1)/2 pairs inside one warp's
// steps was slower than the one-block-a-problem kernel at S = 512),
// and step j loads step j + 1's costs beside its own reduction. Lane 0 walks
// the chain back and the warp writes the members it marked, in q order,
// with a ballot prefix. Float arithmetic uses the _rn intrinsics, so
// nvcc contracts nothing into an FMA the plain version does not have.
//
// K7b. Bound: the window's codes (R bytes and R valid flags) and the
// query's oligos in, the anchors (Q x max_occ x 5 bytes) out. Design:
// a window's positions are cut into chunks of C (1,024-16,384) and
// every chunk is one work item, so one long window fills the card; only
// the query's oligos are indexed. Four kernels, one call:
//   (1) count: persistent blocks each hold a slot table (oligo -> its
//       slot, the query's first position with that oligo: 16-bit
//       entries for 4^k <= 65,536 in shared memory, else 32-bit in the
//       block's scratch), filled to "absent" once; a block sets only the
//       query's entries when it takes a new window (O(Q), not O(4^k))
//       and clears only those. A chunk is walked in tiles of 8,192
//       positions, 8 a thread (the oligo rolled over them), the next
//       tile's codes (or the next item's first) loaded while a tile is
//       scanned and the next window's query oligos while a window is:
//       each position's slot, the tile's hits compacted in position
//       order (a ballot and a block prefix) to the chunk's hit list, and
//       a count a (chunk, slot) with atomics (warp-aggregated where a
//       warp holds many hits);
//   (2) scan: one thread a slot pair walks a window's chunks: each
//       chunk's base rank for a slot (an exclusive scan, saturated at
//       255) and the slot's total (a window of one chunk: the count
//       pass's block does it, and the scan kernel is not launched);
//   (3) place: a block a chunk ranks its hits by (slot, position), in
//       tiles of 256: a warp ranks equal slots with __match_any_sync,
//       and a leader whose slot an earlier warp of the tile holds (a
//       mask a hashed slot) adds their hits with a ballot each, stopping
//       once the rank passes max_occ; a hit whose rank is below max_occ
//       writes its diagonal to its slot's anchor lane. A chunk whose
//       base for a slot is >= max_occ writes nothing for it; an
//       overabundant slot (total > max_occ without keep) is never
//       written;
//   (4) fill: one thread four anchor lanes (one where 4 does not divide
//       max_occ): ok and the invalid lanes, and a repeated oligo's
//       lanes copied from its slot's.
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int NEG = -(1 << 30);
constexpr int QKEY_INVALID = 1 << 30;
constexpr int DIAG_BIAS = 1 << 20;
constexpr int ANCHOR_INVALID = 0x7FFFFFFF;
constexpr int AB = 1024;            // K7b count threads a block
constexpr int AW = AB / 32;
constexpr int PT = 8;               // count: window positions a thread a tile
constexpr int TILE = PT * AB;
constexpr int QREG = 2;             // count: query oligos a thread keeps
constexpr int PB = 256;             // place threads a block, hits a tile
constexpr int HM = 1024;            // place: warp masks, hashed by slot
constexpr int SLOT_ABSENT = 0x7FFFFFFF;
constexpr int SMEM_MAX = 227 * 1024;

// (v, i) becomes the better of itself and (v2, i2): the larger value,
// the lower index on a tie (jnp.argmax's first maximum)
__device__ __forceinline__ void better(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// every lane gets the warp's first maximum
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  for (int off = 16; off; off >>= 1) {
    const float v2 = __shfl_xor_sync(FULL, v, off);
    const int i2 = __shfl_xor_sync(FULL, i, off);
    better(v, i, v2, i2);
  }
}

int grid_for(long long total, int threads) {
  const long long g = (total + threads - 1) / threads;
  return (int)(g < (1 << 20) ? g : (1 << 20));
}

__device__ __forceinline__ unsigned lanemask_lt() {
  return (1u << (threadIdx.x & 31)) - 1;
}

// ------------------------------------------------------------ K7a

// A warp's shared slice, for 32 P segments
template <int P>
struct ChainSlice {
  unsigned long long key[32 * P];   // (qstart key, index), sorted
  int4 a[32 * P];                   // q order: qstart, qend, gstart, gend
  int4 b[32 * P];                   // span, valid, weight, diag
  int ge[32 * P];                   // gend again, read a lane a word
  int prev[32 * P];
  unsigned member[P];
  unsigned follows[32 * P][P];      // bit l of [j][p]: j may follow l + 32 p
};

// problems (warps) a block: four while their slices fit
template <int P>
__host__ __device__ constexpr int chain_warps() {
  return P <= 8 ? 4 : P == 16 ? 2 : 1;
}

// the gap cost of a genomic gap x >= 0, as the plain version rounds it
__device__ __forceinline__ float gap_cost(int x) {
  return __fmul_rn((float)log1p((double)x), 0.01f);
}

// tab[x] = gap_cost(x) for x < TG: the costs the DP looks up
__global__ void chain_gap_table_kernel(int TG, float* __restrict__ tab) {
  for (int x = blockIdx.x * blockDim.x + threadIdx.x; x < TG;
       x += gridDim.x * blockDim.x)
    tab[x] = gap_cost(x);
}

// step j's candidates for the lane's segments i = lane + 32 p: bit p of
// the returned mask where j may follow i (from s.follows), g[p] its gap
// cost, looked up in tab (every gap j may follow i across is below
// max_intron; tab[0] where it may not). The loads are unconditional and
// used a step later, so their latency hides behind a step of the chain
template <int P>
__device__ __forceinline__ unsigned step_gaps(const ChainSlice<P>& s, int j,
                                              int lane, const float* tab,
                                              float (&g)[P]) {
  const int gsj = s.a[j].z;
  unsigned allowed = 0;
#pragma unroll
  for (int q = 0; q < P; ++q) {
    if (P > 4 && 32 * q >= j) break;   // many rows: skip those past j
    const bool ok = (s.follows[j][q] >> lane) & 1;
    allowed |= (unsigned)ok << q;
    g[q] = __ldg(tab + (ok ? gsj - s.ge[lane + 32 * q] : 0));
  }
  return allowed;
}

// DP step j: the lane's first best candidate, the warp's by one xor-
// shuffle argmax (every lane gets it), score_j and prev_j into their
// owner's registers
template <int P>
__device__ __forceinline__ void dp_step(const ChainSlice<P>& s, int j,
                                        int lane, float (&sc)[P],
                                        int (&pv)[P], unsigned allowed,
                                        const float (&g)[P]) {
  float bv = -CUDART_INF_F;
  int bi = 0x7FFFFFFF;
#pragma unroll
  for (int q = 0; q < P; ++q) {
    if (P > 4 && 32 * q >= j) break;
    const float v = (allowed >> q) & 1 ? __fsub_rn(sc[q], g[q])
                                       : -CUDART_INF_F;
    if (v > bv) {
      bv = v;
      bi = lane + 32 * q;
    }
  }
  const int4 bj = s.b[j];
  warp_argmax(bv, bi);
  const float sj = bj.y ? __fadd_rn((float)bj.z, fmaxf(bv, 0.0f))
                        : (float)NEG;
  const int pj = bv > 0.0f ? bi : -1;
#pragma unroll
  for (int q = 0; q < P; ++q)
    if (lane + 32 * q == j) {
      sc[q] = sj;
      pv[q] = pj;
    }
}

template <int P>
__global__ void __launch_bounds__(32 * chain_warps<P>())
    chain_segments_kernel(
    const int32_t* __restrict__ diag, const int32_t* __restrict__ qstart,
    const int32_t* __restrict__ qend, const int32_t* __restrict__ weight,
    const bool* __restrict__ valid, int N, int S, int M, int max_intron,
    float frac, const float* __restrict__ tab,
    int32_t* __restrict__ out_diag, int32_t* __restrict__ out_qs,
    int32_t* __restrict__ out_qe, bool* __restrict__ out_ok) {
  constexpr int L = 32 * P;
  extern __shared__ __align__(16) unsigned char sm7a[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long p = (long long)blockIdx.x * chain_warps<P>() + warp;
  if (p >= N) return;               // a whole warp; no block barrier below
  ChainSlice<P>& s = reinterpret_cast<ChainSlice<P>*>(sm7a)[warp];
  const long long o0 = p * S;
  for (int r = lane; r < L; r += 32)
    s.key[r] = r < S ? ((unsigned long long)(valid[o0 + r] ? qstart[o0 + r]
                                                           : QKEY_INVALID)
                        << 32) | (unsigned)r
                     : ~0ull;
  if (lane < P) s.member[lane] = 0;
  __syncwarp();
  // bitonic sort of the L keys (unique: the index breaks ties)
  for (int size = 2; size <= L; size <<= 1)
    for (int stride = size >> 1; stride; stride >>= 1) {
      for (int x = lane; x < L / 2; x += 32) {
        const int i = 2 * x - (x & (stride - 1)), i2 = i + stride;
        const unsigned long long u = s.key[i], v = s.key[i2];
        if ((u > v) == ((i & size) == 0)) {
          s.key[i] = v;
          s.key[i2] = u;
        }
      }
      __syncwarp();
    }
  for (int r = lane; r < S; r += 32) {
    const long long o = o0 + (int)(s.key[r] & 0xFFFFFFFFu);
    const int d = diag[o], qs = qstart[o], qe = qend[o];
    s.a[r] = make_int4(qs, qe, d + qs, d + qe);
    s.b[r] = make_int4(max(qe - qs + 1, 1), valid[o], weight[o], d);
    s.ge[r] = d + qe;
  }
  __syncwarp();
  // which i each j may follow, before the DP and off its chain: lane l
  // takes j = l + 32 r and tests the i of blocks q <= r, 32 at a time
  // (one i a test for every lane: broadcast reads)
  for (int r = 0; r < P; ++r) {
    const int j = lane + 32 * r;
    const int4 aj = s.a[j], bj = s.b[j];
    for (int q = 0; q <= r; ++q) {
      unsigned w = 0;
#pragma unroll 8
      for (int x = 0; x < 32; ++x) {
        const int i = 32 * q + x;
        const int4 ai = s.a[i], bi = s.b[i];
        const int overlap = max(ai.y - aj.x + 1, 0);
        const int lim = (int)__fmul_rn((float)min(bi.x, bj.x), frac);
        const bool ok = i < j && j < S && bj.y && bi.y && aj.x > ai.x &&
                        aj.z > ai.w && aj.z - ai.w < max_intron &&
                        overlap < lim;
        w |= (unsigned)ok << x;
      }
      s.follows[j][q] = w;
    }
    for (int q = r + 1; q < P; ++q) s.follows[j][q] = 0;
  }
  __syncwarp();
  // two sets of gap costs in registers, steps taken in pairs: step j's,
  // and step j + 1's loads in flight while step j reduces
  float sc[P], ga[P], gb[P];
  int pv[P];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    sc[q] = lane + 32 * q < S ? (float)NEG : -CUDART_INF_F;
    ga[q] = 0.0f;
    pv[q] = -1;
  }
  unsigned ma = 0, mb;              // step 0 has no candidate
  int j = 0;
  for (; j + 1 < S; j += 2) {
    mb = step_gaps<P>(s, j + 1, lane, tab, gb);
    dp_step<P>(s, j, lane, sc, pv, ma, ga);
    ma = step_gaps<P>(s, min(j + 2, S - 1), lane, tab, ga);
    dp_step<P>(s, j + 1, lane, sc, pv, mb, gb);
  }
  if (j < S) dp_step<P>(s, j, lane, sc, pv, ma, ga);
#pragma unroll
  for (int q = 0; q < P; ++q) s.prev[lane + 32 * q] = pv[q];
  // the first best end, then the backtrack
  float bv = -CUDART_INF_F;
  int cur = 0x7FFFFFFF;
#pragma unroll
  for (int q = 0; q < P; ++q)
    if (sc[q] > bv) {
      bv = sc[q];
      cur = lane + 32 * q;
    }
  warp_argmax(bv, cur);
  __syncwarp();
  if (lane == 0)
    for (; cur >= 0; cur = s.prev[cur]) s.member[cur >> 5] |= 1u << (cur & 31);
  __syncwarp();
  const long long ob = p * M;
  int n = 0;
  for (int r0 = 0; r0 < S; r0 += 32) {
    const unsigned word = s.member[r0 >> 5];
    const int m = n + __popc(word & lanemask_lt());
    if (((word >> lane) & 1) && m < M) {
      const int4 a = s.a[r0 + lane], b = s.b[r0 + lane];
      const bool ok = b.y;
      out_diag[ob + m] = ok ? b.w : 0;
      out_qs[ob + m] = ok ? a.x : 0;
      out_qe[ob + m] = ok ? a.y : 0;
      out_ok[ob + m] = ok;
    }
    n += __popc(word);
  }
  for (int m = n + lane; m < M; m += 32) {
    out_diag[ob + m] = 0;
    out_qs[ob + m] = 0;
    out_qe[ob + m] = 0;
    out_ok[ob + m] = false;
  }
}

template <int P>
int launch_chain(const int32_t* diag, const int32_t* qstart,
                 const int32_t* qend, const int32_t* weight,
                 const bool* valid, int N, int S, int M, int max_intron,
                 float frac, const float* tab, int32_t* od,
                 int32_t* oqs, int32_t* oqe, bool* ook, cudaStream_t stream) {
  constexpr int W = chain_warps<P>();
  const int bytes = (int)sizeof(ChainSlice<P>) * W;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        chain_segments_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return (int)err;
  }
  chain_segments_kernel<P><<<(N + W - 1) / W, 32 * W, bytes, stream>>>(
      diag, qstart, qend, weight, valid, N, S, M, max_intron, frac, tab, od,
      oqs, oqe, ook);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ K7b

// four codes, each 4 where its valid byte (0 or 1) is 0
__device__ __forceinline__ uint32_t mask_codes(uint32_t c, uint32_t v) {
  const uint32_t m = (v ^ 0x01010101u) * 0xFFu;
  return (c & ~m) | (0x04040404u & m);
}

// The slot table: 16-bit entries in shared memory (0xFFFF absent), or
// 32-bit ones in the block's scratch (SLOT_ABSENT)
template <bool GT>
struct SlotTable {
  uint32_t* w;                      // shared words, two entries each
  int32_t* g;                       // the block's global table
  __device__ int get(int o) const {
    if (GT) {
      const int v = g[o];
      return v == SLOT_ABSENT ? -1 : v;
    }
    const int v = reinterpret_cast<const uint16_t*>(w)[o];
    return v == 0xFFFF ? -1 : v;
  }
  __device__ void set_min(int o, int q) {
    if (GT) {
      atomicMin(&g[o], q);
      return;
    }
    const int sh = 16 * (o & 1);
    uint32_t old = w[o >> 1];
    while ((int)((old >> sh) & 0xFFFF) > q) {
      const uint32_t nw = (old & ~(0xFFFFu << sh)) | ((uint32_t)q << sh);
      const uint32_t seen = atomicCAS(&w[o >> 1], old, nw);
      if (seen == old) break;
      old = seen;
    }
  }
  __device__ void clear(int o) {
    if (GT)
      g[o] = SLOT_ABSENT;
    else
      reinterpret_cast<uint16_t*>(w)[o] = 0xFFFF;
  }
};

// query position q's oligo where it can have hits (valid, below 4^k),
// else -1
__device__ __forceinline__ int query_oligo(const int32_t* qolig,
                                           const bool* qvalid, long long nq,
                                           int T) {
  const int o = qolig[nq];
  return qvalid[nq] && (unsigned)o < (unsigned)T ? o : -1;
}

template <bool GT>
__global__ void __launch_bounds__(AB, 1) region_anchors_count_kernel(
    const uint8_t* __restrict__ codes, const bool* __restrict__ rvalid,
    const int32_t* __restrict__ qolig, const bool* __restrict__ qvalid,
    int N, int R, int Q, int k, int C, int nch, int Qw,
    int32_t* __restrict__ table, uint32_t* __restrict__ cnt,
    int2* __restrict__ hits, int32_t* __restrict__ nhit,
    int32_t* __restrict__ rep, int32_t* __restrict__ tot) {
  extern __shared__ uint32_t smem[];
  const int T = 1 << (2 * k);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  SlotTable<GT> tab{smem, GT ? table + (long long)blockIdx.x * T : nullptr};
  const int TW = GT ? 0 : ((T + 1) / 2 + 3) & ~3;
  uint8_t* sc = reinterpret_cast<uint8_t*>(smem + TW);   // TILE + 16 codes
  int* wsum = reinterpret_cast<int*>(smem + TW + (TILE + 16) / 4);
  if (GT)
    for (int x = t; x < T; x += AB) tab.g[x] = SLOT_ABSENT;
  else
    for (int x = t; x < TW; x += AB) smem[x] = FULL;
  // the oligos of query positions t and t + AB of the block's window
  // (cur), and of its next one (nxt) as loaded a window ahead (nraw,
  // nval: decoded when the window starts, so no thread waits on the
  // loads before); positions past 2 AB are read where they are used
  long long cur = -1, nxt = -1;
  int co[QREG], nraw[QREG];
  bool nval[QREG];
  auto load_query = [&](long long w) {
#pragma unroll
    for (int r = 0; r < QREG; ++r) {
      const long long nq = w * Q + min(t + r * AB, Q - 1);
      nraw[r] = qolig[nq];
      nval[r] = qvalid[nq];
    }
  };
  // a tile's codes (4 for an invalid base). Where a window's rows are
  // 8-byte aligned they come a tile ahead into registers (across items
  // too: ahead), thread t's own 8 and, for t < 4, 4 of the overhang past
  // the tile; else a byte a load when the tile starts
  const bool vec = (R & 7) == 0 &&
                   ((reinterpret_cast<uintptr_t>(codes) |
                     reinterpret_cast<uintptr_t>(rvalid)) & 7) == 0;
  // (codes and valid bytes as loaded, masked when the tile is stored,
  // so no thread waits on the loads before)
  uint2 fc8 = make_uint2(0, 0), fv8 = make_uint2(0, 0);
  uint32_t fc4 = 0, fv4 = 0;
  bool ahead = false;
  auto fetch = [&](const uint8_t* fc, const bool* fv, int b0) {
    const int pos = b0 + PT * t;
    fc8 = fv8 = make_uint2(0, 0);
    if (pos < R) {
      fc8 = *reinterpret_cast<const uint2*>(fc + pos);
      fv8 = *reinterpret_cast<const uint2*>(fv + pos);
    }
    const int p2 = b0 + TILE + 4 * t;
    fc4 = fv4 = 0;
    if (t < 4 && p2 < R) {
      fc4 = *reinterpret_cast<const uint32_t*>(fc + p2);
      fv4 = *reinterpret_cast<const uint32_t*>(fv + p2);
    }
  };
  const long long items = (long long)N * nch;
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const long long n = it / nch;
    const int c = (int)(it % nch);
    if (n != cur) {
      if (n != nxt) load_query(n);
      int no[QREG];
#pragma unroll
      for (int r = 0; r < QREG; ++r)
        no[r] = t + r * AB < Q && nval[r] && (unsigned)nraw[r] < (unsigned)T
                    ? nraw[r]
                    : -1;
      __syncthreads();
      if (cur >= 0) {
#pragma unroll
        for (int r = 0; r < QREG; ++r)
          if (co[r] >= 0) tab.clear(co[r]);
        for (int q = t + QREG * AB; q < Q; q += AB) {
          const int o = query_oligo(qolig, qvalid, cur * Q + q, T);
          if (o >= 0) tab.clear(o);
        }
      }
      __syncthreads();
      // each oligo's slot is its first query position: a warp's lanes
      // hold consecutive q, so its lowest lane of an oligo sets it
      for (int q0 = 0; q0 < Q; q0 += AB) {
        const int r = q0 / AB;
        int o = -1;
#pragma unroll
        for (int x = 0; x < QREG; ++x)
          if (x == r) o = no[x];
        if (r >= QREG && q0 + t < Q)
          o = query_oligo(qolig, qvalid, n * Q + q0 + t, T);
        const unsigned peers = __match_any_sync(FULL, o);
        if (o >= 0 && lane == __ffs(peers) - 1) tab.set_min(o, q0 + t);
      }
#pragma unroll
      for (int r = 0; r < QREG; ++r) co[r] = no[r];
      __syncthreads();
      cur = n;
      // the next window of this block, loaded while this one is walked
      const long long n2 = (it + gridDim.x) / nch;
      if (it + gridDim.x < items && n2 != n) {
        nxt = n2;
        load_query(n2);
      }
    }
    if (c == 0) {
#pragma unroll
      for (int r = 0; r < QREG; ++r)
        if (t + r * AB < Q) rep[n * Q + t + r * AB] = co[r] >= 0
                                                          ? tab.get(co[r])
                                                          : -1;
      for (int q = t + QREG * AB; q < Q; q += AB) {
        const int o = query_oligo(qolig, qvalid, n * Q + q, T);
        rep[n * Q + q] = o >= 0 ? tab.get(o) : -1;
      }
    }
    uint32_t* row = cnt + (n * nch + c) * (long long)Qw;
    for (int x = t; x < Qw; x += AB) row[x] = 0;
    const uint8_t* cw = codes + n * R;
    const bool* vw = rvalid + n * R;
    int2* hl = hits + n * R + (long long)c * C;
    const int lo = c * C, hi = min(R, lo + C);
    if (vec && !ahead) fetch(cw, vw, lo);
    ahead = false;
    int nh = 0;
    for (int base = lo; base < hi; base += TILE) {
      __syncthreads();
      if (vec) {
        reinterpret_cast<uint2*>(sc)[t] =
            make_uint2(mask_codes(fc8.x, fv8.x), mask_codes(fc8.y, fv8.y));
        if (t < 4)
          reinterpret_cast<uint32_t*>(sc)[TILE / 4 + t] =
              mask_codes(fc4, fv4);
      } else {
        for (int x = t; x < TILE + 16; x += AB) {
          const int pos = base + x;
          sc[x] = pos < R && vw[pos] ? cw[pos] : 4;
        }
      }
      __syncthreads();
      if (vec && base + TILE < hi) {
        fetch(cw, vw, base + TILE);
      } else if (vec && it + gridDim.x < items) {
        // the block's next item's first tile, while this one is scanned
        const long long n2 = (it + gridDim.x) / nch;
        fetch(codes + n2 * R, rvalid + n2 * R,
              (int)((it + gridDim.x) % nch) * C);
        ahead = true;
      }
      // thread t's positions base + PT t + x, in order: the oligo rolls
      // over its PT + k - 1 codes (read a word at a time), bad the last
      // invalid one's index
      uint32_t my[(PT + 11 + 3) / 4];
#pragma unroll
      for (int w = 0; w < (PT + 11 + 3) / 4; ++w)
        my[w] = reinterpret_cast<const uint32_t*>(sc)[PT / 4 * t + w];
      int o = 0, bad = -1;
#pragma unroll
      for (int j = 0; j < 11; ++j)
        if (j < k - 1) {
          const int b = (my[j >> 2] >> (8 * (j & 3))) & 0xFF;
          if (b > 3) bad = j;
          o = (o << 2) | (b & 3);
        }
      // u: the codes from k - 1 on, so code x + k - 1 is u's byte x
      const int d = (k - 1) >> 2, sh = 8 * ((k - 1) & 3);
      uint32_t u[PT / 4];
#pragma unroll
      for (int w = 0; w < PT / 4; ++w) {
        const uint32_t lo = d == 0 ? my[w] : d == 1 ? my[w + 1] : my[w + 2];
        const uint32_t hi =
            d == 0 ? my[w + 1] : d == 1 ? my[w + 2] : my[w + 3];
        u[w] = __funnelshift_r(lo, hi, sh);
      }
      int s[PT], mine = 0;
#pragma unroll
      for (int x = 0; x < PT; ++x) {
        const int b = (u[x >> 2] >> (8 * (x & 3))) & 0xFF;
        if (b > 3) bad = x + k - 1;
        o = ((o << 2) | (b & 3)) & (T - 1);
        const int pos = base + PT * t + x;
        const int slot = tab.get(o);  // o < 4^k: read unconditionally
        s[x] = bad < x && pos < hi && pos <= R - k ? slot : -1;
        mine += s[x] >= 0;
      }
      // counts a (chunk, slot): a warp with many hits aggregates equal
      // slots first (a poly-A tile), a sparse one adds each hit
#pragma unroll
      for (int x = 0; x < PT; ++x) {
        const unsigned hm = __ballot_sync(FULL, s[x] >= 0);
        if (__popc(hm) > 4) {
          const unsigned peers = __match_any_sync(FULL, s[x]);
          if (s[x] >= 0 && lane == __ffs(peers) - 1)
            atomicAdd(&row[s[x] >> 1], (uint32_t)__popc(peers)
                                           << (16 * (s[x] & 1)));
        } else if (s[x] >= 0) {
          atomicAdd(&row[s[x] >> 1], 1u << (16 * (s[x] & 1)));
        }
      }
      // the tile's hits compacted in position order: a block prefix
      int incl = mine;
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, off);
        if (lane >= off) incl += y;
      }
      if (lane == 31) wsum[warp] = incl;
      __syncthreads();
      if (warp == 0) {
        int v = wsum[lane];
        for (int off = 1; off < 32; off <<= 1) {
          const int y = __shfl_up_sync(FULL, v, off);
          if (lane >= off) v += y;
        }
        wsum[lane] = v;
      }
      __syncthreads();
      int at = nh + (warp ? wsum[warp - 1] : 0) + incl - mine;
#pragma unroll
      for (int x = 0; x < PT; ++x)
        if (s[x] >= 0) hl[at++] = make_int2(s[x], base + PT * t + x);
      nh += wsum[AW - 1];
    }
    if (t == 0) nhit[n * nch + c] = nh;
    if (nch == 1) {
      // a window of one chunk: its counts are its totals, its bases 0
      // (the scan kernel's work, here while the row is in L2)
      __syncthreads();
      for (int w = t; w < Qw; w += AB) {
        const uint32_t v = __ldcg(&row[w]);
        tot[n * Q + 2 * w] = min((int)(v & 0xFFFF), 255);
        if (2 * w + 1 < Q) tot[n * Q + 2 * w + 1] = min((int)(v >> 16), 255);
        row[w] = 0;
      }
    }
  }
}

// per (window, slot pair): each chunk's count becomes its base rank
// (exclusive, saturated at 255), and the slots' totals
__global__ void region_anchors_scan_kernel(int N, int Q, int nch, int Qw,
                                           uint32_t* __restrict__ cnt,
                                           int32_t* __restrict__ tot) {
  for (long long x = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       x < (long long)N * Qw; x += (long long)gridDim.x * blockDim.x) {
    const long long n = x / Qw;
    const int w = (int)(x % Qw);
    uint32_t* col = cnt + n * nch * (long long)Qw + w;
    int r0 = 0, r1 = 0;
#pragma unroll 8
    for (int c = 0; c < nch; ++c) {
      const uint32_t v = col[(long long)c * Qw];
      col[(long long)c * Qw] = (uint32_t)min(r0, 255) |
                               ((uint32_t)min(r1, 255) << 16);
      r0 += v & 0xFFFF;
      r1 += v >> 16;
    }
    tot[n * Q + 2 * w] = min(r0, 255);
    if (2 * w + 1 < Q) tot[n * Q + 2 * w + 1] = min(r1, 255);
  }
}

__global__ void __launch_bounds__(PB) region_anchors_place_kernel(
    int R, int Q, int C, int nch, int Qw, int max_occ, int keep,
    uint32_t* __restrict__ cnt, const int2* __restrict__ hits,
    const int32_t* __restrict__ nhit, const int32_t* __restrict__ tot,
    int32_t* __restrict__ diag_out) {
  __shared__ int tslot[PB];
  __shared__ uint32_t wm[HM];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long n = blockIdx.x / nch;
  const int c = blockIdx.x % nch;
  for (int x = t; x < HM; x += PB) wm[x] = 0;
  __syncthreads();
  const int nh = nhit[blockIdx.x];
  // the chunk's count row holds each slot's base, then its cursor
  uint32_t* row = cnt + (long long)blockIdx.x * Qw;
  const int2* hl = hits + n * R + (long long)c * C;
  for (int base = 0; base < nh; base += PB) {
    int s = -1, pos = 0, cur = 0;
    if (base + t < nh) {
      const int2 e = hl[base + t];
      s = e.x;
      pos = e.y;
      cur = (__ldcg(&row[s >> 1]) >> (16 * (s & 1))) & 0xFFFF;
      if (cur >= max_occ || (!keep && tot[n * Q + s] > max_occ)) s = -1;
    }
    tslot[t] = s;
    const unsigned peers = __match_any_sync(FULL, s);
    const bool lead = s >= 0 && lane == __ffs(peers) - 1;
    if (lead) atomicOr(&wm[s & (HM - 1)], 1u << warp);
    __syncthreads();
    // hits of the slot in the tile's earlier warps, leader by leader,
    // for the leaders whose hashed slot an earlier warp holds
    int pre = 0;
    const unsigned mine =
        lead ? wm[s & (HM - 1)] & ((1u << warp) - 1) : 0u;
    for (unsigned ls = __ballot_sync(FULL, mine != 0); ls; ls &= ls - 1) {
      const int L = __ffs(ls) - 1;
      const int sl = __shfl_sync(FULL, s, L);
      const int need = max_occ - __shfl_sync(FULL, cur, L);
      unsigned m = __shfl_sync(FULL, mine, L);
      int acc = 0;
      for (; m && acc < need; m &= m - 1)
        acc += __popc(__ballot_sync(FULL, tslot[(__ffs(m) - 1) * 32 + lane]
                                              == sl));
      if (s == sl) pre = acc;
    }
    if (s >= 0) {
      const int r = cur + pre + __popc(peers & lanemask_lt());
      if (r < max_occ)
        diag_out[(n * Q + s) * max_occ + r] = pos - s + DIAG_BIAS;
    }
    __syncthreads();
    if (lead) {
      atomicAdd(&row[s >> 1], (uint32_t)__popc(peers) << (16 * (s & 1)));
      wm[s & (HM - 1)] = 0;
    }
    __syncthreads();
  }
}

// one thread V anchor lanes of a query position (V divides max_occ):
// ok, the invalid lanes, and a repeated oligo's lanes from its slot's
// (the slot's own valid lanes are placed); V = 4 stores 16 and 4 bytes
template <int V>
__global__ void region_anchors_fill_kernel(
    long long total, int Q, int max_occ, int keep,
    const int32_t* __restrict__ rep, const int32_t* __restrict__ tot,
    int32_t* __restrict__ diag_out, bool* __restrict__ ok_out) {
  const int per = max_occ / V;
  for (long long x = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       x < total; x += (long long)gridDim.x * blockDim.x) {
    // 32-bit division where it fits
    const long long nq = x <= 0x7FFFFFFF ? (long long)((unsigned)x /
                                                       (unsigned)per)
                                         : x / per;
    const int l0 = (int)(x - nq * per) * V;
    const int q = (int)(nq <= 0x7FFFFFFF ? (unsigned)nq % (unsigned)Q
                                         : nq % Q);
    const int r = rep[nq];
    int kept = 0;
    if (r >= 0) {
      const int tt = tot[nq - q + r];
      kept = keep || tt <= max_occ ? min(tt, max_occ) : 0;
    }
    int32_t* d = diag_out + x * V;
    int dv[V];
    bool ov[V];
    if (l0 < kept) {
      const int32_t* from = d + (long long)(r - q) * max_occ;
#pragma unroll
      for (int v = 0; v < V; ++v) dv[v] = from[v] + (r - q);
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      ov[v] = l0 + v < kept;
      if (!ov[v]) dv[v] = ANCHOR_INVALID;
    }
    if (V == 4) {
      reinterpret_cast<int4*>(diag_out)[x] =
          make_int4(dv[0], dv[1 % V], dv[2 % V], dv[3 % V]);
      reinterpret_cast<uchar4*>(ok_out)[x] =
          make_uchar4(ov[0], ov[1 % V], ov[2 % V], ov[3 % V]);
    } else {
      d[0] = dv[0];
      ok_out[x] = ov[0];
    }
  }
}

}  // namespace

// tab: the gap costs of x < max(max_intron, 0), filled here first where
// fill is set (the wrapper keeps the table between calls)
extern "C" int tt_chain_segments(const void* diag, const void* qstart,
                                 const void* qend, const void* weight,
                                 const void* valid, int N, int S, int M,
                                 int max_intron, float frac, void* tab,
                                 int fill, void* out_diag,
                                 void* out_qs, void* out_qe, void* out_ok,
                                 void* stream) {
  if (S < 1 || S > 1024 || M < 1 || M > S) return (int)cudaErrorInvalidValue;
  const auto st = (cudaStream_t)stream;
  const int TG = max(max_intron, 0);
  if (fill && TG) {
    chain_gap_table_kernel<<<grid_for(TG, 256), 256, 0, st>>>(TG,
                                                             (float*)tab);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const auto* d = (const int32_t*)diag;
  const auto* qs = (const int32_t*)qstart;
  const auto* qe = (const int32_t*)qend;
  const auto* w = (const int32_t*)weight;
  const auto* v = (const bool*)valid;
  const auto* t = (const float*)tab;
  auto* od = (int32_t*)out_diag;
  auto* oqs = (int32_t*)out_qs;
  auto* oqe = (int32_t*)out_qe;
  auto* ook = (bool*)out_ok;
#define K7A(P)                                                          \
  if (S <= 32 * P)                                                      \
    return launch_chain<P>(d, qs, qe, w, v, N, S, M, max_intron, frac, t, \
                           od, oqs, oqe, ook, st);
  K7A(1) K7A(2) K7A(4) K7A(8) K7A(16) K7A(32)
#undef K7A
  return (int)cudaErrorInvalidValue;
}

// scratch (the wrapper allocates it): cnt N x nch x Qw words (two 16-bit
// counts each, Qw = ceil(Q / 2)), hits N x R int2 (8-byte aligned), nhit
// N x nch, rep and
// tot N x Q, and with gt G x 4^k table entries
extern "C" int tt_region_anchors(const void* codes, const void* rvalid,
                                 const void* qolig, const void* qvalid, int N,
                                 int R, int Q, int k, int max_occ, int keep,
                                 int C, int G, int gt, void* cnt, void* hits,
                                 void* nhit, void* rep, void* tot,
                                 void* table, void* diag, void* ok,
                                 void* stream) {
  if (k < 1 || k > 12 || max_occ < 1 || max_occ > 254 || G < 1 || C < AB ||
      C % AB || C > 16384 || (!gt && (k > 8 || Q > 0xFFFF)))
    return (int)cudaErrorInvalidValue;
  const auto st = (cudaStream_t)stream;
  const int nch = R > 0 ? (R + C - 1) / C : 1;
  const int Qw = (Q + 1) / 2;
  const int T = 1 << (2 * k);
  const int bytes =
      ((gt ? 0 : ((T + 1) / 2 + 3) & ~3) + (TILE + 16) / 4 + AW) * 4;
  if (bytes > SMEM_MAX) return (int)cudaErrorInvalidValue;
  auto count = gt ? region_anchors_count_kernel<true>
                  : region_anchors_count_kernel<false>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        count, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  count<<<G, AB, bytes, st>>>(
      (const uint8_t*)codes, (const bool*)rvalid, (const int32_t*)qolig,
      (const bool*)qvalid, N, R, Q, k, C, nch, Qw, (int32_t*)table,
      (uint32_t*)cnt, (int2*)hits, (int32_t*)nhit, (int32_t*)rep,
      (int32_t*)tot);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (nch > 1 && (long long)N * Qw) {
    region_anchors_scan_kernel<<<grid_for((long long)N * Qw, 256), 256, 0,
                                 st>>>(N, Q, nch, Qw, (uint32_t*)cnt,
                                       (int32_t*)tot);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  region_anchors_place_kernel<<<N * nch, PB, 0, st>>>(
      R, Q, C, nch, Qw, max_occ, keep, (uint32_t*)cnt, (const int2*)hits,
      (const int32_t*)nhit, (const int32_t*)tot, (int32_t*)diag);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long lanes = (long long)N * Q * max_occ;
  const auto* rp = (const int32_t*)rep;
  const auto* tt = (const int32_t*)tot;
  if (lanes && max_occ % 4 == 0)
    region_anchors_fill_kernel<4><<<grid_for(lanes / 4, 256), 256, 0, st>>>(
        lanes / 4, Q, max_occ, keep, rp, tt, (int32_t*)diag, (bool*)ok);
  else if (lanes)
    region_anchors_fill_kernel<1><<<grid_for(lanes, 256), 256, 0, st>>>(
        lanes, Q, max_occ, keep, rp, tt, (int32_t*)diag, (bool*)ok);
  return (int)cudaGetLastError();
}
