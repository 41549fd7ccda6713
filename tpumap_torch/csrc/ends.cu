// K8: the lanes of the GSNAP ends rung.
//
// Replaces no TPU kernel: tpumap runs the ends rung as jnp ops,
// tpumap/gsnap/engine.py: _ends_standard (277-348), _probe_rank
// (354-371), _dedup_lanes (377-388) and the mode rung of
// align_batch_ends (158-258). For each (read, strand) it takes the
// 2 x interval end k-mers, reads each k-mer's offsets pair and up to
// max_occ positions as diagonals, keeps the 8 smallest distinct
// diagonals (INVALID = 0xFFFFFFFF after them) and, in standard mode,
// ranks those by one 16-base probe word against the reference genome
// and keeps 3 (ties to the lower lane). The port's plain version is
// tpumap_torch/gsnap/engine.py: end_lanes_plain, with two torch.sorts
// over [B, 2 x interval x max_occ] lanes a strand.
//
// Bound on the H100: latency of dependent random gathers. A read's
// length and codes, then a k-mer's two offsets (a 1.07 GB table at k =
// 14), then its positions, then for the probe two genome words a lane:
// a few hundred bytes a row, each read a 32-byte sector of its own; the
// selection is a few integer operations a lane a round. At B = 32,768
// the rows come in several waves of warps, each warp waiting on that
// chain, and the loads and shared-memory traffic of the waves in flight
// queue in the memory pipeline.
//
// Design (up to 256 lanes a strand and 32 end k-mers): one warp serves
// RP reads (1, or 2 once one a warp would fill more than a wave), both
// strands: 2 RP rows, rows strand-major in the output (2B of them). The
// warp loads each read's two end spans (the k + interval - 1 bases the
// end k-mers cover at either end) once, as aligned 4-byte words, one a
// lane, into shared memory, and builds every end k-mer of both strands
// from those words with funnel shifts and bit packing (the
// rc strand's k-mers from the complement read backwards, which gives the
// plain version's rc k-mers and positions whenever len >= k; rows with
// len < k have no lane), mapping the codes through the mode's code map
// as packed words. Then all 2 RP NE offsets gathers go out together,
// then all the rows' positions gathers: up to 32 lanes a strand, lane i
// of the flat [end k-mer, occurrence] order at thread i; up to 256, only
// the live lanes, packed through a shared map of (position index, q), in
// as many registers a thread as they fill, so the rounds run over those
// alone. In standard mode each live lane's two probe words go out right
// after, before the selection, so their latency overlaps it. The 8
// smallest distinct lanes of each row come from 8 rounds of "the
// smallest lane above the last one" (a warp min reduction each, the
// rows' reductions independent); the probe's mismatches of each kept
// lane are looked up among the lanes that hold it, and segments of 8
// threads (a row each) rank the kept lanes by (mismatches, lane) with
// shuffles. Past 256 lanes (or 32 end k-mers) one warp serves one row,
// the live lanes in a global scratch, one slot a resident warp, its
// k-mers rolled from byte loads. Gathers clamp their indices as the
// plain version's mode="clip" takes do.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kInvalid = 0xFFFFFFFFu;
constexpr uint32_t kLowPairs = 0x55555555u;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarps = 4;        // warps a block
constexpr int kProbeInvalid = 999;
constexpr int kSpanWords = 9;    // a span of <= 31 bases, 3 bytes off
constexpr int kKept = 8;         // ENDS_K: lanes kept a row, at most

struct EndArgs {
  const uint8_t* codes;
  long long ncodes;          // B x L bytes
  const int32_t* lengths;
  const uint32_t* offs[2];
  long long noff[2];
  const uint32_t* pos[2];
  long long npos[2];
  const uint32_t* genome;
  long long gwords;
  const uint32_t* packed2;   // [2B, W] (standard mode), else null
  int W, B, L, k, iv, occ, K, keep;
  uint32_t lut[2];           // code maps, 2 bits a code
  uint32_t* scratch;         // [nslots, NE * occ] (scratch path)
  int warp_smem;             // shared words a warp (register paths)
};

__device__ __forceinline__ uint32_t ld_clip(const uint32_t* a, long long n,
                                            long long i) {
  return __ldg(a + (i < 0 ? 0 : (i < n ? i : n - 1)));
}

// the e-th end position (_end_qpos): min(qlast, e) for e < iv, then
// max(qlast - j, 0) for j = iv - 1 .. 0
__device__ __forceinline__ int end_qpos(int e, int iv, int qlast) {
  if (e < iv) return e < qlast ? e : qlast;
  int j = 2 * iv - 1 - e;
  return qlast - j > 0 ? qlast - j : 0;
}

__device__ __forceinline__ void kmer_range(const EndArgs& a, int s,
                                           uint32_t o, uint32_t* start,
                                           int* n) {
  uint32_t st = ld_clip(a.offs[s], a.noff[s], (long long)o);
  long long cnt =
      (long long)ld_clip(a.offs[s], a.noff[s], (long long)o + 1) - st;
  *start = st;
  *n = (cnt > 0 && cnt <= a.occ) ? (int)cnt : 0;
}

__device__ __forceinline__ uint32_t lane_diag(const EndArgs& a, int s,
                                              uint32_t start, int l,
                                              uint32_t q) {
  uint32_t p = ld_clip(a.pos[s], a.npos[s], (long long)start + l);
  return p >= q ? p - q : kInvalid;
}

// 4 code bytes (each & 3) as 2-bit codes: first byte highest (be) or
// lowest (le)
__device__ __forceinline__ uint32_t pack_be4(uint32_t y) {
  y &= 0x03030303u;
  return ((y & 3u) << 6) | ((y >> 4) & 0x30u) | ((y >> 14) & 0xCu) |
         (y >> 24);
}

__device__ __forceinline__ uint32_t pack_le4(uint32_t y) {
  y &= 0x03030303u;
  return (y & 3u) | ((y >> 6) & 0xCu) | ((y >> 12) & 0x30u) |
         ((y >> 18) & 0xC0u);
}

// each 2-bit code c of w as lut's c-th entry
__device__ __forceinline__ uint32_t map_codes(uint32_t w, uint32_t lut) {
  uint32_t hi = (w >> 1) & kLowPairs, lo = w & kLowPairs;
  return (~(hi | lo) & kLowPairs) * (lut & 3u) + (~hi & lo) *
         ((lut >> 2) & 3u) + (hi & ~lo) * ((lut >> 4) & 3u) +
         (hi & lo) * ((lut >> 6) & 3u);
}

// the aligned 4-byte word wa of the codes (bytes past the end 0)
__device__ __forceinline__ uint32_t codes_word(const EndArgs& a,
                                               long long wa) {
  if (4 * wa + 4 <= a.ncodes)
    return *reinterpret_cast<const uint32_t*>(a.codes + 4 * wa);
  uint32_t x = 0;
  for (int t = 0; t < 4; ++t)
    if (4 * wa + t < a.ncodes) x |= (uint32_t)a.codes[4 * wa + t] << (8 * t);
  return x;
}

// --------------------------------------------------- the scratch path

// a k-mer's table range, rolled from byte loads: its first position
// and live lanes, the read at its position q
__device__ __forceinline__ void end_kmer_bytes(const EndArgs& a, int s,
                                               const uint8_t* c, int len,
                                               int e, uint32_t* start,
                                               int* n, uint32_t* q) {
  int qp = end_qpos(e, a.iv, len - a.k);
  uint32_t o = 0;
  for (int j = 0; j < a.k; ++j) {
    int p = s ? len - 1 - (qp + j) : qp + j;
    p = p < 0 ? 0 : (p > a.L - 1 ? a.L - 1 : p);   // in the row
    uint32_t code = s ? 3u - c[p] : c[p];
    o = (o << 2) | ((a.lut[s] >> (2 * (code & 3u))) & 3u);
  }
  kmer_range(a, s, o, start, n);
  *q = (uint32_t)qp;
}

__device__ void scratch_rows(const EndArgs& a, long long* __restrict__ out) {
  int lane = threadIdx.x & 31;
  long long nwarps = (long long)gridDim.x * kWarps;
  long long gw = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  int NE = 2 * a.iv;
  long long N = (long long)NE * a.occ;
  uint32_t* sc = a.scratch + gw * N;
  for (long long row = gw; row < 2LL * a.B; row += nwarps) {
    int s = row >= a.B;
    int b = (int)(s ? row - a.B : row);
    int len = a.lengths[b];
    const uint8_t* c = a.codes + (long long)b * a.L;
    int tot = 0;
    if (len >= a.k) {
      // the live lanes of each k-mer in turn, packed into the scratch
      for (int e = 0; e < NE; ++e) {
        uint32_t st, q;
        int n;
        end_kmer_bytes(a, s, c, len, e, &st, &n, &q);
        for (int l = lane; l < n; l += 32) sc[tot + l] = lane_diag(a, s, st,
                                                                   l, q);
        tot += n;
      }
      __syncwarp();
    }
    // round r: the smallest lane above round r - 1's
    uint32_t lo = 0, mine = kInvalid;
    for (int r = 0; r < a.K; ++r) {
      uint32_t m = kInvalid;
      for (int i = lane; i < tot; i += 32) {
        uint32_t x = sc[i];
        if (x >= lo && x < m) m = x;
      }
      m = __reduce_min_sync(kFull, m);
      if (lane == r) mine = m;
      if (m == kInvalid) break;
      lo = m + 1;
    }
    __syncwarp();                   // the scratch slot is reused
    if (a.keep == 0) {
      if (lane < a.K) out[row * a.K + lane] = mine;
      continue;
    }
    // the probe: one 16-base word at base 16 * (len / 32) of the read
    int pw = len / 32;
    pw = pw < 0 ? 0 : (pw > a.W - 1 ? a.W - 1 : pw);
    int pm = INT_MAX;
    if (lane < a.K) {
      uint32_t rw = a.packed2[row * a.W + pw];
      bool valid = mine != kInvalid;
      uint32_t start = (valid ? mine : 0u) + (uint32_t)pw * 16u;
      long long w0 = start >> 4;
      uint32_t sh = (start & 15u) << 1;
      uint32_t gword = ld_clip(a.genome, a.gwords, w0) >> sh;
      if (sh) gword |= ld_clip(a.genome, a.gwords, w0 + 1) << (32u - sh);
      uint32_t d = rw ^ gword;
      pm = valid ? __popc((d | (d >> 1)) & kLowPairs) : kProbeInvalid;
    }
    int rank = 0;
    for (int i = 0; i < a.K; ++i) {
      int pi = __shfl_sync(kFull, pm, i);
      rank += (pi < pm) || (pi == pm && i < lane);
    }
    if (lane < a.K && rank < a.keep) out[row * a.keep + rank] = mine;
  }
}

// --------------------------------------------------- the register paths

// the 8 smallest distinct lanes of each of a warp's 2 RP rows over the
// first NR of each thread's PER registers (the rest INVALID) and, with
// PROBE, their ranking by the probe; the output rows
template <int NR, int PER, int RP, int PROBE>
__device__ __forceinline__ void select_rank(
    const EndArgs& a, const uint32_t (&v)[2 * RP][PER],
    const uint32_t (&g0)[2 * RP][PER], const uint32_t (&g1)[2 * RP][PER],
    const uint32_t (&rw)[2 * RP], const int (&pws)[2 * RP], long long b0,
    long long* __restrict__ out) {
  constexpr int R = 2 * RP;
  constexpr int G = (R + 3) / 4;    // sets of 4 rows x 8 threads
  const int lane = threadIdx.x & 31;
  // round r: each live row's smallest lane above its round r - 1's; the
  // r-th kept lane of row j sits at thread (j % 4) * 8 + r, set j / 4
  uint32_t sel[G], lo[R];
#pragma unroll
  for (int g = 0; g < G; ++g) sel[g] = kInvalid;
#pragma unroll
  for (int j = 0; j < R; ++j) lo[j] = 0;
  unsigned live = (1u << R) - 1u;
#pragma unroll
  for (int r = 0; r < kKept; ++r) {
    if (r >= a.K || !live) break;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (!((live >> j) & 1u)) continue;
      uint32_t m = kInvalid;
#pragma unroll
      for (int p = 0; p < NR; ++p)
        if (v[j][p] >= lo[j] && v[j][p] < m) m = v[j][p];
      m = __reduce_min_sync(kFull, m);
      if (lane == (j & 3) * 8 + r) sel[j >> 2] = m;
      if (m == kInvalid) live &= ~(1u << j);
      lo[j] = m + 1u;
    }
  }
  const int myr = lane & 7;
  if (!PROBE) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      int j = g * 4 + (lane >> 3);
      int s = j >= RP, r = j - s * RP;
      if (j < R && myr < a.K && b0 + r < a.B)
        out[((long long)s * a.B + b0 + r) * a.K + myr] = sel[g];
    }
    return;
  }
  // each kept lane's probe mismatches, from a lane that holds it
  int pmv[G];
#pragma unroll
  for (int g = 0; g < G; ++g) pmv[g] = kProbeInvalid;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    int pm[NR];
#pragma unroll
    for (int p = 0; p < NR; ++p) {
      uint32_t sh = ((v[j][p] + (uint32_t)pws[j] * 16u) & 15u) << 1;
      uint32_t gw = (g0[j][p] >> sh) | (sh ? g1[j][p] << (32u - sh) : 0u);
      uint32_t d = rw[j] ^ gw;
      pm[p] = __popc((d | (d >> 1)) & kLowPairs);
    }
#pragma unroll
    for (int r = 0; r < kKept; ++r) {
      if (r >= a.K) break;
      uint32_t mr = __shfl_sync(kFull, sel[j >> 2], (j & 3) * 8 + r);
      if (mr == kInvalid) break;
      int c = kProbeInvalid;
#pragma unroll
      for (int p = 0; p < NR; ++p)
        if (v[j][p] == mr) c = min(c, pm[p]);
      c = __reduce_min_sync(kFull, c);
      if (lane == (j & 3) * 8 + r) pmv[j >> 2] = c;
    }
  }
  // rank the kept lanes of each row by (mismatches, lane) in its
  // segment of 8 threads, and keep the first `keep`: a row's nv valid
  // lanes come first (ascending), its INVALID ones (999) rank as they
  // stand
#pragma unroll
  for (int g = 0; g < G; ++g) {
    unsigned vb = __ballot_sync(kFull, myr < a.K && sel[g] != kInvalid);
    int nv = __popc((vb >> (lane & ~7)) & 0xFFu);
    int top = __reduce_max_sync(kFull, nv);
    int rank = myr < nv ? 0 : myr;
    for (int i = 0; i < top; ++i) {
      int pi = __shfl_sync(kFull, pmv[g], i, 8);
      if (myr < nv && i < nv)
        rank += (pi < pmv[g]) || (pi == pmv[g] && i < myr);
    }
    int j = g * 4 + (lane >> 3);
    int s = j >= RP, r = j - s * RP;
    if (j < R && myr < a.K && rank < a.keep && b0 + r < a.B)
      out[((long long)s * a.B + b0 + r) * a.keep + rank] = sel[g];
  }
}

// PER lanes a thread a row (1: up to 32 lanes, 8: up to 256), RP reads
// a warp (rows j = s * RP + r), PROBE: standard mode's probe ranking
template <int PER, int RP, int PROBE>
__device__ void register_rows(const EndArgs& a, long long* __restrict__ out) {
  constexpr int R = 2 * RP;
  extern __shared__ __align__(16) uint32_t smem[];
  const int lane = threadIdx.x & 31;
  const int NE = 2 * a.iv, N = NE * a.occ, H = a.k + a.iv - 1;
  constexpr int cw = 2 * kSpanWords;
  // a warp's shared words: each k-mer's (start, n, q), with 8 lanes a
  // thread each row's packed lanes' (position index, q), each read's two
  // end spans of codes, each read's length
  uint32_t* sw = smem + (threadIdx.x >> 5) * a.warp_smem;
  uint4* skinfo = reinterpret_cast<uint4*>(sw);                 // [R * NE]
  uint2* smap = reinterpret_cast<uint2*>(sw + 4 * R * NE);      // [R][256]
  uint32_t* scodes = sw + 4 * R * NE + (PER > 1 ? 512 * R : 0);  // [RP][cw]
  int* slen = reinterpret_cast<int*>(scodes + RP * cw);
  const long long b0 =
      ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * RP;
  if (b0 >= a.B) return;            // the whole warp
  if (lane < RP) slen[lane] = b0 + lane < a.B ? a.lengths[b0 + lane] : -1;
  __syncwarp();

  // each read's head span [0, H) and tail span [len - H, len), as the
  // aligned words that hold them
  for (int q = lane; q < RP * cw; q += 32) {
    int r = q / cw, w = q - r * cw;
    int len = slen[r], h = w >= kSpanWords;
    w -= h * kSpanWords;
    int st = h ? max(len - H, 0) : 0;
    long long row = (b0 + r) * a.L;
    long long wa = ((row + st) >> 2) + w;
    scodes[q] = len >= a.k && 4 * wa < row + min(st + H, len)
                    ? codes_word(a, wa) : 0u;
  }
  __syncwarp();

  // the end k-mers of both strands and their table ranges
  for (int u = lane; u < R * NE; u += 32) {
    int j = u / NE, e = u - j * NE;
    int s = j >= RP, r = j - s * RP;
    int len = slen[r];
    uint32_t st = 0;
    int n = 0, qp = 0;
    if (len >= a.k) {
      qp = end_qpos(e, a.iv, len - a.k);
      int p = s ? len - qp - a.k : qp;     // the k-mer's first byte
      // the head span holds the fwd head k-mers and the rc tail ones
      int h = (e >= a.iv) ^ s;
      int sst = h ? max(len - H, 0) : 0;
      int off = (int)(((b0 + r) * a.L + sst) & 3) + (p - sst);
      const uint32_t* sp = scodes + r * cw + h * kSpanWords + (off >> 2);
      uint32_t x[5];
#pragma unroll
      for (int i = 0; i < 5; ++i) x[i] = sp[i];
      uint32_t sh = (off & 3) * 8, o = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t y = __funnelshift_r(x[i], x[i + 1], sh);
        o |= s ? pack_le4(y) << (8 * i) : pack_be4(y) << (24 - 8 * i);
      }
      // fwd: the first base highest; rc: complemented, the last byte
      // (the rc k-mer's first base) highest
      o = s ? map_codes(~o, a.lut[1]) : map_codes(o, a.lut[0]);
      o = s ? (a.k == 16 ? o : o & ((1u << (2 * a.k)) - 1u))
            : o >> (32 - 2 * a.k);
      kmer_range(a, s, o, &st, &n);
    }
    skinfo[u] = make_uint4(st, (uint32_t)n, (uint32_t)qp, 0u);
  }
  __syncwarp();

  // the lanes of each row: lane i = p * 32 + thread, each k-mer's
  // occurrences in turn; with 8 a thread only the live ones, packed
  // (the warp writes each packed lane's position index and q), so a
  // row's rounds run over the registers its live lanes fill
  int tot[R];
  int nreg = 1;
  if (PER > 1) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      int first = 0;
      for (int e = 0; e < NE; ++e) {
        uint4 ki = skinfo[j * NE + e];
        for (int l = lane; l < (int)ki.y; l += 32)
          smap[j * 256 + first + l] = make_uint2(ki.x + l, ki.z);
        first += (int)ki.y;
      }
      tot[j] = first;
      nreg = max(nreg, (first + 31) >> 5);
    }
    __syncwarp();
  }
  int le[PER], ll[PER];
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    int i = p * 32 + lane;
    le[p] = i < N ? i / a.occ : -1;
    ll[p] = i < N ? i - le[p] * a.occ : 0;
  }
  uint32_t v[R][PER];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    int s = j >= RP;
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      int i = p * 32 + lane;
      v[j][p] = kInvalid;
      if (PER == 1 && le[p] >= 0) {
        uint4 ki = skinfo[j * NE + le[p]];
        if (ll[p] < (int)ki.y) v[j][p] = lane_diag(a, s, ki.x, ll[p], ki.z);
      } else if (PER > 1 && i < tot[j]) {
        uint2 m = smap[j * 256 + i];
        v[j][p] = lane_diag(a, s, m.x, 0, m.y);
      }
    }
  }
  // the probe's words of every live lane, issued before the selection
  uint32_t rw[R], g0[R][PER], g1[R][PER];
  int pws[R];
  if (PROBE) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      int s = j >= RP, r = j - s * RP;
      int len = slen[r];
      int pw = len / 32;
      pw = pw < 0 ? 0 : (pw > a.W - 1 ? a.W - 1 : pw);
      pws[j] = pw;
      rw[j] = len >= 0 ? __ldg(a.packed2 + ((long long)s * a.B + b0 + r) *
                                              a.W + pw)
                       : 0u;
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        uint32_t start = v[j][p] + (uint32_t)pw * 16u;
        uint32_t sh = (start & 15u) << 1;
        g0[j][p] = g1[j][p] = 0;
        if (v[j][p] != kInvalid) {
          g0[j][p] = ld_clip(a.genome, a.gwords, start >> 4);
          if (sh) g1[j][p] = ld_clip(a.genome, a.gwords, (start >> 4) + 1);
        }
      }
    }
  }
  // the rounds over the registers the warp's rows fill
  if (PER == 1 || nreg <= 1)
    select_rank<1, PER, RP, PROBE>(a, v, g0, g1, rw, pws, b0, out);
  else if (nreg <= 2)
    select_rank<2, PER, RP, PROBE>(a, v, g0, g1, rw, pws, b0, out);
  else if (nreg <= 4)
    select_rank<4, PER, RP, PROBE>(a, v, g0, g1, rw, pws, b0, out);
  else
    select_rank<PER, PER, RP, PROBE>(a, v, g0, g1, rw, pws, b0, out);
}

// PER 0: the scratch path (RP 1); else the register paths
template <int PER, int RP, int PROBE>
__global__ void __launch_bounds__(32 * kWarps)
    end_lanes_kernel(EndArgs a, long long* __restrict__ out) {
  if constexpr (PER == 0)
    scratch_rows(a, out);
  else
    register_rows<PER, RP, PROBE>(a, out);
}

template <int PER, int RP, int PROBE>
int launch_rows(const EndArgs& a, long long* out, cudaStream_t st) {
  long long warps = (a.B + RP - 1) / RP;
  unsigned blocks = (unsigned)((warps + kWarps - 1) / kWarps);
  size_t smem = (size_t)kWarps * a.warp_smem * sizeof(uint32_t);
  end_lanes_kernel<PER, RP, PROBE><<<blocks, 32 * kWarps, smem, st>>>(a,
                                                                      out);
  return (int)cudaGetLastError();
}

}  // namespace

// codes uint8[B, L] (4-byte aligned); lengths int32[B]; the fwd and rc
// strands' offsets and positions (int32 bit patterns, n entries each);
// the reference genome words (the probe) and packed2 int32[2B, W]
// (standard mode; null and keep 0 in a mode); k <= 16; iv the index
// interval (2 iv end k-mers), occ max_occ, K = min(8, 2 iv occ) lanes
// kept, keep the probe's (0: no probe); lut_f, lut_r each strand's code
// map; per the lanes a thread holds (1 up to 32 lanes, 8 up to 256, with
// 2 iv <= 32; 0: the scratch path, int32[nslots, 2 iv occ], nslots a
// multiple of 4: one slot a launched warp); rp the reads a warp serves
// on the register paths (1, or 2 with one lane a thread).
// out int64[2B, keep] (standard) or [2, B, K] (a mode).
// Returns cudaGetLastError(), or cudaErrorInvalidValue for an unknown
// per or rp or a missing scratch.
extern "C" int tt_end_lanes(const void* codes, const void* lengths,
                            const void* offs_f, long long noff_f,
                            const void* pos_f, long long npos_f,
                            const void* offs_r, long long noff_r,
                            const void* pos_r, long long npos_r,
                            const void* genome, long long gwords,
                            const void* packed2, int W, int B, int L, int k,
                            int iv, int occ, int K, int keep, int lut_f,
                            int lut_r, int per, int rp, void* scratch,
                            int nslots, void* out, void* stream) {
  EndArgs a;
  a.codes = (const uint8_t*)codes;
  a.ncodes = (long long)B * L;
  a.lengths = (const int32_t*)lengths;
  a.offs[0] = (const uint32_t*)offs_f;
  a.offs[1] = (const uint32_t*)offs_r;
  a.noff[0] = noff_f;
  a.noff[1] = noff_r;
  a.pos[0] = (const uint32_t*)pos_f;
  a.pos[1] = (const uint32_t*)pos_r;
  a.npos[0] = npos_f;
  a.npos[1] = npos_r;
  a.genome = (const uint32_t*)genome;
  a.gwords = gwords;
  a.packed2 = (const uint32_t*)packed2;
  a.W = W;
  a.B = B;
  a.L = L;
  a.k = k;
  a.iv = iv;
  a.occ = occ;
  a.K = K;
  a.keep = keep;
  a.lut[0] = (uint32_t)lut_f;
  a.lut[1] = (uint32_t)lut_r;
  a.scratch = (uint32_t*)scratch;
  a.warp_smem = 2 * rp * 2 * iv * 4 + (per > 1 ? 2 * rp * 512 : 0) +
                rp * 2 * kSpanWords + rp;
  a.warp_smem = (a.warp_smem + 3) & ~3;   // 16-byte aligned warps
  if (occ < 1 || iv < 1 || k < 1 || k > 16 || K > kKept ||
      (keep && !packed2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  long long* o = (long long*)out;
  if (per == 0) {
    // one scratch slot a launched warp: whole blocks of nslots warps
    if (!scratch || nslots < kWarps || nslots % kWarps)
      return (int)cudaErrorInvalidValue;
    end_lanes_kernel<0, 1, 0><<<nslots / kWarps, 32 * kWarps, 0, st>>>(a, o);
    return (int)cudaGetLastError();
  }
  if (2 * iv > 32 || (long long)2 * iv * occ > 32LL * per)
    return (int)cudaErrorInvalidValue;
  switch (per * 100 + rp * 10 + (keep ? 1 : 0)) {
    case 110: return launch_rows<1, 1, 0>(a, o, st);
    case 111: return launch_rows<1, 1, 1>(a, o, st);
    case 120: return launch_rows<1, 2, 0>(a, o, st);
    case 121: return launch_rows<1, 2, 1>(a, o, st);
    case 810: return launch_rows<8, 1, 0>(a, o, st);
    case 811: return launch_rows<8, 1, 1>(a, o, st);
  }
  return (int)cudaErrorInvalidValue;
}
