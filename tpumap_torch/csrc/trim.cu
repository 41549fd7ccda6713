// K4: end trimming of each read's best diagonal.
//
// Replaces no TPU kernel: tpumap runs end trimming as jnp ops,
// tpumap/gsnap/engine.py: _trim_stage (458-513) with
// tpumap/ops/verify.py: mismatch_mask_single (173) and
// tpumap/ops/pathdp.py: _trim_scan (414) and trim_ends (468-528). For
// each row it builds the per-base mismatch mask of the read in the
// aligned orientation against its best diagonal (the strand's base
// space; ref-OR-alt with an alternate genome; the N flags under
// query_unk and genome_unk; an INVALID diagonal mismatches everywhere),
// trims qstart over [0, len) and then qend over [qstart, len) with the
// reference's scan (match 1, mismatch -3 in the scan's units; >= updates,
// the stop rule, the keep-full rules), and gives the kept interval's
// score (match 8, mismatch -24) and mismatches and, with quals, the
// quality sum of the kept mismatches and 16 x the kept mean quality.
// The port's plain version is tpumap_torch/gsnap/engine.py:
// trim_stage_plain: a [B, L] bool mask (two in a mode), an int32 cumsum,
// two cummax scans and a dozen [B, L] passes.
//
// Bound on the H100: bytes. Each row reads its codes, N flags and quals
// (L bytes each), W + 1 genome words and W / 2 + 2 N-bitmap words from
// a random place; the scans are a few integer operations a mismatch. A
// row's work is short, so what costs is the latency of its two rounds of
// loads and of the chain of reductions after them.
//
// Design (rows of up to 32 words, L <= 512): a segment of SEG lanes a
// row (W = ceil(L / 16) rounded up to a power of two; at L = 128 8
// lanes, 4 rows a warp). Once the row's diagonal, length and strand are
// read, lane j loads its 16 codes, 16 N flags and 16 quals (one 16-byte
// load each where L is a multiple of 16; on the rc strand the mirrored
// bytes as aligned words, funnel-shifted and byte-reversed; else byte
// loads) together with its genome window words, and packs its mismatch
// word in registers: the read word XOR the window word in the strand's
// space, folded, the N masks, compressed to 16 bits and cut at min(len,
// L). A row with no mismatch (a ballot) is done: qstart 0, qend len. Else
// each scan is one segment scan of (mismatches, best key) pairs, the key
// score x 1024 + position (ties to the lower or the higher position),
// then each lane walks its own mismatches for the stop rule; the first
// stop is in the last (qstart) or first (qend) lane that has one, a
// ballot away, and its lane's best key holds the best and its position.
// "The best is the last mismatch scanned" is a ballot for the segment's
// lowest or highest mismatch, and the kept mismatches come from the
// scan's counts. Rows past 32 words keep one warp a row: lane j builds
// words j, j + 32, ... from byte loads into shared memory (past
// TRIM_SMEM_WORDS words a row, a global scratch), a warp scan of each
// lane's chunk of words places its mismatches, and reductions pick the
// first stop and the best. Genome words are fetched as tpumap's window is
// (clamped start for windows of 16 words or more, zero past the padded
// end).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kInvalid = 0xFFFFFFFFu;
constexpr uint32_t kLowPairs = 0x55555555u;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarps = 4;               // warps a block
constexpr int kNeg = -(1 << 20);        // pathdp.NEG

struct TrimArgs {
  const uint32_t* genome;
  long long gwords;
  const uint32_t* gnmask;
  long long nwords;
  const uint32_t* galt;
  long long awords;
  const uint8_t* codes;
  const uint8_t* nmask;
  const int32_t* lengths;
  const int32_t* strand;
  const long long* diag;
  const uint8_t* quals;
  int B, L, W, has_n, query_unk, genome_unk, space_f, space_r, safe_pad;
  int vec;                  // 16-byte loads: L % 16 == 0, rows aligned
  uint32_t* scratch;
};

__device__ __forceinline__ uint32_t ld_clip(const uint32_t* a, long long n,
                                            long long i) {
  return __ldg(a + (i < 0 ? 0 : (i < n ? i : n - 1)));
}

__device__ __forceinline__ uint32_t spread16(uint32_t x) {
  x &= 0xFFFFu;
  x = (x | (x << 8)) & 0x00FF00FFu;
  x = (x | (x << 4)) & 0x0F0F0F0Fu;
  x = (x | (x << 2)) & 0x33333333u;
  return (x | (x << 1)) & 0x55555555u;
}

// bits 2j of x -> bit j
__device__ __forceinline__ uint32_t compress16(uint32_t x) {
  x &= kLowPairs;
  x = (x | (x >> 1)) & 0x33333333u;
  x = (x | (x >> 2)) & 0x0F0F0F0Fu;
  x = (x | (x >> 4)) & 0x00FF00FFu;
  return (x | (x >> 8)) & 0x0000FFFFu;
}

__device__ __forceinline__ uint32_t to_space(uint32_t w, int space) {
  switch (space) {
    case 1: return w | ((w & kLowPairs) << 1);                 // ct
    case 2: return w & ~((~w & kLowPairs) << 1);               // ga
    case 3: return w | ((~(w | (w >> 1)) & kLowPairs) << 1);   // ag
    case 4: return w & ~(((w & (w >> 1)) & kLowPairs) << 1);   // tc
  }
  return w;
}

__device__ __forceinline__ uint32_t fold(uint32_t x) {
  return (x | (x >> 1)) & kLowPairs;
}

// one word of a genome window: tpumap's extract_packed_window, whose
// start word w0 the caller has clamped; past n zeros with zext
__device__ __forceinline__ uint32_t window_word(const uint32_t* g,
                                                long long n, long long w,
                                                uint32_t s2, bool zext) {
  uint32_t lo = (zext && w >= n) ? 0u : ld_clip(g, n, w);
  uint32_t hi = 0;
  if (s2) hi = ((zext && w + 1 >= n) ? 0u : ld_clip(g, n, w + 1))
               << (32u - s2);
  return (lo >> s2) | hi;
}

__device__ __forceinline__ long long window_start(uint32_t start,
                                                  long long n, int W,
                                                  int safe_pad, bool* zext) {
  long long w0 = start >> 4;
  *zext = false;
  if (W >= 16) {
    *zext = W + 1 > safe_pad;
    long long hi = *zext ? n : (n - (W + 1) > 0 ? n - (W + 1) : 0);
    w0 = w0 < hi ? w0 : hi;
  }
  return w0;
}

__device__ __forceinline__ int excl_suffix_sum(int x, int lane) {
  int incl = x;
  for (int d = 1; d < 32; d <<= 1) {
    int y = __shfl_down_sync(kFull, incl, d);
    if (lane + d < 32) incl += y;
  }
  return incl - x;
}

__device__ __forceinline__ int excl_prefix_sum(int x, int lane) {
  int incl = x;
  for (int d = 1; d < 32; d <<= 1) {
    int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  return incl - x;
}

// the maximum over the lanes above (suffix) or below (prefix); kNeg at
// the end
__device__ __forceinline__ int excl_suffix_max(int x, int lane) {
  int incl = x;
  for (int d = 1; d < 32; d <<= 1) {
    int y = __shfl_down_sync(kFull, incl, d);
    if (lane + d < 32) incl = max(incl, y);
  }
  int e = __shfl_down_sync(kFull, incl, 1);
  return lane < 31 ? e : kNeg;
}

__device__ __forceinline__ int excl_prefix_max(int x, int lane) {
  int incl = x;
  for (int d = 1; d < 32; d <<= 1) {
    int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl = max(incl, y);
  }
  int e = __shfl_up_sync(kFull, incl, 1);
  return lane > 0 ? e : kNeg;
}

// bits of word j at bases >= lo
__device__ __forceinline__ uint32_t from_base(int j, int lo) {
  int t = lo - 16 * j;
  return t <= 0 ? 0xFFFFu : (t >= 16 ? 0u : (0xFFFFu << t) & 0xFFFFu);
}

// ------------------------------------------ rows past 32 words: a warp

__device__ void wide_row(const TrimArgs& a, int32_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  int lane = threadIdx.x & 31;
  int wib = threadIdx.x >> 5;
  int b = blockIdx.x * kWarps + wib;
  if (b >= a.B) return;                 // the whole warp
  const int W = a.W, L = a.L;
  uint32_t* mw = a.scratch ? a.scratch + (long long)b * W : smem + wib * W;
  int len = a.lengths[b];
  int lim = len < L ? len : L;
  bool rc = a.strand[b] == 1;
  int space = rc ? a.space_r : a.space_f;
  unsigned long long d = (unsigned long long)a.diag[b];
  bool valid = d != kInvalid;
  uint32_t start = valid ? (uint32_t)d : 0u;
  uint32_t s2 = (start & 15u) << 1;
  bool zext, zext_a = false;
  long long w0 = window_start(start, a.gwords, W, a.safe_pad, &zext);
  long long wa = a.galt ? window_start(start, a.awords, W, a.safe_pad,
                                       &zext_a) : 0;
  long long b0 = start >> 5;
  uint32_t sb = start & 31u;
  const uint8_t* c = a.codes + (long long)b * L;
  const uint8_t* nm = a.nmask + (long long)b * L;

  // the mismatch words, bit t of word j = base 16 j + t, below lim
  for (int j = lane; j < W; j += 32) {
    int base = 16 * j;
    uint32_t m16 = 0;
    if (base < lim) {
      if (!valid) {
        m16 = 0xFFFFu;
      } else {
        uint32_t r = 0, qn = 0;
        int nb = lim - base < 16 ? lim - base : 16;
        for (int t = 0; t < nb; ++t) {
          int src = rc ? len - 1 - (base + t) : base + t;
          src = src < L - 1 ? src : L - 1;      // in the row
          uint32_t code = c[src];
          r |= ((rc ? 3u - code : code) & 3u) << (2 * t);
          qn |= (nm[src] ? 1u : 0u) << (2 * t);
        }
        r = to_space(r, space);
        uint32_t mm = fold(
            r ^ to_space(window_word(a.genome, a.gwords, w0 + j, s2, zext),
                         space));
        if (a.galt)
          mm &= fold(r ^ to_space(window_word(a.galt, a.awords, wa + j, s2,
                                              zext_a),
                                  space));
        mm = a.query_unk ? (mm | qn) : (mm & ~qn);
        if (a.has_n) {
          uint32_t x = ld_clip(a.gnmask, a.nwords, b0 + (j >> 1)) >> sb;
          if (sb) x |= ld_clip(a.gnmask, a.nwords, b0 + (j >> 1) + 1)
                       << (32u - sb);
          uint32_t gm = spread16((j & 1) ? (x >> 16) : x);
          mm = a.genome_unk ? (mm | gm) : (mm & ~gm);
        }
        m16 = compress16(mm);
      }
      if (lim - base < 16) m16 &= (1u << (lim - base)) - 1u;
    }
    mw[j] = m16;
  }
  __syncwarp();

  // each lane's chunk of words [j0, j1)
  int cw = (W + 31) / 32;
  int j0 = lane * cw < W ? lane * cw : W;
  int j1 = j0 + cw < W ? j0 + cw : W;

  // qstart: mismatches scanned from the 3' end leftward; the score of
  // mismatch i is (len - i - 1) - 4 x (mismatches right of i)
  int n_t = 0;
  for (int j = j0; j < j1; ++j) n_t += __popc(mw[j]);
  int above = excl_suffix_sum(n_t, lane);
  int m = __shfl_sync(kFull, above + n_t, 0);
  int cmax = kNeg, seen = 0;
  for (int j = j1 - 1; j >= j0; --j)
    for (uint32_t x = mw[j]; x; x &= ~(1u << (31 - __clz(x)))) {
      int i = 16 * j + 31 - __clz(x);
      cmax = max(cmax, len - i - 1 - 4 * (above + seen++));
    }
  int run = excl_suffix_max(cmax, lane);
  int term = -1;
  seen = 0;
  for (int j = j1 - 1; j >= j0 && term < 0; --j)
    for (uint32_t x = mw[j]; x; x &= ~(1u << (31 - __clz(x)))) {
      int i = 16 * j + 31 - __clz(x);
      int sc = len - i - 1 - 4 * (above + seen++);
      if (sc < run && sc + i + 1 < 0) {
        term = i;
        break;
      }
      run = max(run, sc);
    }
  int first = __reduce_max_sync(kFull, term);       // -1: none
  int best_l = kNeg, pos_l = L;
  seen = 0;
  for (int j = j1 - 1; j >= j0; --j)
    for (uint32_t x = mw[j]; x; x &= ~(1u << (31 - __clz(x)))) {
      int i = 16 * j + 31 - __clz(x);
      int sc = len - i - 1 - 4 * (above + seen++);
      if (i >= first && sc >= best_l) {           // ties to the lower i
        best_l = sc;
        pos_l = i;
      }
    }
  int best = __reduce_max_sync(kFull, best_l);
  int bpos = __reduce_min_sync(kFull, best_l == best ? pos_l : L);
  int js = 0;
  for (int j = j0; j < j1; ++j) js += __popc(mw[j] & from_base(j, bpos + 1));
  js = __reduce_add_sync(kFull, js);
  bool keep = m == 0 || (first < 0 && (js == m - 1 || len - 4 * m >= best));
  int qs = keep ? 0 : bpos + 1;
  qs = qs < len ? qs : len;

  // qend: mismatches at or after qstart scanned rightward; the score of
  // mismatch i is (i - qs) - 4 x (mismatches in [qs, i))
  n_t = 0;
  for (int j = j0; j < j1; ++j) n_t += __popc(mw[j] & from_base(j, qs));
  int below = excl_prefix_sum(n_t, lane);
  int m2 = __shfl_sync(kFull, below + n_t, 31);
  cmax = kNeg;
  seen = 0;
  for (int j = j0; j < j1; ++j)
    for (uint32_t x = mw[j] & from_base(j, qs); x; x &= x - 1) {
      int i = 16 * j + __ffs(x) - 1;
      cmax = max(cmax, i - qs - 4 * (below + seen++));
    }
  run = excl_prefix_max(cmax, lane);
  term = L;
  seen = 0;
  for (int j = j0; j < j1 && term == L; ++j)
    for (uint32_t x = mw[j] & from_base(j, qs); x; x &= x - 1) {
      int i = 16 * j + __ffs(x) - 1;
      int sc = i - qs - 4 * (below + seen++);
      if (sc < run && sc + (len - i) < 0) {
        term = i;
        break;
      }
      run = max(run, sc);
    }
  int first2 = __reduce_min_sync(kFull, term);      // L: none
  best_l = kNeg;
  pos_l = -1;
  seen = 0;
  for (int j = j0; j < j1; ++j)
    for (uint32_t x = mw[j] & from_base(j, qs); x; x &= x - 1) {
      int i = 16 * j + __ffs(x) - 1;
      int sc = i - qs - 4 * (below + seen++);
      if (i <= first2 && sc >= best_l) {          // ties to the higher i
        best_l = sc;
        pos_l = i;
      }
    }
  int best2 = __reduce_max_sync(kFull, best_l);
  int bpos2 = __reduce_max_sync(kFull, best_l == best2 ? pos_l : -1);
  int js2 = 0;
  for (int j = j0; j < j1; ++j)
    js2 += __popc(mw[j] & from_base(j, qs) & ~from_base(j, bpos2));
  js2 = __reduce_add_sync(kFull, js2);
  bool keep2 = m2 == 0 || (first2 >= L && (js2 == m2 - 1 ||
                                            (len - qs) - 4 * m2 >= best2));
  int qe = keep2 ? len : bpos2;
  qe = qe > qs ? qe : qs;

  // the kept interval [qs, qe): mismatches, score, quals
  int nmm = 0;
  for (int j = j0; j < j1; ++j)
    nmm += __popc(mw[j] & from_base(j, qs) & ~from_base(j, qe));
  nmm = __reduce_add_sync(kFull, nmm);
  if (a.quals) {
    const uint8_t* q = a.quals + (long long)b * L;
    int qsum = 0, mmsum = 0;
    for (int i = qs + lane; i < qe; i += 32) {
      int src = rc ? len - 1 - i : i;
      src = src < 0 ? 0 : (src > L - 1 ? L - 1 : src);
      int qv = q[src];
      qsum += qv;
      if ((mw[i >> 4] >> (i & 15)) & 1u) mmsum += qv;
    }
    qsum = __reduce_add_sync(kFull, qsum);
    mmsum = __reduce_add_sync(kFull, mmsum);
    if (lane == 0) {
      int span = qe - qs > 1 ? qe - qs : 1;
      out[4LL * a.B + b] = mmsum;
      out[5LL * a.B + b] = (int32_t)((16LL * qsum) / span);
    }
  }
  if (lane == 0) {
    out[b] = qs;
    out[(long long)a.B + b] = qe;
    out[2LL * a.B + b] = 8 * (qe - qs - nmm) - 24 * nmm;
    out[3LL * a.B + b] = nmm;
  }
}

// ------------------------------------- rows of up to 32 words: segments

constexpr int kKeyNeg = kNeg * 1024;    // a key below every mismatch's

// 4 t-ordered bytes (each & 3) as 2-bit codes, byte t at bits 2t
__device__ __forceinline__ uint32_t pack_le4(uint32_t y) {
  y &= 0x03030303u;
  return (y & 3u) | ((y >> 6) & 0xCu) | ((y >> 12) & 0x30u) |
         ((y >> 18) & 0xC0u);
}

__device__ __forceinline__ uint32_t pack16(const uint32_t t[4]) {
  return pack_le4(t[0]) | (pack_le4(t[1]) << 8) | (pack_le4(t[2]) << 16) |
         (pack_le4(t[3]) << 24);
}

// 1 in each byte of x that is not 0
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t x) {
  x |= x >> 4;
  x |= x >> 2;
  x |= x >> 1;
  return x & 0x01010101u;
}

// the sum of the bytes of q[4] (t-ordered) whose bit t of m16 is set
__device__ __forceinline__ int masked_sum(const uint32_t q[4],
                                          uint32_t m16) {
  unsigned s = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t m4 = (m16 >> (4 * k)) & 15u;
    uint32_t bm = ((m4 * 0x00204081u) & 0x01010101u) * 0xFFu;
    s = __dp4a(q[k] & bm, 0x01010101u, s);
  }
  return (int)s;
}

// bases 16 j .. 16 j + 15 of a row's bytes in the aligned orientation,
// 4 t-ordered bytes a word: row[i] forwards, row[len - 1 - i] backwards
// (rc); bytes past min(len, L) (lim) undefined. With vec (L % 16 == 0,
// the row 16-byte aligned, len <= L) one 16-byte load forwards, or the
// 5 aligned words around the mirrored bytes, funnel-shifted and
// byte-reversed; else byte loads below lim (the rc source clamped to
// the row's last byte, as the plain version's gather).
__device__ __forceinline__ void row_bytes16(const uint8_t* row, int L,
                                            int len, int lim, bool rc,
                                            int j, bool vec,
                                            uint32_t t[4]) {
  if (vec && !rc) {
    uint4 x = __ldg(reinterpret_cast<const uint4*>(row) + j);
    t[0] = x.x;
    t[1] = x.y;
    t[2] = x.z;
    t[3] = x.w;
  } else if (vec) {
    int o = len - 16 * (j + 1);         // the first byte, may be < 0
    int w0 = o >> 2;
    const uint32_t* r32 = reinterpret_cast<const uint32_t*>(row);
    uint32_t x[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      int w = w0 + k;
      x[k] = (w >= 0 && 4 * w < L) ? __ldg(r32 + w) : 0u;
    }
    uint32_t sh = (uint32_t)(o & 3) * 8u;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      t[3 - k] = __byte_perm(__funnelshift_r(x[k], x[k + 1], sh), 0,
                             0x0123);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) t[k] = 0;
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      int i = 16 * j + u;
      if (i < lim) {
        int src = rc ? len - 1 - i : i;
        src = src < L - 1 ? src : L - 1;
        t[u >> 2] |= (uint32_t)__ldg(row + src) << (8 * (u & 3));
      }
    }
  }
}

// the inclusive scan of (count, best key) pairs over the segment, from
// the last lane down (SUFFIX) or from lane 0 up: a block's keys lose 4
// x 1024 for each mismatch scanned before it
template <int SEG, bool SUFFIX>
__device__ __forceinline__ void seg_scan(int& n, int& key, int sl,
                                         unsigned mask) {
#pragma unroll
  for (int d = 1; d < SEG; d <<= 1) {
    int on = SUFFIX ? __shfl_down_sync(mask, n, d, SEG)
                    : __shfl_up_sync(mask, n, d, SEG);
    int ok = SUFFIX ? __shfl_down_sync(mask, key, d, SEG)
                    : __shfl_up_sync(mask, key, d, SEG);
    if (SUFFIX ? sl + d < SEG : sl >= d) {
      key = max(ok, key - 4096 * on);
      n += on;
    }
  }
}

template <int SEG>
__device__ __forceinline__ int seg_sum(int x, unsigned mask) {
#pragma unroll
  for (int d = SEG / 2; d; d >>= 1) x += __shfl_xor_sync(mask, x, d, SEG);
  return x;
}

template <int SEG>
__device__ void segment_rows(const TrimArgs& a, int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31, sl = lane & (SEG - 1);
  const unsigned mask =
      SEG == 32 ? kFull : ((1u << SEG) - 1u) << (lane & ~(SEG - 1));
  const long long b =
      ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * (32 / SEG) +
      lane / SEG;
  if (b >= a.B) return;                 // the whole segment
  const int W = a.W, L = a.L, j = sl;
  int len = __ldg(a.lengths + b);
  int lim = len < L ? len : L;
  bool rc = __ldg(a.strand + b) == 1;
  int space = rc ? a.space_r : a.space_f;
  unsigned long long d = (unsigned long long)__ldg(a.diag + b);
  bool valid = d != kInvalid;
  uint32_t start = valid ? (uint32_t)d : 0u;
  uint32_t s2 = (start & 15u) << 1;
  bool zext, zext_a = false;
  long long w0 = window_start(start, a.gwords, W, a.safe_pad, &zext);
  long long wa = a.galt ? window_start(start, a.awords, W, a.safe_pad,
                                       &zext_a) : 0;
  long long bb = start >> 5;
  uint32_t sb = start & 31u;
  bool vec = a.vec && len <= L;
  int base = 16 * j;
  bool mine = j < W && base < lim;      // this lane's word has bases

  // the mismatch word, bit t = base 16 j + t, below lim; the quals
  uint32_t m16 = 0, qv[4] = {0, 0, 0, 0};
  if (mine) {
    if (a.quals)
      row_bytes16(a.quals + b * L, L, len, lim, rc, j, vec, qv);
    if (!valid) {
      m16 = 0xFFFFu;
    } else {
      uint32_t g = window_word(a.genome, a.gwords, w0 + j, s2, zext);
      uint32_t ga = a.galt ? window_word(a.galt, a.awords, wa + j, s2, zext_a)
                           : 0u;
      uint32_t x = 0;
      if (a.has_n) {
        x = ld_clip(a.gnmask, a.nwords, bb + (j >> 1)) >> sb;
        if (sb) x |= ld_clip(a.gnmask, a.nwords, bb + (j >> 1) + 1)
                     << (32u - sb);
      }
      uint32_t cw[4], nw[4];
      row_bytes16(a.codes + b * L, L, len, lim, rc, j, vec, cw);
      row_bytes16(a.nmask + b * L, L, len, lim, rc, j, vec, nw);
      uint32_t r = pack16(cw);
      r = to_space(rc ? ~r : r, space);
#pragma unroll
      for (int k = 0; k < 4; ++k) nw[k] = nonzero_bytes(nw[k]);
      uint32_t qn = pack16(nw);
      uint32_t mm = fold(r ^ to_space(g, space));
      if (a.galt) mm &= fold(r ^ to_space(ga, space));
      mm = a.query_unk ? (mm | qn) : (mm & ~qn);
      if (a.has_n) {
        uint32_t gm = spread16((j & 1) ? (x >> 16) : x);
        mm = a.genome_unk ? (mm | gm) : (mm & ~gm);
      }
      m16 = compress16(mm);
    }
    if (lim - base < 16) m16 &= (1u << (lim - base)) - 1u;
  }
  const uint32_t limbits = mine ? from_base(j, 0) & ~from_base(j, lim) : 0u;

  int qs = 0, qe = len, nmm = 0;
  unsigned any = __ballot_sync(mask, m16 != 0) & mask;
  if (any) {
    // qstart: mismatches scanned from the 3' end leftward; the score of
    // mismatch i is (len - i - 1) - 4 x (mismatches right of i), its key
    // score x 1024 + (1023 - i): the best key is the best score at the
    // lowest position
    int n = __popc(m16), key = kKeyNeg, seen = 0;
    for (uint32_t x = m16; x; x &= ~(1u << (31 - __clz(x)))) {
      int i = base + 31 - __clz(x);
      key = max(key, (len - i - 1 - 4 * seen++) * 1024 + 1023 - i);
    }
    seg_scan<SEG, true>(n, key, sl, mask);
    int above = __shfl_down_sync(mask, n, 1, SEG);
    int run = __shfl_down_sync(mask, key, 1, SEG);
    int m = __shfl_sync(mask, n, 0, SEG);
    int total = __shfl_sync(mask, key, 0, SEG);
    if (sl == SEG - 1) {
      above = 0;
      run = kKeyNeg;
    }
    int term = -1, bkey = 0;
    seen = 0;
    for (uint32_t x = m16; x; x &= ~(1u << (31 - __clz(x)))) {
      int i = base + 31 - __clz(x);
      int sc = len - i - 1 - 4 * (above + seen++);
      int k = sc * 1024 + 1023 - i;
      if (sc < (run >> 10) && sc + i + 1 < 0) {
        term = i;
        bkey = max(k, run);
        break;
      }
      run = max(run, k);
    }
    // the first stop scanned: the last lane that has one
    unsigned stops = __ballot_sync(mask, term >= 0) & mask;
    if (stops) total = __shfl_sync(mask, bkey, 31 - __clz(stops));
    int best = total >> 10, bpos = 1023 - (total & 1023);
    // "the best is the last mismatch scanned": the lowest mismatch
    int l0 = __ffs(any) - 1;
    int lowest = 16 * (l0 & (SEG - 1)) + __ffs(__shfl_sync(mask, m16, l0))
                 - 1;
    bool keep = !stops && (bpos == lowest || len - 4 * m >= best);
    qs = keep ? 0 : bpos + 1;
    qs = qs < len ? qs : len;

    // qend: mismatches at or after qstart scanned rightward; the score
    // of mismatch i is (i - qs) - 4 x (mismatches in [qs, i)), its key
    // score x 1024 + i: the best score at the highest position
    uint32_t w2 = m16 & from_base(j, qs);
    unsigned any2 = __ballot_sync(mask, w2 != 0) & mask;
    if (any2) {
      n = __popc(w2);
      key = kKeyNeg;
      seen = 0;
      for (uint32_t x = w2; x; x &= x - 1) {
        int i = base + __ffs(x) - 1;
        key = max(key, (i - qs - 4 * seen++) * 1024 + i);
      }
      seg_scan<SEG, false>(n, key, sl, mask);
      int below = __shfl_up_sync(mask, n, 1, SEG);
      run = __shfl_up_sync(mask, key, 1, SEG);
      int m2 = __shfl_sync(mask, n, SEG - 1, SEG);
      total = __shfl_sync(mask, key, SEG - 1, SEG);
      if (sl == 0) {
        below = 0;
        run = kKeyNeg;
      }
      term = -1;
      seen = 0;
      for (uint32_t x = w2; x; x &= x - 1) {
        int i = base + __ffs(x) - 1;
        int sc = i - qs - 4 * (below + seen++);
        int k = sc * 1024 + i;
        if (sc < (run >> 10) && sc + (len - i) < 0) {
          term = i;
          bkey = max(k, run);
          break;
        }
        run = max(run, k);
      }
      // the first stop scanned: the first lane that has one
      stops = __ballot_sync(mask, term >= 0) & mask;
      bool stopped = stops != 0;
      if (stopped) total = __shfl_sync(mask, bkey, __ffs(stops) - 1);
      int best2 = total >> 10, bpos2 = total & 1023;
      int lh = 31 - __clz(any2);
      int highest = 16 * (lh & (SEG - 1)) + 31 -
                    __clz(__shfl_sync(mask, w2, lh));
      bool keep2 = !stopped && (bpos2 == highest ||
                                (len - qs) - 4 * m2 >= best2);
      // the kept mismatches: all from qs on, or those in [qs, bpos2)
      int js2 = __shfl_sync(mask, below + __popc(w2 & ((1u << (bpos2 & 15))
                                                       - 1u)),
                            bpos2 >> 4, SEG);
      qe = keep2 ? len : (bpos2 > qs ? bpos2 : qs);
      nmm = keep2 ? m2 : js2;
    }
  }

  // the kept interval [qs, qe): score, and the quals' sums
  if (a.quals) {
    uint32_t kept = from_base(j, qs) & ~from_base(j, qe) & limbits;
    int qsum = seg_sum<SEG>(masked_sum(qv, kept), mask);
    int mmsum = seg_sum<SEG>(masked_sum(qv, kept & m16), mask);
    if (sl == 0) {
      int span = qe - qs > 1 ? qe - qs : 1;
      out[4LL * a.B + b] = mmsum;
      out[5LL * a.B + b] = (int32_t)((16LL * qsum) / span);
    }
  }
  if (sl == 0) {
    out[b] = qs;
    out[(long long)a.B + b] = qe;
    out[2LL * a.B + b] = 8 * (qe - qs - nmm) - 24 * nmm;
    out[3LL * a.B + b] = nmm;
  }
}

// SEG 0: a warp a row (past 32 words); else SEG lanes a row
template <int SEG>
__global__ void __launch_bounds__(32 * kWarps)
    trim_kernel(TrimArgs a, int32_t* __restrict__ out) {
  if constexpr (SEG == 0)
    wide_row(a, out);
  else
    segment_rows<SEG>(a, out);
}

template <int SEG>
int launch_trim(const TrimArgs& a, int32_t* out, size_t smem,
                cudaStream_t st) {
  long long rows = SEG ? 32 / SEG : 1;
  long long warps = (a.B + rows - 1) / rows;
  unsigned blocks = (unsigned)((warps + kWarps - 1) / kWarps);
  trim_kernel<SEG><<<blocks, 32 * kWarps, smem, st>>>(a, out);
  return (int)cudaGetLastError();
}


}  // namespace

// genome, its N bitmap and the alternate genome (null: no SNP
// comparison) as int32 bit patterns with their word counts; codes and
// nmask uint8[B, L]; lengths, strand int32[B]; diag int64[B]; quals
// uint8[B, L] or null; W = ceil(L / 16); space_f, space_r each strand's
// base space (0 standard, 1-4 ct, ga, ag, tc); safe_pad the genome's
// padding words; seg the lanes a row (W rounded up to a power of two,
// W <= 32; 0: a warp a row); vec 1 where L % 16 == 0 and codes, nmask
// and quals are 16-byte aligned (16-byte loads); scratch int32[B, W] or
// null (a warp a row: W words a row of shared memory). out int32[4 or
// 6, B]: qstart, qend, score, nmm and, with quals, mm_qualsum and
// qual_mean16. Returns cudaGetLastError(), or cudaErrorInvalidValue for
// an unknown seg or where a row's words need the scratch.
extern "C" int tt_trim_stage(const void* genome, long long gwords,
                             const void* gnmask, long long nwords,
                             const void* galt, long long awords,
                             const void* codes, const void* nmask,
                             const void* lengths, const void* strand,
                             const void* diag, const void* quals, int B,
                             int L, int W, int has_n, int query_unk,
                             int genome_unk, int space_f, int space_r,
                             int safe_pad, int seg, int vec, void* scratch,
                             void* out, void* stream) {
  TrimArgs a;
  a.genome = (const uint32_t*)genome;
  a.gwords = gwords;
  a.gnmask = (const uint32_t*)gnmask;
  a.nwords = nwords;
  a.galt = (const uint32_t*)galt;
  a.awords = awords;
  a.codes = (const uint8_t*)codes;
  a.nmask = (const uint8_t*)nmask;
  a.lengths = (const int32_t*)lengths;
  a.strand = (const int32_t*)strand;
  a.diag = (const long long*)diag;
  a.quals = (const uint8_t*)quals;
  a.B = B;
  a.L = L;
  a.W = W;
  a.has_n = has_n;
  a.query_unk = query_unk;
  a.genome_unk = genome_unk;
  a.space_f = space_f;
  a.space_r = space_r;
  a.safe_pad = safe_pad;
  a.vec = vec;
  a.scratch = (uint32_t*)scratch;
  cudaStream_t st = (cudaStream_t)stream;
  int32_t* o = (int32_t*)out;
  if (seg) {
    if (W > seg || 2 * W <= seg) return (int)cudaErrorInvalidValue;
    switch (seg) {
      case 1: return launch_trim<1>(a, o, 0, st);
      case 2: return launch_trim<2>(a, o, 0, st);
      case 4: return launch_trim<4>(a, o, 0, st);
      case 8: return launch_trim<8>(a, o, 0, st);
      case 16: return launch_trim<16>(a, o, 0, st);
      case 32: return launch_trim<32>(a, o, 0, st);
    }
    return (int)cudaErrorInvalidValue;
  }
  size_t smem = scratch ? 0 : (size_t)kWarps * W * sizeof(uint32_t);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  return launch_trim<0>(a, o, smem, st);
}
