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
// a random place; the scans are a few integer operations a mismatch.
//
// Design: one warp per row. Lane j builds the row's mismatch words j,
// j + 32, ... (16 bases each: the read word packed from the codes,
// forwards or complemented backwards on the rc strand, XOR the genome
// window word, folded, then the N masks), compressed to 16 bits and cut
// at min(len, L), into shared memory (past TRIM_SMEM_WORDS words a row,
// a global scratch). The scans then give each lane a contiguous chunk
// of words: a warp scan of the chunks' mismatch counts places each
// mismatch's score, a warp scan of the chunks' best scores gives each
// mismatch the running maximum before it, and each lane walks its own
// mismatches (ffs/clz over the words) for the stop and the best;
// reductions pick the first stop and the best with the plain version's
// tie rules. Genome words are fetched as tpumap's window is (clamped
// start for windows of 16 words or more, zero past the padded end).
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

__global__ void __launch_bounds__(32 * kWarps)
    trim_kernel(TrimArgs a, int32_t* __restrict__ out) {
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

}  // namespace

// genome, its N bitmap and the alternate genome (null: no SNP
// comparison) as int32 bit patterns with their word counts; codes and
// nmask uint8[B, L]; lengths, strand int32[B]; diag int64[B]; quals
// uint8[B, L] or null; W = ceil(L / 16); space_f, space_r each strand's
// base space (0 standard, 1-4 ct, ga, ag, tc); safe_pad the genome's
// padding words; scratch int32[B, W] or null (W words a row of shared
// memory). out int32[4 or 6, B]: qstart, qend, score, nmm and, with
// quals, mm_qualsum and qual_mean16. Returns cudaGetLastError(), or
// cudaErrorInvalidValue where a row's words need the scratch.
extern "C" int tt_trim_stage(const void* genome, long long gwords,
                             const void* gnmask, long long nwords,
                             const void* galt, long long awords,
                             const void* codes, const void* nmask,
                             const void* lengths, const void* strand,
                             const void* diag, const void* quals, int B,
                             int L, int W, int has_n, int query_unk,
                             int genome_unk, int space_f, int space_r,
                             int safe_pad, void* scratch, void* out,
                             void* stream) {
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
  a.scratch = (uint32_t*)scratch;
  size_t smem = scratch ? 0 : (size_t)kWarps * W * sizeof(uint32_t);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  unsigned blocks = (unsigned)((B + kWarps - 1) / kWarps);
  trim_kernel<<<blocks, 32 * kWarps, smem, (cudaStream_t)stream>>>(
      a, (int32_t*)out);
  return (int)cudaGetLastError();
}
