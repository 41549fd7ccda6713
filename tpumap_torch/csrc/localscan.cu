// K6a-c: the window scans of the RNA path's salvage and ambiguous-end
// review: one kernel template with an instance per scan for K6a and K6c,
// and a kernel of its own for K6b.
//
// Replaces: tpumap/ops/localscan.py: _phase_mismatch_counts (34-65) with
// scan_fragment (68-115, K6a), scan_exact_sites (118-145, K6b) and
// scan_fragment_runs (148-225, K6c): a fragment of <= 16 bases compared
// with every offset of a row's genome window (65,536 bp on the path) as
// 16 shift phases of an XOR/popcount stream over the window's packed
// words, then an exact top-k (K6b: the count of exact placements and the
// first top_k).
//
// Bound on the H100: integer ALU. A row is 4,097 words x 16 phases, and
// the window itself is 16.4 KB read once. tpumap's form (and the plain
// version) writes [R, 4097, 16] intermediates to memory, 1.07 GB at
// R = 2,048; these kernels write only the top k. So the time is the
// instructions spent a window offset: the per-offset score, and for the
// few offsets that can reach the top k, the compare with the kept keys
// and the insertion, which a warp runs whenever any of its lanes inserts.
//
// Both kernels take one block per row: at most 256 threads (THREADS;
// K6b's launches on the path are 99% rows without a fragment, so a
// launch takes one active row's latency, and 256 beat 128, 512 and 1,024
// there), fewer for a window of fewer words (K6a and K6c a warp per 32
// words, so the mate repair's 1,024-base window takes 64; K6b a warp per
// 128). The block loads the row's raw window words into shared
// memory, fetched as tpumap fetches them (one dynamic slice whose start
// is clamped to len - size; K6b issues them as cp.async copies, all of a
// thread's in flight at once), and aligns two neighbouring words with
// __funnelshift_r.
//
// K6a and K6c (localscan_kernel, MODE a template parameter; K, the
// length of each thread's kept list, another): each thread takes whole
// words and scores all 16 phases of each, one funnel shift a phase, with
// no bound check; the one partial word at the window's end has its
// phases guarded. Every offset gets a unique 32-bit key
// (score << 17 | offset), so tpumap's iterated block minima equal an
// exact k-smallest: each thread keeps its K smallest keys in registers
// (a compare-exchange insertion), then the block pops the global minimum
// k times with warp reductions. Two passes (two_pass, with a Scan policy
// each). Pass 1 gives each word the least of its 16 phases' scores (K6c:
// of a proxy) in shared memory and each thread its least over its words;
// it builds no keys. The threads' least scores give a block bar: the
// least score S that top_k distinct threads reach, so at least top_k
// distinct offsets score S or less and a key of a higher score is in no
// top k. Pass 2 scores exactly, and inserts, only the phases of the
// words that can reach S (a few of 4,096 on random windows).
// - K6a scores mismatches, popc over the fold of x = stream ^ fw, 0-16
//   (about 6 instructions an offset in pass 1). Its kept list is 4 keys
//   where top_k <= 4 (every call site), else 8. Short fragments tie
//   everywhere (a 1-base fragment matches a quarter of the window), so
//   S is 0 and every word can reach it; but a thread's words come in
//   ascending offsets, so once its K-th key has count c, pass 2 skips
//   the words whose least count is c or more: a tie-heavy row costs a
//   word or two a thread. Rows with no fragment (length <= 0) score 0
//   everywhere, so they return at once with offsets 0 .. top_k - 1 and
//   count 0.
// - K6c scores 32 - __clz(mm2), suffix, or
//   32 - __clz(__brev(mm2)), prefix, which orders as 16 - run: mm2 has
//   one bit per mismatching base on the even bits, so the run anchored
//   at the last base is __clz(mm2) >> 1 and at the first
//   __clz(__brev(mm2)) >> 1, 16 for mm2 == 0, equal to the plain
//   version's smear popc(~y & LOW) for all 2^16 patterns. The run ends
//   at the highest (suffix) or lowest (prefix) set bit of
//   x = stream ^ fw, so x, or ~(x ^ (x - 1)), is a proxy that orders
//   with it at no bit scan (3 or 5 instructions an offset). Its fragment
//   is always 16 bases and it reads no lengths.
//
// K6b (exact_sites_kernel) keys an offset by the offset itself, so its
// top_k smallest keys are its first top_k hits in window order: a count
// and a stream compaction, with no kept list, bar or pops. One pass:
// - Each warp takes a contiguous run of words, and a lane 4 consecutive
//   words an iteration (one 128-bit and one 64-bit shared load, 5 funnel
//   shifts to align them), so the offsets come in (warp, iteration,
//   lane, word) order.
// - A word's 16 phases are tested at once, bit-parallel over the
//   fragment's bases rather than its offsets: with rep[i] base i of the
//   fragment in all 16 pairs, acc = OR over i < flen of
//   (window >> 2i) ^ rep[i] has pair p 00 iff offset p matches, so the
//   hit mask ~(acc | acc >> 1) & LOW costs 2 flen + 1 integer
//   instructions a word (flen - 1 funnel shifts, flen xor-ors, the
//   fold), against ~3 an offset for a test a phase, and against a
//   Shift-And over the word's four code masks, which must pick each
//   base's mask by its code, known only at run time. The loop is
//   instantiated per length (0-16, 0 where F is: no base to test, every
//   offset hits, as the plain version gives; the length is uniform in a
//   block) and
//   the last iteration masks the phases past the window or the warp's
//   run.
// - The count is a popcount of two words' masks at a time, summed over
//   the lanes and the warps once at the end. Every offset is tested: no
//   pass can skip a word of a count.
// - While a warp holds fewer than top_k hits and some lane has one, the
//   lanes rank their hits (a shuffle scan of their counts) and write the
//   first top_k offsets of the warp to shared memory. The warps' first
//   hits in warp order are the row's: after one __syncthreads, each
//   output slot takes the hit of its rank from the warp whose prefix of
//   counts covers it, INVALID past the last. A second walk of the runs
//   to rank the hits after the block's scan, as an alternative, would
//   repeat the whole run of every warp with a hit on the sparse rows of
//   7-10 bases the path sends.
// Rows with no fragment (length <= 0) return at once with no hits, as
// tpumap's masked hits give.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;           // the most threads a row
constexpr int WARPS = THREADS / 32;
constexpr int OFF_BITS = 17;
constexpr int SAFE_PAD_WORDS = 4352;   // tpumap/ops/verify.py
constexpr uint32_t LOW = 0x55555555u;
constexpr uint32_t NONE = 0xFFFFFFFFu;
constexpr unsigned FULL = 0xFFFFFFFFu;

// localscan_kernel's scans (the values are in its instances' names,
// which the profiles and the ptxas check read)
constexpr int FRAG = 0, RUNS_SUFFIX = 2, RUNS_PREFIX = 3;

// K6c's key of window offset o from x = stream ^ fw (fragment base j
// against genome base o + j at bits 2j, 2j + 1)
template <int MODE>
__device__ __forceinline__ uint32_t offset_key(uint32_t x, uint32_t o) {
  const uint32_t mm2 = (x | (x >> 1)) & LOW;
  const uint32_t lead =
      MODE == RUNS_SUFFIX ? __clz(mm2) : __clz(__brev(mm2));
  return ((32u - lead) << OFF_BITS) | o;
}

// two_pass's policy for each two-pass scan, from x = stream ^ fw:
// score(x) an offset's pass-1 score; bin(m) the least key score that a
// thread whose least pass-1 score is m reaches (its histogram bin);
// thr(S) the largest pass-1 score whose key can score S or less;
// key(score, x, o) the offset's key; CUTOFF whether pass 2 may skip a
// word whose least score is at or above the thread's K-th key score
// (where the pass-1 score is the key's score).
// K6c: the proxy x (suffix) or ~(x ^ (x - 1)) (prefix), both 0 for the
// clean run of 16; the key's score is 32 - a bit scan (offset_key).
template <int MODE>
struct Scan {
  static_assert(MODE == RUNS_SUFFIX || MODE == RUNS_PREFIX, "a runs scan");
  static constexpr bool CUTOFF = false;
  __device__ static __forceinline__ uint32_t score(uint32_t x, uint32_t) {
    return MODE == RUNS_SUFFIX ? x : ~(x ^ (x - 1u));
  }
  // prefix: proxy 0 is x == 0, score 0, or a lowest set bit 31, score 2:
  // say 2
  __device__ static __forceinline__ int bin(uint32_t m) {
    if (MODE == RUNS_SUFFIX)
      return (int)(offset_key<MODE>(m, 0u) >> OFF_BITS);
    if (m == 0u) return 2;
    const int a = 31 - __clz(~m);          // the lowest set bit of x
    return 32 - 2 * (a >> 1);
  }
  // S >= 31 bounds nothing
  __device__ static __forceinline__ uint32_t thr(int S) {
    if (S <= 0) return 0u;                  // only the clean run
    if (S >= 31) return 0xFFFFFFFFu;
    if (MODE == RUNS_SUFFIX)                // the highest set bit <= S
      return (2u << S) - 1u;
    // the lowest set bit >= a0, the even bound of 32 - S
    const int a0 = (33 - S) & ~1;
    return a0 >= 32 ? 0u : 0u - (2u << a0);
  }
  __device__ static __forceinline__ uint32_t key(uint32_t, uint32_t x,
                                                 uint32_t o) {
    return offset_key<MODE>(x, o);
  }
};

// K6a: the mismatch count, 0-16, is both scores
template <>
struct Scan<FRAG> {
  static constexpr bool CUTOFF = true;
  __device__ static __forceinline__ uint32_t score(uint32_t x,
                                                   uint32_t lowfm) {
    // a mismatching base has a set bit in x's odd bits of (x | 2x); the
    // doubling as a multiply issues on the FMA pipe, not the integer
    // pipe that the funnel shift, xor and mask use
    uint32_t x2;
    asm("mul.lo.u32 %0, %1, 2;" : "=r"(x2) : "r"(x));
    return (uint32_t)__popc((x | x2) & (lowfm << 1));
  }
  __device__ static __forceinline__ int bin(uint32_t m) { return (int)m; }
  __device__ static __forceinline__ uint32_t thr(int S) { return (uint32_t)S; }
  __device__ static __forceinline__ uint32_t key(uint32_t score, uint32_t,
                                                 uint32_t o) {
    return score << OFF_BITS | o;
  }
};

// keep the K smallest keys in top[] (ascending)
template <int K>
__device__ __forceinline__ void insert(uint32_t (&top)[K], uint32_t key) {
#pragma unroll
  for (int i = 0; i < K; ++i) {        // keep the smaller, carry on
    const uint32_t t = top[i];
    top[i] = min(t, key);
    key = max(t, key);
  }
}

// K6a's and K6c's scan of a row (all threads of the block): pass 1 takes
// each word's least score (K6c: proxy) into least[] (shared) and each
// thread's least over its words; the thread minima give the bar, the
// least score S that at least top_k of them reach (top_k distinct
// offsets score S or less, so a key of a higher score is in no top k);
// pass 2 scores exactly, and inserts, only the phases of the words that
// can reach S. A thread visits its words in ascending order, so a word's
// offsets all lie past those of the keys it holds: once its K-th key has
// score c, a word can add a key only if its least score is under c
// (P::CUTOFF: where the pass-1 score is the key's).
template <class P, int K>
__device__ __forceinline__ void two_pass(const uint32_t* raw, uint32_t* least,
                                         uint32_t s2, uint32_t fw,
                                         uint32_t lowfm, int nfull, int rem,
                                         int top_k, uint32_t (&top)[K]) {
  __shared__ int hist[32];               // threads by their least's score
  const int tid = threadIdx.x, lane = tid & 31, nthr = blockDim.x;
  if (tid < 32) hist[tid] = 0;
  const int nwords = nfull + (rem ? 1 : 0);
  uint32_t mine = 0xFFFFFFFFu;
  bool any = false;
  for (int j = tid; j < nwords; j += nthr) {
    const uint32_t lo = __funnelshift_r(raw[j], raw[j + 1], s2);
    const uint32_t hi = __funnelshift_r(raw[j + 1], raw[j + 2], s2);
    uint32_t m = 0xFFFFFFFFu;
    if (j < nfull) {
#pragma unroll
      for (int p = 0; p < 16; ++p)
        m = min(m, P::score(__funnelshift_r(lo, hi, 2 * p) ^ fw, lowfm));
    } else {
#pragma unroll
      for (int p = 0; p < 16; ++p)
        if (p < rem)
          m = min(m, P::score(__funnelshift_r(lo, hi, 2 * p) ^ fw, lowfm));
    }
    least[j] = m;
    mine = min(mine, m);
    any = true;
  }
  __syncthreads();                       // hist zeroed, least[] written
  if (any)
    atomicAdd(&hist[min(P::bin(mine), 31)], 1);
  __syncthreads();
  // the first score whose running count reaches top_k; none below 31
  // (K6c's scores 31 and 32 bound nothing) leaves the bar open
  int cum = hist[lane];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(FULL, cum, off);
    if (lane >= off) cum += v;
  }
  const unsigned reach = __ballot_sync(FULL, cum >= top_k) & 0x7FFFFFFFu;
  const int S = reach ? __ffs(reach) - 1 : -1;
  uint32_t bar = S < 0 ? NONE : (uint32_t)(S + 1) << OFF_BITS;
  const uint32_t thr = S < 0 ? 0xFFFFFFFFu : P::thr(S);
  for (int j = tid; j < nwords; j += nthr) {
    if (least[j] > thr || (P::CUTOFF && least[j] >= bar >> OFF_BITS))
      continue;
    const uint32_t lo = __funnelshift_r(raw[j], raw[j + 1], s2);
    const uint32_t hi = __funnelshift_r(raw[j + 1], raw[j + 2], s2);
    const int np = j < nfull ? 16 : rem;
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      const uint32_t x = __funnelshift_r(lo, hi, 2 * p) ^ fw;
      const uint32_t pv = P::score(x, lowfm);
      if (p >= np || pv > thr) continue;
      const uint32_t key = P::key(pv, x, 16 * j + p);
      if (key < bar) {
        insert(top, key);
        bar = min(bar, top[K - 1]);
      }
    }
  }
}

template <int MODE, int K>
__global__ void __launch_bounds__(THREADS) localscan_kernel(
    const uint32_t* __restrict__ genome, long long glen_words,
    const long long* __restrict__ win_starts,
    const uint8_t* __restrict__ frag, const int32_t* __restrict__ frag_lens,
    int F, int window, int top_k, long long* __restrict__ out_pos,
    int32_t* __restrict__ out_val) {
  constexpr bool RUNS = MODE == RUNS_SUFFIX || MODE == RUNS_PREFIX;
  extern __shared__ uint32_t raw[];
  __shared__ uint32_t red[WARPS];
  __shared__ uint32_t pick;
  const int r = blockIdx.x;
  const int tid = threadIdx.x, nthr = blockDim.x, nwarps = nthr >> 5;
  const uint32_t ws = (uint32_t)win_starts[r];
  const int flen_raw = RUNS ? 16 : frag_lens[r];
  const int flen = min(max(flen_raw, 0), F);
  long long* pos = out_pos + (long long)r * top_k;
  int32_t* val = out_val + (long long)r * top_k;
  if (MODE == FRAG && flen <= 0) {       // every offset scores 0
    if (tid < top_k) {
      pos[tid] = (long long)(uint32_t)(ws + tid);
      val[tid] = 0;
    }
    return;
  }

  // window words as extract_packed_window(genome, ws, nw + 1) fetches
  // them: nraw = nw + 2 words from the clamped start word
  const int nw = window / 16 + 1;
  const int nraw = nw + 2;
  long long w0 = (long long)(ws >> 4);
  bool zext = false;
  if (nw + 1 >= 16) {
    zext = nraw > SAFE_PAD_WORDS;
    long long lim = zext ? glen_words : glen_words - nraw;
    if (lim < 0) lim = 0;
    if (w0 > lim) w0 = lim;
  }
  for (int i = tid; i < nraw; i += nthr) {
    const long long idx = w0 + i;
    uint32_t v = 0;
    if (!(zext && idx >= glen_words))
      v = genome[idx >= glen_words ? glen_words - 1 : idx];
    raw[i] = v;
  }
  const uint32_t s2 = (ws & 15u) << 1;
  uint32_t fw = 0;
  for (int j = 0; j < F; ++j)
    fw += (uint32_t)frag[(long long)r * F + j] << (2 * j);
  const uint32_t lowfm =
      LOW & (flen >= 16 ? 0xFFFFFFFFu : ((1u << (2 * flen)) - 1u));
  __syncthreads();

  uint32_t top[K];
#pragma unroll
  for (int i = 0; i < K; ++i) top[i] = NONE;
  const int nfull = window / 16;         // words with all 16 phases
  const int rem = window - 16 * nfull;   // phases of the partial word
  two_pass<Scan<MODE>>(raw, raw + nraw, s2, fw, lowfm, nfull, rem, top_k,
                       top);

  // exact block-wide k smallest: pop the minimum head k times (keys are
  // unique, so exactly one thread owns each popped key)
  for (int t = 0; t < top_k; ++t) {
    const uint32_t h = top[0];
    const uint32_t wmin = __reduce_min_sync(FULL, h);
    if ((tid & 31) == 0) red[tid >> 5] = wmin;
    __syncthreads();
    if (tid < 32) {
      const uint32_t v =
          __reduce_min_sync(FULL, tid < nwarps ? red[tid] : NONE);
      if (tid == 0) pick = v;
    }
    __syncthreads();
    const uint32_t m = pick;
    if (h == m && m != NONE) {
#pragma unroll
      for (int i = 0; i < K - 1; ++i) top[i] = top[i + 1];
      top[K - 1] = NONE;
    }
    if (tid == 0) {
      const uint32_t off = m & ((1u << OFF_BITS) - 1u);
      pos[t] = (long long)(uint32_t)(ws + off);
      // K6c's run: (32 - score) >> 1
      val[t] = RUNS ? (int)(32u - (m >> OFF_BITS)) >> 1
                    : (int)(m >> OFF_BITS);
    }
  }
}

// K6b's hit mask of the word at window offsets 16j .. 16j + 15 (lo, and
// hi the next, both aligned to the window): bit 2p set iff the first
// FLEN fragment bases match at offset 16j + p. rep[i] is fragment base i
// in every pair, so pair p of the funnel shift by 2i, xor rep[i], is 00
// iff base i matches at p
template <int FLEN>
__device__ __forceinline__ uint32_t exact_hits(uint32_t lo, uint32_t hi,
                                               const uint32_t (&rep)[16]) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < FLEN; ++i)
    acc |= (i ? __funnelshift_r(lo, hi, 2 * i) : lo) ^ rep[i];
  return ~(acc | (acc >> 1)) & LOW;
}

// the even bits of the first d phases of a word (any d)
__device__ __forceinline__ uint32_t first_phases(int d) {
  return d >= 16 ? LOW : d <= 0 ? 0u : LOW & ((1u << (2 * d)) - 1u);
}

// K6b's scan of a row whose fragment has FLEN bases (all threads of the
// block): warp w takes the words [w * per, (w + 1) * per), a lane 4
// consecutive ones an iteration. Returns in wtot[w] the warp's count of
// exact placements and in first[w] the offsets of its first
// min(count, top_k).
template <int FLEN>
__device__ __forceinline__ void exact_scan(const uint32_t* raw, uint32_t s2,
                                           const uint32_t (&rep)[16],
                                           int window, int per, int top_k,
                                           uint32_t* first, int* wtot) {
  const int lane = threadIdx.x & 31, run0 = (threadIdx.x >> 5) * per;
  int cnt = 0;    // this lane's hits
  int kept = 0;   // the warp's hits so far, while under top_k
  for (int u0 = 0; u0 < per; u0 += 128) {
    const int u = u0 + 4 * lane;
    const int j0 = run0 + u;
    const uint4 q = *reinterpret_cast<const uint4*>(raw + j0);
    const uint2 e = *reinterpret_cast<const uint2*>(raw + j0 + 4);
    const uint32_t a0 = __funnelshift_r(q.x, q.y, s2);
    const uint32_t a1 = __funnelshift_r(q.y, q.z, s2);
    const uint32_t a2 = __funnelshift_r(q.z, q.w, s2);
    const uint32_t a3 = __funnelshift_r(q.w, e.x, s2);
    const uint32_t a4 = __funnelshift_r(e.x, e.y, s2);
    uint32_t h[4] = {exact_hits<FLEN>(a0, a1, rep),
                     exact_hits<FLEN>(a1, a2, rep),
                     exact_hits<FLEN>(a2, a3, rep),
                     exact_hits<FLEN>(a3, a4, rep)};
    if (u >= per || 16 * (j0 + 4) > window) {  // past the run or window
      const int d = u < per ? window - 16 * j0 : 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) h[k] &= first_phases(d - 16 * k);
    }
    // the masks hold even bits only: two words fit one popcount
    const int n = __popc(h[0] | (h[1] << 1)) + __popc(h[2] | (h[3] << 1));
    cnt += n;
    if (kept < top_k && __any_sync(FULL, n != 0)) {
      int incl = n;                      // the warp's hits up to this lane
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(FULL, incl, off);
        if (lane >= off) incl += v;
      }
      int rank = kept + incl - n;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        for (uint32_t m = h[k]; m && rank < top_k; m &= m - 1)
          first[rank++] = 16 * (j0 + k) + ((__ffs(m) - 1) >> 1);
      kept += __shfl_sync(FULL, incl, 31);
    }
  }
  cnt = __reduce_add_sync(FULL, cnt);
  if (lane == 0) *wtot = cnt;
}

// K6b: count the exact placements of each row's fragment in its window
// and keep the first top_k (one block a row; blockDim.x a multiple of 32)
__global__ void __launch_bounds__(THREADS) exact_sites_kernel(
    const uint32_t* __restrict__ genome, long long glen_words,
    const long long* __restrict__ win_starts,
    const uint8_t* __restrict__ frag, const int32_t* __restrict__ frag_lens,
    int F, int window, int top_k, int per, int nbuf,
    long long* __restrict__ out_pos, int32_t* __restrict__ out_count) {
  extern __shared__ __align__(16) uint32_t words[];
  __shared__ uint32_t first[WARPS][8];
  __shared__ int wtot[WARPS];
  const int r = blockIdx.x;
  const int tid = threadIdx.x, nwarps = blockDim.x >> 5;
  const uint32_t ws = (uint32_t)win_starts[r];
  const int flen_raw = frag_lens[r];
  long long* pos = out_pos + (long long)r * top_k;
  if (flen_raw <= 0) {
    if (tid < top_k) pos[tid] = (long long)NONE;
    if (tid == 0) out_count[r] = 0;
    return;
  }
  const int flen = min(flen_raw, F);
  // the window words as localscan_kernel fetches them (the same clamped
  // slice), then zeros up to nbuf (the last iteration's lanes past their
  // warp's run read there, and mask what they read), as cp.async copies
  // of 4 bytes, a copy of 0 bytes filling its word with zeros: a
  // thread's words are all in flight at once, and the fragment's loads
  // go out behind them
  const int nw = window / 16 + 1;
  const int nraw = nw + 2;
  long long w0 = (long long)(ws >> 4);
  bool zext = false;
  if (nw + 1 >= 16) {
    zext = nraw > SAFE_PAD_WORDS;
    long long lim = zext ? glen_words : glen_words - nraw;
    if (lim < 0) lim = 0;
    if (w0 > lim) w0 = lim;
  }
  for (int i = tid; i < nbuf; i += blockDim.x) {
    const long long idx = w0 + i;
    const bool zero = i >= nraw || (zext && idx >= glen_words);
    const uint32_t* src = genome + (idx >= glen_words ? glen_words - 1 : idx);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     (unsigned)__cvta_generic_to_shared(words + i)),
                 "l"(src), "r"(zero ? 0 : 4));
  }
  const uint32_t s2 = (ws & 15u) << 1;
  uint32_t fw = 0;
  for (int j = 0; j < F; ++j)
    fw += (uint32_t)frag[(long long)r * F + j] << (2 * j);
  uint32_t rep[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) rep[i] = ((fw >> (2 * i)) & 3u) * LOW;
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int w = tid >> 5;
  switch (flen) {
#define EXACT_CASE(n)                                                   \
  case n:                                                               \
    exact_scan<n>(words, s2, rep, window, per, top_k, first[w], &wtot[w]); \
    break;
    EXACT_CASE(0) EXACT_CASE(1) EXACT_CASE(2) EXACT_CASE(3) EXACT_CASE(4)
    EXACT_CASE(5) EXACT_CASE(6) EXACT_CASE(7) EXACT_CASE(8) EXACT_CASE(9)
    EXACT_CASE(10) EXACT_CASE(11) EXACT_CASE(12) EXACT_CASE(13)
    EXACT_CASE(14) EXACT_CASE(15) EXACT_CASE(16)
#undef EXACT_CASE
  }
  __syncthreads();

  // hit t of the row is hit t - (hits of the warps before) of the first
  // warp whose prefix of counts passes t; each warp kept min(count, top_k)
  if (tid < top_k) {
    long long p = (long long)NONE;
    for (int v = 0, before = 0; v < nwarps; before += wtot[v++])
      if (tid < before + wtot[v]) {
        p = (long long)(uint32_t)(ws + first[v][tid - before]);
        break;
      }
    pos[tid] = p;
  }
  if (tid == 0) {
    int total = 0;
    for (int v = 0; v < nwarps; ++v) total += wtot[v];
    out_count[r] = total;
  }
}

template <int MODE, int K>
int launch(const void* genome, long long glen_words, const void* win_starts,
           const void* frag, const void* frag_lens, int R, int F, int window,
           int top_k, void* pos, void* val, void* stream) {
  // the raw window words and each word's least score (64 KiB at the
  // largest window, 2^17)
  const int nraw = window / 16 + 3;
  const int bytes = 2 * nraw * (int)sizeof(uint32_t);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        localscan_kernel<MODE, K>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  // a thread a word of the window, a warp per 32 words, at most THREADS
  const int nwords = (window + 15) / 16;
  const int threads = min(THREADS, (nwords + 31) / 32 * 32);
  localscan_kernel<MODE, K><<<R, threads, bytes, (cudaStream_t)stream>>>(
      (const uint32_t*)genome, glen_words, (const long long*)win_starts,
      (const uint8_t*)frag, (const int32_t*)frag_lens, F, window, top_k,
      (long long*)pos, (int32_t*)val);
  return (int)cudaGetLastError();
}

}  // namespace

// The three scans share one argument list; each ignores some of it: K6a
// unused and count, K6b unused and val, K6c frag_lens and count.

// K6a: top_k lowest-mismatch placements of each row's fragment (a kept
// list of 4 keys a thread where top_k <= 4)
extern "C" int tt_scan_fragment(const void* genome, long long glen_words,
                                const void* win_starts, const void* frag,
                                const void* frag_lens, int R, int F,
                                int window, int top_k, int unused, void* pos,
                                void* val, void* count, void* stream) {
  auto fn = top_k <= 4 ? launch<FRAG, 4> : launch<FRAG, 8>;
  return fn(genome, glen_words, win_starts, frag, frag_lens, R, F, window,
            top_k, pos, val, stream);
}

// K6b: exact placements, counted, the top_k smallest offsets kept
extern "C" int tt_scan_exact_sites(const void* genome, long long glen_words,
                                   const void* win_starts, const void* frag,
                                   const void* frag_lens, int R, int F,
                                   int window, int top_k, int unused,
                                   void* pos, void* val, void* count,
                                   void* stream) {
  // a warp per 128 words (4 a lane an iteration), at most THREADS;
  // each warp's run a multiple of 4 words (the lanes' 16-byte loads)
  const int nwords = (window + 15) / 16;
  const int threads = min(THREADS, (nwords + 127) / 128 * 32);
  const int nwarps = threads / 32;
  const int per = ((nwords + nwarps - 1) / nwarps + 3) & ~3;
  // the words the lanes read: the last iteration of the last run reads up
  // to 128 words past nwarps * per, and 2 for the next words' alignment
  // (33.3 KB at the largest window, 2^17)
  const int nbuf = (nwarps * per + 130 + 3) & ~3;
  exact_sites_kernel<<<R, threads, nbuf * (int)sizeof(uint32_t),
                       (cudaStream_t)stream>>>(
      (const uint32_t*)genome, glen_words, (const long long*)win_starts,
      (const uint8_t*)frag, (const int32_t*)frag_lens, F, window, top_k, per,
      nbuf, (long long*)pos, (int32_t*)count);
  return (int)cudaGetLastError();
}

// K6c: top_k placements by the clean run anchored at the fragment's last
// (suffix != 0) or first base (the fragment is 16 bases)
extern "C" int tt_scan_fragment_runs(const void* genome, long long glen_words,
                                     const void* win_starts, const void* frag,
                                     const void* frag_lens, int R, int F,
                                     int window, int top_k, int suffix,
                                     void* pos, void* val, void* count,
                                     void* stream) {
  auto fn = suffix ? launch<RUNS_SUFFIX, 8> : launch<RUNS_PREFIX, 8>;
  return fn(genome, glen_words, win_starts, frag, frag_lens, R, F, window,
            top_k, pos, val, stream);
}
