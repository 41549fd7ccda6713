// K6a-c: the window scans of the RNA path's salvage and ambiguous-end
// review, one kernel template with an instance per scan.
//
// Replaces: tpumap/ops/localscan.py: _phase_mismatch_counts (34-65) with
// scan_fragment (68-115, K6a), scan_exact_sites (118-145, K6b) and
// scan_fragment_runs (148-225, K6c): a fragment of <= 16 bases compared
// with every offset of a row's genome window (65,536 bp on the path) as
// 16 shift phases of an XOR/popcount stream over the window's packed
// words, then an exact top-k.
//
// Bound on the H100: integer ALU. A row is 4,097 words x 16 phases, and
// the window itself is 16.4 KB read once. tpumap's form (and the plain
// version) writes [R, 4097, 16] intermediates to memory, 1.07 GB at
// R = 2,048; this kernel writes only the top k. So the time is the
// instructions spent a window offset, against the ~6 the bound counts:
// the per-offset score, the compare with the kept keys, and the 16-op
// insertion, which a warp runs whenever any of its lanes inserts.
//
// Design: one block of 256 threads per row, one instance per scan (MODE
// a template parameter). The block loads the row's 4,099 raw window
// words into shared memory, fetched as tpumap fetches them (one dynamic
// slice whose start is clamped to len - size). Each thread takes whole
// words: it aligns two neighbouring words with __funnelshift_r and
// scores all 16 phases of each, one funnel shift a phase, with no bound
// check; the one partial word at the window's end has its phases
// guarded. Every offset gets a unique 32-bit key (score << 17 | offset),
// so tpumap's iterated block minima equal an exact k-smallest: each
// thread keeps its 8 smallest keys in registers (a compare-exchange
// insertion), then the block pops the global minimum k times with warp
// reductions.
//
// K6a (score: mismatches, popc(mm2 & fm)) and K6b (exact placements,
// counted, the key the offset) keep that arithmetic; a word goes to the
// insertion only if its least key is under the warp's bar, the smallest
// 8th key of the warp's lanes (one __reduce_min_sync a word): a key above
// it has 8 smaller keys in that lane, so it is in no top 8.
//
// K6c (score 32 - __clz(mm2), suffix, or 32 - __clz(__brev(mm2)),
// prefix, which orders as 16 - run: mm2 has one bit per mismatching base
// on the even bits, so the run anchored at the last base is
// __clz(mm2) >> 1 and at the first __clz(__brev(mm2)) >> 1, 16 for mm2
// == 0, equal to the plain version's smear popc(~y & LOW) for all 2^16
// patterns) runs two passes, because a lane's own 8th key is a loose bar
// (run 2-3 of its 256 offsets, where the row's 8th is ~6), which lets
// most words into the insertion. The run ends at the highest (suffix)
// or lowest (prefix) set bit of x = stream ^ fw, so x, or
// ~(x ^ (x - 1)), is a proxy that orders with it at no bit scan.
// Pass 1 keeps each word's least proxy in shared memory (3 or 5
// instructions an offset); the threads' least proxies give a block bar,
// the least score that top_k of them reach (runs_scan); pass 2 scores
// exactly, and inserts, only the phases of the ~16 of 4,096 words whose
// least proxy can reach it. Rows of the exact-site scan with no fragment
// (length <= 0) return at once with no hits, as tpumap's masked hits
// give; K6c's fragment is always 16 bases and it reads no lengths.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAXK = 8;
constexpr int OFF_BITS = 17;
constexpr int SAFE_PAD_WORDS = 4352;   // tpumap/ops/verify.py
constexpr uint32_t LOW = 0x55555555u;
constexpr uint32_t NONE = 0xFFFFFFFFu;
constexpr unsigned FULL = 0xFFFFFFFFu;

constexpr int FRAG = 0, EXACT = 1, RUNS_SUFFIX = 2, RUNS_PREFIX = 3;

// the key of window offset o from its genome stream word (fragment base
// j against genome base o + j at bits 2j, 2j + 1); NONE for no key
template <int MODE>
__device__ __forceinline__ uint32_t offset_key(uint32_t stream, uint32_t fw,
                                               uint32_t lowfm, uint32_t o) {
  const uint32_t x = stream ^ fw;
  if (MODE == FRAG)
    return ((uint32_t)__popc((x | (x >> 1)) & lowfm) << OFF_BITS) | o;
  if (MODE == EXACT)
    return ((x | (x >> 1)) & lowfm) ? NONE : o;
  const uint32_t mm2 = (x | (x >> 1)) & LOW;
  const uint32_t lead =
      MODE == RUNS_SUFFIX ? __clz(mm2) : __clz(__brev(mm2));
  return ((32u - lead) << OFF_BITS) | o;
}

// K6c's proxies. The run of the key from x = stream ^ fw ends at x's
// highest set bit (suffix) or lowest (prefix), so a proxy that orders
// with the run costs no bit scan: x itself, or ~(x ^ (x - 1)) (both 0
// for the clean run of 16).
template <int MODE>
__device__ __forceinline__ uint32_t runs_proxy(uint32_t x) {
  return MODE == RUNS_SUFFIX ? x : ~(x ^ (x - 1u));
}

// The largest proxy whose key can score S or less (score = 32 - the bit
// scan of offset_key; S >= 31 bounds nothing)
template <int MODE>
__device__ __forceinline__ uint32_t runs_bar(int S) {
  if (S <= 0) return 0u;                  // only the clean run
  if (S >= 31) return 0xFFFFFFFFu;
  if (MODE == RUNS_SUFFIX)                // the highest set bit <= S
    return (2u << S) - 1u;
  // the lowest set bit >= a0, the even bound of 32 - S
  const int a0 = (33 - S) & ~1;
  return a0 >= 32 ? 0u : 0u - (2u << a0);
}

// keep the 8 smallest keys in top[] (ascending)
__device__ __forceinline__ void insert(uint32_t (&top)[MAXK], uint32_t key) {
#pragma unroll
  for (int i = 0; i < MAXK; ++i) {     // keep the smaller, carry on
    const uint32_t t = top[i];
    top[i] = min(t, key);
    key = max(t, key);
  }
}

// The score that a K6c proxy guarantees: some offset of the thread has a
// key of this score or less (prefix: proxy 0 is x == 0, score 0, or a
// lowest set bit 31, score 2: say 2)
template <int MODE>
__device__ __forceinline__ int runs_score(uint32_t proxy) {
  if (MODE == RUNS_SUFFIX)
    return (int)(offset_key<MODE>(proxy, 0u, 0u, 0u) >> OFF_BITS);
  if (proxy == 0u) return 2;
  const int a = 31 - __clz(~proxy);      // the lowest set bit of x
  return 32 - 2 * (a >> 1);
}

// K6c's scan of a row (all threads of the block): pass 1 takes each
// word's least proxy (into least[], shared) and each thread's least over
// its words; the thread minima give the bar, the least score S that at
// least top_k of them reach (top_k distinct offsets score S or less, so
// a key of a higher score is in no top k); pass 2 scores exactly, and
// inserts, only the phases of the words whose least proxy can reach S.
template <int MODE>
__device__ __forceinline__ void runs_scan(const uint32_t* raw,
                                          uint32_t* least, uint32_t s2,
                                          uint32_t fw, int nfull, int rem,
                                          int top_k, uint32_t (&top)[MAXK]) {
  __shared__ int hist[32];               // threads by their least's score
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid < 32) hist[tid] = 0;
  const int nwords = nfull + (rem ? 1 : 0);
  uint32_t mine = 0xFFFFFFFFu;
  bool any = false;
  for (int j = tid; j < nwords; j += THREADS) {
    const uint32_t lo = __funnelshift_r(raw[j], raw[j + 1], s2);
    const uint32_t hi = __funnelshift_r(raw[j + 1], raw[j + 2], s2);
    uint32_t m = 0xFFFFFFFFu;
    if (j < nfull) {
#pragma unroll
      for (int p = 0; p < 16; ++p)
        m = min(m, runs_proxy<MODE>(__funnelshift_r(lo, hi, 2 * p) ^ fw));
    } else {
#pragma unroll
      for (int p = 0; p < 16; ++p)
        if (p < rem)
          m = min(m, runs_proxy<MODE>(__funnelshift_r(lo, hi, 2 * p) ^ fw));
    }
    least[j] = m;
    mine = min(mine, m);
    any = true;
  }
  __syncthreads();                       // hist zeroed, least[] written
  if (any) atomicAdd(&hist[min(runs_score<MODE>(mine), 31)], 1);
  __syncthreads();
  // the first score whose running count reaches top_k; none below 31
  // (scores 31 and 32 bound nothing) leaves the bar open
  int cum = hist[lane];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(FULL, cum, off);
    if (lane >= off) cum += v;
  }
  const unsigned reach = __ballot_sync(FULL, cum >= top_k) & 0x7FFFFFFFu;
  const int S = reach ? __ffs(reach) - 1 : -1;
  uint32_t bar = S < 0 ? NONE : (uint32_t)(S + 1) << OFF_BITS;
  const uint32_t thr = S < 0 ? 0xFFFFFFFFu : runs_bar<MODE>(S);
  for (int j = tid; j < nwords; j += THREADS) {
    if (least[j] > thr) continue;
    const uint32_t lo = __funnelshift_r(raw[j], raw[j + 1], s2);
    const uint32_t hi = __funnelshift_r(raw[j + 1], raw[j + 2], s2);
    const int np = j < nfull ? 16 : rem;
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      const uint32_t x = __funnelshift_r(lo, hi, 2 * p) ^ fw;
      if (p >= np || runs_proxy<MODE>(x) > thr) continue;
      const uint32_t key = offset_key<MODE>(x, 0u, 0u, 16 * j + p);
      if (key < bar) {
        insert(top, key);
        bar = min(bar, top[MAXK - 1]);
      }
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(THREADS) localscan_kernel(
    const uint32_t* __restrict__ genome, long long glen_words,
    const long long* __restrict__ win_starts,
    const uint8_t* __restrict__ frag, const int32_t* __restrict__ frag_lens,
    int F, int window, int top_k, long long* __restrict__ out_pos,
    int32_t* __restrict__ out_val, int32_t* __restrict__ out_count) {
  constexpr bool RUNS = MODE == RUNS_SUFFIX || MODE == RUNS_PREFIX;
  extern __shared__ uint32_t raw[];
  __shared__ uint32_t red[WARPS];
  __shared__ uint32_t pick;
  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const uint32_t ws = (uint32_t)win_starts[r];
  const int flen_raw = RUNS ? 16 : frag_lens[r];
  long long* pos = out_pos + (long long)r * top_k;
  int32_t* val = out_val + (long long)r * top_k;
  if (MODE == EXACT && flen_raw <= 0) {
    if (tid < top_k) {
      pos[tid] = (long long)NONE;
      val[tid] = 0;
    }
    if (tid == 0) out_count[r] = 0;
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
  for (int i = tid; i < nraw; i += THREADS) {
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
  const int flen = min(max(flen_raw, 0), F);
  const uint32_t lowfm =
      LOW & (flen >= 16 ? 0xFFFFFFFFu : ((1u << (2 * flen)) - 1u));
  __syncthreads();

  uint32_t top[MAXK];
#pragma unroll
  for (int i = 0; i < MAXK; ++i) top[i] = NONE;
  int hits = 0;
  const int nfull = window / 16;         // words with all 16 phases
  const int rem = window - 16 * nfull;   // phases of the partial word
  if (RUNS) {
    runs_scan<MODE>(raw, raw + nraw, s2, fw, nfull, rem, top_k, top);
  } else {
    // the loop runs alike on the lanes of a warp, so the bar is a
    // full-warp reduction
    for (int jb = tid & ~31; jb < nfull; jb += THREADS) {
      const int j = jb + (tid & 31);
      uint32_t bar = __reduce_min_sync(FULL, top[MAXK - 1]);
      if (j >= nfull) continue;
      const uint32_t lo = __funnelshift_r(raw[j], raw[j + 1], s2);
      const uint32_t hi = __funnelshift_r(raw[j + 1], raw[j + 2], s2);
      uint32_t key[16];
      uint32_t least = NONE;
#pragma unroll
      for (int p = 0; p < 16; ++p) {
        key[p] = offset_key<MODE>(__funnelshift_r(lo, hi, 2 * p), fw, lowfm,
                                  16 * j + p);
        least = min(least, key[p]);
        if (MODE == EXACT) hits += key[p] != NONE;
      }
      if (least < bar) {
#pragma unroll
        for (int p = 0; p < 16; ++p)
          if (key[p] < bar) {
            insert(top, key[p]);
            bar = min(bar, top[MAXK - 1]);
          }
      }
    }
    // the partial word at the window's end, phases guarded
    if (rem && tid == nfull % THREADS) {
      const int j = nfull;
      const uint32_t lo = __funnelshift_r(raw[j], raw[j + 1], s2);
      const uint32_t hi = __funnelshift_r(raw[j + 1], raw[j + 2], s2);
#pragma unroll
      for (int p = 0; p < 16; ++p) {
        if (p >= rem) break;
        const uint32_t key = offset_key<MODE>(
            __funnelshift_r(lo, hi, 2 * p), fw, lowfm, 16 * j + p);
        if (MODE == EXACT) hits += key != NONE;
        if (key < top[MAXK - 1]) insert(top, key);
      }
    }
  }

  if (MODE == EXACT) {
    int h = __reduce_add_sync(FULL, hits);
    if ((tid & 31) == 0) red[tid >> 5] = (uint32_t)h;
    __syncthreads();
    if (tid == 0) {
      int total = 0;
      for (int w = 0; w < WARPS; ++w) total += (int)red[w];
      out_count[r] = total;
    }
    __syncthreads();
  }

  // exact block-wide k smallest: pop the minimum head k times (keys are
  // unique, so exactly one thread owns each popped key)
  for (int t = 0; t < top_k; ++t) {
    const uint32_t h = top[0];
    const uint32_t wmin = __reduce_min_sync(FULL, h);
    if ((tid & 31) == 0) red[tid >> 5] = wmin;
    __syncthreads();
    if (tid < 32) {
      const uint32_t v = __reduce_min_sync(FULL, tid < WARPS ? red[tid] : NONE);
      if (tid == 0) pick = v;
    }
    __syncthreads();
    const uint32_t m = pick;
    if (h == m && m != NONE) {
#pragma unroll
      for (int i = 0; i < MAXK - 1; ++i) top[i] = top[i + 1];
      top[MAXK - 1] = NONE;
    }
    if (tid == 0) {
      const uint32_t off = m & ((1u << OFF_BITS) - 1u);
      if (MODE == EXACT) {
        pos[t] = m == NONE ? (long long)NONE : (long long)(uint32_t)(ws + m);
        val[t] = 0;
      } else {
        pos[t] = (long long)(uint32_t)(ws + off);
        // K6c's run: (32 - score) >> 1
        val[t] = RUNS ? (int)(32u - (m >> OFF_BITS)) >> 1
                      : (int)(m >> OFF_BITS);
      }
    }
  }
}

template <int MODE>
int launch(const void* genome, long long glen_words, const void* win_starts,
           const void* frag, const void* frag_lens, int R, int F, int window,
           int top_k, void* pos, void* val, void* count, void* stream) {
  // the raw window words; K6c adds each word's least proxy (64 KiB at
  // the largest window, 2^17)
  const int nraw = window / 16 + 3;
  const int bytes = (MODE >= RUNS_SUFFIX ? 2 : 1) * nraw * sizeof(uint32_t);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        localscan_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return (int)err;
  }
  localscan_kernel<MODE><<<R, THREADS, bytes, (cudaStream_t)stream>>>(
      (const uint32_t*)genome, glen_words, (const long long*)win_starts,
      (const uint8_t*)frag, (const int32_t*)frag_lens, F, window, top_k,
      (long long*)pos, (int32_t*)val, (int32_t*)count);
  return (int)cudaGetLastError();
}

}  // namespace

// K6a: top_k lowest-mismatch placements of each row's fragment
extern "C" int tt_scan_fragment(const void* genome, long long glen_words,
                                const void* win_starts, const void* frag,
                                const void* frag_lens, int R, int F,
                                int window, int top_k, int unused, void* pos,
                                void* val, void* count, void* stream) {
  return launch<FRAG>(genome, glen_words, win_starts, frag, frag_lens, R, F,
                      window, top_k, pos, val, count, stream);
}

// K6b: exact placements, counted, the top_k smallest offsets kept
extern "C" int tt_scan_exact_sites(const void* genome, long long glen_words,
                                   const void* win_starts, const void* frag,
                                   const void* frag_lens, int R, int F,
                                   int window, int top_k, int unused,
                                   void* pos, void* val, void* count,
                                   void* stream) {
  return launch<EXACT>(genome, glen_words, win_starts, frag, frag_lens, R, F,
                       window, top_k, pos, val, count, stream);
}

// K6c: top_k placements by the clean run anchored at the fragment's last
// (suffix != 0) or first base; frag_lens and count are not read or
// written (the fragment is 16 bases)
extern "C" int tt_scan_fragment_runs(const void* genome, long long glen_words,
                                     const void* win_starts, const void* frag,
                                     const void* frag_lens, int R, int F,
                                     int window, int top_k, int suffix,
                                     void* pos, void* val, void* count,
                                     void* stream) {
  auto fn = suffix ? launch<RUNS_SUFFIX> : launch<RUNS_PREFIX>;
  return fn(genome, glen_words, win_starts, frag, frag_lens, R, F, window,
            top_k, pos, val, count, stream);
}
