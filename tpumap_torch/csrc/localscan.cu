// K6a-c: the window scans of the RNA path's salvage and ambiguous-end
// review, three entry points on one device routine.
//
// Replaces: tpumap/ops/localscan.py: _phase_mismatch_counts (34-65) with
// scan_fragment (68-115, K6a), scan_exact_sites (118-145, K6b) and
// scan_fragment_runs (148-225, K6c): a fragment of <= 16 bases compared
// with every offset of a row's genome window (65,536 bp on the path) as
// 16 shift phases of an XOR/popcount stream over the window's packed
// words, then an exact top-k.
//
// Bound on the H100: integer ALU. A row is 4,097 words x 16 phases of
// ~10 operations, and the window itself is 16.4 KB read once. tpumap's
// form (and the plain version) writes [R, 4097, 16] intermediates to
// memory, 1.07 GB at R = 2,048; this kernel writes only the top k.
//
// Design: one block of 256 threads per row. The block loads the row's
// 4,099 raw window words into shared memory, fetched as tpumap fetches
// them (one dynamic slice whose start is clamped to len - size), and
// each thread takes whole words: it aligns two neighbouring words from
// shared memory and scores all 16 phases of each, in increasing offset
// order. Every offset gets a unique 32-bit key (score << 17 | offset),
// so tpumap's iterated block minima equal an exact k-smallest: each
// thread keeps its 8 smallest keys in registers (a compare-exchange
// insertion), then the block pops the global minimum k times with warp
// reductions. Exact-site hits are also counted with a block reduction.
// Rows of the exact-site scan with no fragment (length <= 0) return at
// once with no hits, as tpumap's masked hits give.
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

enum Mode { FRAG = 0, EXACT = 1, RUNS_SUFFIX = 2, RUNS_PREFIX = 3 };

__global__ void __launch_bounds__(THREADS) localscan_kernel(
    const uint32_t* __restrict__ genome, long long glen_words,
    const long long* __restrict__ win_starts,
    const uint8_t* __restrict__ frag, const int32_t* __restrict__ frag_lens,
    int F, int window, int top_k, int mode, long long* __restrict__ out_pos,
    int32_t* __restrict__ out_val, int32_t* __restrict__ out_count) {
  extern __shared__ uint32_t raw[];
  __shared__ uint32_t red[WARPS];
  __shared__ uint32_t pick;
  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const uint32_t ws = (uint32_t)win_starts[r];
  const int flen_raw = frag_lens[r];
  long long* pos = out_pos + (long long)r * top_k;
  int32_t* val = out_val + (long long)r * top_k;
  if (mode == EXACT && flen_raw <= 0) {
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
  const uint32_t fm = flen >= 16 ? 0xFFFFFFFFu : ((1u << (2 * flen)) - 1u);
  __syncthreads();

  uint32_t top[MAXK];
#pragma unroll
  for (int i = 0; i < MAXK; ++i) top[i] = NONE;
  int hits = 0;
  for (int j = tid; j < nw; j += THREADS) {
    const uint32_t a = raw[j], b = raw[j + 1], c = raw[j + 2];
    const uint32_t lo = s2 ? (a >> s2) | (b << (32 - s2)) : a;
    const uint32_t hi = s2 ? (b >> s2) | (c << (32 - s2)) : b;
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      const int o = 16 * j + p;
      if (o >= window) break;
      const uint32_t stream = p ? (lo >> (2 * p)) | (hi << (32 - 2 * p)) : lo;
      const uint32_t x = stream ^ fw;
      const uint32_t mm2 = (x | (x >> 1)) & LOW;
      uint32_t key;
      if (mode == FRAG) {
        key = ((uint32_t)__popc(mm2 & fm) << OFF_BITS) | (uint32_t)o;
      } else if (mode == EXACT) {
        if (__popc(mm2 & fm)) continue;
        ++hits;
        key = (uint32_t)o;
      } else {
        // smear each mismatch towards the anchored end; the clean run
        // is what stays clear
        uint32_t y = mm2;
        if (mode == RUNS_SUFFIX) {
          y |= y >> 2; y |= y >> 4; y |= y >> 8; y |= y >> 16;
        } else {
          y |= y << 2; y |= y << 4; y |= y << 8; y |= y << 16;
        }
        const int run = __popc(~y & LOW);
        key = ((uint32_t)(16 - run) << OFF_BITS) | (uint32_t)o;
      }
      if (key < top[MAXK - 1]) {
#pragma unroll
        for (int i = 0; i < MAXK; ++i) {   // keep the smaller, carry on
          const uint32_t t = top[i];
          top[i] = min(t, key);
          key = max(t, key);
        }
      }
    }
  }

  if (mode == EXACT) {
    int h = __reduce_add_sync(0xFFFFFFFFu, hits);
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
    const uint32_t wmin = __reduce_min_sync(0xFFFFFFFFu, h);
    if ((tid & 31) == 0) red[tid >> 5] = wmin;
    __syncthreads();
    if (tid < 32) {
      const uint32_t v = __reduce_min_sync(
          0xFFFFFFFFu, tid < WARPS ? red[tid] : NONE);
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
      if (mode == EXACT) {
        pos[t] = m == NONE ? (long long)NONE : (long long)(uint32_t)(ws + m);
        val[t] = 0;
      } else {
        pos[t] = (long long)(uint32_t)(ws + off);
        val[t] = mode == FRAG ? (int)(m >> OFF_BITS)
                              : 16 - (int)(m >> OFF_BITS);
      }
    }
  }
}

int launch(const void* genome, long long glen_words, const void* win_starts,
           const void* frag, const void* frag_lens, int R, int F, int window,
           int top_k, int mode, void* pos, void* val, void* count,
           void* stream) {
  const int nraw = window / 16 + 3;
  localscan_kernel<<<R, THREADS, nraw * sizeof(uint32_t),
                     (cudaStream_t)stream>>>(
      (const uint32_t*)genome, glen_words, (const long long*)win_starts,
      (const uint8_t*)frag, (const int32_t*)frag_lens, F, window, top_k, mode,
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
  return launch(genome, glen_words, win_starts, frag, frag_lens, R, F, window,
                top_k, FRAG, pos, val, count, stream);
}

// K6b: exact placements, counted, the top_k smallest offsets kept
extern "C" int tt_scan_exact_sites(const void* genome, long long glen_words,
                                   const void* win_starts, const void* frag,
                                   const void* frag_lens, int R, int F,
                                   int window, int top_k, int unused,
                                   void* pos, void* val, void* count,
                                   void* stream) {
  return launch(genome, glen_words, win_starts, frag, frag_lens, R, F, window,
                top_k, EXACT, pos, val, count, stream);
}

// K6c: top_k placements by the clean run anchored at the fragment's last
// (suffix != 0) or first base
extern "C" int tt_scan_fragment_runs(const void* genome, long long glen_words,
                                     const void* win_starts, const void* frag,
                                     const void* frag_lens, int R, int F,
                                     int window, int top_k, int suffix,
                                     void* pos, void* val, void* count,
                                     void* stream) {
  return launch(genome, glen_words, win_starts, frag, frag_lens, R, F, window,
                top_k, suffix ? RUNS_SUFFIX : RUNS_PREFIX, pos, val, count,
                stream);
}
