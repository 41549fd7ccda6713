// K1: mismatch verification of packed reads against candidate diagonals.
//
// Replaces: tools/pallas_verify_experiment.py:verify_pallas (its body
// make_kernel) and its production twin tpumap/ops/verify.py:
// verify_diagonals, with the genome N-mask window, the
// query_unk/genome_unk flags, the reduced base spaces of the alignment
// modes and the SNP-tolerant ref-OR-alt comparison.
//
// Bound on the H100: latency of small random gathers. Each (read, lane)
// fetches W+1 genome words and W/2+2 N-bitmap words (36 + 24 bytes at
// W=8) from a random place in the genome; the arithmetic is a few dozen
// integer ops per word. The packed genome (11.7 MB at 46.7 Mbp) and its
// N bitmap (5.8 MB) fit in the 50 MB L2, so after warm-up the gathers
// hit L2.
//
// Design: one thread per (read, lane), so many independent gathers are
// in flight per SM to hide their latency; loads go through __ldg (the
// read-only path). Each thread walks the W words itself: shift-align,
// XOR, fold base pairs, apply the N masks and the length mask, __popc.
// Gather indices clamp to the array, as JAX's mode="clip" takes do.
//
// Modes and SNPs: SPACE (0 none, 1-4 ct/ga/ag/tc, ops/mode.py) transforms
// the read word and the genome word inline with one bit trick each; with
// ALT the thread also fetches the same window of the alternate genome,
// transforms it, and a base counts only where both the reference and the
// alt comparison mismatch. (a|m)&(b|m) == (a&b)|m and likewise for &~m,
// so the two folded words are ANDed before the N masks are applied once.
// Both are template parameters: the standard instance <0, false> is the
// kernel of the standard path unchanged.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned long long kInvalid = 0xFFFFFFFFull;
constexpr uint32_t kLowPairs = 0x55555555u;

__device__ __forceinline__ uint32_t ld_clip(const uint32_t* a, long long n,
                                            long long i) {
  return __ldg(a + (i < n ? i : n - 1));
}

__device__ __forceinline__ uint32_t spread16(uint32_t x) {
  x &= 0xFFFFu;
  x = (x | (x << 8)) & 0x00FF00FFu;
  x = (x | (x << 4)) & 0x0F0F0F0Fu;
  x = (x | (x << 2)) & 0x33333333u;
  return (x | (x << 1)) & 0x55555555u;
}

// word pair (w, w+1) of `a` shifted right by s bits (s in [0, 31])
__device__ __forceinline__ uint32_t aligned_word(const uint32_t* a,
                                                 long long n, long long w,
                                                 uint32_t s) {
  uint32_t lo = ld_clip(a, n, w) >> s;
  uint32_t hi = s ? (ld_clip(a, n, w + 1) << (32u - s)) : 0u;
  return lo | hi;
}

template <int SPACE>
__device__ __forceinline__ uint32_t to_space(uint32_t w) {
  if (SPACE == 1) return w | ((w & kLowPairs) << 1);              // ct
  if (SPACE == 2) return w & ~((~w & kLowPairs) << 1);            // ga
  if (SPACE == 3) return w | ((~(w | (w >> 1)) & kLowPairs) << 1);  // ag
  if (SPACE == 4) return w & ~(((w & (w >> 1)) & kLowPairs) << 1);  // tc
  return w;
}

__device__ __forceinline__ uint32_t fold(uint32_t x) {
  return (x | (x >> 1)) & kLowPairs;
}

template <int SPACE, bool ALT>
__global__ void verify_kernel(const uint32_t* __restrict__ genome,
                              long long gwords,
                              const uint32_t* __restrict__ gnmask,
                              long long nwords,
                              const uint32_t* __restrict__ galt,
                              long long awords,
                              const uint32_t* __restrict__ reads,
                              const uint32_t* __restrict__ rnmask,
                              const int32_t* __restrict__ lengths,
                              const long long* __restrict__ diags, int B,
                              int W, int C, int has_n, int query_unk,
                              int genome_unk, int32_t* __restrict__ out) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)B * C) return;
  int b = (int)(t / C);
  int len = lengths[b];
  unsigned long long d = (unsigned long long)diags[t];
  if (d == kInvalid) {
    out[t] = len;
    return;
  }
  uint32_t start = (uint32_t)d;
  long long w0 = start >> 4;
  uint32_t s2 = (start & 15u) << 1;
  long long b0 = start >> 5;
  uint32_t sb = start & 31u;
  const uint32_t* q = reads + (long long)b * W;
  const uint32_t* qn = rnmask + (long long)b * W;
  int count = 0;
  for (int j = 0; j < W; ++j) {
    uint32_t r = to_space<SPACE>(__ldg(q + j));
    uint32_t mm =
        fold(r ^ to_space<SPACE>(aligned_word(genome, gwords, w0 + j, s2)));
    if (ALT)
      mm &= fold(r ^ to_space<SPACE>(aligned_word(galt, awords, w0 + j, s2)));
    uint32_t qm = __ldg(qn + j);
    mm = query_unk ? (mm | qm) : (mm & ~qm);
    if (has_n) {
      uint32_t a = aligned_word(gnmask, nwords, b0 + (j >> 1), sb);
      uint32_t gm = spread16((j & 1) ? (a >> 16) : a);
      mm = genome_unk ? (mm | gm) : (mm & ~gm);
    }
    int nb = len - 16 * j;
    uint32_t lmask = nb >= 16 ? kLowPairs
                     : nb <= 0 ? 0u
                               : (((1u << (2 * nb)) - 1u) & kLowPairs);
    count += __popc(mm & lmask);
  }
  out[t] = count;
}

template <int SPACE, bool ALT>
void launch(const void* genome, long long gwords, const void* gnmask,
            long long nwords, const void* galt, long long awords,
            const void* reads, const void* rnmask, const void* lengths,
            const void* diags, int B, int W, int C, int has_n,
            int query_unk, int genome_unk, void* out, cudaStream_t stream) {
  long long n = (long long)B * C;
  int threads = 256;
  unsigned blocks = (unsigned)((n + threads - 1) / threads);
  verify_kernel<SPACE, ALT><<<blocks, threads, 0, stream>>>(
      (const uint32_t*)genome, gwords, (const uint32_t*)gnmask, nwords,
      (const uint32_t*)galt, awords, (const uint32_t*)reads,
      (const uint32_t*)rnmask, (const int32_t*)lengths,
      (const long long*)diags, B, W, C, has_n, query_unk, genome_unk,
      (int32_t*)out);
}

template <bool ALT>
bool launch_space(int space, const void* genome, long long gwords,
                  const void* gnmask, long long nwords, const void* galt,
                  long long awords, const void* reads, const void* rnmask,
                  const void* lengths, const void* diags, int B, int W,
                  int C, int has_n, int query_unk, int genome_unk, void* out,
                  cudaStream_t stream) {
#define TT_VERIFY_ARGS                                                    \
  genome, gwords, gnmask, nwords, galt, awords, reads, rnmask, lengths, \
      diags, B, W, C, has_n, query_unk, genome_unk, out, stream
  switch (space) {
    case 0: launch<0, ALT>(TT_VERIFY_ARGS); return true;
    case 1: launch<1, ALT>(TT_VERIFY_ARGS); return true;
    case 2: launch<2, ALT>(TT_VERIFY_ARGS); return true;
    case 3: launch<3, ALT>(TT_VERIFY_ARGS); return true;
    case 4: launch<4, ALT>(TT_VERIFY_ARGS); return true;
  }
#undef TT_VERIFY_ARGS
  return false;
}

}  // namespace

// galt may be null (no SNP comparison); space is 0 (standard) or 1-4
// (ct, ga, ag, tc). Returns cudaGetLastError(), or cudaErrorInvalidValue
// for an unknown space.
extern "C" int tt_verify_diagonals(const void* genome, long long gwords,
                                   const void* gnmask, long long nwords,
                                   const void* galt, long long awords,
                                   const void* reads, const void* rnmask,
                                   const void* lengths, const void* diags,
                                   int B, int W, int C, int has_n,
                                   int query_unk, int genome_unk, int space,
                                   void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  bool ok = galt ? launch_space<true>(space, genome, gwords, gnmask, nwords,
                                      galt, awords, reads, rnmask, lengths,
                                      diags, B, W, C, has_n, query_unk,
                                      genome_unk, out, st)
                 : launch_space<false>(space, genome, gwords, gnmask, nwords,
                                       galt, awords, reads, rnmask, lengths,
                                       diags, B, W, C, has_n, query_unk,
                                       genome_unk, out, st);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
