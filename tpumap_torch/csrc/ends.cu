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
// Bound on the H100: latency of dependent random gathers. A k-mer's two
// offsets (a 1.07 GB table at k = 14), then its positions, then for the
// probe two genome words a lane: a few hundred bytes a row, each read a
// 32-byte sector of its own; the selection is a few integer operations
// a lane a round.
//
// Design: one warp per (read, strand), rows strand-major (2B of them).
// The k-mers are rolled in registers from the row's codes: the rc
// strand's from the complement of the read taken backwards, which gives
// the plain version's rc k-mers and positions whenever len >= k (the
// standard rung's revcomp_kmer at rc-position len - k - q is the k-mer
// of the rc read there, and those positions are the fwd positions' set
// again); rows with len < k have no lane. The lanes sit in registers (1
// or 8 a thread: lane i of the flat [end k-mer, occurrence] order at
// thread i % 32, each k-mer's offsets held by thread e and read with a
// shuffle), or past 256 lanes (or 32 end k-mers) in a global scratch of
// the live lanes, one slot a resident warp. The 8 smallest distinct
// lanes come from 8 rounds of "the smallest lane above the last one" (a
// warp min reduction each): no sort, any number of lanes. Lane r of the
// warp keeps the r-th; the probe ranks them by (mismatches, lane) with
// shuffles. Gathers clamp their indices as the plain version's
// mode="clip" takes do.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kInvalid = 0xFFFFFFFFu;
constexpr uint32_t kLowPairs = 0x55555555u;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarps = 4;        // warps a block
constexpr int kProbeInvalid = 999;

struct EndArgs {
  const uint8_t* codes;
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
  uint32_t* scratch;         // [nslots, NE * occ] (per == 0)
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

// a k-mer's table range: its first position and live lanes (count if
// count <= occ, else 0), the read at its position q
__device__ __forceinline__ void end_kmer(const EndArgs& a, int s,
                                         const uint8_t* c, int len, int e,
                                         uint32_t* start, int* n,
                                         uint32_t* q) {
  int qp = end_qpos(e, a.iv, len - a.k);
  uint32_t o = 0;
  for (int j = 0; j < a.k; ++j) {
    int p = s ? len - 1 - (qp + j) : qp + j;
    p = p < 0 ? 0 : (p > a.L - 1 ? a.L - 1 : p);   // in the row
    uint32_t code = s ? 3u - c[p] : c[p];
    o = (o << 2) | ((a.lut[s] >> (2 * (code & 3u))) & 3u);
  }
  uint32_t st = ld_clip(a.offs[s], a.noff[s], (long long)o);
  long long cnt =
      (long long)ld_clip(a.offs[s], a.noff[s], (long long)o + 1) - st;
  *start = st;
  *n = (cnt > 0 && cnt <= a.occ) ? (int)cnt : 0;
  *q = (uint32_t)qp;
}

__device__ __forceinline__ uint32_t lane_diag(const EndArgs& a, int s,
                                              uint32_t start, int l,
                                              uint32_t q) {
  uint32_t p = ld_clip(a.pos[s], a.npos[s], (long long)start + l);
  return p >= q ? p - q : kInvalid;
}

template <int PER>
__global__ void __launch_bounds__(32 * kWarps)
    end_lanes_kernel(EndArgs a, long long* __restrict__ out) {
  int lane = threadIdx.x & 31;
  long long nwarps = (long long)gridDim.x * kWarps;
  long long gw = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  int NE = 2 * a.iv;
  int N = NE * a.occ;
  for (long long row = gw; row < 2LL * a.B; row += nwarps) {
    int s = row >= a.B;
    int b = (int)(s ? row - a.B : row);
    int len = a.lengths[b];
    bool ok = len >= a.k;
    const uint8_t* c = a.codes + (long long)b * a.L;
    uint32_t v[PER > 0 ? PER : 1];
    int tot = 0;
    uint32_t* sc = a.scratch + (PER > 0 ? 0 : gw * (long long)N);
    if (PER > 0) {
      // thread e holds end k-mer e's range; lane i = p * 32 + thread
      uint32_t my_start = 0, my_q = 0;
      int my_n = 0;
      if (ok && lane < NE) end_kmer(a, s, c, len, lane, &my_start, &my_n,
                                    &my_q);
#pragma unroll
      for (int p = 0; p < (PER > 0 ? PER : 1); ++p) {
        int i = p * 32 + lane;
        int e = i / a.occ;
        int l = i - e * a.occ;
        int src = e < 32 ? e : 0;
        uint32_t st = __shfl_sync(kFull, my_start, src);
        int n = __shfl_sync(kFull, my_n, src);
        uint32_t q = __shfl_sync(kFull, my_q, src);
        v[p] = (i < N && l < n) ? lane_diag(a, s, st, l, q) : kInvalid;
      }
    } else if (ok) {
      // the live lanes of each k-mer in turn, packed into the scratch
      for (int e = 0; e < NE; ++e) {
        uint32_t st, q;
        int n;
        end_kmer(a, s, c, len, e, &st, &n, &q);
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
      if (PER > 0) {
#pragma unroll
        for (int p = 0; p < (PER > 0 ? PER : 1); ++p)
          if (v[p] >= lo && v[p] < m) m = v[p];
      } else {
        for (int i = lane; i < tot; i += 32) {
          uint32_t x = sc[i];
          if (x >= lo && x < m) m = x;
        }
      }
      m = __reduce_min_sync(kFull, m);
      if (lane == r) mine = m;
      if (m == kInvalid) break;
      lo = m + 1;
    }
    if (PER == 0) __syncwarp();     // the scratch slot is reused
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

}  // namespace

// codes uint8[B, L]; lengths int32[B]; the fwd and rc strands' offsets
// and positions (int32 bit patterns, n entries each); the reference
// genome words (the probe) and packed2 int32[2B, W] (standard mode;
// null and keep 0 in a mode); iv the index interval (2 iv end k-mers),
// occ max_occ, K = min(8, 2 iv occ) lanes kept, keep the probe's (0: no
// probe); lut_f, lut_r each strand's code map; per the lanes a thread
// holds (1, 8; 0: scratch, int32[nslots, 2 iv occ], nslots a multiple
// of 4: one slot a launched warp).
// out int64[2B, keep] (standard) or [2, B, K] (a mode).
// Returns cudaGetLastError(), or cudaErrorInvalidValue for an unknown
// per or a missing scratch.
extern "C" int tt_end_lanes(const void* codes, const void* lengths,
                            const void* offs_f, long long noff_f,
                            const void* pos_f, long long npos_f,
                            const void* offs_r, long long noff_r,
                            const void* pos_r, long long npos_r,
                            const void* genome, long long gwords,
                            const void* packed2, int W, int B, int L, int k,
                            int iv, int occ, int K, int keep, int lut_f,
                            int lut_r, int per, void* scratch, int nslots,
                            void* out, void* stream) {
  EndArgs a;
  a.codes = (const uint8_t*)codes;
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
  if (occ < 1 || iv < 1 || (keep && !packed2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned blocks = (unsigned)((2LL * B + kWarps - 1) / kWarps);
  if (per == 0) {
    // one scratch slot a launched warp: whole blocks of nslots warps
    if (!scratch || nslots < kWarps || nslots % kWarps)
      return (int)cudaErrorInvalidValue;
    blocks = (unsigned)(nslots / kWarps);
  }
  long long* o = (long long*)out;
  switch (per) {
    case 0: end_lanes_kernel<0><<<blocks, 32 * kWarps, 0, st>>>(a, o); break;
    case 1: end_lanes_kernel<1><<<blocks, 32 * kWarps, 0, st>>>(a, o); break;
    case 8: end_lanes_kernel<8><<<blocks, 32 * kWarps, 0, st>>>(a, o); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
