// K5: the chain DP of the RNA path and its traceback.
//
// Replaces: tpumap/ops/pathdp.py:110 chain_solve, lines 217-411: the
// forward lax.scan (:324) over query positions (per step [R, K', K]
// transition math: extend, open, or jump through a deletion, a scored
// intron or an insertion with its exact rolling-window correction), the
// reverse scan (:380) that walks the choices back to segments, the
// segment flip and the mismatch count on the path. The inputs come from
// the plain-torch prologue tpumap_torch/ops/pathdp.py:chain_inputs
// (pathdp.py:137-215).
//
// Bound on the H100: each row is a chain of L dependent steps of K*K
// integer transitions, so the work is integer-ALU bound (the inputs,
// ~14 bytes per (row, lane, step), are read once).
//
// Design: T = G * SPLIT threads per row (G = 8 candidate lanes with
// SPLIT = 4 threads per candidate, one row a warp; or G = 16 with one
// thread per candidate, two rows a warp), so R = 8,192 rows fill 8,192
// or 4,096 warps, and at R = 2,048 a row's step is short. Thread
// (k, part) keeps candidate k's diagonal, H[k] and a running sum C of
// its per-base scores (every part alike), and the junction geometry of
// the jumps k' -> k for its slice of G / SPLIT k' (type and cost),
// computed once per row. It reads k's [R, K, L] inputs as they are (no
// transposed copies), 4 steps a load (int4 and 32-bit loads) where L and
// the pointers allow, one load ahead. Each step it takes H[k'] and k''s
// donor and known bits from the thread of k' by __shfl_sync and loops
// over its k' in index order; the parts' best jumps meet in a group
// reduction to the largest jump and, among equals, the first k', so the
// first k' of the best jump wins as in tpumap. The insertion correction
// sum_{j<n} s[k'][q-1-j] is C_k'(q) - C_k'(q-n), read from a 16-deep
// ring of each candidate's C in shared memory. The row maximum (first k
// of the maximum) is a group reduction of the pairs (H, k); the latest
// q among equal row maxima is the scalar rule. Each step's choice (and
// the mismatch bit of its base) goes to a per-row [L, G] byte table,
// which the reverse walk (one thread per row) reads back. Ties follow
// tpumap exactly: extend before open before jump, the first k' of the
// best jump, the first k of the row maximum, the latest end among equal
// row maxima. Gaps are uint32 wrap arithmetic.
//
// Where the table lives (GTAB): in shared memory beside the ring, the
// diagonals and the segments while a block of one warp holds its rows'
// tables there (L <= pathdp.chain_max_len(K): 28,984 steps at 8 lanes,
// 7,194 at 16, which covers every read bucket up to 7,168 bases); past
// that in a global [R, L, G] byte scratch that the wrapper allocates, so
// a row of any length runs. Only the table moves: the ring, diagonals
// and segments stay in shared memory, and the global instance writes
// G bytes a step per row (coalesced within a row) and walks them back
// with one dependent load a step.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int S = 8;        // segments kept per row
constexpr int RING = 16;    // depth of the running-sum ring (> max_insert)
constexpr int NEG = -(1 << 20);
constexpr uint32_t INVALID = 0xFFFFFFFFu;
constexpr int WARPS = 4;    // warps per block at most
// threads per candidate of the 8- and 16-lane instances (two threads
// per candidate ran slower at 16 lanes on the H100)
constexpr int SPLIT8 = 4, SPLIT16 = 1;
// dinucleotide codes (a=0 c=1 g=2 t=3, hi*4+lo)
constexpr int GT = 11, AG = 2, GC = 9, AT = 3, CT = 7, AC = 1;
// jump types of the per-row geometry
constexpr int T_NONE = 0, T_INTRON = 1, T_DEL = 2, T_INS = 3;

struct Scoring {
  int del_open, del_extend, splice_base, b_gtag, b_gcag, b_atac, b_known;
  uint32_t min_intron, max_intron;
  int ins_open, ins_extend, max_insert, allow_noncanon;
};

// Shared memory of one row: the choice table (unless it is global), the
// running-sum ring, the diagonals and the reversed segments.
template <int G, bool GTAB>
struct RowSmem {
  static constexpr int ring_bytes = RING * G * 4;
  static __host__ __device__ int table_bytes(int L) {
    return GTAB ? 0 : ((L * G + 15) / 16) * 16;
  }
  static __host__ __device__ int bytes(int L) {
    return table_bytes(L) + ring_bytes + G * 4 + S * 4;
  }
};

// The two donor dinucleotides that earn a canonical bonus with acceptor
// dinucleotide aj, and their bonuses (tpumap's max of the sense and the
// antisense pair: for one (dj, aj) at most one of the six pairs holds).
__device__ __forceinline__ void donor_partners(int aj, const Scoring& sc,
                                               int& da, int& ba, int& db,
                                               int& bb) {
  da = db = -1;
  ba = bb = 0;
  if (aj == AG) {
    da = GT; ba = max(sc.b_gtag, 0);
    db = GC; bb = max(sc.b_gcag, 0);
  } else if (aj == AC) {
    da = AT; ba = max(sc.b_atac, 0);
    db = CT; bb = max(sc.b_gtag, 0);
  } else if (aj == GC) {
    da = CT; ba = max(sc.b_gcag, 0);
  } else if (aj == AT) {
    da = GT; ba = max(sc.b_atac, 0);
  }
}

// (v, i) <- (ov, oi) if that is larger, or equal with a smaller index:
// one step of a group reduction to the first index of the maximum
__device__ __forceinline__ void take_first_max(int& v, int& i, int ov,
                                               int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

template <int G, int SPLIT, bool GTAB>
__global__ void __launch_bounds__(WARPS * 32) chain_kernel(
    const long long* __restrict__ diags, const int32_t* __restrict__ s,
    const int32_t* __restrict__ don, const int32_t* __restrict__ acc,
    const uint8_t* __restrict__ mm, const uint8_t* __restrict__ known,
    const int32_t* __restrict__ lengths, int R, int K, int L, bool vec,
    Scoring sc, uint8_t* __restrict__ gtab,
    int32_t* __restrict__ out_score, int32_t* __restrict__ out_qstart,
    int32_t* __restrict__ out_qend, int32_t* __restrict__ out_nsegs,
    int32_t* __restrict__ out_segq, long long* __restrict__ out_segd,
    int32_t* __restrict__ out_nmm) {
  constexpr int T = G * SPLIT;                     // threads per row
  constexpr int P = G / SPLIT;                     // k' per thread
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x % T;
  const int k = t % G;                             // candidate
  const int part = t / G;                          // k' in [part*P, +P)
  const bool lead = part == 0;                     // writes the row's smem
  const int slot = threadIdx.x / T;                // row within the block
  const int r = blockIdx.x * (blockDim.x / T) + slot;
  if (r >= R) return;                              // whole groups leave
  const unsigned gmask = T == 32 ? 0xFFFFFFFFu
      : ((1u << (T % 32)) - 1u) << (threadIdx.x % 32 / T * T);
  using Row = RowSmem<G, GTAB>;
  unsigned char* base = smem + slot * Row::bytes(L);
  uint8_t* ch = GTAB ? gtab + (long long)r * L * G : base;  // [L][G]
  int32_t* ring = (int32_t*)(base + Row::table_bytes(L));   // [RING][G]
  uint32_t* dsm = (uint32_t*)(ring + RING * G);            // [G]
  int32_t* segs = (int32_t*)(dsm + G);                     // [S]

  const bool has_known = known != nullptr;
  const bool mine = k < K;
  const uint32_t d = mine ? (uint32_t)diags[(long long)r * K + k] : INVALID;
  const bool valid = mine && d != INVALID;
  if (lead) dsm[k] = d;
  const int len = lengths[r];

  // the geometry of this thread's jumps kp -> k: type | nins << 2 |
  // cost << 8
  int geom[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int kp = part * P + j;
    const uint32_t dp = __shfl_sync(gmask, d, kp, T);
    const bool ok = valid && kp < K && dp != INVALID;
    const uint32_t gap = d - dp;
    const uint32_t ng = 0u - gap;
    int typ = T_NONE, cost = 0, nins = 0;
    if (gap >= sc.min_intron && gap <= sc.max_intron) {
      typ = T_INTRON;
    } else if (gap >= 1u && gap < sc.min_intron) {
      typ = T_DEL;
      const int gs = (int)min(gap, sc.min_intron);
      cost = sc.del_open + sc.del_extend * max(gs - 1, 0);
    } else if (ng >= 1u && ng <= (uint32_t)sc.max_insert) {
      typ = T_INS;
      nins = (int)ng;
      cost = sc.ins_open + sc.ins_extend * max(nins - 1, 0);
    }
    if (!ok) typ = T_NONE;
    geom[j] = typ | (nins << 2) | (cost * 256);
  }

  // inputs of candidate k, 4 steps a load (int4 and 32-bit loads where
  // vec, else one step at a time), one load ahead; the steps at or past L
  // read as zeros; the donor and mismatch bits only where the lead
  // thread uses them
  const long long row0 = ((long long)r * K + k) * L;
  struct Chunk {
    int s[4], d[4], a[4];
    uint32_t m, kn;       // 4 bytes each
  };
  auto load = [&](int q0, Chunk& c) {
#pragma unroll
    for (int j = 0; j < 4; ++j) c.s[j] = c.d[j] = c.a[j] = 0;
    c.m = c.kn = 0u;
    if (!mine || q0 >= L) return;
    const long long at = row0 + q0;
    if (vec) {
      const int4 sv = *reinterpret_cast<const int4*>(s + at);
      const int4 dv = lead ? *reinterpret_cast<const int4*>(don + at)
                           : make_int4(0, 0, 0, 0);
      const int4 av = *reinterpret_cast<const int4*>(acc + at);
      c.s[0] = sv.x; c.s[1] = sv.y; c.s[2] = sv.z; c.s[3] = sv.w;
      c.d[0] = dv.x; c.d[1] = dv.y; c.d[2] = dv.z; c.d[3] = dv.w;
      c.a[0] = av.x; c.a[1] = av.y; c.a[2] = av.z; c.a[3] = av.w;
      c.m = lead ? *reinterpret_cast<const uint32_t*>(mm + at) : 0u;
      c.kn = has_known ? *reinterpret_cast<const uint32_t*>(known + at) : 0u;
      return;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (q0 + j < L) {
        c.s[j] = s[at + j];
        c.a[j] = acc[at + j];
        if (lead) {
          c.d[j] = don[at + j];
          c.m |= (uint32_t)mm[at + j] << (8 * j);
        }
        if (has_known) c.kn |= (uint32_t)known[at + j] << (8 * j);
      }
    }
  };
  Chunk nxt;
  load(0, nxt);

  int H = NEG, C = 0;
  const int sv0 = valid ? 0 : NEG;
  int best_score = NEG, best_q = 0, best_k = 0;
  for (int q0 = 0; q0 < L; q0 += 4) {
    const Chunk now = nxt;
    load(q0 + 4, nxt);
#pragma unroll
    for (int jq = 0; jq < 4; ++jq) {
      const int q = q0 + jq;
      if (q >= L) break;                    // the whole group alike
      const int sq = now.s[jq], dn = now.d[jq], ac = now.a[jq];
      const int mq = (now.m >> (8 * jq)) & 0xFF;
      const int kn = (now.kn >> (8 * jq)) & 0xFF;
      const bool active = q < len;
      if (lead) ring[(q % RING) * G + k] = C;         // C_k(q)
      __syncwarp(gmask);

      int da, ba, db, bb;
      donor_partners(ac, sc, da, ba, db, bb);
      // known pair: donor on k' and acceptor on k, or antiacceptor on k'
      // and antidonor on k (bits 1, 2, 4, 8)
      const int kdst = ((kn & 2) ? 1 : 0) | ((kn & 4) ? 8 : 0);
      const int dkn = dn | (kn << 5);
      // straight-line code per k' (selects, one predicated ring read) so
      // the unrolled k' iterations interleave; only the running best is a
      // dependent chain. k' >= K contribute nothing; with SPLIT > 1 the
      // loop runs on (the parts of a group shuffle together), and so it
      // does for a global table: long rows are few, so a step's latency
      // counts there, and an exit at K would cut the loop into branches.
      const int cur = (q % RING) * G;
      int sw_best = 0, sw_arg = 0;
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int kp = part * P + j;
        if (SPLIT == 1 && !GTAB && kp >= K) break;
        const int Hp = __shfl_sync(gmask, H, kp, T);
        const int dkp = __shfl_sync(gmask, dkn, kp, T);
        const int g = geom[j];
        const int typ = g & 3, n = (g >> 2) & 63, cost = g >> 8;
        const int dj = dkp & 31;
        int bonus = dj == da ? ba : (dj == db ? bb : 0);
        if (has_known && ((dkp >> 5) & kdst))
          bonus = max(bonus, sc.b_known);
        const int t_intron = (!sc.allow_noncanon && bonus <= 0)
                                 ? NEG : sc.splice_base + bonus;
        int corr = 0;
        if (typ == T_INS)
          corr = ring[cur + kp] - ring[((q - n) & (RING - 1)) * G + kp];
        const int t_ins = q >= n + 1 ? cost - corr : NEG;
        int trans = typ == T_INTRON ? t_intron
                    : typ == T_DEL  ? cost
                    : typ == T_INS  ? t_ins : NEG;
        if (q < 1) trans = NEG;
        const int jump = Hp + trans;
        if (kp < K && (j == 0 || jump > sw_best)) {
          sw_best = jump;
          sw_arg = kp;
        }
      }
      if (SPLIT > 1) {
        // the parts' best jumps: the largest, first k' among equals; a
        // part with no k' < K offers nothing
        if (part * P >= K) sw_best = INT_MIN;
#pragma unroll
        for (int off = G; off < T; off *= 2)
          take_first_max(sw_best, sw_arg,
                         __shfl_xor_sync(gmask, sw_best, off, T),
                         __shfl_xor_sync(gmask, sw_arg, off, T));
      }
      const int cont = H;
      const int best3 = max(cont, max(sv0, sw_best));
      const int c = best3 == cont ? 0 : (best3 == sv0 ? 1 : 2 + sw_arg);
      if (active) {
        H = best3 + sq;
        C += sq;
      }
      if (lead)
        ch[q * G + k] = (uint8_t)((active ? c : 0) | (mq ? 0x80 : 0));

      // row maximum, first k among equals (every part alike)
      int row_best = mine ? H : INT_MIN, row_k = k;
#pragma unroll
      for (int off = G / 2; off > 0; off /= 2)
        take_first_max(row_best, row_k,
                       __shfl_xor_sync(gmask, row_best, off, T),
                       __shfl_xor_sync(gmask, row_k, off, T));
      if (active && row_best >= best_score) {
        best_score = row_best;
        best_q = q;
        best_k = row_k;
      }
    }
  }
  __syncwarp(gmask);

  // reverse walk from the best end (thread 0): segment starts (last
  // first), the mismatches on the path, insertion windows skipped
  int nsegs = 0, nmm = 0;
  if (t == 0) {
    int k_cur = best_k, skip = 0;
    for (int q = best_q; q >= 0; --q) {
      const int b = ch[q * G + k_cur];
      const int c = b & 0x7F;
      const bool is_start = c == 1, is_switch = c >= 2;
      if (is_start || is_switch) {
        if (nsegs < S) segs[nsegs] = q * 32 + k_cur;
        ++nsegs;
      }
      if (skip == 0) nmm += b >> 7;
      skip = max(skip - 1, 0);
      if (is_switch) {
        const int kp = min(max(c - 2, 0), K - 1);
        const uint32_t nij = dsm[kp] - dsm[k_cur];
        if (nij >= 1u && nij <= (uint32_t)sc.max_insert) skip = (int)nij;
        k_cur = c - 2;
      }
      if (is_start) break;
    }
  }
  nsegs = __shfl_sync(gmask, nsegs, 0, T);
  __syncwarp(gmask);

  // flip to ascending query order, thread i writes slot i; slots past
  // the S recorded segments read JAX's out-of-range fill (INT32_MIN,
  // INVALID)
  if (t < S) {
    int qv = 0;
    uint32_t dv = INVALID;
    if (t < nsegs) {
      const int src = nsegs - 1 - t;
      if (src < S) {
        qv = segs[src] >> 5;
        dv = dsm[segs[src] & 31];
      } else {
        qv = INT_MIN;
      }
    }
    out_segq[(long long)r * S + t] = qv;
    out_segd[(long long)r * S + t] = (long long)dv;
    if (t == 0) {
      out_score[r] = best_score;
      out_qstart[r] = qv;
      out_qend[r] = best_q + 1;
      out_nsegs[r] = nsegs;
      out_nmm[r] = nmm;
    }
  }
}

template <int G, int SPLIT, bool GTAB>
int launch(const void* diags, const void* s, const void* don,
           const void* acc, const void* mm, const void* known,
           const void* lengths, int R, int K, int L, bool vec,
           const Scoring& sc, void* gtab,
           void* score, void* q_start, void* q_end, void* nsegs, void* seg_q,
           void* seg_diag, void* nmm, cudaStream_t stream) {
  constexpr int T = G * SPLIT;
  const int per_row = RowSmem<G, GTAB>::bytes(L);
  const int max_smem = 227 * 1024;
  int warps = WARPS;
  while (warps > 1 && warps * (32 / T) * per_row > max_smem) warps /= 2;
  const int rows = warps * (32 / T);
  const int bytes = rows * per_row;
  if (bytes > max_smem) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        chain_kernel<G, SPLIT, GTAB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  chain_kernel<G, SPLIT, GTAB><<<(R + rows - 1) / rows, warps * 32, bytes,
                                 stream>>>(
      (const long long*)diags, (const int32_t*)s, (const int32_t*)don,
      (const int32_t*)acc, (const uint8_t*)mm, (const uint8_t*)known,
      (const int32_t*)lengths, R, K, L, vec, sc, (uint8_t*)gtab,
      (int32_t*)score,
      (int32_t*)q_start, (int32_t*)q_end, (int32_t*)nsegs, (int32_t*)seg_q,
      (long long*)seg_diag, (int32_t*)nmm);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tt_chain_dp(const void* diags, const void* s, const void* don,
                           const void* acc, const void* mm, const void* known,
                           const void* lengths, int R, int K, int L,
                           int del_open, int del_extend, int splice_base,
                           int b_gtag, int b_gcag, int b_atac, int b_known,
                           long long min_intron, long long max_intron,
                           int ins_open, int ins_extend, int max_insert,
                           int allow_noncanon, void* gtab, void* score,
                           void* q_start, void* q_end, void* nsegs,
                           void* seg_q, void* seg_diag, void* nmm,
                           void* stream) {
  Scoring sc{del_open,   del_extend, splice_base,
             b_gtag,     b_gcag,     b_atac,
             b_known,    (uint32_t)min_intron,
             (uint32_t)max_intron,   ins_open,
             ins_extend, max_insert, allow_noncanon};
  // 4-step vector loads where the rows and the pointers allow them
  const bool vec = L % 4 == 0
      && ((uintptr_t)s | (uintptr_t)don | (uintptr_t)acc) % 16 == 0
      && ((uintptr_t)mm | (uintptr_t)known) % 4 == 0;
  // the choice table in global memory where the caller gives a scratch
  // of R * L * G bytes (G = 8 or 16), else in shared memory
  auto fn = K <= 8 ? (gtab ? launch<8, SPLIT8, true>
                           : launch<8, SPLIT8, false>)
                   : (gtab ? launch<16, SPLIT16, true>
                           : launch<16, SPLIT16, false>);
  return fn(diags, s, don, acc, mm, known, lengths, R, K, L, vec, sc, gtab,
            score, q_start, q_end, nsegs, seg_q, seg_diag, nmm,
            (cudaStream_t)stream);
}
