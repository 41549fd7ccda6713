// K5: the chain DP of the RNA path and its traceback.
//
// Replaces: tpumap/ops/pathdp.py:chain_solve, lines 217-411: the forward
// lax.scan over query positions (per step [R, K', K] transition math:
// extend, open, or jump through a deletion, a scored intron or an
// insertion with its exact rolling-window correction), the reverse scan
// that walks the choices back to segments, the segment flip and the
// mismatch count on the path. The inputs come from the plain-torch
// prologue tpumap_torch/ops/pathdp.py:chain_inputs (pathdp.py:137-215).
//
// Bound on the H100: each row is a chain of L dependent steps of K*K
// integer transitions (64 at K = 8), so the work is sequential per row
// and integer-ALU bound; R = 8,192 rows (pass 1) and 2,048 (pass 2) are
// few threads for 132 SMs, so the kernel is latency bound.
//
// Design: one thread per row, in warps of 32 so the rows spread over the
// SMs. The lane count is a template bound: 8 (the cascade's candidate
// lists) or 16 (14 lanes with known splicing's partner diagonals). H[K]
// and the insertion window recent[K][max_insert] stay in registers; the
// per-step inputs are read time-major ([L, K, R]), so a warp reads 32
// neighbouring rows' bytes at once. The per-step choice
// bytes go to a global scratch [L, K, R] that the reverse walk reads
// back. Ties follow tpumap exactly: extend before open before jump, the
// first k' of the best jump, the first k of the row maximum, and the
// latest end among equal row maxima. Gaps are uint32 wrap arithmetic.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NIMAX = 8;    // longest insertion jump
constexpr int S = 8;        // segments kept per row
constexpr int NEG = -(1 << 20);
constexpr uint32_t INVALID = 0xFFFFFFFFu;
// dinucleotide codes (a=0 c=1 g=2 t=3, hi*4+lo)
constexpr int GT = 11, AG = 2, GC = 9, AT = 3, CT = 7, AC = 1;

struct Scoring {
  int del_open, del_extend, splice_base, b_gtag, b_gcag, b_atac, b_known;
  uint32_t min_intron, max_intron;
  int ins_open, ins_extend, max_insert, allow_noncanon;
};

__device__ __forceinline__ int intron_bonus(int dj, int aj, int kn_src,
                                            int kn_dst, bool has_known,
                                            const Scoring& sc) {
  int sense = (dj == GT && aj == AG) ? sc.b_gtag
              : (dj == GC && aj == AG) ? sc.b_gcag
              : (dj == AT && aj == AC) ? sc.b_atac : 0;
  int anti = (dj == CT && aj == AC) ? sc.b_gtag
             : (dj == CT && aj == GC) ? sc.b_gcag
             : (dj == GT && aj == AT) ? sc.b_atac : 0;
  int bonus = max(sense, anti);
  if (has_known) {
    // donor on k' and acceptor on k, or antiacceptor on k' and
    // antidonor on k (bits 1, 2, 4, 8: donor, acceptor, antidonor,
    // antiacceptor)
    bool pair = ((kn_src & 1) && (kn_dst & 2)) || ((kn_src & 8) && (kn_dst & 4));
    bonus = max(bonus, pair ? sc.b_known : 0);
  }
  return bonus;
}

template <int KMAX>
__global__ void __launch_bounds__(32) chain_kernel(
    const long long* __restrict__ diags, const int32_t* __restrict__ s,
    const uint8_t* __restrict__ don, const uint8_t* __restrict__ acc,
    const uint8_t* __restrict__ mm, const uint8_t* __restrict__ known,
    const int32_t* __restrict__ lengths, int R, int K, int L, Scoring sc,
    uint8_t* __restrict__ choices, int32_t* __restrict__ out_score,
    int32_t* __restrict__ out_qstart, int32_t* __restrict__ out_qend,
    int32_t* __restrict__ out_nsegs, int32_t* __restrict__ out_segq,
    long long* __restrict__ out_segd, int32_t* __restrict__ out_nmm) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const bool has_known = known != nullptr;
  uint32_t d[KMAX];
  bool valid[KMAX];
  int H[KMAX];
  int rec[KMAX][NIMAX];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    d[k] = k < K ? (uint32_t)diags[(long long)r * K + k] : INVALID;
    valid[k] = k < K && d[k] != INVALID;
    H[k] = NEG;
#pragma unroll
    for (int j = 0; j < NIMAX; ++j) rec[k][j] = 0;
  }
  const int len = lengths[r];
  int best_score = NEG, best_q = 0, best_k = 0;

  for (int q = 0; q < L; ++q) {
    const bool active = q < len;
    int sq[KMAX], dn[KMAX], ac[KMAX], kn[KMAX];
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k < K) {
        const long long at = ((long long)q * K + k) * R + r;
        sq[k] = s[at];
        dn[k] = don[at];
        ac[k] = acc[at];
        kn[k] = has_known ? known[at] : 0;
      } else {
        sq[k] = dn[k] = ac[k] = kn[k] = 0;
      }
    }
    int Hn[KMAX];
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k >= K) {
        Hn[k] = NEG;
        continue;
      }
      int sw_best = 0, sw_arg = 0;
#pragma unroll
      for (int kp = 0; kp < KMAX; ++kp) {
        if (kp >= K) continue;
        const uint32_t gap = d[k] - d[kp];
        const uint32_t ng = 0u - gap;
        const bool is_del = gap >= 1u && gap < sc.min_intron;
        const bool is_intron = gap >= sc.min_intron && gap <= sc.max_intron;
        const bool is_ins = ng >= 1u && ng <= (uint32_t)sc.max_insert;
        const int nins = (int)min(ng, (uint32_t)sc.max_insert);
        int trans;
        if (is_intron) {
          const int bonus = intron_bonus(dn[kp], ac[k], kn[kp], kn[k],
                                         has_known, sc);
          trans = sc.splice_base + bonus;
          if (!sc.allow_noncanon && bonus <= 0) trans = NEG;
        } else if (is_del) {
          const int gs = (int)min(gap, sc.min_intron);
          trans = sc.del_open + sc.del_extend * max(gs - 1, 0);
        } else if (is_ins) {
          int corr = 0;
#pragma unroll
          for (int j = 0; j < NIMAX; ++j)
            if (j < nins) corr += rec[kp][j];
          trans = sc.ins_open + sc.ins_extend * max(nins - 1, 0) - corr;
        } else {
          trans = NEG;
        }
        if (is_ins && q < nins + 1) trans = NEG;
        if (!(valid[kp] && valid[k] && q >= 1)) trans = NEG;
        const int jump = H[kp] + trans;
        if (kp == 0 || jump > sw_best) {
          sw_best = jump;
          sw_arg = kp;
        }
      }
      const int cont = H[k];
      const int sv = valid[k] ? 0 : NEG;
      const int best3 = max(cont, max(sv, sw_best));
      const int c = best3 == cont ? 0 : (best3 == sv ? 1 : 2 + sw_arg);
      Hn[k] = active ? best3 + sq[k] : cont;
      choices[((long long)q * K + k) * R + r] = (uint8_t)(active ? c : 0);
    }
    int row_best = INT_MIN, row_k = 0;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k >= K) continue;
      H[k] = Hn[k];
      if (H[k] > row_best) {
        row_best = H[k];
        row_k = k;
      }
      if (active) {
#pragma unroll
        for (int j = NIMAX - 1; j > 0; --j) rec[k][j] = rec[k][j - 1];
        rec[k][0] = sq[k];
      }
    }
    if (active && row_best >= best_score) {
      best_score = row_best;
      best_q = q;
      best_k = row_k;
    }
  }

  // reverse walk from the best end: segment starts (last first), the
  // mismatches on the path, insertion windows skipped
  int k_cur = best_k, nsegs = 0, skip = 0, nmm = 0;
  bool done = false;
  int segq_rev[S], segk_rev[S];
  for (int q = L - 1; q >= 0; --q) {
    const bool inside = q <= best_q && !done;
    if (!inside) continue;
    const long long at = ((long long)q * K + k_cur) * R + r;
    const int c = choices[at];
    const bool is_start = c == 1, is_switch = c >= 2;
    if (is_start || is_switch) {
      if (nsegs < S) {
        segq_rev[nsegs] = q;
        segk_rev[nsegs] = k_cur;
      }
      ++nsegs;
    }
    if (skip == 0) nmm += mm[at];
    skip = max(skip - 1, 0);
    if (is_switch) {
      const int kp = min(max(c - 2, 0), K - 1);
      const uint32_t nij = d[kp] - d[k_cur];
      if (nij >= 1u && nij <= (uint32_t)sc.max_insert) skip = (int)nij;
      k_cur = c - 2;
    }
    done = is_start;
  }

  // flip to ascending query order; slots past the S recorded segments
  // read JAX's out-of-range fill (INT32_MIN, INVALID)
  for (int t = 0; t < S; ++t) {
    int qv = 0;
    uint32_t dv = INVALID;
    if (t < nsegs) {
      const int src = nsegs - 1 - t;
      if (src < S) {
        qv = segq_rev[src];
        dv = d[segk_rev[src]];
      } else {
        qv = INT_MIN;
      }
    }
    out_segq[(long long)r * S + t] = qv;
    out_segd[(long long)r * S + t] = (long long)dv;
  }
  out_score[r] = best_score;
  out_qstart[r] = out_segq[(long long)r * S];
  out_qend[r] = best_q + 1;
  out_nsegs[r] = nsegs;
  out_nmm[r] = nmm;
}

}  // namespace

extern "C" int tt_chain_dp(const void* diags, const void* s, const void* don,
                           const void* acc, const void* mm, const void* known,
                           const void* lengths, int R, int K, int L,
                           int del_open, int del_extend, int splice_base,
                           int b_gtag, int b_gcag, int b_atac, int b_known,
                           long long min_intron, long long max_intron,
                           int ins_open, int ins_extend, int max_insert,
                           int allow_noncanon, void* choices, void* score,
                           void* q_start, void* q_end, void* nsegs,
                           void* seg_q, void* seg_diag, void* nmm,
                           void* stream) {
  Scoring sc{del_open,   del_extend, splice_base,
             b_gtag,     b_gcag,     b_atac,
             b_known,    (uint32_t)min_intron,
             (uint32_t)max_intron,   ins_open,
             ins_extend, max_insert, allow_noncanon};
  const int threads = 32;
  auto kernel = K <= 8 ? chain_kernel<8> : chain_kernel<16>;
  kernel<<<(R + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      (const long long*)diags, (const int32_t*)s, (const uint8_t*)don,
      (const uint8_t*)acc, (const uint8_t*)mm, (const uint8_t*)known,
      (const int32_t*)lengths, R, K, L, sc, (uint8_t*)choices,
      (int32_t*)score, (int32_t*)q_start, (int32_t*)q_end, (int32_t*)nsegs,
      (int32_t*)seg_q, (long long*)seg_diag, (int32_t*)nmm);
  return (int)cudaGetLastError();
}
