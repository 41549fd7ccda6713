// K2: batched banded affine-gap alignment, forward pass.
//
// Replaces: tpumap/ops/dp.py:53 banded_align (a lax.scan over the Lq
// query rows of [B, 2*band+1] lane vectors, modes "glocal" and "global",
// with the direction bits and their tie order at dp.py:119-129).
//
// Bound on the H100: the row recurrence is sequential, so one problem is
// Lq dependent steps, each with a prefix max over the W = 2*band+1 band
// cells. The work per cell is ~12 integer ops and one byte of direction
// output (R*Lq*W bytes, 17 MB at R=2048, Lq=128, W=65). At R = 2,048
// there are ~16 problems an SM, so the time is each step's latency and
// issue: a step spread over a block waits at block barriers and
// shared-memory round trips (nine and ~10 a row with a block of 96
// threads, ~1.8 us a row), a step inside one warp at neither.
//
// Design: one warp per problem, WARPS problems a block, and no block
// barrier at all. Lane l owns CPL = ceil(W / 32) consecutive band cells
// k = CPL*l ... CPL*l + CPL - 1 (a template parameter from 1 to 4, so
// W <= 127, band <= 63; every caller in both packages passes
// INDEL_BAND = 32, gsnap/params.py, so W = 65 and CPL = 3 on the path);
// cells k >= W hold H = F = NEG and never change. H and F of the
// previous row stay in the lane's registers: the Hup/Fup of cell k+1
// come from the lane's own next cell, or from the next lane by one
// __shfl_down_sync for its last cell. The prefix max of t = MF + e*k
// is a running max over the lane's own cells, then a 5-step
// __shfl_up_sync warp scan of the lane totals; its exclusive form gives
// c_shift of the lane's first cell, and t_shift of a cell is t of the
// cell before it (the previous lane's last for the first). Query and
// genome codes are staged once per warp in shared memory behind
// __syncwarp, the genome's padded on both sides with the clamped codes,
// so a cell reads its code with no clamp and tests 0 <= j < glen with
// one unsigned compare; each lane stores its CPL direction bytes of the
// row (the row of a problem is contiguous). Every comparison is made on
// the same int32 values in the same order as tpumap, so the direction
// bits, score, end_k (first argmax: a warp reduction over (H, k), the
// smaller k among equals), H_last and the global mode's take_along_axis
// rule are identical; rows i > qlen are still computed and written with
// H and F frozen, as the plain version does.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNeg = -(1 << 20);
constexpr int WARPS = 4;                 // problems (warps) a block
constexpr unsigned FULL = 0xFFFFFFFFu;

// bytes of shared memory one warp stages its codes in: the query, and
// the genome codes of every j = i - 1 + k - band a cell reads (k < 32 *
// CPL, padding cells included), clamped to [0, Lg) as the plain
// version's gather clamps them
__host__ __device__ inline int warp_smem(int Lq, int cpl) {
  return (2 * Lq + 32 * cpl + 15) / 16 * 16;
}

template <int CPL>
__global__ void __launch_bounds__(WARPS * 32) banded_kernel(
    const uint8_t* __restrict__ qcodes, const int32_t* __restrict__ qlens,
    const uint8_t* __restrict__ gcodes, const int32_t* __restrict__ glens,
    int R, int Lq, int Lg, int band, int global_mode, int match,
    int mismatch, int o, int e, uint8_t* __restrict__ dirs,
    int32_t* __restrict__ score, int32_t* __restrict__ end_k,
    int32_t* __restrict__ h_last) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.x * (blockDim.x >> 5) + warp;
  if (r >= R) return;                    // whole warps leave
  const int W = 2 * band + 1;
  uint8_t* sq = smem + warp * warp_smem(Lq, CPL);
  uint8_t* sg = sq + Lq;                 // sg[j + band]
  const uint8_t* q = qcodes + (long long)r * Lq;
  const uint8_t* g = gcodes + (long long)r * Lg;
  for (int x = lane; x < Lq; x += 32) sq[x] = q[x];
  for (int x = lane; x < Lq + 32 * CPL; x += 32)
    sg[x] = g[min(max(x - band, 0), Lg - 1)];
  const int qlen = qlens[r];
  // 0 <= j < glen as one unsigned compare
  const unsigned glen = (unsigned)max(glens[r], 0);
  const int glen_raw = glens[r];
  const int k0 = CPL * lane;

  int H[CPL], F[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int k = k0 + c;
    int h0 = 0;
    if (global_mode) {
      const int lead = k - band;
      h0 = lead == 0 ? 0 : (lead > 0 ? -(o + (lead - 1) * e) : kNeg);
    }
    H[c] = k < W ? h0 : kNeg;
    F[c] = kNeg;
  }
  __syncwarp();

  bool band_cell[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) band_cell[c] = k0 + c < W;
  uint8_t* drow = dirs + (long long)r * Lq * W + k0;
  for (int i = 1; i <= Lq; ++i, drow += W) {
    const int qc = sq[i - 1];
    const bool active = i <= qlen;
    // the previous row's H and F of cell k+1 (the next lane's first cell
    // for the last; lane 31's last cell is always padding: W is odd)
    int Hup[CPL], Fup[CPL];
    Hup[CPL - 1] = __shfl_down_sync(FULL, H[0], 1);
    Fup[CPL - 1] = __shfl_down_sync(FULL, F[0], 1);
#pragma unroll
    for (int c = 0; c + 1 < CPL; ++c) {
      Hup[c] = H[c + 1];
      Fup[c] = F[c + 1];
    }
    int Fc[CPL], M[CPL], MF[CPL], t[CPL], pre[CPL];
    bool inb[CPL];
    int run = INT_MIN;                   // t can lie below NEG
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int k = k0 + c;
      const int j = i - 1 + k - band;
      inb[c] = (unsigned)j < glen;
      const bool eq = sg[j + band] == qc && inb[c];
      Fc[c] = max(Hup[c] - o, Fup[c] - e);
      M[c] = H[c] + (eq ? match : mismatch);
      MF[c] = max(M[c], Fc[c]);
      // padding cells (k >= W) follow every band cell, so their t reaches
      // no band cell's prefix
      t[c] = MF[c] + e * k;
      run = max(run, t[c]);
      pre[c] = run;                      // inclusive max over own cells
    }
    // inclusive max of the lane totals across the warp (a lane below off
    // reads its own value, which leaves the max alone), then exclusive
    int incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1)
      incl = max(incl, __shfl_up_sync(FULL, incl, off));
    // cell 0's c_shift and t_shift are NEG, as the plain version's
    // shifted-in column
    int excl = __shfl_up_sync(FULL, incl, 1);
    int tprev = __shfl_up_sync(FULL, t[CPL - 1], 1);
    if (lane == 0) {
      excl = INT_MIN;
      tprev = kNeg;
    }
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int k = k0 + c;
      const int c_shift = c == 0 ? (lane == 0 ? kNeg : excl)
                                 : max(excl, pre[c > 0 ? c - 1 : 0]);
      const int t_shift = c == 0 ? tprev : t[c > 0 ? c - 1 : 0];
      const int E = c_shift - o - e * (k - 1);
      int h = max(MF[c], E);
      int f = Fc[c];
      if (!inb[c]) {
        h = kNeg;
        f = kNeg;
      }
      const uint8_t dir = h == M[c] ? 0 : (h == E ? 2 : 1);
      const uint8_t fcont = (f == Fup[c] - e) && (f != Hup[c] - o);
      const uint8_t esrc = c_shift == t_shift;
      const uint8_t mf_is_m = MF[c] == M[c];
      if (band_cell[c])
        drow[c] = dir | (fcont << 2) | (esrc << 3) | (mf_is_m << 4);
      // rows past qlen keep H and F; padding cells keep NEG
      H[c] = band_cell[c] && active ? h : H[c];
      F[c] = band_cell[c] && active ? f : F[c];
    }
  }

#pragma unroll
  for (int c = 0; c < CPL; ++c)
    if (k0 + c < W) h_last[(long long)r * W + k0 + c] = H[c];
  int sc, ek;
  if (global_mode) {
    ek = glen_raw - qlen + band;
    // JAX take_along_axis: negative indices wrap once, others past the
    // end fill with INT32_MIN
    const int idx = ek < 0 ? ek + W : ek;
    const bool in = idx >= 0 && idx < W;
    const int cell = in ? idx % CPL : 0;
    int v = H[0];
#pragma unroll
    for (int c = 1; c < CPL; ++c)
      if (cell == c) v = H[c];
    v = __shfl_sync(FULL, v, in ? idx / CPL : 0);
    sc = in ? v : INT_MIN;
  } else {
    // first argmax: the lane's own cells in order, then the warp, the
    // smaller k among equal H
    sc = INT_MIN;
    ek = W;
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      if (k0 + c < W && H[c] > sc) {
        sc = H[c];
        ek = k0 + c;
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int ov = __shfl_xor_sync(FULL, sc, off);
      const int ok = __shfl_xor_sync(FULL, ek, off);
      if (ov > sc || (ov == sc && ok < ek)) {
        sc = ov;
        ek = ok;
      }
    }
  }
  if (lane == 0) {
    score[r] = sc;
    end_k[r] = ek;
  }
}

template <int CPL>
int launch(const void* qcodes, const void* qlens, const void* gcodes,
           const void* glens, int R, int Lq, int Lg, int band,
           int global_mode, int match, int mismatch, int o, int e,
           void* dirs, void* score, void* end_k, void* h_last,
           cudaStream_t stream) {
  const int max_smem = 227 * 1024;
  const int per_warp = warp_smem(Lq, CPL);
  int warps = WARPS;
  while (warps > 1 && warps * per_warp > max_smem) --warps;
  const int bytes = warps * per_warp;
  if (bytes > max_smem) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        banded_kernel<CPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return (int)err;
  }
  banded_kernel<CPL><<<(R + warps - 1) / warps, warps * 32, bytes, stream>>>(
      (const uint8_t*)qcodes, (const int32_t*)qlens, (const uint8_t*)gcodes,
      (const int32_t*)glens, R, Lq, Lg, band, global_mode, match, mismatch,
      o, e, (uint8_t*)dirs, (int32_t*)score, (int32_t*)end_k,
      (int32_t*)h_last);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tt_banded_align(const void* qcodes, const void* qlens,
                               const void* gcodes, const void* glens, int R,
                               int Lq, int Lg, int band, int global_mode,
                               int match, int mismatch, int gap_open,
                               int gap_extend, void* dirs, void* score,
                               void* end_k, void* h_last, void* stream) {
  const int W = 2 * band + 1;
  if (band < 0 || W > 128) return (int)cudaErrorInvalidValue;
  // CPL = ceil(W / 32) band cells a lane
  auto fn = W <= 32 ? launch<1> : W <= 64 ? launch<2>
          : W <= 96 ? launch<3> : launch<4>;
  return fn(qcodes, qlens, gcodes, glens, R, Lq, Lg, band, global_mode,
            match, mismatch, gap_open, gap_extend, dirs, score, end_k,
            h_last, (cudaStream_t)stream);
}
