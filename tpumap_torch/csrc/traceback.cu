// K3: affine traceback of the banded DP, with the transcript's
// run-length encoding fused in.
//
// Replaces: tpumap/ops/dp.py:traceback (a vmapped lax.scan of
// S = Lq + 2*band steps of a 4-state walker over the direction matrix)
// and the run-length encoding of its transcript in
// tpumap/gsnap/ladder.py:refine_full (lines 505-523, at most 12 runs).
//
// Bound on the H100: the walk is sequential within a problem (each step
// reads the cell the previous step chose), so a problem costs up to S
// dependent cell reads; its bytes (Lq x W direction bytes in, S op
// bytes out) take nanoseconds. The time is the latency of that chain.
//
// Design: one warp per problem. The walk only moves up the rows (i
// falls or stays), so the rows [0, min(qlen, Lq)) are streamed into
// shared memory from the bottom up as tiles of whole rows, two buffers
// a warp: the lanes issue cp.async copies of the next tile (16-byte
// blocks; a 16-byte block that holds a byte of the tensor lies in the
// tensor's memory page, so the aligned span around a tile is read
// whole) while lane 0 walks the current one. A step is then one
// shared-memory cell read, one read of a 128-entry decode table
// (state x cell -> op, row step, lane step, next state) and a few
// integer operations. The walk ends at i <= 0, where every further op
// is T_END (the walker's state no longer changes), or after S steps.
//
// Lane 0 leaves its ops in a 32-byte chunk in shared memory; the warp
// then stores the chunk with one coalesced store and run-length encodes
// it: a __ballot_sync marks where runs start, popcounts give their
// indices. Runs are counted in emission order (end-first), so the first
// maxruns runs of the forward transcript are the last maxruns runs
// emitted: a ring of maxruns (op, length) entries keeps them, and
// nruns counts them all (it may exceed maxruns, as in tpumap). Any Lq
// runs on the same path: only two tiles a warp are resident.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum { DIAG = 0, UP = 1, LEFT = 2 };
enum { T_MATCH = 0, T_INS = 1, T_DEL = 2, T_END = 3 };
enum { ST_H = 0, ST_E = 1, ST_F = 2, ST_MF = 3 };

constexpr int WARPS = 2;              // problems a block
constexpr int TILE_BYTES = 4096;      // direction bytes of a tile (whole rows)
constexpr unsigned FULL = 0xFFFFFFFFu;

// Decode-table entry of (state, cell), as dp.py's walker steps:
// bits 0-1 the op, 2-3 the lane step + 1, 5-6 the next state, 7 the row
// step (1: i falls by one)
__device__ uint8_t decode(int st, int cell) {
  const int d = cell & 3, fcont = (cell >> 2) & 1, esrc = (cell >> 3) & 1,
            mf_is_m = (cell >> 4) & 1;
  const bool in_e = st == ST_E || (st == ST_H && d == LEFT);
  const bool is_m = (st == ST_H && d == DIAG) || (st == ST_MF && mf_is_m);
  const int emit = in_e ? T_DEL : (is_m ? T_MATCH : T_INS);
  const int nst = in_e ? (esrc ? ST_MF : ST_E)
                       : (is_m ? ST_H : (fcont ? ST_F : ST_H));
  const int dk = in_e ? -1 : (is_m ? 0 : 1);
  return (uint8_t)(emit | (dk + 1) << 2 | nst << 5 | (in_e ? 0 : 1) << 7);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Issue the copy of bytes [g0, g1) into buf (all lanes): the 16-byte
// aligned span around them, so byte g lands at buf + (g - (g0 & ~15)).
// Returns the offset of g0 in buf.
__device__ __forceinline__ int load_tile(uint8_t* buf, const uint8_t* g0,
                                         const uint8_t* g1, int lane) {
  const uintptr_t lo = (uintptr_t)g0 & ~(uintptr_t)15;
  const uintptr_t hi = ((uintptr_t)g1 + 15) & ~(uintptr_t)15;
  for (uintptr_t p = lo + 16 * lane; p < hi; p += 16 * 32)
    cp_async16(buf + (p - lo), (const void*)p);
  cp_async_commit();
  return (int)((uintptr_t)g0 - lo);
}

// the run ring: entry e % maxruns holds run e (emission order) as
// op << 16 | length
__device__ __forceinline__ void keep_run(uint32_t* ring, int maxruns, int e,
                                         int total, int op, int len) {
  if (e + maxruns >= total)   // among the last maxruns runs so far
    ring[e % maxruns] = (uint32_t)op << 16 | ((uint32_t)len & 0xFFFFu);
}

__global__ void __launch_bounds__(WARPS * 32) traceback_kernel(
    const uint8_t* __restrict__ dirs, const int32_t* __restrict__ qlens,
    const int32_t* __restrict__ end_k, int R, int Lq, int W, int band,
    int maxruns, int T, int buf_bytes, int warp_bytes,
    uint8_t* __restrict__ ops, int32_t* __restrict__ k_final,
    uint8_t* __restrict__ run_op, uint16_t* __restrict__ run_len,
    int32_t* __restrict__ nruns) {
  __shared__ uint8_t tab[128];
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int x = threadIdx.x; x < 128; x += blockDim.x)
    tab[x] = decode(x >> 5, x & 31);
  __syncthreads();
  const int r = blockIdx.x * WARPS + wid;
  if (r >= R) return;

  uint8_t* base = smem + (size_t)wid * warp_bytes;
  uint32_t* ring = (uint32_t*)(base + 2 * buf_bytes);
  uint8_t* chunk = base + 2 * buf_bytes + ((4 * maxruns + 15) & ~15);
  const int S = Lq + 2 * band;
  const uint8_t* d0 = dirs + (long long)r * Lq * W;
  uint8_t* out = ops + (long long)r * S;

  int i = qlens[r], k = end_k[r], st5 = ST_H << 5;
  // rows [row0, row0 + T) in buf[cur] at head; the next tile's rows end
  // at row0 (prefetched into buf[cur ^ 1] at nhead)
  const int rows = i < Lq ? i : Lq;
  int cur = 0, row0 = rows, head = 0, nhead = 0;
  if (rows > 0 && S > 0) {
    row0 = max(rows - T, 0);
    head = load_tile(base, d0 + (long long)row0 * W,
                     d0 + (long long)rows * W, lane);
    if (row0 > 0) {
      nhead = load_tile(base + buf_bytes, d0 + (long long)max(row0 - T, 0) * W,
                        d0 + (long long)row0 * W, lane);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
  }

  int s = 0, nr = 0, cur_op = -1, cur_len = 0;
  while (i > 0 && s < S) {
    int n = 0;
    if (lane == 0) {
      const uint8_t* cells = base + cur * buf_bytes + head;
      const int lim = min(32, S - s);
      while (n < lim && i > 0) {
        const int ic = min(i - 1, Lq - 1);
        if (ic < row0) break;               // the next tile's rows
        const int kc = min(max(k, 0), W - 1);
        const uint32_t t = tab[st5 | (cells[(ic - row0) * W + kc] & 31)];
        chunk[n++] = (uint8_t)(t & 3);
        st5 = t & 0x60;
        i -= (int)(t >> 7);
        k += (int)((t >> 2) & 3) - 1;
      }
    }
    __syncwarp();
    n = __shfl_sync(FULL, n, 0);
    i = __shfl_sync(FULL, i, 0);
    k = __shfl_sync(FULL, k, 0);
    st5 = __shfl_sync(FULL, st5, 0);

    if (n > 0) {
      // store the chunk and run-length encode it (emission order)
      const int op = lane < n ? chunk[lane] : -1;
      if (lane < n) out[s + lane] = (uint8_t)op;
      int prev = __shfl_up_sync(FULL, op, 1);
      if (lane == 0) prev = cur_op;
      const bool start = lane < n && op != prev;
      const unsigned b = __ballot_sync(FULL, start);
      const int total = nr + __popc(b);
      if (b) {
        if (lane == 0 && nr > 0 && maxruns > 0)   // the open run closes
          keep_run(ring, maxruns, nr - 1, total, cur_op,
                   cur_len + __ffs(b) - 1);
        const unsigned later = b & ~((2u << lane) - 1u);
        if (start && later && maxruns > 0)
          keep_run(ring, maxruns, nr + __popc(b & ((1u << lane) - 1u)),
                   total, op, __ffs(later) - 1 - lane);
        const int last = 31 - __clz(b);
        cur_op = __shfl_sync(FULL, op, last);
        cur_len = n - last;
      } else {
        cur_len += n;
      }
      nr = total;
      s += n;
      __syncwarp();                        // chunk read before it is reused
    }
    if (i > 0 && s < S && min(i - 1, Lq - 1) < row0) {
      // the walk reached the next tile: take it, prefetch the one after
      cp_async_wait<0>();
      __syncwarp();
      cur ^= 1;
      head = nhead;
      const int top = row0;
      row0 = max(top - T, 0);
      if (row0 > 0)
        nhead = load_tile(base + (cur ^ 1) * buf_bytes, d0 + (long long)max(row0 - T, 0) * W,
                          d0 + (long long)row0 * W, lane);
    }
  }
  cp_async_wait<0>();

  if (lane == 0) {
    if (nr > 0 && maxruns > 0) keep_run(ring, maxruns, nr - 1, nr, cur_op,
                                        cur_len);
    k_final[r] = k;
    nruns[r] = nr;
  }
  __syncwarp();
  // forward run f is run nr - 1 - f of the emission order
  for (int f = lane; f < maxruns; f += 32) {
    const int e = nr - 1 - f;
    const uint32_t v = e >= 0 ? ring[e % maxruns] : 0u;
    run_op[(long long)r * maxruns + f] = e >= 0 ? (uint8_t)((v >> 16) + 1) : 0;
    run_len[(long long)r * maxruns + f] = e >= 0 ? (uint16_t)(v & 0xFFFFu) : 0;
  }
  for (int x = s + lane; x < S; x += 32) out[x] = T_END;
}

}  // namespace

extern "C" int tt_traceback(const void* dirs, const void* qlens,
                            const void* end_k, int R, int Lq, int W,
                            int band, int maxruns, void* ops, void* k_final,
                            void* run_op, void* run_len, void* nruns,
                            void* stream) {
  // a tile is T whole rows; its buffer holds the 16-byte aligned span
  // around them; a warp also keeps its run ring and its op chunk
  const int T = W >= TILE_BYTES ? 1 : TILE_BYTES / W;
  const int buf_bytes = (T * W + 30 + 15) & ~15;
  const long long warp_bytes =
      2LL * buf_bytes + ((4LL * maxruns + 15) & ~15LL) + 32;
  const long long bytes = WARPS * warp_bytes;
  if (bytes > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        traceback_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  traceback_kernel<<<(R + WARPS - 1) / WARPS, WARPS * 32, (int)bytes,
                     (cudaStream_t)stream>>>(
      (const uint8_t*)dirs, (const int32_t*)qlens, (const int32_t*)end_k, R,
      Lq, W, band, maxruns, T, buf_bytes, (int)warp_bytes, (uint8_t*)ops,
      (int32_t*)k_final, (uint8_t*)run_op, (uint16_t*)run_len,
      (int32_t*)nruns);
  return (int)cudaGetLastError();
}
