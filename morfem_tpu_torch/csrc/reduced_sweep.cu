// Fused reduced-sweep solve: for every frequency point i,
//
//   A_i = c_i0·R0 + c_i1·R1 + c_i2·R2 + diag(inactive)     (K×K, f32)
//   A_i · x_i = B_i                                         (B_i: K×M)
//
// by Gauss–Jordan elimination with implicit partial pivoting.
//
// Replaces the Pallas kernel `_gj_solve_kernel` (entries
// `gauss_jordan_sweep_solve` and `pallas_reduced_sweep`) in
// morfem_tpu/ops/pallas/reduced_sweep.py. The TPU kernel vectorised one
// tile of 32 points across its vector lanes and extracted pivot rows with
// one-hot contractions, because Mosaic has no data-dependent row access.
// Here a warp (or, for large systems, a thread block) owns one point and
// reads the pivot row directly.
//
// The algebra is the reference's, step for step, so the pivots agree:
//   * the R's arrive pre-symmetrized in f32 (the wrapper does that, as the
//     reference does after its f32 cast);
//   * A = ((c0·R0 + c1·R1) + c2·R2) + diag, each product and sum rounded;
//   * the pivot of column j is the row with the largest
//     score = |a_rj|·(1 − used_r) − used_r, the lowest row index winning a
//     tie; a NaN score anywhere in the column gives the point a NaN
//     solution (the reference's max is NaN and its pivot set empty);
//   * row_a = a_p·(1/pivot), row_b = b_p·(1/pivot); every other row r
//     becomes a_r − a_rj·row_a (product and difference rounded separately,
//     as in the plain version: no contraction into FMAs);
//   * x_j = B_final[pivot row of column j].
// Columns ≤ j of A are never read again after step j, so each step
// updates only the columns right of j; the solution is the same, and the
// kernels equal the plain version bit for bit.
//
// What bounds it on this card. Per point K dependent column steps, each a
// pivot search across the rows and an O(K·(K−j)) update: at K = 40 the
// work is ~K³ ≈ 64 kflop per point, so neither bytes nor FLOPs bound it,
// but the chain of K steps does (latency).
//
// Two variants of the same function; the wrapper picks one from (K, M)
// alone (`sweep_variant` in ops/kernels/reduced_sweep.py):
//
// * Warp variant, K ≤ 64 and M ≤ 8 (the waveguide's reduced model: K = 40,
//   M = 2). One warp owns one point, 4 points per block. Lane l holds rows
//   l and l + 32 of A and B in registers; the kernel is templated on the
//   padded width KP (32, 40, 48, 64). A step is: a warp arg-max over the
//   lanes' scores in two reductions (`redux.sync`: the largest score, then
//   the lowest row holding it), the pivot value and then the pivot
//   row broadcast by shuffles from its owner lane, and each lane updating
//   its own rows. No shared memory and no barrier: the first version (one
//   256-thread block per point, A in shared memory, three __syncthreads
//   per step, one warp searching while seven waited) took ~2.5 µs per
//   column step. The column loop is NOT unrolled: fully unrolled (K
//   steps × K columns of straight-line code, ~180 KB at KP = 48) it took
//   0.84 ms at I = 10,000, likely fetching instructions more than
//   computing; this form takes a quarter of that. Instead
//   each step stores the live columns one place to the left, so the
//   pivot column is always register 0 and no register array is indexed
//   at run time; chunks of 8 columns past the live ones are skipped.
// * Block variant, K > 64 or M > 8: one 256-thread block per point, A
//   (row stride K|1 against bank conflicts), B and the step's pivot row
//   and column in shared memory (28 KB at K = 84); one warp searches the
//   pivot with shuffles, three block barriers per step. Its element loops
//   walk (row, column) pairs by increments: no integer division per
//   element.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 256;    // threads of the block variant
constexpr int WPB = 4;     // points (warps) per block of the warp variant
constexpr int MAXM = 8;    // right-hand sides the warp variant holds
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool better(float s, int i, float bs, int bi) {
  return s > bs || (s == bs && i < bi);
}

// an unsigned key that orders as the float does (for non-NaN values)
__device__ __forceinline__ unsigned order_key(float s) {
  const unsigned u = __float_as_uint(s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float score(float a, float u) {
  return __fsub_rn(__fmul_rn(fabsf(a), __fsub_rn(1.f, u)), u);
}

// ---------------------------------------------------------------- warp --

template <int KP>
__global__ void __launch_bounds__(WPB * 32)
gj_sweep_warp_kernel(const float* __restrict__ r0, const float* __restrict__ r1,
                     const float* __restrict__ r2, const float* __restrict__ c,
                     const float* __restrict__ rhs,
                     const float* __restrict__ diag, float* __restrict__ x,
                     int I, int K, int M) {
  constexpr int NR = (KP + 31) / 32;  // rows per lane
  constexpr int NCH = KP / 8;         // 8-column chunks of a row
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * WPB + (threadIdx.x >> 5);
  if (i >= I) return;  // a whole warp: no barrier follows
  const float c0 = c[3 * i], c1 = c[3 * i + 1], c2 = c[3 * i + 2];

  // a[q][d]: row lane + 32q, column j + d of the matrix at step j (the
  // live columns shift left by one per step, so the pivot column is
  // always d = 0 and every index below is a compile-time constant)
  float a[NR][KP], b[NR][MAXM], used[NR];
  int pivj[NR];  // pivj[q]: pivot row of column lane + 32q
#pragma unroll
  for (int q = 0; q < NR; ++q) {
    const int row = lane + 32 * q;
    used[q] = 0.f;
    pivj[q] = 0;
#pragma unroll
    for (int cc = 0; cc < KP; ++cc) {
      float v = 0.f;
      if (row < K && cc < K) {
        const int e = row * K + cc;
        v = __fadd_rn(__fadd_rn(__fmul_rn(c0, __ldg(r0 + e)),
                                __fmul_rn(c1, __ldg(r1 + e))),
                      __fmul_rn(c2, __ldg(r2 + e)));
        if (row == cc) v = __fadd_rn(v, __ldg(diag + row));
      }
      a[q][cc] = v;
    }
#pragma unroll
    for (int m = 0; m < MAXM; ++m)
      b[q][m] = (row < K && m < M) ? rhs[((size_t)i * K + row) * M + m] : 0.f;
  }

#pragma unroll 1
  for (int j = 0; j < K; ++j) {
    // pivot search: each lane's best row, then a shuffle arg-max
    float bs = -INFINITY;
    int bi = K;
    bool nan_seen = false;
#pragma unroll
    for (int q = 0; q < NR; ++q) {
      const int row = lane + 32 * q;
      if (row < K) {
        const float s = score(a[q][0], used[q]);
        nan_seen |= (s != s);
        if (better(s, row, bs, bi)) { bs = s; bi = row; }
      }
    }
    nan_seen = __any_sync(FULL, nan_seen);
    // warp arg-max in two reductions: the largest score (as an ordered
    // key; scores here are never NaN), then the lowest row holding it
    const unsigned key = order_key(bs);
    const unsigned top = __reduce_max_sync(FULL, key);
    bi = (int)__reduce_min_sync(FULL, key == top ? (unsigned)bi : (unsigned)K);
    const bool none = nan_seen || bi >= K;
    const int p = none ? K - 1 : bi;
    const int src = p & 31, hi = p >> 5;  // owner lane, and which of its rows
    float own = a[0][0];
#pragma unroll
    for (int q = 1; q < NR; ++q) if (hi == q) own = a[q][0];
    const float pv = __shfl_sync(FULL, own, src);
    // the correctly rounded reciprocal: 1.0f / pv bit for bit, inline
    const float inv = __frcp_rn(none ? __int_as_float(0x7fc00000) : pv);
    float col[NR];
    bool mine[NR];  // this lane's row q is the pivot row
#pragma unroll
    for (int q = 0; q < NR; ++q) {
      col[q] = a[q][0];
      mine[q] = lane + 32 * q == p;
      if (mine[q]) used[q] = 1.f;
      if (lane == (j & 31) && (j >> 5) == q) pivj[q] = p;
    }

    // live columns j+1 … K−1 sit at d = 1 … K−j−1: each is the pivot
    // row's entry, scaled, from its owner lane, then each lane's update,
    // stored one place to the left; chunks of 8 past the live ones are
    // skipped (a uniform branch)
    const int live = K - j - 1;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      if (8 * ch >= live) break;
      // the chunk's 8 shuffles first, so their latencies overlap
      float pr[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int d = 8 * ch + t + 1;
        if (d < KP) {
          float v = a[0][d];
#pragma unroll
          for (int q = 1; q < NR; ++q) if (hi == q) v = a[q][d];
          pr[t] = __shfl_sync(FULL, v, src);
        }
      }
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int d = 8 * ch + t + 1;
        if (d < KP) {
          const float ra = __fmul_rn(pr[t], inv);
#pragma unroll
          for (int q = 0; q < NR; ++q)
            a[q][d - 1] = mine[q]
                ? ra : __fsub_rn(a[q][d], __fmul_rn(col[q], ra));
        }
      }
    }
    float pb[MAXM];
#pragma unroll
    for (int m = 0; m < MAXM; ++m) {
      if (m >= M) break;
      float v = b[0][m];
#pragma unroll
      for (int q = 1; q < NR; ++q) if (hi == q) v = b[q][m];
      pb[m] = __shfl_sync(FULL, v, src);
    }
#pragma unroll
    for (int m = 0; m < MAXM; ++m) {
      if (m >= M) break;
      const float rb = __fmul_rn(pb[m], inv);
#pragma unroll
      for (int q = 0; q < NR; ++q)
        b[q][m] = mine[q] ? rb : __fsub_rn(b[q][m], __fmul_rn(rb, col[q]));
    }
  }

  // x_j = B_final[piv_j]: lane l writes columns l and l + 32
  float* xi = x + (size_t)i * K * M;
#pragma unroll
  for (int q = 0; q < NR; ++q) {
    const int jj = lane + 32 * q;
    const int src = pivj[q] & 31, hi = pivj[q] >> 5;
#pragma unroll
    for (int m = 0; m < MAXM; ++m) {
      if (m >= M) break;
      float v = 0.f;
#pragma unroll
      for (int h = 0; h < NR; ++h) {
        const float t = __shfl_sync(FULL, b[h][m], src);
        if (hi == h) v = t;
      }
      if (jj < K) xi[jj * M + m] = v;
    }
  }
}

// --------------------------------------------------------------- block --

__global__ void __launch_bounds__(NT)
gj_sweep_block_kernel(const float* __restrict__ r0,
                      const float* __restrict__ r1,
                      const float* __restrict__ r2, const float* __restrict__ c,
                      const float* __restrict__ rhs,
                      const float* __restrict__ diag, float* __restrict__ x,
                      int K, int M) {
  extern __shared__ float smem[];
  const int ld = K | 1;
  float* a = smem;              // K × ld
  float* b = a + K * ld;        // K × M
  float* rowa = b + K * M;      // K: scaled pivot row of A
  float* col = rowa + K;        // K: column j before the step
  float* rowb = col + K;        // M: scaled pivot row of B
  float* usedf = rowb + M;      // K: 1.0 where a row was a pivot
  int* piv = reinterpret_cast<int*>(usedf + K);  // K
  __shared__ int s_p;
  __shared__ float s_inv;

  const int i = blockIdx.x;
  const int tid = threadIdx.x;
  // flat element walks by increments: (row, column) of flat index tid,
  // advanced by NT = dr rows + dc columns per pass
  const int dr_k = NT / K, dc_k = NT - dr_k * K;
  const int dr_m = NT / M, dc_m = NT - dr_m * M;
  const int r_k0 = tid / K, c_k0 = tid - r_k0 * K;
  const int r_m0 = tid / M, c_m0 = tid - r_m0 * M;

  const float c0 = c[3 * i], c1 = c[3 * i + 1], c2 = c[3 * i + 2];
  for (int r = r_k0, cc = c_k0; r < K;) {
    const int e = r * K + cc;
    float v = __fadd_rn(__fadd_rn(__fmul_rn(c0, r0[e]), __fmul_rn(c1, r1[e])),
                        __fmul_rn(c2, r2[e]));
    if (r == cc) v = __fadd_rn(v, diag[r]);
    a[r * ld + cc] = v;
    r += dr_k;
    cc += dc_k;
    if (cc >= K) { cc -= K; ++r; }
  }
  const float* bi = rhs + (size_t)i * K * M;
  for (int e = tid; e < K * M; e += NT) b[e] = bi[e];
  for (int r = tid; r < K; r += NT) usedf[r] = 0.f;
  __syncthreads();

  for (int j = 0; j < K; ++j) {
    if (tid < 32) {
      float bs = -INFINITY;
      int bidx = K;
      bool nan_seen = false;
      for (int r = tid; r < K; r += 32) {
        const float s = score(a[r * ld + j], usedf[r]);
        nan_seen |= (s != s);
        if (better(s, r, bs, bidx)) { bs = s; bidx = r; }
      }
      nan_seen = __any_sync(FULL, nan_seen);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float os = __shfl_xor_sync(FULL, bs, off);
        const int oi = __shfl_xor_sync(FULL, bidx, off);
        if (better(os, oi, bs, bidx)) { bs = os; bidx = oi; }
      }
      if (tid == 0) {
        const bool none = nan_seen || bidx >= K;
        const int p = none ? K - 1 : bidx;
        const float pv = none ? __int_as_float(0x7fc00000) : a[p * ld + j];
        s_p = p;
        s_inv = 1.0f / pv;  // IEEE division (no fast-math)
        piv[j] = p;
        usedf[p] = 1.f;
      }
    }
    __syncthreads();
    const int p = s_p;
    const float inv = s_inv;
    for (int cc = j + 1 + tid; cc < K; cc += NT)
      rowa[cc] = __fmul_rn(a[p * ld + cc], inv);
    for (int r = tid; r < K; r += NT) col[r] = a[r * ld + j];
    for (int m = tid; m < M; m += NT) rowb[m] = __fmul_rn(b[p * M + m], inv);
    __syncthreads();
    const int w = K - j - 1;
    if (w > 0) {
      const int dr = NT / w, dc = NT - dr * w;  // one division per step
      for (int r = tid / w, cc = tid - (tid / w) * w; r < K;) {
        float* ar = a + r * ld + j + 1 + cc;
        *ar = (r == p) ? rowa[j + 1 + cc]
                       : __fsub_rn(*ar, __fmul_rn(col[r], rowa[j + 1 + cc]));
        r += dr;
        cc += dc;
        if (cc >= w) { cc -= w; ++r; }
      }
    }
    for (int r = r_m0, m = c_m0; r < K;) {
      float* br = b + r * M + m;
      *br = (r == p) ? rowb[m] : __fsub_rn(*br, __fmul_rn(rowb[m], col[r]));
      r += dr_m;
      m += dc_m;
      if (m >= M) { m -= M; ++r; }
    }
    __syncthreads();
  }
  float* xi = x + (size_t)i * K * M;
  for (int jj = r_m0, m = c_m0; jj < K;) {
    xi[jj * M + m] = b[piv[jj] * M + m];
    jj += dr_m;
    m += dc_m;
    if (m >= M) { m -= M; ++jj; }
  }
}

size_t block_smem_bytes(int K, int M) {
  const size_t ld = (size_t)(K | 1);
  return sizeof(float) * (K * ld + (size_t)K * M + 3 * (size_t)K + M) +
         sizeof(int) * (size_t)K;
}

}  // namespace

extern "C" int morfem_gj_sweep_warp(const float* r0, const float* r1,
                                    const float* r2, const float* c,
                                    const float* rhs, const float* diag,
                                    float* x, int I, int K, int M,
                                    void* stream) {
  if (I <= 0 || K <= 0 || K > 64 || M <= 0 || M > MAXM)
    return (int)cudaErrorInvalidValue;
  const int grid = (I + WPB - 1) / WPB;
  cudaStream_t st = (cudaStream_t)stream;
  if (K <= 32)
    gj_sweep_warp_kernel<32><<<grid, WPB * 32, 0, st>>>(r0, r1, r2, c, rhs,
                                                        diag, x, I, K, M);
  else if (K <= 40)
    gj_sweep_warp_kernel<40><<<grid, WPB * 32, 0, st>>>(r0, r1, r2, c, rhs,
                                                        diag, x, I, K, M);
  else if (K <= 48)
    gj_sweep_warp_kernel<48><<<grid, WPB * 32, 0, st>>>(r0, r1, r2, c, rhs,
                                                        diag, x, I, K, M);
  else
    gj_sweep_warp_kernel<64><<<grid, WPB * 32, 0, st>>>(r0, r1, r2, c, rhs,
                                                        diag, x, I, K, M);
  return (int)cudaGetLastError();
}

extern "C" int morfem_gj_sweep_block(const float* r0, const float* r1,
                                     const float* r2, const float* c,
                                     const float* rhs, const float* diag,
                                     float* x, int I, int K, int M,
                                     void* stream) {
  if (I <= 0 || K <= 0 || M <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = block_smem_bytes(K, M);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gj_sweep_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  gj_sweep_block_kernel<<<I, NT, smem, (cudaStream_t)stream>>>(
      r0, r1, r2, c, rhs, diag, x, K, M);
  return (int)cudaGetLastError();
}
