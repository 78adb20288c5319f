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
// Here a thread block owns one point and reads the pivot row directly.
//
// The algebra is the reference's, step for step, so the pivots agree:
//   * the R's arrive pre-symmetrized in f32 (the wrapper does that, as the
//     reference does after its f32 cast);
//   * the pivot of column j is the row with the largest
//     score = |a_rj|·(1 − used_r) − used_r, the lowest row index winning a
//     tie;
//   * row_a = a_p·(1/pivot), row_b = b_p·(1/pivot); every other row r
//     becomes a_r − a_rj·row_a (product and difference rounded separately,
//     as in the plain version: no contraction into FMAs);
//   * x_j = B_final[pivot row of column j].
// Columns ≤ j of A are never read again after step j, so each step
// updates only the columns right of j; the solution is the same.
//
// What bounds it on this card. Per point K dependent column steps, each a
// block-wide pivot search and an O(K·(K−j)) update: at K ≈ 40 the work is
// ~K³ ≈ 64 kflop per point, so neither bytes nor FLOPs bound it, but the
// chain of K steps × 3 block barriers does (latency).
//
// What the simple design does about it. A (K×K, row stride K|1 against
// bank conflicts), B and the step's pivot row and column live in shared
// memory (28 KB at K = 84); 256 threads per block; one block per point, so
// I = 100 points fill 100 of 132 SMs and the 10,000-point serving grid
// runs ~8 waves of co-resident blocks. One warp does the pivot search
// with shuffles (K ≤ ~230 rows).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 256;

__device__ __forceinline__ bool better(float s, int i, float bs, int bi) {
  return s > bs || (s == bs && i < bi);
}

__global__ void __launch_bounds__(NT)
gj_sweep_kernel(const float* __restrict__ r0, const float* __restrict__ r1,
                const float* __restrict__ r2, const float* __restrict__ c,
                const float* __restrict__ rhs, const float* __restrict__ diag,
                float* __restrict__ x, int K, int M) {
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
  const float c0 = c[3 * i], c1 = c[3 * i + 1], c2 = c[3 * i + 2];
  for (int e = tid; e < K * K; e += NT) {
    const int r = e / K, cc = e - r * K;
    float v = __fadd_rn(__fadd_rn(__fmul_rn(c0, r0[e]), __fmul_rn(c1, r1[e])),
                        __fmul_rn(c2, r2[e]));
    if (r == cc) v = __fadd_rn(v, diag[r]);
    a[r * ld + cc] = v;
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
        const float u = usedf[r];
        const float s =
            __fsub_rn(__fmul_rn(fabsf(a[r * ld + j]), __fsub_rn(1.f, u)), u);
        nan_seen |= (s != s);
        if (better(s, r, bs, bidx)) { bs = s; bidx = r; }
      }
      nan_seen = __any_sync(0xffffffffu, nan_seen);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float os = __shfl_xor_sync(0xffffffffu, bs, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bidx, off);
        if (better(os, oi, bs, bidx)) { bs = os; bidx = oi; }
      }
      if (tid == 0) {
        // a NaN score makes the reference's max NaN and its pivot set
        // empty: the point's solution turns NaN, here as there
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
    for (int e = tid; e < K * w; e += NT) {
      const int r = e / w, cc = j + 1 + (e - r * w);
      float* ar = a + r * ld + cc;
      *ar = (r == p) ? rowa[cc] : __fsub_rn(*ar, __fmul_rn(col[r], rowa[cc]));
    }
    for (int e = tid; e < K * M; e += NT) {
      const int r = e / M, m = e - r * M;
      b[e] = (r == p) ? rowb[m] : __fsub_rn(b[e], __fmul_rn(rowb[m], col[r]));
    }
    __syncthreads();
  }
  float* xi = x + (size_t)i * K * M;
  for (int e = tid; e < K * M; e += NT) {
    const int jj = e / M, m = e - jj * M;
    xi[e] = b[piv[jj] * M + m];
  }
}

size_t smem_bytes(int K, int M) {
  const size_t ld = (size_t)(K | 1);
  return sizeof(float) * (K * ld + (size_t)K * M + 3 * (size_t)K + M) +
         sizeof(int) * (size_t)K;
}

}  // namespace

extern "C" int morfem_gj_sweep(const float* r0, const float* r1,
                               const float* r2, const float* c,
                               const float* rhs, const float* diag, float* x,
                               int I, int K, int M, void* stream) {
  if (I <= 0 || K <= 0 || M <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(K, M);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gj_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  gj_sweep_kernel<<<I, NT, smem, (cudaStream_t)stream>>>(r0, r1, r2, c, rhs,
                                                         diag, x, K, M);
  return (int)cudaGetLastError();
}
