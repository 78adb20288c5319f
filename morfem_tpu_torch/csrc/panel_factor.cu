// Masked partial-pivot factor of a batch of transposed panels (Hopper).
//
// Replaces the Pallas kernel `_panel_kernel` / `panel_factor` in
// morfem_tpu/ops/pallas/panel_factor.py. Same function: for each batch
// entry g the panel is held transposed, pt[P, Npl] (panel column k in row k,
// matrix row i in lane i); columns are eliminated left to right with partial
// pivoting over the rows still available, and rows are never swapped:
//   * pivot of column j = the available lane with the largest |pt[j, i]|,
//     the LOWEST lane index winning a tie (the reference's masked min over
//     the lanes that reach the max);
//   * multipliers l_i = pt[j, i] / pivot for available non-pivot lanes, 0
//     elsewhere; the elimination coefficients are c_j = -l;
//   * fac row j keeps the entry of used rows and of the pivot (U entries)
//     and stores l_i elsewhere;
//   * later panel columns k > j get pt[k, :] += pt[k, r] * c_j, and the
//     composed coefficient rows q < j get ct[q, :] += ct[q, r] * c_j, so
//     that ct holds C~ with "trailing += C~^T-weighted pivot rows";
//   * the pivot lane is marked used in the availability mask.
// The reference blocks the column steps by SUB=8 with rank-8 MXU updates;
// in exact arithmetic that is the same algebra as the unblocked sequence
// here (products and sums are rounded separately, like the plain PyTorch
// version in ops/kernels/panel_factor.py).
//
// What bounds it on this card. Per batch entry the work is a chain of P
// dependent column steps, each touching the whole [P, Npl] panel
// ((P-1)*Npl multiply-adds) after a block-wide max-reduction. The TPU kept
// the panel and C~ in VMEM; on Hopper they do not fit in shared memory
// ([128, 3456] f32 is 1.77 MB, [384, 384] is 590 KB, a block has at most
// 227 KB). So the panel and C~ live in device memory (in practice in the
// 50 MB L2, which holds all 8 panels of a chunk), and the kernel is bound
// by the L2 bandwidth of the SMs it runs on, and by its parallelism: one
// CTA per batch entry, i.e. 8 of 132 SMs at solve_chunk = 8.
//
// What the simple design does about it. Each thread owns a fixed set of
// lanes, so every update it makes is to addresses only it touches (the
// pivot lane, whose coefficient is 0, is skipped), and the loads along a
// panel row are coalesced. Only the current coefficient vector c_j and the
// availability mask sit in shared memory (2*Npl floats, sized at launch;
// the launcher refuses a panel whose mask does not fit). Spreading one
// panel over several CTAs (a cluster, or a split of the lanes) is the
// first thing a faster version would do.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ bool better(float s, int i, float bs, int bi) {
  return s > bs || (s == bs && i < bi);
}

constexpr int MAX_THREADS = 512;

__global__ void __launch_bounds__(MAX_THREADS)
panel_factor_kernel(const float* __restrict__ panel_t,
                    const float* __restrict__ avail_in, float* fac, float* ct,
                    int* piv, float* avail_out, int P, int Npl) {
  extern __shared__ float smem[];
  float* cvec = smem;        // [Npl] coefficients of the current column
  float* av = smem + Npl;    // [Npl] availability (1 = unused row)
  __shared__ float red_s[32];
  __shared__ int red_i[32];
  __shared__ int s_piv;

  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const int bs = blockDim.x;
  const int64_t off = (int64_t)g * P * Npl;
  const float* pin = panel_t + off;
  float* F = fac + off;
  float* C = ct + off;

  for (int64_t e = tid; e < (int64_t)P * Npl; e += bs) {
    F[e] = pin[e];
    C[e] = 0.f;
  }
  for (int i = tid; i < Npl; i += bs) av[i] = avail_in[(int64_t)g * Npl + i];
  __syncthreads();

  for (int j = 0; j < P; ++j) {
    const float* col = F + (int64_t)j * Npl;
    // pivot search: max score, lowest lane on ties
    float best = -CUDART_INF_F;
    int bi = 0x7fffffff;
    for (int i = tid; i < Npl; i += bs) {
      float a = av[i];
      float s = fabsf(col[i]) * a - (1.f - a);
      if (better(s, i, best, bi)) { best = s; bi = i; }
    }
    for (int o = 16; o > 0; o >>= 1) {
      float os = __shfl_down_sync(0xffffffffu, best, o);
      int oi = __shfl_down_sync(0xffffffffu, bi, o);
      if (better(os, oi, best, bi)) { best = os; bi = oi; }
    }
    const int warp = tid >> 5, lane = tid & 31, nwarps = (bs + 31) >> 5;
    if (lane == 0) { red_s[warp] = best; red_i[warp] = bi; }
    __syncthreads();
    if (warp == 0) {
      best = lane < nwarps ? red_s[lane] : -CUDART_INF_F;
      bi = lane < nwarps ? red_i[lane] : 0x7fffffff;
      for (int o = 16; o > 0; o >>= 1) {
        float os = __shfl_down_sync(0xffffffffu, best, o);
        int oi = __shfl_down_sync(0xffffffffu, bi, o);
        if (better(os, oi, best, bi)) { best = os; bi = oi; }
      }
      // a column of NaNs finds no maximum; keep the index in range
      if (lane == 0) s_piv = bi < Npl ? bi : 0;
    }
    __syncthreads();
    const int r = s_piv;
    const float inv = 1.f / col[r];

    // multipliers, coefficients and the factored row j
    float* frow = F + (int64_t)j * Npl;
    float* crow = C + (int64_t)j * Npl;
    for (int i = tid; i < Npl; i += bs) {
      float v = frow[i];
      bool keep = (av[i] == 0.f) || (i == r);
      float l = keep ? 0.f : v * inv;
      cvec[i] = -l;
      crow[i] = -l;
      frow[i] = keep ? v : l;
    }
    __syncthreads();
    if (tid == 0) {
      piv[(int64_t)g * P + j] = r;
      av[r] = 0.f;
    }
    // later panel columns and earlier coefficient rows, UNROLL rows at a
    // time so that their loads are in flight together (distinct rows never
    // alias; each thread touches only its own lanes)
    constexpr int UNROLL = 8;
    for (int k0 = 0; k0 < P; k0 += UNROLL) {
      float* rows[UNROLL];
      float pr[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        int k = k0 + u;
        bool valid = k < P && k != j;
        rows[u] = valid ? (k > j ? F : C) + (int64_t)k * Npl : nullptr;
        pr[u] = valid ? rows[u][r] : 0.f;
      }
      for (int i = tid; i < Npl; i += bs) {
        if (i == r) continue;
        const float cv = cvec[i];
        float v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) v[u] = rows[u] ? rows[u][i] : 0.f;
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          if (rows[u]) rows[u][i] = __fadd_rn(v[u], __fmul_rn(pr[u], cv));
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < Npl; i += bs) avail_out[(int64_t)g * Npl + i] = av[i];
}

}  // namespace

extern "C" int morfem_panel_factor(const float* panel_t, const float* avail,
                                   float* fac, float* ct, int* piv,
                                   float* avail_out, int G, int P, int Npl,
                                   void* stream) {
  if (G <= 0 || P <= 0 || Npl <= 0) return (int)cudaErrorInvalidValue;
  size_t smem = 2 * (size_t)Npl * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        panel_factor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int threads = ((Npl + 31) / 32) * 32;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  panel_factor_kernel<<<G, threads, smem, (cudaStream_t)stream>>>(
      panel_t, avail, fac, ct, piv, avail_out, P, Npl);
  return (int)cudaGetLastError();
}
