// Banded matvec in diagonal storage:
//
//   y[i, m] = Σ_{d=0}^{bw−1} band[i, d] · x[i + d − half, m]
//
// with x taken as zero outside [0, N).
//
// Replaces the Pallas kernel `_banded_matvec_kernel` (entry
// `banded_matvec_padded`) in morfem_tpu/ops/pallas/banded_matvec.py. The
// TPU kernel padded the band to 128 lanes and x to 8 sublanes and shifted
// a halo'd x tile once per diagonal; none of that padding is needed here.
//
// What bounds it on this card. Each band entry is read once and used once
// (2 flops per 4 bytes), so the kernel is bound by memory bandwidth: at
// N = 34,225, bw = 13, M = 2 it moves ~2.3 MB, ~0.7 µs at 3.35 TB/s, so
// in practice launch latency bounds it.
//
// What the simple design does about it. One block of 128 threads owns
// 128 consecutive rows, one thread per row (vectorised over rows, not over
// the 1–2 columns of x). The block stages its [128, bw] band tile
// (coalesced: consecutive rows are contiguous) and its [128 + bw − 1, M]
// halo of x in shared memory, row stride bw|1 against bank conflicts.
// Each thread accumulates the diagonals in the order d = 0 … bw−1,
// product and sum rounded separately (no FMA contraction), so the result
// equals the plain PyTorch version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;

__global__ void __launch_bounds__(TILE)
banded_matvec_kernel(const float* __restrict__ band, int64_t ld,
                     const float* __restrict__ x, float* __restrict__ y,
                     int N, int bw, int half, int M) {
  extern __shared__ float smem[];
  const int sld = bw | 1;
  float* sb = smem;               // TILE × sld
  float* sx = sb + TILE * sld;    // (TILE + bw − 1) × M
  const int i0 = blockIdx.x * TILE;
  const int rows = min(TILE, N - i0);
  for (int e = threadIdx.x; e < rows * bw; e += TILE) {
    const int r = e / bw, d = e - r * bw;
    sb[r * sld + d] = band[(int64_t)(i0 + r) * ld + d];
  }
  const int hx = rows + bw - 1;
  for (int e = threadIdx.x; e < hx * M; e += TILE) {
    const int r = e / M, m = e - r * M;
    const int gi = i0 - half + r;
    sx[e] = (gi >= 0 && gi < N) ? x[(int64_t)gi * M + m] : 0.f;
  }
  __syncthreads();
  const int r = threadIdx.x;
  if (r >= rows) return;
  for (int m = 0; m < M; ++m) {
    float acc = 0.f;
    for (int d = 0; d < bw; ++d)
      acc = __fadd_rn(acc, __fmul_rn(sb[r * sld + d], sx[(r + d) * M + m]));
    y[(int64_t)(i0 + r) * M + m] = acc;
  }
}

size_t smem_bytes(int bw, int M) {
  return sizeof(float) *
         ((size_t)TILE * (bw | 1) + (size_t)(TILE + bw - 1) * M);
}

}  // namespace

extern "C" int morfem_banded_matvec(const float* band, int64_t ld,
                                    const float* x, float* y, int N, int bw,
                                    int half, int M, void* stream) {
  if (N <= 0 || bw <= 0 || M <= 0 || half < 0 || ld < bw)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(bw, M);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        banded_matvec_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (N + TILE - 1) / TILE;
  banded_matvec_kernel<<<grid, TILE, smem, (cudaStream_t)stream>>>(
      band, ld, x, y, N, bw, half, M);
  return (int)cudaGetLastError();
}
