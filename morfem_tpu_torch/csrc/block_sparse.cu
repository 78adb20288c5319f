// Block-sparse (BSR) SpMM: y = A·x with A stored as dense 32×128 blocks on
// a sparse block grid, blocks sorted by block row:
//
//   y[32·brow_k : 32·brow_k + 32] += vals[k] · x[128·bcol_k : 128·bcol_k + 128]
//
// Replaces the Pallas kernel `_bsr_kernel` (entry `bsr_matmul_pallas`) in
// morfem_tpu/ops/block_sparse.py. The TPU kernel walked the stored blocks
// as a sequential grid, prefetching the block indices into SMEM and
// keeping the output block resident in VMEM across consecutive steps of
// one block row. Blocks on Hopper run in parallel in no order, so a row
// pointer array (computed once per operator on the host side) gives each
// thread block one whole block row instead: it accumulates all of that
// row's blocks in registers and writes its 32 output rows once, with no
// atomics, so the result is deterministic. A block row with no stored
// block writes zeros.
//
// What bounds it on this card. Each stored block is 16 KB of f32 values
// used for 2·32·128·M flops (M = 2: 1 flop per byte), so it is bound by
// memory bandwidth on the block values.
//
// What the simple design does about it. 128 threads (4 warps) per block
// row; warp w owns output rows w, w+4, …, w+28, and lane l the columns
// 4l … 4l+3 of every block, so each warp reads one 512-byte block row
// with one 16-byte load per lane (coalesced). The x segment of the current
// block is staged in shared memory as [M][128] and read as float4 (no bank
// conflicts). Each lane keeps partial sums for its 8 rows × M columns
// across all blocks of the row (FMAs, f32) and a warp shuffle reduction
// finishes them at the end. M ≤ 8 per launch; the wrapper splits wider x.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BR = 32, BC = 128, NT = 128, MAXM = 8, RPW = BR / (NT / 32);

__global__ void __launch_bounds__(NT)
bsr_spmm_kernel(const float* __restrict__ vals, const int* __restrict__ bcols,
                const int* __restrict__ rowptr, const float* __restrict__ x,
                float* __restrict__ y, int N, int M) {
  __shared__ __align__(16) float sx[MAXM * BC];
  const int brow = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[RPW][MAXM];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr)
#pragma unroll
    for (int m = 0; m < MAXM; ++m) acc[rr][m] = 0.f;

  const int k0 = rowptr[brow], k1 = rowptr[brow + 1];
  for (int k = k0; k < k1; ++k) {
    const int col0 = bcols[k] * BC;
    __syncthreads();  // the previous block's x segment is consumed
    for (int e = threadIdx.x; e < BC * M; e += NT) {
      const int cc = e / M, m = e - cc * M;
      const int gc = col0 + cc;
      sx[m * BC + cc] = gc < N ? x[(int64_t)gc * M + m] : 0.f;
    }
    __syncthreads();
    const float4* vb = reinterpret_cast<const float4*>(vals + (int64_t)k * BR * BC);
    float4 xs[MAXM];
#pragma unroll
    for (int m = 0; m < MAXM; ++m)
      if (m < M) xs[m] = reinterpret_cast<const float4*>(sx + m * BC)[lane];
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const float4 v = vb[(warp + 4 * rr) * (BC / 4) + lane];
#pragma unroll
      for (int m = 0; m < MAXM; ++m) {
        if (m < M) {
          float s = acc[rr][m];
          s = fmaf(v.x, xs[m].x, s);
          s = fmaf(v.y, xs[m].y, s);
          s = fmaf(v.z, xs[m].z, s);
          s = fmaf(v.w, xs[m].w, s);
          acc[rr][m] = s;
        }
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int row = brow * BR + warp + 4 * rr;
#pragma unroll
    for (int m = 0; m < MAXM; ++m) {
      if (m < M) {
        float s = acc[rr][m];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0 && row < N) y[(int64_t)row * M + m] = s;
      }
    }
  }
}

}  // namespace

extern "C" int morfem_bsr_spmm(const float* vals, const int* bcols,
                               const int* rowptr, const float* x, float* y,
                               int nbr, int N, int M, void* stream) {
  if (nbr <= 0 || N <= 0 || M <= 0 || M > MAXM)
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)vals % 16 != 0) return (int)cudaErrorMisalignedAddress;
  bsr_spmm_kernel<<<nbr, NT, 0, (cudaStream_t)stream>>>(vals, bcols, rowptr,
                                                        x, y, N, M);
  return (int)cudaGetLastError();
}
