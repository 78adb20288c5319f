// Batched f32-true GEMM with the addend and sign fused: out = t + sign*(c@r).
//
// Replaces the Pallas kernel `_mm_kernel` / `mm_words` in
// morfem_tpu/ops/pallas/fused_mm.py. The TPU kernel realised an f32-true
// product as `words`-word bf16 splits on the MXU; here every product is a
// plain FP32 fused multiply-add on the CUDA cores, which is f32-true for
// any `words` (no TF32: it keeps about 3 decimal digits and would break the
// refinement contraction the panel LU relies on).
//
// What bounds it on this card. The panel-LU trailing updates are
// [8, W, K] @ [8, K, W] with K = 128 (full pivot) or 384 (block pivot) and
// W up to 3456: 2*K FLOPs per output element against 4-12 bytes of
// addend and output traffic, so at these shapes the FP32 rate (67 TFLOP/s
// on the CUDA cores) bounds it, not the 3.35 TB/s of device memory.
//
// What the simple design does about it. A classic SIMT tiling: a CTA of
// 256 threads computes a 64x64 output tile, staging 64x16 tiles of c and
// 16x64 tiles of r in shared memory; each thread keeps a 4x4 register
// accumulator (rows ty+16i, columns tx+16j, so shared reads are broadcast
// or conflict-free and the epilogue's stores are coalesced). The addend is
// read and the output written once, in the epilogue. Ragged M, N and K are
// masked; operands may be strided views (each with its own three strides),
// which lets the panel LU pass transposes and trailing sub-blocks without
// copies. Tensor cores (3xTF32 or DMMA f64) and TMA pipelining are for a
// later version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 16, NT = 256;

template <bool HAS_T>
__global__ void __launch_bounds__(NT)
mm_kernel(const float* __restrict__ c, const float* __restrict__ r,
          const float* __restrict__ t, float* __restrict__ out, int M, int N,
          int K, int64_t c_sg, int64_t c_sm, int64_t c_sk, int64_t r_sg,
          int64_t r_sk, int64_t r_sn, int64_t t_sg, int64_t t_sm,
          int64_t t_sn, float sign) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN + 4];
  const int g = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* cg = c + (int64_t)g * c_sg;
  const float* rg = r + (int64_t)g * r_sg;
  const bool c_krow = (c_sk == 1);  // k is the unit-stride axis of c
  const bool r_nrow = (r_sn == 1);  // n is the unit-stride axis of r

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      int idx = tid + NT * e;
      int kk = c_krow ? (idx & (BK - 1)) : (idx / BM);
      int mm = c_krow ? (idx / BK) : (idx & (BM - 1));
      int gm = m0 + mm, gk = k0 + kk;
      As[kk][mm] = (gm < M && gk < K) ? cg[gm * c_sm + gk * c_sk] : 0.f;
      kk = r_nrow ? (idx / BN) : (idx & (BK - 1));
      int nn = r_nrow ? (idx & (BN - 1)) : (idx / BK);
      int gn = n0 + nn;
      gk = k0 + kk;
      Bs[kk][nn] = (gn < N && gk < K) ? rg[gk * r_sk + gn * r_sn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* og = out + (int64_t)g * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int gn = n0 + tx + 16 * j;
      if (gn >= N) continue;
      float v = sign * acc[i][j];
      if (HAS_T) v = t[(int64_t)g * t_sg + gm * t_sm + gn * t_sn] + v;
      og[(int64_t)gm * N + gn] = v;
    }
  }
}

}  // namespace

extern "C" int morfem_mm_f32(const float* c, const float* r, const float* t,
                             float* out, int G, int M, int N, int K,
                             int64_t c_sg, int64_t c_sm, int64_t c_sk,
                             int64_t r_sg, int64_t r_sk, int64_t r_sn,
                             int64_t t_sg, int64_t t_sm, int64_t t_sn,
                             float sign, void* stream) {
  if (G <= 0 || M <= 0 || N <= 0 || K < 0 || G > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, G);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (t != nullptr)
    mm_kernel<true><<<grid, NT, 0, s>>>(c, r, t, out, M, N, K, c_sg, c_sm,
                                        c_sk, r_sg, r_sk, r_sn, t_sg, t_sm,
                                        t_sn, sign);
  else
    mm_kernel<false><<<grid, NT, 0, s>>>(c, r, t, out, M, N, K, c_sg, c_sm,
                                         c_sk, r_sg, r_sk, r_sn, 0, 0, 0,
                                         sign);
  return (int)cudaGetLastError();
}
