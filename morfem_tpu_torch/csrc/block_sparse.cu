// Block-sparse SpMM over packed nonzero row sectors: y = A·x, with the
// operator's nonzeros packed once into W-wide row sectors, W = 8
// (`pack_sectors` in ops/kernels/block_sparse.py):
//
//   y[r] = Σ_{s in row r}  Σ_{c < W}  vals[s][c] · x[cols[s] + c]
//
// where the sectors of row r are rowptr[r] … rowptr[r+1]−1, each starting
// at any absolute column (it may straddle a block edge or run past N; x is
// read as zero there). The function is the one of the stored blocks,
//
//   y[32·brow_k : +32] += blocks[k] · x[128·bcol_k : +128],
//
// because a sector holds every nonzero of its columns and nothing outside
// them is nonzero.
//
// Replaces the Pallas kernel `_bsr_kernel` (entry `bsr_matmul_pallas`) in
// morfem_tpu/ops/block_sparse.py, which walked the stored blocks as a
// sequential grid with the output block resident in VMEM.
//
// What bounds it on this card. Bytes: each value is used for 2·M flops
// (M ≤ 8), far below the card's ~20 flops per byte for FP32. On the Krylov
// pencil (N = 34,225, scattered far couplings) 98 % of the dense blocks'
// values are stored zeros (1.9 % fill), so the first version, which read
// every block whole (95 MB per call), lost to CSR SpMM. The union nonzeros
// (449,159) fit in 72,722 greedy 8-wide sectors, 2.3 MB of values: at that
// size the kernel sits on the launch-and-latency floor (~5 µs on the
// device, chip_smoke.py on an H100).
//
// Sector width W = 8: a sector of 8 f32 is one 32-byte DRAM sector (two
// float4 loads) and wastes few bytes, though a row of the 13-wide band
// takes 2–3 of them. A 16-wide packing covers such a row in one (38,501
// sectors, 2.5 MB) with fewer dependent steps per thread, but ran in the
// same ~5 µs on the H100, so only the narrower width, which reads fewer
// bytes, is built. Sectors start at the first column not yet covered in
// their row (greedy), not at multiples of 8: that cuts the count from
// 89,832 aligned sectors to 72,722.
//
// The design. One thread owns one row (a warp one 32-row block row):
// it walks its row's sectors in order, loads each sector's values as W/4
// float4 (every byte of a loaded DRAM sector is used), reads the W·M
// values of x it meets (contiguous in x's row-major [N, M] layout; x sits
// in L2) and accumulates the M outputs in registers with FMAs. Each output
// row is written once, by its owner: no atomics, and the summation order
// (sector by sector, column by column) is fixed, so the result is
// deterministic. M ≤ 8 per launch (the wrapper splits wider x); M is a
// template parameter, so the loops unroll.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128, MAXM = 8, W = 8;

template <int M>
__global__ void __launch_bounds__(NT)
sector_spmm_kernel(const float* __restrict__ vals, const int* __restrict__ cols,
                   const int* __restrict__ rowptr, const float* __restrict__ x,
                   float* __restrict__ y, int n) {
  const int row = blockIdx.x * NT + threadIdx.x;
  if (row >= n) return;
  float acc[M];
#pragma unroll
  for (int m = 0; m < M; ++m) acc[m] = 0.f;
  int s = rowptr[row];
  const int s1 = rowptr[row + 1];
  int c0 = s < s1 ? cols[s] : 0;
  for (; s < s1; ++s) {
    // the next sector's column now: its load overlaps this sector's
    const int c_next = s + 1 < s1 ? cols[s + 1] : 0;
    float v[W];
    const float4* vs = reinterpret_cast<const float4*>(vals + (int64_t)s * W);
#pragma unroll
    for (int q = 0; q < W / 4; ++q) {
      const float4 t = __ldg(vs + q);
      v[4 * q] = t.x; v[4 * q + 1] = t.y; v[4 * q + 2] = t.z; v[4 * q + 3] = t.w;
    }
    const float* xs = x + (int64_t)c0 * M;
    if (c0 + W <= n) {
#pragma unroll
      for (int c = 0; c < W; ++c)
#pragma unroll
        for (int m = 0; m < M; ++m) acc[m] = fmaf(v[c], __ldg(xs + c * M + m), acc[m]);
    } else {  // the last sector of a row may run past column N−1
#pragma unroll
      for (int c = 0; c < W; ++c)
        if (c0 + c < n)
#pragma unroll
          for (int m = 0; m < M; ++m) acc[m] = fmaf(v[c], __ldg(xs + c * M + m), acc[m]);
    }
    c0 = c_next;
  }
#pragma unroll
  for (int m = 0; m < M; ++m) y[(int64_t)row * M + m] = acc[m];
}

}  // namespace

extern "C" int morfem_bsr_spmm(const float* vals, const int* cols,
                               const int* rowptr, const float* x, float* y,
                               int n, int M, void* stream) {
  if (n <= 0 || M <= 0 || M > MAXM) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)vals % 16 != 0) return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  const int grid = (n + NT - 1) / NT;
#define MORFEM_SECTOR_CASE(MM)                                            \
  case MM:                                                                \
    sector_spmm_kernel<MM><<<grid, NT, 0, st>>>(vals, cols, rowptr, x, y, \
                                                n);                       \
    break;
  switch (M) {
    MORFEM_SECTOR_CASE(1) MORFEM_SECTOR_CASE(2) MORFEM_SECTOR_CASE(3)
    MORFEM_SECTOR_CASE(4) MORFEM_SECTOR_CASE(5) MORFEM_SECTOR_CASE(6)
    MORFEM_SECTOR_CASE(7) MORFEM_SECTOR_CASE(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef MORFEM_SECTOR_CASE
  return (int)cudaGetLastError();
}
