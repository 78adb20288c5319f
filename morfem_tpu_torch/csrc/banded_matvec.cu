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
// N = 34,225, bw = 13, M = 2 it moves ~2.3 MB, ~0.7 µs at 3.35 TB/s, which
// is below what one launch costs (~2 µs on the device); so latency bounds
// it. The first version (one CTA per 128 rows that staged its band tile
// with one integer division per element, then summed) took ~4.9 µs on the
// device, and the Krylov loop's float64 x cost two more launches (casts).
//
// Design.
// * One 128-thread CTA per 128-row tile. Thread 0 fetches the tile's band
//   (one contiguous run of 128·bw floats when the band is unpadded,
//   ld == bw) and the 16-byte aligned middle of its x halo (one contiguous
//   run of (128 + bw − 1)·M values) by `cp.async.bulk` into shared memory,
//   completing on one mbarrier; meanwhile the threads load the halo's
//   < 16-byte ends. Loads and sums overlap across the CTAs resident on an
//   SM (up to 16 at the Krylov shape), not within one: a CTA that walked
//   two tiles with a second stage took 8.5 µs at N = 34,225 against 4.3 µs
//   for one tile per CTA on an H100 (PERF.md, Findings). Rows outside [0, N)
//   are masked. A padded band (ld > bw) or a ragged last tile whose band
//   is no multiple of 16 bytes is read by each thread from device memory
//   (its own row, no division).
// * x is read in its own type (float or double, a template parameter): a
//   double is rounded on load with __double2float_rn, as x.to(float32)
//   rounds it; y is written as float or double (exact), as .to(dtype)
//   writes it. So one launch serves the float64 Krylov loop.
// * One thread per row accumulates the diagonals in the order
//   d = 0 … bw−1, product and sum rounded separately (no FMA
//   contraction): the result equals the plain PyTorch version bit for bit.
//   The band tile is read at row stride bw, odd, so without bank conflicts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;
constexpr int MAX_SMEM = 232448;  // what one block may take on Hopper
constexpr int BAR = 16;  // bytes in front of the band tile (the mbarrier)

// Hopper bulk asynchronous copies (the copy engine that TMA drives, without
// a tensor map) and the mbarrier that reports their arrival. `bulk_g2s`
// copies `bytes` (a multiple of 16, both addresses 16-byte aligned) into
// shared memory and counts them against the barrier's expected transaction
// bytes (`mbar_expect_tx`, one arrival); `mbar_wait` returns once the phase
// of the given parity has completed, so the bytes are there.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
  // make the initialised barrier visible to the copy engine
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src,
                                         uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(double v) {
  return __double2float_rn(v);
}

template <typename XT, typename YT>
__global__ void __launch_bounds__(TILE)
banded_matvec_kernel(const float* __restrict__ band, int64_t ld,
                     const XT* __restrict__ x, YT* __restrict__ y, int N,
                     int bw, int half, int M, int x_off, bool band_bulk) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t bar = smem_addr(smem);
  unsigned char* sband = smem + BAR;
  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * TILE;
  const int rows = min(TILE, N - i0);
  const bool bulk_band = band_bulk && (rows * bw) % 4 == 0;
  // the halo: x rows [lo, hi) are bytes [xa, xb) of x; its bulk part is
  // [a16, b16) (empty when b16 <= a16); shared byte x_off is x byte base
  const int lo = max(0, i0 - half), hi = min(N, i0 + rows + half);
  const uintptr_t x0 = reinterpret_cast<uintptr_t>(x);
  const uintptr_t xa = x0 + (uintptr_t)lo * M * sizeof(XT);
  const uintptr_t xb = x0 + (uintptr_t)hi * M * sizeof(XT);
  const uintptr_t a16 = (xa + 15) & ~(uintptr_t)15;
  const uintptr_t b16 = xb & ~(uintptr_t)15;
  const uintptr_t base = xa & ~(uintptr_t)15;
  unsigned char* sx = smem + x_off;
  if (tid == 0) mbar_init(bar, 1);
  __syncthreads();
  if (tid == 0) {
    const uint32_t band_b = bulk_band ? rows * bw * 4 : 0;
    const uint32_t x_b = b16 > a16 ? (uint32_t)(b16 - a16) : 0;
    mbar_expect_tx(bar, band_b + x_b);
    if (band_b)
      bulk_g2s(smem_addr(sband), band + (int64_t)i0 * bw, band_b, bar);
    if (x_b)
      bulk_g2s(smem_addr(sx + (a16 - base)),
               reinterpret_cast<const void*>(a16), x_b, bar);
  }
  // the halo's ends (or all of it, when it has no aligned middle)
  const uintptr_t head_end = b16 > a16 ? a16 : xb;
  for (uintptr_t e = xa + tid * sizeof(XT); e < head_end;
       e += TILE * sizeof(XT))
    *reinterpret_cast<XT*>(sx + (e - base)) = *reinterpret_cast<const XT*>(e);
  if (b16 > a16) {
    for (uintptr_t e = b16 + tid * sizeof(XT); e < xb; e += TILE * sizeof(XT))
      *reinterpret_cast<XT*>(sx + (e - base)) =
          *reinterpret_cast<const XT*>(e);
  }
  mbar_wait(bar, 0);
  __syncthreads();
  if (tid >= rows) return;

  const int i = i0 + tid;
  const float* brow = bulk_band
                          ? reinterpret_cast<const float*>(sband) + tid * bw
                          : band + (int64_t)i * ld;
  // x[i − half + d, m] is xr[d·M + m]; rows outside [0, N) are the
  // diagonals d < dlo and d >= dhi (read as zero, never loaded)
  const XT* xr = reinterpret_cast<const XT*>(
      sx + ((intptr_t)x0 - (intptr_t)base) +
      (intptr_t)(i - half) * M * (intptr_t)sizeof(XT));
  const int dlo = max(0, half - i), dhi = min(bw, N - i + half);
  for (int m = 0; m < M; ++m) {
    float acc = 0.f;
#pragma unroll 4
    for (int d = 0; d < bw; ++d) {
      const float xv = d >= dlo && d < dhi ? to_f32(xr[d * M + m]) : 0.f;
      acc = __fadd_rn(acc, __fmul_rn(brow[d], xv));
    }
    y[(int64_t)i * M + m] = (YT)acc;
  }
}

template <typename XT, typename YT>
int launch(const float* band, int64_t ld, const XT* x, YT* y, int N, int bw,
           int half, int M, cudaStream_t stream) {
  const int band_bytes = (TILE * bw * 4 + 15) / 16 * 16;
  // the halo plus up to 15 bytes in front (its start rounded down to 16)
  const int64_t x_bytes =
      ((int64_t)(TILE + bw - 1) * M * (int64_t)sizeof(XT) + 16 + 15) / 16 * 16;
  const int64_t smem = BAR + band_bytes + x_bytes;
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        banded_matvec_kernel<XT, YT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (N + TILE - 1) / TILE;
  const bool band_bulk = ld == bw && (uintptr_t)band % 16 == 0;
  banded_matvec_kernel<XT, YT><<<grid, TILE, (int)smem, stream>>>(
      band, ld, x, y, N, bw, half, M, BAR + band_bytes, band_bulk);
  return (int)cudaGetLastError();
}

}  // namespace

// x_bytes / y_bytes: 4 for float32, 8 for float64
extern "C" int morfem_banded_matvec(const float* band, int64_t ld,
                                    const void* x, int x_bytes, void* y,
                                    int y_bytes, int N, int bw, int half,
                                    int M, void* stream) {
  if (N <= 0 || bw <= 0 || M <= 0 || half < 0 || ld < bw)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (x_bytes == 4 && y_bytes == 4)
    return launch(band, ld, (const float*)x, (float*)y, N, bw, half, M, st);
  if (x_bytes == 4 && y_bytes == 8)
    return launch(band, ld, (const float*)x, (double*)y, N, bw, half, M, st);
  if (x_bytes == 8 && y_bytes == 4)
    return launch(band, ld, (const double*)x, (float*)y, N, bw, half, M, st);
  if (x_bytes == 8 && y_bytes == 8)
    return launch(band, ld, (const double*)x, (double*)y, N, bw, half, M, st);
  return (int)cudaErrorInvalidValue;
}
