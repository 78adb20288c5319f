// Batched row gather out[g, p, :] = src[g, idx[g, p], :].
//
// Replaces the Pallas kernel `_gather_kernel` / `gather_rows` in
// morfem_tpu/ops/pallas/row_gather.py. The TPU kernel fetched the 8-row
// aligned group holding each requested row (Mosaic cannot DMA a single row
// of an (8, 128)-tiled buffer) and selected the row with a 0/1 mask-sum.
// Device memory on Hopper has no such tiling: a row is a contiguous run of
// W floats and is copied as it is.
//
// What bounds it on this card. A gather does no arithmetic: it reads each
// requested row once and writes it once, so it is bound by memory
// bandwidth (3.35 TB/s), in practice by L2 when the panel-LU source block
// is resident there.
//
// Design. One CTA per (batch entry, group of 4 rows); its 256 threads walk
// along each row with 16-byte (float4) loads and stores when the row
// starts and W allow it, else with 4-byte ones; neighbouring threads touch
// neighbouring addresses either way. This runs at 76 % of the bound at the
// block-pivot LU's 384 rows and 87 % at 3456 rows on an H100; a copy-engine
// design (`cp.async.bulk` rows through a shared-memory ring on a
// persistent grid) ran 2-10 % slower at those shapes and was dropped
// (PERF.md, Findings). The source may be a strided view (batch and row
// strides, unit column stride), so the panel LU gathers from trailing
// sub-blocks without a copy. The indices are read in the caller's type
// (int32 or int64, a template parameter) at their own strides, so the
// wrapper launches no cast. An index outside [0, N) writes a NaN row
// rather than reading out of bounds. Any batch: the batch entry is the
// grid's y index, which holds at most 65,535, so the entry point launches
// once per 65,535 entries, on pointers offset to each launch's first one.

#include <algorithm>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 4, NT = 256;
constexpr int MAX_BATCH = 65535;  // the grid's y limit: entries a launch

template <typename Idx>
__global__ void __launch_bounds__(NT)
gather_rows_kernel(const float* __restrict__ src, const Idx* __restrict__ idx,
                   float* __restrict__ out, int N, int P, int W, int64_t s_sg,
                   int64_t s_sn, int64_t s_ig, int64_t s_ip, bool vec4) {
  const int g = blockIdx.y;
  const int p0 = blockIdx.x * ROWS;
  for (int pp = 0; pp < ROWS; ++pp) {
    const int p = p0 + pp;
    if (p >= P) return;
    const int64_t row = (int64_t)idx[g * s_ig + p * s_ip];
    float* o = out + ((int64_t)g * P + p) * W;
    if (row < 0 || row >= N) {
      for (int w = threadIdx.x; w < W; w += NT) o[w] = CUDART_NAN_F;
      continue;
    }
    const float* s = src + g * s_sg + row * s_sn;
    if (vec4) {
      const float4* s4 = reinterpret_cast<const float4*>(s);
      float4* o4 = reinterpret_cast<float4*>(o);
      for (int w = threadIdx.x; w < W / 4; w += NT) o4[w] = s4[w];
    } else {
      for (int w = threadIdx.x; w < W; w += NT) o[w] = s[w];
    }
  }
}

template <typename Idx>
int launch(const float* src, const Idx* idx, float* out, int G, int N, int P,
           int W, int64_t s_sg, int64_t s_sn, int64_t s_ig, int64_t s_ip,
           cudaStream_t stream) {
  const bool vec4 = (W % 4 == 0) && (s_sg % 4 == 0) && (s_sn % 4 == 0) &&
                    ((uintptr_t)src % 16 == 0) && ((uintptr_t)out % 16 == 0);
  for (int g0 = 0; g0 < G; g0 += MAX_BATCH) {
    dim3 grid((P + ROWS - 1) / ROWS, std::min(G - g0, MAX_BATCH));
    gather_rows_kernel<Idx><<<grid, NT, 0, stream>>>(
        src + g0 * s_sg, idx + g0 * s_ig, out + (int64_t)g0 * P * W, N, P, W,
        s_sg, s_sn, s_ig, s_ip, vec4);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// idx_bytes: 4 for int32 indices, 8 for int64
extern "C" int morfem_gather_rows(const float* src, const void* idx,
                                  int idx_bytes, float* out, int G, int N,
                                  int P, int W, int64_t s_sg, int64_t s_sn,
                                  int64_t s_ig, int64_t s_ip, void* stream) {
  if (G <= 0 || P <= 0 || W <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (idx_bytes == 4)
    return launch(src, static_cast<const int32_t*>(idx), out, G, N, P, W,
                  s_sg, s_sn, s_ig, s_ip, st);
  if (idx_bytes == 8)
    return launch(src, static_cast<const int64_t*>(idx), out, G, N, P, W,
                  s_sg, s_sn, s_ig, s_ip, st);
  return (int)cudaErrorInvalidValue;
}
