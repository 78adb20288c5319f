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
// What the simple design does about it. One CTA per (batch entry, group
// of 4 rows); its 256 threads walk along each row with 16-byte (float4)
// loads and stores when the row start and W allow it, else with 4-byte
// ones; neighbouring threads touch neighbouring addresses either way. The
// source may be a strided view (batch and row strides, unit column
// stride), so the panel LU gathers from trailing sub-blocks without a copy.
// An index outside [0, N) writes NaN rows rather than reading out of
// bounds.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 4, NT = 256;

__global__ void __launch_bounds__(NT)
gather_rows_kernel(const float* __restrict__ src, const int* __restrict__ idx,
                   float* __restrict__ out, int N, int P, int W,
                   int64_t s_sg, int64_t s_sn, bool vec4) {
  const int g = blockIdx.y;
  const int p0 = blockIdx.x * ROWS;
  for (int pp = 0; pp < ROWS; ++pp) {
    const int p = p0 + pp;
    if (p >= P) return;
    const int row = idx[(int64_t)g * P + p];
    float* o = out + ((int64_t)g * P + p) * W;
    if (row < 0 || row >= N) {
      for (int w = threadIdx.x; w < W; w += NT) o[w] = CUDART_NAN_F;
      continue;
    }
    const float* s = src + (int64_t)g * s_sg + (int64_t)row * s_sn;
    if (vec4) {
      const float4* s4 = reinterpret_cast<const float4*>(s);
      float4* o4 = reinterpret_cast<float4*>(o);
      for (int w = threadIdx.x; w < W / 4; w += NT) o4[w] = s4[w];
    } else {
      for (int w = threadIdx.x; w < W; w += NT) o[w] = s[w];
    }
  }
}

}  // namespace

extern "C" int morfem_gather_rows(const float* src, const int* idx, float* out,
                                  int G, int N, int P, int W, int64_t s_sg,
                                  int64_t s_sn, void* stream) {
  if (G <= 0 || P <= 0 || W <= 0 || G > 65535)
    return (int)cudaErrorInvalidValue;
  bool vec4 = (W % 4 == 0) && (s_sg % 4 == 0) && (s_sn % 4 == 0) &&
              ((uintptr_t)src % 16 == 0) && ((uintptr_t)out % 16 == 0);
  dim3 grid((P + ROWS - 1) / ROWS, G);
  gather_rows_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      src, idx, out, N, P, W, s_sg, s_sn, vec4);
  return (int)cudaGetLastError();
}
