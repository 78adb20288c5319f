// f32-true batched GEMM out = t + sign*(c@r) as a bf16-word tensor-core product.
//
// Replaces the Pallas kernel `_mm_kernel` / `mm_words` in
// morfem_tpu/ops/pallas/fused_mm.py, and computes the same function the
// same way: each f32 operand is split exactly into three bf16 words
// (x = x0 + x1 + x2, `_split_words`' rounding: add 0x8000 to the bit
// pattern, mask the low 16 bits, NaN words stay NaN), and the six word
// products of weight >= 2^-16 are accumulated in f32, smallest weight
// first: (c0 r2, c1 r1, c2 r0), then (c0 r1, c1 r0), then c0 r0. Each word
// product is exact in f32, so the result is f32-true (~1e-7 relative),
// without TF32 (which would stall the f64 refinement around the factors).
//
// What bounds it on this card. The panel-LU trailing updates are
// [8, W, K] @ [8, K, W] with K = 384 (block pivot) or 128 (full pivot) and
// W up to 3456. On an H100 SXM (published peaks at its 700 W limit) an
// f32-true product on the CUDA cores is capped at the 67 TFLOP/s FP32
// rate; here it runs on the bf16 tensor cores (989 TFLOP/s dense), six
// passes: 6 * 2*M*N*K operations, 0.352 ms at [8,3072,384]@[8,384,3072].
// The addend read and the output write (2 * 4*M*N bytes) come next.
//
// Design.
// * Split pass (`split_words_kernel`): reads an f32 operand at its own
//   three strides (the transposed coefficient view and the trailing
//   sub-block views need no copy) through a 32x32 shared-memory tile, and
//   writes three K-major bf16 word planes [3, G, R, Kp], Kp = K rounded up
//   to 64 with zeros, so every row stride is a multiple of 16 bytes as TMA
//   requires and no K tile is ragged.
// * GEMM (`mm_words_kernel`): one CTA per 128x128 output tile, two consumer
//   warpgroups of 64 rows each and one producer warp. A ring of 2 shared-
//   memory stages, each holding one 64-wide K slice of all three words of
//   both operands (6 TMA boxes of 128 rows x 128 bytes, 128-byte swizzle),
//   is filled by TMA and drained by `wgmma.mma_async` m64n128k16 (bf16 in,
//   f32 accumulators in registers), with full/empty mbarriers per stage.
//   Ragged M and N rows are zero-filled by TMA and masked in the epilogue,
//   which reads the addend at its strides and writes the output once.
// * Accumulation. The tensor cores do not round their accumulator to
//   nearest; chained over the 6 pairs x K/16 steps (144 at K = 384), the
//   error grew past an FP32 product's, and the f64 refinement around the
//   panel LU needed more iterations and escalated chunks (PERF.md). So
//   each 16-wide K step's six products start a fresh partial (scale-d =
//   0), which is added to an FP32 master with round-to-nearest, as an FMA
//   loop would; chip_smoke.py checks that the result is no farther from
//   the exact product than cuBLAS's FP32 one.
// * Any batch. The batch entry is the grid's z index, which holds at most
//   65,535, so each entry point launches once per 65,535 entries: the
//   split pass on pointers offset to the launch's first entry (its planes
//   stay one [3, G, R, Kp] buffer: the plane stride is the whole G's), the
//   GEMM told that entry, g0, for its coordinates in the one tensor map
//   over all G.

#include <algorithm>
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// split pass

constexpr int MAX_BATCH = 65535;  // the grid's z limit: entries a launch
constexpr int ST = 32;  // tile side of the split pass

// subnormals to a zero of their sign, as the reference's arithmetic does
// (the TPU and XLA on the CPU flush them); NaN passes
__device__ __forceinline__ float flush(float v) {
  return fabsf(v) < 1.17549435e-38f ? copysignf(0.f, v) : v;
}

// one word of x and the exact residual x - word
__device__ __forceinline__ float split_step(float x, uint16_t* word) {
  uint32_t bits = __float_as_uint(x);
  uint32_t h = (bits + 0x8000u) & 0xFFFF0000u;
  if (isnan(x)) {  // +0x8000 could carry a NaN payload into the sign bit
    *word = (uint16_t)(((bits >> 16) & 0x8000u) | 0x7FC0u);
    return __fsub_rn(x, x);
  }
  *word = (uint16_t)(h >> 16);
  return flush(__fsub_rn(flush(x), flush(__uint_as_float(h))));
}

// x[g, r, k] at strides (sg, sr, sk) -> out[w, g, r, k] (K-major, row
// length Kp, zero for K <= k < Kp)
__global__ void __launch_bounds__(ST * 8)
split_words_kernel(const float* __restrict__ x, uint16_t* __restrict__ out,
                   int G, int R, int K, int Kp, int64_t sg, int64_t sr,
                   int64_t sk) {
  __shared__ float tile[ST][ST + 1];  // [r][k]
  const int g = blockIdx.z;
  const int r0 = blockIdx.y * ST, k0 = blockIdx.x * ST;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const float* xg = x + (int64_t)g * sg;
  const bool k_fast = (sk == 1);  // coalesce the load along k, else along r
  for (int a = ty; a < ST; a += 8) {
    int rr = k_fast ? a : tx, kk = k_fast ? tx : a;
    int gr = r0 + rr, gk = k0 + kk;
    tile[rr][kk] = (gr < R && gk < K) ? xg[gr * sr + gk * sk] : 0.f;
  }
  __syncthreads();
  const int64_t plane = (int64_t)G * R * Kp;
  for (int rr = ty; rr < ST; rr += 8) {
    int gr = r0 + rr, gk = k0 + tx;
    if (gr >= R || gk >= Kp) continue;
    float v = tile[rr][tx];
    int64_t o = ((int64_t)g * R + gr) * Kp + gk;
    uint16_t w;
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      v = split_step(v, &w);
      out[p * plane + o] = w;
    }
  }
}

// ---------------------------------------------------------------------------
// GEMM

constexpr int BM = 128, BN = 128, BK = 64, STAGES = 2;
constexpr int TILE_BYTES = BM * BK * 2;  // one word box of A or B (16 KB)
constexpr int STAGE_BYTES = 6 * TILE_BYTES;
constexpr int CONSUMERS = 256;           // two warpgroups
constexpr int THREADS = CONSUMERS + 32;  // + one producer warp
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024 + 64;

// the six word pairs (c word, r word), smallest weight first
__device__ __forceinline__ constexpr int pair_a(int p) {
  return p == 1 ? 1 : p == 2 ? 2 : p == 4 ? 1 : 0;
}
__device__ __forceinline__ constexpr int pair_b(int p) {
  return p == 0 ? 2 : p == 1 ? 1 : p == 3 ? 1 : 0;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// K-major operand, 128-byte swizzle: 8-row atoms of 1024 bytes (SBO), the
// leading offset unused (1); k16 steps advance the start address by 32 B
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d = (scale_d ? d : 0) + A·B for one m64n128k16 step (bf16 in, f32 out)
__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The six word products of the 16-wide K step kk of stage `st` for
// warpgroup wg's 64 rows, smallest weight first, into p (from zero).
__device__ __forceinline__ void k16_products(float* p, uint32_t st, int wg,
                                             int kk) {
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    const uint32_t a = st + pair_a(q) * TILE_BYTES + wg * 64 * 128 + 32 * kk;
    const uint32_t b = st + (3 + pair_b(q)) * TILE_BYTES + 32 * kk;
    wgmma_m64n128k16(p, sw128_desc(a), sw128_desc(b), q > 0);
  }
}

template <bool HAS_T>
__global__ void __launch_bounds__(THREADS)
mm_words_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b,
                const float* __restrict__ t, float* __restrict__ out, int G,
                int M, int N, int Kp, int64_t t_sg, int64_t t_sm,
                int64_t t_sn, float sign, int g0) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // stage buffers 1024-byte aligned (the swizzle atom), barriers after them
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + STAGES * STAGE_BYTES);
  const uint32_t full0 = smem_addr(bars), empty0 = smem_addr(bars + STAGES);
  const uint32_t tiles = smem_addr(base);

  const int g = g0 + blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = Kp / BK;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // producer warp: one thread keeps the ring full
    if (tid == CONSUMERS) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(empty0 + 8 * s, ((kt / STAGES) - 1) & 1);
        const uint32_t bar = full0 + 8 * s;
        mbar_expect_tx(bar, STAGE_BYTES);
        const uint32_t st = tiles + s * STAGE_BYTES;
        for (int w = 0; w < 3; ++w) {
          tma_load_3d(st + w * TILE_BYTES, &map_a, bar, kt * BK, m0,
                      w * G + g);
          tma_load_3d(st + (3 + w) * TILE_BYTES, &map_b, bar, kt * BK, n0,
                      w * G + g);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns output rows m0 + 64*wg .. +63
  const int wg = tid / 128;
  // Each 16-wide K step's six products go into a fresh partial p, which
  // is added into the master m with round-to-nearest FP32 adds: no wgmma
  // accumulation chain is longer than one K step (see the header).
  float p[64], m[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) m[i] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(full0 + 8 * s, (kt / STAGES) & 1);
    const uint32_t st = tiles + s * STAGE_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
      k16_products(p, st, wg, kk);
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
      for (int i = 0; i < 64; ++i) m[i] = __fadd_rn(m[i], p[i]);
    }
    mbar_arrive(empty0 + 8 * s);
  }

  // epilogue: accumulator fragment of m64n128 -> rows, columns
  const int wt = tid % 128, warp = wt / 32, lane = wt % 32;
  const int row = m0 + wg * 64 + warp * 16 + lane / 4;
  float* og = out + (int64_t)g * M * N;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = n0 + j * 8 + (lane % 4) * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = row + 8 * h;
      if (gm >= M) continue;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int gn = col + c;
        if (gn >= N) continue;
        float v = sign * m[4 * j + 2 * h + c];
        if (HAS_T) v = t[(int64_t)g * t_sg + gm * t_sm + gn * t_sn] + v;
        og[(int64_t)gm * N + gn] = v;
      }
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point (no link
// against libcuda)
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
  }
  return fn;
}

// word planes [3, G, R, Kp] bf16 as a 3-D map (Kp, R, 3G), box 64 x 128 x 1
bool word_map(CUtensorMap* map, const void* planes, int G, int R, int Kp) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t dims[3] = {(cuuint64_t)Kp, (cuuint64_t)R, (cuuint64_t)3 * G};
  cuuint64_t strides[2] = {(cuuint64_t)Kp * 2, (cuuint64_t)R * Kp * 2};
  cuuint32_t box[3] = {BK, BM, 1};
  cuuint32_t estr[3] = {1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                  const_cast<void*>(planes), dims, strides, box, estr,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS;
}

}  // namespace

// Word planes of x[G, R, K] (strides sg, sr, sk) into out[3, G, R, Kp].
extern "C" int morfem_split_words(const float* x, uint16_t* out, int G, int R,
                                  int K, int Kp, int64_t sg, int64_t sr,
                                  int64_t sk, void* stream) {
  if (G <= 0 || R <= 0 || K <= 0 || Kp < K || Kp % BK)
    return (int)cudaErrorInvalidValue;
  dim3 grid((Kp + ST - 1) / ST, (R + ST - 1) / ST);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  for (int g0 = 0; g0 < G; g0 += MAX_BATCH) {
    grid.z = std::min(G - g0, MAX_BATCH);
    split_words_kernel<<<grid, dim3(ST, 8), 0, (cudaStream_t)stream>>>(
        x + g0 * sg, out + (int64_t)g0 * R * Kp, G, R, K, Kp, sg, sr, sk);
  }
  return (int)cudaGetLastError();
}

// out[G, M, N] = t + sign * (c @ r) from the word planes a = words(c)
// [3, G, M, Kp] and b = words(r^T) [3, G, N, Kp]; t may be null.
extern "C" int morfem_mm_words(const uint16_t* a, const uint16_t* b,
                               const float* t, float* out, int G, int M,
                               int N, int Kp, int64_t t_sg, int64_t t_sm,
                               int64_t t_sn, float sign, void* stream) {
  if (G <= 0 || M <= 0 || N <= 0 || Kp <= 0 || Kp % BK)
    return (int)cudaErrorInvalidValue;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  if (!word_map(&map_a, a, G, M, Kp) || !word_map(&map_b, b, G, N, Kp))
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  auto launch = [&](auto kernel) -> cudaError_t {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return e;
    for (int g0 = 0; g0 < G; g0 += MAX_BATCH) {
      grid.z = std::min(G - g0, MAX_BATCH);
      kernel<<<grid, THREADS, SMEM_BYTES, s>>>(
          map_a, map_b, t, out, G, M, N, Kp, t_sg, t_sm, t_sn, sign, g0);
    }
    return cudaSuccess;
  };
  cudaError_t e;
  if (t != nullptr)
    e = launch(mm_words_kernel<true>);
  else
    e = launch(mm_words_kernel<false>);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
