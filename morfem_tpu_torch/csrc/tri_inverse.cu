// Inverses of the panel LU's diagonal blocks, both triangles in one launch:
// from packed LU blocks lu[b] (P x P; strict lower part = L without its unit
// diagonal, upper part with the diagonal = U) it writes
//   linv[b] = (strict_lower(lu[b]) + I)^-1   and   uinv[b] = upper(lu[b])^-1,
// zero outside their triangles.
//
// Replaces no Pallas kernel: the JAX package inverts these blocks with
// batched matmuls (`_unit_lower_inv`, recursion and log-squaring, and
// `_upper_inv`, in morfem_tpu/ops/panel_lu.py), and the port called
// `torch.linalg.solve_triangular` against an identity twice per block step,
// which took ~0.58 ms a call at [8, 384, 384] on an H100, 250 times the
// work's bound (PERF.md, Findings).
//
// What bounds it on this card. A P x P triangular inverse is P^3/3
// operations (P^3/6 FMA); at the block-pivot factor's [8, 384, 384] both
// triangles are 0.3 GFLOP of FP32, 4.5 us at 67 TFLOP/s, and 14 MB of
// traffic, 4.2 us at 3.35 TB/s.
// The arithmetic is plain FP32 FMA on the CUDA cores: the inverses
// precondition an f64 refinement, and a TF32 or bf16 inverse would cost
// refinement steps. In practice the bound is the dependency chain: block
// row i of a column strip needs every block row before it.
//
// Design. Blocks are cut into 32 x 32 tiles (T = P/32 a side). One CTA of
// 256 threads owns one column strip (32 columns) of one inverse of one
// matrix: grid (batch, 2T), the heaviest strips (L's first, U's last)
// first. First its eight warps invert the strip's diagonal tiles T_ii at
// once, a warp a tile, one column a lane, by substitution in registers
// (unit diagonal for L; for U times the pivots' reciprocals, so a zero
// pivot gives inf/NaN as a triangular solve does). Then it walks down the
// strip (up it, for U): X_ij = -T_ii^-1 sum_k T_ik X_kj, X_jj = T_jj^-1,
// keeping the strip's tiles in shared memory (P x 32 floats; tile i holds
// T_ii^-1 until X_ij replaces it), so the substitutions, serial work of
// one warp each, are off the chain of block rows. The off-diagonal tiles T_ik stream through a ring of NS shared-memory slots
// by cp.async, NS - 1 tiles ahead across block rows (they do not depend
// on X). The sum is split over four groups of 64 threads, each a quarter
// of every tile's depth, each thread a 4 x 4 register tile (rows tr + 8a,
// so a warp's float4 reads of a tile row hit distinct banks); at a row's
// end the four partial sums meet in shared memory and all threads take
// the product with T_ii^-1. Where the strip does not fit in shared memory
// (P > 1472) the strip's tiles live in the output in device memory (L2)
// instead. The input may be a strided view (two batch strides and a row
// stride, unit column stride), so the panel LU passes the diagonal blocks
// of its factor without a copy. No host synchronisation: a CUDA graph
// captures it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TB = 32;          // tile side
constexpr int NT = 256;         // threads a CTA
constexpr int NS = 6;           // ring slots
constexpr int LDT = TB + 4;     // a staged tile's row stride (floats)
constexpr int TILE = TB * LDT;  // a ring slot (floats)
constexpr int GROUPS = NT / 64;  // groups splitting a tile's depth
constexpr int WARPS = NT / 32;
constexpr int MAX_SMEM = 232448;  // H100: opt-in shared memory a block

__host__ __device__ constexpr int fixed_smem_floats() {
  return NS * TILE + GROUPS * TB * TB;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Walks the off-diagonal tiles (i, k) a strip needs, row by row: for each
// block row i after the first (down from j for L, up from j for U) the
// tiles k = j, j + dir, ..., i - dir.
struct Cursor {
  int i, k, j, dir, end;
  __device__ Cursor(int j_, int dir_, int T)
      : i(j_ + dir_), k(j_), j(j_), dir(dir_), end(dir_ > 0 ? T : -1) {}
  __device__ bool done() const { return i == end; }
  __device__ bool last() const { return k + dir == i; }  // the row's last
  __device__ void next() {
    if (k + dir != i) {
      k += dir;
    } else {
      i += dir;
      k = j;
    }
  }
};

// Column `lane` of the inverse of one 32 x 32 triangular tile `t` (row
// stride TB) into y, in registers: unit lower (the strict lower part) or
// upper (times the pivots' reciprocals: a zero pivot gives inf/NaN, as a
// triangular solve does). The entries off the triangle are zero, never
// computed (a zero pivot would make them 0/0).
__device__ __forceinline__ void invert_tile(const float* t, bool upper,
                                            int lane, float (&y)[TB]) {
#pragma unroll
  for (int r = 0; r < TB; ++r) y[r] = r == lane ? 1.0f : 0.0f;
  if (!upper) {
#pragma unroll
    for (int r = 1; r < TB; ++r) {
      float s = y[r];
#pragma unroll
      for (int q = 0; q < r; ++q) s = fmaf(-t[r * TB + q], y[q], s);
      y[r] = r < lane ? 0.0f : s;
    }
  } else {
#pragma unroll
    for (int r = TB - 1; r >= 0; --r) {
      float s = y[r];
#pragma unroll
      for (int q = r + 1; q < TB; ++q) s = fmaf(-t[r * TB + q], y[q], s);
      y[r] = r > lane ? 0.0f : s * __frcp_rn(t[r * TB + r]);
    }
  }
}

template <bool XS>
__global__ void __launch_bounds__(NT, 2)
tri_inverse_kernel(const float* __restrict__ lu, float* __restrict__ linv,
                   float* __restrict__ uinv, int B2, int P, int64_t s_b1,
                   int64_t s_b2, int64_t s_r) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* red = ring + NS * TILE;          // GROUPS x 32 x 32 partials
  float* xs = red + GROUPS * TB * TB;     // XS: P x 32, the strip's tiles
  float* stage = xs;                      // else: WARPS x 32 x 32 staging

  const int T = P / TB;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.x;
  const bool upper = blockIdx.y & 1;
  const int j = upper ? T - 1 - (int)(blockIdx.y >> 1) : (int)(blockIdx.y >> 1);
  const int dir = upper ? -1 : 1;
  const float* in = lu + (int64_t)(b / B2) * s_b1 + (int64_t)(b % B2) * s_b2;
  float* out = (upper ? uinv : linv) + (int64_t)b * P * P;
  // tile i of the strip: X_ij once solved, the diagonal tile's inverse
  // before; in shared memory (XS) or in place in the output
  auto xtile = [&](int i) -> float* {
    return XS ? xs + TB * i * TB : out + (int64_t)TB * i * P + TB * j;
  };
  const int ldx = XS ? TB : P;

  // the strip's tiles outside its triangle are zero
  for (int i = upper ? j + 1 : 0; i < (upper ? T : j); ++i)
    for (int e = tid; e < TB * TB; e += NT)
      out[(int64_t)(TB * i + e / TB) * P + TB * j + e % TB] = 0.0f;

  const int m = upper ? j + 1 : T - j;  // block rows of the strip
  const int n_tiles = m * (m - 1) / 2;  // off-diagonal tiles

  auto fetch = [&](const Cursor& c, int slot) {
    const int row = tid / 8, chunk = tid % 8;  // 32 rows x 8 x 16 bytes
    cp_async16(ring + slot * TILE + row * LDT + 4 * chunk,
               in + (int64_t)(TB * c.i + row) * s_r + TB * c.k + 4 * chunk);
  };
  Cursor prod(j, dir, T);
  for (int s = 0; s < NS - 1; ++s) {
    if (!prod.done()) {
      fetch(prod, s);
      prod.next();
    }
    cp_async_commit();
  }

  // 1. the inverses of the strip's diagonal tiles T_ii, a warp a tile, all
  // warps at once, while the first off-diagonal tiles stream in
  for (int t = warp; t < m; t += WARPS) {
    const int i = j + dir * t;
    float* st = XS ? xtile(i) : stage + warp * TB * TB;
    const float* src = in + (int64_t)TB * i * s_r + TB * i;
    for (int e = lane; e < TB * TB / 4; e += 32)
      *reinterpret_cast<float4*>(st + (e / 8) * TB + 4 * (e % 8)) =
          *reinterpret_cast<const float4*>(src + (int64_t)(e / 8) * s_r +
                                           4 * (e % 8));
    __syncwarp();
    float y[TB];
    invert_tile(st, upper, lane, y);
    __syncwarp();  // every lane has read the tile
    float* xt = xtile(i);
#pragma unroll
    for (int r = 0; r < TB; ++r) {
      xt[r * ldx + lane] = y[r];
      if (XS && i == j) out[(int64_t)(TB * j + r) * P + TB * j + lane] = y[r];
    }
    __syncwarp();
  }

  // 2. down the strip: T_ii X_ij = -sum_k T_ik X_kj, that is
  //    X_ij = -T_ii^-1 (sum_k T_ik X_kj)
  const int g = tid / 64, lt = tid % 64, tr = lt / 8, tc = lt % 8;
  float acc[4][4] = {};
  Cursor cons(j, dir, T);
  for (int s = 0; s < n_tiles; ++s) {
    cp_async_wait<NS - 2>();
    __syncthreads();  // tile s landed; slot of tile s-1 free; X ready
    if (!prod.done()) {
      fetch(prod, (s + NS - 1) % NS);
      prod.next();
    }
    cp_async_commit();
    // acc += T_ik[:, 8g:8g+8] @ X_kj[8g:8g+8, :] (this group's quarter)
    const float* tile = ring + (s % NS) * TILE;
    const float* xk = xtile(cons.k);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kk = 8 * g + 4 * h;
      float4 a4[4], x4[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        a4[a] = *reinterpret_cast<const float4*>(tile + (tr + 8 * a) * LDT +
                                                 kk);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4* src =
            reinterpret_cast<const float4*>(xk + (kk + q) * ldx + 4 * tc);
        x4[q] = XS ? *src : __ldcg(src);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float av[4] = {a4[a].x, a4[a].y, a4[a].z, a4[a].w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[a][0] = fmaf(av[q], x4[q].x, acc[a][0]);
          acc[a][1] = fmaf(av[q], x4[q].y, acc[a][1]);
          acc[a][2] = fmaf(av[q], x4[q].z, acc[a][2]);
          acc[a][3] = fmaf(av[q], x4[q].w, acc[a][3]);
        }
      }
    }
    if (cons.last()) {
      const int i = cons.i;
      // the four partial sums meet: R = -(their sum), in red[0]
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        *reinterpret_cast<float4*>(red + g * TB * TB + (tr + 8 * a) * TB +
                                   4 * tc) =
            make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = 0.0f;
      }
      __syncthreads();
      {
        float4 sum = reinterpret_cast<const float4*>(red)[tid];
#pragma unroll
        for (int q = 1; q < GROUPS; ++q) {
          const float4 v = reinterpret_cast<const float4*>(red + q * TB * TB)[tid];
          sum.x += v.x;
          sum.y += v.y;
          sum.z += v.z;
          sum.w += v.w;
        }
        reinterpret_cast<float4*>(red)[tid] =
            make_float4(-sum.x, -sum.y, -sum.z, -sum.w);
      }
      __syncthreads();
      // X_ij = T_ii^-1 R: a row and four columns a thread; the depth
      // index turns with the row, so a warp's four rows hit four banks
      const int r = tid / 8, c4 = tid % 8;
      const float* ti = xtile(i) + r * ldx;
      float4 o = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 8
      for (int s2 = 0; s2 < TB; ++s2) {
        const int q = (s2 + r) & (TB - 1);
        const float a = XS ? ti[q] : __ldcg(ti + q);
        const float4 x = reinterpret_cast<const float4*>(red + q * TB)[c4];
        o.x = fmaf(a, x.x, o.x);
        o.y = fmaf(a, x.y, o.y);
        o.z = fmaf(a, x.z, o.z);
        o.w = fmaf(a, x.w, o.w);
      }
      __syncthreads();  // T_ii^-1 and R read: tile i takes X_ij
      *reinterpret_cast<float4*>(xtile(i) + r * ldx + 4 * c4) = o;
      if (XS)
        *reinterpret_cast<float4*>(out + (int64_t)(TB * i + r) * P + TB * j +
                                   4 * c4) = o;
    }
    cons.next();
  }
  cp_async_wait<0>();
}

template <bool XS>
int launch(const float* lu, float* linv, float* uinv, int B1, int B2, int P,
           int64_t s_b1, int64_t s_b2, int64_t s_r, int64_t smem,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        tri_inverse_kernel<XS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((int64_t)B1 * B2), 2 * (P / TB));
  tri_inverse_kernel<XS><<<grid, NT, (int)smem, stream>>>(
      lu, linv, uinv, B2, P, s_b1, s_b2, s_r);
  return (int)cudaGetLastError();
}

}  // namespace

// lu: [B1, B2, P, P] floats at strides (s_b1, s_b2, s_r, 1), 16-byte
// aligned with every stride a multiple of 4; linv, uinv: [B1, B2, P, P]
// contiguous. P a multiple of 32; B1 * B2 below 2^31.
extern "C" int morfem_tri_inverse(const float* lu, float* linv, float* uinv,
                                  int B1, int B2, int P, int64_t s_b1,
                                  int64_t s_b2, int64_t s_r, void* stream) {
  if (B1 <= 0 || B2 <= 0 || P <= 0 || P % TB ||
      (int64_t)B1 * B2 > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)lu % 16 || s_b1 % 4 || s_b2 % 4 || s_r % 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t fixed = (int64_t)fixed_smem_floats() * 4;
  const int64_t strip = (int64_t)P * TB * 4;
  if (fixed + strip <= MAX_SMEM)
    return launch<true>(lu, linv, uinv, B1, B2, P, s_b1, s_b2, s_r,
                        fixed + strip, st);
  return launch<false>(lu, linv, uinv, B1, B2, P, s_b1, s_b2, s_r,
                       fixed + (int64_t)WARPS * TB * TB * 4, st);
}
