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
// here. Every update is rounded as __fadd_rn(v, __fmul_rn(pr, c)), once per
// element per step and in the same order, like the plain PyTorch version in
// ops/kernels/panel_factor.py, so the kernels equal it bit for bit.
// C~ is optional (want_ct): the block-pivot LU discards it, and skipping
// its rows q < j halves every step's work there.
//
// What bounds it on this card. Per batch entry the work is a chain of P
// dependent column steps, each a max-reduction over the lanes followed by
// an update of the whole [P, Npl] panel. The arithmetic is small (the
// operations bound of [8, 384, 384] is ~7 us at the FP32 peak of an H100
// SXM at 700 W); the time is the latency of the P dependent steps and the
// bandwidth of wherever the panel lives.
//
// Two kernels, picked by shape in the wrapper (never by a failed launch):
//
// * cluster kernel (the block-pivot [8, 384, 384] shape and any panel whose
//   lanes fit): each batch entry is a portable cluster of CS = 8 CTAs. CTA
//   `rank` owns lanes [rank*L, rank*L + L) of pt (and of C~) and keeps them
//   in its own shared memory for the whole factor, so the panel never goes
//   back to L2 between steps; 8 SMs work on one matrix instead of one.
//   One column step, with one cluster barrier:
//     1. warp 0 finds the CTA's local (max score, lowest lane, value);
//     2. it posts that triple into every CTA's slot for this step through
//        distributed shared memory, double-buffered by step parity (a slot
//        of step j+2 is written only after the barrier of step j+1, which
//        every CTA passes only after reading the slots of step j);
//     3. after the cluster barrier every CTA reduces the CS triples to the
//        same winner r;
//     4. every CTA copies the pivot lane's entries pt[k, r], k > j (and
//        ct[q, r], q < j) from the owner's shared memory. The owner never
//        writes lane r during step j (the pivot lane is skipped), so the
//        copy does not race with its update;
//     5. every CTA updates only its own lanes, in shared memory.
//   A cluster barrier after the last step keeps every CTA's shared memory
//   alive until the others have read it.
//
// * one-CTA kernel (panels whose lanes do not fit 8 CTAs' shared memory:
//   the full-pivot [8, 128, 3456] panel with C~ is 3.5 MB): one CTA per
//   batch entry, panel and C~ in device memory (L2-resident in practice),
//   only c_j and the mask in shared memory. It runs only on escalation.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ bool better(float s, int i, float bs, int bi) {
  return s > bs || (s == bs && i < bi);
}

__device__ __forceinline__ float upd(float v, float pr, float cv) {
  return __fadd_rn(v, __fmul_rn(pr, cv));
}

// ---------------------------------------------------------------------------
// cluster kernel

constexpr int CS = 8;            // CTAs per batch entry (portable cluster)
constexpr int CL_THREADS = 256;  // threads per CTA
constexpr int NOBODY = 0x7fffffff;

// shared memory of one CTA, in this order: the step slots, pt[P][L],
// ct[P][L] (want_ct), cvec[L], av[L], prow[P], pcol[P] (want_ct)
__host__ __device__ inline size_t cluster_smem_bytes(int P, int L,
                                                     bool want_ct) {
  size_t slots = 2 * CS * (2 * sizeof(float) + sizeof(int));
  size_t per = want_ct ? 2 : 1;
  return slots + sizeof(float) * (per * (size_t)P * L + 2 * (size_t)L +
                                  per * (size_t)P);
}

// Update rows [k_lo, k_hi) of `rows` ([.][L] in shared memory) at this
// thread's lanes with the pivot column `pcolv` and coefficients `cvec`,
// skipping local lane `skip` (-1: none). Thread t owns lane t % nl and
// rows k_lo + t / nl, stepping by R = T / nl (or, when nl > T, lanes t,
// t + T, ... over all rows).
__device__ __forceinline__ void update_rows(float* rows, const float* pcolv,
                                            const float* cvec, int L, int nl,
                                            int k_lo, int k_hi, int skip) {
  const int t = threadIdx.x;
  if (nl <= 0 || k_hi <= k_lo) return;
  if (nl <= CL_THREADS) {
    const int R = CL_THREADS / nl;
    const int i = t % nl, k0 = t / nl;
    if (k0 >= R || i == skip) return;
    const float cv = cvec[i];
    int k = k_lo + k0;
    for (; k + 3 * R < k_hi; k += 4 * R) {
      float v0 = rows[(k)*L + i], v1 = rows[(k + R) * L + i];
      float v2 = rows[(k + 2 * R) * L + i], v3 = rows[(k + 3 * R) * L + i];
      float p0 = pcolv[k], p1 = pcolv[k + R], p2 = pcolv[k + 2 * R];
      float p3 = pcolv[k + 3 * R];
      rows[(k)*L + i] = upd(v0, p0, cv);
      rows[(k + R) * L + i] = upd(v1, p1, cv);
      rows[(k + 2 * R) * L + i] = upd(v2, p2, cv);
      rows[(k + 3 * R) * L + i] = upd(v3, p3, cv);
    }
    for (; k < k_hi; k += R) rows[k * L + i] = upd(rows[k * L + i], pcolv[k], cv);
  } else {
    for (int i = t; i < nl; i += CL_THREADS) {
      if (i == skip) continue;
      const float cv = cvec[i];
      for (int k = k_lo; k < k_hi; ++k)
        rows[k * L + i] = upd(rows[k * L + i], pcolv[k], cv);
    }
  }
}

template <bool WANT_CT>
__global__ void __cluster_dims__(CS, 1, 1) __launch_bounds__(CL_THREADS)
panel_factor_cluster_kernel(const float* __restrict__ panel_t,
                            const float* __restrict__ avail_in, float* fac,
                            float* ct, int* piv, float* avail_out, int P,
                            int Npl, int L) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* slot_s = reinterpret_cast<float*>(smem_raw);  // [2][CS] score
  float* slot_v = slot_s + 2 * CS;                     // [2][CS] value
  int* slot_i = reinterpret_cast<int*>(slot_v + 2 * CS);  // [2][CS] lane
  float* pts = reinterpret_cast<float*>(slot_i + 2 * CS);  // [P][L]
  float* cts = pts + (size_t)P * L;                        // [P][L]
  float* cvec = WANT_CT ? cts + (size_t)P * L : cts;       // [L]
  float* av = cvec + L;                                    // [L]
  float* prow = av + L;                                    // [P]
  float* pcol = prow + P;                                  // [P] (want_ct)

  const int rank = (int)cluster.block_rank();
  const int g = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane0 = rank * L;
  const int nl = max(0, min(L, Npl - lane0));
  const int64_t off = (int64_t)g * P * Npl;

  for (int e = tid; e < P * nl; e += CL_THREADS) {
    int k = e / nl, i = e - k * nl;
    pts[k * L + i] = panel_t[off + (int64_t)k * Npl + lane0 + i];
    if (WANT_CT) cts[k * L + i] = 0.f;
  }
  for (int i = tid; i < nl; i += CL_THREADS)
    av[i] = avail_in[(int64_t)g * Npl + lane0 + i];
  // every CTA of the cluster is running and initialised before any reads
  // or writes another's shared memory
  cluster.sync();

  for (int j = 0; j < P; ++j) {
    const int par = (j & 1) * CS;
    if (tid < 32) {
      // 1. local candidate over this CTA's lanes of row j
      float best = -CUDART_INF_F, bv = 0.f;
      int bi = NOBODY;
      for (int i = tid; i < nl; i += 32) {
        float a = av[i], v = pts[j * L + i];
        float s = fabsf(v) * a - (1.f - a);
        if (better(s, lane0 + i, best, bi)) { best = s; bi = lane0 + i; bv = v; }
      }
      for (int o = 16; o > 0; o >>= 1) {
        float os = __shfl_down_sync(0xffffffffu, best, o);
        int oi = __shfl_down_sync(0xffffffffu, bi, o);
        float ov = __shfl_down_sync(0xffffffffu, bv, o);
        if (better(os, oi, best, bi)) { best = os; bi = oi; bv = ov; }
      }
      best = __shfl_sync(0xffffffffu, best, 0);
      bi = __shfl_sync(0xffffffffu, bi, 0);
      bv = __shfl_sync(0xffffffffu, bv, 0);
      // 2. post it into every CTA's slot (lane d writes to CTA d)
      if (tid < CS) {
        cluster.map_shared_rank(slot_s, tid)[par + rank] = best;
        cluster.map_shared_rank(slot_v, tid)[par + rank] = bv;
        cluster.map_shared_rank(slot_i, tid)[par + rank] = bi;
      }
    }
    cluster.sync();  // the one cluster barrier of the step

    // 3. the same winner in every CTA
    float best = -CUDART_INF_F, pv = 0.f;
    int r = NOBODY;
#pragma unroll
    for (int d = 0; d < CS; ++d) {
      float s = slot_s[par + d];
      int i = slot_i[par + d];
      if (better(s, i, best, r)) { best = s; r = i; pv = slot_v[par + d]; }
    }
    if (r >= Npl) {
      // a column of NaNs finds no maximum; keep the index in range (lane 0,
      // owned by CTA 0), as the plain version does
      r = 0;
      pv = cluster.map_shared_rank(pts, 0)[j * L];
    }
    const int owner = r / L, rl = r - owner * L;
    const float inv = 1.f / pv;

    // 4. the pivot lane's later rows (and earlier C~ rows) from its owner
    const float* opts = cluster.map_shared_rank(pts, owner);
    for (int k = j + 1 + tid; k < P; k += CL_THREADS) prow[k] = opts[k * L + rl];
    if (WANT_CT) {
      const float* octs = cluster.map_shared_rank(cts, owner);
      for (int q = tid; q < j; q += CL_THREADS) pcol[q] = octs[q * L + rl];
    }
    // multipliers, coefficients and the factored row j at own lanes
    for (int i = tid; i < nl; i += CL_THREADS) {
      float v = pts[j * L + i];
      bool mine = lane0 + i == r;
      bool keep = (av[i] == 0.f) || mine;
      float l = keep ? 0.f : v * inv;
      cvec[i] = -l;
      if (!keep) pts[j * L + i] = l;
      if (WANT_CT) cts[j * L + i] = -l;
      if (mine) av[i] = 0.f;
    }
    if (rank == 0 && tid == 0) piv[(int64_t)g * P + j] = r;
    __syncthreads();

    // 5. own lanes of later panel rows and earlier C~ rows
    const int skip = owner == rank ? rl : -1;
    update_rows(pts, prow, cvec, L, nl, j + 1, P, skip);
    if (WANT_CT) update_rows(cts, pcol, cvec, L, nl, 0, j, skip);
    __syncthreads();
  }
  // keep this CTA's shared memory alive until every CTA has read it
  cluster.sync();

  for (int e = tid; e < P * nl; e += CL_THREADS) {
    int k = e / nl, i = e - k * nl;
    fac[off + (int64_t)k * Npl + lane0 + i] = pts[k * L + i];
    if (WANT_CT) ct[off + (int64_t)k * Npl + lane0 + i] = cts[k * L + i];
  }
  for (int i = tid; i < nl; i += CL_THREADS)
    avail_out[(int64_t)g * Npl + lane0 + i] = av[i];
}

// ---------------------------------------------------------------------------
// one-CTA kernel

constexpr int MAX_THREADS = 512;

__global__ void __launch_bounds__(MAX_THREADS)
panel_factor_cta_kernel(const float* __restrict__ panel_t,
                        const float* __restrict__ avail_in, float* fac,
                        float* ct, int* piv, float* avail_out, int P, int Npl,
                        bool want_ct) {
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
  float* C = want_ct ? ct + off : nullptr;

  for (int64_t e = tid; e < (int64_t)P * Npl; e += bs) {
    F[e] = pin[e];
    if (want_ct) C[e] = 0.f;
  }
  for (int i = tid; i < Npl; i += bs) av[i] = avail_in[(int64_t)g * Npl + i];
  __syncthreads();

  for (int j = 0; j < P; ++j) {
    const float* col = F + (int64_t)j * Npl;
    // pivot search: max score, lowest lane on ties
    float best = -CUDART_INF_F;
    int bi = NOBODY;
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
      bi = lane < nwarps ? red_i[lane] : NOBODY;
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
    float* crow = want_ct ? C + (int64_t)j * Npl : nullptr;
    for (int i = tid; i < Npl; i += bs) {
      float v = frow[i];
      bool keep = (av[i] == 0.f) || (i == r);
      float l = keep ? 0.f : v * inv;
      cvec[i] = -l;
      if (want_ct) crow[i] = -l;
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
    for (int k0 = want_ct ? 0 : j + 1; k0 < P; k0 += UNROLL) {
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
          if (rows[u]) rows[u][i] = upd(v[u], pr[u], cv);
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < Npl; i += bs) avail_out[(int64_t)g * Npl + i] = av[i];
}

}  // namespace

extern "C" int morfem_panel_factor_cluster(const float* panel_t,
                                           const float* avail, float* fac,
                                           float* ct, int* piv,
                                           float* avail_out, int G, int P,
                                           int Npl, int want_ct,
                                           void* stream) {
  if (G <= 0 || P <= 0 || Npl <= 0 || G > 65535 || P > Npl)
    return (int)cudaErrorInvalidValue;
  const int L = (Npl + CS - 1) / CS;
  const size_t smem = cluster_smem_bytes(P, L, want_ct != 0);
  dim3 grid(CS, G), block(CL_THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (want_ct) {
    e = cudaFuncSetAttribute(panel_factor_cluster_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    panel_factor_cluster_kernel<true><<<grid, block, smem, s>>>(
        panel_t, avail, fac, ct, piv, avail_out, P, Npl, L);
  } else {
    e = cudaFuncSetAttribute(panel_factor_cluster_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    panel_factor_cluster_kernel<false><<<grid, block, smem, s>>>(
        panel_t, avail, fac, ct, piv, avail_out, P, Npl, L);
  }
  return (int)cudaGetLastError();
}

extern "C" int morfem_panel_factor_cta(const float* panel_t,
                                       const float* avail, float* fac,
                                       float* ct, int* piv, float* avail_out,
                                       int G, int P, int Npl, int want_ct,
                                       void* stream) {
  if (G <= 0 || P <= 0 || Npl <= 0) return (int)cudaErrorInvalidValue;
  size_t smem = 2 * (size_t)Npl * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        panel_factor_cta_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int threads = ((Npl + 31) / 32) * 32;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  panel_factor_cta_kernel<<<G, threads, smem, (cudaStream_t)stream>>>(
      panel_t, avail, fac, ct, piv, avail_out, P, Npl, want_ct != 0);
  return (int)cudaGetLastError();
}
