// Masked partial-pivot factor of a batch of transposed panels (Hopper).
//
// Replaces the Pallas kernel `_panel_kernel` / `panel_factor` in
// morfem_tpu/ops/pallas/panel_factor.py. Same function: for each batch
// entry g the panel is held transposed, pt[P, Npl] (panel column k in row k,
// matrix row i in lane i); columns are eliminated left to right with partial
// pivoting over the rows still available, and rows are never swapped:
//   * pivot of column j = the available lane with the largest |pt[j, i]|,
//     the LOWEST lane index winning a tie (the reference's masked min over
//     the lanes that reach the max); a NaN score anywhere in the column
//     finds no maximum and the pivot is lane 0, as in the plain version;
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
// ops/kernels/panel_factor.py, so the kernel equals it bit for bit. (The
// pivot lane's own entries are left as they are; the plain version adds
// pr * (-0) to them, which changes no finite value.)
// C~ is optional (want_ct): the block-pivot LU discards it, and skipping
// its rows q < j halves every step's work there.
//
// What bounds it on this card. Per batch entry the work is a chain of P
// dependent column steps, each a max-reduction over the lanes followed by
// an update of the P - 1 live rows over all lanes. The arithmetic is small
// (the operations bound of [8, 128, 3456] with C~ is ~13 us at the FP32
// peak of an H100 SXM at 700 W); the time is the latency of the P dependent
// steps (a cluster barrier and a remote read each) and the bandwidth of
// wherever the live rows live.
//
// One kernel for every shape: each batch entry is a thread-block cluster of
// CS CTAs (8, the portable size, or 16, non-portable) of 256 or 512
// threads. CTA `rank` owns lanes [rank*L, rank*L + L) of the panel,
// L = ceil(Npl / CS), and keeps them for the whole factor.
//
// One buffer per CTA. At step j the live rows of a lane are the panel rows
// k > j and the C~ rows q < j: P - 1 rows. So one [P, L] buffer holds both:
// row k is panel row k while k >= j and C~ row k once k < j. At step j the
// factored row j goes to `fac` in device memory as the multipliers are
// formed, and its slot becomes C~ row j (= c_j), which is also the step's
// coefficient vector. At the end the buffer is C~, written out once.
// Without C~ the slot only carries c_j.
//
// Where the buffer lives is picked by shape in the wrapper (never by a
// failed launch): in the CTA's shared memory when it fits (the variants
// "cluster8" and "cluster16"; [G, 128, 3456] with C~ is 225 KB per CTA on
// 8), else in device memory ("cluster_global": the buffer is the `ct`
// output itself, or `fac` without C~, L2-resident in practice), with the
// same split of the lanes and the same step protocol. In shared memory the
// buffer is lane-major, [L][S] with S = round_up(P, 32) + 4: a lane's rows
// are contiguous, so the pivot lane's column is one coalesced remote read,
// and 4 rows of 8 neighbouring lanes fill the 32 banks once (float4
// updates without conflicts). In device memory it keeps the outputs'
// row-major [P][Npl] layout.
//
// One column step, with one cluster barrier:
//   1. (during the previous step) warp 0 updates row j first, then finds
//      the CTA's local (max score, lowest lane, value) over its lanes of
//      row j, and whether a score was NaN, while the other warps update
//      the remaining rows;
//   2. it posts that triple into every CTA's slot for this step through
//      distributed shared memory, double-buffered by step parity (a slot
//      of step j+2 is written only after the barrier of step j+1, which
//      every CTA passes only after reading the slots of step j); CTA 0
//      also posts the value of lane 0, the pivot of a column with a NaN;
//   3. after the cluster barrier (split: arrive once the CTA's rows are
//      updated and its candidate posted, then wait) every CTA reduces the
//      CS triples to the same winner r;
//   4. every CTA copies the pivot lane's live rows from the owner's
//      buffer. The owner never writes lane r during step j (the pivot lane
//      is skipped), so the copy does not race with its update;
//   5. it forms the multipliers, writes fac row j and c_j, and updates only
//      its own lanes of the live rows.
// A cluster barrier after the last step keeps every CTA's shared memory
// alive until the others have read it.
//
// Any batch: the batch entry is the grid's y index, which holds at most
// 65,535, so the entry point launches once per 65,535 entries, on pointers
// offset to each launch's first one (the reference's grid (G,) has no
// bound).

#include <algorithm>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_THREADS = 512;  // threads per CTA: 256 or 512, by shape
constexpr int NOBODY = 0x7fffffff;
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block may use
constexpr int MAX_BATCH = 65535;  // the grid's y limit: entries a launch

__device__ __forceinline__ bool better(float s, int i, float bs, int bi) {
  return s > bs || (s == bs && i < bi);
}

__device__ __forceinline__ float upd(float v, float pr, float cv) {
  return __fadd_rn(v, __fmul_rn(pr, cv));
}

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// A lane's stride in the shared-memory buffer: its P rows, rounded so that
// the stride is 4 words past a multiple of 32 banks.
__host__ __device__ inline int lane_stride(int P) {
  return round_up(P, 32) + 4;
}

// Shared memory of one CTA, in this order: the pivot lane's column
// [round_up(P, 4)], the buffer [L][S] (in_smem) or c_j [L] (buffer in
// device memory), the mask [L], the step slots (score, value, lane)[2][CS]
// and lane 0's value [2].
__host__ __device__ inline size_t smem_bytes(int P, int L, int cs,
                                             bool in_smem) {
  return sizeof(float) *
         ((size_t)round_up(P, 4) +
          (in_smem ? (size_t)L * lane_stride(P) : (size_t)L) + L +
          6 * (size_t)cs + 2);
}

// In shared memory: update lanes [0, nl) of rows k in [k_lo, k_hi), k not
// xa or xb (row[k] += pcol[k] * c_j at each lane, c_j the lane's entry of
// row j), skipping lane `skip`, by the nt threads t of a group. Thread t
// owns lane t % nl (its c_j stays in a register) and the row quads from
// t / nl on, stepping by QR = nt / nl (or, when nl > nt, the lanes t,
// t + nt, ... over all quads); U quads (float4) in flight.
template <int U>
__device__ __forceinline__ void update_smem(float* sbuf, int S,
                                            const float* pcol, int nl, int j,
                                            int k_lo, int k_hi, int xa,
                                            int xb, int skip, int t, int nt) {
  const int q_lo = k_lo >> 2, q_hi = (k_hi + 3) >> 2;
  if (nl <= 0 || q_lo >= q_hi) return;
  int i0 = t, g0 = 0, QR = 1;
  if (nl <= nt) {
    QR = nt / nl;
    i0 = t % nl;
    g0 = t / nl;
    if (g0 >= QR) return;
  }
  const float4* pc4 = reinterpret_cast<const float4*>(pcol);
  for (int i = i0; i < nl; i += nt) {
    if (i == skip) continue;  // the pivot lane: its owner's column is read
    float* lane = sbuf + (size_t)i * S;
    float4* lane4 = reinterpret_cast<float4*>(lane);
    const float c = lane[j];
    for (int q = q_lo + g0; q < q_hi; q += U * QR) {
      float4 v[U], p[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int qu = q + u * QR;
        if (qu < q_hi) {
          v[u] = lane4[qu];
          p[u] = pc4[qu];
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int qu = q + u * QR;
        if (qu >= q_hi) continue;
        float4 o;
        o.x = upd(v[u].x, p[u].x, c);
        o.y = upd(v[u].y, p[u].y, c);
        o.z = upd(v[u].z, p[u].z, c);
        o.w = upd(v[u].w, p[u].w, c);
        const int k0 = 4 * qu;
        if (k0 >= k_lo && k0 + 3 < k_hi && (unsigned)(xa - k0) > 3u &&
            (unsigned)(xb - k0) > 3u) {
          lane4[qu] = o;
        } else {  // a quad at the edge of the live rows, or holding xa / xb
          const float ov[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int k = k0 + r;
            if (k >= k_lo && k < k_hi && k != xa && k != xb) lane[k] = ov[r];
          }
        }
      }
    }
  }
}

// In device memory (row-major, any alignment): the same update, the
// (row, lane) pairs dealt out evenly over the threads, row-major; U pairs
// in flight per thread.
template <int U>
__device__ __forceinline__ void update_global(float* buf, int ld,
                                              const float* pcol,
                                              const float* cvec, int nl,
                                              int k_lo, int k_hi, int xa,
                                              int xb, int skip, int t,
                                              int nt) {
  if (nl <= 0 || k_lo >= k_hi) return;
  const int dq = nt / nl, dr = nt - dq * nl;  // one step of nt pairs
  int k = k_lo + t / nl, i = t - (t / nl) * nl;
  while (k < k_hi) {
    float v[U], pr[U], cv[U];
    int kk[U], ii[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      kk[u] = k;
      ii[u] = i;
      if (k < k_hi) {
        v[u] = buf[(size_t)k * ld + i];
        pr[u] = pcol[k];
        cv[u] = cvec[i];
      }
      i += dr;
      k += dq;
      if (i >= nl) {
        i -= nl;
        ++k;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int ku = kk[u];
      if (ku < k_hi && ku != xa && ku != xb && ii[u] != skip)
        buf[(size_t)ku * ld + ii[u]] = upd(v[u], pr[u], cv[u]);
    }
  }
}

// Warp 0: row k over this CTA's lanes (element (k, i) at k * ks + i * is):
// row[k] += pr * c_j, c_j at cvec[i * cs], skipping lane `skip`; 8 lanes
// in flight per thread.
__device__ __forceinline__ void update_one_row(float* buf, int ks, int is,
                                               int k, float pr,
                                               const float* cvec, int cs,
                                               int nl, int skip) {
  constexpr int U = 8;
  float* row = buf + (size_t)k * ks;
  for (int i = threadIdx.x; i < nl; i += 32 * U) {
    float v[U], c[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int iu = i + 32 * u;
      if (iu < nl) {
        v[u] = row[(size_t)iu * is];
        c[u] = cvec[(size_t)iu * cs];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int iu = i + 32 * u;
      if (iu < nl && iu != skip) row[(size_t)iu * is] = upd(v[u], pr, c[u]);
    }
  }
}

// The two halves of a cluster barrier: arrive (release) and wait (acquire).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// Warp 0: the CTA's candidate for the pivot of row k (max score, lowest
// lane, its value; a NaN score posts NaN), posted into every CTA's slot of
// parity `par` (lane d writes to CTA d); CTA 0 also posts lane 0's value.
template <int CS>
__device__ __forceinline__ void post_candidate(
    cg::cluster_group& cluster, const float* buf, int ks, int is, int k,
    const float* av, int nl, int lane0, int rank, int par, float* slot_s,
    float* slot_v, int* slot_i, float* slot_z) {
  const int t = threadIdx.x;
  const float* row = buf + (size_t)k * ks;
  float best = -CUDART_INF_F, bv = 0.f;
  int bi = NOBODY;
  bool saw_nan = false;
#pragma unroll 4
  for (int i = t; i < nl; i += 32) {
    const float a = av[i], v = row[(size_t)i * is];
    const float s = fabsf(v) * a - (1.f - a);
    saw_nan |= isnan(s);
    if (better(s, lane0 + i, best, bi)) { best = s; bi = lane0 + i; bv = v; }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float os = __shfl_down_sync(0xffffffffu, best, o);
    const int oi = __shfl_down_sync(0xffffffffu, bi, o);
    const float ov = __shfl_down_sync(0xffffffffu, bv, o);
    if (better(os, oi, best, bi)) { best = os; bi = oi; bv = ov; }
  }
  saw_nan = __any_sync(0xffffffffu, saw_nan);
  best = __shfl_sync(0xffffffffu, best, 0);
  bi = __shfl_sync(0xffffffffu, bi, 0);
  bv = __shfl_sync(0xffffffffu, bv, 0);
  if (t < CS) {
    cluster.map_shared_rank(slot_s, t)[par * CS + rank] =
        saw_nan ? CUDART_NAN_F : best;
    cluster.map_shared_rank(slot_v, t)[par * CS + rank] = bv;
    cluster.map_shared_rank(slot_i, t)[par * CS + rank] = bi;
    if (rank == 0) cluster.map_shared_rank(slot_z, t)[par] = row[0];
  }
}

template <int CS, bool WANT_CT, bool IN_SMEM>
__global__ void __launch_bounds__(MAX_THREADS)
panel_factor_kernel(const float* __restrict__ panel_t,
                    const float* __restrict__ avail_in, float* fac, float* ct,
                    int* piv, float* avail_out, int P, int Npl, int L) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int S = lane_stride(P), P4 = round_up(P, 4);
  float* pcol = reinterpret_cast<float*>(smem_raw);        // [P4]
  float* sbuf = pcol + P4;                                 // [L][S] in_smem
  float* cvec_s = sbuf;                                    // [L] otherwise
  float* av = sbuf + (IN_SMEM ? (size_t)L * S : (size_t)L);  // [L]
  float* slot_s = av + L;                                  // [2][CS] score
  float* slot_v = slot_s + 2 * CS;                         // [2][CS] value
  int* slot_i = reinterpret_cast<int*>(slot_v + 2 * CS);   // [2][CS] lane
  float* slot_z = reinterpret_cast<float*>(slot_i + 2 * CS);  // [2]

  const int rank = (int)cluster.block_rank();
  const int g = blockIdx.y;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane0 = rank * L;
  const int nl = max(0, min(L, Npl - lane0));
  const int64_t off = (int64_t)g * P * Npl;
  // the whole entry's live rows in device memory (buffer in device memory)
  float* gbuf = (WANT_CT ? ct : fac) + off;
  // this CTA's lanes of the live rows: element (k, i) at buf[k*ks + i*is]
  float* buf = IN_SMEM ? sbuf : gbuf + lane0;
  const int ks = IN_SMEM ? 1 : Npl, is = IN_SMEM ? S : 1;
  float* facg = fac + off + lane0;

  for (int e = tid; e < P * nl; e += nthr) {
    const int k = e / nl, i = e - k * nl;
    buf[(size_t)k * ks + (size_t)i * is] =
        panel_t[off + (int64_t)k * Npl + lane0 + i];
  }
  for (int i = tid; i < nl; i += nthr)
    av[i] = avail_in[(int64_t)g * Npl + lane0 + i];
  for (int k = tid; k < P4; k += nthr) pcol[k] = 0.f;
  if (IN_SMEM && P4 > P) {  // the rows of a lane's last quad past P
    for (int e = tid; e < nl * (P4 - P); e += nthr) {
      const int i = e / (P4 - P);
      sbuf[(size_t)i * S + P + (e - i * (P4 - P))] = 0.f;
    }
  }
  // every CTA of the cluster is running and initialised before any reads
  // or writes another's shared memory or lanes
  cluster.sync();
  if (tid < 32)
    post_candidate<CS>(cluster, buf, ks, is, 0, av, nl, lane0, rank, 0,
                       slot_s, slot_v, slot_i, slot_z);
  cluster_arrive();
  cluster_wait();

  for (int j = 0; j < P; ++j) {
    const int par = j & 1;

    // 3. the same winner in every CTA
    float best = -CUDART_INF_F, pv = 0.f;
    int r = NOBODY;
    bool saw_nan = false;
#pragma unroll
    for (int d = 0; d < CS; ++d) {
      const float s = slot_s[par * CS + d];
      const int i = slot_i[par * CS + d];
      saw_nan |= isnan(s);
      if (better(s, i, best, r)) {
        best = s;
        r = i;
        pv = slot_v[par * CS + d];
      }
    }
    if (saw_nan || r >= Npl) {
      // a NaN score: no maximum; the pivot is lane 0, as in the plain version
      r = 0;
      pv = slot_z[par];
    }
    const int owner = r / L, rl = r - owner * L;
    const float inv = 1.f / pv;
    const int k_lo = WANT_CT ? 0 : j + 1;  // the first live row

    // 4. the pivot lane's live rows from its owner, 4 loads in flight
    {
      const float* ob =
          IN_SMEM ? cluster.map_shared_rank(sbuf, owner) + (size_t)rl * S
                  : gbuf + r;
      for (int k0 = k_lo + tid; k0 < P; k0 += 4 * nthr) {
        float v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int k = k0 + u * nthr;
          if (k < P)
            v[u] = IN_SMEM ? ob[k] : __ldcg(ob + (size_t)k * Npl);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int k = k0 + u * nthr;
          if (k < P && k != j) pcol[k] = v[u];
        }
      }
    }
    // multipliers, the factored row j, and c_j at own lanes: in shared
    // memory the slot of row j becomes C~ row j
    float* cvec = IN_SMEM ? sbuf + j : cvec_s;  // c_j of lane i at i * cs
    const int cs = IN_SMEM ? S : 1;
    for (int i = tid; i < nl; i += nthr) {
      const float v = buf[(size_t)j * ks + (size_t)i * is];
      const bool mine = lane0 + i == r;
      const bool keep = (av[i] == 0.f) || mine;
      const float l = keep ? 0.f : v * inv;
      facg[(int64_t)j * Npl + i] = keep ? v : l;
      cvec[(size_t)i * cs] = -l;
      if (!IN_SMEM && WANT_CT) buf[(size_t)j * ks + i] = -l;
      if (mine) av[i] = 0.f;
    }
    if (rank == 0 && tid == 0) piv[(int64_t)g * P + j] = r;
    __syncthreads();

    // 5. own lanes of the live rows
    const int skip = owner == rank ? rl : -1;
    const int x1 = j + 1 < P ? j + 1 : -1;  // warp 0's row
    if (x1 >= 0 && tid < 32) {
      // warp 0: row j+1 first, then the next step's candidate, posted
      // while the other warps update the remaining rows
      update_one_row(buf, ks, is, x1, pcol[x1], cvec, cs, nl, skip);
      __syncwarp();
      post_candidate<CS>(cluster, buf, ks, is, x1, av, nl, lane0, rank,
                         par ^ 1, slot_s, slot_v, slot_i, slot_z);
    } else {
      const int t0 = x1 >= 0 ? 32 : 0;
      if (IN_SMEM)
        update_smem<4>(sbuf, S, pcol, nl, j, k_lo, P, j, x1, skip, tid - t0,
                       nthr - t0);
      else
        update_global<8>(buf, ks, pcol, cvec, nl, k_lo, P, j, x1, skip,
                         tid - t0, nthr - t0);
    }
    if (x1 >= 0) {
      // the one cluster barrier of the step: this CTA's rows are updated
      // and its candidate for step j+1 posted
      cluster_arrive();
      cluster_wait();
    }
  }
  // keep this CTA's shared memory alive until every CTA has read it
  cluster.sync();

  if (IN_SMEM && WANT_CT) {
    for (int e = tid; e < P * nl; e += nthr) {
      const int k = e / nl, i = e - k * nl;
      ct[off + (int64_t)k * Npl + lane0 + i] = sbuf[(size_t)i * S + k];
    }
  }
  for (int i = tid; i < nl; i += nthr)
    avail_out[(int64_t)g * Npl + lane0 + i] = av[i];
}

typedef void (*KernelFn)(const float*, const float*, float*, float*, int*,
                         float*, int, int, int);

template <int CS>
KernelFn pick(bool want_ct, bool in_smem) {
  if (want_ct)
    return in_smem ? panel_factor_kernel<CS, true, true>
                   : panel_factor_kernel<CS, true, false>;
  return in_smem ? panel_factor_kernel<CS, false, true>
                 : panel_factor_kernel<CS, false, false>;
}

// The kernel instance of (cs, want_ct, in_smem) with its attributes set for
// `smem` bytes, and its launch configuration over G <= MAX_BATCH entries.
cudaError_t prepare(int cs, bool want_ct, bool in_smem, size_t smem,
                    int threads, int G, cudaStream_t s, KernelFn* fn,
                    cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  if (cs == 8) {
    *fn = pick<8>(want_ct, in_smem);
  } else if (cs == 16) {
    *fn = pick<16>(want_ct, in_smem);
  } else {
    return cudaErrorInvalidValue;
  }
  if (smem > (size_t)MAX_SMEM || (threads != 256 && threads != MAX_THREADS))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      *fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  if (cs > 8) {
    e = cudaFuncSetAttribute(
        *fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(cs, G);
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = s;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

// How many clusters of `cs` CTAs of `threads` threads at the shared memory
// of a [P, Npl] panel (buffer in shared memory or not) the card can hold at
// once: 0 means such a cluster cannot be placed on any of its GPCs.
extern "C" int morfem_panel_factor_max_clusters(int P, int Npl, int want_ct,
                                                int cs, int in_smem,
                                                int threads, int* count) {
  if (P <= 0 || Npl <= 0 || P > Npl || cs <= 0)
    return (int)cudaErrorInvalidValue;
  const int L = (Npl + cs - 1) / cs;
  const size_t smem = smem_bytes(P, L, cs, in_smem != 0);
  KernelFn fn;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = prepare(cs, want_ct != 0, in_smem != 0, smem, threads, 1,
                          0, &fn, &cfg, &attr);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveClusters(count, (const void*)fn, &cfg);
}

extern "C" int morfem_panel_factor(const float* panel_t, const float* avail,
                                   float* fac, float* ct, int* piv,
                                   float* avail_out, int G, int P, int Npl,
                                   int want_ct, int cs, int in_smem,
                                   int threads, void* stream) {
  if (G <= 0 || P <= 0 || Npl <= 0 || P > Npl || cs <= 0)
    return (int)cudaErrorInvalidValue;
  if (want_ct && ct == nullptr) return (int)cudaErrorInvalidValue;
  const int L = (Npl + cs - 1) / cs;
  const size_t smem = smem_bytes(P, L, cs, in_smem != 0);
  KernelFn fn;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e =
      prepare(cs, want_ct != 0, in_smem != 0, smem, threads,
              std::min(G, MAX_BATCH), (cudaStream_t)stream, &fn, &cfg, &attr);
  if (e != cudaSuccess) return (int)e;
  for (int g0 = 0; g0 < G; g0 += MAX_BATCH) {
    const int64_t pan = (int64_t)g0 * P * Npl, lanes = (int64_t)g0 * Npl;
    cfg.gridDim.y = std::min(G - g0, MAX_BATCH);
    e = cudaLaunchKernelEx(&cfg, fn, panel_t + pan, avail + lanes, fac + pan,
                           ct ? ct + pan : ct, piv + (int64_t)g0 * P,
                           avail_out + lanes, P, Npl, L);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}
