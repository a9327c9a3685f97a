// K8a: batched dense solve by Householder QR without pivoting with the
// right-hand side kept apart from A, then back substitution, for sm_90a: the
// Newton step's Schur solve of a one-instance solve on tier "schur_pallas".
//
// Replaces mcp_tpu/kernels/linear_solve.py::_qr_solve_kernel (:38). Same
// reflectors, which round otherwise than K4b's (qr_dense.cu): for column k,
// v = A[k:, k], norm = sqrt(v.v + 1e-30), alpha = -sign(v_k) norm,
// u = v - alpha e_k, beta = 2 / (u.u + 1e-30) if u.u > 1e-30 else 0; b is
// kept apart from A and takes the same reflections; finally
// x_k = (c_k - R[k, k+1:] x[k+1:]) / R[k, k] with the raw R diagonal. A zero
// pivot gives inf/NaN in x; nothing sanitizes it (the solver's linesearch
// flags it as a failed linear solve). The reflections are applied in panels
// as one compact-WY block reflector, so the sums round otherwise than the
// unblocked plain version's (held by the condition-scaled QR rule). Columns
// left of a panel, whose rows from the panel down hold only rounding residue
// that the back substitution never reads, are not updated.
//
// Bound on this card (NVIDIA H100 80GB HBM3): at the lane-change path's shape
// (one system, n=200, float32) the kernel must read A and b and write x,
// 161.6 KB: 0.05 us at 3.35 TB/s; its ~10.7 MFLOP (chip_smoke.sep_counts)
// take 0.16 us at the 67 TFLOP/s float32 rate: bound by operations. The n
// reflections are a serial chain, which neither bound sees.
//
// Design: one thread block cluster of C CTAs per system (the plan,
// linear_solve.qr_sep_plan: C = 8 at n = 200, 4 at n = 100). CTA r keeps a
// column slab A[:, lo[r]:lo[r+1]] of whole panels of kNb columns in its
// shared memory (row stride odd), the last CTA also b as one more column;
// at n = 200 the widest slab is 32 columns, 45 KB per CTA in float32 and
// 89 KB in float64. Per panel of kNb columns, one cluster barrier:
//   * the panel's owner factors it with one warp per panel column, the
//     column's rows in registers: warp kk forms reflector kk (one pass, one
//     warp reduction) and writes u, the warps of later columns apply it to
//     theirs after one block barrier; then T of I - U T U^T by LAPACK's
//     larft (T[:k, k] = -beta T (U^T u), T[k, k] = beta);
//   * after the barrier every other CTA copies U and T from the owner's
//     shared memory (distributed shared memory, ld.shared::cluster; U and
//     T alternate between two buffers, so one barrier per panel suffices)
//     and applies the block reflector to its columns right of the panel
//     (and b): W = U^T A_slab (a warp per column, kNb sums per lane in
//     registers), W <- T^T W, A_slab -= U W (a thread per row, the row of U
//     in registers);
//   * the owner of the next panel updates that panel's columns first and
//     factors it before the rest of its slab (lookahead), so the chain of
//     panels waits only for the next panel's columns.
// The back substitution runs along the cluster from the last slab to the
// first: CTA r solves its diagonal triangle 32 columns at a time in one warp
// (shuffles, no barrier per column), subtracts R[:lo[r], slab] x_slab from
// the right-hand side with all its threads and hands the rest to CTA r-1
// (C cluster barriers). The launch checks with cudaOccupancyMaxActiveClusters
// that a cluster of that size can be resident and returns an error if not.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kNb = 8;       // panel width (linear_solve.QR_SEP_PANEL)
constexpr int kUs = kNb + 1;  // row stride of U (odd: conflict-free row walks)
constexpr int kMaxCluster = 8;

struct SepPlan {
  int C;
  int lo[kMaxCluster + 1];  // CTA r owns columns [lo[r], lo[r+1])
};

__device__ __forceinline__ float dsqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double dsqrt(double v) { return sqrt(v); }

// Copy n elements from this CTA's shared memory at p to the same place in
// CTA r of the cluster.
template <typename T>
__device__ __forceinline__ void send(const T* p, int n, int r) {
  const unsigned a = cluster::addr(p, r);
  for (int e = threadIdx.x; e < n; e += kThreads) cluster::st(a + e * (unsigned)sizeof(T), p[e]);
}

// Copy n elements from the same place in CTA r of the cluster to this CTA's
// shared memory at p.
template <typename T>
__device__ __forceinline__ void fetch(T* p, int n, int r) {
  const unsigned a = cluster::addr(p, r);
  for (int e = threadIdx.x; e < n; e += kThreads) p[e] = cluster::ld(a + e * (unsigned)sizeof(T), T());
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Row stride of a slab of `wsmax` columns plus b: odd.
__host__ __device__ __forceinline__ int slab_ld(int wsmax) { return (wsmax + 1) | 1; }

// Shared-memory layout, the same in every CTA of a cluster (elements of T):
// A slab n x lda, U 2 x n x kUs, T 2 x kNb^2, W two kNb x lda, Z kNb^2,
// beta kNb, c n, xs 32.
__host__ __device__ __forceinline__ long long sep_elems(int n, int wsmax) {
  const int lda = slab_ld(wsmax);
  return (long long)n * lda + 2LL * n * kUs + 2 * kNb * kNb + 2LL * kNb * lda + kNb * kNb +
         kNb + n + 32;
}

template <typename T>
struct SepSmem {
  T *A, *U[2], *Tm[2], *Wa, *Wb, *Z, *beta, *c, *xs;
};

template <typename T>
__device__ __forceinline__ SepSmem<T> sep_carve(T* p, int n, int lda) {
  SepSmem<T> s;
  s.A = p;
  p += (size_t)n * lda;
  s.U[0] = p;
  p += (size_t)n * kUs;
  s.U[1] = p;
  p += (size_t)n * kUs;
  s.Tm[0] = p;
  p += kNb * kNb;
  s.Tm[1] = p;
  p += kNb * kNb;
  s.Wa = p;
  p += kNb * lda;
  s.Wb = p;
  p += kNb * lda;
  s.Z = p;
  p += kNb * kNb;
  s.beta = p;
  p += kNb;
  s.c = p;
  p += n;
  s.xs = p;
  return s;
}

// The panel [j0, j0 + w) of the owner's slab (local columns from pl): its w
// reflections, U (rows j0..n-1) and T into buffer `buf`. Warp c keeps panel
// column c (rows j0 + lane + 32t, t < MAXR) in registers for the whole
// panel: per reflection the reflector's warp reads none of shared memory
// but writes u, and the other warps read u once.
template <int MAXR, typename T>
__device__ __forceinline__ void factor_panel(SepSmem<T> s, int buf, int n, int lda, int j0, int w,
                                             int pl) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T eps = T(1e-30);
  T* const U = s.U[buf];
  T* const col = s.A + pl + warp;  // this warp's panel column (warp < w)
  T cv[MAXR];
#pragma unroll
  for (int t = 0; t < MAXR; ++t) {
    const int i = j0 + lane + 32 * t;
    cv[t] = warp < w && i < n ? col[(size_t)i * lda] : T(0);
  }
  for (int kk = 0; kk < w; ++kk) {
    const int k = j0 + kk, tk = kk >> 5, lk = kk & 31;
    if (warp == kk) {
      // u = v below row k, s1 the sum of their squares; v.v = s1 + v_k^2,
      // u.u = s1 + u_k^2 and u.v = s1 + u_k v_k.
      T s1 = T(0), mine = T(0);
#pragma unroll
      for (int t = 0; t < MAXR; ++t) {
        const int i = j0 + lane + 32 * t;
        if (i > k && i < n) s1 += cv[t] * cv[t];
        if (t == tk) mine = cv[t];
      }
      s1 = warp_sum(s1);
      const T vk = __shfl_sync(0xffffffffu, mine, lk);
      const T norm = dsqrt(s1 + vk * vk + eps);
      const T alpha = vk >= T(0) ? -norm : norm;
      const T uk = vk - alpha;
      const T uu = s1 + uk * uk, uv = s1 + uk * vk;
      const T beta = uu > eps ? T(2) / (uu + eps) : T(0);
#pragma unroll
      for (int t = 0; t < MAXR; ++t) {
        const int i = j0 + lane + 32 * t;
        if (i < n) U[(size_t)(i - j0) * kUs + kk] = i > k ? cv[t] : (i == k ? uk : T(0));
      }
      // Only R[k, k] of this column is read again.
      if (lane == lk) {
#pragma unroll
        for (int t = 0; t < MAXR; ++t)
          if (t == tk) cv[t] = vk - (beta * uk) * uv;
      }
      if (lane == 0) s.beta[kk] = beta;
    }
    __syncthreads();
    if (warp > kk && warp < w) {
      T u[MAXR];
      T d = T(0);
#pragma unroll
      for (int t = 0; t < MAXR; ++t) {
        const int i = j0 + lane + 32 * t;
        u[t] = i >= k && i < n ? U[(size_t)(i - j0) * kUs + kk] : T(0);
        d += u[t] * cv[t];
      }
      d = warp_sum(d);
      const T beta = s.beta[kk];
#pragma unroll
      for (int t = 0; t < MAXR; ++t) cv[t] -= (beta * u[t]) * d;
    } else if (warp < kk) {
      T z = T(0);
      for (int i = k + lane; i < n; i += 32)
        z += U[(size_t)(i - j0) * kUs + warp] * U[(size_t)(i - j0) * kUs + kk];
      z = warp_sum(z);
      if (lane == 0) s.Z[warp * kNb + kk] = z;
    }
  }
  if (warp < w) {
#pragma unroll
    for (int t = 0; t < MAXR; ++t) {
      const int i = j0 + lane + 32 * t;
      if (i < n) col[(size_t)i * lda] = cv[t];
    }
  }
  __syncthreads();
  // larft, forward and columnwise: lane i builds row i of T.
  if (warp == 0 && lane < w) {
    T* Tm = s.Tm[buf];
    for (int kk = 0; kk < w; ++kk) {
      T t = T(0);
      if (lane < kk) {
        T acc = T(0);
        for (int j = lane; j < kk; ++j) acc += Tm[lane * kNb + j] * s.Z[j * kNb + kk];
        t = -s.beta[kk] * acc;
      } else if (lane == kk) {
        t = s.beta[kk];
      }
      Tm[lane * kNb + kk] = t;
    }
  }
}

// A_slab[j0:, c_from:c_to] -= U (T^T (U^T A_slab[j0:, c_from:c_to])): the block
// reflector of buffer `buf` on local columns [c_from, c_to). Ends with a
// block barrier.
template <typename T>
__device__ __forceinline__ void apply_panel(SepSmem<T> s, int buf, int n, int lda, int j0, int w,
                            int c_from, int c_to) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nc = c_to - c_from, m = n - j0;
  if (nc <= 0) return;
  const T* U = s.U[buf];
  const T* Tm = s.Tm[buf];
  for (int c = warp; c < nc; c += kThreads / 32) {
    T acc[kNb];
#pragma unroll
    for (int a = 0; a < kNb; ++a) acc[a] = T(0);
#pragma unroll 4
    for (int i = lane; i < m; i += 32) {
      const T v = s.A[(size_t)(j0 + i) * lda + c_from + c];
#pragma unroll
      for (int a = 0; a < kNb; ++a) acc[a] += U[(size_t)i * kUs + a] * v;
    }
#pragma unroll
    for (int a = 0; a < kNb; ++a) acc[a] = warp_sum(acc[a]);
    if (lane < w) {
      T v = T(0);
#pragma unroll
      for (int a = 0; a < kNb; ++a)
        if (a == lane) v = acc[a];
      s.Wa[lane * lda + c] = v;
    }
  }
  __syncthreads();
  for (int e = tid; e < w * nc; e += kThreads) {
    const int a = e / nc, c = e - a * nc;
    T acc = T(0);
    for (int j = 0; j <= a; ++j) acc += Tm[j * kNb + a] * s.Wa[j * lda + c];
    s.Wb[a * lda + c] = acc;
  }
  __syncthreads();
  for (int i = tid; i < m; i += kThreads) {
    T u[kNb];
#pragma unroll
    for (int a = 0; a < kNb; ++a) u[a] = a < w ? U[(size_t)i * kUs + a] : T(0);
    T* row = s.A + (size_t)(j0 + i) * lda + c_from;
    for (int c = 0; c < nc; ++c) {
      T acc = T(0);
#pragma unroll
      for (int a = 0; a < kNb; ++a)
        if (a < w) acc += u[a] * s.Wb[a * lda + c];
      row[c] -= acc;
    }
  }
  __syncthreads();
}

// The owner's panel at j0: factor it (the other CTAs fetch U and T from it
// after the next cluster barrier).
template <int MAXR, typename T>
__device__ __forceinline__ void factor(SepSmem<T> s, int n, int lda, int j0, int c0) {
  factor_panel<MAXR>(s, (j0 / kNb) & 1, n, lda, j0, min(kNb, n - j0), j0 - c0);
}

template <typename T, int MAXR>
__global__ void __launch_bounds__(kThreads) qr_sep_kernel(const T* __restrict__ A,
                                                          const T* __restrict__ b,
                                                          T* __restrict__ x, int n, SepPlan plan,
                                                          int wsmax) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = plan.C;
  const int rank = (int)cg::this_cluster().block_rank();
  const long long sys = blockIdx.x / C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lda = slab_ld(wsmax);
  const SepSmem<T> s = sep_carve(reinterpret_cast<T*>(smem_raw), n, lda);
  const int c0 = plan.lo[rank], c1 = plan.lo[rank + 1], ws = c1 - c0;
  const bool has_b = rank == C - 1;
  const int wcols = ws + (has_b ? 1 : 0);  // local columns, b last

  const T* A_sys = A + sys * n * n;
  for (int i = warp; i < n; i += kThreads / 32)
    for (int j = lane; j < ws; j += 32) s.A[(size_t)i * lda + j] = A_sys[(size_t)i * n + c0 + j];
  if (has_b)
    for (int i = tid; i < n; i += kThreads) s.A[(size_t)i * lda + ws] = b[sys * n + i];
  cluster::barrier();  // every CTA runs: distributed shared memory is safe

  // Per panel: the owner of the next panel applies this panel's reflector to
  // the next panel's columns first, factors and sends it, then updates the
  // rest of its slab (lookahead); one cluster barrier per panel.
  const int npan = (n + kNb - 1) / kNb;
  if (c0 == 0) factor<MAXR>(s, n, lda, 0, c0);
  for (int p = 0; p < npan; ++p) {
    const int j0 = p * kNb, w = min(kNb, n - j0), buf = p & 1;
    cluster::barrier();
    if (j0 < c0 || j0 >= c1) {  // U and T of this panel from its owner
      int owner = 0;
      while (owner + 1 < C && plan.lo[owner + 1] <= j0) ++owner;
      fetch(s.U[buf], (n - j0) * kUs, owner);
      fetch(s.Tm[buf], kNb * kNb, owner);
      __syncthreads();
    }
    const int cl = max(0, j0 + w - c0);  // first local column right of the panel
    const int jn = j0 + kNb;               // the next panel
    if (jn < n && c0 <= jn && jn < c1) {
      const int wn = min(kNb, n - jn);
      apply_panel(s, buf, n, lda, j0, w, cl, cl + wn);
      factor<MAXR>(s, n, lda, jn, c0);
      apply_panel(s, buf, n, lda, j0, w, cl + wn, wcols);
    } else {
      apply_panel(s, buf, n, lda, j0, w, cl, wcols);
    }
  }

  // Back substitution R x = Q^T b along the cluster, last slab first.
  __syncthreads();  // the last update of b is done
  if (has_b)
    for (int i = tid; i < n; i += kThreads) s.c[i] = s.A[(size_t)i * lda + ws];
  T* x_sys = x + sys * n;
  for (int r = C - 1; r >= 0; --r) {
    if (r == rank) {
      __syncthreads();
      for (int e = c1; e > c0; e -= 32) {
        const int a = max(c0, e - 32), h = e - a;
        if (warp == 0) {
          T ci = lane < h ? s.c[a + lane] : T(0);
          T xi = T(0);
          for (int i = h - 1; i >= 0; --i) {
            const T piv = s.A[(size_t)(a + i) * lda + (a + i - c0)];
            const T xv = __shfl_sync(0xffffffffu, ci, i) / piv;
            if (lane == i) xi = xv;
            if (lane < i) ci -= s.A[(size_t)(a + lane) * lda + (a + i - c0)] * xv;
          }
          if (lane < h) {
            s.xs[lane] = xi;
            x_sys[a + lane] = xi;
          }
        }
        __syncthreads();
        for (int i = tid; i < a; i += kThreads) {
          T acc = T(0);
          const T* row = s.A + (size_t)i * lda + (a - c0);
          for (int j = 0; j < h; ++j) acc += row[j] * s.xs[j];
          s.c[i] -= acc;
        }
        __syncthreads();
      }
      if (rank > 0) send(s.c, c0, rank - 1);
    }
    cluster::barrier();
  }
}

template <typename T, int MAXR>
int launch(const void* A, const void* b, void* x, int B, int n, const SepPlan& plan,
           size_t smem, cudaStream_t stream) {
  int wsmax = 0;
  for (int r = 0; r < plan.C; ++r)
    wsmax = plan.lo[r + 1] - plan.lo[r] > wsmax ? plan.lo[r + 1] - plan.lo[r] : wsmax;
  if (smem != sizeof(T) * (size_t)sep_elems(n, wsmax)) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * plan.C), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = plan.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // Checked once per (dtype, C, smem): the attribute and the residency.
  static int checked_C = 0;
  static size_t checked_smem = 0;
  cudaError_t err;
  if (checked_C != plan.C || checked_smem != smem) {
    err = cudaFuncSetAttribute(qr_sep_kernel<T, MAXR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, qr_sep_kernel<T, MAXR>, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
    checked_C = plan.C;
    checked_smem = smem;
  }
  err = cudaLaunchKernelEx(&cfg, qr_sep_kernel<T, MAXR>, static_cast<const T*>(A),
                           static_cast<const T*>(b), static_cast<T*>(x), n, plan, wsmax);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = float64. Layouts (row-major, contiguous): A
// (B,n,n), b (B,n), x (B,n). The plan (linear_solve.qr_sep_plan): C CTAs per
// system, CTA r owning columns [lo[r], lo[r+1]) (lo has C+1 entries, whole
// panels of 8 columns), `smem` bytes of dynamic shared memory per CTA.
// Returns a CUDA error code (0 on success).
extern "C" int mcp_qr_sep_solve(int dtype, const void* A, const void* b, void* x, int B, int n,
                                int C, const int* lo, long long smem, void* stream) {
  if (C < 1 || C > kMaxCluster || (C & (C - 1)) != 0) return (int)cudaErrorInvalidValue;
  SepPlan plan{};
  plan.C = C;
  for (int r = 0; r <= C; ++r) plan.lo[r] = lo[r];
  if (plan.lo[0] != 0 || plan.lo[C] != n) return (int)cudaErrorInvalidValue;
  for (int r = 0; r < C; ++r)
    if (plan.lo[r + 1] <= plan.lo[r] || plan.lo[r] % kNb) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // Rows per lane of a panel column kept in registers: n <= 32 MAXR.
  if (n <= 256) {
    if (dtype == 0) return launch<float, 8>(A, b, x, B, n, plan, (size_t)smem, s);
    return launch<double, 8>(A, b, x, B, n, plan, (size_t)smem, s);
  }
  if (n <= 512) {
    if (dtype == 0) return launch<float, 16>(A, b, x, B, n, plan, (size_t)smem, s);
    return launch<double, 16>(A, b, x, B, n, plan, (size_t)smem, s);
  }
  if (n > 1024) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch<float, 32>(A, b, x, B, n, plan, (size_t)smem, s);
  return launch<double, 32>(A, b, x, B, n, plan, (size_t)smem, s);
}
