// The in-block augmented solves ("facts") of cyclic reduction K3
// (cyclic_reduction.cu) on a thread block cluster, for sm_90a: the working
// matrix M = [A | N (| I)] (b x ld) split into column slabs, one per CTA.
//
// The facts and their rounding are those of solve_aug.cuh (whose templates
// K1, K7a and K6 keep using) and of kernels/solve_aug.py, the plain versions:
// the eliminations round each product, sum and difference on their own
// (mul_rn / sub_rn / add_rn, no FMA contraction) in the plain version's
// order and form, pivot choice included, and which CTA holds a column
// changes no element's operation sequence; the contractions (gjp's head,
// the blocked trailing updates, the refinement products) sum in their own
// order.
//
// Layout. CTA r of a cluster of C (<= 8) holds columns [lo[r], lo[r+1]) of M,
// all b rows, row-major at stride lds in its shared memory; every CTA
// carves the same layout from the widest slab, so a pointer into one CTA's
// shared memory maps to the same place in another's (mapa). The
// blocked facts' panels of kPanel head columns never straddle two slabs
// (the plan, cyclic_reduction.cr_plan, puts slab edges inside the head on
// multiples of kPanel).
//
// Steps. Per elimination step k the owner of column k (after a block
// barrier) picks the pivot by the fact's rule (largest |entry| among unused
// rows, lowest row on ties, used rows scored -1, no pivot when a score is
// NaN; the pivot-free facts take row k), scales the clamped inverse into the
// b multipliers and writes (multipliers, 1/pivot, pivot row) into every
// CTA's step buffer; one cluster barrier follows and every CTA updates its
// own slab (its part of the pivot row is local). The step buffers alternate,
// so one cluster barrier per step suffices: the owner of step k+1 writes
// after the barrier of step k, which every CTA reaches only after it has
// read the buffer of step k-1. The QR fact broadcasts (u, beta) the same
// way. The blocked facts factor a panel in its owner, then broadcast its W
// (b x w) and pivot rows (two cluster barriers per panel) and every CTA does
// the trailing update of its slab as a register-tiled product.
//
// Cross-slab products (gjp's head contraction, the refinement's A^-1, QR's
// back substitution with R) go through global memory: the owners write the
// b x b operand to the cluster's scratch, fence, one cluster barrier, and
// every CTA reads it from L2 (ld.global.cg) into a staged, register-tiled
// product over its own columns.

#pragma once

#include <cuda_runtime.h>

#include "cluster.cuh"
#include "solve_aug.cuh"

namespace solve_aug_slab {

using solve_aug::add_rn;
using solve_aug::clamped_inverse;
using solve_aug::dsqrt;
using solve_aug::kPanel;
using solve_aug::mul_rn;
using solve_aug::sub_rn;
using solve_aug::warp_sum;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;
constexpr int kRM = 4, kRN = 4;  // register tile of the products
constexpr int kKT = 16;          // rows of the left operand staged per pass
constexpr int kLaneCols = 8;     // columns per lane per pass of a step update

// The slab bounds of one launch: CTA r owns columns [lo[r], lo[r+1]).
struct Cols {
  int C;
  int lo[kMaxCluster + 1];
};

// The cluster's barrier; a cluster of one CTA takes the block barrier.
__device__ __forceinline__ void csync(int C) {
  if (C > 1)
    cluster::barrier();
  else
    __syncthreads();
}

// Store v at p (this CTA's shared memory) in CTA r of a cluster of C.
template <typename T>
__device__ __forceinline__ void put(int C, T* p, int r, T v) {
  cluster::st(C > 1 ? cluster::addr(p, r) : (unsigned)__cvta_generic_to_shared(p), v);
}

__host__ __device__ __forceinline__ bool blocked(int fam) { return fam >= solve_aug::kGJB; }

// Scratch of the blocked trailing update, the unscramble and the refinement
// residual: kPanel x max(lds, b) elements.
__host__ __device__ __forceinline__ int scratch_elems(int b, int lds, int fam, int refine) {
  return (blocked(fam) || refine) ? kPanel * (lds > b ? lds : b) : 0;
}

// Elements of T in one CTA's working set (piv's ints counted apart): M b x
// lds, two step buffers of b + 2, the pivot row (lds, at least kPanel), W's
// pivot row (kPanel), used (b), four scalars, W (b x kPanel, blocked), the
// scratch and the staged left operand (kKT x b).
__host__ __device__ __forceinline__ long long slab_elems(int b, int lds, int fam, int refine) {
  return (long long)b * lds + 2LL * (b + 2) + (lds > kPanel ? lds : kPanel) + kPanel + b + 4 +
         (blocked(fam) ? (long long)b * kPanel : 0) + scratch_elems(b, lds, fam, refine) +
         (long long)kKT * b;
}

__host__ __device__ __forceinline__ size_t slab_bytes(int b, int lds, int fam, int refine,
                                                      size_t sz) {
  return sz * (size_t)slab_elems(b, lds, fam, refine) + sizeof(int) * (size_t)b;
}

template <typename T>
struct Slab {
  T* M;     // b x lds, local columns 0..ws-1 = global c0..c1-1
  T* step;  // 2 x (b + 2): multipliers or u, then 1/pivot or beta, then the pivot row
  T* prow;  // the pivot row of this slab
  T* wrow;  // kPanel: W's pivot row plus e_j
  T* used;  // b
  T* sc;    // 4 scalars
  T* W;     // b x kPanel
  T* scr;   // scratch
  T* At;    // kKT x b: staged left operand, transposed
  int* piv;  // b
  int b, lds, c0, c1, ws, rank, C;
  // Whether this CTA holds column `col`.
  __device__ __forceinline__ bool owns(int col) const { return c0 <= col && col < c1; }
};

template <typename T>
__device__ __forceinline__ Slab<T> carve(unsigned char* raw, int b, int lds, int fam, int refine,
                         const Cols& cols, int rank) {
  Slab<T> s;
  T* p = reinterpret_cast<T*>(raw);
  s.M = p;
  p += (size_t)b * lds;
  s.step = p;
  p += 2 * (b + 2);
  s.prow = p;
  p += lds > kPanel ? lds : kPanel;
  s.wrow = p;
  p += kPanel;
  s.used = p;
  p += b;
  s.sc = p;
  p += 4;
  s.W = p;
  p += blocked(fam) ? (size_t)b * kPanel : 0;
  s.scr = p;
  p += scratch_elems(b, lds, fam, refine);
  s.At = p;
  p += (size_t)kKT * b;
  s.piv = reinterpret_cast<int*>(p);
  s.b = b;
  s.lds = lds;
  s.C = cols.C;
  s.rank = rank;
  s.c0 = cols.lo[rank];
  s.c1 = cols.lo[rank + 1];
  s.ws = s.c1 - s.c0;
  return s;
}

// Coherent read of data another CTA wrote in this launch (bypasses L1).
template <typename T>
__device__ __forceinline__ T ld_cg(const T* p) {
  return __ldcg(p);
}

// out(i, c) = sum_m A(i, m) S[m * lds_s + c] for i < rows, c < ncols, over
// m < K: the left operand staged kKT rows of m at a time into At
// (transposed; read along m when A_ROWS, the operand being row-major in
// memory, else along i), a kRM x kRN tile of sums in registers per thread,
// columns in chunks of at most `cwmax` that every thread's single tile
// covers. With INPLACE the epilogue runs after a block barrier (it may
// overwrite S). Begins and ends with a block barrier.
template <bool INPLACE, bool A_ROWS, typename T, typename AF, typename EF>
__device__ __forceinline__ void tile_product(Slab<T> s, int rows, int K, const AF& A, const T* S,
                             int lds_s, int ncols, int cwmax, const EF& epi) {
  const int tid = threadIdx.x;
  const int rt = (rows + kRM - 1) / kRM;
  const int ct = kThreads / rt;
  int cw = ct * kRN;
  if (cw > cwmax) cw = cwmax;
  const int ti = tid % rt, tj = tid / rt;
  const int i0 = ti * kRM, j0 = tj * kRN;
  const bool active = tj < ct && j0 < cw;
  __syncthreads();
  for (int cc = 0; cc < ncols; cc += cw) {
    const int cn = min(cw, ncols - cc);
    T acc[kRM][kRN];
#pragma unroll
    for (int a = 0; a < kRM; ++a)
#pragma unroll
      for (int c = 0; c < kRN; ++c) acc[a][c] = T(0);
    for (int m0 = 0; m0 < K; m0 += kKT) {
      const int kt = min(kKT, K - m0);
      for (int e = tid; e < kt * rows; e += kThreads) {
        int m, i;
        if (A_ROWS) {
          i = e / kt;
          m = e - i * kt;
        } else {
          m = e / rows;
          i = e - m * rows;
        }
        s.At[m * rows + i] = A(i, m0 + m);
      }
      __syncthreads();
      if (active && j0 < cn) {
        for (int m = 0; m < kt; ++m) {
          T a[kRM], v[kRN];
#pragma unroll
          for (int q = 0; q < kRM; ++q) a[q] = i0 + q < rows ? s.At[m * rows + i0 + q] : T(0);
          const T* srow = S + (size_t)(m0 + m) * lds_s + cc + j0;
#pragma unroll
          for (int c = 0; c < kRN; ++c) v[c] = j0 + c < cn ? srow[c] : T(0);
#pragma unroll
          for (int q = 0; q < kRM; ++q)
#pragma unroll
            for (int c = 0; c < kRN; ++c) acc[q][c] += a[q] * v[c];
        }
      }
      __syncthreads();
    }
    if (active && j0 < cn) {
#pragma unroll
      for (int q = 0; q < kRM; ++q)
#pragma unroll
        for (int c = 0; c < kRN; ++c)
          if (i0 + q < rows && j0 + c < cn) epi(i0 + q, cc + j0 + c, acc[q][c]);
    }
    if (INPLACE) __syncthreads();
  }
  __syncthreads();
}

// Load this slab of [orig | I (refine)] (orig: b x (b + nrhs)).
template <typename T, typename Orig>
__device__ __forceinline__ void load_slab(Slab<T> s, int nrhs, const Orig& orig) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n0 = s.b + nrhs;
  for (int i = warp; i < s.b; i += kWarps)
    for (int j = lane; j < s.ws; j += 32) {
      const int g = s.c0 + j;
      s.M[(size_t)i * s.lds + j] = g < n0 ? orig(i, g) : (g - n0 == i ? T(1) : T(0));
    }
}

// The pivot of local column kl among the unused rows (warp 0): p (b when
// none) and the clamped 1/pivot in every lane.
template <typename T>
__device__ __forceinline__ void find_pivot(Slab<T> s, int kl, int& p_out, T& inv_out) {
  const int lane = threadIdx.x & 31;
  const int b = s.b;
  T best = T(0);
  int bi = b, seen = 0, nan = 0;
  for (int i = lane; i < b; i += 32) {
    const T c = s.M[(size_t)i * s.lds + kl];
    const T u = s.used[i];
    const T sc = sub_rn(mul_rn(c >= T(0) ? c : -c, sub_rn(T(1), u)), u);
    if (sc != sc) {
      nan = 1;
    } else if (!seen || sc > best) {  // rows ascend: ties keep the first
      best = sc;
      bi = i;
      seen = 1;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const T ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    const int os = __shfl_xor_sync(0xffffffffu, seen, off);
    if (os && (!seen || ob > best || (ob == best && oi < bi))) {
      best = ob;
      bi = oi;
      seen = 1;
    }
  }
  nan = __any_sync(0xffffffffu, nan);
  const int p = (nan || !seen) ? b : bi;
  p_out = p;
  inv_out = clamped_inverse(p < b ? s.M[(size_t)p * s.lds + kl] : T(0));
}

// Step k's owner (warp 0): pivot and multipliers of column k into every
// CTA's step buffer k & 1.
template <bool PIVOTED, typename T>
__device__ __forceinline__ void gj_broadcast(Slab<T> s, int k) {
  if ((threadIdx.x >> 5) != 0) return;
  const int lane = threadIdx.x & 31, b = s.b, kl = k - s.c0;
  int p;
  T inv;
  if (PIVOTED) {
    find_pivot(s, kl, p, inv);
  } else {
    p = k;
    inv = clamped_inverse(s.M[(size_t)k * s.lds + kl]);
  }
  T* const buf = s.step + (k & 1) * (b + 2);
  for (int i = lane; i < b; i += 32) {
    const T f = mul_rn(s.M[(size_t)i * s.lds + kl], inv);
    for (int r = 0; r < s.C; ++r) put(s.C, buf + i, r, f);
  }
  if (lane == 0)
    for (int r = 0; r < s.C; ++r) {
      put(s.C, buf + b, r, inv);
      put(s.C, buf + b + 1, r, T(p));
    }
}

// Gauss-Jordan, pivot-free (PIVOTED false: columns right of k only, as
// solve_aug::gj_eliminate) or with implicit partial pivoting on every column
// (PIVOTED true, solve_aug::gjp_eliminate).
template <bool PIVOTED, typename T>
__device__ __forceinline__ void gj_slab(Slab<T> s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = s.b, lds = s.lds, ws = s.ws;
  for (int i = tid; i < b; i += kThreads) s.used[i] = T(0);
  __syncthreads();
  if (s.owns(0)) gj_broadcast<PIVOTED>(s, 0);
  csync(s.C);
  for (int k = 0; k < b; ++k) {
    const T* st = s.step + (k & 1) * (b + 2);
    const T inv = st[b];
    const int p = (int)st[b + 1];
    const int lo = PIVOTED ? 0 : max(0, k + 1 - s.c0);
    for (int j = lo + tid; j < ws; j += kThreads)
      s.prow[j] = p < b ? s.M[(size_t)p * lds + j] : T(0);
    __syncthreads();
    for (int cs = lo; cs < ws; cs += 32 * kLaneCols) {
      T pr[kLaneCols];
#pragma unroll
      for (int t = 0; t < kLaneCols; ++t) {
        const int j = cs + lane + 32 * t;
        pr[t] = j < ws ? s.prow[j] : T(0);
      }
      for (int i = warp; i < b; i += kWarps) {
        T* row = s.M + (size_t)i * lds;
        if (i == p) {
#pragma unroll
          for (int t = 0; t < kLaneCols; ++t) {
            const int j = cs + lane + 32 * t;
            if (j < ws) row[j] = mul_rn(pr[t], inv);
          }
        } else {
          const T fi = st[i];
#pragma unroll
          for (int t = 0; t < kLaneCols; ++t) {
            const int j = cs + lane + 32 * t;
            if (j < ws) row[j] = sub_rn(row[j], mul_rn(fi, pr[t]));
          }
        }
      }
    }
    if (PIVOTED && tid == 0 && p < b) s.used[p] = T(1);
    if (k + 1 < b && s.owns(k + 1)) {
      __syncthreads();
      gj_broadcast<PIVOTED>(s, k + 1);
    }
    csync(s.C);
  }
}

// Householder QR without pivoting (solve_aug::qr_solve's reflectors):
// step k's owner broadcasts u (rows k..b-1) and beta; every CTA applies the
// reflection to its columns from k on, a thread per column.
template <typename T>
__device__ __forceinline__ void qr_broadcast(Slab<T> s, int k) {
  if ((threadIdx.x >> 5) != 0) return;
  const int lane = threadIdx.x & 31, b = s.b, kl = k - s.c0;
  const T eps = T(1e-30);
  T ss = T(0);
  for (int i = k + lane; i < b; i += 32) {
    const T v = s.M[(size_t)i * s.lds + kl];
    ss += v * v;
  }
  ss = warp_sum(ss);
  const T vk = s.M[(size_t)k * s.lds + kl];
  const T norm = dsqrt(ss + eps);
  const T sgn = vk >= T(0) ? T(1) : T(-1);
  const T avk = vk >= T(0) ? vk : -vk;
  const T uk = vk + sgn * norm;
  const T beta = T(1) / (norm * (norm + avk) + eps);
  T* const buf = s.step + (k & 1) * (b + 2);
  for (int i = k + lane; i < b; i += 32) {
    const T u = i == k ? uk : s.M[(size_t)i * s.lds + kl];
    for (int r = 0; r < s.C; ++r) put(s.C, buf + i, r, u);
  }
  if (lane == 0)
    for (int r = 0; r < s.C; ++r) put(s.C, buf + b, r, beta);
}

// QR of the head applied to every column, then the back substitution
// M[:, b:] <- R^-1 M[:, b:] with R read from `hs` (global, b x b).
template <typename T>
__device__ __forceinline__ void qr_slab(Slab<T> s, T* hs) {
  const int tid = threadIdx.x, b = s.b, lds = s.lds, ws = s.ws;
  if (s.owns(0)) qr_broadcast(s, 0);
  csync(s.C);
  for (int k = 0; k < b; ++k) {
    const T* u = s.step + (k & 1) * (b + 2);
    const T beta = u[b];
    for (int j = max(0, k - s.c0) + tid; j < ws; j += kThreads) {
      T w = T(0);
      for (int i = k; i < b; ++i) w += u[i] * s.M[(size_t)i * lds + j];
      for (int i = k; i < b; ++i) s.M[(size_t)i * lds + j] -= (beta * u[i]) * w;
    }
    if (k + 1 < b && s.owns(k + 1)) {
      __syncthreads();
      qr_broadcast(s, k + 1);
    }
    csync(s.C);
  }
  // R to global, then each right-hand column on its own thread.
  for (int i = threadIdx.x >> 5; i < b; i += kWarps)
    for (int j = (threadIdx.x & 31); j < ws && s.c0 + j < b; j += 32)
      hs[(size_t)i * b + s.c0 + j] = s.M[(size_t)i * lds + j];
  __threadfence();
  csync(s.C);
  for (int j = max(0, b - s.c0) + tid; j < ws; j += kThreads) {
    for (int k = b - 1; k >= 0; --k) {
      T acc = s.M[(size_t)k * lds + j];
      for (int m = k + 1; m < b; ++m) acc -= ld_cg(hs + (size_t)k * b + m) * s.M[(size_t)m * lds + j];
      s.M[(size_t)k * lds + j] = acc / ld_cg(hs + (size_t)k * b + k);
    }
  }
  __syncthreads();
}

// Blocked Gauss-Jordan (solve_aug::gjb_eliminate) over panels of kPanel head
// columns, pivot-free or with gjp's pivot sequence; the pivoted variant
// leaves the rows in pivot order.
template <bool PIVOTED, typename T>
__device__ __forceinline__ void gjb_slab(Slab<T> s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = s.b, lds = s.lds, ws = s.ws;
  T* u = s.step;  // b multipliers of a panel step (local)
  for (int i = tid; i < b; i += kThreads) s.used[i] = T(0);
  for (int k0 = 0; k0 < b; k0 += kPanel) {
    const int w = min(kPanel, b - k0);
    const bool own = s.owns(k0);
    if (own) {
      const int pl = k0 - s.c0;
      __syncthreads();
      for (int e = tid; e < b * kPanel; e += kThreads) s.W[e] = T(0);
      __syncthreads();
      for (int j = 0; j < w; ++j) {
        const int cj = k0 + j;
        int p;
        T inv;
        if (PIVOTED) {
          if (warp == 0) {
            find_pivot(s, pl + j, p, inv);
            if (lane == 0) {
              s.sc[0] = inv;
              s.sc[1] = T(p);
            }
          }
          __syncthreads();
          p = (int)s.sc[1];
          inv = s.sc[0];
        } else {
          p = cj;
          inv = clamped_inverse(s.M[(size_t)p * lds + pl + j]);
        }
        for (int i = tid; i < b; i += kThreads)
          u[i] = i == p ? sub_rn(inv, T(1)) : -mul_rn(s.M[(size_t)i * lds + pl + j], inv);
        for (int c = tid; c < w; c += kThreads) {
          s.prow[c] = p < b ? s.M[(size_t)p * lds + pl + c] : T(0);
          s.wrow[c] = add_rn(p < b ? s.W[p * kPanel + c] : T(0), c == j ? T(1) : T(0));
        }
        __syncthreads();
        for (int i = warp; i < b; i += kWarps) {
          const T ui = u[i];
          T* row = s.M + (size_t)i * lds + pl;
          for (int c = j + 1 + lane; c < w; c += 32) row[c] = add_rn(row[c], mul_rn(ui, s.prow[c]));
          for (int c = lane; c < w; c += 32)
            s.W[i * kPanel + c] = add_rn(s.W[i * kPanel + c], mul_rn(ui, s.wrow[c]));
        }
        if (PIVOTED && tid == 0) {
          s.piv[cj] = p;
          if (p < b) s.used[p] = T(1);
        }
        __syncthreads();
      }
    }
    csync(s.C);  // every CTA is past its previous trailing update
    if (own) {
      for (int r = 0; r < s.C; ++r) {
        if (r == s.rank) continue;
        for (int e = tid; e < b * kPanel; e += kThreads) put(s.C, s.W + e, r, s.W[e]);
        if (PIVOTED)
          for (int j = tid; j < w; j += kThreads) put(s.C, s.piv + k0 + j, r, s.piv[k0 + j]);
      }
    }
    csync(s.C);
    if (PIVOTED && !own && tid == 0)
      for (int j = 0; j < w; ++j)
        if (s.piv[k0 + j] < b) s.used[s.piv[k0 + j]] = T(1);
    // Trailing update of this slab's columns right of the panel: the
    // panel's pivot rows into the scratch, then M += W * scratch.
    const int tl = max(0, k0 + w - s.c0);
    const int nc = ws - tl;
    if (nc <= 0) continue;
    for (int cs = 0; cs < nc; cs += lds) {
      const int cn = min(lds, nc - cs);
      for (int e = tid; e < w * cn; e += kThreads) {
        const int jj = e / cn, c = e - jj * cn;
        const int r = PIVOTED ? s.piv[k0 + jj] : k0 + jj;
        s.scr[jj * cn + c] = r < b ? s.M[(size_t)r * lds + tl + cs + c] : T(0);
      }
      const T* W = s.W;
      tile_product<false, true>(
          s, b, w, [=](int i, int m) { return W[i * kPanel + m]; }, s.scr, cn, cn, cn,
          [=](int i, int c, T acc) {
            T* x = s.M + (size_t)i * lds + tl + cs + c;
            *x = add_rn(*x, acc);
          });
    }
  }
}

// Row k of this slab's columns from b on <- row piv[k] (zero where a step
// had no pivot): the per-panel O^T contraction, through the scratch.
template <typename T>
__device__ __forceinline__ void unscramble(Slab<T> s) {
  const int tid = threadIdx.x, b = s.b, lds = s.lds;
  const int lo = max(0, b - s.c0);
  const int cw = scratch_elems(b, lds, solve_aug::kGJBP, 0) / b;
  for (int cs = lo; cs < s.ws; cs += cw) {
    const int cn = min(cw, s.ws - cs);
    __syncthreads();
    for (int e = tid; e < b * cn; e += kThreads) {
      const int k = e / cn, c = e - k * cn;
      const int p = s.piv[k];
      s.scr[e] = p < b ? s.M[(size_t)p * lds + cs + c] : T(0);
    }
    __syncthreads();
    for (int e = tid; e < b * cn; e += kThreads) {
      const int k = e / cn, c = e - k * cn;
      s.M[(size_t)k * lds + cs + c] = s.scr[e];
    }
  }
  __syncthreads();
}

// Write this slab's part of the global columns [g0, g0 + b) of M to `dst`
// (b x b, row-major).
template <typename T>
__device__ __forceinline__ void slab_to_global(Slab<T> s, int g0, T* dst) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, b = s.b;
  const int ja = max(0, g0 - s.c0), je = min(s.ws, g0 + b - s.c0);
  for (int i = warp; i < b; i += kWarps)
    for (int j = ja + lane; j < je; j += 32) dst[(size_t)i * b + s.c0 + j - g0] = s.M[(size_t)i * s.lds + j];
}

// gjp's unscramble: M[:, b:] <- head^T M[:, b:] (head = M[:, :b], through
// `hs`), in place on this slab.
template <typename T>
__device__ __forceinline__ void contract_head(Slab<T> s, T* hs) {
  const int b = s.b;
  slab_to_global(s, 0, hs);
  __threadfence();
  csync(s.C);
  const int lo = max(0, b - s.c0);
  if (lo >= s.ws) return;
  tile_product<true, false>(
      s, b, b, [=](int i, int m) { return ld_cg(hs + (size_t)m * b + i); }, s.M + lo, s.lds,
      s.ws - lo, 1 << 30, [=](int i, int c, T acc) { s.M[(size_t)i * s.lds + lo + c] = acc; });
}

// `refine` steps of X <- X + A^-1 (N - A X) on this slab's X columns
// (global [b, b + nrhs)), A^-1 (global [b + nrhs, 2b + nrhs)) through `ai`,
// A and N read from `orig`.
template <typename T, typename Orig>
__device__ __forceinline__ void refine_steps(Slab<T> s, int nrhs,
                             int refine, const Orig& orig, T* ai) {
  const int b = s.b;
  slab_to_global(s, b + nrhs, ai);
  __threadfence();
  csync(s.C);
  const int xa = max(0, b - s.c0), xe = min(s.ws, b + nrhs - s.c0);
  if (xe <= xa) return;
  const int cw = scratch_elems(b, s.lds, solve_aug::kGJ, 1) / b;
  for (int step = 0; step < refine; ++step) {
    for (int cs = xa; cs < xe; cs += cw) {
      const int cn = min(cw, xe - cs);
      const int g = s.c0 + cs;  // global column of the chunk's first X column
      T* R = s.scr;
      tile_product<false, true>(
          s, b, b, [=](int i, int m) { return orig(i, m); }, s.M + cs, s.lds, cn, cn,
          [=](int i, int c, T acc) { R[i * cn + c] = orig(i, g + c) - acc; });
      tile_product<false, true>(
          s, b, b, [=](int i, int m) { return ld_cg(ai + (size_t)i * b + m); }, R, cn, cn, cn,
          [=](int i, int c, T acc) {
            T* x = s.M + (size_t)i * s.lds + cs + c;
            *x = add_rn(*x, acc);
          });
    }
  }
}

// Solve A X = N on the cluster in place: on return the global columns
// [b, b + nrhs) of the slabs hold X. `hs` is the cluster's 2 x b x b scratch
// in global memory.
template <int FAM, typename T, typename Orig>
__device__ __forceinline__ void solve_slab(Slab<T> s, int nrhs, int refine,
                           const Orig& orig, T* hs) {
  if (FAM == solve_aug::kQR) {
    solve_aug_slab::qr_slab(s, hs);
    return;
  }
  if (FAM == solve_aug::kGJ) {
    solve_aug_slab::gj_slab<false>(s);
  } else if (FAM == solve_aug::kGJP) {
    solve_aug_slab::gj_slab<true>(s);
    solve_aug_slab::contract_head(s, hs);
  } else if (FAM == solve_aug::kGJB) {
    solve_aug_slab::gjb_slab<false>(s);
  } else {
    solve_aug_slab::gjb_slab<true>(s);
    solve_aug_slab::unscramble(s);
  }
  if (refine)
    solve_aug_slab::refine_steps(s, nrhs, refine, orig, hs + (size_t)s.b * s.b);
  __syncthreads();
}

}  // namespace solve_aug_slab
