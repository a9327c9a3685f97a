// The in-block augmented solves ("facts") of the one-way sweep K1
// (thomas.cu) on one warp, for blocks of b <= 32 rows, for sm_90a.
//
// The working matrix M = [A | N | I (refine)] (b x ld) lives in registers,
// column-owned: lane l holds columns l, l + 32, l + 64, ... with all of
// their rows, as col[c][i] = M[i][32 c + l] for rows i < BM (rows b..BM-1
// are padding). Every register array is indexed at compile time only: row
// loops are unrolled to BM and a runtime row is chosen by a select tree on
// its bits (`mux`), so the tile never goes to local memory. The owner of
// column k (lane k: k < b <= 32) computes what step k needs from its own
// column (the Householder vector and beta, or the pivot row, 1/pivot and the
// multipliers) and the warp takes it by __shfl_sync; every lane then
// updates its own columns. No block barrier exists: what crosses lanes
// outside the elimination goes through the warp's shared-memory tile with
// __syncwarp. The regions of that tile are zero outside the b x b system,
// so the loops over them run over BM rows without a runtime test.
//
// The facts without pivoting keep the step's pivot row at physical row 0:
// each step writes every updated row one place up and the pivot row to the
// end (BM - 1), which costs no instruction (the unrolled update writes each
// result straight into its new register), so row k is a compile-time row.
// QR also retires the finished row k of R and of Q^T N to shared memory at
// step k and zeroes it, so the reflector's vector is the owner's column as
// it stands.
//
// The algebra is solve_aug.cuh's, fact by fact. The Gauss-Jordan facts keep
// each element's operation sequence (__fmul_rn / __fsub_rn in the plain
// version's order, its pivot rule: largest |entry| among unused rows, lowest
// row on ties, used rows scored -1, no pivot when a score is NaN, a pivot
// <= 1e-30 in magnitude clamped to 1e-30); the contractions (gjp's head,
// the refinement's A X and A^-1 R, QR's dot products and back substitution)
// sum in their own order.

#pragma once

#include <cuda_runtime.h>

#include "solve_aug.cuh"

namespace solve_aug_warp {

using solve_aug::add_rn;
using solve_aug::clamped_inverse;
using solve_aug::dsqrt;
using solve_aug::mul_rn;
using solve_aug::sub_rn;

constexpr unsigned kFull = 0xffffffffu;

// Columns of the working matrix: [A (b) | N (b + 1) | I (b, refine only)].
__host__ __device__ constexpr int warp_ld(int b, bool refine) {
  return 2 * b + 1 + (refine ? b : 0);
}
// Column groups per lane at BM rows.
__host__ __device__ constexpr int warp_groups(int bm, bool refine) {
  return (warp_ld(bm, refine) + 31) / 32;
}
// Elements of one staging buffer: the step's [D | U | r (| I)] (BM rows at
// a stride of 32 per group, so every lane's load of every group is in
// range) and L^T (BM x BM).
__host__ __device__ constexpr int stage_elems(int bm, bool refine) {
  return bm * 32 * warp_groups(bm, refine) + bm * bm;
}

// One warp's shared memory (elements of T), every stride a compile-time
// function of BM, regions at 16-byte boundaries first (column-major at
// stride BM, read as broadcast vectors): two staging buffers (the next
// step's loads land in one by cp.async while the other is read; the
// backward sweep's ring of [C | d] rows after the forward sweep), the head
// or R (row-major, stride BM), with pivoting the columns right of the head,
// and with refinement X before the refinement and the residual N - A X;
// then [C | d] (b + 1 columns, column-major, stride BM + 1, odd: lanes
// walking their own columns hit distinct banks) and, with refinement, A^-1
// (row-major, stride BM + 1) and the step's original [A | N] (row-major,
// stride 2 BM + 1).
template <typename T>
struct WarpTile {
  T* stage;  // buffer q at stage + q * stage_elems
  T* H;
  T* xin;
  T* xa;
  T* e;
  T* cd;
  T* ainv;
  T* orig;
};

__host__ __device__ constexpr long long warp_tile_elems(int bm, bool pivoted, bool refine) {
  return 2LL * stage_elems(bm, refine) + (long long)bm * bm +
         (pivoted ? (long long)(2 * bm + 1) * bm : 0) + (long long)(bm + 1) * (bm + 1) +
         (refine ? 3LL * bm * (bm + 1) + (long long)bm * (2 * bm + 1) : 0);
}

template <typename T>
__device__ WarpTile<T> carve_warp(T* p, int bm, bool pivoted, bool refine) {
  WarpTile<T> s;
  s.stage = p;
  p += 2 * stage_elems(bm, refine);
  s.H = p;
  p += bm * bm;
  s.xin = p;
  p += pivoted ? (2 * bm + 1) * bm : 0;
  s.xa = p;
  p += refine ? (bm + 1) * bm : 0;
  s.e = p;
  p += refine ? (bm + 1) * bm : 0;
  s.cd = p;
  p += (bm + 1) * (bm + 1);
  s.ainv = p;
  p += refine ? bm * (bm + 1) : 0;
  s.orig = p;
  return s;
}

// One element global -> shared without registers (sm_80+ cp.async).
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(T) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16-byte vectors of T, for the rows at 16-byte boundaries.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int n = 4;
};
template <>
struct Vec<double> {
  using type = double2;
  static constexpr int n = 2;
};

// acc[i] += row[i] * a for i < BM, row 16-byte aligned.
template <typename T, int BM>
__device__ __forceinline__ void axpy_row(T (&acc)[BM], const T* row, T a) {
  using V = typename Vec<T>::type;
  constexpr int n = Vec<T>::n;
  const V* r = reinterpret_cast<const V*>(row);
#pragma unroll
  for (int q = 0; q < BM / n; ++q) {
    const V v = r[q];
    acc[n * q] += v.x * a;
    acc[n * q + 1] += v.y * a;
    if constexpr (n == 4) {
      acc[n * q + 2] += v.z * a;
      acc[n * q + 3] += v.w * a;
    }
  }
}

// sum_i v[i] * row[i] for i < BM, row 16-byte aligned (two partial sums).
template <typename T, int BM>
__device__ __forceinline__ T dot_row(const T (&v)[BM], const T* row) {
  using V = typename Vec<T>::type;
  constexpr int n = Vec<T>::n;
  const V* r = reinterpret_cast<const V*>(row);
  T s0 = T(0), s1 = T(0);
#pragma unroll
  for (int q = 0; q < BM / n; ++q) {
    const V w = r[q];
    if constexpr (n == 4) {
      s0 += v[n * q] * w.x + v[n * q + 2] * w.z;
      s1 += v[n * q + 1] * w.y + v[n * q + 3] * w.w;
    } else {
      s0 += v[n * q] * w.x;
      s1 += v[n * q + 1] * w.y;
    }
  }
  return s0 + s1;
}

// v[p] for a runtime p < BM: a select tree on the bits of p, log2(BM) deep.
template <int BM, typename T>
__device__ __forceinline__ T mux(const T (&v)[BM], int p) {
  T t[BM];
#pragma unroll
  for (int i = 0; i < BM; ++i) t[i] = v[i];
#pragma unroll
  for (int bit = 1; bit < BM; bit <<= 1) {
    const bool hi = (p & bit) != 0;
#pragma unroll
    for (int i = 0; i + bit < BM; i += 2 * bit) t[i] = hi ? t[i + bit] : t[i];
  }
  return t[0];
}

// Householder QR without pivoting of M[:, :b] applied to every column from
// k on (_qr_solve_aug's reflector: norm = sqrt(v.v + eps), u_k = v_k +
// sign(v_k) norm, beta = 1/(norm (norm + |v_k|) + eps)), each live column
// taking M_j -= u (beta u^T M_j). The pivot row sits at physical row 0; the
// rows finished before are zero, so u is the owner's column with u_0
// replaced. Row k of R goes to s.H and row k of Q^T N to the [C | d] tile.
template <typename T, int BM, int NC>
__device__ __forceinline__ void qr_eliminate(const WarpTile<T>& s, T (&col)[NC][BM], int b,
                                             int ld, int lane) {
  const T eps = T(1e-30);
  for (int k = 0; k < b; ++k) {
    T s0 = T(0), s1 = T(0);
#pragma unroll
    for (int i = 0; i < BM; i += 2) {
      s0 += col[0][i] * col[0][i];
      s1 += col[0][i + 1] * col[0][i + 1];
    }
    const T vk = col[0][0];
    const T norm = dsqrt((s0 + s1) + eps);
    const T avk = vk >= T(0) ? vk : -vk;
    const T beta = __shfl_sync(kFull, T(1) / (norm * (norm + avk) + eps), k);
    T u[BM];
    u[0] = __shfl_sync(kFull, vk + (vk >= T(0) ? T(1) : T(-1)) * norm, k);
#pragma unroll
    for (int i = 1; i < BM; ++i) u[i] = __shfl_sync(kFull, col[0][i], k);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int j = 32 * c + lane;
      if (j < k || j >= ld) continue;
      T w0 = T(0), w1 = T(0);
#pragma unroll
      for (int i = 0; i < BM; i += 2) {
        w0 += u[i] * col[c][i];
        w1 += u[i + 1] * col[c][i + 1];
      }
      const T bw = beta * (w0 + w1);
      const T top = col[c][0] - u[0] * bw;
#pragma unroll
      for (int i = 1; i < BM; ++i) col[c][i - 1] = col[c][i] - u[i] * bw;
      col[c][BM - 1] = T(0);
      if (j < b)
        s.H[k * BM + j] = top;
      else
        s.cd[(j - b) * (BM + 1) + k] = top;
    }
  }
}

// QR: X = R^-1 (Q^T N) by back substitution, lane c on column c of [C | d]
// in registers (R's padding diagonal is 1, so the loops need no test). The
// reciprocals of R's diagonal are formed first, all at once, so the serial
// chain is one multiply and one update per row. A zero or non-finite pivot
// gives inf/NaN in that system only.
template <typename T, int BM>
__device__ __forceinline__ void qr_finish(const WarpTile<T>& s, int b, int lane) {
  __syncwarp();
  T rinv[BM];
#pragma unroll
  for (int k = 0; k < BM; ++k) rinv[k] = T(1) / s.H[k * BM + k];
  for (int c = lane; c <= b; c += 32) {  // b + 1 columns: lane 0 takes two at b = 32
    T* yc = s.cd + c * (BM + 1);
    T y[BM];
#pragma unroll
    for (int i = 0; i < BM; ++i) y[i] = yc[i];
#pragma unroll
    for (int k = BM - 1; k >= 0; --k) {
      y[k] = y[k] * rinv[k];
#pragma unroll
      for (int i = 0; i < k; ++i) y[i] -= s.H[i * BM + k] * y[k];
    }
#pragma unroll
    for (int i = 0; i < BM; ++i) yc[i] = y[i];
  }
}

// Pivot-free Gauss-Jordan: row k scaled by 1/piv, every other row loses
// (M[i][k] / piv) row_k; columns <= k are never read again and are skipped.
// Row k sits at physical row 0 (it moves to the end after its step).
template <typename T, int BM, int NC>
__device__ __forceinline__ void gj_eliminate(T (&col)[NC][BM], int b, int ld, int lane) {
  for (int k = 0; k < b; ++k) {
    const T inv_own = clamped_inverse(col[0][0]);
    const T inv = __shfl_sync(kFull, inv_own, k);
    T f[BM];
#pragma unroll
    for (int i = 1; i < BM; ++i) f[i] = __shfl_sync(kFull, mul_rn(col[0][i], inv_own), k);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int j = 32 * c + lane;
      if (j <= k || j >= ld) continue;
      const T r0 = col[c][0];
      const T top = mul_rn(r0, inv);
#pragma unroll
      for (int i = 1; i < BM; ++i) col[c][i - 1] = sub_rn(col[c][i], mul_rn(f[i], r0));
      col[c][BM - 1] = top;
    }
  }
}

// gj: the columns right of the head are X, rows rotated b places: physical
// row p holds row p - (BM - b).
template <typename T, int BM, int NC>
__device__ __forceinline__ void gj_finish(const WarpTile<T>& s, const T (&col)[NC][BM], int b,
                                          int ld, int lane) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int j = 32 * c + lane;
    if (j < b || j >= ld) continue;
    T* yc = s.cd + (j - b) * (BM + 1);
#pragma unroll
    for (int p = 0; p < BM; ++p) {
      const int i = p - (BM - b);
      if (i >= 0) yc[i] = col[c][p];
    }
  }
}

// Gauss-Jordan with implicit partial pivoting on every column of M. `used`
// is the warp's bit mask of pivot rows so far (the same in every lane). The
// owner scores its column k and finds the pivot by a tournament (ties keep
// the lower row); a NaN score anywhere leaves the step without a pivot.
template <typename T, int BM, int NC>
__device__ __forceinline__ void gjp_eliminate(T (&col)[NC][BM], int b, int ld, int lane) {
  // The padding rows count as used: they score -1 and never win (a row
  // < b is unused at every step), and a NaN among them is masked out.
  const unsigned real = b >= 32 ? ~0u : (1u << b) - 1u;
  unsigned used = ~real;
  for (int k = 0; k < b; ++k) {
    T v[BM];
    int id[BM];
    unsigned nanm = 0u;
#pragma unroll
    for (int i = 0; i < BM; ++i) {
      // |c| (1 - u) - u: |c| for an unused row, |c| * 0 - 1 = -1 for a used
      // one (NaN where c is not finite). |-0| = +0 ranks as -0 does.
      const T a = fabs(col[0][i]);
      v[i] = (used >> i) & 1u ? sub_rn(sub_rn(a, a), T(1)) : a;
      if (v[i] != v[i]) nanm |= 1u << i;
      id[i] = i;
    }
#pragma unroll
    for (int st = 1; st < BM; st <<= 1) {
#pragma unroll
      for (int i = 0; i + st < BM; i += 2 * st) {
        if (v[i + st] > v[i]) {
          v[i] = v[i + st];
          id[i] = id[i + st];
        }
      }
    }
    const int p_own = (nanm & real) ? b : id[0];
    const T inv_own = clamped_inverse(p_own < b ? mux(col[0], p_own) : T(0));
    const int p = __shfl_sync(kFull, p_own, k);
    const T inv = __shfl_sync(kFull, inv_own, k);
    T f[BM];
#pragma unroll
    for (int i = 0; i < BM; ++i) f[i] = __shfl_sync(kFull, mul_rn(col[0][i], inv_own), k);
    const unsigned hot = p < b ? 1u << p : 0u;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int j = 32 * c + lane;
      if (j >= ld) continue;
      const T prow = p < b ? mux(col[c], p) : T(0);
      const T pn = mul_rn(prow, inv);
#pragma unroll
      for (int i = 0; i < BM; ++i) {
        const T g = sub_rn(col[c][i], mul_rn(f[i], prow));
        col[c][i] = (hot >> i) & 1u ? pn : g;
      }
    }
    used |= hot;
  }
}

// gjp: after the full Jordan elimination the head is the pivot permutation;
// X = head^T M[:, b:] (one contraction, summed in any order). Lane k < b
// holds head column k in its first group and forms row k of X, and with
// refinement of A^-1, from the columns right of the head (s.xin, read as
// broadcast vectors); X goes to the [C | d] tile (with refinement first to
// s.xa), A^-1 to s.ainv. Then with refinement one step X += A^-1 (N - A X),
// lane i on row i, A and N read from the step's original.
template <typename T, int BM, int NC, bool REFINE>
__device__ __forceinline__ void gjp_finish(const WarpTile<T>& s, T (&col)[NC][BM], int b,
                                           int ld, int lane) {
  constexpr int SC = BM + 1, SO = 2 * BM + 1;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int j = 32 * c + lane;
    if (j < b || j >= ld) continue;
#pragma unroll
    for (int i = 0; i < BM; ++i) s.xin[(j - b) * BM + i] = i < b ? col[c][i] : T(0);
  }
  // Padding rows take no part in the contraction (an overflow can leave
  // them non-finite).
#pragma unroll
  for (int i = 0; i < BM; ++i) col[0][i] = i < b ? col[0][i] : T(0);
  __syncwarp();
  if (lane < b) {
    const int m = ld - b;
#pragma unroll 4
    for (int cc = 0; cc < m; ++cc) {
      const T acc = dot_row<T, BM>(col[0], s.xin + cc * BM);
      if (!REFINE)
        s.cd[cc * SC + lane] = acc;
      else if (cc <= b)
        s.xa[cc * BM + lane] = acc;
      else
        s.ainv[lane * SC + (cc - b - 1)] = acc;
    }
  }
  if constexpr (REFINE) {
    __syncwarp();
    const int i = lane;
    if (i < b) {
      T ar[BM];
#pragma unroll
      for (int m = 0; m < BM; ++m) {
        const T a = s.orig[i * SO + m];
        ar[m] = m < b ? a : T(0);
      }
#pragma unroll 4
      for (int c = 0; c <= b; ++c)
        s.e[c * BM + i] = sub_rn(s.orig[i * SO + b + c], dot_row<T, BM>(ar, s.xa + c * BM));
    }
    __syncwarp();
    if (i < b) {
      T ir[BM];
#pragma unroll
      for (int m = 0; m < BM; ++m) ir[m] = s.ainv[i * SC + m];
#pragma unroll 4
      for (int c = 0; c <= b; ++c)
        s.cd[c * SC + i] = add_rn(s.xa[c * BM + i], dot_row<T, BM>(ir, s.e + c * BM));
    }
  }
}

}  // namespace solve_aug_warp
