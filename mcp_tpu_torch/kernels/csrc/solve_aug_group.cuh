// The in-block augmented solves ("facts") of the two-way sweep K7a
// (thomas_babe.cu) on one 128-thread group per sweep direction, for blocks
// of b <= 48 rows whose working matrix has at most 128 columns, for sm_90a.
//
// The working matrix M = [A | N | I (refine)] (b x ld, ld <= 128) lives in
// registers, column-owned: thread j of the group holds column j with all of
// its rows, as col[i] = M[i][j] for rows i < BM (rows b..BM-1 are zero
// padding). Every register array is indexed at compile time only: row loops
// are unrolled to BM and a runtime row is chosen by a select tree on its
// bits (solve_aug_warp::mux), so a column never goes to local memory; one
// column is the only BM-long array a thread holds at any time (BM words of
// 32 bits in float32, 2 BM in float64).
//
// Step k of the elimination: the owner of column k has formed what the step
// needs from its own registers, with no reduction (the Householder vector
// and beta, or the pivot row, 1/pivot and the multipliers), and written it
// to one of two shared-memory slots; after ONE named barrier every thread
// reads it as broadcast 16-byte vectors and updates its own column. The
// owner of column k + 1 forms step k + 1 into the other slot as soon as its
// own column is updated (lookahead), so the slots alternate and a step costs
// one barrier: a slot is written at step k only after the barrier that ends
// step k - 1, the last step that read it.
//
// The facts without pivoting keep the step's pivot row at physical row 0:
// each step writes every updated row one place up and the pivot row to the
// end (BM - 1), which costs no instruction (the unrolled update writes each
// result straight into its new register), so row k is a compile-time row.
// QR also retires the finished row k to shared memory at step k (of R, as
// R^T, for the head's columns; of Q^T N for the others) and shifts a zero in
// at the bottom, so the reflector's vector is the owner's column as it
// stands; R's back substitution then runs one thread per right-hand column
// on R^T in shared memory, with R's reciprocal diagonal formed by the
// owners during the elimination.
//
// The algebra is solve_aug.cuh's, fact by fact. The Gauss-Jordan facts keep
// each element's operation sequence (__fmul_rn / __fsub_rn in the plain
// version's order, its pivot rule: largest |entry| among unused rows, lowest
// row on ties, used rows scored -1, no pivot when a score is NaN, a pivot
// <= 1e-30 in magnitude clamped to 1e-30). The contractions after the
// elimination (gjp's head, the refinement's A X and A^-1 E) each sum in one
// running chain in row order, as a sequential matrix product does: with
// four partial sums instead, the unrefined gjp's rounding, amplified over a
// sweep of ill-conditioned blocks, put it 30x further from the plain
// version than the block route. QR's dot products and back substitution
// sum in their own order.

#pragma once

#include <cuda_runtime.h>

#include "solve_aug.cuh"
#include "solve_aug_warp.cuh"

namespace solve_aug_group {

using solve_aug::add_rn;
using solve_aug::clamped_inverse;
using solve_aug::dsqrt;
using solve_aug::kGJ;
using solve_aug::kGJP;
using solve_aug::kQR;
using solve_aug::mul_rn;
using solve_aug::sub_rn;
using solve_aug_warp::mux;
using solve_aug_warp::Vec;

// ---- One direction's shared memory (elements of T). Every region is a
// multiple of 4 elements long, so each starts at a 16-byte boundary; the
// column-major regions have the odd stride S = BM + 1, so threads that walk
// their own columns hit distinct banks.
//
//   stage[2]  the staging buffers, each the step's [D | U | r] ("cols",
//             2b + 1 columns, column-major at stride S, rows >= b zero; the
//             L-correction writes D - L C and r - L d back in place, so with
//             refinement it is the step's original [A | N]) and the "side"
//             region ((b + 1) x S): L^T (rows of BM) for the correction, then
//             R^T (QR), the head's columns (gjp) or E = N - A X (gjpr).
//   out       [C | d] of the step (column-major at stride S; b + 1 columns)
//             and, with refinement, A^-1 after it (b more columns).
//   slot[2]   the step's broadcast: BM values and up to four scalars.
//   rinv      BM values: 1 / R[k][k] (QR).

__host__ __device__ constexpr long long round4(long long n) { return (n + 3) / 4 * 4; }

// Columns of the working matrix: [A (b) | N (nrhs) | I (b, refine only)].
__host__ __device__ constexpr int group_ld(int b, int nrhs, bool refine) {
  return b + nrhs + (refine ? b : 0);
}
__host__ __device__ constexpr long long group_cols_elems(int b, int bm) {
  return round4((2LL * b + 1) * (bm + 1));
}
__host__ __device__ constexpr long long group_stage_elems(int b, int bm) {
  return group_cols_elems(b, bm) + round4((b + 1LL) * (bm + 1));
}
__host__ __device__ constexpr long long group_out_elems(int b, int bm, bool refine) {
  return round4((b + 1LL + (refine ? b : 0)) * (bm + 1));
}
__host__ __device__ constexpr long long group_slot_elems(int bm) { return round4(bm + 4); }
__host__ __device__ constexpr long long group_dir_elems(int b, int bm, bool refine) {
  return 2 * group_stage_elems(b, bm) + group_out_elems(b, bm, refine) +
         2 * group_slot_elems(bm) + round4(bm);
}

template <typename T>
struct GroupTile {
  T* stage;  // buffer q at stage + q * stage_elems
  long long stage_elems;
  long long side_off;  // the side region's offset within a buffer
  T* out;
  T* slot;  // slot q at slot + q * slot_elems
  int slot_elems;
  T* rinv;
};

template <typename T>
__device__ GroupTile<T> carve_group(T* p, int b, int bm, bool refine) {
  GroupTile<T> s;
  s.stage = p;
  s.stage_elems = group_stage_elems(b, bm);
  s.side_off = group_cols_elems(b, bm);
  p += 2 * s.stage_elems;
  s.out = p;
  p += group_out_elems(b, bm, refine);
  s.slot = p;
  s.slot_elems = (int)group_slot_elems(bm);
  p += 2 * s.slot_elems;
  s.rinv = p;
  return s;
}

// ---- 16-byte vectors of T in registers.

__device__ __forceinline__ float4 pack(const float (&e)[4]) {
  return make_float4(e[0], e[1], e[2], e[3]);
}
__device__ __forceinline__ double2 pack(const double (&e)[2]) { return make_double2(e[0], e[1]); }
__device__ __forceinline__ void unpack(const float4& v, float (&e)[4]) {
  e[0] = v.x;
  e[1] = v.y;
  e[2] = v.z;
  e[3] = v.w;
}
__device__ __forceinline__ void unpack(const double2& v, double (&e)[2]) {
  e[0] = v.x;
  e[1] = v.y;
}

// sum_i v[i] * row[i] for i < BM (row 16-byte aligned), in four partial
// sums: the dot product sits on the owner's serial chain.
template <typename T, int BM>
__device__ __forceinline__ T dot4(const T (&v)[BM], const T* row) {
  using V = typename Vec<T>::type;
  constexpr int n = Vec<T>::n;
  const V* r = reinterpret_cast<const V*>(row);
  T s[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
  for (int q = 0; q < BM / n; ++q) {
    T e[n];
    unpack(r[q], e);
#pragma unroll
    for (int c = 0; c < n; ++c) s[(n * q + c) & 3] += v[n * q + c] * e[c];
  }
  return (s[0] + s[1]) + (s[2] + s[3]);
}

// sum_i v[i] * row[i] for i < BM (row 16-byte aligned) as one running sum
// in row order, the order of a sequential matrix product: for the
// contractions after the elimination, which run several at once.
template <typename T, int BM>
__device__ __forceinline__ T dot_seq(const T (&v)[BM], const T* row) {
  using V = typename Vec<T>::type;
  constexpr int n = Vec<T>::n;
  const V* r = reinterpret_cast<const V*>(row);
  T s = T(0);
#pragma unroll
  for (int q = 0; q < BM / n; ++q) {
    T e[n];
    unpack(r[q], e);
#pragma unroll
    for (int c = 0; c < n; ++c) s += v[n * q + c] * e[c];
  }
  return s;
}

// ---- What the owner of column k forms for step k, into a slot.

// QR (_qr_solve_aug's reflector, pivot row at physical row 0, the finished
// rows zero): u = the column with u_0 = v_0 + sign(v_0) norm, norm =
// sqrt(v.v + eps); slot[BM] = beta = 1/(norm (norm + |v_0|) + eps).
template <typename T, int BM>
__device__ __forceinline__ void qr_form(T* slot, const T (&col)[BM]) {
  using V = typename Vec<T>::type;
  constexpr int n = Vec<T>::n;
  const T eps = T(1e-30);
  T s[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
  for (int i = 0; i < BM; ++i) s[i & 3] += col[i] * col[i];
  const T vk = col[0];
  const T norm = dsqrt(((s[0] + s[1]) + (s[2] + s[3])) + eps);
  const T avk = vk >= T(0) ? vk : -vk;
  V* d = reinterpret_cast<V*>(slot);
#pragma unroll
  for (int q = 0; q < BM / n; ++q) {
    T e[n];
#pragma unroll
    for (int c = 0; c < n; ++c) e[c] = col[n * q + c];
    if (q == 0) e[0] = vk + (vk >= T(0) ? T(1) : T(-1)) * norm;
    d[q] = pack(e);
  }
  slot[BM] = T(1) / (norm * (norm + avk) + eps);
}

// The multipliers f_i = M[i][k] / piv (rounded as the plain version:
// M[i][k] * (1/piv)) and slot[BM] = 1/piv.
template <typename T, int BM>
__device__ __forceinline__ void store_multipliers(T* slot, const T (&col)[BM], T inv) {
  using V = typename Vec<T>::type;
  constexpr int n = Vec<T>::n;
  V* d = reinterpret_cast<V*>(slot);
#pragma unroll
  for (int q = 0; q < BM / n; ++q) {
    T e[n];
#pragma unroll
    for (int c = 0; c < n; ++c) e[c] = mul_rn(col[n * q + c], inv);
    d[q] = pack(e);
  }
  slot[BM] = inv;
}

// Pivot-free Gauss-Jordan: the pivot is row k, at physical row 0.
template <typename T, int BM>
__device__ __forceinline__ void gj_form(T* slot, const T (&col)[BM]) {
  store_multipliers<T, BM>(slot, col, clamped_inverse(col[0]));
}

// Gauss-Jordan with implicit partial pivoting: the pivot search over the
// owner's column, used rows (`used`, a bit mask the same in every thread;
// the padding rows count as used) scored -1 (|c| * 0 - 1: NaN where c is
// not finite); four interleaved scans, each keeping its first maximum, then
// the larger of those, the lower row on ties. A NaN score in a real row
// leaves the step without a pivot (slot[BM + 1] = b). slot[BM] = 1/pivot.
template <typename T, int BM>
__device__ __forceinline__ void gjp_form(T* slot, const T (&col)[BM], unsigned long long used,
                                         int b) {
  const unsigned long long real = (1ull << b) - 1ull;
  T best[4];
  int bi[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    best[r] = T(-2);  // below every score (scores are >= -1 or NaN)
    bi[r] = BM;
  }
  bool nan = false;
#pragma unroll
  for (int i = 0; i < BM; ++i) {
    const T a = fabs(col[i]);
    const T v = (used >> i) & 1ull ? sub_rn(sub_rn(a, a), T(1)) : a;
    if (v != v && ((real >> i) & 1ull)) nan = true;
    if (v > best[i & 3]) {
      best[i & 3] = v;
      bi[i & 3] = i;
    }
  }
#pragma unroll
  for (int r = 1; r < 4; ++r) {
    if (best[r] > best[0] || (best[r] == best[0] && bi[r] < bi[0])) {
      best[0] = best[r];
      bi[0] = bi[r];
    }
  }
  const int p = (nan || bi[0] >= b) ? b : bi[0];
  store_multipliers<T, BM>(slot, col, clamped_inverse(p < b ? mux<BM>(col, p) : T(0)));
  slot[BM + 1] = T(p);
}

template <int FAM, typename T, int BM>
__device__ __forceinline__ void form(T* slot, const T (&col)[BM], unsigned long long used, int b) {
  if constexpr (FAM == kQR)
    qr_form<T, BM>(slot, col);
  else if constexpr (FAM == kGJ)
    gj_form<T, BM>(slot, col);
  else
    gjp_form<T, BM>(slot, col, used, b);
}

// ---- What every thread does to its own column at step k.

// QR: M_j -= u (beta u^T M_j), each row written one place up; returns row
// 0's result (row k of R or of Q^T N) and shifts a zero in at the bottom.
template <typename T, int BM>
__device__ __forceinline__ T qr_apply(T (&col)[BM], const T* u) {
  using V = typename Vec<T>::type;
  constexpr int n = Vec<T>::n;
  const T bw = u[BM] * dot4<T, BM>(col, u);
  const V* uv = reinterpret_cast<const V*>(u);
  T top = T(0);
#pragma unroll
  for (int q = 0; q < BM / n; ++q) {
    T e[n];
    unpack(uv[q], e);
#pragma unroll
    for (int c = 0; c < n; ++c) {
      const int i = n * q + c;
      const T v = col[i] - e[c] * bw;
      if (i == 0)
        top = v;
      else
        col[i - 1] = v;
    }
  }
  col[BM - 1] = T(0);
  return top;
}

// Pivot-free Gauss-Jordan: row k (physical row 0) scaled by 1/piv and moved
// to the end, every other row loses f_i row_k and moves one place up.
template <typename T, int BM>
__device__ __forceinline__ void gj_apply(T (&col)[BM], const T* f) {
  using V = typename Vec<T>::type;
  constexpr int n = Vec<T>::n;
  const T r0 = col[0];
  const T top = mul_rn(r0, f[BM]);
  const V* fv = reinterpret_cast<const V*>(f);
#pragma unroll
  for (int q = 0; q < BM / n; ++q) {
    T e[n];
    unpack(fv[q], e);
#pragma unroll
    for (int c = 0; c < n; ++c) {
      const int i = n * q + c;
      if (i >= 1) col[i - 1] = sub_rn(col[i], mul_rn(e[c], r0));
    }
  }
  col[BM - 1] = top;
}

// Gauss-Jordan with pivoting: the pivot row p scaled by 1/piv, every other
// row loses f_i (row p); no pivot (p = b): every row loses f_i * 0.
template <typename T, int BM>
__device__ __forceinline__ void gjp_apply(T (&col)[BM], const T* f, int p, int b) {
  using V = typename Vec<T>::type;
  constexpr int n = Vec<T>::n;
  const T prow = p < b ? mux<BM>(col, p) : T(0);
  const T pn = mul_rn(prow, f[BM]);
  const V* fv = reinterpret_cast<const V*>(f);
#pragma unroll
  for (int q = 0; q < BM / n; ++q) {
    T e[n];
    unpack(fv[q], e);
#pragma unroll
    for (int c = 0; c < n; ++c) {
      const int i = n * q + c;
      const T g = sub_rn(col[i], mul_rn(e[c], prow));
      col[i] = i == p ? pn : g;
    }
  }
}

// ---- The elimination: the owner of column 0 forms step 0, one barrier,
// then per step every live column's update, the lookahead owner's form and
// one barrier. QR retires row k of R into `side` (as R^T: R[k][j] at
// side[j BM + k]) and of Q^T N into the out tile, and the owner of column k
// puts 1/R[k][k] in rinv.
template <int FAM, typename T, int BM, typename G>
__device__ __forceinline__ void group_eliminate(const G& g, const GroupTile<T>& s, T* side,
                                                T (&col)[BM], int b, int ld, int j) {
  constexpr int S = BM + 1;
  unsigned long long used = ~((1ull << b) - 1ull);
  if (j == 0) form<FAM, T, BM>(s.slot, col, used, b);
  g.sync();
  for (int k = 0; k < b; ++k) {
    const T* sl = s.slot + (k & 1) * s.slot_elems;
    if constexpr (FAM == kQR) {
      if (j >= k && j < ld) {
        const T top = qr_apply<T, BM>(col, sl);
        if (j < b)
          side[j * BM + k] = top;
        else
          s.out[(j - b) * S + k] = top;
        if (j == k) s.rinv[k] = T(1) / top;
      }
    } else if constexpr (FAM == kGJ) {
      if (j > k && j < ld) gj_apply<T, BM>(col, sl);
    } else {
      const int p = (int)sl[BM + 1];
      if (j < ld) gjp_apply<T, BM>(col, sl, p, b);
      if (p < b) used |= 1ull << p;
    }
    if (j == k + 1 && k + 1 < b)
      form<FAM, T, BM>(s.slot + ((k + 1) & 1) * s.slot_elems, col, used, b);
    g.sync();
  }
}

// ---- After the elimination: X (b x nrhs) into the out tile's first nrhs
// columns (column-major at stride S, rows >= b untouched) and, column-major,
// into `gout` (gout[c b + i]). `st` is the step's original [A | N]
// (column-major at stride S; read with refinement only).
template <int FAM, bool REFINE, typename T, int BM, typename G>
__device__ __forceinline__ void group_finish(const G& g, const GroupTile<T>& s, const T* st,
                                             T* side, T (&col)[BM], int b, int nrhs, int ld,
                                             int j, T* gout) {
  using V = typename Vec<T>::type;
  constexpr int n = Vec<T>::n;
  constexpr int S = BM + 1;
  if constexpr (FAM == kQR) {
    // R^-1 (Q^T N), thread b + c on column c. R's rows beyond b are never
    // read (the unrolled steps k >= b are skipped).
    if (j >= b && j < b + nrhs) {
      const int c = j - b;
      T* yc = s.out + c * S;
      T y[BM];
#pragma unroll
      for (int i = 0; i < BM; ++i) y[i] = yc[i];
#pragma unroll
      for (int k = BM - 1; k >= 0; --k) {
        if (k >= b) continue;
        y[k] *= s.rinv[k];
        const V* rk = reinterpret_cast<const V*>(side + k * BM);  // column k of R
#pragma unroll
        for (int q = 0; q < BM / n; ++q) {
          if (n * q >= k) break;
          T e[n];
          unpack(rk[q], e);
#pragma unroll
          for (int r = 0; r < n; ++r)
            if (n * q + r < k) y[n * q + r] -= e[r] * y[k];
        }
      }
#pragma unroll
      for (int i = 0; i < BM; ++i) {
        if (i < b) {
          yc[i] = y[i];
          gout[c * b + i] = y[i];
        }
      }
    }
  } else if constexpr (FAM == kGJ) {
    // The columns right of the head are X, their rows rotated b places:
    // physical row p holds row p - (BM - b).
    if (j >= b && j < b + nrhs) {
      const int c = j - b;
#pragma unroll
      for (int p = 0; p < BM; ++p) {
        const int i = p - (BM - b);
        if (i >= 0) {
          s.out[c * S + i] = col[p];
          gout[c * b + i] = col[p];
        }
      }
    }
  } else {
    // gjp: after the full Jordan elimination the head is the pivot
    // permutation; X = head^T M[:, b:] (one contraction, summed in any
    // order): the head's columns go to the side region, and thread b + c
    // forms column c of X (with refinement, columns nrhs.. are A^-1). Rows
    // beyond b take no part (an overflow can leave them non-finite).
    if (j < b) {
      V* d = reinterpret_cast<V*>(side + j * BM);
#pragma unroll
      for (int q = 0; q < BM / n; ++q) {
        T e[n];
#pragma unroll
        for (int r = 0; r < n; ++r) e[r] = n * q + r < b ? col[n * q + r] : T(0);
        d[q] = pack(e);
      }
    } else {
#pragma unroll
      for (int i = 0; i < BM; ++i) col[i] = i < b ? col[i] : T(0);
    }
    g.sync();
    if (j >= b && j < ld) {
      const int c = j - b;
#pragma unroll 4
      for (int k = 0; k < b; ++k) {
        const T x = dot_seq<T, BM>(col, side + k * BM);
        s.out[c * S + k] = x;
        if (!REFINE) gout[c * b + k] = x;
      }
    }
    if constexpr (REFINE) {
      // One step X += A^-1 (N - A X), thread i on row i: E = N - A X into
      // the side region (column-major at stride BM), then X += A^-1 E.
      g.sync();
      if (j < b) {
        const int i = j;
        T ar[BM];
#pragma unroll
        for (int m = 0; m < BM; ++m) {
          const T a = st[(m < b ? m : 0) * S + i];
          ar[m] = m < b ? a : T(0);
        }
#pragma unroll 4
        for (int c = 0; c < nrhs; ++c) {
          const T* xc = s.out + c * S;
          T a = T(0);
#pragma unroll
          for (int m = 0; m < BM; ++m) a += ar[m] * xc[m];
          side[c * BM + i] = sub_rn(st[(b + c) * S + i], a);
        }
      }
      g.sync();
      if (j < b) {
        const int i = j;
        T ir[BM];
#pragma unroll
        for (int m = 0; m < BM; ++m) {
          const T a = s.out[(nrhs + (m < b ? m : 0)) * S + i];
          ir[m] = m < b ? a : T(0);
        }
#pragma unroll 4
        for (int c = 0; c < nrhs; ++c) {
          const T x = add_rn(s.out[c * S + i], dot_seq<T, BM>(ir, side + c * BM));
          s.out[c * S + i] = x;
          gout[c * b + i] = x;
        }
      }
    }
  }
}

// Thread j's column of the loaded working matrix: the staged [A | N]
// (column-major at stride S) for j < b + nrhs, identity column j - b - nrhs
// with refinement.
template <bool REFINE, typename T, int BM>
__device__ __forceinline__ void load_col(T (&col)[BM], const T* st, int b, int nrhs, int j) {
  constexpr int S = BM + 1;
  if (j < b + nrhs) {
    const T* cj = st + j * S;
#pragma unroll
    for (int i = 0; i < BM; ++i) col[i] = cj[i];
  } else {
    const int e = j - b - nrhs;
#pragma unroll
    for (int i = 0; i < BM; ++i) col[i] = REFINE && i == e ? T(1) : T(0);
  }
}

// Solve the loaded working matrix (one column per thread of the group):
// X into the out tile and `gout`.
template <int FAM, bool REFINE, typename T, int BM, typename G>
__device__ __forceinline__ void group_solve(const G& g, const GroupTile<T>& s, const T* st,
                                            T* side, T (&col)[BM], int b, int nrhs, int j,
                                            T* gout) {
  const int ld = group_ld(b, nrhs, REFINE);
  group_eliminate<FAM, T, BM>(g, s, side, col, b, ld, j);
  group_finish<FAM, REFINE, T, BM>(g, s, st, side, col, b, nrhs, ld, j, gout);
}

}  // namespace solve_aug_group
