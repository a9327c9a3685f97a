// The in-block augmented solves ("facts") of the banded kernels K1 (thomas.cu),
// K7a (thomas_babe.cu) and K3 (cyclic_reduction.cu), for sm_90a.
//
// Each solves A X = N in place on M = [A | N] (b x ld, row-major in shared
// memory): on return M[:, b : b + nrhs] holds X. They are the device versions
// of mcp_tpu/kernels/thomas_pallas.py::_solve_aug (:431) and its facts, whose
// plain PyTorch versions are in kernels/solve_aug.py:
//
//   family kQR   "qr"                     _qr_solve_aug (:33)
//   family kGJ   "gj"                     _gj_solve_aug (:78)
//   family kGJP  "gjp", "gjpr"            _gjp_solve_aug (:110), _gjpr_solve_aug (:396)
//   family kGJB  "gjb", "gjbr", "gjbr2"   _gjb_solve_aug (:176)
//   family kGJBP "gjbp", "gjbpr", "gjbpr2", "gjbprl"   _gjbp_solve_aug (:260)
//
// With `refine` > 0 the elimination runs on [A | N | I] (ld = 2b + nrhs),
// which also yields A^-1, and `refine` steps X += A^-1 (N - A X) follow, A and
// N read from `orig`. A Gauss-Jordan pivot of magnitude <= 1e-30 is clamped
// to 1e-30. The eliminations round each product, sum and difference on its
// own (__fmul_rn and friends, no FMA contraction) in the plain version's
// order and form, pivot choice included (largest |entry| among unused rows,
// lowest row on ties, used rows scored -1, no pivot at all when a score is
// NaN), so they round as the plain version does; the contractions (gjp's
// head, the blocked trailing updates, the refinement products) sum in their
// own order. The blocked-pivoted family keeps each panel's one-hot pivot
// matrix O as pivot-row indices and gathers where the JAX package contracts
// with O: the same values for finite entries, but a non-finite entry in a
// non-pivot row stays in its row here, where the one-hot contraction
// (0 * inf) spreads NaN into the pivot row.
//
// Every function runs on a thread group G: G::g is the thread's index in the
// group, G::n the group's size (a multiple of 32, warps aligned), G::sync()
// its barrier. BlockGroup syncs the whole block (__syncthreads); NamedGroup
// syncs a sub-block with `bar.sync id, n` (K7a runs one group per sweep
// direction). No function uses __syncthreads() or static shared memory
// itself, so two named groups can run facts side by side.

#pragma once

#include <cuda_runtime.h>

namespace solve_aug {

enum Family { kQR = 0, kGJ = 1, kGJP = 2, kGJB = 3, kGJBP = 4 };
constexpr int kPanel = 32;  // GJB_PANEL

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float dsqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double dsqrt(double v) { return sqrt(v); }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__device__ __forceinline__ T clamped_inverse(T piv) {
  const T ap = piv >= T(0) ? piv : -piv;
  return T(1) / (ap > T(1e-30) ? piv : T(1e-30));
}

struct BlockGroup {
  int g, n;
  __device__ __forceinline__ void sync() const { __syncthreads(); }
};

struct NamedGroup {
  int g, n, id;
  __device__ __forceinline__ void sync() const {
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
  }
};

// The shared-memory working set of one solve.
template <typename T>
struct Aug {
  T* M;        // b x ld
  T* va;       // b: used flags (pivoted), Householder vector (qr)
  T* vb;       // b: multipliers
  T* vc;       // ld: pivot row (gj*), u^T M (qr)
  T* vd;       // kPanel: W's pivot row plus e_j (blocked)
  T* sc;       // 4 scalars: sc[0] 1/pivot or beta, sc[1] the pivot row
  T* W;        // b x kPanel (blocked families)
  T* scratch;  // b x chunk
  int* piv;    // b pivot rows (kGJBP)
  int chunk;
};

// Elements of T in the working set (piv's ints are counted by aug_bytes).
__host__ __device__ __forceinline__ long long aug_elems(int b, int ld, int fam, int chunk) {
  return (long long)b * ld + 2LL * b + ld + kPanel + 4 + (fam >= kGJB ? (long long)b * kPanel : 0)
         + (long long)b * chunk;
}

__host__ __device__ __forceinline__ size_t aug_bytes(int b, int ld, int fam, int chunk, size_t sz) {
  return sz * (size_t)aug_elems(b, ld, fam, chunk) + (fam == kGJBP ? sizeof(int) * b : 0);
}

// Lays the working set out from `base`; with chunk == 0 the caller points
// `scratch` at b x `chunk` elements of its own.
template <typename T>
__device__ Aug<T> carve(T* base, int b, int ld, int fam, int chunk) {
  Aug<T> s;
  s.M = base;
  s.va = s.M + (size_t)b * ld;
  s.vb = s.va + b;
  s.vc = s.vb + b;
  s.vd = s.vc + ld;
  s.sc = s.vd + kPanel;
  s.W = s.sc + 4;
  s.scratch = s.W + (fam >= kGJB ? b * kPanel : 0);
  s.piv = reinterpret_cast<int*>(s.scratch + (size_t)b * chunk);
  s.chunk = chunk;
  return s;
}

// A b x ? matrix in shared memory as an `orig` for refinement.
template <typename T>
struct SmemMat {
  const T* p;
  int ld;
  __device__ T operator()(int i, int j) const { return p[i * ld + j]; }
};

// The pivot search of column k over the unused rows (warp 0 of the group):
// sc[0] <- 1/pivot (clamped), sc[1] <- the pivot row (b: none).
template <typename T, typename G>
__device__ void find_pivot(const G& g, const Aug<T>& s, int b, int ld, int k) {
  const int lane = g.g & 31;
  if ((g.g >> 5) != 0) return;
  const T* M = s.M;
  const T* used = s.va;
  T best = T(0);
  int bi = b;
  int seen = 0, nan = 0;
  for (int i = lane; i < b; i += 32) {
    const T c = M[i * ld + k];
    const T u = used[i];
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
  if (lane == 0) {
    const int p = (nan || !seen) ? b : bi;
    s.sc[0] = clamped_inverse(p < b ? M[p * ld + k] : T(0));
    s.sc[1] = T(p);
  }
}

// Pivot-free Gauss-Jordan: row k is scaled by 1/piv, every other row loses
// (M[i][k] / piv) row_k. Columns <= k are never read again and are skipped.
template <typename T, typename G>
__device__ void gj_eliminate(const G& g, const Aug<T>& s, int b, int ld) {
  const int lane = g.g & 31, warp = g.g >> 5, nw = g.n >> 5;
  T* M = s.M;
  T* f = s.vb;
  T* prow = s.vc;
  for (int k = 0; k < b; ++k) {
    const T inv = clamped_inverse(M[k * ld + k]);
    for (int j = k + 1 + g.g; j < ld; j += g.n) prow[j] = M[k * ld + j];
    for (int i = g.g; i < b; i += g.n) f[i] = mul_rn(M[i * ld + k], inv);
    g.sync();
    for (int i = warp; i < b; i += nw) {
      T* row = M + i * ld;
      if (i == k) {
        for (int j = k + 1 + lane; j < ld; j += 32) row[j] = mul_rn(prow[j], inv);
      } else {
        const T fi = f[i];
        for (int j = k + 1 + lane; j < ld; j += 32) row[j] = sub_rn(row[j], mul_rn(fi, prow[j]));
      }
    }
    g.sync();
  }
}

// Gauss-Jordan with implicit partial pivoting on every column of M.
template <typename T, typename G>
__device__ void gjp_eliminate(const G& g, const Aug<T>& s, int b, int ld) {
  const int lane = g.g & 31, warp = g.g >> 5, nw = g.n >> 5;
  T* M = s.M;
  T* used = s.va;
  T* f = s.vb;
  T* prow = s.vc;
  for (int i = g.g; i < b; i += g.n) used[i] = T(0);
  g.sync();
  for (int k = 0; k < b; ++k) {
    find_pivot(g, s, b, ld, k);
    g.sync();
    const int p = (int)s.sc[1];
    const T inv = s.sc[0];
    for (int j = g.g; j < ld; j += g.n) prow[j] = p < b ? M[p * ld + j] : T(0);
    for (int i = g.g; i < b; i += g.n) f[i] = mul_rn(M[i * ld + k], inv);
    g.sync();
    for (int i = warp; i < b; i += nw) {
      T* row = M + i * ld;
      if (i == p) {
        for (int j = lane; j < ld; j += 32) row[j] = mul_rn(prow[j], inv);
      } else {
        const T fi = f[i];
        for (int j = lane; j < ld; j += 32) row[j] = sub_rn(row[j], mul_rn(fi, prow[j]));
      }
    }
    if (g.g == 0 && p < b) used[p] = T(1);
    g.sync();
  }
}

// M[:, b:] <- head^T M[:, b:] in place (head = M[:, :b]), `chunk` columns at
// a time through the scratch slab.
template <typename T, typename G>
__device__ void contract_head(const G& g, const Aug<T>& s, int b, int ld) {
  T* M = s.M;
  for (int c0 = b; c0 < ld; c0 += s.chunk) {
    const int w = min(s.chunk, ld - c0);
    for (int e = g.g; e < b * w; e += g.n) {
      const int k = e / w, c = e - k * w;
      T acc = T(0);
      for (int j = 0; j < b; ++j) acc += M[j * ld + k] * M[j * ld + c0 + c];
      s.scratch[e] = acc;
    }
    g.sync();
    for (int e = g.g; e < b * w; e += g.n) {
      const int k = e / w, c = e - k * w;
      M[k * ld + c0 + c] = s.scratch[e];
    }
    g.sync();
  }
}

// Blocked Gauss-Jordan, pivot-free (PIVOTED false: row k0 + j pivots panel
// column j) or with gjp's pivot sequence (PIVOTED true). Per panel of w <=
// kPanel columns, step j: u = 1/piv - 1 at the pivot row p and -M[i][c]/piv
// elsewhere; the panel's columns after j take += u * M[p]; W (b x w) takes
// += u * (W[p] + e_j); then every later column takes += W * (its rows at the
// panel's pivots). The pivoted variant leaves the rows in pivot order.
template <typename T, bool PIVOTED, typename G>
__device__ void gjb_eliminate(const G& g, const Aug<T>& s, int b, int ld) {
  const int lane = g.g & 31, warp = g.g >> 5, nw = g.n >> 5;
  T* M = s.M;
  T* u = s.vb;
  T* prow = s.vc;
  T* wrow = s.vd;
  T* W = s.W;
  if (PIVOTED) {
    for (int i = g.g; i < b; i += g.n) s.va[i] = T(0);
  }
  for (int k0 = 0; k0 < b; k0 += kPanel) {
    const int w = min(kPanel, b - k0);
    for (int e = g.g; e < b * kPanel; e += g.n) W[e] = T(0);
    g.sync();
    for (int j = 0; j < w; ++j) {
      const int cj = k0 + j;
      int p;
      T inv;
      if (PIVOTED) {
        find_pivot(g, s, b, ld, cj);
        g.sync();
        p = (int)s.sc[1];
        inv = s.sc[0];
      } else {
        p = cj;
        inv = clamped_inverse(M[p * ld + cj]);
      }
      for (int i = g.g; i < b; i += g.n)
        u[i] = i == p ? sub_rn(inv, T(1)) : -mul_rn(M[i * ld + cj], inv);
      for (int c = g.g; c < w; c += g.n) {
        prow[c] = p < b ? M[p * ld + k0 + c] : T(0);
        wrow[c] = add_rn(p < b ? W[p * kPanel + c] : T(0), c == j ? T(1) : T(0));
      }
      g.sync();
      for (int i = warp; i < b; i += nw) {
        const T ui = u[i];
        T* row = M + i * ld + k0;
        for (int c = j + 1 + lane; c < w; c += 32) row[c] = add_rn(row[c], mul_rn(ui, prow[c]));
        for (int c = lane; c < w; c += 32)
          W[i * kPanel + c] = add_rn(W[i * kPanel + c], mul_rn(ui, wrow[c]));
      }
      if (PIVOTED && g.g == 0) {
        s.piv[cj] = p;
        if (p < b) s.va[p] = T(1);
      }
      g.sync();
    }
    // Trailing update, `chunk` columns at a time: the panel's pivot rows
    // into the scratch slab (w x cw), then M += W * slab.
    for (int c0 = k0 + w; c0 < ld; c0 += s.chunk) {
      const int cw = min(s.chunk, ld - c0);
      for (int e = g.g; e < w * cw; e += g.n) {
        const int jj = e / cw, c = e - jj * cw;
        const int r = PIVOTED ? s.piv[k0 + jj] : k0 + jj;
        s.scratch[e] = r < b ? M[r * ld + c0 + c] : T(0);
      }
      g.sync();
      for (int e = g.g; e < b * cw; e += g.n) {
        const int i = e / cw, c = e - i * cw;
        T acc = T(0);
        for (int jj = 0; jj < w; ++jj) acc += W[i * kPanel + jj] * s.scratch[jj * cw + c];
        M[i * ld + c0 + c] = add_rn(M[i * ld + c0 + c], acc);
      }
      g.sync();
    }
  }
}

// Row k of M[:, b:] <- row piv[k] (zero where a step had no pivot), in place
// through the scratch slab: the JAX package's per-panel O^T contraction.
template <typename T, typename G>
__device__ void unscramble(const G& g, const Aug<T>& s, int b, int ld) {
  T* M = s.M;
  for (int c0 = b; c0 < ld; c0 += s.chunk) {
    const int w = min(s.chunk, ld - c0);
    for (int e = g.g; e < b * w; e += g.n) {
      const int k = e / w, c = e - k * w;
      const int p = s.piv[k];
      s.scratch[e] = p < b ? M[p * ld + c0 + c] : T(0);
    }
    g.sync();
    for (int e = g.g; e < b * w; e += g.n) {
      const int k = e / w, c = e - k * w;
      M[k * ld + c0 + c] = s.scratch[e];
    }
    g.sync();
  }
}

// Householder QR without pivoting of M[:, :b], applied to every column from
// k on, then back substitution in place: M[:, b:] <- X.
template <typename T, typename G>
__device__ void qr_solve(const G& g, const Aug<T>& s, int b, int ld) {
  const int lane = g.g & 31, warp = g.g >> 5;
  T* M = s.M;
  T* u = s.va;
  T* w = s.vc;
  const T eps = T(1e-30);
  for (int k = 0; k < b; ++k) {
    if (warp == 0) {
      T ss = T(0);
      for (int i = k + lane; i < b; i += 32) {
        const T v = M[i * ld + k];
        ss += v * v;
      }
      ss = warp_sum(ss);
      if (lane == 0) {
        const T vk = M[k * ld + k];
        const T norm = dsqrt(ss + eps);
        const T sgn = vk >= T(0) ? T(1) : T(-1);
        const T avk = vk >= T(0) ? vk : -vk;
        u[k] = vk + sgn * norm;
        s.sc[0] = T(1) / (norm * (norm + avk) + eps);
      }
      for (int i = k + 1 + lane; i < b; i += 32) u[i] = M[i * ld + k];
    }
    g.sync();
    for (int j = k + g.g; j < ld; j += g.n) {
      T acc = T(0);
      for (int i = k; i < b; ++i) acc += u[i] * M[i * ld + j];
      w[j] = acc;
    }
    g.sync();
    // One element per thread over the trailing block: a warp per row would
    // leave most of its lanes idle at K1's b = 20.
    const T beta = s.sc[0];
    const int cols = ld - k;
    for (int e = g.g; e < (b - k) * cols; e += g.n) {
      const int i = k + e / cols, j = k + (e - (e / cols) * cols);
      M[i * ld + j] -= (beta * u[i]) * w[j];
    }
    g.sync();
  }
  for (int c = b + g.g; c < ld; c += g.n) {
    for (int k = b - 1; k >= 0; --k) {
      T acc = M[k * ld + c];
      for (int j = k + 1; j < b; ++j) acc -= M[k * ld + j] * M[j * ld + c];
      M[k * ld + c] = acc / M[k * ld + k];
    }
  }
  g.sync();
}

// `refine` steps of X <- X + A^-1 (N - A X) with X = M[:, b : b + nrhs] and
// A^-1 = M[:, b + nrhs :]: A into the head (free after the elimination), then
// a chunk of X columns at a time.
template <typename T, typename G, typename Orig>
__device__ void refine_steps(const G& g, const Aug<T>& s, int b, int nrhs, int refine,
                             const Orig& orig) {
  const int lane = g.g & 31, warp = g.g >> 5, nw = g.n >> 5;
  const int ld = 2 * b + nrhs;
  T* M = s.M;
  for (int i = warp; i < b; i += nw)
    for (int j = lane; j < b; j += 32) M[i * ld + j] = orig(i, j);
  g.sync();
  for (int step = 0; step < refine; ++step) {
    for (int c0 = 0; c0 < nrhs; c0 += s.chunk) {
      const int w = min(s.chunk, nrhs - c0);
      for (int e = g.g; e < b * w; e += g.n) {
        const int i = e / w, c = e - i * w;
        T acc = T(0);
        for (int m = 0; m < b; ++m) acc += M[i * ld + m] * M[m * ld + b + c0 + c];
        s.scratch[e] = orig(i, b + c0 + c) - acc;
      }
      g.sync();
      for (int e = g.g; e < b * w; e += g.n) {
        const int i = e / w, c = e - i * w;
        T acc = T(0);
        for (int m = 0; m < b; ++m) acc += M[i * ld + b + nrhs + m] * s.scratch[m * w + c];
        M[i * ld + b + c0 + c] = add_rn(M[i * ld + b + c0 + c], acc);
      }
      g.sync();
    }
  }
}

// Columns of the working matrix: [A | N], or [A | N | I] with refinement.
__host__ __device__ __forceinline__ int aug_ld(int b, int nrhs, int refine) {
  return b + nrhs + (refine ? b : 0);
}

// Fill M = [orig | I (refine)] from `orig` (b x (b + nrhs)).
template <typename T, typename G, typename Orig>
__device__ void load(const G& g, const Aug<T>& s, int b, int nrhs, int refine, const Orig& orig) {
  const int lane = g.g & 31, warp = g.g >> 5, nw = g.n >> 5;
  const int ld = aug_ld(b, nrhs, refine);
  for (int i = warp; i < b; i += nw)
    for (int j = lane; j < ld; j += 32)
      s.M[i * ld + j] = j < b + nrhs ? orig(i, j) : (j - b - nrhs == i ? T(1) : T(0));
  g.sync();
}

// Solve the loaded M in place (M[:, b : b + nrhs] <- X); `orig` gives A and
// N to the refinement steps.
template <int FAM, typename T, typename G, typename Orig>
__device__ void solve_loaded(const G& g, const Aug<T>& s, int b, int nrhs, int refine,
                             const Orig& orig) {
  const int ld = aug_ld(b, nrhs, refine);
  if (FAM == kQR) {
    qr_solve(g, s, b, ld);
    return;
  }
  if (FAM == kGJ) {
    gj_eliminate(g, s, b, ld);
  } else if (FAM == kGJP) {
    gjp_eliminate(g, s, b, ld);
    contract_head(g, s, b, ld);
  } else if (FAM == kGJB) {
    gjb_eliminate<T, false>(g, s, b, ld);
  } else {
    gjb_eliminate<T, true>(g, s, b, ld);
    unscramble(g, s, b, ld);
  }
  if (refine) refine_steps(g, s, b, nrhs, refine, orig);
}

// ---- The step of the one-way sweeps K1 (thomas.cu) and K7a (thomas_babe.cu).

// One sweep direction's shared memory: the fact's working set for
// [D - L C | U | r - L d] (nrhs = b + 1), the original of that matrix (with
// refinement only: `orig` of the refinement steps), L (b x b; after the
// matrix is formed, the scratch slab of the contractions, chunk = b) and
// [C | d] (b x (b+1)) of the previous step, then of this one.
template <typename T>
struct Sweep {
  Aug<T> s;
  T* M0;
  T* Lm;
  T* Cd;
};

__host__ __device__ __forceinline__ size_t sweep_bytes(int b, int fam, int refine, size_t sz) {
  const int ld = aug_ld(b, b + 1, refine);
  return aug_bytes(b, ld, fam, 0, sz) +
         sz * ((refine ? (size_t)b * (2 * b + 1) : 0) + (size_t)b * b + (size_t)b * (b + 1));
}

template <typename T>
__device__ Sweep<T> carve_sweep(unsigned char* base, int b, int fam, int refine) {
  const int ld = aug_ld(b, b + 1, refine);
  Sweep<T> w;
  w.s = carve(reinterpret_cast<T*>(base), b, ld, fam, 0);
  T* p = reinterpret_cast<T*>(base + aug_bytes(b, ld, fam, 0, sizeof(T)));
  w.M0 = p;
  p += refine ? b * (2 * b + 1) : 0;
  w.Lm = p;
  w.Cd = p + b * b;
  w.s.scratch = w.Lm;
  w.s.chunk = b;
  return w;
}

// [C | d] of (D - Lp C_prev) [C | d] = [Un | r - Lp d_prev] into W.Cd and
// cd_out (b x (b+1)); Lp == nullptr at the chain's start (W.Cd then holds
// nothing that is read), Un == nullptr for a zero coupling.
template <int FAM, typename T, typename G>
__device__ void sweep_step(const G& g, const Sweep<T>& W, int b, int refine, const T* Dt,
                           const T* Lp, const T* Un, const T* rt, T* cd_out) {
  const int n0 = 2 * b + 1, ldc = b + 1;
  const int ld = aug_ld(b, ldc, refine);
  T* M = W.s.M;
  if (Lp != nullptr)
    for (int e = g.g; e < b * b; e += g.n) W.Lm[e] = Lp[e];
  g.sync();  // Lm loaded; Cd holds the previous step
  for (int e = g.g; e < b * ld; e += g.n) {
    const int i = e / ld, j = e - (e / ld) * ld;
    if (j >= n0) {
      M[i * ld + j] = j - n0 == i ? T(1) : T(0);
      continue;
    }
    T val = j < b ? Dt[i * b + j] : (j < 2 * b ? (Un ? Un[i * b + (j - b)] : T(0)) : rt[i]);
    if (Lp != nullptr && (j < b || j == 2 * b)) {
      const int cj = j < b ? j : b;
      T acc = T(0);
      for (int k = 0; k < b; ++k) acc += W.Lm[i * b + k] * W.Cd[k * ldc + cj];
      val -= acc;
    }
    M[i * ld + j] = val;
    if (refine) W.M0[i * n0 + j] = val;
  }
  g.sync();
  solve_loaded<FAM>(g, W.s, b, ldc, refine, SmemMat<T>{W.M0, n0});
  for (int e = g.g; e < b * ldc; e += g.n) {
    const int i = e / ldc, c = e - (e / ldc) * ldc;
    const T v = M[i * ld + b + c];
    W.Cd[e] = v;
    cd_out[e] = v;
  }
}

}  // namespace solve_aug
