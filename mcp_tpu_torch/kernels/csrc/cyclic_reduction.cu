// K3: batched block-tridiagonal solve by block cyclic reduction, for sm_90a,
// with every in-block factorization ("fact") of the JAX package: Householder
// QR ("qr"), pivot-free Gauss-Jordan ("gj"), Gauss-Jordan with implicit
// partial pivoting ("gjp"), gjp plus one explicit-inverse refinement step
// ("gjpr"), and the blocked eliminations in panels of 32 columns, pivot-free
// ("gjb", "gjbr", "gjbr2": 0, 1, 2 refinement steps) and with gjp's pivot
// sequence ("gjbp", "gjbpr", "gjbpr2", and "gjbprl", which is gjbpr's
// algebra). The facts themselves are in solve_aug.cuh.
//
// Replaces mcp_tpu/kernels/thomas_pallas.py::_thomas_kernel_cr_packed
// (:1154) and ::_thomas_kernel_cr_split (:1167), i.e. _cr_solve (:1055) with
// _solve_aug (:431). One source covers both TPU kernels: their split is a
// lane-packing rule (3b+1 <= 128) of the TPU.
//
// What it computes (cyclic_reduction.cr_solve_plain is the same algebra in
// PyTorch): an odd T is padded with a decoupled identity block; each level
// solves every odd block o = 2k+1 against [L_o | U_o | r_o], folds the
// results into the even rows
//   D'_k = (D_e - U_e D_o^-1 L_o) - L_e D_{o-2}^-1 U_{o-2},  r'_k likewise,
//   L'_k = -(L_e D_{o-2}^-1 L_{o-2}),  U'_k = -(U_e D_o^-1 U_o),
// recurses on the half-size system, solves the T=1 base [D | r] and
// back-substitutes x_o = (D_o^-1 r_o - D_o^-1 L_o x_e) - D_o^-1 U_o x_{e+2}.
// The level products sum in another order than the plain version's matmuls.
//
// Bound on this card: at the N=4 flagship (B=8, T=30, b=40, gjp, float32)
// the solve reads the bands and the right side once (4.6 MB, 1.4 us at
// 3.35 TB/s) and does 0.27 GFLOP (chip_smoke.cr_counts, every column of the
// elimination included): 4.1 us at the 67 TFLOP/s float32 rate, bound by
// operations; at the N=10 flagship (b=100, gjpr) 7.1 GFLOP, 106 us. In
// practice neither binds: every elimination step is a serial link with
// two or three block-wide barriers (b steps per system and level), and the
// levels run one after another with fewer systems each (120, 64, 32, 16, 8
// blocks at T=30, B=8 against 132 SMs).
//
// Design (simple and correct first): host-side recursion over the static
// level shapes; per level one launch of the odd-block solve, one thread
// block per (odd block, lane), whose [D | L | U | r (| I)] matrix lives in
// shared memory (b x (3b+1), plus b identity columns with refinement:
// 160.4 KB at b=100 in float32, plus the 32-column panel W of the blocked
// facts; above 48 KB by dynamic shared memory after cudaFuncSetAttribute).
// The same block then forms the even-row products that need its own
// solution: D - U_e D_o^-1 L_o, r - U_e D_o^-1 r_o and U'_k for its pair,
// and L_e D_o^-1 U_o, L_e D_o^-1 r_o and L'_{k+1} for the next pair (written
// to separate arrays that the next level subtracts on load, in the plain
// version's order). Then one launch for the T=1 base, and one
// back-substitution launch per level. The contractions and the refinement
// run in place, a b x chunk column slab at a time, so every fact fits at
// b=100 in float32. The wrapper refuses shapes whose matrix does not fit a
// block (every fact at b=100 in float64).

#include <cuda_runtime.h>

#include "solve_aug.cuh"

namespace {

using namespace solve_aug;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 64;
constexpr size_t kSmemLimit = 232448;

// One level's bands in padded form: L(t) couples t to t-1 (zero at t = 0),
// U(t) couples t to t+1 (zero at the last block), blocks t >= nT are the
// identity pad. D(t) = D[t] - Dq[t] and r(t) = r[t] - rq[t] when Dq / rq
// are given (the two halves of the previous level's even-row update).
template <typename T>
struct Level {
  const T* D;
  const T* Dq;
  const T* L;
  const T* U;
  const T* r;
  const T* rq;
  long long d_bs, l_bs, u_bs, r_bs;  // lane strides (elements)
  int nT;
  int l_off;  // L(t) is stored at index t - l_off
};

template <typename T>
__device__ __forceinline__ T D_at(const Level<T>& v, long long z, int t, int i, int j, int b) {
  if (t >= v.nT) return i == j ? T(1) : T(0);
  const long long o = z * v.d_bs + (long long)t * b * b + i * b + j;
  return v.Dq ? sub_rn(v.D[o], v.Dq[o]) : v.D[o];
}

template <typename T>
__device__ __forceinline__ T L_at(const Level<T>& v, long long z, int t, int i, int j, int b) {
  if (t == 0 || t >= v.nT) return T(0);
  return v.L[z * v.l_bs + (long long)(t - v.l_off) * b * b + i * b + j];
}

template <typename T>
__device__ __forceinline__ T U_at(const Level<T>& v, long long z, int t, int i, int j, int b) {
  if (t >= v.nT - 1) return T(0);
  return v.U[z * v.u_bs + (long long)t * b * b + i * b + j];
}

template <typename T>
__device__ __forceinline__ T r_at(const Level<T>& v, long long z, int t, int i, int b) {
  if (t >= v.nT) return T(0);
  const long long o = z * v.r_bs + (long long)t * b + i;
  return v.rq ? sub_rn(v.r[o], v.rq[o]) : v.r[o];
}

// The original augmented matrix of an odd block: [D_o | L_o | U_o | r_o].
template <typename T>
struct OddBlock {
  Level<T> v;
  long long z;
  int t, b;
  __device__ T operator()(int i, int j) const {
    if (j < b) return D_at(v, z, t, i, j, b);
    if (j < 2 * b) return L_at(v, z, t, i, j - b, b);
    if (j < 3 * b) return U_at(v, z, t, i, j - 2 * b, b);
    return r_at(v, z, t, i, b);
  }
};

// The original augmented matrix of the base: [D_0 | r_0].
template <typename T>
struct BaseBlock {
  Level<T> v;
  long long z;
  int b;
  __device__ T operator()(int i, int j) const {
    return j < b ? D_at(v, z, 0, i, j, b) : r_at(v, z, 0, i, b);
  }
};

template <typename T>
__device__ Aug<T> carve_smem(int b, int ld, int fam, int chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  return carve(reinterpret_cast<T*>(smem_raw), b, ld, fam, chunk);
}

// One level: odd block o = 2k+1 of lane z, then its even-row products.
template <typename T, int FAM>
__global__ void __launch_bounds__(kThreads) cr_reduce_kernel(
    Level<T> in, int b, int H, int refine, int chunk, T* __restrict__ sol, T* __restrict__ Dp,
    T* __restrict__ Dq, T* __restrict__ rp, T* __restrict__ rq, T* __restrict__ Ln,
    T* __restrict__ Un) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k = blockIdx.x;
  const long long z = blockIdx.y;
  const int nrhs = 2 * b + 1;
  const int nc = aug_ld(b, nrhs, refine);
  const Aug<T> s = carve_smem<T>(b, nc, FAM, chunk);
  const BlockGroup g{tid, kThreads};
  T* M = s.M;
  const int o = 2 * k + 1, e = 2 * k;
  const OddBlock<T> orig{in, z, o, b};
  load(g, s, b, nrhs, refine, orig);
  solve_loaded<FAM>(g, s, b, nrhs, refine, orig);

  // [D_o^-1 L_o | D_o^-1 U_o | D_o^-1 r_o] for the back substitution.
  const long long bb = (long long)b * b;
  const long long pair = z * H + k;
  for (int i = warp; i < b; i += kWarps)
    for (int j = lane; j < nrhs; j += 32) sol[(pair * b + i) * nrhs + j] = M[i * nc + b + j];
  // U_e into the head: D_e - U_e D_o^-1 L_o, -(U_e D_o^-1 U_o), r_e - U_e D_o^-1 r_o.
  for (int i = warp; i < b; i += kWarps)
    for (int j = lane; j < b; j += 32) M[i * nc + j] = U_at(in, z, e, i, j, b);
  __syncthreads();
  for (int i = warp; i < b; i += kWarps) {
    for (int j = lane; j < nrhs; j += 32) {
      T acc = T(0);
      for (int m = 0; m < b; ++m) acc += M[i * nc + m] * M[m * nc + b + j];
      if (j < b) {
        Dp[pair * bb + i * b + j] = sub_rn(D_at(in, z, e, i, j, b), acc);
      } else if (j < 2 * b) {
        Un[pair * bb + i * b + (j - b)] = -acc;
      } else {
        rp[pair * b + i] = sub_rn(r_at(in, z, e, i, b), acc);
      }
    }
  }
  __syncthreads();
  if (k + 1 < H) {
    // L_{e+2} into the head: L_e D_o^-1 U_o, L_e D_o^-1 r_o, -(L_e D_o^-1 L_o)
    // of pair k+1.
    for (int i = warp; i < b; i += kWarps)
      for (int j = lane; j < b; j += 32) M[i * nc + j] = L_at(in, z, e + 2, i, j, b);
    __syncthreads();
    const long long nxt = pair + 1;
    for (int i = warp; i < b; i += kWarps) {
      for (int j = lane; j < nrhs; j += 32) {
        T acc = T(0);
        for (int m = 0; m < b; ++m) acc += M[i * nc + m] * M[m * nc + b + j];
        if (j < b) {
          Ln[nxt * bb + i * b + j] = -acc;
        } else if (j < 2 * b) {
          Dq[nxt * bb + i * b + (j - b)] = acc;
        } else {
          rq[nxt * b + i] = acc;
        }
      }
    }
  }
  if (k == 0) {  // pair 0 has no previous odd block
    for (int q = tid; q < b * b; q += kThreads) {
      Dq[pair * bb + q] = T(0);
      Ln[pair * bb + q] = T(0);
    }
    for (int i = tid; i < b; i += kThreads) rq[pair * b + i] = T(0);
  }
}

// The T=1 base: x = D^-1 r per lane.
template <typename T, int FAM>
__global__ void __launch_bounds__(kThreads) cr_base_kernel(Level<T> in, int b, int refine,
                                                           int chunk, T* __restrict__ x) {
  const int nc = aug_ld(b, 1, refine);
  const long long z = blockIdx.y;
  const Aug<T> s = carve_smem<T>(b, nc, FAM, chunk);
  const BlockGroup g{(int)threadIdx.x, kThreads};
  const BaseBlock<T> orig{in, z, b};
  load(g, s, b, 1, refine, orig);
  solve_loaded<FAM>(g, s, b, 1, refine, orig);
  for (int i = threadIdx.x; i < b; i += kThreads) x[z * b + i] = s.M[i * nc + b];
}

// Back substitution of one level: x[2k] = x_e[k], x[2k+1] = (Dr - DL x_e[k])
// - DU x_e[k+1] (x_e[H] = 0); writes only blocks t < out_T.
template <typename T>
__global__ void __launch_bounds__(kThreads) cr_backsub_kernel(
    const T* __restrict__ sol, const T* __restrict__ xe, int xe_T, int b, int H,
    T* __restrict__ x, int out_T) {
  const int k = blockIdx.x;
  const long long z = blockIdx.y;
  const int nrhs = 2 * b + 1;
  const T* S = sol + (z * H + k) * (long long)b * nrhs;
  const T* x0 = xe + (z * xe_T + k) * (long long)b;
  const T* x1 = x0 + b;
  T* out = x + z * (long long)out_T * b;
  for (int i = threadIdx.x; i < b; i += kThreads) {
    const T* row = S + (long long)i * nrhs;
    T a = T(0), c = T(0);
    for (int m = 0; m < b; ++m) a += row[m] * x0[m];
    if (k + 1 < H)
      for (int m = 0; m < b; ++m) c += row[b + m] * x1[m];
    if (2 * k < out_T) out[(long long)(2 * k) * b + i] = x0[i];
    if (2 * k + 1 < out_T) out[(long long)(2 * k + 1) * b + i] = sub_rn(sub_rn(row[2 * b], a), c);
  }
}

// The static level shapes: level l has nT real blocks, padded to an even
// Tp, and H = Tp / 2 pairs; the next level has H blocks. The base has 1.
struct Plan {
  int nlev;
  int nT[32], H[32];
};

Plan make_plan(int T) {
  Plan p{};
  int t = T;
  while (t > 1) {
    p.nT[p.nlev] = t;
    p.H[p.nlev] = (t + (t & 1)) / 2;
    t = p.H[p.nlev];
    ++p.nlev;
  }
  return p;
}

// The widest column slab (<= kMaxChunk) whose working set fits a block; 0 when
// not even one column does (cyclic_reduction.check_fits refuses those).
int pick_chunk(int b, int nc, int fam, size_t sz) {
  const size_t base = aug_bytes(b, nc, fam, 0, sz);
  if (base + sz * b > kSmemLimit) return 0;
  const size_t avail = (kSmemLimit - base) / (sz * b);
  return (int)(avail < (size_t)kMaxChunk ? avail : kMaxChunk);
}

template <typename K>
int allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

// Workspace elements, in layout order: per level sol, Dp, Dq, Ln, Un, rp, rq,
// then each level's solution x (levels >= 1; level 0 writes the output),
// then the base's x.
long long workspace_elems(int B, int T, int b) {
  const Plan p = make_plan(T);
  long long n = 0;
  for (int l = 0; l < p.nlev; ++l) {
    const long long H = p.H[l];
    n += B * H * b * (2LL * b + 1) + 4LL * B * H * b * b + 2LL * B * H * b;
    if (l > 0) n += (long long)B * 2 * p.H[l] * b;
  }
  return n + (long long)B * b;
}

template <typename T, int FAM>
int solve(const T* diag, const T* lower, const T* upper, const T* rhs, T* work, T* x, int B,
          int T_, int b, int refine, long long lower_bs, long long upper_bs,
          cudaStream_t stream) {
  const Plan p = make_plan(T_);
  const size_t sz = sizeof(T);
  const int nc_red = aug_ld(b, 2 * b + 1, refine);
  const int nc_base = aug_ld(b, 1, refine);
  const int chunk = pick_chunk(b, nc_red, FAM, sz);
  if (chunk == 0) return (int)cudaErrorInvalidValue;
  const size_t smem_red = aug_bytes(b, nc_red, FAM, chunk, sz);
  const size_t smem_base = aug_bytes(b, nc_base, FAM, chunk, sz);
  int err = allow_smem(cr_reduce_kernel<T, FAM>, smem_red);
  if (err) return err;
  err = allow_smem(cr_base_kernel<T, FAM>, smem_base);
  if (err) return err;

  // Carve the workspace.
  T* sol[32];
  T* Dp[32];
  T* Dq[32];
  T* Ln[32];
  T* Un[32];
  T* rp[32];
  T* rq[32];
  T* xl[33];
  T* w = work;
  const long long bb = (long long)b * b;
  for (int l = 0; l < p.nlev; ++l) {
    const long long H = p.H[l];
    sol[l] = w;
    w += B * H * b * (2LL * b + 1);
    Dp[l] = w;
    w += B * H * bb;
    Dq[l] = w;
    w += B * H * bb;
    Ln[l] = w;
    w += B * H * bb;
    Un[l] = w;
    w += B * H * bb;
    rp[l] = w;
    w += B * H * b;
    rq[l] = w;
    w += B * H * b;
  }
  xl[0] = x;
  for (int l = 1; l < p.nlev; ++l) {
    xl[l] = w;
    w += (long long)B * 2 * p.H[l] * b;
  }
  xl[p.nlev] = (p.nlev == 0) ? x : w;

  Level<T> lev{diag, nullptr, lower, upper, rhs, nullptr,
               (long long)T_ * bb, lower_bs, upper_bs, (long long)T_ * b, T_, 1};
  for (int l = 0; l < p.nlev; ++l) {
    const int H = p.H[l];
    cr_reduce_kernel<T, FAM><<<dim3(H, B), kThreads, smem_red, stream>>>(
        lev, b, H, refine, chunk, sol[l], Dp[l], Dq[l], rp[l], rq[l], Ln[l], Un[l]);
    err = (int)cudaGetLastError();
    if (err) return err;
    lev = Level<T>{Dp[l], Dq[l], Ln[l], Un[l], rp[l], rq[l],
                   H * bb, H * bb, H * bb, (long long)H * b, H, 0};
  }
  cr_base_kernel<T, FAM><<<dim3(1, B), kThreads, smem_base, stream>>>(lev, b, refine, chunk,
                                                                      xl[p.nlev]);
  err = (int)cudaGetLastError();
  if (err) return err;
  for (int l = p.nlev - 1; l >= 0; --l) {
    const int H = p.H[l];
    const int xe_T = (l + 1 < p.nlev) ? 2 * p.H[l + 1] : 1;
    const int out_T = (l == 0) ? T_ : 2 * H;
    cr_backsub_kernel<T><<<dim3(H, B), kThreads, 0, stream>>>(sol[l], xl[l + 1], xe_T, b, H,
                                                              xl[l], out_T);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}

template <typename T>
int dispatch(int fam, int refine, const void* diag, const void* lower, const void* upper,
             const void* rhs, void* work, void* x, int B, int T_, int b, long long lbs,
             long long ubs, cudaStream_t s) {
  const T* d = static_cast<const T*>(diag);
  const T* lo = static_cast<const T*>(lower);
  const T* up = static_cast<const T*>(upper);
  const T* r = static_cast<const T*>(rhs);
  T* wk = static_cast<T*>(work);
  T* xx = static_cast<T*>(x);
  switch (fam) {
    case kQR: return solve<T, kQR>(d, lo, up, r, wk, xx, B, T_, b, 0, lbs, ubs, s);
    case kGJ: return solve<T, kGJ>(d, lo, up, r, wk, xx, B, T_, b, 0, lbs, ubs, s);
    case kGJP: return solve<T, kGJP>(d, lo, up, r, wk, xx, B, T_, b, refine, lbs, ubs, s);
    case kGJB: return solve<T, kGJB>(d, lo, up, r, wk, xx, B, T_, b, refine, lbs, ubs, s);
    case kGJBP: return solve<T, kGJBP>(d, lo, up, r, wk, xx, B, T_, b, refine, lbs, ubs, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Elements of the workspace buffer mcp_cr_solve needs for (B, T, b).
extern "C" long long mcp_cr_workspace(int B, int T, int b) { return workspace_elems(B, T, b); }

// dtype: 0 = float32, 1 = float64; fam: the fact's family (solve_aug.cuh:
// 0 qr, 1 gj, 2 gjp, 3 gjb, 4 gjbp) and refine its refinement steps (0 for
// qr and gj). Layouts
// (row-major, contiguous within a system): diag (B,T,b,b), lower/upper
// (B,T-1,b,b) with a lane stride of `*_bs` elements (0 = one band shared by
// every lane), rhs (B,T,b), work (mcp_cr_workspace elements), x (B,T,b).
// Launches on `stream`; returns the first CUDA error (0 on success).
extern "C" int mcp_cr_solve(int dtype, int fam, int refine, const void* diag, const void* lower,
                            const void* upper, const void* rhs, void* work, void* x, int B,
                            int T, int b, long long lower_bs, long long upper_bs,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(fam, refine, diag, lower, upper, rhs, work, x, B, T, b, lower_bs,
                           upper_bs, s);
  return dispatch<double>(fam, refine, diag, lower, upper, rhs, work, x, B, T, b, lower_bs,
                          upper_bs, s);
}
