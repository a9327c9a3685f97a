// K3: batched block-tridiagonal solve by block cyclic reduction, for sm_90a,
// with every in-block factorization ("fact") of the JAX package: Householder
// QR ("qr"), pivot-free Gauss-Jordan ("gj"), Gauss-Jordan with implicit
// partial pivoting ("gjp"), gjp plus one explicit-inverse refinement step
// ("gjpr"), and the blocked eliminations in panels of 32 columns, pivot-free
// ("gjb", "gjbr", "gjbr2": 0, 1, 2 refinement steps) and with gjp's pivot
// sequence ("gjbp", "gjbpr", "gjbpr2", and "gjbprl", which is gjbpr's
// algebra). The facts on a cluster of column slabs are in
// solve_aug_slab.cuh.
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
// Bound on this card (NVIDIA H100 80GB HBM3): at the N=4 flagship (B=8,
// T=30, b=40, gjp, float32) the solve reads the bands and the right side
// once (4.6 MB, 1.4 us at 3.35 TB/s) and does 0.27 GFLOP (chip_smoke.cr_counts,
// every column of the elimination included): 4.1 us at the 67 TFLOP/s
// float32 rate, bound by operations; at the N=10 flagship (b=100, gjpr) 7.1
// GFLOP, 106 us. Neither sees the serial chain: b elimination steps per
// odd-block solve, and the levels one after another with fewer systems each
// (120, 64, 32, 16, 8 odd blocks at T=30, B=8 against 132 SMs).
//
// Design: host-side recursion over the static level shapes; per level one
// launch of the odd-block solve on a grid of thread block clusters, one
// cluster of C CTAs per (odd block, lane), C in {1, 2, 4, 8} chosen per level
// by the plan (cyclic_reduction.cr_plan: a level with few odd blocks takes a
// larger C, so that the deep levels and the base fill more of the card;
// every slab fits the 232,448 bytes a block may hold, b=100 in float64
// included). CTA r holds the column slab [lo[r], lo[r+1]) of the odd block's
// [D_o | L_o | U_o | r_o (| I)] (all b rows) in its shared memory, and the
// elimination broadcasts each step's pivot and multipliers through
// distributed shared memory with one cluster barrier per step (QR: u and
// beta; the blocked facts: each panel's W, two barriers per panel). Each CTA
// then forms, for its own columns of the solution, the even-row products
// that need it, register-tiled with U_e and L_e read from L2:
// D - U_e D_o^-1 L_o, r - U_e D_o^-1 r_o and U'_k for its pair, and
// L_e D_o^-1 U_o, L_e D_o^-1 r_o and L'_{k+1} for the next pair (written to
// separate arrays that the next level subtracts on load, in the plain
// version's order). Then one launch for the T=1 base (B clusters), and one
// back-substitution launch per level on a grid over (pair, lane, 64-row
// tile), a thread per row of x_o (its two b-long dot products summed in row
// order, as before the redesign: the T=64 lane change is chaotic enough at
// tol 1e-4 that a new summation order moves its iteration count). Every
// launch checks with cudaOccupancyMaxActiveClusters that its
// cluster can be resident and returns an error if not; nothing falls back.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "solve_aug_slab.cuh"

namespace {

using namespace solve_aug;
using solve_aug_slab::Cols;
using solve_aug_slab::kThreads;
using solve_aug_slab::kWarps;
using solve_aug_slab::Slab;
namespace cg = cooperative_groups;

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


// A b x b band block of lane z read from global memory (nullptr: zero).
template <typename T>
struct Block {
  const T* p;
  int b;
  __device__ T operator()(int i, int m) const { return p ? __ldg(p + (size_t)i * b + m) : T(0); }
};

// One level: odd block o = 2k+1 of lane z on the cluster (blockIdx.x / C),
// then its even-row products for this CTA's columns of the solution.
template <typename T, int FAM>
__global__ void __launch_bounds__(kThreads, 2) cr_reduce_kernel(
    Level<T> in, int b, int H, int refine, Cols cols, int lds, T* __restrict__ sol,
    T* __restrict__ Dp, T* __restrict__ Dq, T* __restrict__ rp, T* __restrict__ rq,
    T* __restrict__ Ln, T* __restrict__ Un, T* __restrict__ hs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rank = (int)cg::this_cluster().block_rank();
  const int k = blockIdx.x / cols.C;
  const long long z = blockIdx.y;
  const int nrhs = 2 * b + 1;
  const Slab<T> s = solve_aug_slab::carve<T>(smem_raw, b, lds, FAM, refine, cols, rank);
  const int o = 2 * k + 1, e = 2 * k;
  const OddBlock<T> orig{in, z, o, b};
  const long long bb = (long long)b * b;
  const long long pair = z * H + k;
  solve_aug_slab::load_slab(s, nrhs, orig);
  solve_aug_slab::csync(cols.C);  // every CTA runs: distributed shared memory is safe
  solve_aug_slab::solve_slab<FAM>(s, nrhs, refine, orig, hs + pair * 2 * bb);
  // This CTA's columns of X = [D_o^-1 L_o | D_o^-1 U_o | D_o^-1 r_o].
  const int xa = max(0, b - s.c0), xe = min(s.ws, b + nrhs - s.c0);
  if (xe > xa) {
    const int g0 = s.c0 + xa - b;  // X column of the first local one
    const int nx = xe - xa;
    const T* X = s.M + xa;
    for (int i = threadIdx.x >> 5; i < b; i += kWarps)
      for (int j = threadIdx.x & 31; j < nx; j += 32)
        sol[(pair * b + i) * nrhs + g0 + j] = X[(size_t)i * lds + j];
    // U_e X: D_e - U_e D_o^-1 L_o, -(U_e D_o^-1 U_o), r_e - U_e D_o^-1 r_o.
    const Block<T> Ue{e < in.nT - 1 ? in.U + z * in.u_bs + (long long)e * bb : nullptr, b};
    solve_aug_slab::tile_product<false, true>(
        s, b, b, Ue, X, lds, nx, 1 << 30, [=](int i, int c, T acc) {
          const int g = g0 + c;
          if (g < b) {
            Dp[pair * bb + i * b + g] = sub_rn(D_at(in, z, e, i, g, b), acc);
          } else if (g < 2 * b) {
            Un[pair * bb + i * b + (g - b)] = -acc;
          } else {
            rp[pair * b + i] = sub_rn(r_at(in, z, e, i, b), acc);
          }
        });
    if (k + 1 < H) {
      // L_{e+2} X: -(L_e D_o^-1 L_o), L_e D_o^-1 U_o, L_e D_o^-1 r_o of pair k+1.
      const long long nxt = pair + 1;
      const int t = e + 2;
      const Block<T> Le{t < in.nT ? in.L + z * in.l_bs + (long long)(t - in.l_off) * bb : nullptr,
                        b};
      solve_aug_slab::tile_product<false, true>(
          s, b, b, Le, X, lds, nx, 1 << 30, [=](int i, int c, T acc) {
            const int g = g0 + c;
            if (g < b) {
              Ln[nxt * bb + i * b + g] = -acc;
            } else if (g < 2 * b) {
              Dq[nxt * bb + i * b + (g - b)] = acc;
            } else {
              rq[nxt * b + i] = acc;
            }
          });
    }
  }
  if (k == 0 && rank == 0) {  // pair 0 has no previous odd block
    for (int q = threadIdx.x; q < b * b; q += kThreads) {
      Dq[pair * bb + q] = T(0);
      Ln[pair * bb + q] = T(0);
    }
    for (int i = threadIdx.x; i < b; i += kThreads) rq[pair * b + i] = T(0);
  }
  solve_aug_slab::csync(cols.C);
}

// The T=1 base: x = D^-1 r per lane, on the cluster blockIdx.x / C.
template <typename T, int FAM>
__global__ void __launch_bounds__(kThreads, 2) cr_base_kernel(Level<T> in, int b, int refine,
                                                           Cols cols, int lds,
                                                           T* __restrict__ x,
                                                           T* __restrict__ hs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rank = (int)cg::this_cluster().block_rank();
  const long long z = blockIdx.x / cols.C;
  const Slab<T> s = solve_aug_slab::carve<T>(smem_raw, b, lds, FAM, refine, cols, rank);
  const BaseBlock<T> orig{in, z, b};
  solve_aug_slab::load_slab(s, 1, orig);
  solve_aug_slab::csync(cols.C);
  solve_aug_slab::solve_slab<FAM>(s, 1, refine, orig, hs + z * 2 * (long long)b * b);
  if (s.c0 <= b && b < s.c1)
    for (int i = threadIdx.x; i < b; i += kThreads) x[z * b + i] = s.M[(size_t)i * lds + b - s.c0];
  solve_aug_slab::csync(cols.C);
}

// Back substitution of one level on a grid over (pair, lane, tile of
// kBackRows rows): x[2k] = x_e[k], x[2k+1] = (Dr - DL x_e[k]) - DU x_e[k+1]
// (x_e[H] = 0), a thread per row of x_o, each sum in row order; writes only
// blocks t < out_T.
constexpr int kBackRows = 64;

template <typename T>
__global__ void __launch_bounds__(kBackRows) cr_backsub_kernel(
    const T* __restrict__ sol, const T* __restrict__ xe, int xe_T, int b, int H,
    T* __restrict__ x, int out_T) {
  const int k = blockIdx.x;
  const long long z = blockIdx.y;
  const int nrhs = 2 * b + 1;
  const T* x0 = xe + (z * xe_T + k) * (long long)b;
  const T* x1 = x0 + b;
  T* out = x + z * (long long)out_T * b;
  const int i = blockIdx.z * kBackRows + threadIdx.x;
  if (i >= b) return;
  if (2 * k < out_T) out[(long long)(2 * k) * b + i] = x0[i];
  if (2 * k + 1 >= out_T) return;
  const T* row = sol + ((z * H + k) * (long long)b + i) * nrhs;
  T a = T(0), c = T(0);
  for (int m = 0; m < b; ++m) a += row[m] * x0[m];
  if (k + 1 < H)
    for (int m = 0; m < b; ++m) c += row[b + m] * x1[m];
  out[(long long)(2 * k + 1) * b + i] = sub_rn(sub_rn(row[2 * b], a), c);
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

// Workspace elements, in layout order: per level sol, Dp, Dq, Ln, Un, rp, rq,
// then each level's solution x (levels >= 1; level 0 writes the output),
// then the base's x, then the clusters' scratch (2 b x b each, sized for
// the widest level).
long long workspace_elems(int B, int T, int b) {
  const Plan p = make_plan(T);
  long long n = 0;
  for (int l = 0; l < p.nlev; ++l) {
    const long long H = p.H[l];
    n += B * H * b * (2LL * b + 1) + 4LL * B * H * b * b + 2LL * B * H * b;
    if (l > 0) n += (long long)B * 2 * p.H[l] * b;
  }
  const long long H0 = p.nlev ? p.H[0] : 1;
  return n + (long long)B * b + 2LL * B * H0 * b * b;
}

// One launch of the plan (cyclic_reduction.cr_plan): cluster size, slab
// bounds and shared memory per CTA.
struct Launch {
  Cols cols;
  int lds;
  size_t smem;
};

// Reads launch `l` of the plan (records of 3 + kMaxCluster + 1 ints: C,
// threads, smem, lo[0..C]) and checks it against this source's layout.
int read_launch(const int* plan, int l, int b, int ld, int fam, int refine, size_t sz,
                Launch& out) {
  const int* r = plan + l * (3 + solve_aug_slab::kMaxCluster + 1);
  const int C = r[0];
  if (C < 1 || C > solve_aug_slab::kMaxCluster || (C & (C - 1)) || r[1] != kThreads)
    return (int)cudaErrorInvalidValue;
  out.cols.C = C;
  int wsmax = 0;
  for (int q = 0; q <= C; ++q) out.cols.lo[q] = r[3 + q];
  if (out.cols.lo[0] != 0 || out.cols.lo[C] != ld) return (int)cudaErrorInvalidValue;
  for (int q = 0; q < C; ++q) {
    const int lo = out.cols.lo[q], hi = out.cols.lo[q + 1];
    if (hi <= lo) return (int)cudaErrorInvalidValue;
    if (solve_aug_slab::blocked(fam) && lo < b && lo % kPanel) return (int)cudaErrorInvalidValue;
    wsmax = hi - lo > wsmax ? hi - lo : wsmax;
  }
  out.lds = wsmax;
  out.smem = solve_aug_slab::slab_bytes(b, wsmax, fam, refine, sz);
  if (out.smem != (size_t)r[2] || out.smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  return 0;
}

// What has been checked for one kernel: the largest shared-memory attribute
// set, and per cluster size the largest size found resident.
struct Checked {
  const void* kernel;
  size_t attr;
  size_t resident[4];
};

// Launch `kernel` on `grid` clusters of launch L after the shared-memory
// attribute and the residency check (cudaOccupancyMaxActiveClusters), each
// done once per kernel and size.
template <typename K, typename... Args>
int launch_clusters(K kernel, dim3 grid, const Launch& L, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = L.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = L.cols.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  static Checked seen[64];
  static int nseen = 0;
  Checked* c = nullptr;
  for (int q = 0; q < nseen; ++q)
    if (seen[q].kernel == (const void*)kernel) c = &seen[q];
  if (c == nullptr) {
    if (nseen == 64) return (int)cudaErrorInvalidValue;
    c = &seen[nseen++];
    *c = Checked{(const void*)kernel, 0, {0, 0, 0, 0}};
  }
  cudaError_t err;
  if (L.smem > c->attr) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)L.smem);
    if (err != cudaSuccess) return (int)err;
    c->attr = L.smem;
  }
  const int slot = L.cols.C == 1 ? 0 : L.cols.C == 2 ? 1 : L.cols.C == 4 ? 2 : 3;
  if (L.smem + 1 > c->resident[slot]) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
    c->resident[slot] = L.smem + 1;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, int FAM>
int solve(const T* diag, const T* lower, const T* upper, const T* rhs, T* work, T* x, int B,
          int T_, int b, int refine, long long lower_bs, long long upper_bs, const int* plan,
          cudaStream_t stream) {
  const Plan p = make_plan(T_);
  const size_t sz = sizeof(T);
  const int nc_red = aug_ld(b, 2 * b + 1, refine);
  const int nc_base = aug_ld(b, 1, refine);
  Launch red[32], base;
  for (int l = 0; l < p.nlev; ++l) {
    const int err = read_launch(plan, l, b, nc_red, FAM, refine, sz, red[l]);
    if (err) return err;
  }
  int err = read_launch(plan, p.nlev, b, nc_base, FAM, refine, sz, base);
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
  w += (long long)B * b;
  T* hs = w;

  Level<T> lev{diag, nullptr, lower, upper, rhs, nullptr,
               (long long)T_ * bb, lower_bs, upper_bs, (long long)T_ * b, T_, 1};
  for (int l = 0; l < p.nlev; ++l) {
    const int H = p.H[l];
    err = launch_clusters(cr_reduce_kernel<T, FAM>, dim3(red[l].cols.C * H, B, 1), red[l],
                          stream, lev, b, H, refine, red[l].cols, red[l].lds, sol[l], Dp[l],
                          Dq[l], rp[l], rq[l], Ln[l], Un[l], hs);
    if (err) return err;
    lev = Level<T>{Dp[l], Dq[l], Ln[l], Un[l], rp[l], rq[l],
                   H * bb, H * bb, H * bb, (long long)H * b, H, 0};
  }
  err = launch_clusters(cr_base_kernel<T, FAM>, dim3(base.cols.C * B, 1, 1), base, stream, lev,
                        b, refine, base.cols, base.lds, xl[p.nlev], hs);
  if (err) return err;
  for (int l = p.nlev - 1; l >= 0; --l) {
    const int H = p.H[l];
    const int xe_T = (l + 1 < p.nlev) ? 2 * p.H[l + 1] : 1;
    const int out_T = (l == 0) ? T_ : 2 * H;
    cr_backsub_kernel<T><<<dim3(H, B, (b + kBackRows - 1) / kBackRows), kBackRows, 0, stream>>>(
        sol[l], xl[l + 1], xe_T, b, H, xl[l], out_T);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}

template <typename T>
int dispatch(int fam, int refine, const void* diag, const void* lower, const void* upper,
             const void* rhs, void* work, void* x, int B, int T_, int b, long long lbs,
             long long ubs, const int* plan, cudaStream_t s) {
  const T* d = static_cast<const T*>(diag);
  const T* lo = static_cast<const T*>(lower);
  const T* up = static_cast<const T*>(upper);
  const T* r = static_cast<const T*>(rhs);
  T* wk = static_cast<T*>(work);
  T* xx = static_cast<T*>(x);
  switch (fam) {
    case kQR: return solve<T, kQR>(d, lo, up, r, wk, xx, B, T_, b, 0, lbs, ubs, plan, s);
    case kGJ: return solve<T, kGJ>(d, lo, up, r, wk, xx, B, T_, b, 0, lbs, ubs, plan, s);
    case kGJP: return solve<T, kGJP>(d, lo, up, r, wk, xx, B, T_, b, refine, lbs, ubs, plan, s);
    case kGJB: return solve<T, kGJB>(d, lo, up, r, wk, xx, B, T_, b, refine, lbs, ubs, plan, s);
    case kGJBP: return solve<T, kGJBP>(d, lo, up, r, wk, xx, B, T_, b, refine, lbs, ubs, plan, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The build compiles this file as two translation units, once with each
// -DMCP_PART=k, and links them into one library (kernels/_build.py, PARTS):
// part 0 holds the float32 instances and the entry points, part 1 the
// float64 instances. Without MCP_PART one unit holds everything.
#define MCP_CR_PART_PARAMS                                                                 \
  int fam, int refine, const void *diag, const void *lower, const void *upper,             \
      const void *rhs, void *work, void *x, int B, int T, int b, long long lower_bs,        \
      long long upper_bs, const int *plan, void *stream
#define MCP_CR_PART(k, DT)                                                                  \
  extern "C" int mcp_cr_part##k(MCP_CR_PART_PARAMS) {                                       \
    return dispatch<DT>(fam, refine, diag, lower, upper, rhs, work, x, B, T, b, lower_bs,   \
                        upper_bs, plan, static_cast<cudaStream_t>(stream));                 \
  }

extern "C" {
int mcp_cr_part0(MCP_CR_PART_PARAMS);
int mcp_cr_part1(MCP_CR_PART_PARAMS);
}

#if !defined(MCP_PART) || MCP_PART == 1
MCP_CR_PART(1, double)
#endif

#if !defined(MCP_PART) || MCP_PART == 0
MCP_CR_PART(0, float)

// Elements of the workspace buffer mcp_cr_solve needs for (B, T, b).
extern "C" long long mcp_cr_workspace(int B, int T, int b) { return workspace_elems(B, T, b); }

// dtype: 0 = float32, 1 = float64; fam: the fact's family (solve_aug.cuh:
// 0 qr, 1 gj, 2 gjp, 3 gjb, 4 gjbp) and refine its refinement steps (0 for
// qr and gj). Layouts (row-major, contiguous within a system): diag
// (B,T,b,b), lower/upper (B,T-1,b,b) with a lane stride of `*_bs` elements
// (0 = one band shared by every lane), rhs (B,T,b), work (mcp_cr_workspace
// elements), x (B,T,b). `plan` (cyclic_reduction.cr_plan) holds one record
// per level and one for the base, each C, threads, shared-memory bytes per
// CTA and the C + 1 slab bounds (12 ints). Launches on `stream`; returns the
// first CUDA error (0 on success).
extern "C" int mcp_cr_solve(int dtype, int fam, int refine, const void* diag, const void* lower,
                            const void* upper, const void* rhs, void* work, void* x, int B,
                            int T, int b, long long lower_bs, long long upper_bs,
                            const int* plan, void* stream) {
  return (dtype == 0 ? mcp_cr_part0 : mcp_cr_part1)(fam, refine, diag, lower, upper, rhs, work,
                                                    x, B, T, b, lower_bs, upper_bs, plan,
                                                    stream);
}
#endif
