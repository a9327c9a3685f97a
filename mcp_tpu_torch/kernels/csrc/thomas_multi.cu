// K6: batched block-tridiagonal solve with k right-hand-side columns by the
// one-way block-Thomas sweep, for sm_90a: the local slab solve of the
// horizon-sharded SPIKE solve (parallel/horizon.py), whose k = 2b + 1 columns
// are [r | e_0 (x) L_bound | e_last (x) U_bound].
//
// Replaces mcp_tpu/kernels/thomas_pallas.py::_thomas_kernel_packed_multi
// (:572) with its fact "qr": the algebra of _qr_solve_aug (:33), the
// Householder QR of solve_aug.cuh (eps = 1e-30 inside the sqrt and in beta).
//
// Per system: for t = 0..T-1 solve (D_t - L_t C_{t-1}) [C_t | d_t] =
// [U_t | R_t - L_t d_{t-1}] (d_t and R_t have k columns), then back-substitute
// x_t = d_t - C_t x_{t+1} on all k columns. A zero or non-finite pivot gives
// inf/NaN in x; nothing sanitizes it.
//
// Bound on this card: at the lane-change path's shape (B=256, T/D=5, b=20,
// k=41, float32, bands shared by every system) the kernel must read diag
// and R and write x, ~10.5 MB: 3.1 us at 3.35 TB/s; its ~217 MFLOP (the QR
// of each b x (2b+k) step, L [C | d] and the back substitution;
// chip_smoke.multi_counts) take ~3.2 us at the 67 TFLOP/s float32 rate, so
// it is bound by operations. In practice neither binds: each step is a
// serial chain of b reflections, so the latency of one reflection sets the
// time.
//
// Two routes, chosen by the wrapper's plan (thomas_multi.multi_plan, a
// plain function of b, k and the dtype) and checked here against the
// kernels' own limits; one thread block per system on both, the T-serial
// chain inside it, so nothing crosses thread blocks. [C_t | d_t] of every
// step goes to a global workspace (B, T, b, b+k) that the wrapper allocates,
// in the route's own layout, read back by the backward sweep. diag, lower
// and upper take any batch stride (0 for a band shared by every system, T*b*b
// for a slab view of a longer band); each system's blocks are contiguous.
//
// "group" (b <= 48 and the working matrix [D - LC | U | R - L d] at most 256
// columns wide: 2b + k <= 128 on 128 threads, e.g. the lane change's
// b = 20, k = 41, else on 256): K7a's column-owner elimination
// (solve_aug_group.cuh, used as it is): thread j owns column j of the step's
// working matrix with all of its rows in registers, rows templated to BM in
// {8, 16, 24, 32, 40, 48}. The owner of column k forms the reflector from
// its own registers into a double-buffered shared slot; one block barrier a
// reflection; every thread updates its own column, and the owner of column
// k + 1 forms step k + 1 as soon as its own column is updated. R^T and
// Q^T N are retired to shared memory row by row, and threads b.. back-
// substitute their own columns of [C_t | d_t]. D, U, R and L of step t + 1
// arrive by cp.async into a second staging buffer while step t runs; the
// step's [C | d] stays in shared memory, where thread j forms its own column
// of D - L C (j < b) or R - L d (j >= 2b) from L^T's rows as broadcast
// vectors: no division, no barrier. The backward sweep keeps x_{t+1}
// column-owned (thread c on column c, in shared memory) and takes C_t and
// d_t through a two-slot cp.async ring, one barrier a step.
//
// "block" (every other shape; the A/B of the group route): K1's block
// design (thomas.cu) with its own __global__, so K1 is untouched: the step's
// working matrix in shared memory beside L and the previous [C | d]
// (b x (b+k)); solve_aug.cuh's block-group QR, three block barriers a
// reflection. The wrapper refuses what does not fit one block's shared
// memory.

#include <cuda_runtime.h>

#include "solve_aug.cuh"
#include "solve_aug_group.cuh"
#include "solve_aug_warp.cuh"

namespace {

using namespace solve_aug;

constexpr int kThreads = 256;

template <typename T>
size_t multi_bytes(int b, int k) {
  const int ld = 2 * b + k;
  return aug_bytes(b, ld, kQR, 0, sizeof(T)) + sizeof(T) * ((size_t)b * b + (size_t)b * (b + k));
}

template <typename T>
__global__ void __launch_bounds__(kThreads) multi_kernel(
    const T* __restrict__ diag, const T* __restrict__ lower,
    const T* __restrict__ upper, const T* __restrict__ rhs, T* __restrict__ cd,
    T* __restrict__ x, int nt, int b, int k, long long diag_bstride,
    long long lower_bstride, long long upper_bstride) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = 2 * b + k;  // [D - LC | U | R - L d]
  const int ldc = b + k;     // [C | d]
  Aug<T> s = carve(reinterpret_cast<T*>(smem_raw), b, ld, kQR, 0);
  T* Lm = reinterpret_cast<T*>(smem_raw + aug_bytes(b, ld, kQR, 0, sizeof(T)));
  T* Cd = Lm + b * b;
  const BlockGroup g{(int)threadIdx.x, kThreads};
  const int tid = threadIdx.x;
  const long long bb = (long long)b * b, bk = (long long)b * k;
  const long long sys = blockIdx.x;
  const T* D_sys = diag + sys * diag_bstride;
  const T* L_sys = lower + sys * lower_bstride;
  const T* U_sys = upper + sys * upper_bstride;
  const T* R_sys = rhs + sys * nt * bk;
  T* cd_sys = cd + sys * nt * b * ldc;
  T* x_sys = x + sys * nt * bk;
  T* M = s.M;

  for (int t = 0; t < nt; ++t) {
    const T* Dt = D_sys + t * bb;
    const T* Un = t < nt - 1 ? U_sys + t * bb : nullptr;
    const T* Rt = R_sys + t * bk;
    if (t > 0)
      for (int e = tid; e < b * b; e += kThreads) Lm[e] = L_sys[(t - 1) * bb + e];
    g.sync();  // Lm loaded; Cd holds the previous step
    for (int e = tid; e < b * ld; e += kThreads) {
      const int i = e / ld, j = e - (e / ld) * ld;
      T val = j < b ? Dt[i * b + j] : (j < 2 * b ? (Un ? Un[i * b + (j - b)] : T(0))
                                                 : Rt[i * k + (j - 2 * b)]);
      if (t > 0 && (j < b || j >= 2 * b)) {
        const int cj = j < b ? j : j - b;
        T acc = T(0);
        for (int m = 0; m < b; ++m) acc += Lm[i * b + m] * Cd[m * ldc + cj];
        val -= acc;
      }
      M[i * ld + j] = val;
    }
    g.sync();
    qr_solve(g, s, b, ld);  // M[:, b:] <- [C_t | d_t]
    T* cd_t = cd_sys + (long long)t * b * ldc;
    for (int e = tid; e < b * ldc; e += kThreads) {
      const int i = e / ldc, c = e - (e / ldc) * ldc;
      const T v = M[i * ld + b + c];
      Cd[e] = v;
      cd_t[e] = v;
    }
  }
  g.sync();

  // Backward sweep x_t = d_t - C_t x_{t+1}, x_T = 0, on all k columns:
  // x_{t+1} in xn (the working matrix, b*ld >= b*k), x_t into xt (Cd's space).
  T* xn = M;
  T* xt = Cd;
  for (int e = tid; e < b * k; e += kThreads) xn[e] = T(0);
  g.sync();
  for (int t = nt - 1; t >= 0; --t) {
    const T* cdt = cd_sys + (long long)t * b * ldc;
    for (int e = tid; e < b * k; e += kThreads) {
      const int i = e / k, c = e - (e / k) * k;
      T acc = cdt[i * ldc + b + c];
      for (int j = 0; j < b; ++j) acc -= cdt[i * ldc + j] * xn[j * k + c];
      xt[e] = acc;
      x_sys[t * bk + e] = acc;
    }
    g.sync();
    T* tmp = xn;
    xn = xt;
    xt = tmp;
  }
}

struct Args {
  const void *diag, *lower, *upper, *rhs;
  void *cd, *x;
  int B, nt, b, k;
  long long dbs, lbs, ubs;
  cudaStream_t stream;
};

template <typename T>
int launch_block(const Args& a) {
  const size_t smem = multi_bytes<T>(a.b, a.k);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        multi_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  multi_kernel<T><<<a.B, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.diag), static_cast<const T*>(a.lower),
      static_cast<const T*>(a.upper), static_cast<const T*>(a.rhs), static_cast<T*>(a.cd),
      static_cast<T*>(a.x), a.nt, a.b, a.k, a.dbs, a.lbs, a.ubs);
  return (int)cudaGetLastError();
}

// ---- Route "group": one column of the working matrix per thread, in
// registers.

// The group route's widest group and the shared memory one block may use
// on this card. A thread holds one BM-long column: 96 registers of doubles
// at BM = 48, the widest template (ptxas: 233 registers, no spill).
constexpr int kMaxGroup = 256;
constexpr long long kSmemLimit = 232448;

// Threads of the group: one per column of [D - LC | U | R - L d].
__host__ __device__ constexpr int group_threads(int b, int k) {
  return 2 * b + k <= 128 ? 128 : kMaxGroup;
}

// The group route's shared memory (elements of T; every region a multiple
// of 4 elements, so each starts at a 16-byte boundary; the column-major
// regions at the odd stride S = BM + 1):
//   stage[2]  the staging buffers, each the step's [D | U | R] (2b + k
//             columns, column-major at stride S, rows >= b zero; the
//             correction writes D - L C and R - L d back in place) and the
//             side region (b rows of BM): L^T for the correction, then R^T;
//             after the forward sweep, the backward sweep's ring of
//             [C_t | d_t] (b + k columns at stride BM).
//   out       [C | d] of the step (b + k columns at stride S); in the
//             backward sweep, x_{t+1} (k columns).
//   slot[2]   the step's reflector: BM values and beta.
//   rinv      BM values: 1 / R[k][k].
using solve_aug_group::round4;
__host__ __device__ constexpr long long mg_cols_elems(int b, int k, int bm) {
  return round4((2LL * b + k) * (bm + 1));
}
__host__ __device__ constexpr long long mg_stage_elems(int b, int k, int bm) {
  return mg_cols_elems(b, k, bm) + round4((long long)b * bm);
}
__host__ __device__ constexpr long long mg_out_elems(int b, int k, int bm) {
  return round4(((long long)b + k) * (bm + 1));
}
__host__ __device__ constexpr long long mg_elems(int b, int k, int bm) {
  return 2 * mg_stage_elems(b, k, bm) + mg_out_elems(b, k, bm) +
         2 * solve_aug_group::group_slot_elems(bm) + round4(bm);
}

// Step t's [D | U | R] into a staging buffer's columns (thread j < b:
// column j of D; b + c: column c of U, zeros at the last step; 2b + c:
// column c of R) and L transposed into its side region (thread j < b:
// column j of L as row j), by cp.async; Lp == nullptr at t = 0. Rows b..
// stay as the zeroed tile left them.
template <typename T, int BM>
__device__ __forceinline__ void mg_stage(T* st, T* side, const T* Dt, const T* Lp, const T* Un,
                                         const T* Rt, int b, int k, int j) {
  using solve_aug_warp::cp_async;
  constexpr int S = BM + 1;
  T* cj = st + j * S;
  if (j < b) {
    for (int i = 0; i < b; ++i) cp_async(cj + i, Dt + i * b + j);
    if (Lp != nullptr)
      for (int i = 0; i < b; ++i) cp_async(side + j * BM + i, Lp + i * b + j);
  } else if (j < 2 * b) {
    if (Un != nullptr)
      for (int i = 0; i < b; ++i) cp_async(cj + i, Un + i * b + (j - b));
    else
      for (int i = 0; i < b; ++i) cj[i] = T(0);
  } else if (j < 2 * b + k) {
    for (int i = 0; i < b; ++i) cp_async(cj + i, Rt + i * k + (j - 2 * b));
  }
}

// D - L C and R - L d in place: thread j < b from column j of the previous
// [C | d] (the out tile), thread 2b + c from its column b + c; L^T's rows
// as broadcast vectors.
template <typename T, int BM>
__device__ __forceinline__ void mg_correct(T* st, const T* side, const T* out, int b, int k,
                                           int j) {
  constexpr int S = BM + 1;
  if ((j >= b && j < 2 * b) || j >= 2 * b + k) return;
  const T* cp = out + (j < b ? j : j - b) * S;
  T acc[BM];
#pragma unroll
  for (int i = 0; i < BM; ++i) acc[i] = T(0);
#pragma unroll 4
  for (int m = 0; m < b; ++m) solve_aug_warp::axpy_row<T, BM>(acc, side + m * BM, cp[m]);
  T* cj = st + j * S;
#pragma unroll
  for (int i = 0; i < BM; ++i)
    if (i < b) cj[i] = solve_aug::sub_rn(cj[i], acc[i]);
}

// [C_t | d_t] (column-major in the workspace: cd_t[c b + i]) into a ring
// slot (column c at slot + c BM), by cp.async: warp w on columns w, w + nw,
// ..., its lanes on the rows.
template <typename T, int BM>
__device__ __forceinline__ void mg_load_ring(T* slot, const T* cdt, int b, int k, int tid,
                                             int nthreads) {
  const int lane = tid & 31;
  for (int c = tid >> 5; c < b + k; c += nthreads >> 5)
    for (int i = lane; i < b; i += 32) solve_aug_warp::cp_async(slot + c * BM + i, cdt + c * b + i);
}

template <typename T, int BM>
__global__ void __launch_bounds__(kMaxGroup, 1) multi_group_kernel(
    const T* __restrict__ diag, const T* __restrict__ lower, const T* __restrict__ upper,
    const T* __restrict__ rhs, T* cd, T* __restrict__ x, int nt, int b, int k,
    long long diag_bstride, long long lower_bstride, long long upper_bstride) {
  using namespace solve_aug_group;
  using solve_aug_warp::cp_async_commit;
  using solve_aug_warp::cp_async_wait;
  constexpr int S = BM + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* base = reinterpret_cast<T*>(smem_raw);
  const int j = threadIdx.x;
  const int nthreads = blockDim.x;
  const solve_aug::BlockGroup g{j, nthreads};
  for (long long e = j; e < mg_elems(b, k, BM); e += nthreads) base[e] = T(0);
  GroupTile<T> W;
  W.stage = base;
  W.stage_elems = mg_stage_elems(b, k, BM);
  W.side_off = mg_cols_elems(b, k, BM);
  W.out = base + 2 * W.stage_elems;
  W.slot = W.out + mg_out_elems(b, k, BM);
  W.slot_elems = (int)group_slot_elems(BM);
  W.rinv = W.slot + 2 * W.slot_elems;
  __syncthreads();

  const int ldc = b + k;  // columns of [C | d]
  const long long bb = (long long)b * b, bk = (long long)b * k;
  const long long sys = blockIdx.x;
  const T* D_sys = diag + sys * diag_bstride;
  const T* L_sys = lower + sys * lower_bstride;
  const T* U_sys = upper + sys * upper_bstride;
  const T* R_sys = rhs + sys * nt * bk;
  T* cd_sys = cd + sys * nt * b * ldc;
  T* x_sys = x + sys * nt * bk;

  auto stage = [&](int t) {
    T* st = W.stage + (t & 1) * W.stage_elems;
    mg_stage<T, BM>(st, st + W.side_off, D_sys + t * bb, t > 0 ? L_sys + (t - 1) * bb : nullptr,
                    t < nt - 1 ? U_sys + t * bb : nullptr, R_sys + t * bk, b, k, j);
  };
  stage(0);
  cp_async_commit();

  T col[BM];
  for (int t = 0; t < nt; ++t) {
    cp_async_wait<0>();
    g.sync();  // step t staged; the previous [C | d] in the out tile
    if (t + 1 < nt) stage(t + 1);
    cp_async_commit();
    T* st = W.stage + (t & 1) * W.stage_elems;
    T* side = st + W.side_off;
    if (t > 0) mg_correct<T, BM>(st, side, W.out, b, k, j);
    load_col<false, T, BM>(col, st, b, ldc, j);
    group_solve<solve_aug::kQR, false, T, BM>(g, W, st, side, col, b, ldc, j,
                                              cd_sys + (long long)t * b * ldc);
  }
  g.sync();

  // Backward sweep x_t = d_t - C_t x_{t+1}, x_T = 0, on all k columns:
  // thread c < k on column c, x_{t+1} in the out tile (column c at stride
  // S); C_t and d_t through a ring of two slots in the staging buffers.
  T* xc = W.out + j * S;
  if (j < k)
    for (int i = 0; i < b; ++i) xc[i] = T(0);
  mg_load_ring<T, BM>(W.stage, cd_sys + (long long)(nt - 1) * b * ldc, b, k, j, nthreads);
  cp_async_commit();
  for (int s = 0; s < nt; ++s) {
    const int t = nt - 1 - s;
    cp_async_wait<0>();
    g.sync();  // slot s & 1 loaded; slot (s + 1) & 1 read last at step s - 1
    if (t > 0)
      mg_load_ring<T, BM>(W.stage + ((s + 1) & 1) * W.stage_elems,
                          cd_sys + (long long)(t - 1) * b * ldc, b, k, j, nthreads);
    cp_async_commit();
    if (j < k) {
      const T* sl = W.stage + (s & 1) * W.stage_elems;
      T acc[BM];
#pragma unroll
      for (int i = 0; i < BM; ++i) acc[i] = T(0);
#pragma unroll 4
      for (int m = 0; m < b; ++m) solve_aug_warp::axpy_row<T, BM>(acc, sl + m * BM, xc[m]);
      const T* dc = sl + (b + j) * BM;
#pragma unroll
      for (int i = 0; i < BM; ++i) {
        if (i < b) {
          const T v = dc[i] - acc[i];
          xc[i] = v;
          x_sys[((long long)t * b + i) * k + j] = v;
        }
      }
    }
  }
}

template <typename T, int BM>
int launch_group(const Args& a) {
  const long long smem = mg_elems(a.b, a.k, BM) * (long long)sizeof(T);
  if (a.b < 1 || a.b > BM || a.k < 1 || 2 * a.b + a.k > kMaxGroup || smem > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        multi_group_kernel<T, BM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  multi_group_kernel<T, BM><<<a.B, group_threads(a.b, a.k), (size_t)smem, a.stream>>>(
      static_cast<const T*>(a.diag), static_cast<const T*>(a.lower),
      static_cast<const T*>(a.upper), static_cast<const T*>(a.rhs), static_cast<T*>(a.cd),
      static_cast<T*>(a.x), a.nt, a.b, a.k, a.dbs, a.lbs, a.ubs);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a, int route, int bm) {
  if (route == 0) {
    if (bm != 0) return (int)cudaErrorInvalidValue;
    return launch_block<T>(a);
  }
  if (route != 1) return (int)cudaErrorInvalidValue;
  switch (bm) {
    case 8: return launch_group<T, 8>(a);
    case 16: return launch_group<T, 16>(a);
    case 24: return launch_group<T, 24>(a);
    case 32: return launch_group<T, 32>(a);
    case 40: return launch_group<T, 40>(a);
    case 48: return launch_group<T, 48>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = float64. Layouts (row-major): diag (B,T,b,b),
// lower/upper (B,T-1,b,b), each system contiguous, with batch strides of
// `*_bstride` elements (0 = one band shared by every system); rhs (B,T,b,k)
// contiguous; workspace cd (B,T,b(b+k)) in the route's own layout; x
// (B,T,b,k). The plan (thomas_multi.multi_plan): route 0 "block" (bm 0), 1
// "group" (rows templated to bm in {8, 16, 24, 32, 40, 48}, b <= bm, 2b + k
// <= 256 columns, the tiles within the card's shared memory per block); the
// dynamic shared memory and the group's threads are derived here from b, k
// and the dtype. A plan that disagrees with the kernels' own limits returns
// cudaErrorInvalidValue and launches nothing. Returns cudaGetLastError().
extern "C" int mcp_thomas_solve_multi(int dtype, const void* diag, const void* lower,
                                      const void* upper, const void* rhs, void* cd, void* x,
                                      int B, int nt, int b, int k, long long diag_bstride,
                                      long long lower_bstride, long long upper_bstride,
                                      int route, int bm, void* stream) {
  const Args a{diag, lower, upper, rhs, cd, x, B, nt, b, k, diag_bstride, lower_bstride,
               upper_bstride, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch<float>(a, route, bm);
  return dispatch<double>(a, route, bm);
}
