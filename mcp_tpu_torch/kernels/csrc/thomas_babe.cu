// K7a: batched block-tridiagonal solve by the two-way ("burn at both ends")
// block-Thomas sweep, for sm_90a, with the facts of K1 (csrc/thomas.cu):
// "qr", "gj", "gjp" and "gjpr" (solve_aug.cuh), in both chains and in the
// junction.
//
// Replaces mcp_tpu/kernels/thomas_pallas.py::_thomas_kernel_babe (:737) with
// its dispatch _pallas_block_thomas_babe (:1223); every in-block solve is
// _solve_aug(fact) (:431), as at :779 and :798.
//
// Per system, ml = ceil(T/2):
//   left  sweep, t = 0..ml-1:  (D_t - L_{t-1} C_{t-1}) [C_t | d_t]
//                                = [U_t | r_t - L_{t-1} d_{t-1}]
//   right sweep, t = T-1..ml:  (D_t - U_t E_{t+1}) [E_t | e_t]
//                                = [L_{t-1} | r_t - U_t e_{t+1}]
//   junction: (I - C_{ml-1} E_{ml}) x_{ml-1} = d_{ml-1} - C_{ml-1} e_{ml},
//             x_{ml} = e_{ml} - E_{ml} x_{ml-1}
//   back substitution: x_t = d_t - C_t x_{t+1} (t < ml-1),
//                      x_t = e_t - E_t x_{t-1} (t > ml).
// (lower[t] couples block t+1 to block t, upper[t] block t to t+1.) The JAX
// package time-reverses the right half into a copy, with one identity pad
// block for odd T; here the right direction indexes the bands in reverse and
// starts at t = T-1 (the pad [I | 0 | 0 | 0] solves to [C | d] = 0 exactly
// under every fact and changes nothing). A zero or non-finite QR pivot gives
// inf/NaN in x; a Gauss-Jordan pivot is clamped to 1e-30; nothing sanitizes x.
//
// Bound on this card: at the training step's shape (B=8, T=30, b=40,
// float32, per-lane bands) the kernel must read diag, lower, upper and rhs
// and write x, 4.6 MB: 1.4 us at 3.35 TB/s; its 0.10 GFLOP take 1.5 us at the
// 67 TFLOP/s float32 rate, so it is bound by operations (chip_smoke.py,
// babe_counts). In practice neither binds: each step is a serial chain of b
// eliminations, and the two-way order only halves the serial chain of K1's
// one-way sweep (T steps to ceil(T/2) + 1); B=8 systems busy 8 of the 132
// SMs. So the latency of one elimination step sets the time.
//
// One thread block of 256 threads per system on both routes: threads 0-127
// run the left sweep and threads 128-255 the right sweep at the same time,
// each group with its own shared memory and its own hardware barrier
// (bar.sync 1 and 2, 128 threads: solve_aug::NamedGroup); the junction solve
// follows one block barrier, and the two back substitutions again run side
// by side. [C_t | d_t] of every step goes to a global workspace (B, T, b,
// b+1) that the wrapper allocates, in the route's own layout, read back by
// the back substitution. Nothing crosses thread blocks. The wrapper's plan
// (thomas_babe.babe_plan, a plain function of b, the fact and the dtype)
// picks the route, and the C entry checks it against the kernels' limits:
//
// "group" (b <= 48, the working matrix [D - LC | U | r (| I)] at most 128
// columns wide: every b the tier routes here, 3b + 1 <= 128; where both
// directions' tiles fit the block's shared memory): thread j of a
// group owns column j of the step's working matrix with all of its rows in
// registers, rows unrolled to BM in {8, 16, 24, 32, 40, 48}
// (solve_aug_group.cuh). The owner of column k forms step k (the reflector,
// or the pivot, 1/pivot and the multipliers) from its own registers into a
// double-buffered shared slot; one named barrier per step; every thread
// updates its own column, and the owner of column k + 1 forms step k + 1 as
// soon as its own column is updated. D, U, r and L of step t + 1 arrive by
// cp.async into a second staging buffer while step t runs; the step's
// [C | d] stays in shared memory for the next step's D - L C (thread j forms
// its own column) and goes to the workspace column-major. The junction solve
// runs on the left group's layout. Each back substitution runs on one warp,
// lane l on rows l and l + 32, x of the previous step taken by __shfl_sync
// (no barrier) and the rows of [C_t | d_t] fetched four steps ahead by
// cp.async into the group's staging buffers.
//
// "block" (every other shape; the A/B of the group route): each direction's
// working set is K1's (solve_aug.cuh::Sweep) in shared memory, every in-block
// solve solve_aug.cuh's block-route fact on 128 threads; the junction solve
// runs on all 256 threads in the left working set. The wrapper refuses what
// does not fit one block (gjpr at b=64 in float64, qr at b=64 in float64).

#include <cuda_runtime.h>

#include "solve_aug.cuh"
#include "solve_aug_group.cuh"
#include "solve_aug_warp.cuh"

namespace {

using namespace solve_aug;

constexpr int kGroup = 128;           // threads per direction
constexpr int kThreads = 2 * kGroup;  // one block: both directions

template <typename T, int FAM>
__global__ void __launch_bounds__(kThreads) babe_kernel(
    const T* __restrict__ diag, const T* __restrict__ lower,
    const T* __restrict__ upper, const T* __restrict__ rhs, T* cd,
    T* __restrict__ x, int nt, int b, int refine, long long lower_bstride,
    long long upper_bstride) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int dir = tid / kGroup;  // 0: left sweep, 1: right sweep
  const int g = tid - dir * kGroup;
  const NamedGroup grp{g, kGroup, 1 + dir};
  const BlockGroup block{tid, kThreads};
  const Sweep<T> left = carve_sweep<T>(smem_raw, b, FAM, refine);
  const Sweep<T> right =
      carve_sweep<T>(smem_raw + sweep_bytes(b, FAM, refine, sizeof(T)), b, FAM, refine);
  const Sweep<T>& W = dir == 0 ? left : right;

  const int ldc = b + 1;
  const long long bb = (long long)b * b;
  const long long sys = blockIdx.x;
  const T* D_sys = diag + sys * nt * bb;
  const T* L_sys = lower + sys * lower_bstride;
  const T* U_sys = upper + sys * upper_bstride;
  const T* r_sys = rhs + sys * nt * b;
  T* cd_sys = cd + sys * nt * b * ldc;
  T* x_sys = x + sys * nt * b;
  const int ml = (nt + 1) / 2;

  // Both sweeps at once, each under its own barrier.
  if (dir == 0) {
    for (int t = 0; t < ml; ++t)
      sweep_step<FAM>(grp, W, b, refine, D_sys + t * bb, t > 0 ? L_sys + (t - 1) * bb : nullptr,
                      U_sys + t * bb, r_sys + (long long)t * b,
                      cd_sys + (long long)t * b * ldc);
  } else {
    for (int t = nt - 1; t >= ml; --t)
      sweep_step<FAM>(grp, W, b, refine, D_sys + t * bb,
                      t < nt - 1 ? U_sys + t * bb : nullptr, L_sys + (t - 1) * bb,
                      r_sys + (long long)t * b, cd_sys + (long long)t * b * ldc);
  }
  block.sync();

  // Junction, on the whole block in the left working set: Mj = [I - C E |
  // d - C e (| I)] (b x nj), its original in the left M0 with refinement.
  const int nj = aug_ld(b, 1, refine);
  T* Mj = left.s.M;
  for (int e = tid; e < b * nj; e += kThreads) {
    const int i = e / nj, j = e - (e / nj) * nj;
    if (j > b) {
      Mj[i * nj + j] = j - b - 1 == i ? T(1) : T(0);
      continue;
    }
    T acc = T(0);
    for (int k = 0; k < b; ++k) acc += left.Cd[i * ldc + k] * right.Cd[k * ldc + j];
    const T head = j < b ? (i == j ? T(1) : T(0)) : left.Cd[i * ldc + b];
    Mj[i * nj + j] = head - acc;
    if (refine) left.M0[i * (b + 1) + j] = head - acc;
  }
  block.sync();
  solve_loaded<FAM>(block, left.s, b, 1, refine, SmemMat<T>{left.M0, b + 1});
  if (tid < b) {
    const T xl = Mj[tid * nj + b];
    T acc = right.Cd[tid * ldc + b];
    for (int k = 0; k < b; ++k) acc -= right.Cd[tid * ldc + k] * Mj[k * nj + b];
    left.s.va[tid] = xl;
    right.s.va[tid] = acc;
    x_sys[(long long)(ml - 1) * b + tid] = xl;
    x_sys[(long long)ml * b + tid] = acc;
  }
  block.sync();

  // Both back substitutions at once: left x_t = d_t - C_t x_{t+1} for
  // t = ml-2..0, right x_t = e_t - E_t x_{t-1} for t = ml+1..T-1.
  T* u = W.s.va;
  const int steps = dir == 0 ? ml - 1 : nt - ml - 1;
  for (int s = 0; s < steps; ++s) {
    const int t = dir == 0 ? ml - 2 - s : ml + 1 + s;
    const T* cdt = cd_sys + (long long)t * b * ldc;
    T xi = T(0);
    if (g < b) {
      T acc = cdt[g * ldc + b];
      for (int j = 0; j < b; ++j) acc -= cdt[g * ldc + j] * u[j];
      xi = acc;
    }
    grp.sync();
    if (g < b) {
      u[g] = xi;
      x_sys[(long long)t * b + g] = xi;
    }
    grp.sync();
  }
}

// ---- Route "group": one 128-thread group per direction, one column of the
// working matrix per thread, in registers.

// The group route's register budget: one BM-long column per thread, in
// 32-bit registers (thomas_babe.GROUP_REGS; the rest of the 255 a thread may
// hold is addresses, loop state and the step's scalars), and the shared
// memory one block may use on this card.
constexpr int kGroupRegs = 96;
constexpr long long kSmemLimit = 232448;

// An instance of the group route exists where some b it serves (b from the
// previous row template + 1 up to BM) fits: its column within the register
// budget, its working matrix within kGroup columns and both directions'
// tiles within the shared memory (the smallest such b needs the least).
// float64 gjpr at BM = 48 fits nowhere (b = 41 already needs 263,616 bytes).
template <typename T, bool REFINE>
__host__ __device__ constexpr bool group_instance(int bm) {
  const int b = bm <= 8 ? 1 : bm - 7;
  return bm * (int)(sizeof(T) / 4) <= kGroupRegs &&
         solve_aug_group::group_ld(b, b + 1, REFINE) <= kGroup &&
         2 * solve_aug_group::group_dir_elems(b, bm, REFINE) * (long long)sizeof(T) <=
             kSmemLimit;
}

// Step t's [D | U | r] into a staging buffer's columns (column-major at
// stride BM + 1: thread j < b takes column j of D, thread b + c column c of
// U, thread 2b r) and L transposed into its side region (thread j < b:
// column j of L as row j, L^T[j][i] at side[j BM + i]), by cp.async; Lp ==
// nullptr at a chain's start. Rows b.. stay as the zeroed tile left them.
template <typename T, int BM>
__device__ __forceinline__ void stage_step(T* st, T* side, const T* Dt, const T* Lp,
                                           const T* Un, const T* rt, int b, int j) {
  using solve_aug_warp::cp_async;
  constexpr int S = BM + 1;
  T* cj = st + j * S;
  if (j < b) {
    for (int i = 0; i < b; ++i) cp_async(cj + i, Dt + i * b + j);
    if (Lp != nullptr)
      for (int i = 0; i < b; ++i) cp_async(side + j * BM + i, Lp + i * b + j);
  } else if (j < 2 * b) {
    for (int i = 0; i < b; ++i) cp_async(cj + i, Un + i * b + (j - b));
  } else if (j == 2 * b) {
    for (int i = 0; i < b; ++i) cp_async(cj + i, rt + i);
  }
}

// D - L C and r - L d in place in the staging buffer: thread j < b forms
// its own column from column j of the previous [C | d] (the out tile) and
// L^T's rows as broadcast vectors, thread 2b from d.
template <typename T, int BM>
__device__ __forceinline__ void correct_step(T* st, const T* side, const T* out, int b, int j) {
  constexpr int S = BM + 1;
  if (j >= b && j != 2 * b) return;
  const T* cp = out + (j < b ? j : b) * S;
  T acc[BM];
#pragma unroll
  for (int i = 0; i < BM; ++i) acc[i] = T(0);
#pragma unroll 4
  for (int k = 0; k < b; ++k) solve_aug_warp::axpy_row<T, BM>(acc, side + k * BM, cp[k]);
  T* cj = st + j * S;
#pragma unroll
  for (int i = 0; i < BM; ++i)
    if (i < b) cj[i] = solve_aug::sub_rn(cj[i], acc[i]);
}

// The junction's [I - C E | d - C e] into the left group's staging columns:
// thread j < b column j, thread b the right-hand side; C, d from the left
// out tile, E, e from the right one (all column-major at stride BM + 1).
template <typename T, int BM>
__device__ __forceinline__ void junction_form(T* st, const T* outL, const T* outR, int b,
                                              int j) {
  constexpr int S = BM + 1;
  if (j > b) return;
  const T* ej = outR + j * S;
  T acc[BM];
#pragma unroll
  for (int i = 0; i < BM; ++i) acc[i] = T(0);
#pragma unroll 2
  for (int k = 0; k < b; ++k) {
    const T ek = ej[k];
    const T* ck = outL + k * S;
#pragma unroll
    for (int i = 0; i < BM; ++i) acc[i] += ck[i] * ek;
  }
  T* cj = st + j * S;
#pragma unroll
  for (int i = 0; i < BM; ++i) {
    if (i < b) {
      const T head = j < b ? (i == j ? T(1) : T(0)) : outL[b * S + i];
      cj[i] = solve_aug::sub_rn(head, acc[i]);
    }
  }
}

// Rows `lane` and `lane + 32` of [C_t | d_t] (column-major in the
// workspace: cd_t[c b + i]) into a ring slot (column-major at stride BM),
// by cp.async.
template <typename T, int BM>
__device__ __forceinline__ void load_cd_rows(T* slot, const T* cdt, int b, int lane) {
#pragma unroll
  for (int h = 0; h < (BM > 32 ? 2 : 1); ++h) {
    const int r = lane + 32 * h;
    if (r < b)
      for (int c = 0; c <= b; ++c) solve_aug_warp::cp_async(slot + c * BM + r, cdt + c * b + r);
  }
}

// One chain of the back substitution on one warp: x_t = d_t - C_t x_prev
// for `steps` steps t = t0, t0 + dt, ..., from x_prev = x0 (shared memory,
// b values). Lane l on rows l and l + 32; x_prev by __shfl_sync; the rows
// come through a ring of four slots (each lane reads only what it copied).
template <typename T, int BM>
__device__ __forceinline__ void back_substitute(T* ring, const T* x0, const T* cd_sys, T* x_sys,
                                                int b, int steps, int t0, int dt, int lane) {
  using namespace solve_aug_warp;
  constexpr bool TWO = BM > 32;
  const long long ldc = b + 1;
  const int rs = (int)solve_aug_group::round4((b + 1LL) * BM);  // one slot
  T xa = lane < b ? x0[lane] : T(0);
  T xb = TWO && lane + 32 < b ? x0[lane + 32] : T(0);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (q < steps)
      load_cd_rows<T, BM>(ring + q * rs, cd_sys + (long long)(t0 + q * dt) * b * ldc, b, lane);
    cp_async_commit();
  }
  for (int s = 0, q = 0; s < steps; ++s, q = (q + 1) & 3) {
    cp_async_wait<3>();
    const T* sl = ring + q * rs;
    const int t = t0 + s * dt;
    T acc_a = sl[b * BM + lane];
    T acc_b = TWO ? sl[b * BM + lane + 32] : T(0);
#pragma unroll
    for (int jj = 0; jj < BM; ++jj) {
      if (jj >= b) continue;
      const T xj = __shfl_sync(kFull, jj < 32 ? xa : xb, jj & 31);
      acc_a -= sl[jj * BM + lane] * xj;
      if (TWO) acc_b -= sl[jj * BM + lane + 32] * xj;
    }
    xa = acc_a;
    xb = acc_b;
    if (lane < b) x_sys[(long long)t * b + lane] = acc_a;
    if (TWO && lane + 32 < b) x_sys[(long long)t * b + lane + 32] = acc_b;
    if (s + 4 < steps)
      load_cd_rows<T, BM>(ring + q * rs, cd_sys + (long long)(t + 4 * dt) * b * ldc, b, lane);
    cp_async_commit();
  }
}

template <typename T, int FAM, bool REFINE, int BM>
__global__ void __launch_bounds__(kThreads, 1) babe_group_kernel(
    const T* __restrict__ diag, const T* __restrict__ lower, const T* __restrict__ upper,
    const T* __restrict__ rhs, T* cd, T* __restrict__ x, int nt, int b,
    long long lower_bstride, long long upper_bstride) {
  using namespace solve_aug_group;
  using solve_aug_warp::cp_async_commit;
  using solve_aug_warp::cp_async_wait;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* base = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x;
  const int dir = tid / kGroup;  // 0: left sweep, 1: right sweep
  const int j = tid - dir * kGroup;
  const NamedGroup grp{j, kGroup, 1 + dir};
  const long long dir_elems = group_dir_elems(b, BM, REFINE);
  for (long long e = tid; e < 2 * dir_elems; e += kThreads) base[e] = T(0);
  __syncthreads();
  const GroupTile<T> left = carve_group<T>(base, b, BM, REFINE);
  const GroupTile<T> right = carve_group<T>(base + dir_elems, b, BM, REFINE);
  const GroupTile<T> W = dir == 0 ? left : right;

  const int ldc = b + 1;
  const long long bb = (long long)b * b;
  const long long sys = blockIdx.x;
  const T* D_sys = diag + sys * nt * bb;
  const T* L_sys = lower + sys * lower_bstride;
  const T* U_sys = upper + sys * upper_bstride;
  const T* r_sys = rhs + sys * nt * b;
  T* cd_sys = cd + sys * nt * b * ldc;
  T* x_sys = x + sys * nt * b;
  const int ml = (nt + 1) / 2;
  const int nsteps = dir == 0 ? ml : nt - ml;

  // Step s of this direction: time t, its "previous" coupling (L_{t-1} on
  // the left, U_t on the right; none at the chain's start) and its "next"
  // one (U_t on the left, L_{t-1} on the right).
  auto stage = [&](int s) {
    const int t = dir == 0 ? s : nt - 1 - s;
    const T* Lp = s == 0 ? nullptr : (dir == 0 ? L_sys + (t - 1) * bb : U_sys + t * bb);
    const T* Un = dir == 0 ? U_sys + t * bb : L_sys + (t - 1) * bb;
    T* st = W.stage + (s & 1) * W.stage_elems;
    stage_step<T, BM>(st, st + W.side_off, D_sys + t * bb, Lp, Un, r_sys + (long long)t * b, b,
                      j);
  };
  stage(0);
  cp_async_commit();

  T col[BM];
  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<0>();
    grp.sync();  // step s staged; the previous [C | d] in the out tile
    if (s + 1 < nsteps) stage(s + 1);
    cp_async_commit();
    const int t = dir == 0 ? s : nt - 1 - s;
    T* st = W.stage + (s & 1) * W.stage_elems;
    T* side = st + W.side_off;
    if (s > 0) correct_step<T, BM>(st, side, W.out, b, j);
    load_col<REFINE, T, BM>(col, st, b, b + 1, j);
    group_solve<FAM, REFINE, T, BM>(grp, W, st, side, col, b, b + 1, j,
                                    cd_sys + (long long)t * b * ldc);
  }
  __syncthreads();

  // Junction, on the left group's layout (staging buffer 0 and its side
  // region, the left out tile): x_{ml-1} into the left out tile's column 0
  // and x.
  if (dir == 0) {
    T* st = left.stage;
    junction_form<T, BM>(st, left.out, right.out, b, j);
    load_col<REFINE, T, BM>(col, st, b, 1, j);
    group_solve<FAM, REFINE, T, BM>(grp, left, st, st + left.side_off, col, b, 1, j,
                                    x_sys + (long long)(ml - 1) * b);
  }
  __syncthreads();

  // Both back substitutions at once, one warp each: left x_t = d_t - C_t
  // x_{t+1} for t = ml-2..0, right x_t = e_t - E_t x_{t-1} for t = ml..T-1
  // (x_ml = e_ml - E_ml x_{ml-1} first).
  if (j < 32) {
    if (dir == 0)
      back_substitute<T, BM>(W.stage, left.out, cd_sys, x_sys, b, ml - 1, ml - 2, -1, j);
    else
      back_substitute<T, BM>(W.stage, left.out, cd_sys, x_sys, b, nt - ml, ml, 1, j);
  }
}

struct Args {
  const void *diag, *lower, *upper, *rhs;
  void *cd, *x;
  int B, nt, b;
  long long lbs, ubs;
  cudaStream_t stream;
};

template <typename T, int FAM>
int launch_block(const Args& a, int refine) {
  const size_t smem = 2 * sweep_bytes(a.b, FAM, refine, sizeof(T));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        babe_kernel<T, FAM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  babe_kernel<T, FAM><<<a.B, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.diag), static_cast<const T*>(a.lower),
      static_cast<const T*>(a.upper), static_cast<const T*>(a.rhs), static_cast<T*>(a.cd),
      static_cast<T*>(a.x), a.nt, a.b, refine, a.lbs, a.ubs);
  return (int)cudaGetLastError();
}

template <typename T, int FAM, bool REFINE, int BM>
int launch_group(const Args& a) {
  if constexpr (!group_instance<T, REFINE>(BM)) {
    return (int)cudaErrorInvalidValue;  // no such instance: fits no b it serves
  } else {
    using solve_aug_group::group_dir_elems;
    using solve_aug_group::group_ld;
    const long long smem = 2 * group_dir_elems(a.b, BM, REFINE) * (long long)sizeof(T);
    if (a.b < 1 || a.b > BM || group_ld(a.b, a.b + 1, REFINE) > kGroup || smem > kSmemLimit)
      return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(babe_group_kernel<T, FAM, REFINE, BM>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    babe_group_kernel<T, FAM, REFINE, BM><<<a.B, kThreads, (size_t)smem, a.stream>>>(
        static_cast<const T*>(a.diag), static_cast<const T*>(a.lower),
        static_cast<const T*>(a.upper), static_cast<const T*>(a.rhs), static_cast<T*>(a.cd),
        static_cast<T*>(a.x), a.nt, a.b, a.lbs, a.ubs);
    return (int)cudaGetLastError();
  }
}

template <typename T, int FAM, bool REFINE>
int dispatch_group(const Args& a, int bm) {
  switch (bm) {
    case 8: return launch_group<T, FAM, REFINE, 8>(a);
    case 16: return launch_group<T, FAM, REFINE, 16>(a);
    case 24: return launch_group<T, FAM, REFINE, 24>(a);
    case 32: return launch_group<T, FAM, REFINE, 32>(a);
    case 40: return launch_group<T, FAM, REFINE, 40>(a);
    case 48: return launch_group<T, FAM, REFINE, 48>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The instances of one part (see MCP_PART below): the pivoted family (gjp,
// gjpr) or the others (qr, gj) in one dtype.
template <typename T, bool PIVOTED>
int dispatch(int fam, int refine, const Args& a, int route, int bm) {
  if constexpr (PIVOTED) {
    if (route == 0) return launch_block<T, kGJP>(a, refine);
    if (route != 1 || refine > 1) return (int)cudaErrorInvalidValue;
    return refine ? dispatch_group<T, kGJP, true>(a, bm)
                  : dispatch_group<T, kGJP, false>(a, bm);
  } else {
    if (route == 0) {
      switch (fam) {
        case kQR: return launch_block<T, kQR>(a, 0);
        case kGJ: return launch_block<T, kGJ>(a, 0);
        default: return (int)cudaErrorInvalidValue;
      }
    }
    if (route != 1 || refine != 0) return (int)cudaErrorInvalidValue;
    switch (fam) {
      case kQR: return dispatch_group<T, kQR, false>(a, bm);
      case kGJ: return dispatch_group<T, kGJ, false>(a, bm);
      default: return (int)cudaErrorInvalidValue;
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = float64; fam: the fact's family (solve_aug.cuh:
// 0 qr, 1 gj, 2 gjp) and refine its refinement steps (1 for gjpr). Layouts
// (row-major, contiguous within a system): diag (B,T,b,b), lower/upper
// (B,T-1,b,b) with a batch stride of `*_bstride` elements (0 = one band
// shared by every system), rhs (B,T,b), workspace cd (B,T,b(b+1)) in the
// route's own layout, x (B,T,b); T >= 2. The plan (thomas_babe.babe_plan):
// route 0 "block", 1 "group" (rows templated to bm in {8, 16, 24, 32, 40,
// 48}, b <= bm, the working matrix at most 128 columns, both directions'
// tiles within the card's shared memory per block); the dynamic shared
// memory of either route is derived here from b, the fact and the dtype. A
// plan that disagrees with the kernels' own limits returns
// cudaErrorInvalidValue and launches nothing. Returns cudaGetLastError().
//
// The build compiles this file as four translation units, once with
// each -DMCP_PART=k, and links them into one library (kernels/_build.py,
// PARTS): part 2 * dtype + (fam == gjp) holds that dtype's pivoted or other
// instances, part 0 also the entry point. Without MCP_PART one unit holds
// everything.
#define MCP_BABE_PART_PARAMS                                                            \
  int fam, int refine, const void *diag, const void *lower, const void *upper,          \
      const void *rhs, void *cd, void *x, int B, int nt, int b, long long lower_bstride, \
      long long upper_bstride, int route, int bm, void *stream
#define MCP_BABE_PART(k, T, PIVOTED)                                                     \
  extern "C" int mcp_babe_part##k(MCP_BABE_PART_PARAMS) {                                \
    const Args a{diag, lower, upper, rhs, cd, x, B, nt, b, lower_bstride, upper_bstride, \
                 static_cast<cudaStream_t>(stream)};                                     \
    return dispatch<T, PIVOTED>(fam, refine, a, route, bm);                              \
  }

extern "C" {
int mcp_babe_part0(MCP_BABE_PART_PARAMS);
int mcp_babe_part1(MCP_BABE_PART_PARAMS);
int mcp_babe_part2(MCP_BABE_PART_PARAMS);
int mcp_babe_part3(MCP_BABE_PART_PARAMS);
}

#if !defined(MCP_PART) || MCP_PART == 0
MCP_BABE_PART(0, float, false)
#endif
#if !defined(MCP_PART) || MCP_PART == 1
MCP_BABE_PART(1, float, true)
#endif
#if !defined(MCP_PART) || MCP_PART == 2
MCP_BABE_PART(2, double, false)
#endif
#if !defined(MCP_PART) || MCP_PART == 3
MCP_BABE_PART(3, double, true)
#endif

#if !defined(MCP_PART) || MCP_PART == 0
extern "C" int mcp_babe_solve(int dtype, int fam, int refine, const void* diag,
                              const void* lower, const void* upper, const void* rhs,
                              void* cd, void* x, int B, int nt, int b,
                              long long lower_bstride, long long upper_bstride, int route,
                              int bm, void* stream) {
  auto part = dtype == 0 ? (fam == solve_aug::kGJP ? mcp_babe_part1 : mcp_babe_part0)
                         : (fam == solve_aug::kGJP ? mcp_babe_part3 : mcp_babe_part2);
  return part(fam, refine, diag, lower, upper, rhs, cd, x, B, nt, b, lower_bstride,
              upper_bstride, route, bm, stream);
}
#endif
