// K1: batched block-tridiagonal solve by the one-way block-Thomas sweep, for
// sm_90a, with the in-block factorizations ("facts") of the JAX package's
// packed sweep: Householder QR without pivoting ("qr"), pivot-free
// Gauss-Jordan ("gj"), Gauss-Jordan with implicit partial pivoting ("gjp")
// and gjp plus one explicit-inverse refinement step ("gjpr"); the facts
// themselves are in solve_aug_warp.cuh (route "warp") and solve_aug.cuh
// (route "block").
//
// Replaces mcp_tpu/kernels/thomas_pallas.py::_thomas_kernel_lanes (:852,
// QR only) and ::_thomas_kernel_packed (:516, _solve_aug(fact)); its QR is
// the algebra of _qr_solve_aug (:33), including eps = 1e-30 inside the sqrt
// and in beta.
//
// Per system: for t = 0..T-1 solve (D_t - L_t C_{t-1}) [C_t | d_t] =
// [U_t | r_t - L_t d_{t-1}] by the fact, then back-substitute
// x_t = d_t - C_t x_{t+1}. A zero or non-finite QR pivot gives inf/NaN in x;
// a Gauss-Jordan pivot of magnitude <= 1e-30 is clamped to 1e-30. Nothing
// sanitizes x (the solver's linesearch flags it as a failed linear solve).
//
// Bound on this card: at the main path (B=256, T=10, b=20, float32, qr) the
// kernel must read diag + rhs (4.4 MB; lower/upper are shared by every
// system) and write x: ~1.4 us at 3.35 TB/s; its ~138 MFLOP take ~2.1 us at
// the 67 TFLOP/s float32 rate, so it is bound by operations (gjpr at the same
// shape: chip_smoke.thomas_counts). In practice neither binds: each step is
// a serial chain of b eliminations and a serial back substitution, so the
// latency of one elimination step sets the time.
//
// Two routes, chosen by the wrapper's plan (thomas.thomas_plan, a plain
// function of b, the fact and the dtype) and checked here against the
// kernels' own limits:
//
// "warp" (b <= 32, every fact, where the register budget holds): one warp
// per system, one warp per block (B = 256 systems give every one of the 132
// SMs work). The step's working matrix [D - LC | U | r (| I)] lives in
// registers, lane l holding columns l, l + 32, ... with all their rows
// (solve_aug_warp.cuh); the owner of column k computes the reflector or the
// pivot and multipliers and the warp takes them by __shfl_sync, so a step
// of the elimination costs no barrier. The next step's D, U, r and L come
// by cp.async into a second staging buffer while a step runs. [C_t | d_t]
// goes through the warp's shared-memory tile to the next step (lane j forms
// D - L C from column j of C) and, column-major, to the global workspace for
// the backward sweep, which runs one lane per row with x_{t+1} taken by
// __shfl_sync and its rows fetched four steps ahead by cp.async.
//
// "block" (every other shape: b > 32, the "padded" route at b = 50 and 60,
// and the float64 instances over the budget): one thread block per system;
// the working matrix lives in shared memory (with refinement, beside a copy
// of the original for the refinement step); column norms and pivot searches
// are warp-shuffle reductions; [C_t | d_t] of every step goes to the global
// workspace (B, T, b, b+1), read back by the backward sweep. The T-serial
// chain stays inside one block, so no inter-block synchronisation exists.
// The wrapper refuses what does not fit one block's shared memory (gjpr at
// b=64 in float64).

#include <cuda_runtime.h>

#include "solve_aug.cuh"
#include "solve_aug_warp.cuh"

namespace {

using namespace solve_aug;

constexpr int kThreads = 128;

template <typename T, int FAM>
__global__ void __launch_bounds__(kThreads) thomas_kernel(
    const T* __restrict__ diag, const T* __restrict__ lower,
    const T* __restrict__ upper, const T* __restrict__ rhs,
    T* __restrict__ cd, T* __restrict__ x, int nt, int b, int refine,
    long long lower_bstride, long long upper_bstride) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Sweep<T> W = carve_sweep<T>(smem_raw, b, FAM, refine);
  const BlockGroup g{(int)threadIdx.x, kThreads};
  const int tid = threadIdx.x;
  const int ldc = b + 1;  // columns of [C | d]
  const long long bb = (long long)b * b;
  const long long sys = blockIdx.x;
  const T* D_sys = diag + sys * nt * bb;
  const T* L_sys = lower + sys * lower_bstride;
  const T* U_sys = upper + sys * upper_bstride;
  const T* r_sys = rhs + sys * nt * b;
  T* cd_sys = cd + sys * nt * b * ldc;
  T* x_sys = x + sys * nt * b;

  for (int t = 0; t < nt; ++t)
    sweep_step<FAM>(g, W, b, refine, D_sys + t * bb, t > 0 ? L_sys + (t - 1) * bb : nullptr,
                    t < nt - 1 ? U_sys + t * bb : nullptr, r_sys + (long long)t * b,
                    cd_sys + (long long)t * b * ldc);

  // Backward sweep x_t = d_t - C_t x_{t+1}, x_T = 0.
  T* u = W.s.va;
  for (int i = tid; i < b; i += kThreads) u[i] = T(0);
  __syncthreads();
  for (int t = nt - 1; t >= 0; --t) {
    const T* cdt = cd_sys + (long long)t * b * ldc;
    T xi = T(0);
    if (tid < b) {
      T acc = cdt[tid * ldc + b];
      for (int j = 0; j < b; ++j) acc -= cdt[tid * ldc + j] * u[j];
      xi = acc;
    }
    __syncthreads();
    if (tid < b) {
      u[tid] = xi;
      x_sys[(long long)t * b + tid] = xi;
    }
    __syncthreads();
  }
}

// ---- Route "warp": one warp per system, the working matrix in registers.

// Row templates of the warp route and its register budget: the tile
// (groups x BM values) plus one BM vector (u or the multipliers), in 32-bit
// registers, at most kWarpRegs (thomas.WARP_REGS; the rest of the 255 a
// thread may hold is addresses, loop state and the step's scalars).
constexpr int kWarpRegs = 168;

__host__ __device__ constexpr int warp_regs(int bm, bool refine, int words) {
  return (solve_aug_warp::warp_groups(bm, refine) + 1) * bm * words;
}

template <typename T>
__host__ __device__ constexpr bool warp_fits(int bm, bool refine) {
  return warp_regs(bm, refine, (int)(sizeof(T) / 4)) <= kWarpRegs;
}

// Step t's [D | U | r] into a staging buffer (row-major, stride SW; U at
// column b, r at column 2b) and L_{t-1} transposed (L^T[k][i] at k BM + i,
// after the BM x SW block), by cp.async; a missing U (the last step) is
// written as zeros. Only the b x b entries are touched, so the padding
// stays as the zeroed tile left it.
template <typename T, int BM, int SW>
__device__ __forceinline__ void stage_step(T* st, const T* Dt, const T* Lp, const T* Un,
                                           const T* rt, int b, int lane) {
  using namespace solve_aug_warp;
  if (lane >= b) return;
  T* LT = st + BM * SW;
  for (int i = 0; i < b; ++i) {
    cp_async(st + i * SW + lane, Dt + i * b + lane);
    if (Un != nullptr)
      cp_async(st + i * SW + b + lane, Un + i * b + lane);
    else
      st[i * SW + b + lane] = T(0);
    if (Lp != nullptr) cp_async(LT + lane * BM + i, Lp + i * b + lane);
  }
  cp_async(st + lane * SW + 2 * b, rt + lane);
}

// Row `lane` of [C_t | d_t] from the warp route's column-major workspace
// into a ring slot (column-major, stride BM), by cp.async.
template <typename T, int BM>
__device__ __forceinline__ void load_cd_rows(T* slot, const T* cdt, int b, int lane) {
  if (lane >= b) return;
  for (int j = 0; j <= b; ++j) solve_aug_warp::cp_async(slot + j * BM + lane, cdt + j * b + lane);
}

template <typename T, int FAM, bool REFINE, int BM>
__global__ void __launch_bounds__(32) thomas_warp_kernel(
    const T* __restrict__ diag, const T* __restrict__ lower,
    const T* __restrict__ upper, const T* __restrict__ rhs,
    T* __restrict__ cd, T* __restrict__ x, int nt, int b,
    long long lower_bstride, long long upper_bstride) {
  using namespace solve_aug_warp;
  constexpr int NC = warp_groups(BM, REFINE);
  constexpr int SC = BM + 1;
  constexpr int SW = 32 * NC;  // row stride of the staged [D | U | r (| I)]
  constexpr int STG = stage_elems(BM, REFINE);  // one staging buffer
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const WarpTile<T> s = carve_warp<T>(reinterpret_cast<T*>(smem_raw), BM, FAM == kGJP, REFINE);
  const int lane = threadIdx.x;
  const int ld = warp_ld(b, REFINE);
  const int ldc = b + 1;  // columns of [C | d]
  const long long bb = (long long)b * b;
  const long long sys = blockIdx.x;
  const T* D_sys = diag + sys * nt * bb;
  const T* L_sys = lower + sys * lower_bstride;
  const T* U_sys = upper + sys * upper_bstride;
  const T* r_sys = rhs + sys * nt * b;
  T* cd_sys = cd + sys * nt * b * ldc;
  T* x_sys = x + sys * nt * b;

  // Zero the whole tile once: the regions stay zero outside the b x b
  // system (R's padding diagonal is 1; the identity columns of the staged
  // [D | U | r | I] are written here, the loads never touch them).
  T* base = reinterpret_cast<T*>(smem_raw);
  for (int e = lane; e < (int)warp_tile_elems(BM, FAM == kGJP, REFINE); e += 32) base[e] = T(0);
  __syncwarp();
  if (FAM == kQR)
    for (int i = b + lane; i < BM; i += 32) s.H[i * BM + i] = T(1);
  if (REFINE && lane < b) {
    s.stage[lane * SW + 2 * b + 1 + lane] = T(1);
    s.stage[STG + lane * SW + 2 * b + 1 + lane] = T(1);
  }
  stage_step<T, BM, SW>(s.stage, D_sys, nullptr, nt > 1 ? U_sys : nullptr, r_sys, b, lane);
  cp_async_commit();

  T col[NC][BM];
  for (int t = 0; t < nt; ++t) {
    cp_async_wait<0>();
    __syncwarp();
    const T* st = s.stage + (t & 1) * STG;
    // Step t + 1's loads into the other buffer, read last at step t - 1.
    if (t + 1 < nt)
      stage_step<T, BM, SW>(s.stage + ((t + 1) & 1) * STG, D_sys + (t + 1) * bb, L_sys + t * bb,
                            t + 2 < nt ? U_sys + (t + 1) * bb : nullptr,
                            r_sys + (long long)(t + 1) * b, b, lane);
    cp_async_commit();
    // Lane l's columns of [D | U | r (| I)], rows b.. zero.
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int i = 0; i < BM; ++i) col[c][i] = st[i * SW + 32 * c + lane];
    }
    if (t > 0) {
      // D - L C: lane j < b takes column j of C from the previous step's
      // [C | d] tile and L^T's rows as vectors. r - L d: lane i forms row i
      // of L d, and the owner of column 2b takes it by __shfl_sync.
      const T* LT = st + BM * SW;
      if (lane < b) {
        const T* cp = s.cd + lane * SC;
        T acc[BM];
#pragma unroll
        for (int i = 0; i < BM; ++i) acc[i] = T(0);
#pragma unroll 4
        for (int k = 0; k < b; ++k) axpy_row<T, BM>(acc, LT + k * BM, cp[k]);
#pragma unroll
        for (int i = 0; i < BM; ++i) col[0][i] -= acc[i];
      }
      const T* dp = s.cd + b * SC;
      T ldi = T(0);
#pragma unroll 4
      for (int k = 0; k < b; ++k) ldi += LT[k * BM + (lane < BM ? lane : 0)] * dp[k];
#pragma unroll
      for (int i = 0; i < BM; ++i) {
        const T v = __shfl_sync(kFull, ldi, i);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          if (32 * c + lane == 2 * b) col[c][i] -= v;
      }
    }
    if constexpr (REFINE) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int j = 32 * c + lane;
        if (j >= 2 * b + 1) continue;
#pragma unroll
        for (int i = 0; i < BM; ++i) s.orig[i * (2 * BM + 1) + j] = col[c][i];
      }
    }
    __syncwarp();
    if constexpr (FAM == kQR) {
      qr_eliminate<T, BM, NC>(s, col, b, ld, lane);
      qr_finish<T, BM>(s, b, lane);
    } else if constexpr (FAM == kGJ) {
      gj_eliminate<T, BM, NC>(col, b, ld, lane);
      gj_finish<T, BM, NC>(s, col, b, ld, lane);
    } else {
      gjp_eliminate<T, BM, NC>(col, b, ld, lane);
      gjp_finish<T, BM, NC, REFINE>(s, col, b, ld, lane);
    }
    __syncwarp();
    // [C_t | d_t] to the workspace, column-major: cd_t[c * b + i].
    T* cdt = cd_sys + (long long)t * b * ldc;
    if (lane < b)
      for (int c = 0; c < ldc; ++c) cdt[c * b + lane] = s.cd[c * SC + lane];
  }
  __syncwarp();

  // Backward sweep x_t = d_t - C_t x_{t+1}, x_T = 0: lane i forms row i,
  // x_{t+1} taken by __shfl_sync. Row i of [C_t | d_t] comes by cp.async
  // through a ring of four slots in the staging buffers (each lane reads
  // only what it copied), so four steps of loads are in flight.
  T* ring = s.stage;
  constexpr int RS = (BM + 1) * BM;  // a slot: [C | d] column-major, stride BM
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (nt - 1 - q >= 0)
      load_cd_rows<T, BM>(ring + q * RS, cd_sys + (long long)(nt - 1 - q) * b * ldc, b, lane);
    cp_async_commit();
  }
  T xn = T(0);
  for (int t = nt - 1, q = 0; t >= 0; --t, q = (q + 1) & 3) {
    cp_async_wait<3>();
    T* sl = ring + q * RS;
    T acc = T(0);
    if (lane < b) acc = sl[b * BM + lane];
#pragma unroll
    for (int j = 0; j < BM; ++j) {
      const T xj = __shfl_sync(kFull, xn, j);
      if (j < b && lane < b) acc -= sl[j * BM + lane] * xj;
    }
    xn = acc;
    if (lane < b) x_sys[(long long)t * b + lane] = acc;
    if (t - 4 >= 0) load_cd_rows<T, BM>(sl, cd_sys + (long long)(t - 4) * b * ldc, b, lane);
    cp_async_commit();
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
  const size_t smem = sweep_bytes(a.b, FAM, refine, sizeof(T));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        thomas_kernel<T, FAM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  thomas_kernel<T, FAM><<<a.B, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.diag), static_cast<const T*>(a.lower),
      static_cast<const T*>(a.upper), static_cast<const T*>(a.rhs),
      static_cast<T*>(a.cd), static_cast<T*>(a.x), a.nt, a.b, refine, a.lbs, a.ubs);
  return (int)cudaGetLastError();
}

template <typename T, int FAM, bool REFINE, int BM>
int launch_warp(const Args& a) {
  if constexpr (!warp_fits<T>(BM, REFINE)) {
    return (int)cudaErrorInvalidValue;  // no such instance: over the register budget
  } else {
    const size_t smem =
        sizeof(T) * (size_t)solve_aug_warp::warp_tile_elems(BM, FAM == kGJP, REFINE);
    if (a.b > BM || a.b < 1) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(thomas_warp_kernel<T, FAM, REFINE, BM>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    thomas_warp_kernel<T, FAM, REFINE, BM><<<a.B, 32, smem, a.stream>>>(
        static_cast<const T*>(a.diag), static_cast<const T*>(a.lower),
        static_cast<const T*>(a.upper), static_cast<const T*>(a.rhs),
        static_cast<T*>(a.cd), static_cast<T*>(a.x), a.nt, a.b, a.lbs, a.ubs);
    return (int)cudaGetLastError();
  }
}

template <typename T, int FAM, bool REFINE>
int dispatch_warp(const Args& a, int bm) {
  switch (bm) {
    case 8: return launch_warp<T, FAM, REFINE, 8>(a);
    case 16: return launch_warp<T, FAM, REFINE, 16>(a);
    case 24: return launch_warp<T, FAM, REFINE, 24>(a);
    case 32: return launch_warp<T, FAM, REFINE, 32>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch(int fam, int refine, const Args& a, int route, int bm) {
  if (route == 0) {
    switch (fam) {
      case kQR: return launch_block<T, kQR>(a, 0);
      case kGJ: return launch_block<T, kGJ>(a, 0);
      case kGJP: return launch_block<T, kGJP>(a, refine);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (route != 1 || refine > 1 || (refine && fam != kGJP)) return (int)cudaErrorInvalidValue;
  switch (fam) {
    case kQR: return dispatch_warp<T, kQR, false>(a, bm);
    case kGJ: return dispatch_warp<T, kGJ, false>(a, bm);
    case kGJP:
      return refine ? dispatch_warp<T, kGJP, true>(a, bm)
                    : dispatch_warp<T, kGJP, false>(a, bm);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = float64; fam: the fact's family (solve_aug.cuh:
// 0 qr, 1 gj, 2 gjp) and refine its refinement steps (1 for gjpr). Layouts
// (row-major, contiguous within a system): diag (B,T,b,b), lower/upper
// (B,T-1,b,b) with a batch stride of `*_bstride` elements (0 = one band
// shared by every system), rhs (B,T,b), workspace cd (B,T,b(b+1)) in the
// route's own layout, x (B,T,b). The plan (thomas.thomas_plan): route 0
// "block" (128 threads per system), 1 "warp" (one warp per system, rows
// templated to bm in {8, 16, 24, 32}, b <= bm); the dynamic shared memory
// of either route is derived here from b, the fact and the dtype. A plan
// that disagrees with the kernels' own limits returns cudaErrorInvalidValue
// and launches nothing.
// Returns cudaGetLastError().
extern "C" int mcp_thomas_solve(int dtype, int fam, int refine, const void* diag,
                                const void* lower, const void* upper, const void* rhs,
                                void* cd, void* x, int B, int nt, int b,
                                long long lower_bstride, long long upper_bstride, int route,
                                int bm, void* stream) {
  const Args a{diag, lower, upper, rhs, cd, x, B, nt, b, lower_bstride, upper_bstride,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch<float>(fam, refine, a, route, bm);
  return dispatch<double>(fam, refine, a, route, bm);
}
