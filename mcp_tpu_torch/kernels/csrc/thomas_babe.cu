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
// eliminations, two or three barriers each. The two-way order halves the serial
// chain of K1's one-way sweep (T steps to ceil(T/2) + 1).
//
// Design (simple and correct first): one thread block of 256 threads per
// system; threads 0-127 run the left sweep and threads 128-255 the right
// sweep at the same time, each in its own shared-memory working set (K1's,
// solve_aug.cuh::Sweep) and synchronised by its own hardware barrier
// (bar.sync 1 and 2, 128 threads: solve_aug::NamedGroup); the junction solve
// runs on all 256 threads after one block barrier, in the left working set,
// and the two back substitutions again run side by side. The wrapper refuses
// what does not fit one block (gjpr at b=64 in float64, qr at b=64 in
// float64). [C_t | d_t] of every step goes to a global workspace
// (B, T, b, b+1) that the wrapper allocates, read back by the back
// substitution. Nothing crosses thread blocks.

#include <cuda_runtime.h>

#include "solve_aug.cuh"

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

template <typename T, int FAM>
int launch(const void* diag, const void* lower, const void* upper,
           const void* rhs, void* cd, void* x, int B, int nt, int b, int refine,
           long long lower_bstride, long long upper_bstride,
           cudaStream_t stream) {
  const size_t smem = 2 * sweep_bytes(b, FAM, refine, sizeof(T));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        babe_kernel<T, FAM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  babe_kernel<T, FAM><<<B, kThreads, smem, stream>>>(
      static_cast<const T*>(diag), static_cast<const T*>(lower),
      static_cast<const T*>(upper), static_cast<const T*>(rhs),
      static_cast<T*>(cd), static_cast<T*>(x), nt, b, refine, lower_bstride,
      upper_bstride);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int fam, int refine, const void* diag, const void* lower, const void* upper,
             const void* rhs, void* cd, void* x, int B, int nt, int b, long long lbs,
             long long ubs, cudaStream_t s) {
  switch (fam) {
    case kQR: return launch<T, kQR>(diag, lower, upper, rhs, cd, x, B, nt, b, 0, lbs, ubs, s);
    case kGJ: return launch<T, kGJ>(diag, lower, upper, rhs, cd, x, B, nt, b, 0, lbs, ubs, s);
    case kGJP:
      return launch<T, kGJP>(diag, lower, upper, rhs, cd, x, B, nt, b, refine, lbs, ubs, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = float64; fam: the fact's family (solve_aug.cuh:
// 0 qr, 1 gj, 2 gjp) and refine its refinement steps (1 for gjpr). Layouts
// (row-major, contiguous within a system): diag (B,T,b,b), lower/upper
// (B,T-1,b,b) with a batch stride of `*_bstride` elements (0 = one band
// shared by every system), rhs (B,T,b), workspace cd (B,T,b,b+1), x (B,T,b);
// T >= 2. Returns cudaGetLastError().
extern "C" int mcp_babe_solve(int dtype, int fam, int refine, const void* diag,
                              const void* lower, const void* upper, const void* rhs,
                              void* cd, void* x, int B, int nt, int b,
                              long long lower_bstride, long long upper_bstride,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(fam, refine, diag, lower, upper, rhs, cd, x, B, nt, b,
                           lower_bstride, upper_bstride, s);
  return dispatch<double>(fam, refine, diag, lower, upper, rhs, cd, x, B, nt, b,
                          lower_bstride, upper_bstride, s);
}
