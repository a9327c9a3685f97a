// K1: batched block-tridiagonal solve by the one-way block-Thomas sweep, for
// sm_90a, with the in-block factorizations ("facts") of the JAX package's
// packed sweep: Householder QR without pivoting ("qr"), pivot-free
// Gauss-Jordan ("gj"), Gauss-Jordan with implicit partial pivoting ("gjp")
// and gjp plus one explicit-inverse refinement step ("gjpr"); the facts
// themselves are in solve_aug.cuh.
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
// a serial chain of b eliminations, two or three block-wide barriers each,
// and a serial back substitution.
//
// Design (simple and correct first): one thread block per system; the step's
// working matrix [D - LC | U | r (| I)] lives in shared memory (with
// refinement, beside a copy of the original for the refinement step);
// column norms and pivot searches are warp-shuffle reductions; [C_t | d_t]
// of every step goes to a global workspace (B, T, b, b+1) that the wrapper
// allocates (L2-resident at the main path), read back by the backward sweep.
// The T-serial chain stays inside one block, so no inter-block
// synchronisation exists. The wrapper refuses what does not fit one block's
// shared memory (gjpr at b=64 in float64).

#include <cuda_runtime.h>

#include "solve_aug.cuh"

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

template <typename T, int FAM>
int launch(const void* diag, const void* lower, const void* upper,
           const void* rhs, void* cd, void* x, int B, int nt, int b, int refine,
           long long lower_bstride, long long upper_bstride,
           cudaStream_t stream) {
  const size_t smem = sweep_bytes(b, FAM, refine, sizeof(T));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        thomas_kernel<T, FAM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  thomas_kernel<T, FAM><<<B, kThreads, smem, stream>>>(
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
// shared by every system), rhs (B,T,b), workspace cd (B,T,b,b+1), x (B,T,b).
// Returns cudaGetLastError().
extern "C" int mcp_thomas_solve(int dtype, int fam, int refine, const void* diag,
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
