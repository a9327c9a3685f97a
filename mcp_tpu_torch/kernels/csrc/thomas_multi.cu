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
// serial chain of b reflections with three block barriers each.
//
// Design (simple and correct first): K1's (thomas.cu), with its own
// __global__ so K1 is untouched. One thread block per system; the step's
// working matrix [D - LC | U | R - L d] (b x (2b+k)) in shared memory beside
// L and the previous [C | d] (b x (b+k)); [C_t | d_t] of every step goes to a
// global workspace (B, T, b, b+k) that the wrapper allocates and the
// backward sweep reads back. diag, lower and upper take any batch stride (0
// for a band shared by every system, T*b*b for a slab view of a longer
// band); each system's blocks are contiguous. The wrapper refuses what does
// not fit one block's shared memory.

#include <cuda_runtime.h>

#include "solve_aug.cuh"

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

template <typename T>
int launch(const void* diag, const void* lower, const void* upper, const void* rhs,
           void* cd, void* x, int B, int nt, int b, int k, long long dbs, long long lbs,
           long long ubs, cudaStream_t stream) {
  const size_t smem = multi_bytes<T>(b, k);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        multi_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  multi_kernel<T><<<B, kThreads, smem, stream>>>(
      static_cast<const T*>(diag), static_cast<const T*>(lower),
      static_cast<const T*>(upper), static_cast<const T*>(rhs), static_cast<T*>(cd),
      static_cast<T*>(x), nt, b, k, dbs, lbs, ubs);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = float64. Layouts (row-major): diag (B,T,b,b),
// lower/upper (B,T-1,b,b), each system contiguous, with batch strides of
// `*_bstride` elements (0 = one band shared by every system); rhs (B,T,b,k)
// contiguous; workspace cd (B,T,b,b+k); x (B,T,b,k). Returns
// cudaGetLastError().
extern "C" int mcp_thomas_solve_multi(int dtype, const void* diag, const void* lower,
                                      const void* upper, const void* rhs, void* cd, void* x,
                                      int B, int nt, int b, int k, long long diag_bstride,
                                      long long lower_bstride, long long upper_bstride,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(diag, lower, upper, rhs, cd, x, B, nt, b, k, diag_bstride,
                         lower_bstride, upper_bstride, s);
  return launch<double>(diag, lower, upper, rhs, cd, x, B, nt, b, k, diag_bstride,
                        lower_bstride, upper_bstride, s);
}
