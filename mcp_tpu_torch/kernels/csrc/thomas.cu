// K1: batched block-tridiagonal solve by a pivot-free Householder
// block-Thomas sweep, for sm_90a.
//
// Replaces mcp_tpu/kernels/thomas_pallas.py::_thomas_kernel_lanes (:852)
// and ::_thomas_kernel_packed (:516); same algebra as _qr_solve_aug (:33),
// including eps = 1e-30 inside the sqrt and in beta.
//
// Per system: for t = 0..T-1 solve (D_t - L_t C_{t-1}) [C_t | d_t] =
// [U_t | r_t - L_t d_{t-1}] by Householder QR without pivoting, then
// back-substitute x_t = d_t - C_t x_{t+1}. A zero or non-finite pivot gives
// inf/NaN in x; nothing sanitizes it (the solver's linesearch flags it as a
// failed linear solve).
//
// Bound on this card: at the main path (B=256, T=10, b=20, float32) the
// kernel must read diag + rhs (4.4 MB; lower/upper are shared by every
// system) and write x: ~1.4 us at 3.35 TB/s; its ~138 MFLOP take ~2.1 us at
// the 67 TFLOP/s float32 rate, so it is bound by operations. In practice
// neither binds: each step is a serial chain of b reflections, each with
// three block-wide barriers, and a serial back substitution.
//
// Design (simple and correct first): one thread block per system; the step's
// working block [D - LC | U | r - Ld] (b x (2b+1)) lives in shared memory
// with an odd row stride (no bank conflicts on column walks); column norms
// are warp-shuffle reductions; [C_t | d_t] of every step goes to a global
// workspace (B, T, b, b+1) that the wrapper allocates (L2-resident at the
// main path), read back by the backward sweep. The T-serial chain stays
// inside one block, so no inter-block synchronisation exists.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float dsqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double dsqrt(double v) { return sqrt(v); }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
size_t smem_bytes(int b) {
  const int nc = 2 * b + 1;
  // M (b x nc) + L (b x b) + [C|d] (b x (b+1)) + u (b) + w (nc) + beta (1)
  return sizeof(T) * (size_t)(b * nc + b * b + b * (b + 1) + b + nc + 1);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) thomas_kernel(
    const T* __restrict__ diag, const T* __restrict__ lower,
    const T* __restrict__ upper, const T* __restrict__ rhs,
    T* __restrict__ cd, T* __restrict__ x, int nt, int b,
    long long lower_bstride, long long upper_bstride) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int nc = 2 * b + 1;  // columns of [denominator | U | r]
  const int ldc = b + 1;     // columns of [C | d]
  T* M = smem;               // b x nc
  T* Lm = M + b * nc;        // b x b: L_t
  T* Cd = Lm + b * b;        // b x ldc: [C | d] of the previous step
  T* u = Cd + b * ldc;       // b: Householder vector, then x_{t+1}
  T* w = u + b;              // nc: u^T M
  T* beta_s = w + nc;        // 1

  const int tid = threadIdx.x;
  const long long bb = (long long)b * b;
  const long long sys = blockIdx.x;
  const T* D_sys = diag + sys * nt * bb;
  const T* L_sys = lower + sys * lower_bstride;
  const T* U_sys = upper + sys * upper_bstride;
  const T* r_sys = rhs + sys * nt * b;
  T* cd_sys = cd + sys * nt * b * ldc;
  T* x_sys = x + sys * nt * b;
  const T eps = T(1e-30);

  for (int t = 0; t < nt; ++t) {
    if (t > 0) {
      const T* Lt = L_sys + (long long)(t - 1) * bb;
      for (int e = tid; e < b * b; e += kThreads) Lm[e] = Lt[e];
    }
    __syncthreads();  // Lm loaded; Cd holds step t-1

    // M = [D_t - L_t C_{t-1} | U_t | r_t - L_t d_{t-1}] (U_{T-1} = 0).
    const T* Dt = D_sys + (long long)t * bb;
    const T* Ut = U_sys + (long long)t * bb;
    for (int e = tid; e < b * nc; e += kThreads) {
      const int i = e / nc, j = e - (e / nc) * nc;
      T val;
      if (j < b) {
        val = Dt[i * b + j];
      } else if (j < 2 * b) {
        val = (t < nt - 1) ? Ut[i * b + (j - b)] : T(0);
      } else {
        val = r_sys[(long long)t * b + i];
      }
      if (t > 0 && (j < b || j == 2 * b)) {
        const int cj = (j < b) ? j : b;
        T acc = T(0);
        for (int k = 0; k < b; ++k) acc += Lm[i * b + k] * Cd[k * ldc + cj];
        val -= acc;
      }
      M[i * nc + j] = val;
    }
    __syncthreads();

    // Householder QR of the denominator, applied to every column from k on.
    for (int k = 0; k < b; ++k) {
      if (tid < 32) {
        T ss = T(0);
        for (int i = k + tid; i < b; i += 32) {
          const T v = M[i * nc + k];
          ss += v * v;
        }
        ss = warp_sum(ss);
        if (tid == 0) {
          const T vk = M[k * nc + k];
          const T norm = dsqrt(ss + eps);
          const T sgn = vk >= T(0) ? T(1) : T(-1);
          const T avk = vk >= T(0) ? vk : -vk;
          u[k] = vk + sgn * norm;
          beta_s[0] = T(1) / (norm * (norm + avk) + eps);
        }
        for (int i = k + 1 + tid; i < b; i += 32) u[i] = M[i * nc + k];
      }
      __syncthreads();
      for (int j = k + tid; j < nc; j += kThreads) {
        T acc = T(0);
        for (int i = k; i < b; ++i) acc += u[i] * M[i * nc + j];
        w[j] = acc;
      }
      __syncthreads();
      const T beta = beta_s[0];
      const int cols = nc - k;
      for (int e = tid; e < (b - k) * cols; e += kThreads) {
        const int i = k + e / cols, j = k + (e - (e / cols) * cols);
        M[i * nc + j] -= (beta * u[i]) * w[j];
      }
      __syncthreads();
    }

    // Back substitution R [C_t | d_t] = Q^T [U | r']: thread c owns column c.
    for (int c = tid; c < ldc; c += kThreads) {
      for (int k = b - 1; k >= 0; --k) {
        T acc = M[k * nc + b + c];
        for (int j = k + 1; j < b; ++j) acc -= M[k * nc + j] * Cd[j * ldc + c];
        Cd[k * ldc + c] = acc / M[k * nc + k];
      }
    }
    __syncthreads();
    T* cdt = cd_sys + (long long)t * b * ldc;
    for (int e = tid; e < b * ldc; e += kThreads) cdt[e] = Cd[e];
  }

  // Backward sweep x_t = d_t - C_t x_{t+1}, x_T = 0.
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

template <typename T>
int launch(const void* diag, const void* lower, const void* upper,
           const void* rhs, void* cd, void* x, int B, int nt, int b,
           long long lower_bstride, long long upper_bstride,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(b);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        thomas_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  thomas_kernel<T><<<B, kThreads, smem, stream>>>(
      static_cast<const T*>(diag), static_cast<const T*>(lower),
      static_cast<const T*>(upper), static_cast<const T*>(rhs),
      static_cast<T*>(cd), static_cast<T*>(x), nt, b, lower_bstride,
      upper_bstride);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = float64. Layouts (row-major, contiguous within a
// system): diag (B,T,b,b), lower/upper (B,T-1,b,b) with a batch stride of
// `*_bstride` elements (0 = one band shared by every system), rhs (B,T,b),
// workspace cd (B,T,b,b+1), x (B,T,b). Returns cudaGetLastError().
extern "C" int mcp_thomas_solve(int dtype, const void* diag, const void* lower,
                                const void* upper, const void* rhs, void* cd,
                                void* x, int B, int nt, int b,
                                long long lower_bstride,
                                long long upper_bstride, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(diag, lower, upper, rhs, cd, x, B, nt, b,
                         lower_bstride, upper_bstride, s);
  return launch<double>(diag, lower, upper, rhs, cd, x, B, nt, b,
                        lower_bstride, upper_bstride, s);
}
