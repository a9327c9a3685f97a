// K8a: batched dense solve by Householder QR without pivoting with the
// right-hand side kept apart from A, then back substitution, for sm_90a: the
// Newton step's Schur solve of a one-instance solve on tier "schur_pallas".
//
// Replaces mcp_tpu/kernels/linear_solve.py::_qr_solve_kernel (:38). Same
// algebra, which rounds otherwise than K4b's (qr_dense.cu): for column k,
// v = A[k:, k], norm = sqrt(v.v + 1e-30), alpha = -sign(v_k) norm,
// u = v - alpha e_k, beta = 2 / (u.u + 1e-30) if u.u > 1e-30 else 0, then
// A <- A - (beta u)(u^T A) and b <- b - (beta (u.b)) u; finally
// x_k = (b_k - R[k, k+1:] x[k+1:]) / R[k, k] with the raw R diagonal. A zero
// pivot gives inf/NaN in x; nothing sanitizes it (the solver's linesearch
// flags it as a failed linear solve). The JAX kernel's update also touches
// the columns left of k, whose rows from k down hold only rounding residue
// that the back substitution multiplies by zero; this kernel skips them.
//
// Bound on this card: at the lane-change path's shape (one system, n=200,
// float32) the kernel must read A and b and write x, 161.6 KB: 0.05 us at
// 3.35 TB/s; its ~10.7 MFLOP (per reflection the column norm, u.u, u^T A and
// u.b, the rank-1 updates; the back substitution; chip_smoke.dense_counts)
// take 0.16 us at the 67 TFLOP/s float32 rate: bound by operations. In
// practice neither binds: one system is one block on one of 132 SMs, and
// its n reflections are a serial chain with three block barriers each.
//
// Design (simple and correct first): one thread block per system (the JAX
// kernel's batch tile is a VMEM rule), A in shared memory with row stride
// n+1 (odd, so column walks hit distinct banks) beside b, u and w (u^T A and
// u.b); 160.8 KB at n=200 in float32, above 48 KB by dynamic shared memory
// after cudaFuncSetAttribute; the wrapper refuses what does not fit (n=200
// in float64). The norms are warp-shuffle reductions in warp 0; u^T A gives
// one thread per column; the rank-1 update spreads the trailing block over
// all threads. The back substitution runs in warp 0 alone.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float dsqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double dsqrt(double v) { return sqrt(v); }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
size_t smem_bytes(int n) {
  // A (n x (n+1)) + b (n) + u (n) + w (n+1) + 4 scalars.
  return sizeof(T) * ((size_t)n * (n + 1) + 3 * (size_t)n + 1 + 4);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) qr_sep_kernel(
    const T* __restrict__ A, const T* __restrict__ b, T* __restrict__ x, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lda = n + 1;
  T* M = reinterpret_cast<T*>(smem_raw);  // n x lda: A
  T* bv = M + (size_t)n * lda;            // n: b
  T* u = bv + n;                          // n: Householder vector, then x
  T* w = u + n;                           // n+1: u^T A, then u.b at w[n]
  T* sc = w + n + 1;                      // sc[0] beta

  const int tid = threadIdx.x;
  const long long sys = blockIdx.x;
  const T* A_sys = A + sys * n * n;
  const T* b_sys = b + sys * n;
  const T eps = T(1e-30);

  for (int e = tid; e < n * n; e += kThreads) {
    const int i = e / n, j = e - (e / n) * n;
    M[i * lda + j] = A_sys[e];
  }
  for (int i = tid; i < n; i += kThreads) bv[i] = b_sys[i];
  __syncthreads();

  for (int k = 0; k < n; ++k) {
    if (tid < 32) {
      T ss = T(0);
      for (int i = k + tid; i < n; i += 32) {
        const T v = M[i * lda + k];
        ss += v * v;
      }
      ss = warp_sum(ss);
      const T vk = M[k * lda + k];
      const T norm = dsqrt(ss + eps);
      const T alpha = vk >= T(0) ? -norm : norm;
      T uu = T(0);
      for (int i = k + tid; i < n; i += 32) {
        const T ui = i == k ? vk - alpha : M[i * lda + k];
        u[i] = ui;
        uu += ui * ui;
      }
      uu = warp_sum(uu);
      if (tid == 0) sc[0] = uu > eps ? T(2) / (uu + eps) : T(0);
    }
    __syncthreads();
    for (int j = k + tid; j <= n; j += kThreads) {
      T acc = T(0);
      if (j < n)
        for (int i = k; i < n; ++i) acc += u[i] * M[i * lda + j];
      else
        for (int i = k; i < n; ++i) acc += u[i] * bv[i];
      w[j] = acc;
    }
    __syncthreads();
    const T beta = sc[0];
    const T bub = beta * w[n];
    const int cols = n - k;
    for (int e = tid; e < (n - k) * cols; e += kThreads) {
      const int i = k + e / cols, j = k + (e - (e / cols) * cols);
      M[i * lda + j] -= (beta * u[i]) * w[j];
    }
    for (int i = k + tid; i < n; i += kThreads) bv[i] -= bub * u[i];
    __syncthreads();
  }

  // Back substitution R x = Q^T b in warp 0; x_j lives in u[j] once solved.
  if (tid < 32) {
    for (int k = n - 1; k >= 0; --k) {
      T acc = T(0);
      for (int j = k + 1 + tid; j < n; j += 32) acc += M[k * lda + j] * u[j];
      acc = warp_sum(acc);
      if (tid == 0) u[k] = (bv[k] - acc) / M[k * lda + k];
      __syncwarp();
    }
    T* x_sys = x + sys * n;
    for (int i = tid; i < n; i += 32) x_sys[i] = u[i];
  }
}

template <typename T>
int launch(const void* A, const void* b, void* x, int B, int n, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(n);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        qr_sep_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  qr_sep_kernel<T><<<B, kThreads, smem, stream>>>(
      static_cast<const T*>(A), static_cast<const T*>(b), static_cast<T*>(x), n);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = float64. Layouts (row-major, contiguous): A
// (B,n,n), b (B,n), x (B,n). Returns cudaGetLastError().
extern "C" int mcp_qr_sep_solve(int dtype, const void* A, const void* b, void* x, int B,
                                int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(A, b, x, B, n, s);
  return launch<double>(A, b, x, B, n, s);
}
