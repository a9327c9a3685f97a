// K4b/K4c: batched dense solve by Householder QR without pivoting on the
// augmented [A | b], then back substitution, for sm_90a.
//
// Replaces mcp_tpu/kernels/linear_solve.py::_qr_lanes_kernel (:494, the
// B >= 128 float32 route of gauss_solve) and ::_qr_solve_aug_kernel (:200,
// every other batch and dtype): one function, the gate between them being a
// TPU layout rule. Same algebra: v = column k below the diagonal,
// norm = sqrt(|v|^2 + 1e-30), u = v + sign(v_k) norm e_k,
// beta = 1 / (norm (norm + |v_k|) + 1e-30), M -= (beta u)(u^T M); then
// x_k = (c_k - R[k, k+1:] x[k+1:]) / R[k, k] with the raw R diagonal. A zero
// pivot gives inf/NaN in x; nothing sanitizes it (the solver's linesearch
// flags it as a failed linear solve).
//
// Bound on this card: at the QP path (B=256, n=100, float32) the kernel must
// read A and b and write x, 10.4 MB, 3.1 us at 3.35 TB/s; its
// 4 sum_k (n-k)(n+1-k) + n^2 ~ 1.37 MFLOP per system, 0.35 GFLOP, take
// 5.2 us at the 67 TFLOP/s float32 rate: bound by operations. In practice
// neither binds: the n reflections are a serial chain, each a column-norm
// reduction, a u^T M product and a rank-1 update with three block barriers.
//
// Design (simple and correct first): one thread block per system, [A | b]
// in shared memory (row stride n+1, odd, so column walks hit distinct
// banks; 40.4 KB at n=100 in float32, 80.8 KB in float64, above 48 KB by
// dynamic shared memory after cudaFuncSetAttribute). The column norm is a
// warp-shuffle reduction in warp 0; u^T M gives one thread per column; the
// rank-1 update spreads the trailing block over all threads. The back
// substitution runs in warp 0 alone, a shuffle-reduced row dot per step, so
// it needs no block barrier.

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
  // M (n x (n+1)) + u (n) + w (n+1) + beta (1).
  const int nc = n + 1;
  return sizeof(T) * ((size_t)n * nc + n + nc + 1);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) qr_kernel(
    const T* __restrict__ A, const T* __restrict__ b, T* __restrict__ x, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nc = n + 1;
  T* M = reinterpret_cast<T*>(smem_raw);  // n x nc: [A | b]
  T* u = M + (size_t)n * nc;              // n: Householder vector, then x
  T* w = u + n;                           // nc: u^T M
  T* beta_s = w + nc;                     // 1

  const int tid = threadIdx.x;
  const long long sys = blockIdx.x;
  const T* A_sys = A + sys * n * n;
  const T* b_sys = b + sys * n;
  const T eps = T(1e-30);

  for (int e = tid; e < n * nc; e += kThreads) {
    const int i = e / nc, j = e - (e / nc) * nc;
    M[e] = (j < n) ? A_sys[i * n + j] : b_sys[i];
  }
  __syncthreads();

  for (int k = 0; k < n; ++k) {
    if (tid < 32) {
      T ss = T(0);
      for (int i = k + tid; i < n; i += 32) {
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
      for (int i = k + 1 + tid; i < n; i += 32) u[i] = M[i * nc + k];
    }
    __syncthreads();
    for (int j = k + tid; j < nc; j += kThreads) {
      T acc = T(0);
      for (int i = k; i < n; ++i) acc += u[i] * M[i * nc + j];
      w[j] = acc;
    }
    __syncthreads();
    const T beta = beta_s[0];
    const int cols = nc - k;
    for (int e = tid; e < (n - k) * cols; e += kThreads) {
      const int i = k + e / cols, j = k + (e - (e / cols) * cols);
      M[i * nc + j] -= (beta * u[i]) * w[j];
    }
    __syncthreads();
  }

  // Back substitution R x = Q^T b in warp 0; x_j lives in u[j] once solved.
  if (tid < 32) {
    for (int k = n - 1; k >= 0; --k) {
      T acc = T(0);
      for (int j = k + 1 + tid; j < n; j += 32) acc += M[k * nc + j] * u[j];
      acc = warp_sum(acc);
      if (tid == 0) u[k] = (M[k * nc + n] - acc) / M[k * nc + k];
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
        qr_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  qr_kernel<T><<<B, kThreads, smem, stream>>>(
      static_cast<const T*>(A), static_cast<const T*>(b), static_cast<T*>(x), n);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = float64. Layouts (row-major, contiguous): A
// (B,n,n), b (B,n), x (B,n). Returns cudaGetLastError().
extern "C" int mcp_qr_solve(int dtype, const void* A, const void* b, void* x,
                            int B, int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(A, b, x, B, n, s);
  return launch<double>(A, b, x, B, n, s);
}
