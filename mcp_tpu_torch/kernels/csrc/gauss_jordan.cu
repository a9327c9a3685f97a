// K4a and K5: batched Gauss-Jordan solve without pivoting, optionally with
// the explicit inverse, for sm_90a.
//
// Replaces mcp_tpu/kernels/linear_solve.py::_gj_lanes_kernel (:577, K4a:
// [A | b] -> x) and ::_gji_lanes_kernel (:674, K5: [A | b | I] -> x, A^-1),
// one template with an emit-inverse flag. Same algebra, step by step: the
// pivot guard inv = 1 / (|p| > 1e-30 ? p : 1e-30) (a zero pivot gives huge
// values, not NaN), multipliers f_i = M[i][k] * inv, every other row minus
// f_i * (row k), row k times inv. Products and differences are rounded one
// by one (__fmul_rn / __fsub_rn, no FMA contraction), so the kernel rounds
// exactly as the plain PyTorch version (linear_solve.gj_solve_plain).
// Valid only where no-pivot elimination is stable: the SPD Schur matrices
// of convex QPs.
//
// Bound on this card: at the QP path (B=256, n=100, float32) K4a must read
// A and b and write x, 10.4 MB, 3.1 us at 3.35 TB/s, and do n^2 (n+1)
// multiply-subtract pairs per system, 0.26 GFLOP, 3.9 us at the 67 TFLOP/s
// float32 rate: bound by operations. K5 also writes A^-1 (20.7 MB, 6.2 us)
// and at step k updates n+1 live columns (A right of the pivot, b, and the
// identity columns 0..k), about 2 n^3 per system, 0.52 GFLOP, 7.7 us: bound
// by operations too. In practice neither binds: the n elimination steps are
// a serial chain with two block barriers each.
//
// Design (simple and correct first): one thread block per system, the whole
// augmented matrix in shared memory (row stride n+1 or 2n+1, odd, so column
// walks hit distinct banks; 40.4 KB for K4a and 80.4 KB for K5 at n=100 in
// float32, 160.8 KB for K5 in float64, above 48 KB by dynamic shared memory
// after cudaFuncSetAttribute). Each step stages the multipliers and row k in
// shared vectors, then updates only the live columns: right of the pivot
// (the columns already eliminated feed no output; x and A^-1 are the columns
// right of A) and, for K5, left of identity column k+1 (row k is 0 on the
// identity columns after it, so the update would leave them as they are).
// B=256 systems give about two blocks per SM on 132 SMs.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

template <typename T>
size_t smem_bytes(int n, int nc) {
  // M (n x nc) + multipliers (n) + row k (nc) + one spare slot.
  return sizeof(T) * ((size_t)n * nc + n + nc + 1);
}

template <typename T, bool kInverse>
__global__ void __launch_bounds__(kThreads) gj_kernel(
    const T* __restrict__ A, const T* __restrict__ b, T* __restrict__ x,
    T* __restrict__ inv, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nc = kInverse ? 2 * n + 1 : n + 1;
  T* M = reinterpret_cast<T*>(smem_raw);  // n x nc: [A | b (| I)]
  T* f = M + (size_t)n * nc;              // n: multipliers of step k
  T* r = f + n;                           // nc: row k of step k

  const int tid = threadIdx.x;
  const long long sys = blockIdx.x;
  const T* A_sys = A + sys * n * n;
  const T* b_sys = b + sys * n;
  const T eps = T(1e-30);

  for (int e = tid; e < n * nc; e += kThreads) {
    const int i = e / nc, j = e - (e / nc) * nc;
    T v;
    if (j < n) {
      v = A_sys[i * n + j];
    } else if (j == n) {
      v = b_sys[i];
    } else {
      v = (j - n - 1 == i) ? T(1) : T(0);
    }
    M[e] = v;
  }
  __syncthreads();

  for (int k = 0; k < n; ++k) {
    const T p = M[k * nc + k];
    const T ik = T(1) / ((p >= T(0) ? p : -p) > eps ? p : eps);
    for (int i = tid; i < n; i += kThreads) f[i] = mul_rn(M[i * nc + k], ik);
    const int hi = kInverse ? n + 2 + k : nc;  // live columns end here
    for (int j = k + 1 + tid; j < hi; j += kThreads) r[j] = M[k * nc + j];
    __syncthreads();
    const int cols = hi - k - 1;
    for (int e = tid; e < n * cols; e += kThreads) {
      const int i = e / cols, j = k + 1 + (e - (e / cols) * cols);
      M[i * nc + j] = (i == k) ? mul_rn(r[j], ik) : sub_rn(M[i * nc + j], mul_rn(f[i], r[j]));
    }
    __syncthreads();
  }

  T* x_sys = x + sys * n;
  for (int i = tid; i < n; i += kThreads) x_sys[i] = M[i * nc + n];
  if (kInverse) {
    T* inv_sys = inv + sys * n * n;
    for (int e = tid; e < n * n; e += kThreads) {
      const int i = e / n, j = e - (e / n) * n;
      inv_sys[e] = M[i * nc + n + 1 + j];
    }
  }
}

template <typename T, bool kInverse>
int launch(const void* A, const void* b, void* x, void* inv, int B, int n,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(n, kInverse ? 2 * n + 1 : n + 1);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gj_kernel<T, kInverse>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  gj_kernel<T, kInverse><<<B, kThreads, smem, stream>>>(
      static_cast<const T*>(A), static_cast<const T*>(b), static_cast<T*>(x),
      static_cast<T*>(inv), n);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = float64. Layouts (row-major, contiguous): A
// (B,n,n), b (B,n), x (B,n), inv (B,n,n) or null. With inv null the kernel
// eliminates [A | b] (K4a); otherwise [A | b | I] and writes A^-1 (K5).
// Returns cudaGetLastError().
extern "C" int mcp_gj_solve(int dtype, const void* A, const void* b, void* x,
                            void* inv, int B, int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (inv == nullptr) {
    if (dtype == 0) return launch<float, false>(A, b, x, inv, B, n, s);
    return launch<double, false>(A, b, x, inv, B, n, s);
  }
  if (dtype == 0) return launch<float, true>(A, b, x, inv, B, n, s);
  return launch<double, true>(A, b, x, inv, B, n, s);
}
