// K8b: batched dense solve by blocked (compact-WY) Householder QR without
// pivoting, then back substitution, for sm_90a.
//
// Replaces mcp_tpu/kernels/linear_solve.py::_wy_qr_solve_kernel (:103). Same
// algebra: for each panel of nb columns j0..j0+nb-1, the nb reflections
// (K8a's: alpha = -sign(v_k) sqrt(v.v + 1e-30), u = v - alpha e_k,
// beta = 2 / (u.u + 1e-30), 0 when u.u <= 1e-30) are confined to a copy P of
// the panel, and the block reflector I - U T U^T is accumulated by LAPACK's
// larft (forward, columnwise): T[:k, k] = -beta T (U^T u), T[k, k] = beta.
// The factored panel P is the panel's R (kept, as LAPACK's larfb does); the
// trailing columns and b then take Q^T once per panel:
// [A | b] <- [A | b] - U (T^T (U^T [A | b])) over the columns right of the
// panel. (The JAX kernel applies the update to the panel columns as well and
// drops P; the two differ by rounding only.) Back substitution
// divides by the raw R diagonal: a zero pivot gives inf/NaN in x. n is a
// multiple of nb (the wrapper pads with identity rows and columns). The JAX
// kernel's updates also touch rows above the panel (U is zero there) and
// columns left of it (rounding residue below the diagonal); this kernel skips
// both.
//
// Bound on this card: at the QP Schur systems (B=256, n=100 padded to 104,
// nb=8, float32) the kernel must read A and b and write x, 11.2 MB: 3.3 us at
// 3.35 TB/s; its 0.45 GFLOP (the panel reflections, larft, the three
// products of each trailing update, the back substitution;
// chip_smoke.wy_counts) take 6.8 us at the 67 TFLOP/s float32 rate: bound
// by operations. In practice neither binds: the panels are a serial chain,
// each nb reflections with three block barriers and a two-barrier update.
//
// Design (simple and correct first): one thread block per system; A (row
// stride n+1), b, P, U (n x nb), T (nb x nb) and the (nb x (n+1)) product
// T^T U^T [A | b] in shared memory. A reflection's norms are warp-shuffle
// reductions in warp 0, u^T P and U^T u one warp per panel column; the
// product takes one thread per column of [A | b] (U^T column in registers,
// then T^T); the update spreads the trailing block over all threads.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPanel = 16;

__device__ __forceinline__ float dsqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double dsqrt(double v) { return sqrt(v); }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
size_t smem_bytes(int n, int nb) {
  return sizeof(T) * ((size_t)n * (n + 1) + 2 * (size_t)n + 2 * (size_t)n * nb +
                      (size_t)nb * nb + (size_t)nb * (n + 1) + 2 * nb + 4);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) wy_kernel(
    const T* __restrict__ A, const T* __restrict__ b, T* __restrict__ x, int n, int nb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lda = n + 1;
  T* M = reinterpret_cast<T*>(smem_raw);  // n x lda: A
  T* bv = M + (size_t)n * lda;            // n: b
  T* u = bv + n;                          // n: Householder vector, then x
  T* P = u + n;                           // n x nb: the panel's working copy
  T* U = P + (size_t)n * nb;              // n x nb: the panel's reflectors
  T* Tm = U + (size_t)n * nb;             // nb x nb: larft's T
  T* Wp = Tm + nb * nb;                   // nb x (n+1): T^T U^T [A | b]
  T* wv = Wp + (size_t)nb * (n + 1);      // nb: u^T P
  T* utu = wv + nb;                       // nb: U^T u
  T* sc = utu + nb;                       // sc[0] beta

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
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

  for (int j0 = 0; j0 < n; j0 += nb) {
    for (int e = tid; e < n * nb; e += kThreads) {
      const int i = e / nb, c = e - (e / nb) * nb;
      P[e] = M[i * lda + j0 + c];
      U[e] = T(0);
    }
    for (int e = tid; e < nb * nb; e += kThreads) Tm[e] = T(0);
    __syncthreads();

    for (int k = 0; k < nb; ++k) {
      const int g = j0 + k;  // the reflection's pivot row
      if (warp == 0) {
        T ss = T(0);
        for (int i = g + lane; i < n; i += 32) {
          const T v = P[i * nb + k];
          ss += v * v;
        }
        ss = warp_sum(ss);
        const T vk = P[g * nb + k];
        const T norm = dsqrt(ss + eps);
        const T alpha = vk >= T(0) ? -norm : norm;
        T uu = T(0);
        for (int i = g + lane; i < n; i += 32) {
          const T ui = i == g ? vk - alpha : P[i * nb + k];
          u[i] = ui;
          uu += ui * ui;
        }
        uu = warp_sum(uu);
        if (lane == 0) sc[0] = uu > eps ? T(2) / (uu + eps) : T(0);
      }
      __syncthreads();
      for (int c = warp; c < nb; c += kWarps) {
        const T* col = c >= k ? P : U;  // u^T P right of k, U^T u left of it
        T acc = T(0);
        for (int i = g + lane; i < n; i += 32) acc += u[i] * col[i * nb + c];
        acc = warp_sum(acc);
        if (lane == 0) {
          if (c >= k)
            wv[c] = acc;
          else
            utu[c] = acc;
        }
      }
      __syncthreads();
      const T beta = sc[0];
      const int pc = nb - k;
      for (int e = tid; e < (n - g) * pc; e += kThreads) {
        const int i = g + e / pc, c = k + (e - (e / pc) * pc);
        P[i * nb + c] -= (beta * u[i]) * wv[c];
      }
      for (int i = g + tid; i < n; i += kThreads) U[i * nb + k] = u[i];
      if (tid < k) {
        T acc = T(0);
        for (int q = 0; q < k; ++q) acc += Tm[tid * nb + q] * utu[q];
        Tm[tid * nb + k] = -beta * acc;
      } else if (tid == k) {
        Tm[k * nb + k] = beta;
      }
      __syncthreads();
    }

    // The factored panel is R's panel columns (rows above j0 are unchanged).
    for (int e = tid; e < (n - j0) * nb; e += kThreads) {
      const int i = j0 + e / nb, c = e - (e / nb) * nb;
      M[i * lda + j0 + c] = P[i * nb + c];
    }
    // Wp = T^T (U^T [A | b]) over the columns right of the panel (column n
    // is b).
    const int jt = j0 + nb;
    for (int j = jt + tid; j <= n; j += kThreads) {
      T z[kMaxPanel];
#pragma unroll
      for (int r = 0; r < kMaxPanel; ++r) z[r] = T(0);
      for (int i = j0; i < n; ++i) {
        const T a = j < n ? M[i * lda + j] : bv[i];
#pragma unroll
        for (int r = 0; r < kMaxPanel; ++r)
          if (r < nb) z[r] += U[i * nb + r] * a;
      }
      for (int c = 0; c < nb; ++c) {
        T acc = T(0);
#pragma unroll
        for (int r = 0; r < kMaxPanel; ++r)
          if (r < nb) acc += Tm[r * nb + c] * z[r];
        Wp[c * (n + 1) + j] = acc;
      }
    }
    __syncthreads();
    // [A | b] -= U Wp over the rows from j0 on and the columns right of the
    // panel.
    const int cols = n + 1 - jt;
    for (int e = tid; e < (n - j0) * cols; e += kThreads) {
      const int i = j0 + e / cols, j = jt + (e - (e / cols) * cols);
      T acc = T(0);
      for (int c = 0; c < nb; ++c) acc += U[i * nb + c] * Wp[c * (n + 1) + j];
      if (j < n)
        M[i * lda + j] -= acc;
      else
        bv[i] -= acc;
    }
    __syncthreads();
  }

  // Back substitution R x = Q^T b in warp 0; x_j lives in u[j] once solved.
  if (warp == 0) {
    for (int k = n - 1; k >= 0; --k) {
      T acc = T(0);
      for (int j = k + 1 + lane; j < n; j += 32) acc += M[k * lda + j] * u[j];
      acc = warp_sum(acc);
      if (lane == 0) u[k] = (bv[k] - acc) / M[k * lda + k];
      __syncwarp();
    }
    T* x_sys = x + sys * n;
    for (int i = lane; i < n; i += 32) x_sys[i] = u[i];
  }
}

template <typename T>
int launch(const void* A, const void* b, void* x, int B, int n, int nb, cudaStream_t stream) {
  if (nb < 1 || nb > kMaxPanel || n % nb != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T>(n, nb);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        wy_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  wy_kernel<T><<<B, kThreads, smem, stream>>>(
      static_cast<const T*>(A), static_cast<const T*>(b), static_cast<T*>(x), n, nb);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = float64. Layouts (row-major, contiguous): A
// (B,n,n), b (B,n), x (B,n), n a multiple of the panel width nb <= 16.
// Returns cudaGetLastError().
extern "C" int mcp_wy_solve(int dtype, const void* A, const void* b, void* x, int B, int n,
                            int nb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(A, b, x, B, n, nb, s);
  return launch<double>(A, b, x, B, n, nb, s);
}
