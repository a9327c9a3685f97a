// K7a: batched block-tridiagonal solve by the two-way ("burn at both ends")
// pivot-free Householder block-Thomas sweep, for sm_90a.
//
// Replaces mcp_tpu/kernels/thomas_pallas.py::_thomas_kernel_babe (:737) with
// its dispatch _pallas_block_thomas_babe (:1223), factorization "qr"; each
// in-block solve is K1's (csrc/thomas.cu), the algebra of _qr_solve_aug (:33)
// with eps = 1e-30 inside the sqrt and in beta.
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
// starts at t = T-1 (the pad solves to [C | d] = 0 and changes nothing). A
// zero or non-finite pivot gives inf/NaN in x; nothing sanitizes it.
//
// Bound on this card: at the training step's shape (B=8, T=30, b=40,
// float32, per-lane bands) the kernel must read diag, lower, upper and rhs
// and write x, 4.6 MB: 1.4 us at 3.35 TB/s; its 0.10 GFLOP take 1.5 us at the
// 67 TFLOP/s float32 rate, so it is bound by operations (chip_smoke.py,
// babe_counts). In practice neither binds: each step is a serial chain of b
// reflections, three barriers each. The two-way order halves the serial
// chain of K1's one-way sweep (T steps to ceil(T/2) + 1).
//
// Design (simple and correct first): one thread block of 256 threads per
// system; threads 0-127 run the left sweep and threads 128-255 the right
// sweep at the same time, each in its own shared-memory working set (K1's
// [D - LC | U | r], L, [C | d]) and synchronised by its own hardware barrier
// (bar.sync 1 and 2, 128 threads); the junction solve runs on all 256
// threads after one block barrier, and the two back substitutions again run
// side by side. [C_t | d_t] of every step goes to a global workspace
// (B, T, b, b+1) that the wrapper allocates, read back by the back
// substitution. Nothing crosses thread blocks.

#include <cuda_runtime.h>

namespace {

constexpr int kGroup = 128;           // threads per direction
constexpr int kThreads = 2 * kGroup;  // one block: both directions

__device__ __forceinline__ float dsqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double dsqrt(double v) { return sqrt(v); }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Hardware barrier `id` over `count` threads (id 0, count 256: the block).
__device__ __forceinline__ void bar(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// Elements of one direction's working set: M (b x nc) + L (b x b) +
// [C|d] (b x (b+1)) + u (b) + w (nc) + beta (1), nc = 2b+1.
__host__ __device__ __forceinline__ int per_dir(int b) {
  const int nc = 2 * b + 1;
  return b * nc + b * b + b * (b + 1) + b + nc + 1;
}

template <typename T>
struct Work {
  T* M;     // b x (2b+1): [D - LC | U | r - Ld], then its QR
  T* Lm;    // b x b: the coupling to the previous step
  T* Cd;    // b x (b+1): [C | d] of the previous step, then of this one
  T* u;     // b: Householder vector, then x of the back substitution
  T* w;     // 2b+1: u^T M
  T* beta;  // 1
};

template <typename T>
__device__ Work<T> carve(T* base, int b) {
  const int nc = 2 * b + 1;
  Work<T> W;
  W.M = base;
  W.Lm = W.M + b * nc;
  W.Cd = W.Lm + b * b;
  W.u = W.Cd + b * (b + 1);
  W.w = W.u + b;
  W.beta = W.w + nc;
  return W;
}

// Householder QR of M[:, :b] (row stride ld), applied to columns k..nc-1,
// then back substitution R X = Q^T M[:, b:] into X (b x (nc-b), row stride
// ldx): thread c owns column c. `nthr` threads (thread index g) under
// barrier `id`.
template <typename T>
__device__ void qr_solve(T* M, int ld, int b, int nc, T* u, T* w, T* beta_s,
                         T* X, int ldx, int g, int nthr, int id) {
  const T eps = T(1e-30);
  for (int k = 0; k < b; ++k) {
    if (g < 32) {
      T ss = T(0);
      for (int i = k + g; i < b; i += 32) {
        const T v = M[i * ld + k];
        ss += v * v;
      }
      ss = warp_sum(ss);
      if (g == 0) {
        const T vk = M[k * ld + k];
        const T norm = dsqrt(ss + eps);
        const T sgn = vk >= T(0) ? T(1) : T(-1);
        const T avk = vk >= T(0) ? vk : -vk;
        u[k] = vk + sgn * norm;
        beta_s[0] = T(1) / (norm * (norm + avk) + eps);
      }
      for (int i = k + 1 + g; i < b; i += 32) u[i] = M[i * ld + k];
    }
    bar(id, nthr);
    for (int j = k + g; j < nc; j += nthr) {
      T acc = T(0);
      for (int i = k; i < b; ++i) acc += u[i] * M[i * ld + j];
      w[j] = acc;
    }
    bar(id, nthr);
    const T beta = beta_s[0];
    const int cols = nc - k;
    for (int e = g; e < (b - k) * cols; e += nthr) {
      const int i = k + e / cols, j = k + (e - (e / cols) * cols);
      M[i * ld + j] -= (beta * u[i]) * w[j];
    }
    bar(id, nthr);
  }
  for (int c = g; c < nc - b; c += nthr) {
    for (int k = b - 1; k >= 0; --k) {
      T acc = M[k * ld + b + c];
      for (int j = k + 1; j < b; ++j) acc -= M[k * ld + j] * X[j * ldx + c];
      X[k * ldx + c] = acc / M[k * ld + k];
    }
  }
  bar(id, nthr);
}

// One sweep step of one direction: [C | d] of (D - Lp C_prev) [C | d] =
// [Un | r - Lp d_prev] into W.Cd and cd_out; Lp == nullptr at the chain's
// start (W.Cd then holds nothing that is read).
template <typename T>
__device__ void sweep_step(const Work<T>& W, const T* Dt, const T* Lp,
                           const T* Un, const T* rt, int b, int g, int id,
                           T* cd_out) {
  const int nc = 2 * b + 1, ldc = b + 1;
  if (Lp != nullptr)
    for (int e = g; e < b * b; e += kGroup) W.Lm[e] = Lp[e];
  bar(id, kGroup);  // Lm loaded; Cd holds the previous step
  for (int e = g; e < b * nc; e += kGroup) {
    const int i = e / nc, j = e - (e / nc) * nc;
    T val = j < b ? Dt[i * b + j] : (j < 2 * b ? Un[i * b + (j - b)] : rt[i]);
    if (Lp != nullptr && (j < b || j == 2 * b)) {
      const int cj = j < b ? j : b;
      T acc = T(0);
      for (int k = 0; k < b; ++k) acc += W.Lm[i * b + k] * W.Cd[k * ldc + cj];
      val -= acc;
    }
    W.M[i * nc + j] = val;
  }
  bar(id, kGroup);
  qr_solve(W.M, nc, b, nc, W.u, W.w, W.beta, W.Cd, ldc, g, kGroup, id);
  for (int e = g; e < b * ldc; e += kGroup) cd_out[e] = W.Cd[e];
}

template <typename T>
__global__ void __launch_bounds__(kThreads) babe_kernel(
    const T* __restrict__ diag, const T* __restrict__ lower,
    const T* __restrict__ upper, const T* __restrict__ rhs, T* cd,
    T* __restrict__ x, int nt, int b, long long lower_bstride,
    long long upper_bstride) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x;
  const int dir = tid / kGroup;  // 0: left sweep, 1: right sweep
  const int g = tid - dir * kGroup;
  const int id = 1 + dir;
  const Work<T> left = carve(smem, b);
  const Work<T> right = carve(smem + per_dir(b), b);
  const Work<T>& W = dir == 0 ? left : right;

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
      sweep_step(W, D_sys + t * bb, t > 0 ? L_sys + (t - 1) * bb : nullptr,
                 U_sys + t * bb, r_sys + (long long)t * b, b, g, id,
                 cd_sys + (long long)t * b * ldc);
  } else {
    for (int t = nt - 1; t >= ml; --t)
      sweep_step(W, D_sys + t * bb, t < nt - 1 ? U_sys + t * bb : nullptr,
                 L_sys + (t - 1) * bb, r_sys + (long long)t * b, b, g, id,
                 cd_sys + (long long)t * b * ldc);
  }
  bar(0, kThreads);

  // Junction, on the whole block: Mj = [I - C E | d - C e] (b x (b+1), row
  // stride b+1) in the left M, its solution x_{ml-1} in the left Lm.
  const int nj = b + 1;
  for (int e = tid; e < b * nj; e += kThreads) {
    const int i = e / nj, j = e - (e / nj) * nj;
    T acc = T(0);
    for (int k = 0; k < b; ++k) acc += left.Cd[i * ldc + k] * right.Cd[k * ldc + j];
    const T head = j < b ? (i == j ? T(1) : T(0)) : left.Cd[i * ldc + b];
    left.M[i * nj + j] = head - acc;
  }
  bar(0, kThreads);
  qr_solve(left.M, nj, b, nj, left.u, left.w, left.beta, left.Lm, 1, tid,
           kThreads, 0);
  if (tid < b) {
    const T xl = left.Lm[tid];
    T acc = right.Cd[tid * ldc + b];
    for (int k = 0; k < b; ++k) acc -= right.Cd[tid * ldc + k] * left.Lm[k];
    left.u[tid] = xl;
    right.u[tid] = acc;
    x_sys[(long long)(ml - 1) * b + tid] = xl;
    x_sys[(long long)ml * b + tid] = acc;
  }
  bar(0, kThreads);

  // Both back substitutions at once: left x_t = d_t - C_t x_{t+1} for
  // t = ml-2..0, right x_t = e_t - E_t x_{t-1} for t = ml+1..T-1.
  const int steps = dir == 0 ? ml - 1 : nt - ml - 1;
  for (int s = 0; s < steps; ++s) {
    const int t = dir == 0 ? ml - 2 - s : ml + 1 + s;
    const T* cdt = cd_sys + (long long)t * b * ldc;
    T xi = T(0);
    if (g < b) {
      T acc = cdt[g * ldc + b];
      for (int j = 0; j < b; ++j) acc -= cdt[g * ldc + j] * W.u[j];
      xi = acc;
    }
    bar(id, kGroup);
    if (g < b) {
      W.u[g] = xi;
      x_sys[(long long)t * b + g] = xi;
    }
    bar(id, kGroup);
  }
}

template <typename T>
size_t smem_bytes(int b) {
  return 2 * sizeof(T) * (size_t)per_dir(b);
}

template <typename T>
int launch(const void* diag, const void* lower, const void* upper,
           const void* rhs, void* cd, void* x, int B, int nt, int b,
           long long lower_bstride, long long upper_bstride,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(b);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        babe_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  babe_kernel<T><<<B, kThreads, smem, stream>>>(
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
// workspace cd (B,T,b,b+1), x (B,T,b); T >= 2, b <= 128. Returns
// cudaGetLastError().
extern "C" int mcp_babe_solve(int dtype, const void* diag, const void* lower,
                              const void* upper, const void* rhs, void* cd,
                              void* x, int B, int nt, int b,
                              long long lower_bstride, long long upper_bstride,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(diag, lower, upper, rhs, cd, x, B, nt, b,
                         lower_bstride, upper_bstride, s);
  return launch<double>(diag, lower, upper, rhs, cd, x, B, nt, b,
                        lower_bstride, upper_bstride, s);
}
