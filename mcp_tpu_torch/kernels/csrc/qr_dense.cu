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
// flags it as a failed linear solve). The sums run in another order than
// the plain version's (linear_solve.qr_solve_plain), route by route.
//
// Bound on this card: at the QP path (B=256, n=100, float32) the kernel must
// read A and b and write x, 10.4 MB, 3.1 us at 3.35 TB/s; its
// 4 sum_k (n-k)(n+1-k) + n^2 ~ 1.37 MFLOP per system, 0.35 GFLOP, take
// 5.2 us at the 67 TFLOP/s float32 rate: bound by operations. In practice
// neither binds: the n reflections are a serial chain, each a column norm,
// a u^T M product and a rank-1 update, so the latency of one step sets the
// time.
//
// Two routes, chosen by the wrapper's plan (linear_solve.qr_plan, a plain
// function of n and the dtype) and checked here against the kernels' own
// limits; one block of 256 threads per system on both:
//
// "pair" (n + 1 <= 128): threads 2c and 2c + 1 (a lane pair) own column c
// of [A | b] (c < n: A's column, c = n: b), each with half its rows in
// registers, col[r] = M[h H + r][c] for the pair's half h, rows templated to
// H in {8, 16, 24, 32, 40, 48, 52, 64} (2H >= n; rows n.. are zero padding
// and stay zero; 52 is the QP path's n = 100). Every
// register array is indexed at compile time only. The pivot row stays at
// physical row 0: each step writes every updated row one place up, the top
// row of the lower half crossing to the bottom of the upper half by one
// __shfl_xor_sync, and a zero shifts in at the bottom, so row k is a
// compile-time row. Step k: the owner pair of column k has formed the
// reflector from its own registers (each half's sum of squares, one
// __shfl_xor_sync, sqrt and beta) into one of two shared slots; ONE block
// barrier; every pair with c >= k reads its half of u as broadcast 16-byte
// vectors, forms its half of u^T M_c (one __shfl_xor_sync joins the halves)
// and updates its half-column; the upper half retires row k (R[k][c], or
// (Q^T b)_k for c = n) to shared memory, the owner of column k also
// 1 / R[k][k]; and the owner pair of column k + 1 forms step k + 1 into the
// other slot as soon as its own column is updated. A slot is written at step
// k only after the barrier that ends step k - 1, its last reader. Then one
// warp back-substitutes column by column from shared memory, lane l holding
// rows l + 32 q of y = Q^T b, x_k taken by __shfl_sync: no barrier.
//
// "block" (every other n; the A/B of the pair route): [A | b] in shared
// memory (row stride n+1, odd, so column walks hit distinct banks; 40.4 KB
// at n=100 in float32, 80.8 KB in float64, above 48 KB by dynamic shared
// memory after cudaFuncSetAttribute). The column norm is a warp-shuffle
// reduction in warp 0; u^T M gives one thread per column; the rank-1 update
// spreads the trailing block over all threads; three block barriers a
// reflection. The back substitution runs in warp 0 alone, a shuffle-reduced
// row dot per step, so it needs no block barrier.

#include <cuda_runtime.h>

#include "solve_aug_group.cuh"

namespace {

using solve_aug::dsqrt;

constexpr int kThreads = 256;

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
int launch_block(const void* A, const void* b, void* x, int B, int n, cudaStream_t stream) {
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

// ---- Route "pair": a lane pair per column of [A | b], in registers.

// The pair route's columns (one pair of threads each) and its register
// budget: one half-column of H values, in 32-bit registers, at most
// kPairRegs (linear_solve.PAIR_REGS; the rest of the 255 a thread may hold
// is addresses, loop state and the step's scalars: float64 at H = 64 took
// all 255 and spilled, at H = 52 it takes 233).
constexpr int kPairCols = kThreads / 2;
constexpr int kPairRegs = 104;

template <typename T>
__host__ __device__ constexpr bool pair_fits(int h) {
  return h * (int)(sizeof(T) / 4) <= kPairRegs;
}

__host__ __device__ constexpr int round4(int v) { return (v + 3) / 4 * 4; }

// The pair route's shared memory (elements of T): two slots (the step's
// reflector, 2H values, and beta), 1 / R[k][k] (n values), and R with
// Q^T b as its column n, column-major at the odd stride n | 1 (R[k][c] at
// c (n | 1) + k: the pairs of a warp retiring row k hit distinct banks, and
// the back substitution's lanes read a column's consecutive rows).
__host__ __device__ constexpr int pair_slot_elems(int h) { return round4(2 * h + 4); }
__host__ __device__ constexpr long long pair_elems(int h, int n) {
  return 2LL * pair_slot_elems(h) + round4(n) + (long long)(n + 1) * (n | 1);
}

// Step k's reflector from the owner pair's column (physical row 0 the pivot
// row, the finished rows shifted out): each half's sum of squares in four
// partial sums, joined by __shfl_xor_sync; u = the column with u_0 = v_0 +
// sign(v_0) norm, each half storing its own rows; slot[2H] = beta.
template <typename T, int H>
__device__ __forceinline__ void pair_form(T* slot, const T (&col)[H], int h, unsigned pm) {
  using solve_aug_group::pack;
  using V = typename solve_aug_warp::Vec<T>::type;
  constexpr int nv = solve_aug_warp::Vec<T>::n;
  const T eps = T(1e-30);
  T s[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
  for (int i = 0; i < H; ++i) s[i & 3] += col[i] * col[i];
  T ss = (s[0] + s[1]) + (s[2] + s[3]);
  ss += __shfl_xor_sync(pm, ss, 1);
  const T vk = col[0];  // the pivot entry in the upper half
  const T norm = dsqrt(ss + eps);
  V* d = reinterpret_cast<V*>(slot + h * H);
#pragma unroll
  for (int q = 0; q < H / nv; ++q) {
    T e[nv];
#pragma unroll
    for (int r = 0; r < nv; ++r) e[r] = col[nv * q + r];
    if (q == 0 && h == 0) e[0] = vk + (vk >= T(0) ? T(1) : T(-1)) * norm;
    d[q] = pack(e);
  }
  if (h == 0) slot[2 * H] = T(1) / (norm * (norm + (vk >= T(0) ? vk : -vk)) + eps);
}

// Float32 up to H = 52: two blocks an SM (B = 256 systems on 132 SMs in one
// wave; 128 registers a thread, which spill at H = 64).
template <typename T, int H>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 && H <= 52 ? 2 : 1) qr_pair_kernel(
    const T* __restrict__ A, const T* __restrict__ b, T* __restrict__ x, int n) {
  using solve_aug_group::dot4;
  using solve_aug_group::unpack;
  using V = typename solve_aug_warp::Vec<T>::type;
  constexpr int nv = solve_aug_warp::Vec<T>::n;
  constexpr int SL = pair_slot_elems(H);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* slot = reinterpret_cast<T*>(smem_raw);  // slot q at slot + q SL
  T* rinv = slot + 2 * SL;
  T* Rs = rinv + round4(n);
  const int ldr = n | 1;
  const int tid = threadIdx.x;
  const int c = tid >> 1, h = tid & 1, lane = tid & 31;
  const unsigned pm = 3u << (lane & ~1);  // the pair's lanes
  const long long sys = blockIdx.x;
  const T* A_sys = A + sys * n * n;
  const T* b_sys = b + sys * n;

  // The pair's half-column: rows h H + r of column c, zero past n.
  T col[H];
#pragma unroll
  for (int r = 0; r < H; ++r) {
    const int i = h * H + r;
    T v = T(0);
    if (i < n) {
      if (c < n)
        v = A_sys[(long long)i * n + c];
      else if (c == n)
        v = b_sys[i];
    }
    col[r] = v;
  }
  if (c == 0) pair_form<T, H>(slot, col, h, pm);
  __syncthreads();

  for (int k = 0; k < n; ++k) {
    if (c >= k && c <= n) {
      const T* u = slot + (k & 1) * SL;
      T w = dot4<T, H>(col, u + h * H);
      w += __shfl_xor_sync(pm, w, 1);
      const T bw = u[2 * H] * w;
      const V* uv = reinterpret_cast<const V*>(u + h * H);
      T top = T(0);
#pragma unroll
      for (int q = 0; q < H / nv; ++q) {
        T e[nv];
        unpack(uv[q], e);
#pragma unroll
        for (int r = 0; r < nv; ++r) {
          const int i = nv * q + r;
          const T v = col[i] - e[r] * bw;
          if (i == 0)
            top = v;
          else
            col[i - 1] = v;
        }
      }
      // The lower half's top row moves to the bottom of the upper half.
      const T up = __shfl_xor_sync(pm, top, 1);
      col[H - 1] = h == 0 ? up : T(0);
      if (h == 0) {
        Rs[c * ldr + k] = top;
        if (c == k) rinv[k] = T(1) / top;
      }
      if (c == k + 1 && k + 1 < n) pair_form<T, H>(slot + ((k + 1) & 1) * SL, col, h, pm);
    }
    __syncthreads();
  }

  // Back substitution R x = Q^T b on warp 0, column by column: lane l holds
  // y_i, i = l + 32 q (y = Q^T b, then x_i once row i is solved); x_k =
  // y_k (1 / R[k][k]) from its owner lane by __shfl_sync, then y_i -= R[i][k]
  // x_k for i < k.
  if (tid < 32) {
    constexpr int Q = kPairCols / 32;
    T y[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int i = lane + 32 * q;
      y[q] = i < n ? Rs[n * ldr + i] : T(0);
    }
    for (int k = n - 1; k >= 0; --k) {
      T yk = T(0);
#pragma unroll
      for (int q = 0; q < Q; ++q)
        if (lane + 32 * q == k) yk = y[q];
      const T xk = __shfl_sync(0xffffffffu, yk * rinv[k], k & 31);
      const T* rk = Rs + k * ldr;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int i = lane + 32 * q;
        if (i < k)
          y[q] -= rk[i] * xk;
        else if (i == k)
          y[q] = xk;
      }
    }
    T* x_sys = x + sys * n;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int i = lane + 32 * q;
      if (i < n) x_sys[i] = y[q];
    }
  }
}

template <typename T, int H>
int launch_pair(const void* A, const void* b, void* x, int B, int n, cudaStream_t stream) {
  if constexpr (!pair_fits<T>(H)) {
    return (int)cudaErrorInvalidValue;  // no such instance: over the register budget
  } else {
    if (n < 1 || n + 1 > kPairCols || n > 2 * H) return (int)cudaErrorInvalidValue;
    const size_t smem = sizeof(T) * (size_t)pair_elems(H, n);
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          qr_pair_kernel<T, H>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    qr_pair_kernel<T, H><<<B, kThreads, smem, stream>>>(
        static_cast<const T*>(A), static_cast<const T*>(b), static_cast<T*>(x), n);
    return (int)cudaGetLastError();
  }
}

template <typename T>
int dispatch(const void* A, const void* b, void* x, int B, int n, int route, int rows,
             cudaStream_t s) {
  if (route == 0) {
    if (rows != 0) return (int)cudaErrorInvalidValue;
    return launch_block<T>(A, b, x, B, n, s);
  }
  if (route != 1) return (int)cudaErrorInvalidValue;
  switch (rows) {
    case 8: return launch_pair<T, 8>(A, b, x, B, n, s);
    case 16: return launch_pair<T, 16>(A, b, x, B, n, s);
    case 24: return launch_pair<T, 24>(A, b, x, B, n, s);
    case 32: return launch_pair<T, 32>(A, b, x, B, n, s);
    case 40: return launch_pair<T, 40>(A, b, x, B, n, s);
    case 48: return launch_pair<T, 48>(A, b, x, B, n, s);
    case 52: return launch_pair<T, 52>(A, b, x, B, n, s);
    case 64: return launch_pair<T, 64>(A, b, x, B, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = float64. Layouts (row-major, contiguous): A
// (B,n,n), b (B,n), x (B,n). The plan (linear_solve.qr_plan): route 0
// "block" (rows 0), 1 "pair" with `rows` rows per thread (H, one of
// dispatch's cases; n <= 2H, n + 1 <= 128 columns); the dynamic shared
// memory of either route is derived here from n and the dtype. A plan the kernels do not take
// returns cudaErrorInvalidValue and launches nothing. Returns
// cudaGetLastError().
extern "C" int mcp_qr_solve(int dtype, const void* A, const void* b, void* x, int B, int n,
                            int route, int rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(A, b, x, B, n, route, rows, s);
  return dispatch<double>(A, b, x, B, n, route, rows, s);
}
