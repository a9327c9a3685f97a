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
// by operations too. That rate counts a fused multiply-add as two
// operations; an elimination that rounds the product and the difference
// apart issues two instructions for them, so it can reach half of it.
//
// Two routes, chosen by the wrapper's plan (linear_solve.gj_plan, a plain
// function of n, the inverse flag and the dtype) and checked here against
// the kernels' own limits:
//
// "tile" (n <= 128): one block of 256 threads per system, an 8 x 32 grid;
// thread (ty, tx) holds rows i = ty (mod 8) and slots j = tx (mod 32) of the
// n + 1 slots of [A | b] in registers (rows templated to R = 2..16 per
// thread, R = ceil(n/8) rounded up to even). The cyclic distribution keeps
// the live slots balanced as the pivot moves. K5 works in place: slot k
// holds column k of A until step k, whose multipliers it gives, and identity
// column k from step k on (identity column k is e_k until step k, the first
// step whose update reaches it), so [A | b | I] takes n + 1 slots, not
// 2n + 1, and at the end slot j < n holds column j of A^-1. Step k takes one
// barrier: at the end of step k-1 the owners of column k (lane k mod 32 of
// every warp) and of row k (warp k mod 8) write them into one half of a
// double-buffered pair of shared vectors; after the barrier every thread
// reads the pivot M[k][k] and computes 1/p itself, forms f_i = M[i][k] * (1/p)
// for its own rows and updates its own slots with the same operations in the
// same order as the plain version, so the result is bit for bit the same.
// x and A^-1 are stored coalesced (a warp holds 32 consecutive slots of a
// row).
//
// "block" (n > 128): one thread block per system, the whole augmented
// matrix in shared memory (row stride n+1 or 2n+1, odd, so column walks hit
// distinct banks; above 48 KB by dynamic shared memory after
// cudaFuncSetAttribute). Each step stages the multipliers and row k in
// shared vectors, then updates only the live columns: right of the pivot
// (the columns already eliminated feed no output; x and A^-1 are the
// columns right of A) and, for K5, left of identity column k+1 (row k is 0
// on the identity columns after it, so the update would leave them as they
// are).

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
int launch_block(const void* A, const void* b, void* x, void* inv, int B, int n,
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

// ---- Route "tile": the n + 1 slots of [A | b] cyclically over an 8 x 32
// thread grid, in registers.

constexpr int kTY = 8, kTX = 32;
// The tile's register budget: R x C values plus row k's C values and the
// R multipliers, in 32-bit registers (linear_solve.TILE_REGS).
constexpr int kTileRegs = 208;

__host__ __device__ constexpr int tile_cols(int rows) { return (kTY * rows + kTX) / kTX; }

template <typename T>
__host__ __device__ constexpr bool tile_fits(int rows) {
  return ((rows + 1) * tile_cols(rows) + rows) * (int)(sizeof(T) / 4) <= kTileRegs;
}

template <typename T>
__device__ __forceinline__ T clamped_inverse(T p) {
  return T(1) / ((p >= T(0) ? p : -p) > T(1e-30) ? p : T(1e-30));
}

// Two blocks a SM where the float32 tile leaves room (B = 256 systems on
// 132 SMs).
template <typename T, bool kInverse, int R>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 && R <= 14 ? 2 : 1) gj_tile_kernel(
    const T* __restrict__ A, const T* __restrict__ b, T* __restrict__ x,
    T* __restrict__ inv, int n) {
  constexpr int C = tile_cols(R);
  __shared__ T colbuf[2][kTY * R];  // column k of step k: rows
  __shared__ T rowbuf[2][kTX * C];  // row k of step k: slots
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  const long long sys = blockIdx.x;
  const T* A_sys = A + sys * n * n;
  const T* b_sys = b + sys * n;

  // M[r][c] is row kTY r + ty, slot kTX c + tx: column j < n of A, b at
  // slot n (K5: identity column j from step j on).
  T M[R][C];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = kTY * r + ty;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = kTX * c + tx;
      T v = T(0);
      if (i < n) {
        if (j < n)
          v = A_sys[(long long)i * n + j];
        else if (j == n)
          v = b_sys[i];
      }
      M[r][c] = v;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) colbuf[0][kTY * r + ty] = M[r][0];
  }
  if (ty == 0) {
#pragma unroll
    for (int c = 0; c < C; ++c) rowbuf[0][kTX * c + tx] = M[0][c];
  }
  __syncthreads();

  // Padding rows (i >= n) and slots (j > n) hold zeros and feed nothing
  // back (no pivot comes from them), and for K4a the dead slots left of
  // the pivot feed no output either, so every step updates the whole tile
  // but the slot groups that are all dead: no per-element test.
  for (int k = 0; k < n; ++k) {
    const int buf = k & 1;
    const T ik = clamped_inverse(colbuf[buf][k]);
    T rk[C];
#pragma unroll
    for (int c = 0; c < C; ++c) rk[c] = rowbuf[buf][kTX * c + tx];
    if (kInverse) {
      // Slot k turns from column k of A (read above, through colbuf) into
      // identity column k: e_k, so row k's entry is 1. (Every runtime choice
      // of a slot or row compares the thread's own index, tx + kTX c or
      // ty + kTY r: a test of c or r alone lets the compiler index the tile
      // at run time, which sends it to local memory.)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (kTX * c + tx != k) continue;
        rk[c] = T(1);
#pragma unroll
        for (int r = 0; r < R; ++r) M[r][c] = T(0);
      }
    }
    T f[R];
#pragma unroll
    for (int r = 0; r < R; ++r) f[r] = mul_rn(colbuf[buf][kTY * r + ty], ik);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (!kInverse && kTX * c + kTX - 1 <= k) continue;  // the whole group is dead
#pragma unroll
      for (int r = 0; r < R; ++r) M[r][c] = sub_rn(M[r][c], mul_rn(f[r], rk[c]));
    }
    // Row k (one warp's, warp-uniform) is row k times 1/p instead.
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (kTY * r + ty != k) continue;
#pragma unroll
      for (int c = 0; c < C; ++c) M[r][c] = mul_rn(rk[c], ik);
    }
    // Column k+1 and row k+1 for the next step, into the other buffer.
    const int k1 = k + 1;
    if (k1 < n) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (kTX * c + tx != k1) continue;
#pragma unroll
        for (int r = 0; r < R; ++r) colbuf[buf ^ 1][kTY * r + ty] = M[r][c];
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (kTY * r + ty != k1) continue;
#pragma unroll
        for (int c = 0; c < C; ++c) rowbuf[buf ^ 1][kTX * c + tx] = M[r][c];
      }
    }
    __syncthreads();
  }

  if (kInverse) {
    T* inv_sys = inv + sys * n * n;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = kTY * r + ty;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j = kTX * c + tx;
        if (i < n && j < n) inv_sys[(long long)i * n + j] = M[r][c];
      }
    }
  }
  T* x_sys = x + sys * n;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (kTX * c + tx != n) continue;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = kTY * r + ty;
      if (i < n) x_sys[i] = M[r][c];
    }
  }
}

template <typename T, bool kInverse, int R>
int launch_tile(const void* A, const void* b, void* x, void* inv, int B, int n,
                cudaStream_t stream) {
  if constexpr (!tile_fits<T>(R)) {
    return (int)cudaErrorInvalidValue;  // no such instance: over the register budget
  } else {
    if (n < 1 || n > kTY * R || n + 1 > kTX * tile_cols(R)) return (int)cudaErrorInvalidValue;
    gj_tile_kernel<T, kInverse, R><<<B, kThreads, 0, stream>>>(
        static_cast<const T*>(A), static_cast<const T*>(b), static_cast<T*>(x),
        static_cast<T*>(inv), n);
    return (int)cudaGetLastError();
  }
}

template <typename T, bool kInverse>
int dispatch(const void* A, const void* b, void* x, void* inv, int B, int n, int route,
             int rows, cudaStream_t s) {
  if (route == 0) {
    if (rows != 0) return (int)cudaErrorInvalidValue;
    return launch_block<T, kInverse>(A, b, x, inv, B, n, s);
  }
  if (route != 1) return (int)cudaErrorInvalidValue;
  switch (rows) {
    case 2: return launch_tile<T, kInverse, 2>(A, b, x, inv, B, n, s);
    case 4: return launch_tile<T, kInverse, 4>(A, b, x, inv, B, n, s);
    case 6: return launch_tile<T, kInverse, 6>(A, b, x, inv, B, n, s);
    case 8: return launch_tile<T, kInverse, 8>(A, b, x, inv, B, n, s);
    case 10: return launch_tile<T, kInverse, 10>(A, b, x, inv, B, n, s);
    case 12: return launch_tile<T, kInverse, 12>(A, b, x, inv, B, n, s);
    case 14: return launch_tile<T, kInverse, 14>(A, b, x, inv, B, n, s);
    case 16: return launch_tile<T, kInverse, 16>(A, b, x, inv, B, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = float64. Layouts (row-major, contiguous): A
// (B,n,n), b (B,n), x (B,n), inv (B,n,n) or null. With inv null the kernel
// eliminates [A | b] (K4a); otherwise [A | b | I] and writes A^-1 (K5). The
// plan (linear_solve.gj_plan): route 0 "block" (rows 0), 1 "tile" with
// `rows` rows per thread (even, 2..16, n <= 8 rows); a plan the kernels do
// not take returns cudaErrorInvalidValue and launches nothing. Returns
// cudaGetLastError().
extern "C" int mcp_gj_solve(int dtype, const void* A, const void* b, void* x,
                            void* inv, int B, int n, int route, int rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (inv == nullptr) {
    if (dtype == 0) return dispatch<float, false>(A, b, x, inv, B, n, route, rows, s);
    return dispatch<double, false>(A, b, x, inv, B, n, route, rows, s);
  }
  if (dtype == 0) return dispatch<float, true>(A, b, x, inv, B, n, route, rows, s);
  return dispatch<double, true>(A, b, x, inv, B, n, route, rows, s);
}
