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
// by operations. In practice neither binds: the panels are a serial chain
// of nb reflections each, and the latency of a reflection sets the time.
//
// Two routes, chosen by the wrapper's plan (linear_solve.wy_plan, a plain
// function of the padded n, the panel and the dtype) and checked here
// against the kernels' own limits; one block of 256 threads per system on
// both:
//
// "pair" (float32, panel 8, n + 1 <= 128; K4b's pair layout of
// csrc/qr_dense.cu; in float64 at n = 104 it ran no faster than the block
// route, so it has no float64 instance):
// threads 2c and 2c + 1 (a lane pair) own column c of [A | b] (c < n: A's
// column, c = n: b), each with half its rows in registers, col[r] =
// M[j + h H + r][c] for the pair's half h, j the first row not yet retired
// (rows templated to H in {8, 16, 24, 32, 40, 48, 52, 64}, 2H >= n; rows
// past n are zero padding and stay zero). The 8 columns of a panel are the
// 16 lanes of one half-warp, which factor it warp-synchronously: per
// reflection the owner pair forms u and beta from its registers into one of
// two shared slots, __syncwarp, every pair of the panel reads its half of u
// as broadcast 16-byte vectors and joins its two half dots by one
// __shfl_xor_sync; the pairs right of the owner update and retire a row of
// R, the owner retires R[k][k] and keeps u in its registers, the pairs left
// of it (earlier owners, holding their u) take the dot as larft's U^T u, and
// larft's column of T is formed from those by __shfl_sync, each pair holding
// its row of T. The owners publish U (rows relative to the panel's first
// row, row-major) and T to shared memory; ONE block barrier; every trailing
// pair then applies I - U T U^T to its own column: 8 half dots with U's
// rows, 8 shuffles, T^T from shared memory, the update, and retires the
// panel's 8 rows of R (or Q^T b) to shared memory, shifting its rows up by
// 8. Lookahead: the owners of the next panel update their columns first and
// factor it while the other pairs update theirs, into the other of two U
// and T buffers. So a system costs n/8 + 1 block barriers (14 at n = 104)
// against the block route's ~3n + 2n/8. Then one warp back-substitutes
// from shared memory as K4b's pair route does.
//
// "block" (every other shape; the A/B of the pair route): one thread block
// per system; A (row stride n+1), b, P, U (n x nb), T (nb x nb) and the
// (nb x (n+1)) product T^T U^T [A | b] in shared memory. A reflection's
// norms are warp-shuffle reductions in warp 0, u^T P and U^T u one warp per
// panel column; the product takes one thread per column of [A | b] (U^T
// column in registers, then T^T); the update spreads the trailing block
// over all threads; three block barriers a reflection, two an update.

#include <cuda_runtime.h>

#include "solve_aug_group.cuh"

namespace {

using solve_aug::dsqrt;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPanel = 16;

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
int launch_block(const void* A, const void* b, void* x, int B, int n, int nb,
                 cudaStream_t stream) {
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

// ---- Route "pair": a lane pair per column of [A | b], in registers.

// The pair route's panel (a half-warp of lane pairs) and its columns (one
// pair of threads each).
constexpr int kNb = 8;
constexpr int kPairCols = kThreads / 2;

__host__ __device__ constexpr int round4(int v) { return (v + 3) / 4 * 4; }

// The pair route's shared memory (elements of T): two slots (a panel
// step's u, 2H values, and beta), two buffers of U (2H rows of kNb, rows
// relative to the panel's first row) and of T (kNb x kNb), 1 / R[k][k] (n
// values), and R with Q^T b as its column n, column-major at the odd stride
// n | 1 (R[k][c] at c (n | 1) + k, as K4b's pair route).
__host__ __device__ constexpr int pair_slot_elems(int h) { return round4(2 * h + 4); }
__host__ __device__ constexpr long long pair_elems(int h, int n) {
  return 2LL * pair_slot_elems(h) + 2LL * 2 * h * kNb + 2 * kNb * kNb + round4(n) +
         (long long)(n + 1) * (n | 1);
}

// The reflection of a panel step from the owner pair's column (physical row
// 0 the pivot row): K8a's alpha = -sign(v_0) sqrt(v.v + eps), u = v with
// u_0 = v_0 - alpha, beta = 2 / (u.u + eps) (0 when u.u <= eps), each half's
// sums in four partial sums joined by __shfl_xor_sync; each half stores its
// rows of u into the slot, slot[2H] = beta.
template <typename T, int H>
__device__ __forceinline__ void wy_form(T* slot, const T (&col)[H], int h, int lane, unsigned pm) {
  using solve_aug_group::pack;
  using V = typename solve_aug_warp::Vec<T>::type;
  constexpr int nv = solve_aug_warp::Vec<T>::n;
  const T eps = T(1e-30);
  T s[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const T v = (i == 0 && h == 0) ? T(0) : col[i];
    s[i & 3] += v * v;
  }
  const T rest = (s[0] + s[1]) + (s[2] + s[3]);  // this half's rows but the pivot
  const T vk = __shfl_sync(pm, col[0], lane & ~1);
  T ss = h == 0 ? rest + vk * vk : rest;
  ss += __shfl_xor_sync(pm, ss, 1);
  const T norm = dsqrt(ss + eps);
  const T alpha = vk >= T(0) ? -norm : norm;
  const T u0 = vk - alpha;
  T uu = h == 0 ? rest + u0 * u0 : rest;
  uu += __shfl_xor_sync(pm, uu, 1);
  V* d = reinterpret_cast<V*>(slot + h * H);
#pragma unroll
  for (int q = 0; q < H / nv; ++q) {
    T e[nv];
#pragma unroll
    for (int r = 0; r < nv; ++r) e[r] = col[nv * q + r];
    if (q == 0 && h == 0) e[0] = u0;
    d[q] = pack(e);
  }
  if (h == 0) slot[2 * H] = uu > eps ? T(2) / (uu + eps) : T(0);
}

// Factor the panel whose first row and column is j0, by its 8 lane pairs (a
// half-warp; kc = c - j0 this pair's column in it), each column at physical
// row 0 = row j0 on entry. Per step k: the update of columns k.. (the
// owner's own giving R[k][k]), the retirement of row j0 + k of R, the
// shift by one row; the owner then holds u_k (shifted with the others), so
// that at later steps its dot with the step's u is larft's U^T u. The
// owners write U and T (row kc of T by pair kc) into the buffers U and Tm.
// The steps are a runtime loop: one copy of the step's code.
template <typename T, int H>
__device__ __forceinline__ void wy_factor(T (&col)[H], int kc, int h, int lane, unsigned pm,
                                          unsigned hm, T* slot, T* U, T* Tm, T* Rs, T* rinv,
                                          int ldr, int j0) {
  using solve_aug_group::dot4;
  using solve_aug_group::unpack;
  using V = typename solve_aug_warp::Vec<T>::type;
  constexpr int nv = solve_aug_warp::Vec<T>::n;
  constexpr int SL = pair_slot_elems(H);
  const int c = j0 + kc;
  T* trow = Tm + kc * kNb;
  if (h == 0) {
#pragma unroll
    for (int q = 0; q < kNb; ++q) {
      trow[q] = T(0);
      if (q < kc) U[q * kNb + kc] = T(0);  // U is zero above its diagonal
    }
  }
#pragma unroll 1
  for (int k = 0; k < kNb; ++k) {
    T* u = slot + (k & 1) * SL;
    const bool own = kc == k, live = kc > k;
    if (own) wy_form<T, H>(u, col, h, lane, pm);
    __syncwarp(hm);
    const T beta = u[2 * H];
    T w = dot4<T, H>(col, u + h * H);
    w += __shfl_xor_sync(pm, w, 1);
    const T bw = beta * w;
    const V* uv = reinterpret_cast<const V*>(u + h * H);
    T top = T(0), cross = T(0);
#pragma unroll
    for (int q = 0; q < H / nv; ++q) {
      T e[nv];
      unpack(uv[q], e);
#pragma unroll
      for (int r = 0; r < nv; ++r) {
        const int i = nv * q + r;
        const T upd = col[i] - e[r] * bw;
        const T v = live ? upd : (own ? e[r] : col[i]);
        // Column k of U (rows relative to j0) from the owner's registers.
        if (own && k + h * H + i < 2 * H) U[(k + h * H + i) * kNb + k] = e[r];
        if (i == 0) {
          top = upd;
          cross = v;
        } else {
          col[i - 1] = v;
        }
      }
    }
    // The lower half's top row moves to the bottom of the upper half.
    const T up = __shfl_xor_sync(pm, cross, 1);
    col[H - 1] = h == 0 ? up : T(0);
    if (own && h == 0) rinv[j0 + k] = T(1) / top;
    if (h == 0 && kc >= k) Rs[c * ldr + j0 + k] = top;
    // larft: T[p][k] = -beta sum_q T[p][q] (U^T u)_q over the earlier
    // owners q, T[k][k] = beta.
    T acc = T(0);
#pragma unroll
    for (int q = 0; q < kNb - 1; ++q) {
      const T z = __shfl_sync(hm, w, (lane & 16) + 2 * q);
      if (q < k) acc += trow[q] * z;
    }
    if (h == 0) {
      if (kc < k) trow[k] = -beta * acc;
      if (own) trow[k] = beta;
    }
  }
}

// Rows of U that wy_apply loads at a time: 32 registers of U, then a
// __syncwarp of the pair, which no load is moved across. Without it the
// compiler issued every row's loads at once (8H values for each pass, the
// second pass's ahead of the first: over the register budget, spilled).
template <typename T>
__host__ __device__ constexpr int apply_rows() {
  return 16 / (int)sizeof(T);
}

// A trailing column (physical row 0 = row j0) takes the panel's block
// reflector: col -= U (T^T (U^T col)); its rows j0.. j0 + 7 retire to R
// (or Q^T b) and the rest shift up by 8.
template <typename T, int H>
__device__ __forceinline__ void wy_apply(T (&col)[H], int h, unsigned pm, const T* U,
                                         const T* Tm, T* Rs, int ldr, int c, int j0) {
  using solve_aug_group::unpack;
  using V = typename solve_aug_warp::Vec<T>::type;
  constexpr int nv = solve_aug_warp::Vec<T>::n;
  constexpr int RG = apply_rows<T>();
  const V* u = reinterpret_cast<const V*>(U + h * H * kNb);
  T y[kNb];
#pragma unroll
  for (int q = 0; q < kNb; ++q) y[q] = T(0);
#pragma unroll
  for (int r = 0; r < H; ++r) {
#pragma unroll
    for (int q = 0; q < kNb / nv; ++q) {
      T e[nv];
      unpack(u[r * (kNb / nv) + q], e);
#pragma unroll
      for (int t = 0; t < nv; ++t) y[nv * q + t] += e[t] * col[r];
    }
    if (r % RG == RG - 1) __syncwarp(pm);
  }
#pragma unroll
  for (int q = 0; q < kNb; ++q) y[q] += __shfl_xor_sync(pm, y[q], 1);
  __syncwarp(pm);  // T's loads after the first pass's
  // z = T^T y, in place from the last entry: z_p = sum_{q <= p} T[q][p] y_q.
#pragma unroll
  for (int p = kNb - 1; p >= 0; --p) {
    T acc = T(0);
#pragma unroll
    for (int q = 0; q <= p; ++q) acc += Tm[q * kNb + p] * y[q];
    y[p] = acc;
  }
  __syncwarp(pm);
  T top[kNb];
#pragma unroll
  for (int r = 0; r < H; ++r) {
    T acc = T(0);
#pragma unroll
    for (int q = 0; q < kNb / nv; ++q) {
      T e[nv];
      unpack(u[r * (kNb / nv) + q], e);
#pragma unroll
      for (int t = 0; t < nv; ++t) acc += e[t] * y[nv * q + t];
    }
    const T v = col[r] - acc;
    if (r < kNb)
      top[r] = v;
    else
      col[r - kNb] = v;
    if (r % RG == RG - 1) __syncwarp(pm);
  }
#pragma unroll
  for (int i = 0; i < kNb; ++i) {
    const T up = __shfl_xor_sync(pm, top[i], 1);
    col[H - kNb + i] = h == 0 ? up : T(0);
    if (h == 0) Rs[c * ldr + j0 + i] = top[i];
  }
}

// Float32 up to H = 52: two blocks an SM (B = 256 systems on 132 SMs in one
// wave).
template <typename T, int H>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 && H <= 52 ? 2 : 1) wy_pair_kernel(
    const T* __restrict__ A, const T* __restrict__ b, T* __restrict__ x, int n) {
  constexpr int SL = pair_slot_elems(H);
  constexpr int UL = 2 * H * kNb;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* slot = reinterpret_cast<T*>(smem_raw);  // slot q at slot + q SL
  T* Ub = slot + 2 * SL;                     // U buffer q at Ub + q UL
  T* Tb = Ub + 2 * UL;                       // T buffer q at Tb + q kNb^2
  T* rinv = Tb + 2 * kNb * kNb;
  T* Rs = rinv + round4(n);
  const int ldr = n | 1;
  const int tid = threadIdx.x;
  const int c = tid >> 1, h = tid & 1, lane = tid & 31;
  const unsigned pm = 3u << (lane & ~1);       // the pair's lanes
  const unsigned hm = 0xffffu << (lane & 16);  // the half-warp's (a panel's) lanes
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
  // Step p applies panel p (buffers p & 1) to the columns right of it and
  // factors panel p + 1 (buffers (p + 1) & 1) on its owners, who update
  // their columns first; step -1 only factors panel 0.
  const int npan = n / kNb;
  for (int p = -1; p < npan; ++p) {
    const int j0 = p * kNb, jn = j0 + kNb;
    if (c >= jn && c <= n) {
      if (p >= 0)
        wy_apply<T, H>(col, h, pm, Ub + (p & 1) * UL, Tb + (p & 1) * kNb * kNb, Rs, ldr, c, j0);
      if (c < n && c < jn + kNb)
        wy_factor<T, H>(col, c - jn, h, lane, pm, hm, slot, Ub + ((p + 1) & 1) * UL,
                        Tb + ((p + 1) & 1) * kNb * kNb, Rs, rinv, ldr, jn);
    }
    __syncthreads();
  }

  // Back substitution R x = Q^T b on warp 0, column by column (K4b's pair
  // route): lane l holds y_i, i = l + 32 q (y = Q^T b, then x_i once row i
  // is solved); x_k = y_k (1 / R[k][k]) from its owner lane by __shfl_sync,
  // then y_i -= R[i][k] x_k for i < k.
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

template <int H>
int launch_pair(const void* A, const void* b, void* x, int B, int n, cudaStream_t stream) {
  if (n < kNb || n % kNb != 0 || n + 1 > kPairCols || n > 2 * H)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)pair_elems(H, n);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        wy_pair_kernel<float, H>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  wy_pair_kernel<float, H><<<B, kThreads, smem, stream>>>(
      static_cast<const float*>(A), static_cast<const float*>(b), static_cast<float*>(x), n);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* A, const void* b, void* x, int B, int n, int nb, int route, int rows,
             cudaStream_t s) {
  if (route == 0) {
    if (rows != 0) return (int)cudaErrorInvalidValue;
    return launch_block<T>(A, b, x, B, n, nb, s);
  }
  if (route != 1 || nb != kNb || sizeof(T) != sizeof(float)) return (int)cudaErrorInvalidValue;
  switch (rows) {
    case 8: return launch_pair<8>(A, b, x, B, n, s);
    case 16: return launch_pair<16>(A, b, x, B, n, s);
    case 24: return launch_pair<24>(A, b, x, B, n, s);
    case 32: return launch_pair<32>(A, b, x, B, n, s);
    case 40: return launch_pair<40>(A, b, x, B, n, s);
    case 48: return launch_pair<48>(A, b, x, B, n, s);
    case 52: return launch_pair<52>(A, b, x, B, n, s);
    case 64: return launch_pair<64>(A, b, x, B, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = float64. Layouts (row-major, contiguous): A
// (B,n,n), b (B,n), x (B,n), n a multiple of the panel width nb <= 16. The
// plan (linear_solve.wy_plan): route 0 "block" (rows 0), 1 "pair" (float32,
// nb = 8) with `rows` rows per thread (H, one of dispatch's cases; n <= 2H,
// n + 1 <= 128 columns); the dynamic shared memory of either route is
// derived here from n, nb and the dtype. A plan the kernels do not take returns
// cudaErrorInvalidValue and launches nothing. Returns cudaGetLastError().
extern "C" int mcp_wy_solve(int dtype, const void* A, const void* b, void* x, int B, int n,
                            int nb, int route, int rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(A, b, x, B, n, nb, route, rows, s);
  return dispatch<double>(A, b, x, B, n, nb, route, rows, s);
}
