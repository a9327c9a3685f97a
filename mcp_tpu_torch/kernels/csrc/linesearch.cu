// K2: fused fraction-to-the-boundary linesearch + iterate update + KKT norm,
// for sm_90a.
//
// Replaces mcp_tpu/kernels/linesearch_pallas.py::_ls_update_kernel (:70),
// with the same semantics, per lane:
//   lin_ok  = dx, ds, dy all finite; a failed direction is zeroed (select,
//             never multiply: 0*NaN = NaN);
//   alpha_s = max over candidates c of c * [all_i c*ds_i >= -tau*s_i]
//             (the first feasible candidate of the halving grid is the
//             largest), alpha_y likewise over (y, dy);
//   ok      = lin_ok && any_s && any_y; the update is scaled by ok*alpha;
//   kkt     = max(|rg|_inf, |rh|_inf, |rc|_inf) at the pre-step point
//             (NaN-propagating, as jnp.max);
//   failed  = !ok.
// The update uses explicitly rounded multiply and add (no FMA contraction),
// so every route equals the plain PyTorch version bit for bit.
//
// Bound on this card: at the main path (B=256, n=200, m=250, float32) the
// kernel reads 9 vectors and writes 3 plus two scalars per lane, ~2.9 MB:
// ~0.9 us at 3.35 TB/s; at the flagships' B=8 (n=1200, m=1470: 0.40 MB;
// n=3000, m=3630: 0.99 MB) 0.12 and 0.29 us. Its compares are negligible.
// What sets the time is latency: every lane is a reduction (finiteness, two
// candidate masks, a maximum) whose result scales the update of the same
// vectors.
//
// Two routes, chosen by the wrapper's plan (linesearch.ls_plan, a plain
// function of B, n, m, the dtype and whether the candidate grid is
// monotone) and checked here against the kernels' own limits. The candidate
// grid (K <= 32 values of the iterate dtype) and every pointer travel in
// one kernel parameter block; the loops over the candidates are unrolled,
// so each candidate is an operand of the constant bank, not a load.
//
// "cluster" (a batch too small to fill the card, the flagships' B = 8; the
// solver's grid, finite, positive and non-increasing): a thread block
// cluster of P CTAs (2..16; 16 needs the non-portable cluster size) per
// lane. Each row is cut into 16-byte chunks and CTA r owns the r-th of P
// contiguous ranges of them; thread t of a CTA of G threads owns chunks
// t + G q, q < Q (the plan's slots), of that range of each of the nine
// rows. It issues every load of its chunks back to back into registers,
// with 16-, 8- or 4-byte vector loads as the rows' alignment allows, then
// reduces finiteness, both candidate masks (by a scan of the grid, scan_of)
// and the maximum in registers and by warp shuffles. Each warp pushes its
// partial results into every CTA's shared memory (distributed shared
// memory stores), ONE cluster barrier with release/acquire makes them
// visible, and every CTA reduces the P x W partials in the same order, so
// all agree, and updates its own range from registers: one pass over
// device memory. No CTA reads another's shared memory after that barrier,
// so none waits at exit. (A relaxed cluster arrive at the start, waited on
// before the pushes, guarantees that every CTA of the cluster runs; its
// wait overlaps the loads.)
//
// "block" (today's kernel; the A/B, a batch that fills the card, and the
// shapes and grids the cluster route does not take): one 256-thread block
// per lane in three passes over the lane (finiteness under
// __syncthreads_and, the masks with a shared atomicAnd, the maximum and the
// update).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <string.h>

#include "cluster.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;   // the block route's block
constexpr int kMaxCands = 32;   // one bit per candidate
constexpr int kMaxGroup = 256;  // threads per CTA of the cluster route
constexpr int kMaxSlots = 4;    // chunks of each row per thread
constexpr int kMaxCluster = 16;
constexpr int kMaxPartials = 32;  // CTAs x warps whose partials one warp reduces
constexpr int kMaxDevices = 64;   // devices whose cluster launches launch_group checks once

// Everything a launch needs, as one kernel parameter.
template <typename T>
struct LSParams {
  const T* in[9];  // x, dx, s, ds, y, dy, rg, rh, rc
  T* xo;
  T* so;
  T* yo;
  T* kkt;
  uint8_t* failed;
  int n, m, K;
  int wn, wm;  // vector width (elements) of the n rows and of the m rows
  int parts;  // CTAs per lane (cluster route), else 1
  T tau;
  T cands[kMaxCands];
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// max that propagates NaN, like jnp.max / torch.amax.
template <typename T>
__device__ __forceinline__ T nanmax(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

// |v| with a positive zero, as torch.abs; NaN stays NaN.
__device__ __forceinline__ float absval(float v) { return fabsf(v); }
__device__ __forceinline__ double absval(double v) { return fabs(v); }

// The candidate-mask loop of one element: bit k of msk cleared where
// c_k * dv >= b fails (NaN fails). The index is uniform across the warp, so
// each candidate is one constant-bank read.
template <typename T>
__device__ __forceinline__ unsigned mask_of(const LSParams<T>& p, T dv, T b, unsigned msk) {
  for (int k = 0; k < p.K; ++k)
    if (!(p.cands[k] * dv >= b)) msk &= ~(1u << k);
  return msk;
}

// The same masks by a scan, for a grid c_0 >= c_1 >= ... > 0, all finite
// (the cluster route's; launch checks it). Rounding is monotone, so for a
// fixed dv the rounded product c * dv is non-decreasing in c when dv > 0
// and non-increasing when dv < 0 (subnormal products included), and the
// test c_k * dv >= b holds on a prefix of the grid (k < k1) when dv > 0
// (b > 0 from s < 0 included: the product grows with c) and on a suffix
// (k >= k0) when dv < 0. When dv = +-0 every product is +-0, so the test
// is 0 >= b for every k. A NaN dv fails every k (the last branch); a NaN b
// (from a NaN v) fails every compare of the first two branches, which then
// run to k1 = 0 or k0 = K, and the third. dv = +-inf gives +-inf for every
// c > 0: one answer for every k. So each element's feasible set is an
// interval, their intersection is [k0, k1) with k0 the largest suffix
// start and k1 the smallest prefix end, and that is bit for bit mask_of's.
// A thread keeps (k0, k1) over its elements and moves a bound only when an
// element's own bound passes it: at most K compares per element, one in
// the common case. cs is the warp's copy of the grid in shared memory (a
// thread's index is its own).
template <typename T>
__device__ __forceinline__ void scan_of(const T* cs, int K, T dv, T b, int& k0, int& k1) {
  if (dv > T(0)) {
    while (k1 > 0 && !(cs[k1 - 1] * dv >= b)) --k1;
  } else if (dv < T(0)) {
    while (k0 < K && !(cs[k0] * dv >= b)) ++k0;
  } else if (!(dv == T(0) && T(0) >= b)) {
    k1 = 0;
  }
}

__device__ __forceinline__ unsigned range_mask(int k0, int k1) {
  return k0 < k1 ? (unsigned)(((1ull << k1) - 1ull) & ~((1ull << k0) - 1ull)) : 0u;
}

// The step lengths from the lane's reduced results.
template <typename T>
__device__ __forceinline__ void step_of(const LSParams<T>& p, bool lin_ok, unsigned ms,
                                        unsigned my, T& sc_s, T& sc_y, bool& ok) {
  const unsigned valid = p.K >= 32 ? 0xffffffffu : ((1u << p.K) - 1u);
  const unsigned fs = ms & valid, fy = my & valid;
  T a_s = T(0), a_y = T(0);
  for (int k = 0; k < p.K; ++k) {
    const T c = p.cands[k];
    if (fs & (1u << k)) a_s = c > a_s ? c : a_s;
    if (fy & (1u << k)) a_y = c > a_y ? c : a_y;
  }
  ok = lin_ok && fs != 0 && fy != 0;
  sc_s = ok ? a_s : T(0);
  sc_y = ok ? a_y : T(0);
}

// ---- Route "block": one 256-thread block per lane, three passes.

template <typename T>
__global__ void __launch_bounds__(kThreads) ls_kernel(const __grid_constant__ LSParams<T> p) {
  __shared__ unsigned mask_s, mask_y;
  __shared__ T red[kThreads / 32];
  const int tid = threadIdx.x, n = p.n, m = p.m;
  const long long ln = blockIdx.x;
  const T* x = p.in[0] + ln * n;
  const T* dx = p.in[1] + ln * n;
  const T* s = p.in[2] + ln * m;
  const T* ds = p.in[3] + ln * m;
  const T* y = p.in[4] + ln * m;
  const T* dy = p.in[5] + ln * m;
  const T* rg = p.in[6] + ln * n;
  const T* rh = p.in[7] + ln * m;
  const T* rc = p.in[8] + ln * m;
  T* xo = p.xo + ln * n;
  T* so = p.so + ln * m;
  T* yo = p.yo + ln * m;

  int fin = 1;
  for (int i = tid; i < n; i += kThreads) fin &= isfinite(dx[i]) ? 1 : 0;
  for (int i = tid; i < m; i += kThreads)
    fin &= (isfinite(ds[i]) && isfinite(dy[i])) ? 1 : 0;
  if (tid == 0) {
    mask_s = 0xffffffffu;
    mask_y = 0xffffffffu;
  }
  const bool lin_ok = __syncthreads_and(fin) != 0;

  const T neg_tau = -p.tau;
  unsigned ms = 0xffffffffu, my = 0xffffffffu;
  for (int i = tid; i < m; i += kThreads) {
    const T dsv = lin_ok ? ds[i] : T(0);
    const T dyv = lin_ok ? dy[i] : T(0);
    ms = mask_of(p, dsv, neg_tau * s[i], ms);
    my = mask_of(p, dyv, neg_tau * y[i], my);
  }
  ms = __reduce_and_sync(0xffffffffu, ms);
  my = __reduce_and_sync(0xffffffffu, my);
  if ((tid & 31) == 0) {
    atomicAnd(&mask_s, ms);
    atomicAnd(&mask_y, my);
  }

  // ‖F‖∞ of the pre-step residual.
  T mx = T(0);
  for (int i = tid; i < n; i += kThreads) mx = nanmax(mx, absval(rg[i]));
  for (int i = tid; i < m; i += kThreads)
    mx = nanmax(mx, nanmax(absval(rh[i]), absval(rc[i])));
  for (int off = 16; off > 0; off >>= 1)
    mx = nanmax(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if ((tid & 31) == 0) red[tid >> 5] = mx;
  __syncthreads();  // masks and partial maxima complete

  T sc_s, sc_y;
  bool ok;
  step_of(p, lin_ok, mask_s, mask_y, sc_s, sc_y, ok);
  for (int i = tid; i < n; i += kThreads)
    xo[i] = add_rn(x[i], mul_rn(sc_s, lin_ok ? dx[i] : T(0)));
  for (int i = tid; i < m; i += kThreads) {
    so[i] = add_rn(s[i], mul_rn(sc_s, lin_ok ? ds[i] : T(0)));
    yo[i] = add_rn(y[i], mul_rn(sc_y, lin_ok ? dy[i] : T(0)));
  }
  if (tid == 0) {
    T k_all = red[0];
    for (int wi = 1; wi < kThreads / 32; ++wi) k_all = nanmax(k_all, red[wi]);
    p.kkt[ln] = k_all;
    p.failed[ln] = ok ? 0 : 1;
  }
}

// ---- Route "cluster": rows in 16-byte chunks held in registers.

template <typename T, int W>
struct VecW;
template <>
struct VecW<float, 1> { using type = float; };
template <>
struct VecW<float, 2> { using type = float2; };
template <>
struct VecW<float, 4> { using type = float4; };
template <>
struct VecW<double, 1> { using type = double; };
template <>
struct VecW<double, 2> { using type = double2; };

// Elements e[0..CH) of a chunk at row[base..], in vectors of W elements
// (W divides the row length and the row is W-element aligned), zero past
// len.
template <typename T, int W, int CH>
__device__ __forceinline__ void load_vecs(const T* __restrict__ row, int base, int len,
                                          T (&e)[CH]) {
  using V = typename VecW<T, W>::type;
#pragma unroll
  for (int k = 0; k < CH / W; ++k) {
    const int i = base + k * W;
    if (i < len) {
      const V v = __ldg(reinterpret_cast<const V*>(row + i));
      memcpy(&e[k * W], &v, sizeof(V));
    } else {
#pragma unroll
      for (int r = 0; r < W; ++r) e[k * W + r] = T(0);
    }
  }
}

template <typename T, int W, int CH>
__device__ __forceinline__ void store_vecs(T* __restrict__ row, int base, int len,
                                           const T (&e)[CH]) {
  using V = typename VecW<T, W>::type;
#pragma unroll
  for (int k = 0; k < CH / W; ++k) {
    const int i = base + k * W;
    if (i < len) {
      V v;
      memcpy(&v, &e[k * W], sizeof(V));
      *reinterpret_cast<V*>(row + i) = v;
    }
  }
}

// Chunk j (elements j*CH..) of a row of len elements when j < jend, else
// zeros; w is the row's vector width.
template <typename T, int CH>
__device__ __forceinline__ void load_chunk(const T* __restrict__ row, int j, int jend, int len,
                                           int w, T (&e)[CH]) {
  if (j < jend) {
    if (w == CH) {
      load_vecs<T, CH>(row, j * CH, len, e);
      return;
    }
    if constexpr (CH == 4) {
      if (w == 2) {
        load_vecs<T, 2>(row, j * CH, len, e);
        return;
      }
    }
    load_vecs<T, 1>(row, j * CH, len, e);
    return;
  }
#pragma unroll
  for (int r = 0; r < CH; ++r) e[r] = T(0);
}

template <typename T, int CH>
__device__ __forceinline__ void store_chunk(T* __restrict__ row, int j, int jend, int len, int w,
                                            const T (&e)[CH]) {
  if (j >= jend) return;
  if (w == CH) {
    store_vecs<T, CH>(row, j * CH, len, e);
    return;
  }
  if constexpr (CH == 4) {
    if (w == 2) {
      store_vecs<T, 2>(row, j * CH, len, e);
      return;
    }
  }
  store_vecs<T, 1>(row, j * CH, len, e);
}

// One warp's (or one lane's) partial results.
template <typename T>
struct Partial {
  int fin;
  unsigned ms, my;
  T mx;
};

template <typename T>
__device__ __forceinline__ Partial<T> warp_reduce(Partial<T> a) {
  a.fin = __all_sync(0xffffffffu, a.fin);
  a.ms = __reduce_and_sync(0xffffffffu, a.ms);
  a.my = __reduce_and_sync(0xffffffffu, a.my);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) a.mx = nanmax(a.mx, __shfl_xor_sync(0xffffffffu, a.mx, off));
  return a;
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// Q chunks of each of the nine rows per thread; G = blockDim.x threads per
// CTA of a cluster of p.parts >= 2 CTAs per lane.
template <typename T, int Q>
__global__ void __launch_bounds__(kMaxGroup)
    ls_group_kernel(const __grid_constant__ LSParams<T> p) {
  constexpr int CH = 16 / sizeof(T);
  __shared__ Partial<T> part[kMaxPartials];
  __shared__ T cands[kMaxGroup / 32][kMaxCands];  // each warp's copy of the grid
  const int G = blockDim.x, W = G >> 5;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = p.n, m = p.m;
  cluster_arrive_relaxed();
  const int P = p.parts;
  const int rank = (int)cg::this_cluster().block_rank();
  const long long ln = blockIdx.x / P;
  // This CTA's chunks of the n rows [jn0, jn1) and of the m rows [jm0, jm1).
  const int Nn = (n + CH - 1) / CH, Nm = (m + CH - 1) / CH;
  const int Sn = (Nn + P - 1) / P, Sm = (Nm + P - 1) / P;
  const int jn0 = rank * Sn, jn1 = min(Nn, jn0 + Sn);
  const int jm0 = rank * Sm, jm1 = min(Nm, jm0 + Sm);

  const T* x = p.in[0] + ln * n;
  const T* dx = p.in[1] + ln * n;
  const T* s = p.in[2] + ln * m;
  const T* ds = p.in[3] + ln * m;
  const T* y = p.in[4] + ln * m;
  const T* dy = p.in[5] + ln * m;
  const T* rg = p.in[6] + ln * n;
  const T* rh = p.in[7] + ln * m;
  const T* rc = p.in[8] + ln * m;

  // Every load first, into registers.
  T xv[Q][CH], dxv[Q][CH], rgv[Q][CH];
  T sv[Q][CH], dsv[Q][CH], yv[Q][CH], dyv[Q][CH], rhv[Q][CH], rcv[Q][CH];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int jn = jn0 + tid + G * q, jm = jm0 + tid + G * q;
    load_chunk(x, jn, jn1, n, p.wn, xv[q]);
    load_chunk(dx, jn, jn1, n, p.wn, dxv[q]);
    load_chunk(rg, jn, jn1, n, p.wn, rgv[q]);
    load_chunk(s, jm, jm1, m, p.wm, sv[q]);
    load_chunk(ds, jm, jm1, m, p.wm, dsv[q]);
    load_chunk(y, jm, jm1, m, p.wm, yv[q]);
    load_chunk(dy, jm, jm1, m, p.wm, dyv[q]);
    load_chunk(rh, jm, jm1, m, p.wm, rhv[q]);
    load_chunk(rc, jm, jm1, m, p.wm, rcv[q]);
  }

  // This thread's partials. Past the row (and past this CTA's range) every
  // value is 0: finite, feasible for every candidate (c*0 >= -tau*0), and
  // no larger than any |r|. When a direction is not finite the lane fails
  // whatever its masks, so the masks use the raw direction.
  const T neg_tau = -p.tau;
  Partial<T> a{1, 0xffffffffu, 0xffffffffu, T(0)};
#pragma unroll
  for (int q = 0; q < Q; ++q) {
#pragma unroll
    for (int e = 0; e < CH; ++e) {
      a.fin &= isfinite(dxv[q][e]) & isfinite(dsv[q][e]) & isfinite(dyv[q][e]);
      a.mx = nanmax(a.mx, nanmax(absval(rgv[q][e]), nanmax(absval(rhv[q][e]), absval(rcv[q][e]))));
    }
  }
  // (This copy loop is not unrolled: unrolled, ptxas spilled in the float64
  // two-slot instance.)
  T* cs = cands[warp];
#pragma unroll 1
  for (int k = 0; k < kMaxCands; ++k)
    if (lane == k && k < p.K) cs[k] = p.cands[k];
  __syncwarp();
  int s0 = 0, s1 = p.K, y0 = 0, y1 = p.K;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
#pragma unroll
    for (int e = 0; e < CH; ++e) {
      scan_of(cs, p.K, dsv[q][e], neg_tau * sv[q][e], s0, s1);
      scan_of(cs, p.K, dyv[q][e], neg_tau * yv[q][e], y0, y1);
    }
  }
  a.ms = range_mask(s0, s1);
  a.my = range_mask(y0, y1);
  a = warp_reduce(a);

  // Every warp of the lane: the lane's result, from the P W partials
  // (2 <= P W <= kMaxPartials) of the cluster's warps.
  cluster_wait();  // every CTA of the cluster runs
  if (lane < P) {
    const Partial<T>* slot = &part[rank * W + warp];
    cluster::st(cluster::addr(&slot->fin, lane), a.fin);
    cluster::st(cluster::addr(&slot->ms, lane), (int)a.ms);
    cluster::st(cluster::addr(&slot->my, lane), (int)a.my);
    cluster::st(cluster::addr(&slot->mx, lane), a.mx);
  }
  cluster::barrier();
  Partial<T> b{1, 0xffffffffu, 0xffffffffu, T(0)};
  if (lane < P * W) b = part[lane];
  a = warp_reduce(b);

  T sc_s, sc_y;
  bool ok;
  const bool lin_ok = a.fin != 0;
  step_of(p, lin_ok, a.ms, a.my, sc_s, sc_y, ok);
  T* xo = p.xo + ln * n;
  T* so = p.so + ln * m;
  T* yo = p.yo + ln * m;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int jn = jn0 + tid + G * q, jm = jm0 + tid + G * q;
    T ox[CH], os[CH], oy[CH];
#pragma unroll
    for (int e = 0; e < CH; ++e) {
      ox[e] = add_rn(xv[q][e], mul_rn(sc_s, lin_ok ? dxv[q][e] : T(0)));
      os[e] = add_rn(sv[q][e], mul_rn(sc_s, lin_ok ? dsv[q][e] : T(0)));
      oy[e] = add_rn(yv[q][e], mul_rn(sc_y, lin_ok ? dyv[q][e] : T(0)));
    }
    store_chunk(xo, jn, jn1, n, p.wn, ox);
    store_chunk(so, jm, jm1, m, p.wm, os);
    store_chunk(yo, jm, jm1, m, p.wm, oy);
  }
  if (rank == 0 && tid == 0) {
    p.kkt[ln] = a.mx;
    p.failed[ln] = ok ? 0 : 1;
  }
}

// The widest vector (elements) that every row of len elements at each of
// ptrs starts on: 16 bytes, 8 or one element.
template <typename T>
int width(int len, const void* const* ptrs, int count) {
  for (int w = 16 / (int)sizeof(T); w > 1; w >>= 1) {
    const size_t bytes = w * sizeof(T);
    bool ok = ((size_t)len * sizeof(T)) % bytes == 0;
    for (int i = 0; i < count; ++i) ok = ok && (reinterpret_cast<uintptr_t>(ptrs[i]) % bytes) == 0;
    if (ok) return w;
  }
  return 1;
}

// Chunks of a row of len elements a CTA of a lane split P ways holds.
template <typename T>
int chunks(int len, int P) {
  constexpr int CH = 16 / sizeof(T);
  return ((len + CH - 1) / CH + P - 1) / P;
}

template <typename T, int Q>
int launch_group(const LSParams<T>& a, int B, int G, int P, cudaStream_t st) {
  auto kernel = ls_group_kernel<T, Q>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * P), 1, 1);
  cfg.blockDim = dim3((unsigned)G, 1, 1);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // Checked once per (device, P, G) of this instance: the attribute and
  // residency (every time on a device past kMaxDevices).
  static unsigned long long checked[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = 1ull << ((31 - __builtin_clz(P)) * 8 + (G / 32 - 1));
  if (dev >= kMaxDevices || !(checked[dev] & bit)) {
    if (P > 8) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return (int)err;
    }
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
    if (dev < kMaxDevices) checked[dev] |= bit;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// What linesearch.py's cached launch configuration holds (ctypes.Structure
// _LSConfig, the same fields in the same order).
struct LSConfig {
  int32_t dtype;    // 0 = float32, 1 = float64
  int32_t route;    // 0 block, 1 cluster
  int32_t group;    // threads per CTA on cluster; 256 on block
  int32_t slots;    // chunks of each row per thread on cluster; 0 on block
  int32_t cluster;  // CTAs per lane: 2..16 on cluster, else 1
  int32_t B, n, m, K;
  int64_t off[5];  // byte offsets of x', s', y', kkt, failed in the output buffer
  double tau;
  double cands[kMaxCands];
};

template <typename T>
static int launch(const LSConfig& c, const unsigned long long* ptr, cudaStream_t st) {
  LSParams<T> a;
  memset(&a, 0, sizeof(a));
  for (int i = 0; i < 9; ++i) a.in[i] = reinterpret_cast<const T*>(ptr[i]);
  char* out = reinterpret_cast<char*>(ptr[9]);
  a.xo = reinterpret_cast<T*>(out + c.off[0]);
  a.so = reinterpret_cast<T*>(out + c.off[1]);
  a.yo = reinterpret_cast<T*>(out + c.off[2]);
  a.kkt = reinterpret_cast<T*>(out + c.off[3]);
  a.failed = reinterpret_cast<uint8_t*>(out + c.off[4]);
  a.n = c.n;
  a.m = c.m;
  a.K = c.K;
  a.tau = (T)c.tau;
  for (int k = 0; k < c.K; ++k) a.cands[k] = (T)c.cands[k];
  const void* nrows[4] = {a.in[0], a.in[1], a.in[6], a.xo};
  const void* mrows[8] = {a.in[2], a.in[3], a.in[4], a.in[5], a.in[7], a.in[8], a.so, a.yo};
  a.wn = width<T>(c.n, nrows, 4);
  a.wm = width<T>(c.m, mrows, 8);
  a.parts = 1;
  if (c.route == 0) {
    if (c.group != kThreads || c.slots != 0 || c.cluster != 1) return (int)cudaErrorInvalidValue;
    ls_kernel<T><<<c.B, kThreads, 0, st>>>(a);
    return (int)cudaGetLastError();
  }
  const int G = c.group, Q = c.slots, P = c.cluster;
  if (c.route != 1 || G < 32 || G > kMaxGroup || (G & (G - 1)) != 0 || Q < 1 || Q > kMaxSlots ||
      P < 2 || P > kMaxCluster || (P & (P - 1)) != 0 || P * (G / 32) > kMaxPartials)
    return (int)cudaErrorInvalidValue;
  if (chunks<T>(c.n, P) > G * Q || chunks<T>(c.m, P) > G * Q) return (int)cudaErrorInvalidValue;
  // The scan (scan_of) takes a finite, positive, non-increasing grid.
  for (int k = 0; k < c.K; ++k) {
    const T ck = a.cands[k];
    if (!(std::isfinite(ck) && ck > T(0) && (k == 0 || ck <= a.cands[k - 1])))
      return (int)cudaErrorInvalidValue;
  }
  a.parts = P;
  switch (Q) {
    case 1: return launch_group<T, 1>(a, c.B, G, P, st);
    case 2: return launch_group<T, 2>(a, c.B, G, P, st);
    case 3: return launch_group<T, 3>(a, c.B, G, P, st);
    case 4: return launch_group<T, 4>(a, c.B, G, P, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// One launch: cfg (the plan, shapes, the candidate grid and the output
// layout, built once per configuration) and ptr[0..11): x, dx, s, ds, y,
// dy, rg, rh, rc (contiguous (B, n) or (B, m), the iterate dtype), the
// output buffer and the stream. A plan the kernels do not take returns
// cudaErrorInvalidValue and launches nothing. Returns cudaGetLastError().
extern "C" int mcp_linesearch_launch(const LSConfig* cfg, const unsigned long long* ptr) {
  const LSConfig& c = *cfg;
  if (c.K < 1 || c.K > kMaxCands || c.B < 0 || c.n < 1 || c.m < 1)
    return (int)cudaErrorInvalidValue;
  if (c.B == 0) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(ptr[10]);
  if (c.dtype == 0) return launch<float>(c, ptr, st);
  if (c.dtype == 1) return launch<double>(c, ptr, st);
  return (int)cudaErrorInvalidValue;
}
