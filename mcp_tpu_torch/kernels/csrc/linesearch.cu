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
// so it equals the plain PyTorch version bit for bit.
//
// Bound on this card: at the main path (B=256, n=200, m=250, float32) the
// kernel reads 9 vectors and writes 3 plus two scalars per lane, ~2.9 MB:
// ~0.9 us at 3.35 TB/s; its few million compares are negligible. Launch
// latency dominates at this size.
//
// Design: one thread block per lane; each thread keeps a bit mask of the
// candidates its elements admit, reduced across the block with
// __reduce_and_sync and a shared atomicAnd; the all-finite test is
// __syncthreads_and. Written in CUDA C++ rather than Triton so that both
// kernels of the main path share one build route (nvcc + ctypes) and the
// machine needs no Triton JIT at run time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

template <typename T>
__device__ __forceinline__ T absval(T v) {
  return v >= T(0) ? v : -v;  // NaN stays NaN
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ls_kernel(
    const T* __restrict__ x, const T* __restrict__ dx, const T* __restrict__ s,
    const T* __restrict__ ds, const T* __restrict__ y, const T* __restrict__ dy,
    const T* __restrict__ rg, const T* __restrict__ rh, const T* __restrict__ rc,
    const T* __restrict__ cands, int K, T tau, int n, int m,
    T* __restrict__ xo, T* __restrict__ so, T* __restrict__ yo,
    T* __restrict__ kkt, uint8_t* __restrict__ failed) {
  __shared__ unsigned mask_s, mask_y;
  __shared__ T red[kThreads / 32];
  const int tid = threadIdx.x;
  const long long ln = blockIdx.x;
  x += ln * n; dx += ln * n; rg += ln * n; xo += ln * n;
  s += ln * m; ds += ln * m; y += ln * m; dy += ln * m;
  rh += ln * m; rc += ln * m; so += ln * m; yo += ln * m;

  int fin = 1;
  for (int i = tid; i < n; i += kThreads) fin &= isfinite(dx[i]) ? 1 : 0;
  for (int i = tid; i < m; i += kThreads)
    fin &= (isfinite(ds[i]) && isfinite(dy[i])) ? 1 : 0;
  if (tid == 0) {
    mask_s = 0xffffffffu;
    mask_y = 0xffffffffu;
  }
  const bool lin_ok = __syncthreads_and(fin) != 0;

  const T neg_tau = -tau;
  unsigned ms = 0xffffffffu, my = 0xffffffffu;
  for (int i = tid; i < m; i += kThreads) {
    const T dsv = lin_ok ? ds[i] : T(0);
    const T dyv = lin_ok ? dy[i] : T(0);
    const T bs = neg_tau * s[i];
    const T by = neg_tau * y[i];
    for (int k = 0; k < K; ++k) {
      const T c = cands[k];
      if (!(c * dsv >= bs)) ms &= ~(1u << k);
      if (!(c * dyv >= by)) my &= ~(1u << k);
    }
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

  const unsigned valid = K >= 32 ? 0xffffffffu : ((1u << K) - 1u);
  const unsigned fs = mask_s & valid, fy = mask_y & valid;
  T a_s = T(0), a_y = T(0);
  for (int k = 0; k < K; ++k) {
    if (fs & (1u << k)) a_s = cands[k] > a_s ? cands[k] : a_s;
    if (fy & (1u << k)) a_y = cands[k] > a_y ? cands[k] : a_y;
  }
  const bool ok = lin_ok && fs != 0 && fy != 0;
  const T sc_s = ok ? a_s : T(0);
  const T sc_y = ok ? a_y : T(0);

  for (int i = tid; i < n; i += kThreads)
    xo[i] = add_rn(x[i], mul_rn(sc_s, lin_ok ? dx[i] : T(0)));
  for (int i = tid; i < m; i += kThreads) {
    so[i] = add_rn(s[i], mul_rn(sc_s, lin_ok ? ds[i] : T(0)));
    yo[i] = add_rn(y[i], mul_rn(sc_y, lin_ok ? dy[i] : T(0)));
  }
  if (tid == 0) {
    T k_all = red[0];
    for (int wi = 1; wi < kThreads / 32; ++wi) k_all = nanmax(k_all, red[wi]);
    kkt[ln] = k_all;
    failed[ln] = ok ? 0 : 1;
  }
}

template <typename T>
int launch(const void* const* in, const void* cands, int K, double tau, int B,
           int n, int m, void* const* out, cudaStream_t stream) {
  ls_kernel<T><<<B, kThreads, 0, stream>>>(
      static_cast<const T*>(in[0]), static_cast<const T*>(in[1]),
      static_cast<const T*>(in[2]), static_cast<const T*>(in[3]),
      static_cast<const T*>(in[4]), static_cast<const T*>(in[5]),
      static_cast<const T*>(in[6]), static_cast<const T*>(in[7]),
      static_cast<const T*>(in[8]), static_cast<const T*>(cands), K, (T)tau,
      n, m, static_cast<T*>(out[0]), static_cast<T*>(out[1]),
      static_cast<T*>(out[2]), static_cast<T*>(out[3]),
      static_cast<uint8_t*>(out[4]));
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = float64. Contiguous (B, n) x, dx, rg; (B, m) s,
// ds, y, dy, rh, rc; cands (K <= 32) in the iterate dtype. Outputs x', s',
// y' (B, n)/(B, m), kkt (B,), failed (B,) as bytes. Returns
// cudaGetLastError().
extern "C" int mcp_linesearch_update(
    int dtype, const void* x, const void* dx, const void* s, const void* ds,
    const void* y, const void* dy, const void* rg, const void* rh,
    const void* rc, const void* cands, int K, double tau, int B, int n, int m,
    void* xo, void* so, void* yo, void* kkt, void* failed, void* stream) {
  const void* in[9] = {x, dx, s, ds, y, dy, rg, rh, rc};
  void* out[5] = {xo, so, yo, kkt, failed};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(in, cands, K, tau, B, n, m, out, st);
  return launch<double>(in, cands, K, tau, B, n, m, out, st);
}
