// Thread-block-cluster primitives for sm_90a, shared by K3
// (solve_aug_slab.cuh) and K8a (qr_sep.cu): the cluster barrier and loads
// and stores in another CTA's shared memory (distributed shared memory).

#pragma once

#include <cuda_runtime.h>

namespace cluster {

// Every thread of the cluster: arrive with release, wait with acquire
// (cluster scope), so the shared-memory stores of any CTA before the barrier
// are visible to every CTA after it.
__device__ __forceinline__ void barrier() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The shared::cluster address of this CTA's shared-memory location p in CTA
// r of the cluster.
__device__ __forceinline__ unsigned addr(const void* p, int r) {
  unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("mapa.shared::cluster.u32 %0, %0, %1;" : "+r"(a) : "r"(r));
  return a;
}

__device__ __forceinline__ void st(unsigned a, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(a), "f"(v) : "memory");
}
__device__ __forceinline__ void st(unsigned a, double v) {
  asm volatile("st.shared::cluster.f64 [%0], %1;" ::"r"(a), "d"(v) : "memory");
}
__device__ __forceinline__ void st(unsigned a, int v) {
  asm volatile("st.shared::cluster.s32 [%0], %1;" ::"r"(a), "r"(v) : "memory");
}

__device__ __forceinline__ float ld(unsigned a, float) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(a) : "memory");
  return v;
}
__device__ __forceinline__ double ld(unsigned a, double) {
  double v;
  asm volatile("ld.shared::cluster.f64 %0, [%1];" : "=d"(v) : "r"(a) : "memory");
  return v;
}

}  // namespace cluster
