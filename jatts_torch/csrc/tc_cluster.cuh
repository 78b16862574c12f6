// Thread-block-cluster building blocks shared by the backward kernels whose
// blocks exchange partial products through distributed shared memory
// (flash_attn_bwd_tc_f32.cu, flash_attn_bwd_tc_relpos.cu), on
// tc_common.cuh: the block's rank and the cluster barrier, a peer's address
// of a shared variable, st.async pushes and acknowledgements counted by the
// receiver's mbarrier, the cluster-scope wait on them, the consumer
// warpgroup's own barrier, and the exchange-slot rule. sm_90a.

#pragma once

#include "tc_common.cuh"

namespace {

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// the address of this block's shared address `addr` in block `rank` of the cluster
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// 16 bytes into another block's shared memory, asynchronously: that block's
// mbarrier `bar` (both cluster addresses) counts them (complete_tx) once they
// have landed, so the sender never waits for the store
__device__ __forceinline__ void st_async4(uint32_t addr, float a, float b, float c, float d, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];"
               ::"r"(addr), "f"(a), "f"(b), "f"(c), "f"(d), "r"(bar) : "memory");
}

// 4 bytes into another block's shared memory, counted by its mbarrier `bar`
// as above: an acknowledgement that costs no fence (an mbarrier arrive with
// release at cluster scope takes ~2500 cycles on an H100)
__device__ __forceinline__ void st_async_ack(uint32_t addr, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];" ::"r"(addr), "r"(1u),
               "r"(bar) : "memory");
}

// mbar_wait with acquire at cluster scope, for the exchange's barriers (a
// CTA-scope acquire reads the same time on an H100)
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred p;\n"
      "WAITX:\n"
      " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAITX;\n}"
      ::"r"(smem_u32(bar)), "r"(parity) : "memory");
}

// the consumer warpgroup's own barrier (warps 0-3; barrier 0 is __syncthreads)
__device__ __forceinline__ void consumer_sync() { asm volatile("bar.sync 1, 128;" ::: "memory"); }

__device__ __forceinline__ float4 ld_shared4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];" : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr)
               : "memory");
  return v;
}

// a receiver's exchange slot for the partial of sender `from` (every rank
// but its own, in rank order)
__device__ __forceinline__ int slot_of(int from, int to) { return from < to ? from : from - 1; }

}  // namespace
