// K1b's dk/dv backward in bf16 on Hopper's tensor cores (sm_90a), plain C
// interface.
//
// Replaces, for VALL-E AR's form (bf16, causal, d_qk = d_v = 64, a key mask,
// no bias), the Pallas TPU kernel `_flash_attention_dkv_kernel`
// (jax/experimental/pallas/ops/tpu/flash_attention.py:796; pallas_call at
// :1121) with causal=True: the element mask at :877-885 and the block skip
// at :924. VALL-E's AR trunk drives it (jatts_tpu/modules/valle_modules.py:101)
// through the custom VJP of jatts_tpu/modules/attention.py:_flash_attend. It
// computes exactly what flash_attn_bwd_dkv_kernel<bf16, 64, true>
// (flash_attn_bwd.cu) computes, per (b, h):
//
//     p = exp(s - lse) on the keys a row sees, 0 elsewhere
//     dv = p^T . do        dp = do . v^T        ds = p * (dp - di) * sm_scale
//     dk = ds^T . q
//
// with s = q . k^T * sm_scale, lse the forward's row log-sum-exp (+inf on a
// row that sees no key, so its p is 0) and di = rowsum(o * do), both f32 from
// the wrapper. Query row i sees key j when j <= i (Tq == Tk, top-left
// aligned) and the key's mask byte is nonzero; keys past Tk are never seen.
//
// Numerics: all four products accumulate in f32 on the tensor cores; p and
// ds are computed in f32 on the accumulator fragments (in the base-2
// domain: p = exp2(s * sm_scale * log2 e - lse * log2 e)) and rounded to
// bf16 only as the A operands of their products, where the scalar kernel
// keeps them in f32: the one difference. dk and dv are rounded once to bf16.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16), at VALL-E AR's
// attention (B,H,T,d = 16,16,1088,64, every key valid): reading q, k, v, do
// and writing dk, dv (6 x 35.7 MB), lse and di (2 x 1.1 MB) is 216.2 MB ->
// 0.0645 ms; the causal half of four products (s again, dp, dv, dk) is 77.6
// GFLOP -> 0.0784 ms by operations. The scalar kernel did them as f32 FMAs on
// the CUDA cores (67 TFLOP/s), bf16 widened to f32 in shared memory by
// synchronous loads and p, ds round-tripped through shared memory: 57x off.
//
// Design (the FlashAttention-2/3 dk/dv form on flash_attn_fwd_tc.cu's
// machinery, tc_common.cuh):
// - One block a 64-key tile of one (b, h): warps 0-3 are one consumer
//   warpgroup, warp 4 the producer. Grid (ceil(Tk/64), B*H). Causal: key
//   tile k0 loops over the query tiles q0 = k0, k0 + 64, ... < Tq (no earlier
//   row sees its keys), so tile 0 is the heaviest and already comes first.
// - The k and v tiles stay resident (one TMA'd 64 x 64 slab each). The q and
//   do tiles of each query tile stream through a ring of R stages (a q slab
//   and a do slab, 16 KB) with a full and an empty mbarrier each; the
//   producer also writes the stage's 64 lse * log2 e and 64 di values
//   (plain loads, +inf / 0 past Tq) into a small shared array, and every
//   producer lane arrives on the full barrier after its stores (lane 0 with
//   the TMA's byte count), which releases them to the consumers.
// - Per query tile, all products wgmma m64n64k16 (keys x queries):
//     S^T  = K . Q^T   A = the k slab, B = the q slab, both K-major;
//     dP^T = V . dO^T  A = the v slab, B = the do slab, both K-major;
//     dV  += P^T . dO  A = P^T from registers (the S^T fragment, as the
//                      forward's P), B = the do slab, MN-major;
//     dK  += dS^T . Q  A = dS^T from registers, B = the q slab, MN-major.
//   S^T and dP^T are issued together; P^T is formed when S^T retires and
//   dV's product is issued before dP^T is waited on, so it overlaps the dS^T
//   arithmetic. Each q and do slab is read once from device memory and used
//   in both majors from shared memory. The stage is released when dK's
//   product retires.
// - Masks on the fragments: p = 0 on masked keys and keys past Tk (decided
//   once a block, a thread holds 2 key rows), past Tq (lse = +inf there), on
//   a row that sees no key (lse = +inf), and on the diagonal tile (q0 == k0)
//   above the diagonal. dk and dv accumulate in f32 registers (32 + 32 a
//   thread) and are written once as bf16: a block owns its keys, no atomics.
//   A key tile with no valid key loads nothing and writes zeros.
//
// Shared memory: k + v 16 KB, a ring of R = 4 stages 64 KB, 1 KB of
// alignment slack (dynamic), the stages' lse and di 2 KB (static): 83 KB,
// two blocks an SM. Registers: two blocks of 5 warps cap a thread at 168.

#include "tc_common.cuh"

namespace {

constexpr int D = 64;  // d_qk = d_v: one 64-column slab a tile
constexpr int R = 4;   // q/do stages in the ring
constexpr size_t SMEM = (size_t)(2 + 2 * R) * SLAB + 1024;  // + alignment slack

template <bool CAUSAL>
__global__ void __launch_bounds__(NTHREADS, 2)
flash_attn_bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                             const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v,
                             const __grid_constant__ CUtensorMap map_do,
                             const uint8_t* __restrict__ key_mask, const float* __restrict__ lse,
                             const float* __restrict__ di, __nv_bfloat16* __restrict__ dk,
                             __nv_bfloat16* __restrict__ dv, int H, int Tq, int Tk, float scale2,
                             float sm_scale) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t kv_full;
  __shared__ __align__(8) uint64_t full[R];
  __shared__ __align__(8) uint64_t empty[R];
  __shared__ __align__(16) float st_lse[R][BQ];  // lse * log2 e of the stage's query rows
  __shared__ __align__(16) float st_di[R][BQ];
  // TMA's 128-byte swizzle repeats every 1024 bytes: align the slabs to it
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* sK = base;
  uint8_t* sV = base + SLAB;
  uint8_t* ring = base + 2 * SLAB;  // stage i: q at 2i, do at 2i + 1

  const int tid = threadIdx.x;
  // broadcast from lane 0: warp-uniform to ptxas, so no wgmma sits on a
  // divergent path
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int lane = tid % 32;
  const int k0 = blockIdx.x * BK;
  const int bh = blockIdx.y;  // b * H + h
  const uint8_t* mask_b = key_mask ? key_mask + (size_t)(bh / H) * Tk : nullptr;
  const float* lse_bh = lse + (size_t)bh * Tq;
  const float* di_bh = di + (size_t)bh * Tq;
  // causal: rows before k0 see no key of this tile
  const int q_begin = CAUSAL ? k0 : 0;

  if (tid == 0) {
    mbar_init(&kv_full, 1);
    for (int i = 0; i < R; ++i) {
      mbar_init(&full[i], 32);    // every producer lane (lane 0 with the bytes)
      mbar_init(&empty[i], 128);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // also publishes the barriers' initialisation; the same answer in every
  // thread, broadcast from lane 0 so that ptxas sees it warp-uniform too
  const bool any =
      __shfl_sync(0xffffffffu, __syncthreads_or(tid < BK && key_valid(mask_b, k0 + tid, Tk)), 0) != 0;

  if (warp == 4) {
    // ---- producer: k and v once, then q, do, lse, di of every query tile ----
    if (!any) return;
    if (lane == 0) {
      mbar_expect_tx(&kv_full, 2 * SLAB);
      tma_load(sK, &map_k, &kv_full, 0, k0, bh);
      tma_load(sV, &map_v, &kv_full, 0, k0, bh);
    }
    int slot = 0;
    uint32_t phase = 0;
    for (int q0 = q_begin; q0 < Tq; q0 += BQ) {
      mbar_wait(&empty[slot], phase ^ 1);
#pragma unroll
      for (int i = 0; i < BQ / 32; ++i) {
        const int r = lane + 32 * i, qr = q0 + r;
        st_lse[slot][r] = qr < Tq ? __ldg(lse_bh + qr) * LOG2E : INFINITY;
        st_di[slot][r] = qr < Tq ? __ldg(di_bh + qr) : 0.f;
      }
      if (lane == 0) {
        mbar_expect_tx(&full[slot], 2 * SLAB);
        tma_load(ring + 2 * slot * SLAB, &map_q, &full[slot], 0, q0, bh);
        tma_load(ring + (2 * slot + 1) * SLAB, &map_do, &full[slot], 0, q0, bh);
      } else {
        mbar_arrive(&full[slot]);
      }
      if (++slot == R) {
        slot = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // ---- consumers: one warpgroup; a thread holds 2 key rows x 16 columns ----
  const int quad_row = 16 * warp + lane / 4;  // key rows quad_row and quad_row + 8
  const int cc = 2 * (lane % 4);              // columns 8j + cc, 8j + cc + 1
  float acc_k[32], acc_v[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_k[i] = acc_v[i] = 0.f;

  if (any) {
    bool kvalid[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) kvalid[h] = key_valid(mask_b, k0 + quad_row + 8 * h, Tk);
    const uint64_t k_desc = slab_desc(smem_u32(sK));
    const uint64_t v_desc = slab_desc(smem_u32(sV));
    const uint32_t ring_addr = smem_u32(ring);
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    int slot = 0;
    uint32_t phase = 0;
    mbar_wait(&kv_full, 0);

#pragma unroll 1
    for (int q0 = q_begin; q0 < Tq; q0 += BQ) {
      mbar_wait(&full[slot], phase);
      const uint64_t q_desc = slab_desc(ring_addr + 2 * slot * SLAB);
      const uint64_t do_desc = slab_desc(ring_addr + (2 * slot + 1) * SLAB);

      // S^T = K.Q^T and dP^T = V.dO^T, 4 k-steps (of d) each
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss(s, k_desc + 2 * kk, q_desc + 2 * kk, kk != 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss(dp, v_desc + 2 * kk, do_desc + 2 * kk, kk != 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_acc(s);

      // P^T on the fragment: element 4j + 2h + e is key row quad_row + 8h,
      // query column 8j + cc + e
      const bool diag = CAUSAL && q0 == k0;
      // on the diagonal tile, column 8j + cc + e is seen by key row
      // quad_row + 8h when 8j + e >= lim[h] (written with q0 and k0, so the
      // comparisons stay inside the loop, not in registers across it)
      int lim[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) lim[h] = k0 + quad_row + 8 * h - q0 - cc;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(&st_lse[slot][8 * j + cc]);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool seen = kvalid[h] && (!diag || 8 * j + e >= lim[h]);
            float& x = s[4 * j + 2 * h + e];
            x = seen ? exp2f(x * scale2 - (e ? l2.y : l2.x)) : 0.f;
          }
      }
      uint32_t pa[4][4];
      frag_to_a(s, pa);

      // dV += P^T.dO, k-steps of 16 query rows
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc_v, pa[kk], do_desc + 128 * kk);
      wgmma_commit();
      wgmma_wait<1>();  // dP^T has retired; dV's product may still run
      fence_acc(dp);

      // dS^T = P^T (dP^T - di) sm_scale, in f32, then bf16 as the A operand
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 d2 = *reinterpret_cast<const float2*>(&st_di[slot][8 * j + cc]);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * h + e;
            dp[i] = s[i] * (dp[i] - (e ? d2.y : d2.x)) * sm_scale;
          }
      }
      uint32_t da[4][4];
      frag_to_a(dp, da);

      // dK += dS^T.Q
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc_k, da[kk], q_desc + 128 * kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc_v);
      fence_acc(acc_k);
      fence_frag(pa);
      fence_frag(da);
      mbar_arrive(&empty[slot]);
      if (++slot == R) {
        slot = 0;
        phase ^= 1;
      }
    }
  }

  // epilogue: dk, dv in bf16; element 4j + 2h + e is key row quad_row + 8h,
  // column 8j + cc + e
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kr = k0 + quad_row + 8 * h;
    if (kr >= Tk) continue;
    const size_t row = ((size_t)bh * Tk + kr) * D;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = 4 * j + 2 * h;
      *reinterpret_cast<uint32_t*>(dk + row + 8 * j + cc) = pack_bf16(acc_k[i], acc_k[i + 1]);
      *reinterpret_cast<uint32_t*>(dv + row + 8 * j + cc) = pack_bf16(acc_v[i], acc_v[i + 1]);
    }
  }
}

template <bool CAUSAL>
cudaError_t launch(const void* q, const void* k, const void* v, const void* key_mask, const float* lse,
                   const float* di, const void* dout, void* dk, void* dv, int B, int H, int Tq, int Tk,
                   float sm_scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo;
  if (!make_map(&mq, q, B * H, Tq, D) || !make_map(&mk, k, B * H, Tk, D) ||
      !make_map(&mv, v, B * H, Tk, D) || !make_map(&mdo, dout, B * H, Tq, D))
    return cudaErrorInvalidValue;
  static unsigned long long sized = 0;
  cudaError_t err = size_smem_once(flash_attn_bwd_dkv_tc_kernel<CAUSAL>, SMEM, sized);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tk + BK - 1) / BK, B * H);
  flash_attn_bwd_dkv_tc_kernel<CAUSAL><<<grid, NTHREADS, SMEM, stream>>>(
      mq, mk, mv, mdo, static_cast<const uint8_t*>(key_mask), lse, di,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), H, Tq, Tk, sm_scale * LOG2E,
      sm_scale);
  return cudaGetLastError();
}

}  // namespace

// The same arguments and semantics as jatts_flash_attn_bwd_dkv
// (flash_attn_bwd.cu) for the one form this kernel has: bf16 (is_bf16 != 0),
// causal (Tq == Tk), Dqk == Dv == 64, no bias (ab null). q, k, v, dout
// 16-byte aligned, dk, dv 4-byte aligned. Returns a cudaError_t (0 =
// launched); anything else it refuses with cudaErrorInvalidValue (or
// cudaErrorMisalignedAddress).
extern "C" int jatts_flash_attn_bwd_dkv_tc(const void* q, const void* k, const void* v,
                                           const void* ab, const void* key_mask, const void* lse,
                                           const void* di, const void* dout, void* dk, void* dv,
                                           int B, int H, int Tq, int Tk, int Dqk, int Dv,
                                           int is_bf16, int causal, float sm_scale, void* stream) {
  if (!is_bf16 || !causal || ab != nullptr || Dqk != 64 || Dv != 64 || Tq != Tk || Tq <= 0)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout) % 16 != 0 ||
      ((uintptr_t)dk | (uintptr_t)dv) % 4 != 0)
    return (int)cudaErrorMisalignedAddress;
  return (int)launch<true>(q, k, v, key_mask, static_cast<const float*>(lse),
                               static_cast<const float*>(di), dout, dk, dv, B, H, Tq, Tk, sm_scale,
                               static_cast<cudaStream_t>(stream));
}
