// K1's backward in bf16 at d 64 on Hopper's tensor cores (sm_90a), plain C
// interface: the dk/dv kernel and the dq kernel, each in a causal and a
// non-causal form (a compile-time CAUSAL).
//
// Replace, for VALL-E's forms (bf16, d_qk = d_v = 64, a key mask, no bias;
// causal for the AR, K1b, non-causal for the NAR), the two Pallas TPU kernels
// of the flash-attention custom VJP
// (jax/experimental/pallas/ops/tpu/flash_attention.py):
// `_flash_attention_dkv_kernel` (:796; pallas_call at :1121; the causal
// element mask at :877-885 and block skip at :924) and
// `_flash_attention_dq_kernel` (:1146; pallas_call at :1456, wrapper
// `_flash_attention_bwd_dq` :1287; the causal element mask at :1213-1220, ds
// at :1243-1248, dq summed in a scratch accumulator at :1257-1261 and written
// once at :1281-1284, the causal blocks above the diagonal skipped at
// :1263-1277). VALL-E's trunks drive them (jatts_tpu/modules/valle_modules.py:101,
// causal=True in the AR, False in the NAR) through the custom VJP of
// jatts_tpu/modules/attention.py:_flash_attend. They compute exactly what
// flash_attn_bwd_dkv_kernel<bf16, 64, CAUSAL> and
// flash_attn_bwd_dq_kernel<bf16, 64, CAUSAL> (flash_attn_bwd.cu) compute, per
// (b, h):
//
//     p = exp(s - lse) on the keys a row sees, 0 elsewhere
//     dv = p^T . do        dp = do . v^T        ds = p * (dp - di) * sm_scale
//     dk = ds^T . q        dq = ds . k
//
// with s = q . k^T * sm_scale, lse the forward's row log-sum-exp (+inf on a
// row that sees no key, so its p is 0) and di = rowsum(o * do), both f32 from
// the wrapper. Query row i sees key j when the key's mask byte is nonzero
// and, in the causal form, j <= i (Tq == Tk, top-left aligned); keys past Tk
// are never seen. The non-causal form takes any Tq, Tk >= 1.
//
// The non-causal form at the VALL-E NAR's attention (B,H,T,d =
// 16,16,1088,64, every key valid) does every tile pair: dk/dv's four
// products are 155.2 GFLOP -> 0.157 ms, dq's three 116.4 GFLOP -> 0.118 ms on
// the bf16 tensor cores; the bytes are the causal form's (below). Its blocks
// are all equally heavy, so the block order does not matter.
//
// ---- the dk/dv kernel ----
//
// Numerics: all four products accumulate in f32 on the tensor cores; p and
// ds are computed in f32 on the accumulator fragments (in the base-2
// domain: p = exp2(s * sm_scale * log2 e - lse * log2 e)) and rounded to
// bf16 only as the A operands of their products, where the scalar kernel
// keeps them in f32: the one difference. dk and dv are rounded once to bf16.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16), causal, at VALL-E AR's
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
//   row sees its keys), so tile 0 is the heaviest and already comes first;
//   non-causal: over every query tile from 0.
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
//   a row that sees no key (lse = +inf), and, causal, on the diagonal tile
//   (q0 == k0) above the diagonal. dk and dv accumulate in f32 registers (32 + 32 a
//   thread) and are written once as bf16: a block owns its keys, no atomics.
//   A key tile with no valid key loads nothing and writes zeros.
//
// Shared memory: k + v 16 KB, a ring of R = 4 stages 64 KB, 1 KB of
// alignment slack (dynamic), the stages' lse and di 2 KB (static): 83 KB,
// two blocks an SM. Registers: two blocks of 5 warps cap a thread at 168.
//
// ---- the dq kernel ----
//
// Numerics: the three products accumulate in f32 on the tensor cores; p and
// ds are computed in f32 on the accumulator fragments (p in the base-2
// domain, as above). The one difference from the scalar kernel: ds is
// rounded to bf16 as the A operand of dQ += dS.K, where the scalar kernel
// keeps it in f32. dq is rounded once to bf16.
//
// Bound on an H100 SXM, causal, at VALL-E AR's attention (16,16,1088,64,
// every key valid): reading q, k, v, do and writing dq (5 x 35.7 MB), lse and di (2 x
// 1.1 MB) is 180.5 MB -> 0.0539 ms; the causal half of three products (s
// again, dp, dq) is 58.2 GFLOP -> 0.0588 ms, so operations bound it. The
// scalar kernel did them as f32 FMAs on the CUDA cores on 32-key tiles
// widened to f32 in shared memory: 53x off.
//
// Design (the FlashAttention-2/3 dq form on the same machinery):
// - One block a 64-row query tile of one (b, h): warps 0-3 are one consumer
//   warpgroup, warp 4 the producer. Grid (ceil(Tq/64), B*H), query tiles in
//   reverse block order, so the heaviest causal tiles start first.
// - The q and do tiles stay resident (one TMA'd 64 x 64 slab each); a
//   thread loads the lse * log2 e and di of its 2 rows once (+inf / 0 past
//   Tq). The k and v tiles of each key tile stream through the ring of R
//   stages (a k slab and a v slab, 16 KB), one TMA each, with a full and an
//   empty mbarrier a stage.
// - Per key tile, all products wgmma m64n64k16 (queries x keys, then
//   queries x d):
//     S   = Q . K^T   A = the q slab, B = the k slab, both K-major;
//     dP  = dO . V^T  A = the do slab, B = the v slab, both K-major;
//     dQ += dS . K    A = dS from registers (the dP fragment, as the
//                     forward's P), B = the k slab, MN-major (as the
//                     forward's v).
//   S and dP are issued together; P is formed when S retires, while dP may
//   still run, and dS when dP retires. Each k slab is read once from device
//   memory and used in both majors from shared memory. The stage is
//   released when dQ's product retires.
// - The causal bound: query tile q0 takes key tiles k0 < min(Tk, q0 + 64)
//   only (non-causal: every key tile < Tk), the producer and the consumers
//   from one variable (a slab the
//   consumers never take would never be released, and the reverse hangs).
//   The diagonal tile (k0 == q0) is masked on the S fragment.
// - Masks: p = 0 on masked keys and keys past Tk, on the diagonal tile above
//   the diagonal, on rows past Tq and on a row that sees no key (lse = +inf
//   there: exp2(-inf) = 0), so such a row's dq is exactly 0, never NaN. A
//   key tile with no valid key is loaded by nobody and skipped by everybody.
// - dq accumulates in 32 f32 registers a thread and is written once as bf16:
//   a block owns its rows, no atomics, the same bits from run to run.
//
// Shared memory: q + do 16 KB, the ring 64 KB, 1 KB of alignment slack: 81
// KB, two blocks an SM; registers capped at 168 as above (S, dP and dQ
// fragments and the dS A fragment: 112 floats a thread).

#include "tc_common.cuh"

namespace {

constexpr int D = 64;  // d_qk = d_v: one 64-column slab a tile
constexpr int R = 4;   // ring stages: q/do (dk/dv kernel), k/v (dq kernel)
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
__global__ void __launch_bounds__(NTHREADS, 2)
flash_attn_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                            const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v,
                            const __grid_constant__ CUtensorMap map_do,
                            const uint8_t* __restrict__ key_mask, const float* __restrict__ lse,
                            const float* __restrict__ di, __nv_bfloat16* __restrict__ dq, int H, int Tq,
                            int Tk, float scale2, float sm_scale) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t qdo_full;
  __shared__ __align__(8) uint64_t full[R];
  __shared__ __align__(8) uint64_t empty[R];
  // TMA's 128-byte swizzle repeats every 1024 bytes: align the slabs to it
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* sQ = base;
  uint8_t* sdO = base + SLAB;
  uint8_t* ring = base + 2 * SLAB;  // stage i: k at 2i, v at 2i + 1

  const int tid = threadIdx.x;
  // broadcast from lane 0: warp-uniform to ptxas, so no wgmma sits on a
  // divergent path
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int lane = tid % 32;
  // the last query tile (the most key tiles) is scheduled first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int bh = blockIdx.y;  // b * H + h
  const uint8_t* mask_b = key_mask ? key_mask + (size_t)(bh / H) * Tk : nullptr;
  // causal (Tq == Tk, top-left aligned): no row of this tile sees a key at
  // or past q0 + BQ; non-causal: every key tile. The producer and the
  // consumers both loop to this bound.
  const int k_end = CAUSAL ? min(Tk, q0 + BQ) : Tk;

  if (tid == 0) {
    mbar_init(&qdo_full, 1);
    for (int i = 0; i < R; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 128);  // every consumer thread arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {
    // ---- producer: q and do once, then k and v of every key tile with a valid key ----
    if (lane == 0) {
      mbar_expect_tx(&qdo_full, 2 * SLAB);
      tma_load(sQ, &map_q, &qdo_full, 0, q0, bh);
      tma_load(sdO, &map_do, &qdo_full, 0, q0, bh);
    }
    int slot = 0;
    uint32_t phase = 0;
    for (int k0 = 0; k0 < k_end; k0 += BK) {
      const bool any = __any_sync(0xffffffffu, key_valid(mask_b, k0 + lane, Tk) ||
                                                   key_valid(mask_b, k0 + 32 + lane, Tk));
      if (!any) continue;
      if (lane == 0) {
        mbar_wait(&empty[slot], phase ^ 1);
        mbar_expect_tx(&full[slot], 2 * SLAB);
        tma_load(ring + 2 * slot * SLAB, &map_k, &full[slot], 0, k0, bh);
        tma_load(ring + (2 * slot + 1) * SLAB, &map_v, &full[slot], 0, k0, bh);
      }
      if (++slot == R) {
        slot = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // ---- consumers: one warpgroup; a thread holds 2 query rows x 16 columns ----
  const int quad_row = 16 * warp + lane / 4;  // rows quad_row and quad_row + 8
  const int cc = 2 * (lane % 4);              // columns 8j + cc, 8j + cc + 1
  float lse2[2], di_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qr = q0 + quad_row + 8 * h;
    lse2[h] = qr < Tq ? __ldg(lse + (size_t)bh * Tq + qr) * LOG2E : INFINITY;
    di_r[h] = qr < Tq ? __ldg(di + (size_t)bh * Tq + qr) : 0.f;
  }
  float acc[32], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = s[i] = dp[i] = 0.f;
  const uint64_t q_desc = slab_desc(smem_u32(sQ));
  const uint64_t do_desc = slab_desc(smem_u32(sdO));
  const uint32_t ring_addr = smem_u32(ring);
  int slot = 0;
  uint32_t phase = 0;
  mbar_wait(&qdo_full, 0);

#pragma unroll 1
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    // which of this thread's 16 columns are valid keys (bit 2j + e)
    uint32_t vbits = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (key_valid(mask_b, k0 + 8 * j + cc + e, Tk)) vbits |= 1u << (2 * j + e);
    // a quad covers all 64 columns: the same answer in every thread
    uint32_t tile_bits = vbits;
    tile_bits |= __shfl_xor_sync(0xffffffffu, tile_bits, 1);
    tile_bits |= __shfl_xor_sync(0xffffffffu, tile_bits, 2);
    tile_bits = __shfl_sync(0xffffffffu, tile_bits, 0);  // uniform to ptxas
    if (tile_bits == 0) continue;  // the producer skipped it too

    mbar_wait(&full[slot], phase);
    const uint64_t k_desc = slab_desc(ring_addr + 2 * slot * SLAB);
    const uint64_t v_desc = slab_desc(ring_addr + (2 * slot + 1) * SLAB);

    // S = Q.K^T and dP = dO.V^T, 4 k-steps (of d) each
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss(s, q_desc + 2 * kk, k_desc + 2 * kk, kk != 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss(dp, do_desc + 2 * kk, v_desc + 2 * kk, kk != 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc(s);

    // P on the fragment: element 4j + 2h + e is row quad_row + 8h, key
    // column 8j + cc + e. On the diagonal tile the column is seen when
    // 8j + e <= lim[h] (written with q0 and k0, so the comparisons stay
    // inside the loop, not in registers across it)
    int lim[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) lim[h] = q0 + quad_row + 8 * h - k0 - cc;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          bool seen = (vbits >> (2 * j + e)) & 1u;
          if (CAUSAL && k0 == q0) seen = seen && 8 * j + e <= lim[h];
          float& x = s[4 * j + 2 * h + e];
          x = seen ? exp2f(x * scale2 - lse2[h]) : 0.f;
        }
    wgmma_wait<0>();
    fence_acc(dp);

    // dS = P (dP - di) sm_scale, in f32, then bf16 as the A operand
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - di_r[(i >> 1) & 1]) * sm_scale;
    uint32_t da[4][4];
    frag_to_a(dp, da);

    // dQ += dS.K, k-steps of 16 keys (2048 bytes of the k slab)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, da[kk], k_desc + 128 * kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    fence_frag(da);
    mbar_arrive(&empty[slot]);
    if (++slot == R) {
      slot = 0;
      phase ^= 1;
    }
  }

  // epilogue: dq in bf16; element 4j + 2h + e is row quad_row + 8h, column
  // 8j + cc + e
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qr = q0 + quad_row + 8 * h;
    if (qr >= Tq) continue;
    __nv_bfloat16* row = dq + ((size_t)bh * Tq + qr) * D;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j + cc) = pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

// the tensor maps of q, k, v and do, in that order
bool make_maps(CUtensorMap (&m)[4], const void* q, const void* k, const void* v, const void* dout, int BH,
               int Tq, int Tk) {
  return make_map(&m[0], q, BH, Tq, D) && make_map(&m[1], k, BH, Tk, D) && make_map(&m[2], v, BH, Tk, D) &&
         make_map(&m[3], dout, BH, Tq, D);
}

template <bool CAUSAL>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* key_mask, const float* lse,
                       const float* di, const void* dout, void* dk, void* dv, int B, int H, int Tq, int Tk,
                       float sm_scale, cudaStream_t stream) {
  CUtensorMap m[4];
  if (!make_maps(m, q, k, v, dout, B * H, Tq, Tk)) return cudaErrorInvalidValue;
  static unsigned long long sized = 0;
  cudaError_t err = size_smem_once(flash_attn_bwd_dkv_tc_kernel<CAUSAL>, SMEM, sized);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tk + BK - 1) / BK, B * H);
  flash_attn_bwd_dkv_tc_kernel<CAUSAL><<<grid, NTHREADS, SMEM, stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const uint8_t*>(key_mask), lse, di,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), H, Tq, Tk, sm_scale * LOG2E,
      sm_scale);
  return cudaGetLastError();
}

template <bool CAUSAL>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* key_mask, const float* lse,
                      const float* di, const void* dout, void* dq, int B, int H, int Tq, int Tk,
                      float sm_scale, cudaStream_t stream) {
  CUtensorMap m[4];
  if (!make_maps(m, q, k, v, dout, B * H, Tq, Tk)) return cudaErrorInvalidValue;
  static unsigned long long sized = 0;
  cudaError_t err = size_smem_once(flash_attn_bwd_dq_tc_kernel<CAUSAL>, SMEM, sized);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + BQ - 1) / BQ, B * H);
  flash_attn_bwd_dq_tc_kernel<CAUSAL><<<grid, NTHREADS, SMEM, stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const uint8_t*>(key_mask), lse, di,
      static_cast<__nv_bfloat16*>(dq), H, Tq, Tk, sm_scale * LOG2E, sm_scale);
  return cudaGetLastError();
}

// the forms both kernels take: bf16, d_qk = d_v = 64, no bias, causal (Tq ==
// Tk) or not (any Tq, Tk >= 1); q, k, v, dout 16-byte aligned (TMA), the
// outputs 4-byte aligned
int check_form(const void* q, const void* k, const void* v, const void* ab, const void* dout, const void* out_a,
               const void* out_b, int Tq, int Tk, int Dqk, int Dv, int is_bf16, int causal) {
  if (!is_bf16 || ab != nullptr || Dqk != 64 || Dv != 64 || Tq <= 0 || Tk <= 0 || (causal && Tq != Tk))
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout) % 16 != 0 ||
      ((uintptr_t)out_a | (uintptr_t)out_b) % 4 != 0)
    return (int)cudaErrorMisalignedAddress;
  return 0;
}

}  // namespace

// The same arguments and semantics as jatts_flash_attn_bwd_dkv
// (flash_attn_bwd.cu) for the forms this kernel has: bf16 (is_bf16 != 0),
// Dqk == Dv == 64, no bias (ab null), causal (Tq == Tk) or not (any Tq, Tk).
// q, k, v, dout 16-byte aligned, dk, dv 4-byte aligned. Returns a
// cudaError_t (0 = launched); anything else it refuses with
// cudaErrorInvalidValue (or cudaErrorMisalignedAddress).
extern "C" int jatts_flash_attn_bwd_dkv_tc(const void* q, const void* k, const void* v,
                                           const void* ab, const void* key_mask, const void* lse,
                                           const void* di, const void* dout, void* dk, void* dv,
                                           int B, int H, int Tq, int Tk, int Dqk, int Dv,
                                           int is_bf16, int causal, float sm_scale, void* stream) {
  const int rc = check_form(q, k, v, ab, dout, dk, dv, Tq, Tk, Dqk, Dv, is_bf16, causal);
  if (rc != 0) return rc;
  auto launch = causal ? launch_dkv<true> : launch_dkv<false>;
  return (int)launch(q, k, v, key_mask, static_cast<const float*>(lse), static_cast<const float*>(di), dout, dk,
                     dv, B, H, Tq, Tk, sm_scale, static_cast<cudaStream_t>(stream));
}

// The same arguments and semantics as jatts_flash_attn_bwd_dq
// (flash_attn_bwd.cu) for the same forms: no bias, so no d(ab) either (ab
// and dab null). dq 4-byte aligned. Returns a cudaError_t as above.
extern "C" int jatts_flash_attn_bwd_dq_tc(const void* q, const void* k, const void* v,
                                          const void* ab, const void* key_mask, const void* lse,
                                          const void* di, const void* dout, void* dq, void* dab,
                                          int B, int H, int Tq, int Tk, int Dqk, int Dv,
                                          int is_bf16, int causal, float sm_scale, void* stream) {
  if (dab != nullptr) return (int)cudaErrorInvalidValue;
  const int rc = check_form(q, k, v, ab, dout, dq, nullptr, Tq, Tk, Dqk, Dv, is_bf16, causal);
  if (rc != 0) return rc;
  auto launch = causal ? launch_dq<true> : launch_dq<false>;
  return (int)launch(q, k, v, key_mask, static_cast<const float*>(lse), static_cast<const float*>(di), dout, dq,
                     B, H, Tq, Tk, sm_scale, static_cast<cudaStream_t>(stream));
}
