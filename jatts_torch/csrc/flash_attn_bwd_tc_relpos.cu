// K1r's bf16 backward on Hopper's tensor cores (sm_90a), plain C interface:
// the dk/dv kernel and the dq kernel of the fused "latest" rel-pos attention
// (d_qk != d_v).
//
// Replace, for FastSpeech2's bf16-compute training under attn_backend flash
// (JVS-latest), the two Pallas TPU kernels of the flash-attention custom VJP
// (jax/experimental/pallas/ops/tpu/flash_attention.py):
// `_flash_attention_dkv_kernel` (:796; pallas_call at :1121) and
// `_flash_attention_dq_kernel` (:1146; pallas_call at :1456), as the fused
// call of jatts_tpu/modules/attention.py:372-385 drives them
// (`_flash_attend(q_cat, k_cat, v, None, mask, sm_scale)`): q and k of width
// d_qk, v and do of width d_v = d_qk / 3, (d_qk, d_v) = (576, 192) or (192,
// 64), bf16, non-causal, a key mask, no bias. They compute what the scalar
// kernels flash_attn_bwd_{dkv,dq}_relpos_kernel<bf16, D_QK, D_V>
// (flash_attn_bwd.cu) compute, per (b, h):
//
//     p = exp2(s * sm_scale * log2 e - lse * log2 e) on the keys a row sees, 0 elsewhere
//     dv = p^T . do        dp = do . v^T        ds = p * (dp - di) * sm_scale
//     dk = ds^T . q        dq = ds . k
//
// with s = q . k^T over d_qk, lse the forward's row log-sum-exp (+inf on a
// row that sees no key) and di = rowsum(o * do), both f32 from the wrapper.
// Masked keys, keys past Tk, rows past Tq and rows with lse = +inf have p =
// 0, so a row that sees no key has dq exactly 0 and a key that no row sees
// has dk and dv exactly 0. Any Tq, Tk >= 1.
//
// Numerics: every product accumulates in f32 on the tensor cores from the
// bf16 operands; each 192-column part's partial scores are summed in f32 in
// rank order; p and ds are formed in f32 on the accumulator fragments and
// rounded to bf16 only as the A operands of their products (dV += P^T.dO,
// dK += dS^T.Q, dQ += dS.K), where the scalar kernels keep them in f32: the
// one difference (flash_attn_bwd_tc.cu's d-64 kernels make the same one).
// dk, dv and dq are rounded once to bf16.
//
// Bounds on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16) at a bf16-compute
// JVS-latest training step (B, H, T = 24, 2, 896, d_qk 576, d_v 192, every
// key valid): dk/dv does s, dp, dv and dk, 2 * B*H*T^2 * (576 + 192 + 192 +
// 576) = 118.4 GFLOP -> 0.1197 ms, reading q, k, v, do, lse, di and writing
// dk, dv (198.4 MB, 0.059 ms); dq does s, dp and dq, 103.6 GFLOP -> 0.1047
// ms (181.9 MB, 0.054 ms). Operations bound both. The scalar kernels did them as f32 FMAs on the
// CUDA cores (1.77 ms at 67 TFLOP/s), one shared-memory load an FMA, at 79x
// and 81x these bounds.
//
// Design: flash_attn_bwd_tc_f32.cu's cluster over the widths, with
// flash_attn_bwd_tc.cu's bf16 products, and no dp block.
// - One warpgroup cannot hold a 64-row dk part of 576 f32 columns (288
//   registers a thread), so a thread-block cluster of NQ = d_qk / 192 blocks
//   shares one 64-row tile (keys in the dk/dv kernel, queries in the dq
//   kernel) of one (b, h): rank r owns columns 192r .. 192r + 191 of q and k
//   (and of dk or dq) and, in dk/dv, columns 64r .. 64r + 63 of dv. Grid (NQ
//   x tiles, B*H), launched with a cluster dimension (cudaLaunchKernelEx); at
//   (192, 64) a cluster is one block and nothing is exchanged.
// - Per tile of the loop (queries in dk/dv, keys in dq) each block forms its
//   partial scores X.Y^T over its 192 columns (X its resident tile, Y the
//   streamed one) and, on the tensor cores while the partials are exchanged,
//   the whole dp over d_v (dP^T = V.dO^T in dk/dv, dP = dO.V^T in dq). It
//   pushes its partial from registers by st.async into its slot in every
//   other block of the cluster (counted by the receiver's mbarrier as the
//   bytes land), waits for theirs and sums the NQ partials in rank order 0,
//   1, .. NQ - 1, so every block holds the same s bit for bit and forms the
//   same p. Once its consumers have read the slots (a bar.sync orders the
//   reads) it acknowledges each sender with one 4-byte st.async into the
//   sender's `xempty`, which the sender waits on before its next push, and
//   only then forms p, ds and its outputs: nothing in the loop fences at
//   cluster scope (the f32 kernel's protocol, which acknowledges after the
//   output product).
// - The exchange costs what moving its bytes between SMs costs: 2 x 16 KB
//   out and in a block a tile took 2100-2500 cycles of a 5350-6260-cycle
//   tile however they went (st.async from registers, or one cp.async.bulk
//   shared::cta -> shared::cluster a peer from shared memory, which only
//   moved the time from the push into the wait and ran 8-9% slower; the
//   study's stamps).
// - Why no dp block (the f32 kernel's split: NQ score blocks and one dp block
//   whose dp goes to them by st.async): in bf16 the products are cheap and
//   the exchange is not. The first bf16 version of that split spent ~17% of
//   a tile's ~6600 cycles in products (bin/study_bwd_tc_relpos.py's clock
//   stamps, 24 x 2 x 896): dp's 16 KB push to every score block, and the
//   score partials' to the dp block, cost more than each block doing dp's 12
//   wgmmas itself, which overlap the exchange. So the cluster is 3 SMs, not
//   4, every block's work is the same, and dv is split by 64-column chunk.
// - Products (wgmma m64n64k16, bf16 in, f32 out), keys x queries in dk/dv
//   (S^T = K.Q^T, dP^T = V.dO^T) and queries x keys in dq (S = Q.K^T, dP =
//   dO.V^T): the partial and dp read the resident slab and the streamed one
//   both K-major, as TMA landed them (64 x 64 bf16, 128-byte swizzle). The
//   output products take their A, p or ds, from registers (the accumulator
//   fragment is the A fragment, frag_to_a) and their B, the streamed q, do or
//   k slab, from shared memory MN-major, as it landed: bf16 wgmma reads a
//   transposed B, so the f32 kernel's transposed boxes, permuted rows and
//   split warps go. dk/dv issues dV's product as soon as p is formed, so it
//   runs while ds is formed, as flash_attn_bwd_tc.cu's does.
// - Roles in a block: warps 0-3 the consumer warpgroup, warp 4 the TMA
//   producer (the resident X part and its d_v operand once, then every
//   tile's Y part and d_v operand through a ring of R stages; in dk/dv also
//   the stage's lse * log2 e and di, +inf and 0 past Tq; in dq the stage's
//   key-valid bits, so the consumers read no mask from device memory in the
//   loop: those loads took ~1100 cycles a tile). A key tile with no valid key
//   loads nothing and writes zeros in dk/dv; in dq its stage carries only
//   its bits (zero), and every block of the cluster skips it. A stage is
//   released once the output products that read it again have retired.
// - No atomics, no split over the loop: every output element is written
//   once, by one block, so the bits are the same from run to run and a row's
//   result does not depend on its batch.
//
// Shared memory (dynamic, 1024-byte aligned) at (576, 192): the resident X
// part and d_v operand 6 slabs (48 KB), the ring R = 2 stages of 6 slabs (96
// KB; three do not fit), the exchange slots 2 x 16 KB (one 64 x 64 f32
// partial a sender), 1 KB of slack: 177 KB, one block an SM. Registers (a
// consumer thread): the output part 3 x 32 (and dv's chunk 32), the partial
// 32, dp 32, the A fragments 2 x 16: ptxas needs 218-254, with no spill.

#include "tc_cluster.cuh"

// %clock stamps of a consumer's phases a tile, summed by consumer thread 0
// of every block and written over its part of the output at row 0, columns
// 8i, by the blocks of the first cluster of (b, h) 0:
// bin/study_bwd_tc_relpos.py's `stamps` variant defines RELPOS_STAMPS.
// Nothing otherwise.
#ifdef RELPOS_STAMPS
#define STAMP(i)                                     \
  if (threadIdx.x == 0) {                            \
    uint32_t c_;                                     \
    asm volatile("mov.u32 %0, %%clock;" : "=r"(c_)); \
    stamps[i] += c_ - stamps[NSTAMPS];               \
    stamps[NSTAMPS] = c_;                            \
  }
#else
#define STAMP(i)
#endif

namespace {

constexpr int WS = 192;             // q and k columns a block owns
constexpr int NS = WS / 64;         // slabs of a block's part of q or k
constexpr int R_S = 2;              // ring stages
constexpr int XSLOT = 64 * 64 * 4;  // one 64 x 64 f32 partial
constexpr int NSTAMPS = 9;          // the stamped phases

template <int DQK, int DV>
struct CfgR {
  static constexpr int NQ = DQK / WS;  // the cluster's blocks
  static constexpr int NV = DV / 64;   // slabs of v or do
  static constexpr int STAGE = (NS + NV) * SLAB;  // a Y part and its d_v operand
  static constexpr size_t SMEM = (size_t)(1 + R_S) * STAGE + (size_t)(NQ - 1) * XSLOT + 1024;
  static_assert(DQK % WS == 0 && NV == NQ, "K1r's pairs: d_qk = 3 d_v, a 64-column chunk of dv a block");
};

// the block's static shared memory: its mbarriers and (dk/dv) the stages'
// lse * log2 e and di
struct Ctl {
  uint64_t x_full;       // the resident operands landed (TMA)
  uint64_t full[R_S];    // a stage landed (TMA; in dk/dv also every producer lane's lse and di)
  uint64_t empty[R_S];   // a stage's products retired (every consumer thread)
  uint64_t xfull;        // every peer's partial has landed (st.async bytes)
  uint64_t xempty;       // every peer has read this block's partial (st.async acks)
  float lse2[R_S][64];   // dk/dv: the stage's query rows' lse * log2 e (+inf past Tq)
  float di[R_S][64];     // and di (0 past Tq)
  uint32_t kbits[R_S][2];  // dq: the stage's key-valid bits (key c0 + 32w + b: word w, bit b)
  uint32_t ack;          // the word the peers' acks land in
};

// ---------------------------------------------------------------------------
// the kernels. DQ false: dk/dv (x: k part and v; y: q part and do; outs dk,
// dv). DQ true: dq (x: q part and do; y: k part and v; out dq).
// ---------------------------------------------------------------------------

template <int DQK, int DV, bool DQ>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_attn_bwd_tc_relpos_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_xv,
                                const __grid_constant__ CUtensorMap map_y, const __grid_constant__ CUtensorMap map_yv,
                                const uint8_t* __restrict__ key_mask, const float* __restrict__ lse,
                                const float* __restrict__ di, __nv_bfloat16* __restrict__ out,
                                __nv_bfloat16* __restrict__ out_v, int H, int Tq, int Tk, float scale2,
                                float sm_scale) {
  using C = CfgR<DQK, DV>;
  constexpr int NQ = C::NQ, NV = C::NV, STAGE = C::STAGE;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(16) Ctl ctl;
  // TMA's 128-byte swizzle repeats every 1024 bytes: align the slabs to it
  // (the same offset in every block of the cluster: one kernel, one layout)
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* sX = base;                   // the resident part (NS slabs) and d_v operand (NV slabs)
  uint8_t* ring = sX + STAGE;           // R_S stages, laid out as sX
  uint8_t* xbuf = ring + R_S * STAGE;   // NQ - 1 exchange slots (slot_of)

  const int tid = threadIdx.x;
  // uniform to ptxas, so no wgmma sits on a divergent path
  const int role = __shfl_sync(0xffffffffu, (int)cluster_rank(), 0);
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int lane = tid % 32;
  const int tile = blockIdx.x / NQ;
  const int r0 = tile * 64;  // this cluster's rows: keys (dk/dv) or queries (dq)
  const int bh = blockIdx.y;
  const int col0 = WS * role;       // this block's first column of q, k and dk or dq
  const int T_loop = DQ ? Tk : Tq;  // the loop runs over query tiles (dk/dv) or key tiles (dq)
  const uint8_t* mask_b = key_mask ? key_mask + (size_t)(bh / H) * Tk : nullptr;
  const float* lse_bh = lse + (size_t)bh * Tq;
  const float* di_bh = di + (size_t)bh * Tq;

  if (tid == 0) {
    mbar_init(&ctl.x_full, 1);
    for (int i = 0; i < R_S; ++i) {
      mbar_init(&ctl.full[i], DQ ? 1 : 32);  // dk/dv: every producer lane (lane 0 with the bytes)
      mbar_init(&ctl.empty[i], 128);
    }
    mbar_init(&ctl.xfull, 1);   // one expect_tx arrive a tile; the peers' st.async bring the bytes
    mbar_init(&ctl.xempty, 1);  // one expect_tx arrive a tile; the peers' st.async acks bring the bytes
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // no block pushes into a peer before the peer's barriers exist
  cluster_sync();

  // dk/dv: a key tile with no valid key loads nothing and writes zeros; the
  // same answer in every thread of every block of the cluster
  bool row_any = true;
  if (!DQ)
    row_any = __shfl_sync(0xffffffffu, __syncthreads_or(tid < 64 && key_valid(mask_b, r0 + tid, Tk)), 0) != 0;

  if (warp == 4) {
    // ---- producer: the resident operands once, then every tile's stage ----
    if (!row_any) return;
    if (lane == 0) {
      mbar_expect_tx(&ctl.x_full, STAGE);
      for (int s = 0; s < NS; ++s) tma_load(sX + s * SLAB, &map_x, &ctl.x_full, col0 + 64 * s, r0, bh);
      for (int s = 0; s < NV; ++s) tma_load(sX + (NS + s) * SLAB, &map_xv, &ctl.x_full, 64 * s, r0, bh);
    }
    int slot = 0;
    uint32_t phase = 0;
    for (int c0 = 0; c0 < T_loop; c0 += 64) {
      // dq: the tile's key-valid bits, read before the stage is free
      uint32_t w0 = 1, w1 = 0;
      if (DQ) {
        w0 = __ballot_sync(0xffffffffu, key_valid(mask_b, c0 + lane, Tk));
        w1 = __ballot_sync(0xffffffffu, key_valid(mask_b, c0 + 32 + lane, Tk));
      }
      mbar_wait(&ctl.empty[slot], phase ^ 1);
      if (DQ && lane == 0) {
        ctl.kbits[slot][0] = w0;
        ctl.kbits[slot][1] = w1;
      }
      if (!DQ) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = lane + 32 * i, qr = c0 + r;
          ctl.lse2[slot][r] = qr < Tq ? __fmul_rn(__ldg(lse_bh + qr), LOG2E) : INFINITY;
          ctl.di[slot][r] = qr < Tq ? __ldg(di_bh + qr) : 0.f;
        }
      }
      if (lane == 0 && (w0 | w1) == 0) {
        mbar_arrive(&ctl.full[slot]);  // dq, no valid key: the bits alone, and everybody skips the tile
      } else if (lane == 0) {
        uint8_t* st = ring + slot * STAGE;
        mbar_expect_tx(&ctl.full[slot], STAGE);
        for (int s = 0; s < NS; ++s) tma_load(st + s * SLAB, &map_y, &ctl.full[slot], col0 + 64 * s, c0, bh);
        for (int s = 0; s < NV; ++s) tma_load(st + (NS + s) * SLAB, &map_yv, &ctl.full[slot], 64 * s, c0, bh);
      } else if (!DQ) {
        mbar_arrive(&ctl.full[slot]);  // releases this lane's lse and di
      }
      if (++slot == R_S) {
        slot = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // ---- consumers: one warpgroup, 2 rows x 16 columns of a 64 x 64 tile a
  // thread: element 4j + 2h + e is row quad_row + 8h, column 8j + cc + e ----
  const int quad_row = 16 * warp + lane / 4;
  const int cc = 2 * (lane % 4);

  float o[NS][32];  // the output part, 64-column chunks
  float ov[32];     // dk/dv: dv's chunk `role`
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    ov[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NS; ++c) o[c][i] = 0.f;
  }

#ifdef RELPOS_STAMPS
  __shared__ uint32_t stamps[NSTAMPS + 1];  // the phases' sums, the last stamp
  if (tid == 0) {
    for (int i = 0; i < NSTAMPS; ++i) stamps[i] = 0;
    asm volatile("mov.u32 %0, %%clock;" : "=r"(stamps[NSTAMPS]));
  }
#endif

  if (row_any) {
    // the rows' own masks: dk/dv a row is a key (valid or not), dq a query
    // (its lse * log2 e, +inf past Tq, and di)
    bool rvalid[2];
    float lse2_r[2], di_r[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = r0 + quad_row + 8 * h;
      rvalid[h] = DQ || key_valid(mask_b, rr, Tk);
      lse2_r[h] = DQ && rr < Tq ? __fmul_rn(__ldg(lse_bh + rr), LOG2E) : INFINITY;
      di_r[h] = DQ && rr < Tq ? __ldg(di_bh + rr) : 0.f;
    }
    const uint32_t x_addr = smem_u32(sX);
    const uint32_t ring_addr = smem_u32(ring);
    const uint32_t xbuf_addr = smem_u32(xbuf);
    int slot = 0;
    uint32_t phase = 0;
    uint32_t tx = 0;  // tiles exchanged so far
    float acc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = dp[i] = 0.f;

    mbar_wait(&ctl.x_full, 0);
    STAMP(0)

#pragma unroll 1
    for (int c0 = 0; c0 < T_loop; c0 += 64) {
      mbar_wait(&ctl.full[slot], phase);
      STAMP(1)
      // dq: which of this thread's 16 key columns are valid (bit 2j + e),
      // from the stage's bits; a tile without one is skipped by every block
      // of the cluster (the same bits), and its stage freed
      uint32_t vbits = 0xFFFFFFFFu;
      if (DQ) {
        const uint32_t w[2] = {ctl.kbits[slot][0], ctl.kbits[slot][1]};
        vbits = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * j + cc + e;
            vbits |= ((w[col >> 5] >> (col & 31)) & 1u) << (2 * j + e);
          }
        if ((w[0] | w[1]) == 0) {
          mbar_arrive(&ctl.empty[slot]);
          if (++slot == R_S) {
            slot = 0;
            phase ^= 1;
          }
          continue;
        }
      }

      // this tile's exchange: the bytes the peers will store here (the
      // previous tile's phase completed before this thread got here)
      if (NQ > 1 && tid == 0) mbar_expect_tx(&ctl.xfull, (NQ - 1) * XSLOT);

      // the partial scores over this block's 192 columns, then dp over d_v,
      // every operand K-major
      const uint32_t y_addr = ring_addr + slot * STAGE;
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < NS; ++s)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss(acc, slab_desc(x_addr + s * SLAB) + 2 * kk, slab_desc(y_addr + s * SLAB) + 2 * kk,
                   s > 0 || kk > 0);
      wgmma_commit();
#pragma unroll
      for (int s = NS; s < NS + NV; ++s)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss(dp, slab_desc(x_addr + s * SLAB) + 2 * kk, slab_desc(y_addr + s * SLAB) + 2 * kk,
                   s > NS || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();  // the partial has retired; dp may still run
      fence_acc(acc);
      STAMP(2)

      if constexpr (NQ > 1) {
        // push the partial into this block's slot in every peer, once they
        // have read the previous one
        if (tx > 0) mbar_wait_cluster(&ctl.xempty, (tx - 1) & 1);
        // this tile's acks, before this thread's own stores (a peer acks
        // only after all of them have landed)
        if (tid == 0) mbar_expect_tx(&ctl.xempty, (NQ - 1) * 4);
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          if (j == role) continue;
          const uint32_t dst = peer_addr(xbuf_addr + slot_of(role, j) * XSLOT + tid * 16, j);
          const uint32_t bar = peer_addr(smem_u32(&ctl.xfull), j);
#pragma unroll
          for (int q4 = 0; q4 < 8; ++q4)
            st_async4(dst + q4 * 128 * 16, acc[4 * q4], acc[4 * q4 + 1], acc[4 * q4 + 2], acc[4 * q4 + 3], bar);
        }
        STAMP(3)

        // the scores: the partials summed in rank order (the same bits in
        // every block), in place
        mbar_wait_cluster(&ctl.xfull, tx & 1);
        STAMP(4)
#pragma unroll
        for (int q4 = 0; q4 < 8; ++q4) {
          float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int i = 0; i < NQ; ++i) {
            const float4 t = i == role
                                 ? make_float4(acc[4 * q4], acc[4 * q4 + 1], acc[4 * q4 + 2], acc[4 * q4 + 3])
                                 : ld_shared4(xbuf_addr + slot_of(i, role) * XSLOT + (q4 * 128 + tid) * 16);
            if (i == 0) {
              sum = t;
            } else {
              sum.x = __fadd_rn(sum.x, t.x);
              sum.y = __fadd_rn(sum.y, t.y);
              sum.z = __fadd_rn(sum.z, t.z);
              sum.w = __fadd_rn(sum.w, t.w);
            }
          }
          acc[4 * q4] = sum.x, acc[4 * q4 + 1] = sum.y, acc[4 * q4 + 2] = sum.z, acc[4 * q4 + 3] = sum.w;
        }
        // the slots were read (bar.sync orders every consumer's loads before
        // it): free them in every peer now, so its next push waits on no
        // product of this block
        consumer_sync();
        if (tid == 0)
          for (int j = 0; j < NQ; ++j)
            if (j != role) st_async_ack(peer_addr(smem_u32(&ctl.ack), j), peer_addr(smem_u32(&ctl.xempty), j));
        STAMP(5)
      }

      // p in place of the scores, in f32
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = DQ ? make_float2(0.f, 0.f) : *reinterpret_cast<const float2*>(&ctl.lse2[slot][8 * j + cc]);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * h + e;
            const bool seen = DQ ? ((vbits >> (2 * j + e)) & 1u) != 0 : rvalid[h];
            const float lse2 = DQ ? lse2_r[h] : (e ? l2.y : l2.x);
            acc[i] = seen ? exp2f(__fmaf_rn(acc[i], scale2, -lse2)) : 0.f;
          }
      }
      // dk/dv: dV[:, chunk role] += P^T . dO[:, chunk role], p in bf16 only
      // as the A operand; it runs while ds is formed
      uint32_t pa[4][4];
      if (!DQ) {
        frag_to_a(acc, pa);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs(ov, pa[kk], slab_desc(y_addr + (NS + role) * SLAB) + 128 * kk);
        wgmma_commit();
        wgmma_wait<1>();  // dp has retired; dV's product may still run
      } else {
        wgmma_wait<0>();  // dp has retired
      }
      fence_acc(dp);

      // ds = p (dp - di) sm_scale in f32, then bf16 as the A operand
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 d2 = DQ ? make_float2(0.f, 0.f) : *reinterpret_cast<const float2*>(&ctl.di[slot][8 * j + cc]);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * h + e;
            const float dv_i = DQ ? di_r[h] : (e ? d2.y : d2.x);
            acc[i] = __fmul_rn(__fmul_rn(acc[i], __fsub_rn(dp[i], dv_i)), sm_scale);
          }
      }
      uint32_t da[4][4];
      frag_to_a(acc, da);
      STAMP(6)

      // the output part: chunk c += dS^T . Q[:, c] (dk/dv) or dS . K[:, c]
      // (dq), the streamed slab MN-major (k-steps of its 16 rows)
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < NS; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs(o[c], da[kk], slab_desc(y_addr + c * SLAB) + 128 * kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(ov);
#pragma unroll
      for (int c = 0; c < NS; ++c) fence_acc(o[c]);
      if (!DQ) fence_frag(pa);
      fence_frag(da);
      STAMP(7)
      mbar_arrive(&ctl.empty[slot]);
      if (++slot == R_S) {
        slot = 0;
        phase ^= 1;
      }
      ++tx;
      STAMP(8)
    }
    // every peer has read this block's last partial, so no block of the
    // cluster touches this block's shared memory after it exits
    if (NQ > 1 && tx > 0) mbar_wait_cluster(&ctl.xempty, (tx - 1) & 1);
  }

  // epilogue: the output part (and dk/dv's dv chunk) in bf16, rows r0 +
  // quad_row + 8h
  const int T_rows = DQ ? Tq : Tk;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = r0 + quad_row + 8 * h;
    if (rr >= T_rows) continue;
    __nv_bfloat16* orow = out + ((size_t)bh * T_rows + rr) * DQK + col0;
#pragma unroll
    for (int c = 0; c < NS; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 64 * c + 8 * j + cc) =
            pack_bf16(o[c][4 * j + 2 * h], o[c][4 * j + 2 * h + 1]);
    if (!DQ) {
      __nv_bfloat16* vrow = out_v + ((size_t)bh * T_rows + rr) * DV + 64 * role;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(vrow + 8 * j + cc) = pack_bf16(ov[4 * j + 2 * h], ov[4 * j + 2 * h + 1]);
    }
  }
#ifdef RELPOS_STAMPS
  if (tid == 0 && bh == 0 && tile == 0 && row_any)
    for (int i = 0; i < NSTAMPS; ++i) out[col0 + 8 * i] = __float2bfloat16((float)stamps[i]);
#endif
}

template <int DQK, int DV, bool DQ>
cudaError_t launch(const void* q, const void* k, const void* v, const void* key_mask, const float* lse,
                   const float* di, const void* dout, void* out, void* out_v, int B, int H, int Tq, int Tk,
                   float sm_scale, cudaStream_t stream) {
  using C = CfgR<DQK, DV>;
  const int BH = B * H;
  const int Tx = DQ ? Tq : Tk, Ty = DQ ? Tk : Tq;
  CUtensorMap m[4];
  if (!make_map(&m[0], DQ ? q : k, BH, Tx, DQK) || !make_map(&m[1], DQ ? dout : v, BH, Tx, DV) ||
      !make_map(&m[2], DQ ? k : q, BH, Ty, DQK) || !make_map(&m[3], DQ ? v : dout, BH, Ty, DV))
    return cudaErrorInvalidValue;
  auto kernel = flash_attn_bwd_tc_relpos_kernel<DQK, DV, DQ>;
  static unsigned long long sized = 0;
  cudaError_t err = size_smem_once(kernel, C::SMEM, sized);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C::NQ * ((Tx + 63) / 64), BH);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C::NQ;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, m[0], m[1], m[2], m[3], static_cast<const uint8_t*>(key_mask), lse, di,
                           static_cast<__nv_bfloat16*>(out), static_cast<__nv_bfloat16*>(out_v), H, Tq, Tk,
                           sm_scale * LOG2E, sm_scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// the forms both kernels take: bf16, non-causal, no bias, (Dqk, Dv) in
// {(192, 64), (576, 192)}; q, k, v, dout 16-byte aligned (TMA), the outputs
// 4-byte aligned
int check_form(const void* q, const void* k, const void* v, const void* ab, const void* dout, const void* out_a,
               const void* out_b, int B, int H, int Tq, int Tk, int Dqk, int Dv, int is_bf16, int causal) {
  if (!is_bf16 || causal || ab != nullptr || Tq <= 0 || Tk <= 0 || B <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  if (!((Dqk == 192 && Dv == 64) || (Dqk == 576 && Dv == 192))) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout) % 16 != 0 ||
      ((uintptr_t)out_a | (uintptr_t)out_b) % 4 != 0)
    return (int)cudaErrorMisalignedAddress;
  return 0;
}

template <bool DQ>
int dispatch(const void* q, const void* k, const void* v, const void* key_mask, const void* lse, const void* di,
             const void* dout, void* out, void* out_v, int B, int H, int Tq, int Tk, int Dqk, float sm_scale,
             void* stream) {
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(di);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dqk == 576)
    return (int)launch<576, 192, DQ>(q, k, v, key_mask, l, d, dout, out, out_v, B, H, Tq, Tk, sm_scale, s);
  return (int)launch<192, 64, DQ>(q, k, v, key_mask, l, d, dout, out, out_v, B, H, Tq, Tk, sm_scale, s);
}

}  // namespace

// The same arguments and semantics as jatts_flash_attn_bwd_dkv
// (flash_attn_bwd.cu) for K1r's bf16 forms: is_bf16 != 0, causal == 0, ab
// null, (Dqk, Dv) in {(192, 64), (576, 192)}. q, k, v, dout 16-byte aligned,
// dk, dv 4-byte aligned. Returns a cudaError_t (0 = launched); anything else
// it refuses with cudaErrorInvalidValue (or cudaErrorMisalignedAddress).
extern "C" int jatts_flash_attn_bwd_dkv_tc_relpos(const void* q, const void* k, const void* v, const void* ab,
                                                  const void* key_mask, const void* lse, const void* di,
                                                  const void* dout, void* dk, void* dv, int B, int H, int Tq,
                                                  int Tk, int Dqk, int Dv, int is_bf16, int causal,
                                                  float sm_scale, void* stream) {
  const int rc = check_form(q, k, v, ab, dout, dk, dv, B, H, Tq, Tk, Dqk, Dv, is_bf16, causal);
  if (rc != 0) return rc;
  return dispatch<false>(q, k, v, key_mask, lse, di, dout, dk, dv, B, H, Tq, Tk, Dqk, sm_scale, stream);
}

// As above for jatts_flash_attn_bwd_dq: dq 4-byte aligned; no bias, so no
// d(ab) either (dab must be null).
extern "C" int jatts_flash_attn_bwd_dq_tc_relpos(const void* q, const void* k, const void* v, const void* ab,
                                                 const void* key_mask, const void* lse, const void* di,
                                                 const void* dout, void* dq, void* dab, int B, int H, int Tq,
                                                 int Tk, int Dqk, int Dv, int is_bf16, int causal, float sm_scale,
                                                 void* stream) {
  if (dab != nullptr) return (int)cudaErrorInvalidValue;
  const int rc = check_form(q, k, v, ab, dout, dq, nullptr, B, H, Tq, Tk, Dqk, Dv, is_bf16, causal);
  if (rc != 0) return rc;
  return dispatch<true>(q, k, v, key_mask, lse, di, dout, dq, nullptr, B, H, Tq, Tk, Dqk, sm_scale, stream);
}
