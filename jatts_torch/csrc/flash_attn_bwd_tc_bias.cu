// K1-bwd's bf16 backward with a bias on Hopper's tensor cores (sm_90a), plain
// C interface: the dk/dv kernel and the dq/d(ab) kernel at d_qk = d_v = 192.
//
// Replace, for FastSpeech2's bf16-compute training under attn_backend flash
// (the JSUT recipe: adim 384, 2 heads of 192), the two Pallas TPU kernels of
// the flash-attention custom VJP (jax/experimental/pallas/ops/tpu/
// flash_attention.py): `_flash_attention_dkv_kernel` (:796; pallas_call at
// :1121) and `_flash_attention_dq_kernel` (:1146; pallas_call at :1456; "dab
// is just ds", :1477), as the legacy rel-pos call of jatts_tpu/modules/
// attention.py:334 drives them (`_flash_attend(q_u, k, v, matrix_bd, mask,
// sm_scale)`): bf16, non-causal, a dense bias ab [B, H, Tq, Tk] in bf16
// (matrix_bd), a key mask. They compute what the scalar kernels
// flash_attn_bwd_{dkv,dq}_kernel<bf16, 192> (flash_attn_bwd.cu) compute, per
// (b, h):
//
//     p = exp2((s + ab) * sm_scale * log2 e - lse * log2 e) on the keys a row sees, 0 elsewhere
//     dv = p^T . do        dp = do . v^T        ds = p * (dp - di) * sm_scale
//     dk = ds^T . q        dq = ds . k          d(ab) = ds
//
// with s = q . k^T, lse the forward's row log-sum-exp (+inf on a row that
// sees no key) and di = rowsum(o * do), both f32 from the wrapper. Masked
// keys, keys past Tk, rows past Tq and rows with lse = +inf have p = 0, so a
// row that sees no key has dq and d(ab) exactly 0, a key that no row sees
// has dk and dv exactly 0, and d(ab) is exactly 0 on masked keys. d(ab) is
// written on every element (zeros on a key tile the dq kernel skips), so the
// wrapper's torch.empty needs no fill. Any Tq, Tk >= 1.
//
// Numerics: every product accumulates in f32 on the tensor cores from the
// bf16 operands; the bias is added to the scores in f32 before the scale; p
// and ds are formed in f32 and rounded to bf16 only as the A operands of
// their products (dV += P^T.dO, dK += dS^T.Q, dQ += dS.K), where the scalar
// kernels keep them in f32: the one difference (flash_attn_bwd_tc.cu's and
// flash_attn_bwd_tc_relpos.cu's kernels make the same one). d(ab) is the f32
// ds rounded once to bf16 (the same bits as dQ's A operand); dk, dv and dq
// are rounded once to bf16.
//
// Bounds on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16) at a bf16-compute JSUT
// training step's decoder (B, H, T = 24, 2, 896, d 192, every key valid):
// dk/dv does s, dp, dv and dk, 2 * B*H*T^2 * 4 * 192 = 59.2 GFLOP -> 0.0598
// ms, reading q, k, v, do, the bias, lse, di and writing dk, dv (176 MB,
// 0.053 ms): operations bound it. dq does s, dp and dq, 44.4 GFLOP -> 0.0449
// ms, reading the bias and writing d(ab) besides (237 MB, 0.0707 ms): bytes
// bound it. The scalar kernels did them as f32 FMAs on the CUDA cores at
// 74x and 60x these bounds.
//
// Design: one block a 64-row tile of one (b, h), no cluster (the whole of d
// is one block's), a TMA producer warp and a ring of R_S stages, each stage
// a streamed tile's two 192-column operands (6 slabs, TMA, 128-byte
// swizzle) and its 64 x 64 bias tile.
// - The bias, a 64 x 64 tile a stage, one stage ahead of the consumers. Every
//   training call gives Tk % 8 == 0: the collater pads text to a multiple of
//   16 and frames to one of 64 (data/batcher.py:FastSpeech2Collater), and the
//   decoder runs at the padded frame count (models/fastspeech2.py). There the
//   tile is one more TMA box of the stage (a 3-d map over [BH, Tq, Tk], rows
//   of 128 bytes, 128-byte swizzle: key k of row r at 16-byte chunk
//   (k / 8) ^ (r % 8)), counted on the stage's `full` barrier with the
//   operands; rows past Tq and keys past Tk land as zeros. The swizzle keeps
//   the consumers' 2-byte reads free of bank conflicts both along a row (dq)
//   and down a column (dk/dv, which reads the tile transposed). Any other Tk
//   (a caller's own shapes; the tests' odd lengths) has rows that a TMA map
//   cannot stride, and takes the correctness path: the producer's lanes copy
//   each query row as the 16-byte-aligned window that holds its 64 keys (at
//   most 144 bytes, 9 chunks), a chunk by a 16-byte cp.async, 18 a lane, each
//   lane's cp.async arriving on the stage's `full` barrier as they land
//   (cp.async.mbarrier.arrive.noinc). (The f32 kernel's consumers stage the
//   bias by cp.async while their partial product runs; here the products
//   are ~8x faster and the load's latency would stall them.)
//   bin/study_bwd_tc_bias.py times the two paths at the same Tk (`windows`)
//   and the cycles of a tile (`stamps`). Two stages are all the dk/dv
//   kernel's shared memory holds; a third (dq's holds one) did not shorten
//   the consumers' wait for the next stage: the streams' bandwidth, not
//   their latency.
// - dq (queries x keys), one consumer warpgroup: S = Q.K^T and dP = dO.V^T
//   from the resident q and do and the streamed k and v, all K-major as TMA
//   landed them; the bias added to S's fragment before the scale; dS formed
//   in f32, its bf16 A fragment stored as d(ab) (4-byte pairs where the
//   pair is aligned: every row where Tk is even, every other where it is
//   odd), then dQ += dS.K with B the streamed k slab MN-major. dQ (96 f32
//   registers a thread), S and dP fit one warpgroup. The producer publishes
//   each stage's key-valid bits (flash_attn_bwd_tc_relpos.cu's remedy: the
//   consumers' mask loads cost ~1100 cycles a tile); a key tile with no
//   valid key loads nothing, and its consumers write its d(ab) as zeros.
// - dk/dv (keys x queries), two consumer warpgroups: dK and dV at 192
//   columns each are 192 f32 registers a thread, which one warpgroup cannot
//   hold beside S and dP. So warpgroup A forms S^T = K.Q^T, adds the bias
//   (read transposed), forms P^T and accumulates dV += P^T.dO; warpgroup B
//   forms dP^T = V.dO^T, takes A's f32 P^T from shared memory (one 16 KB
//   buffer of two, each thread's 32 values where its own fragment has them,
//   under an mbarrier pair a buffer: `p_full` by A's 128 threads, `p_empty`
//   by B's), forms dS^T and accumulates dK += dS^T.Q. Each warpgroup issues
//   24 wgmmas a tile; the handoff moves 16 KB inside the SM, where
//   flash_attn_bwd_tc_relpos.cu's cluster moves 32 KB between SMs. (B
//   forming S^T and p itself instead, 1.25x the products, spilled and ran
//   1.4x slower: bin/study_bwd_tc_bias.py's `recompute`.) A key tile with no
//   valid key loads nothing and writes zeros.
// - No atomics, no split over the loop: every output element is written
//   once, by one block, so the bits are the same from run to run and a row's
//   result does not depend on its batch.
//
// Shared memory (dynamic, 1024-byte aligned): the resident tile's two
// operands 6 slabs (48 KB), the ring R_S = 2 stages of 6 slabs and 64 bias
// rows (114 KB), in dk/dv the two p buffers (32 KB), 1 KB of slack: 163 KB
// (dq) and 195 KB (dk/dv), one block an SM. Registers (a consumer thread):
// the output 96, S (or p, ds) 32, dP 32, the A fragment 16: ptxas gives
// the dk/dv kernel 168 and the dq kernel 233 (TMA bias) or 215 (windows),
// with no spill. Bias offsets that are the same on every tile are kept as a
// few bases plus immediates: 32 of them held across the loop spilled the
// dk/dv kernel.

#include "tc_common.cuh"

// %clock stamps of a consumer warpgroup's phases a tile, summed by its
// thread 0 and written over row 0 of its output at columns 8i by the first
// block of (b, h) 0: bin/study_bwd_tc_bias.py's `stamps` variant defines
// BIAS_STAMPS. Nothing otherwise.
#ifdef BIAS_STAMPS
#define STAMP(i)                                     \
  if ((threadIdx.x & 127) == 0) {                    \
    uint32_t c_;                                     \
    asm volatile("mov.u32 %0, %%clock;" : "=r"(c_)); \
    uint32_t* st_ = stamps[threadIdx.x >> 7];        \
    st_[i] += c_ - st_[NSTAMPS];                     \
    st_[NSTAMPS] = c_;                               \
  }
#else
#define STAMP(i)
#endif

namespace {

constexpr int D = 192;                       // d_qk = d_v
constexpr int NS = D / 64;                   // slabs of a 192-column operand
constexpr int R_S = 2;                       // ring stages
constexpr int XBYTES = 2 * NS * SLAB;        // the resident tile's two operands
constexpr int BROW = 144;                    // a window row (cp.async): the 16-byte-aligned window of its 64 keys
constexpr int BIAS_OFF = XBYTES;             // a stage's bias follows its tile's two operands (1024-byte aligned)
constexpr int BTILE = 64 * 64 * 2;           // a TMA bias tile: 64 rows of 128 bytes
constexpr int STAGE = BIAS_OFF + 64 * BROW;  // a streamed tile's two operands and its bias (1024-byte multiple)
constexpr int PTILE = 64 * 64 * 4;           // dk/dv: one f32 p tile, warpgroup A -> B
constexpr int NT_DQ = NTHREADS;              // one consumer warpgroup + the producer warp
constexpr int NT_DKV = 288;                  // two consumer warpgroups + the producer warp
constexpr size_t SMEM_DQ = (size_t)XBYTES + R_S * STAGE + 1024;
constexpr size_t SMEM_DKV = SMEM_DQ + 2 * PTILE;
#ifdef BIAS_STAMPS
constexpr int NSTAMPS = 8;                   // the stamped phases
#endif

// the block's static shared memory: its mbarriers, and what the producer
// publishes a stage besides the bytes
struct Ctl {
  uint64_t x_full;         // the resident operands landed (TMA)
  uint64_t full[R_S];      // a stage landed (TMA, every producer lane's cp.async and its arrive)
  uint64_t empty[R_S];     // a stage's products retired (every consumer thread)
  uint64_t p_full[2];      // dk/dv: warpgroup A's p tile written (A's threads)
  uint64_t p_empty[2];     // dk/dv: warpgroup B has read it (B's threads)
  float lse2[R_S][64];     // dk/dv: the stage's query rows' lse * log2 e (+inf past Tq)
  float di[R_S][64];       // and di (0 past Tq)
  uint32_t kbits[R_S][2];  // dq: the stage's key-valid bits (key c0 + 32w + b: word w, bit b)
};

// TMA's 128-byte swizzle repeats every 1024 bytes: align the slabs to it,
// by pointer arithmetic on the shared array, so the slabs' loads and stores
// stay ld.shared and st.shared that the compiler may batch between barriers
__device__ __forceinline__ uint8_t* align1024(uint8_t* smem) {
  return smem + ((1024u - (smem_u32(smem) & 1023u)) & 1023u);
}

// 16 bytes global -> shared, through L2 only
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
}

// an arrive on `bar` once every cp.async this thread has issued has landed;
// the barrier's count includes it (noinc)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// the bias tile ab[q0 .. q0 + 63, k0 .. k0 + 63] of one (b, h) into the
// stage's window rows (BROW bytes apart), by the producer warp, where no TMA
// map can stride the rows (Tk % 8 != 0, or ab not 16-byte aligned): row r is
// the 16-byte-aligned window that holds its keys, up to 9 chunks of 16
// bytes, each one cp.async, so key k of row r lies at byte bias_at(row's
// first key) + 2k of the row (bias_at: the first key's address mod 16).
// Chunk i = lane + 32n of the tile's 576 is chunk i % 9 of row i / 9, 18 a
// lane, its row and chunk stepped, not divided (with a division and a 64-bit
// product a chunk the producer fell behind). A chunk is copied where it
// holds one of the tile's keys; the last may run past them (the next row's
// values, or past Tk, never past the allocation, whose 16-byte chunks are
// whole), and the chunks after it are left as they were: keys past Tk may
// hold anything, since every consumer selects p = 0 for them rather than
// multiplying, and a p that is 0 makes ds 0. Rows past Tq are zeros (the
// dk/dv kernel's products sum over them).
__device__ __forceinline__ void stage_bias(uint8_t* rows_at, const __nv_bfloat16* ab_bh, int q0, int k0, int Tq,
                                           int Tk, int lane) {
  const __nv_bfloat16* row0 = ab_bh + (size_t)q0 * Tk + k0;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const uint32_t need = 2u * (uint32_t)min(64, Tk - k0);  // the tile's keys' bytes a row
  int r = lane / 9, c = lane % 9;
  const __nv_bfloat16* row = row0 + (size_t)r * Tk;
#pragma unroll 6
  for (int n = 0; n < 64 * (BROW / 16) / 32; ++n) {
    uint8_t* dst = rows_at + r * BROW + 16 * c;
    const uintptr_t at = reinterpret_cast<uintptr_t>(row);
    if (q0 + r >= Tq)
      *reinterpret_cast<uint4*>(dst) = zero;
    else if (16u * c < (uint32_t)(at & 15u) + need)
      cp_async16(smem_u32(dst), reinterpret_cast<const void*>((at & ~static_cast<uintptr_t>(15)) + 16 * c));
    // the next chunk, 32 on: 3 rows and 5 chunks
    c += 5, r += 3, row += 3 * (size_t)Tk;
    if (c >= BROW / 16) c -= BROW / 16, ++r, row += Tk;
  }
}

// the byte of (row r, key k) in a stage's TMA bias tile: 128-byte rows,
// 16-byte chunk k / 8 stored at chunk (k / 8) ^ (r % 8) (128-byte swizzle)
__device__ __forceinline__ uint32_t tile_at(int r, int k) {
  return (uint32_t)(r * 128 + ((((k >> 3) ^ r) & 7) << 4) + 2 * (k & 7));
}

// a key's byte offset inside its bias row: its address mod 16
__device__ __forceinline__ uint32_t bias_at(const __nv_bfloat16* p) {
  return (uint32_t)(reinterpret_cast<uintptr_t>(p) & 15u);
}

// ---------------------------------------------------------------------------
// dq and d(ab): a block a 64-query tile, the loop over key tiles
// ---------------------------------------------------------------------------

// TMA_BIAS: the bias tile by TMA (map_ab), else by the producer's cp.async
// windows (map_ab unused)
template <bool TMA_BIAS>
__global__ void __launch_bounds__(NT_DQ, 1)
flash_attn_bwd_dq_tc_bias_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_do,
                                 const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
                                 const __grid_constant__ CUtensorMap map_ab, const __nv_bfloat16* __restrict__ ab,
                                 const uint8_t* __restrict__ key_mask, const float* __restrict__ lse,
                                 const float* __restrict__ di, __nv_bfloat16* __restrict__ dq,
                                 __nv_bfloat16* __restrict__ dab, int H, int Tq, int Tk, float scale2, float sm_scale,
                                 int dab_pairs) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(16) Ctl ctl;
  uint8_t* sX = align1024(smem_raw);  // q (slabs 0-2) and do (3-5) of the block's queries
  uint8_t* ring = sX + XBYTES;        // R_S stages: k (slabs 0-2), v (3-5) and the bias rows of a key tile

  const int tid = threadIdx.x;
  // uniform to ptxas, so no wgmma sits on a divergent path
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int lane = tid % 32;
  const int r0 = blockIdx.x * 64;  // the block's queries
  const int bh = blockIdx.y;
  const uint8_t* mask_b = key_mask ? key_mask + (size_t)(bh / H) * Tk : nullptr;
  const __nv_bfloat16* ab_bh = ab + (size_t)bh * Tq * Tk;
  __nv_bfloat16* dab_bh = dab ? dab + (size_t)bh * Tq * Tk : nullptr;

  if (tid == 0) {
    mbar_init(&ctl.x_full, 1);
    for (int i = 0; i < R_S; ++i) {
      mbar_init(&ctl.full[i], TMA_BIAS ? 32 : 64);  // every producer lane's arrive (and its cp.async landed)
      mbar_init(&ctl.empty[i], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {
    // ---- producer: q and do once, then every key tile's stage ----
    if (lane == 0) {
      mbar_expect_tx(&ctl.x_full, XBYTES);
      for (int s = 0; s < NS; ++s) {
        tma_load(sX + s * SLAB, &map_q, &ctl.x_full, 64 * s, r0, bh);
        tma_load(sX + (NS + s) * SLAB, &map_do, &ctl.x_full, 64 * s, r0, bh);
      }
    }
    int slot = 0;
    uint32_t phase = 0;
    for (int c0 = 0; c0 < Tk; c0 += 64) {
      // the tile's key-valid bits, read before the stage is free
      const uint32_t w0 = __ballot_sync(0xffffffffu, key_valid(mask_b, c0 + lane, Tk));
      const uint32_t w1 = __ballot_sync(0xffffffffu, key_valid(mask_b, c0 + 32 + lane, Tk));
      const bool any = (w0 | w1) != 0;
      mbar_wait(&ctl.empty[slot], phase ^ 1);
      uint8_t* st = ring + slot * STAGE;
      if (lane == 0) {
        ctl.kbits[slot][0] = w0;
        ctl.kbits[slot][1] = w1;
      }
      if constexpr (!TMA_BIAS) {
        if (any) stage_bias(st + BIAS_OFF, ab_bh, r0, c0, Tq, Tk, lane);
        cp_async_arrive(&ctl.full[slot]);
      }
      if (lane == 0 && any) {
        mbar_expect_tx(&ctl.full[slot], 2 * NS * SLAB + (TMA_BIAS ? BTILE : 0));
        for (int s = 0; s < NS; ++s) {
          tma_load(st + s * SLAB, &map_k, &ctl.full[slot], 64 * s, c0, bh);
          tma_load(st + (NS + s) * SLAB, &map_v, &ctl.full[slot], 64 * s, c0, bh);
        }
        if constexpr (TMA_BIAS) tma_load(st + BIAS_OFF, &map_ab, &ctl.full[slot], c0, r0, bh);
      } else {
        mbar_arrive(&ctl.full[slot]);  // no valid key: the bits alone, and the consumers skip the tile
      }
      if (++slot == R_S) {
        slot = 0;
        phase ^= 1;
      }
    }
    if constexpr (!TMA_BIAS) cp_async_wait_all();
    return;
  }

  // ---- consumers: one warpgroup, 2 rows x 16 columns of a 64 x 64 tile a
  // thread: element 4j + 2h + e is row quad_row + 8h, column 8j + cc + e ----
  const int quad_row = 16 * warp + lane / 4;
  const int cc = 2 * (lane % 4);

#ifdef BIAS_STAMPS
  __shared__ uint32_t stamps[1][NSTAMPS + 1];  // the phases' sums, the last stamp
  if (tid == 0) {
    for (int i = 0; i < NSTAMPS; ++i) stamps[0][i] = 0;
    asm volatile("mov.u32 %0, %%clock;" : "=r"(stamps[0][NSTAMPS]));
  }
#endif

  float o[NS][32];  // dQ, 64-column chunks
#pragma unroll
  for (int c = 0; c < NS; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float lse2_r[2], di_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = r0 + quad_row + 8 * h;
    lse2_r[h] = rr < Tq ? __fmul_rn(__ldg(lse + (size_t)bh * Tq + rr), LOG2E) : INFINITY;
    di_r[h] = rr < Tq ? __ldg(di + (size_t)bh * Tq + rr) : 0.f;
  }
  // d(ab) at the fragment position (row r0 + quad_row + 8h, keys c0 + 8j + cc
  // and + 1), the two bf16 of `w`: one 4-byte store where the pair is whole
  // and 4-byte aligned (every row where Tk is even, every other where it is
  // odd), else one value at a time
  auto put_dab = [&](int c0, int j, int h, uint32_t w) {
    const int rr = r0 + quad_row + 8 * h, kc = c0 + 8 * j + cc;
    if (rr >= Tq || kc >= Tk) return;
    __nv_bfloat16* drow = dab_bh + (size_t)rr * Tk + kc;
    if (kc + 1 < Tk && (reinterpret_cast<uintptr_t>(drow) & 3u) == 0) {
      *reinterpret_cast<uint32_t*>(drow) = w;
      return;
    }
    reinterpret_cast<unsigned short*>(drow)[0] = (unsigned short)(w & 0xFFFFu);
    if (kc + 1 < Tk) reinterpret_cast<unsigned short*>(drow)[1] = (unsigned short)(w >> 16);
  };

  const bool inner = r0 + 64 <= Tq && dab_pairs;  // the block's d(ab) rows are whole and their pairs aligned
  // windows: where each of this thread's rows starts in its bias row (the
  // same for every key tile: a tile is 128 bytes)
  uint32_t boff[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    boff[h] = (quad_row + 8 * h) * BROW + bias_at(ab_bh + (size_t)(r0 + quad_row + 8 * h) * Tk);
  const uint32_t x_addr = smem_u32(sX);
  const uint32_t ring_addr = smem_u32(ring);
  float acc[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = dp[i] = 0.f;
  int slot = 0;
  uint32_t phase = 0;

  mbar_wait(&ctl.x_full, 0);
  STAMP(0)

#pragma unroll 1
  for (int c0 = 0; c0 < Tk; c0 += 64) {
    mbar_wait(&ctl.full[slot], phase);
    STAMP(1)
    // which of this thread's 16 key columns are valid (bit 2j + e), from the
    // stage's bits; a tile without one writes d(ab) = 0 and frees its stage
    const uint32_t w0 = ctl.kbits[slot][0], w1 = ctl.kbits[slot][1];
    uint32_t vbits = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)  // column 8j + cc + e: word j / 4, bit 8 (j % 4) + cc + e
        vbits |= (((j < 4 ? w0 : w1) >> (8 * (j % 4) + cc + e)) & 1u) << (2 * j + e);
    if ((w0 | w1) == 0) {
      if (dab_bh != nullptr)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) put_dab(c0, j, h, 0u);
      mbar_arrive(&ctl.empty[slot]);
      if (++slot == R_S) {
        slot = 0;
        phase ^= 1;
      }
      continue;
    }

    // S = Q.K^T, then dP = dO.V^T, every operand K-major
    const uint32_t y_addr = ring_addr + slot * STAGE;
    const uint8_t* bias = ring + slot * STAGE + BIAS_OFF;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss(acc, slab_desc(x_addr + s * SLAB) + 2 * kk, slab_desc(y_addr + s * SLAB) + 2 * kk, s > 0 || kk > 0);
    wgmma_commit();
#pragma unroll
    for (int s = NS; s < 2 * NS; ++s)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss(dp, slab_desc(x_addr + s * SLAB) + 2 * kk, slab_desc(y_addr + s * SLAB) + 2 * kk, s > NS || kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // S has retired; dP may still run
    fence_acc(acc);
    STAMP(2)

    // p in place of the scores: the bias of (row quad_row + 8h, key 8j + cc
    // + e) added in f32 before the scale
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          const bool seen = ((vbits >> (2 * j + e)) & 1u) != 0;
          const uint32_t off = TMA_BIAS ? tile_at(quad_row + 8 * h, 8 * j + cc + e) : boff[h] + 2 * (8 * j + cc + e);
          const float b = bf16_lo(*reinterpret_cast<const unsigned short*>(bias + off));
          const float x = __fmaf_rn(__fadd_rn(acc[i], b), scale2, -lse2_r[h]);
          acc[i] = exp2f(seen ? x : -INFINITY);  // a select, not a branch around each exp
        }
    STAMP(3)
    wgmma_wait<0>();  // dP has retired
    fence_acc(dp);

    // ds = p (dp - di) sm_scale in f32, then bf16 as the A operand and as d(ab)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      acc[i] = __fmul_rn(__fmul_rn(acc[i], __fsub_rn(dp[i], di_r[h])), sm_scale);
    }
    uint32_t da[4][4];
    frag_to_a(acc, da);
    STAMP(4)
    if (dab_bh != nullptr && inner && c0 + 64 <= Tk) {
      // the tile inside the tensor and Tk even: every pair a 4-byte store
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t* drow = reinterpret_cast<uint32_t*>(dab_bh + (size_t)(r0 + quad_row + 8 * h) * Tk + c0 + cc);
#pragma unroll
        for (int j = 0; j < 8; ++j) drow[4 * j] = da[j >> 1][2 * (j & 1) + h];
      }
    } else if (dab_bh != nullptr) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) put_dab(c0, j, h, da[j >> 1][2 * (j & 1) + h]);
    }
    STAMP(5)

    // dQ chunk c += dS . K[:, c], the streamed k slab MN-major
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NS; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs(o[c], da[kk], slab_desc(y_addr + c * SLAB) + 128 * kk);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < NS; ++c) fence_acc(o[c]);
    fence_frag(da);
    STAMP(6)
    mbar_arrive(&ctl.empty[slot]);
    if (++slot == R_S) {
      slot = 0;
      phase ^= 1;
    }
    STAMP(7)
  }

  // epilogue: dq in bf16, rows r0 + quad_row + 8h
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = r0 + quad_row + 8 * h;
    if (rr >= Tq) continue;
    __nv_bfloat16* orow = dq + ((size_t)bh * Tq + rr) * D;
#pragma unroll
    for (int c = 0; c < NS; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 64 * c + 8 * j + cc) =
            pack_bf16(o[c][4 * j + 2 * h], o[c][4 * j + 2 * h + 1]);
  }
#ifdef BIAS_STAMPS
  if (tid == 0 && bh == 0 && blockIdx.x == 0)
    for (int i = 0; i < NSTAMPS; ++i) dq[8 * i] = __float2bfloat16((float)stamps[0][i]);
#endif
}

// ---------------------------------------------------------------------------
// dk/dv: a block a 64-key tile, the loop over query tiles; warpgroup A (warps
// 0-3) forms p and dV, warpgroup B (warps 4-7) dS and dK, warp 8 produces
// ---------------------------------------------------------------------------

template <bool TMA_BIAS>
__global__ void __launch_bounds__(NT_DKV, 1)
flash_attn_bwd_dkv_tc_bias_kernel(const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
                                  const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_do,
                                  const __grid_constant__ CUtensorMap map_ab, const __nv_bfloat16* __restrict__ ab,
                                  const uint8_t* __restrict__ key_mask, const float* __restrict__ lse,
                                  const float* __restrict__ di, __nv_bfloat16* __restrict__ dk,
                                  __nv_bfloat16* __restrict__ dv, int H, int Tq, int Tk, float scale2,
                                  float sm_scale) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(16) Ctl ctl;
  uint8_t* sX = align1024(smem_raw);  // k (slabs 0-2) and v (3-5) of the block's keys
  uint8_t* ring = sX + XBYTES;        // R_S stages: q (slabs 0-2), do (3-5) and the bias rows of a query tile
  uint8_t* pbuf = ring + R_S * STAGE;  // two f32 p tiles, A -> B

  const int tid = threadIdx.x;
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int lane = tid % 32;
  const int r0 = blockIdx.x * 64;  // the block's keys
  const int bh = blockIdx.y;
  const uint8_t* mask_b = key_mask ? key_mask + (size_t)(bh / H) * Tk : nullptr;
  const __nv_bfloat16* ab_bh = ab + (size_t)bh * Tq * Tk;

  if (tid == 0) {
    mbar_init(&ctl.x_full, 1);
    for (int i = 0; i < R_S; ++i) {
      mbar_init(&ctl.full[i], TMA_BIAS ? 32 : 64);  // every producer lane's arrive (and its cp.async landed)
      mbar_init(&ctl.empty[i], 256);                // every consumer thread of both warpgroups
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&ctl.p_full[i], 128);
      mbar_init(&ctl.p_empty[i], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // a key tile with no valid key loads nothing and writes zeros; the same
  // answer in every thread
  const bool row_any =
      __shfl_sync(0xffffffffu, __syncthreads_or(tid < 64 && key_valid(mask_b, r0 + tid, Tk)), 0) != 0;

  if (warp == 8) {
    // ---- producer: k and v once, then every query tile's stage ----
    if (!row_any) return;
    if (lane == 0) {
      mbar_expect_tx(&ctl.x_full, XBYTES);
      for (int s = 0; s < NS; ++s) {
        tma_load(sX + s * SLAB, &map_k, &ctl.x_full, 64 * s, r0, bh);
        tma_load(sX + (NS + s) * SLAB, &map_v, &ctl.x_full, 64 * s, r0, bh);
      }
    }
    const float* lse_bh = lse + (size_t)bh * Tq;
    const float* di_bh = di + (size_t)bh * Tq;
    int slot = 0;
    uint32_t phase = 0;
    for (int c0 = 0; c0 < Tq; c0 += 64) {
      mbar_wait(&ctl.empty[slot], phase ^ 1);
      uint8_t* st = ring + slot * STAGE;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = lane + 32 * i, qr = c0 + r;
        ctl.lse2[slot][r] = qr < Tq ? __fmul_rn(__ldg(lse_bh + qr), LOG2E) : INFINITY;
        ctl.di[slot][r] = qr < Tq ? __ldg(di_bh + qr) : 0.f;
      }
      if constexpr (!TMA_BIAS) {
        stage_bias(st + BIAS_OFF, ab_bh, c0, r0, Tq, Tk, lane);
        cp_async_arrive(&ctl.full[slot]);
      }
      if (lane == 0) {
        mbar_expect_tx(&ctl.full[slot], 2 * NS * SLAB + (TMA_BIAS ? BTILE : 0));
        for (int s = 0; s < NS; ++s) {
          tma_load(st + s * SLAB, &map_q, &ctl.full[slot], 64 * s, c0, bh);
          tma_load(st + (NS + s) * SLAB, &map_do, &ctl.full[slot], 64 * s, c0, bh);
        }
        if constexpr (TMA_BIAS) tma_load(st + BIAS_OFF, &map_ab, &ctl.full[slot], r0, c0, bh);
      } else {
        mbar_arrive(&ctl.full[slot]);  // releases this lane's lse and di (and its window rows' zeros)
      }
      if (++slot == R_S) {
        slot = 0;
        phase ^= 1;
      }
    }
    if constexpr (!TMA_BIAS) cp_async_wait_all();
    return;
  }

  // ---- consumers: two warpgroups, each 2 rows (keys) x 16 columns
  // (queries) of a 64 x 64 tile a thread: element 4j + 2h + e is key
  // quad_row + 8h, query 8j + cc + e ----
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);  // 0: A (p, dV), 1: B (dS, dK)
  const int t4 = tid % 128;
  const int quad_row = 16 * (warp % 4) + lane / 4;
  const int cc = 2 * (lane % 4);

#ifdef BIAS_STAMPS
  __shared__ uint32_t stamps[2][NSTAMPS + 1];  // each warpgroup's phases' sums, its last stamp
  if (t4 == 0) {
    for (int i = 0; i < NSTAMPS; ++i) stamps[wg][i] = 0;
    asm volatile("mov.u32 %0, %%clock;" : "=r"(stamps[wg][NSTAMPS]));
  }
#endif

  float o[NS][32];  // A: dV, B: dK, 64-column chunks
#pragma unroll
  for (int c = 0; c < NS; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;

  if (row_any) {
    const uint32_t x_addr = smem_u32(sX);
    const uint32_t ring_addr = smem_u32(ring);
    int slot = 0;
    uint32_t phase = 0;
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    mbar_wait(&ctl.x_full, 0);
    STAMP(0)

    if (wg == 0) {
      // ---- A: S^T = K.Q^T, the bias, P^T, dV += P^T.dO ----
      bool rvalid[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) rvalid[h] = key_valid(mask_b, r0 + quad_row + 8 * h, Tk);
      // TMA: the byte of (query cc + e, key quad_row + 8h) in the bias tile;
      // query 8j + cc + e lies 1024 j on (the swizzle repeats every 8 rows),
      // an immediate of the load rather than 32 offsets held across the loop
      uint32_t tb[2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) tb[h][e] = tile_at(cc + e, quad_row + 8 * h);
#pragma unroll 1
      for (int c0 = 0, t = 0; c0 < Tq; c0 += 64, ++t) {
        mbar_wait(&ctl.full[slot], phase);
        STAMP(1)
        const uint32_t y_addr = ring_addr + slot * STAGE;
        const uint8_t* bias = ring + slot * STAGE + BIAS_OFF;
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < NS; ++s)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss(acc, slab_desc(x_addr + s * SLAB) + 2 * kk, slab_desc(y_addr + s * SLAB) + 2 * kk,
                     s > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(acc);
        STAMP(2)

        // p^T in place of the scores: the bias of (query 8j + cc + e, key
        // quad_row + 8h), read down the query-major rows, added in f32
        // before the scale; windows: query row qc starts at byte
        // (a0 + 2 qc Tk) mod 16 of its bias row
        const uint32_t a0 = bias_at(ab_bh + (size_t)c0 * Tk + r0);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 l2 = *reinterpret_cast<const float2*>(&ctl.lse2[slot][8 * j + cc]);
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 4 * j + 2 * h + e;
              const int qc = 8 * j + cc + e, kr = quad_row + 8 * h;
              const uint32_t off = TMA_BIAS ? tb[h][e] + 1024 * j
                                            : qc * BROW + ((a0 + 2u * (uint32_t)qc * (uint32_t)Tk) & 15u) + 2 * kr;
              const float b = bf16_lo(*reinterpret_cast<const unsigned short*>(bias + off));
              const float x = __fmaf_rn(__fadd_rn(acc[i], b), scale2, -(e ? l2.y : l2.x));
              acc[i] = exp2f(rvalid[h] ? x : -INFINITY);  // a select, not a branch around each exp
            }
        }
        STAMP(3)

        // hand p to B: buffer t & 1, once B has read what it held two tiles ago
        const int pb = t & 1;
        if (t >= 2) mbar_wait(&ctl.p_empty[pb], ((t >> 1) - 1) & 1);
        float4* pt = reinterpret_cast<float4*>(pbuf + pb * PTILE);
#pragma unroll
        for (int q4 = 0; q4 < 8; ++q4)
          pt[q4 * 128 + t4] = make_float4(acc[4 * q4], acc[4 * q4 + 1], acc[4 * q4 + 2], acc[4 * q4 + 3]);
        mbar_arrive(&ctl.p_full[pb]);
        STAMP(4)

        // dV chunk c += P^T . dO[:, c], p in bf16 only as the A operand, the
        // streamed do slab MN-major
        uint32_t pa[4][4];
        frag_to_a(acc, pa);
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < NS; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) wgmma_rs(o[c], pa[kk], slab_desc(y_addr + (NS + c) * SLAB) + 128 * kk);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int c = 0; c < NS; ++c) fence_acc(o[c]);
        fence_frag(pa);
        STAMP(5)
        mbar_arrive(&ctl.empty[slot]);
        if (++slot == R_S) {
          slot = 0;
          phase ^= 1;
        }
        STAMP(6)
      }
    } else {
      // ---- B: dP^T = V.dO^T, A's p, dS^T, dK += dS^T.Q ----
#pragma unroll 1
      for (int c0 = 0, t = 0; c0 < Tq; c0 += 64, ++t) {
        mbar_wait(&ctl.full[slot], phase);
        STAMP(1)
        const uint32_t y_addr = ring_addr + slot * STAGE;
        wgmma_fence();
#pragma unroll
        for (int s = NS; s < 2 * NS; ++s)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss(acc, slab_desc(x_addr + s * SLAB) + 2 * kk, slab_desc(y_addr + s * SLAB) + 2 * kk,
                     s > NS || kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(acc);
        STAMP(2)

        const int pb = t & 1;
        mbar_wait(&ctl.p_full[pb], (t >> 1) & 1);
        STAMP(3)
        // ds = p (dp - di) sm_scale in f32, in place of dp, then bf16 as the A operand
        const float4* pt = reinterpret_cast<const float4*>(pbuf + pb * PTILE);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 p = pt[j * 128 + t4];
          const float2 d2 = *reinterpret_cast<const float2*>(&ctl.di[slot][8 * j + cc]);
          const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int i = 4 * j + m;
            acc[i] = __fmul_rn(__fmul_rn(pv[m], __fsub_rn(acc[i], (m & 1) ? d2.y : d2.x)), sm_scale);
          }
        }
        mbar_arrive(&ctl.p_empty[pb]);
        uint32_t da[4][4];
        frag_to_a(acc, da);
        STAMP(4)

        // dK chunk c += dS^T . Q[:, c], the streamed q slab MN-major
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < NS; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) wgmma_rs(o[c], da[kk], slab_desc(y_addr + c * SLAB) + 128 * kk);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int c = 0; c < NS; ++c) fence_acc(o[c]);
        fence_frag(da);
        STAMP(5)
        mbar_arrive(&ctl.empty[slot]);
        if (++slot == R_S) {
          slot = 0;
          phase ^= 1;
        }
        STAMP(6)
      }
    }
  }

  // epilogue: A's dV or B's dK in bf16, rows (keys) r0 + quad_row + 8h
  __nv_bfloat16* out = wg == 0 ? dv : dk;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = r0 + quad_row + 8 * h;
    if (rr >= Tk) continue;
    __nv_bfloat16* orow = out + ((size_t)bh * Tk + rr) * D;
#pragma unroll
    for (int c = 0; c < NS; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 64 * c + 8 * j + cc) =
            pack_bf16(o[c][4 * j + 2 * h], o[c][4 * j + 2 * h + 1]);
  }
#ifdef BIAS_STAMPS
  if (t4 == 0 && bh == 0 && blockIdx.x == 0 && row_any)
    for (int i = 0; i < NSTAMPS; ++i) out[8 * i] = __float2bfloat16((float)stamps[wg][i]);
#endif
}

template <bool DQ, bool TMA_BIAS>
cudaError_t launch(const void* q, const void* k, const void* v, const void* ab, const void* key_mask, const float* lse,
                   const float* di, const void* dout, void* out_a, void* out_b, int B, int H, int Tq, int Tk,
                   float sm_scale, cudaStream_t stream) {
  const int BH = B * H;
  CUtensorMap m[5] = {};
  // dq: q, do (the block's queries), k, v (streamed); dk/dv: k, v, then q, do
  const void* ptr[4] = {DQ ? q : k, DQ ? dout : v, DQ ? k : q, DQ ? v : dout};
  const int rows[4] = {DQ ? Tq : Tk, DQ ? Tq : Tk, DQ ? Tk : Tq, DQ ? Tk : Tq};
  for (int i = 0; i < 4; ++i)
    if (!make_map(&m[i], ptr[i], BH, rows[i], D)) return cudaErrorInvalidValue;
  // the bias [BH, Tq, Tk] in 64 x 64 boxes
  if (TMA_BIAS && !make_map(&m[4], ab, BH, Tq, Tk)) return cudaErrorInvalidValue;
  const dim3 grid(((DQ ? Tq : Tk) + 63) / 64, BH);
  const auto* bias = static_cast<const __nv_bfloat16*>(ab);
  const auto* mask = static_cast<const uint8_t*>(key_mask);
  auto* a = static_cast<__nv_bfloat16*>(out_a);
  auto* b = static_cast<__nv_bfloat16*>(out_b);
  cudaError_t err;
  if constexpr (DQ) {
    static unsigned long long sized = 0;
    err = size_smem_once(flash_attn_bwd_dq_tc_bias_kernel<TMA_BIAS>, SMEM_DQ, sized);
    if (err != cudaSuccess) return err;
    const int dab_pairs = Tk % 2 == 0 && reinterpret_cast<uintptr_t>(out_b) % 4 == 0;
    flash_attn_bwd_dq_tc_bias_kernel<TMA_BIAS><<<grid, NT_DQ, SMEM_DQ, stream>>>(
        m[0], m[1], m[2], m[3], m[4], bias, mask, lse, di, a, b, H, Tq, Tk, sm_scale * LOG2E, sm_scale, dab_pairs);
  } else {
    static unsigned long long sized = 0;
    err = size_smem_once(flash_attn_bwd_dkv_tc_bias_kernel<TMA_BIAS>, SMEM_DKV, sized);
    if (err != cudaSuccess) return err;
    flash_attn_bwd_dkv_tc_bias_kernel<TMA_BIAS><<<grid, NT_DKV, SMEM_DKV, stream>>>(
        m[0], m[1], m[2], m[3], m[4], bias, mask, lse, di, a, b, H, Tq, Tk, sm_scale * LOG2E, sm_scale);
  }
  return cudaGetLastError();
}

// the bias by TMA where a map can stride its rows (Tk % 8 == 0, ab 16-byte
// aligned: every training call), else by the producer's cp.async windows
template <bool DQ>
cudaError_t launch_any(const void* q, const void* k, const void* v, const void* ab, const void* key_mask,
                       const float* lse, const float* di, const void* dout, void* out_a, void* out_b, int B, int H,
                       int Tq, int Tk, float sm_scale, cudaStream_t stream) {
  const bool tma_bias = Tk % 8 == 0 && reinterpret_cast<uintptr_t>(ab) % 16 == 0;
  if (tma_bias)
    return launch<DQ, true>(q, k, v, ab, key_mask, lse, di, dout, out_a, out_b, B, H, Tq, Tk, sm_scale, stream);
  return launch<DQ, false>(q, k, v, ab, key_mask, lse, di, dout, out_a, out_b, B, H, Tq, Tk, sm_scale, stream);
}

// the form both kernels take: bf16, non-causal, a bias, Dqk = Dv = 192; q,
// k, v, dout 16-byte aligned (TMA), the outputs 4-byte aligned, ab and d(ab)
// 2-byte aligned
int check_form(const void* q, const void* k, const void* v, const void* ab, const void* dout, const void* out_a,
               const void* out_b, int B, int H, int Tq, int Tk, int Dqk, int Dv, int is_bf16, int causal) {
  if (!is_bf16 || causal || ab == nullptr || Dqk != D || Dv != D || Tq <= 0 || Tk <= 0 || B <= 0 || H <= 0)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout) % 16 != 0 || (uintptr_t)out_a % 4 != 0 ||
      (uintptr_t)ab % 2 != 0)
    return (int)cudaErrorMisalignedAddress;
  return 0;
}

}  // namespace

// The same arguments and semantics as jatts_flash_attn_bwd_dkv
// (flash_attn_bwd.cu) for K1-bwd's bf16 form with a bias: is_bf16 != 0,
// causal == 0, ab bf16 [B, H, Tq, Tk], Dqk = Dv = 192. q, k, v, dout
// 16-byte aligned, dk, dv 4-byte aligned. Returns a cudaError_t (0 =
// launched); anything else it refuses with cudaErrorInvalidValue (or
// cudaErrorMisalignedAddress).
extern "C" int jatts_flash_attn_bwd_dkv_tc_bias(const void* q, const void* k, const void* v, const void* ab,
                                                const void* key_mask, const void* lse, const void* di,
                                                const void* dout, void* dk, void* dv, int B, int H, int Tq, int Tk,
                                                int Dqk, int Dv, int is_bf16, int causal, float sm_scale,
                                                void* stream) {
  int rc = check_form(q, k, v, ab, dout, dk, dv, B, H, Tq, Tk, Dqk, Dv, is_bf16, causal);
  if (rc == 0 && (uintptr_t)dv % 4 != 0) rc = (int)cudaErrorMisalignedAddress;
  if (rc != 0) return rc;
  return (int)launch_any<false>(q, k, v, ab, key_mask, static_cast<const float*>(lse), static_cast<const float*>(di),
                                dout, dk, dv, B, H, Tq, Tk, sm_scale, static_cast<cudaStream_t>(stream));
}

// As above for jatts_flash_attn_bwd_dq: dq 4-byte aligned; d(ab) = ds
// [B, H, Tq, Tk] bf16 is written, every element, when dab is not null.
extern "C" int jatts_flash_attn_bwd_dq_tc_bias(const void* q, const void* k, const void* v, const void* ab,
                                               const void* key_mask, const void* lse, const void* di,
                                               const void* dout, void* dq, void* dab, int B, int H, int Tq, int Tk,
                                               int Dqk, int Dv, int is_bf16, int causal, float sm_scale,
                                               void* stream) {
  int rc = check_form(q, k, v, ab, dout, dq, dab, B, H, Tq, Tk, Dqk, Dv, is_bf16, causal);
  if (rc == 0 && (uintptr_t)dab % 2 != 0) rc = (int)cudaErrorMisalignedAddress;
  if (rc != 0) return rc;
  return (int)launch_any<true>(q, k, v, ab, key_mask, static_cast<const float*>(lse), static_cast<const float*>(di),
                               dout, dq, dab, B, H, Tq, Tk, sm_scale, static_cast<cudaStream_t>(stream));
}
