// The f32 flash-attention backward on Hopper's tensor cores (sm_90a),
// 3xTF32, plain C interface: the dk/dv kernel and the dq kernel, for K1r's
// f32 form and K1-bwd's.
//
// Replace, for FastSpeech2's f32 training under attn_backend flash, the two
// Pallas TPU kernels of the flash-attention custom VJP (jax/experimental/
// pallas/ops/tpu/flash_attention.py): `_flash_attention_dkv_kernel` (:796;
// pallas_call at :1121) and `_flash_attention_dq_kernel` (:1146; pallas_call
// at :1456; "dab is just ds", :1477). Two forms, non-causal, with a key mask:
// - K1r's, the fused "latest" rel-pos call of jatts_tpu/modules/
//   attention.py:372-385 (JVS-latest): q, k of width d_qk, v, do of width
//   d_v, (d_qk, d_v) = (576, 192) or (192, 64), no bias;
// - K1-bwd's, the legacy rel-pos call `_flash_attend(q_u, k, v, matrix_bd,
//   ...)` of attention.py:334 (the JSUT recipe, adim 384, 2 heads): (d_qk,
//   d_v) = (192, 192), with or without a dense bias ab [B, H, Tq, Tk] f32.
// They compute what the scalar kernels of flash_attn_bwd.cu compute, per
// (b, h):
//
//     p = exp((s + ab) * sm_scale - lse) on the keys a row sees, 0 elsewhere
//     dv = p^T . do        dp = do . v^T        ds = p * (dp - di) * sm_scale
//     dk = ds^T . q        dq = ds . k          d(ab) = ds
//
// with s = q . k^T, ab 0 without a bias, lse the forward's row log-sum-exp
// (+inf on a row that sees no key) and di = rowsum(o * do), both f32 from
// the wrapper. Masked keys, keys past Tk, rows past Tq and rows with lse =
// +inf have p = 0, so a row that sees no key has dq exactly 0, a key that no
// row sees has dk and dv exactly 0, and d(ab) is exactly 0 there (written as
// zeros on a key tile the dq kernel skips). Any Tq, Tk >= 1. The bf16 K1r
// backward and K1-bwd's other forms (bf16, causal, d 64/128/256) stay on the
// scalar kernels.
//
// Numerics, 3xTF32 as in flash_attn_fwd_tc_f32.cu (tc_f32_common.cuh):
// every operand split into hi = rna(x) and lo = rna(x - hi), each product
// hi.lo + lo.hi + hi.hi on the tensor cores. Their f32 sums truncate, so
// every chain is short and starts fresh, added to its running sum in f32
// (round to nearest): the scores and dp over one 32-column slab (12
// wgmmas, the small terms first), dv, dk and dq over one 32-row half of a
// tile and one 64-column chunk (12 wgmmas). p is formed in the base-2
// domain ((s + ab) * sm_scale * log2 e - lse * log2 e, exp2), the bias
// added to s in f32 before the scale, as the forward adds it.
//
// Bounds on an H100 SXM (3.35 TB/s; 3xTF32 at 495 / 3 TFLOP/s; the CUDA
// cores' f32 at 67), at the JVS-latest training decoder (B, H, T = 32, 2,
// 1024, d_qk 576, d_v 192, every key valid): dk/dv does s, dp, dv and dk,
// 2 * B*H*T^2 * (576 + 192 + 192 + 576) = 206.2 GFLOP -> 1.2494 ms (CUDA
// cores 3.08 ms), reading q, k, v, do, lse, di and writing dk, dv (604.5
// MB, 0.18 ms); dq does s, dp and dq, 180.4 GFLOP -> 1.0933 ms (2.69 ms).
// At the JSUT training decoder (B, H, T = 32, 2, 1024, d 192, a dense bias):
// dk/dv 103.1 GFLOP -> 0.6247 ms, reading the bias too (571.0 MB, 0.17 ms);
// dq 77.3 GFLOP -> 0.4685 ms, reading the bias and writing d(ab) (789.1 MB,
// 0.24 ms). The scalar kernels ran at 5.7x their CUDA-core floor.
//
// Design: a thread-block cluster over the widths (the register file cannot
// hold one warpgroup's dk part of 576 columns: 288 registers a thread).
// - A cluster of CL = NQ + 1 blocks shares one 64-row tile (keys in the
//   dk/dv kernel, queries in the dq kernel) of one (b, h): NQ = d_qk / 192
//   score blocks, rank r < NQ owning columns 192r .. 192r + 191 of q and k,
//   and one dp block, rank NQ, owning all d_v columns of v and do. At
//   (576, 192) every block of the dk/dv kernel does the same products: a
//   score block the partial s over its 192 columns and dk over them, the dp
//   block dp over 192 and dv over 192; so at K1-bwd's (192, 192), a cluster
//   of 2. Grid (CL x tiles, B*H), launched with a cluster dimension
//   (cudaLaunchKernelEx).
// - Per tile of the loop (queries in dk/dv, keys in dq), each block forms
//   its partial product X.Y^T over its columns (X its resident tile, Y the
//   streamed one), pushes it into its slot in the shared memory of every
//   block that needs it, waits for the partials it needs, and sums the
//   scores' partials in rank order 0, 1, .. NQ - 1. So every block holds the
//   same s, bit for bit, and forms the same p and ds. No product is done
//   twice.
// - The exchange moves only by st.async (distributed shared memory, counted
//   by the receiving block's mbarrier as the bytes land): the push, into the
//   receiver's `xfull` (its consumer thread 0 expects the tile's bytes), and
//   at the end of the tile, once a consumer bar.sync has ordered the slot
//   reads, one 4-byte acknowledgement a sender into the sender's `xempty`,
//   which it waits on before it pushes the next tile. Nothing in the loop
//   fences at cluster scope: on an H100 a synchronous st.shared::cluster
//   push and mbarrier arrives with release at cluster scope cost ~6000 and
//   ~2500 cycles a tile, as much as the products
//   (bin/study_bwd_tc_f32.py's clock stamps).
//     dk/dv: every block needs the scores; the score blocks need dp. The
//            score blocks then do dK[:, part] += dS^T . Q[:, part], the dp
//            block dV += P^T . dO.
//     dq:    the score blocks need the scores and dp; the dp block pushes
//            dp and does nothing else (a quarter of the cluster's SMs half
//            idle at 576). The score blocks do dQ[:, part] += dS . K[:, part].
// - Orientation (the bf16 backward's): keys x queries in the dk/dv kernel
//   (S^T = K.Q^T, dP^T = V.dO^T), queries x keys in the dq kernel (S =
//   Q.K^T, dP = dO.V^T), so the resident X is k or v (dk/dv), q or do (dq),
//   read K-major as stored, and its fragments are split in registers for
//   every slab, as the forward splits Q's. The output product's A is the
//   p or ds accumulator fragment, and its B (do or q in dk/dv, k in dq)
//   must be K-major over the summed index: .tf32 takes no MN-major operand,
//   so those are streamed as 64-column x 32-row boxes and written transposed
//   by the split pass, their rows permuted in each group of 8 (position a
//   holds row pi(a) = 2a for a < 4, 2(a - 4) + 1 else), which makes the
//   accumulator fragment the k8 A fragment as it stands (the forward's
//   remedy for P.V).
// - The bias (K1-bwd, one score block: NQ = 1) is added once, by the score
//   block, to its partial before the push: so the dk/dv dp block receives
//   s + ab, both blocks form p from the same bits, and the 268 MB bias of
//   the JSUT decoder is read once. The consumers stage each tile's 64 x 64
//   bias by cp.async while the partial product runs, in its natural layout
//   (a query a row, a warp a row at a time: coalesced) in a padded slab, and
//   after a consumer bar.sync add it from shared memory four values at a
//   time, as they are pushed (dk/dv) or summed (dq), never holding the tile
//   in registers (added in one pass first, it took the dq kernel to 255
//   registers and a spill). The dk/dv kernel works on keys x queries, so it
//   reads the slab transposed, one float at a time (rows 68 floats apart: a
//   warp's 32 reads hit 32 banks); the dq kernel reads 8-byte pairs along a
//   row (rows 72 apart, the same for a half-warp's pairs).
// - d(ab) = ds: the dq score block stores its ds fragment as it is formed,
//   before dQ's product, in 8-byte pairs (a warp writes 8 rows x 32 bytes),
//   and zeros for a key tile that it skips (no valid key): every element of
//   d(ab) is written, once, so the wrapper's torch.empty needs no fill.
// - Roles in a block (the forward's): warps 0-3 the consumer warpgroup,
//   warp 4 the TMA producer (the resident X once, then per tile the Y slabs
//   and the transposed boxes through a ring of R raw slabs), warps 5-7 the
//   split pass (each raw slab into a hi and a lo slab in the next of NSB
//   split buffers). The producer, the split warps and the consumers take the
//   same tiles from one rule: every query tile (dk/dv; a key tile with no
//   valid key loads nothing and writes zeros), every key tile with a valid
//   key (dq).
// - No atomics, no split over the loop: every output element is written
//   once, by one block, so the result has the same bits from run to run and
//   a row's result does not depend on its batch.
//
// Shared memory (dynamic, 1024-byte aligned): the resident X 6 slabs (48
// KB), the raw ring R x 8 KB, the split buffers NSB x 16 KB, the exchange
// slots (CL - 1) x 16 KB (one 64 x 64 f32 partial a sender), with a bias
// the bias slab (64 rows of 68 or 72 floats, 17 or 18 KB), plus 1 KB of
// slack: 161 KB (179 KB with a bias) at (192, 192), one block an SM.
// Registers (a consumer thread, one block of 8 warps: 255 at most): the
// running output part 96, the partial (or p or ds) 32, the slab's fresh
// accumulator 32, X's or the A operand's fragments (hi + lo) 32, and at
// the exchange the scores and dp; the fresh accumulator and the fragments
// live in their phase only, and dk/dv's lse and di and the bias wait in
// shared memory, so ptxas needs 229-255 registers by form, with no spill.

#include "tc_f32_common.cuh"

namespace {

constexpr int WS = 192;          // q and k columns a score block owns
constexpr int R_B = 4;           // raw ring slabs
constexpr int NSB_B = 4;         // split buffers (a hi and a lo slab each)
constexpr int NXS = WS / 32;     // resident X slabs (the widest role)
constexpr int XSLOT = 64 * 64 * 4;  // one 64 x 64 f32 partial

template <int DQK, bool DQ, bool BIAS>
struct CfgB {
  static constexpr int NQ = DQK / WS;  // score blocks
  static constexpr int CL = NQ + 1;    // the cluster: the score blocks and the dp block
  // the bias slab's row stride in floats: 68 for the transposed reads of
  // dk/dv, 72 for dq's pairs (conflict-free either way)
  static constexpr int BLD = DQ ? 72 : 68;
  static constexpr size_t SMEM = (size_t)(NXS + R_B + 2 * NSB_B) * FSLAB + (size_t)(CL - 1) * XSLOT +
                                 (BIAS ? (size_t)64 * BLD * 4 : 0) + 1024;
  static_assert(!BIAS || NQ == 1, "a bias only with one score block (d_qk 192)");
};

// the block's static shared memory: its mbarriers and (dk/dv) the staged lse and di
struct Ctl {
  uint64_t x_full;        // the resident X landed (TMA)
  uint64_t full[R_B];     // a raw slab landed (TMA)
  uint64_t empty[R_B];    // a raw slab read by the split warps
  uint64_t ready[NSB_B];  // a split buffer written
  uint64_t freed[NSB_B];  // a split buffer's products retired
  uint64_t xfull;         // every partial this block needs has landed (st.async bytes)
  uint64_t xempty;        // every receiver of this block's partial has read it (st.async acks)
  // dk/dv: each query tile's lse and di (+inf and 0 past Tq), staged by the
  // consumers with cp.async during the tile's partial products, two tiles
  // deep; a consumer reads 16 columns' worth of each
  float cols[2][2][64];
  uint32_t ack;  // the word the receivers' acks land in
};

// ---------------------------------------------------------------------------
// cluster helpers: rank, barrier, distributed shared memory
// ---------------------------------------------------------------------------

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

// the consumer warpgroup's own barrier (warps 0-3; barrier 0 is __syncthreads)
__device__ __forceinline__ void consumer_sync() { asm volatile("bar.sync 1, 128;" ::: "memory"); }

__device__ __forceinline__ float4 ld_shared4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];" : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ float ld_shared1(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ float2 ld_shared2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];" : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}

// K1-bwd's bias tile: ab's 64 x 64 block at (query q0, key k0) of one (b, h)
// into the slab at `dst` in its natural layout (a query a row, rows LD
// floats apart), by the 128 consumer threads, a warp a row at a time, 8
// bytes a thread (stage_bias2_f32: cp.async where the pair is whole and
// aligned); positions past Tq or Tk read as 0
template <int LD>
__device__ __forceinline__ void stage_bias_tile(uint32_t dst, const float* ab_bh, int q0, int k0, int Tq, int Tk,
                                                bool pairs, int tid) {
  const int col = 2 * (tid % 32);
#pragma unroll 4
  for (int i = 0; i < 16; ++i) {
    const int r = 4 * i + tid / 32;
    const float* row = q0 + r < Tq ? ab_bh + (size_t)(q0 + r) * Tk : nullptr;
    stage_bias2_f32(dst + (r * LD + col) * 4, row, k0 + col, Tk, pairs);
  }
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

// who pushes a partial to whom: in the dk/dv kernel everybody to everybody
// (every block needs the scores, the score blocks dp); in the dq kernel
// only to the score blocks (the dp block needs nothing)
template <int NQ, bool DQ>
__device__ __forceinline__ bool sends_to(int from, int to) {
  return from != to && (!DQ || to < NQ);
}

template <int NQ, bool DQ>
__device__ __forceinline__ int n_senders(int to) {
  return DQ && to >= NQ ? 0 : NQ;  // the cluster's other NQ blocks
}

template <int NQ, bool DQ>
__device__ __forceinline__ int n_receivers(int from) {
  return DQ ? (from < NQ ? NQ - 1 : NQ) : NQ;
}

// a receiver's exchange slot for the partial of sender `from` (every rank
// but its own, in rank order)
__device__ __forceinline__ int slot_of(int from, int to) { return from < to ? from : from - 1; }

// ---------------------------------------------------------------------------
// one role of the cluster: W columns of X and Y (192 for a score block, d_v
// for the dp block)
// ---------------------------------------------------------------------------

template <int DQK, bool DQ, bool BIAS, int W, bool SCORE>
__device__ __forceinline__ void run_role(const CUtensorMap* map_x, const CUtensorMap* map_y,
                                         const CUtensorMap* map_w, Ctl& ctl, uint8_t* base, int role,
                                         const uint8_t* mask_b, const float* lse_bh, const float* di_bh,
                                         const float* ab_bh, float* dab_bh, float* out, int out_ld, int Tq,
                                         int Tk, float scale2, float sm_scale) {
  using C = CfgB<DQK, DQ, BIAS>;
  constexpr int NQ = C::NQ, CL = C::CL, BLD = C::BLD;
  constexpr bool SBIAS = BIAS && SCORE;         // this block adds the bias (and in dq writes d(ab))
  constexpr int NSL = W / 32;                   // X and Y slabs
  constexpr int NCH = W / 64;                   // 64-column chunks of the output part
  constexpr bool OUT = SCORE || !DQ;            // the dq kernel's dp block has no output product
  constexpr int NW = OUT ? 2 * NCH : 0;         // transposed boxes a tile (32-row half-major)
  static_assert(W % 64 == 0 && W <= WS, "role width");

  uint8_t* sX = base;                             // NXS raw slabs, resident
  uint8_t* ring = sX + NXS * FSLAB;               // R_B raw slabs
  uint8_t* split = ring + R_B * FSLAB;            // NSB_B x (hi slab, lo slab)
  uint8_t* xbuf = split + 2 * NSB_B * FSLAB;      // CL - 1 exchange slots (slot_of)
  uint8_t* sbias = xbuf + (CL - 1) * XSLOT;       // with a bias: the tile's bias, 64 rows of BLD floats

  const int tid = threadIdx.x;
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int lane = tid % 32;
  const int tile = blockIdx.x / CL;
  const int r0 = tile * 64;  // this cluster's rows: keys (dk/dv) or queries (dq)
  const int bh = blockIdx.y;
  const int col0 = SCORE ? WS * role : 0;  // this block's first column of X, Y and the output
  const int T_loop = DQ ? Tk : Tq;         // the loop runs over query tiles (dk/dv) or key tiles (dq)

  // dk/dv: a key tile with no valid key loads nothing and writes zeros; the
  // same answer in every thread of every block of the cluster
  bool row_any = true;
  if (!DQ)
    row_any = __shfl_sync(0xffffffffu, __syncthreads_or(tid < 64 && key_valid(mask_b, r0 + tid, Tk)), 0) != 0;
  // dq: the loop takes the key tiles with a valid key, producer, split warps
  // and consumers alike
  auto tile_has_key = [&](int c0) {
    return !DQ || __any_sync(0xffffffffu, key_valid(mask_b, c0 + lane, Tk) || key_valid(mask_b, c0 + 32 + lane, Tk));
  };

  if (warp == 4) {
    // ---- producer: X once, then every tile's Y slabs and transposed boxes ----
    if (!row_any) return;
    if (lane == 0) {
      mbar_expect_tx(&ctl.x_full, NSL * FSLAB);
      for (int s = 0; s < NSL; ++s) tma_load(sX + s * FSLAB, map_x, &ctl.x_full, col0 + 32 * s, r0, bh);
    }
    int slot = 0;
    uint32_t phase = 0;
    for (int c0 = 0; c0 < T_loop; c0 += 64) {
      if (!tile_has_key(c0)) continue;
      if (lane == 0) {
        for (int s = 0; s < NSL + NW; ++s) {
          mbar_wait(&ctl.empty[slot], phase ^ 1);
          mbar_expect_tx(&ctl.full[slot], FSLAB);
          if (s < NSL) {
            tma_load(ring + slot * FSLAB, map_y, &ctl.full[slot], col0 + 32 * s, c0, bh);
          } else {
            const int j = s - NSL;  // half j / NCH, chunk j % NCH
            tma_load(ring + slot * FSLAB, map_w, &ctl.full[slot], col0 + 64 * (j % NCH), c0 + 32 * (j / NCH), bh);
          }
          if (++slot == R_B) {
            slot = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  if (warp > 4) {
    // ---- the split pass: each raw slab into a hi and a lo slab ----
    if (!row_any) return;
    const int st = tid - 5 * 32;
    int slot = 0, sb = 0;
    uint32_t phase = 0, sphase = 0;
    for (int c0 = 0; c0 < T_loop; c0 += 64) {
      if (!tile_has_key(c0)) continue;
      for (int s = 0; s < NSL + NW; ++s) {
        mbar_wait(&ctl.freed[sb], sphase ^ 1);
        mbar_wait(&ctl.full[slot], phase);
        const uint8_t* src = ring + slot * FSLAB;
        uint8_t* hi = split + sb * 2 * FSLAB;
        if (s < NSL) {
          // a Y slab: element by element, its swizzled layout kept
#pragma unroll 3
          for (int f = st; f < FSLAB / 16; f += NSPLITTERS) {
            uint4 h, w;
            split4(reinterpret_cast<const float4*>(src)[f], h, w);
            reinterpret_cast<uint4*>(hi)[f] = h;
            reinterpret_cast<uint4*>(hi + FSLAB)[f] = w;
          }
        } else {
          // a box (32 rows of the summed index x 64 columns) transposed and
          // permuted: 16-byte chunk ch of slab row n (column n of the box)
          // holds positions 4ch .. 4ch + 3, box rows 8(ch / 2) + ch % 2 + 2i
#pragma unroll 3
          for (int c = st; c < FSLAB / 16; c += NSPLITTERS) {
            const int n = c % 64, ch = c / 64;
            const float* c0p = reinterpret_cast<const float*>(src) + (8 * (ch / 2) + ch % 2) * 64 + n;
            uint4 h, w;
            split4(make_float4(c0p[0], c0p[128], c0p[256], c0p[384]), h, w);
            const uint32_t off = swz(n, 4 * ch);
            *reinterpret_cast<uint4*>(hi + off) = h;
            *reinterpret_cast<uint4*>(hi + FSLAB + off) = w;
          }
        }
        fence_proxy_async();
        mbar_arrive(&ctl.empty[slot]);
        mbar_arrive(&ctl.ready[sb]);
        if (++slot == R_B) {
          slot = 0;
          phase ^= 1;
        }
        if (++sb == NSB_B) {
          sb = 0;
          sphase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: one warpgroup, 2 rows x 16 columns of a 64 x 64 tile a
  // thread: element 4j + 2h + e is row quad_row + 8h, column 8j + cc + e ----
  const int quad_row = 16 * warp + lane / 4;
  const int c4 = lane % 4;
  const int cc = 2 * c4;

  float o[NCH][32];
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;

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
    int sb = 0;
    uint32_t sphase = 0;
    int held = 0;
    uint32_t tx = 0;  // tiles exchanged so far
    const uint32_t split_addr = smem_u32(split);
    const uint32_t xbuf_addr = smem_u32(xbuf);
    const uint32_t bias_addr = smem_u32(sbias);
    const uint8_t* x_row = sX + quad_row * 128;
    // the bias and d(ab) by 8-byte pairs where Tk and the pointer allow
    const bool ab_pairs = Tk % 2 == 0 && (reinterpret_cast<uintptr_t>(ab_bh) & 7) == 0;
    const bool dab_pairs = Tk % 2 == 0 && (reinterpret_cast<uintptr_t>(dab_bh) & 7) == 0;
    // the bias of fragment positions 4q4 .. 4q4 + 3 (rows quad_row + 8h,
    // columns 8q4 + cc + e) added to acc from the slab: dk/dv (keys x
    // queries) reads the query-major slab transposed, one float at a time,
    // dq reads two 8-byte pairs
    auto add_bias4 = [&](float (&acc)[32], int q4) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = quad_row + 8 * h, col = 8 * q4 + cc;
        const float2 b = DQ ? ld_shared2(bias_addr + (row * BLD + col) * 4)
                            : make_float2(ld_shared1(bias_addr + (col * BLD + row) * 4),
                                          ld_shared1(bias_addr + ((col + 1) * BLD + row) * 4));
        acc[4 * q4 + 2 * h] += b.x;
        acc[4 * q4 + 2 * h + 1] += b.y;
      }
    };
    // d(ab) at the fragment position (row r0 + quad_row + 8h, keys c0 + 8j +
    // cc and + 1; the dq score block): one 8-byte store where the pair is
    // whole and aligned, else one float at a time (an odd Tk, the ragged edge)
    auto put_dab2 = [&](int c0, int j, int h, float x, float y) {
      const int rr = r0 + quad_row + 8 * h, kc = c0 + 8 * j + cc;
      if (rr >= Tq) return;
      float* drow = dab_bh + (size_t)rr * Tk;
      if (dab_pairs && kc + 1 < Tk) {
        *reinterpret_cast<float2*>(drow + kc) = make_float2(x, y);
        return;
      }
      if (kc < Tk) drow[kc] = x;
      if (kc + 1 < Tk) drow[kc + 1] = y;
    };

    auto take_split = [&](uint64_t& b_hi, uint64_t& b_lo) {
      mbar_wait(&ctl.ready[sb], sphase);
      const uint32_t b = split_addr + sb * 2 * FSLAB;
      b_hi = slab_desc(b);
      b_lo = slab_desc(b + FSLAB);
    };
    auto issued = [&]() {
      wgmma_commit();
      held = sb;
      if (++sb == NSB_B) {
        sb = 0;
        sphase ^= 1;
      }
    };
    // tmp = X.Y^T over slab ks (the forward's s_slab): once its split buffer
    // is ready, retire the previous slab's products, fold their tmp into acc
    // and free their buffer, then this slab's 4 k-steps, the small terms first
    auto part_slab = [&](float (&acc)[32], float (&tmp)[32], uint32_t (&xa)[4][8], int ks) {
      uint64_t b_hi, b_lo;
      take_split(b_hi, b_lo);
      wgmma_wait<0>();
      fence_acc(tmp);
      keep_frags(xa);
      if (ks > 0) {
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] += tmp[i];
        mbar_arrive(&ctl.freed[held]);
      }
      const uint8_t* xs = x_row + ks * FSLAB;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t o0 = ((((2 * kk) ^ (lane / 4))) << 4) + c4 * 4;
        const uint32_t o1 = ((((2 * kk + 1) ^ (lane / 4))) << 4) + c4 * 4;
        split_tf32(*reinterpret_cast<const float*>(xs + o0), xa[kk][0], xa[kk][4]);
        split_tf32(*reinterpret_cast<const float*>(xs + 1024 + o0), xa[kk][1], xa[kk][5]);
        split_tf32(*reinterpret_cast<const float*>(xs + o1), xa[kk][2], xa[kk][6]);
        split_tf32(*reinterpret_cast<const float*>(xs + 1024 + o1), xa[kk][3], xa[kk][7]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_tf32(tmp, xa[kk][0], xa[kk][1], xa[kk][2], xa[kk][3], b_lo + 2 * kk, kk != 0);
        wgmma_tf32(tmp, xa[kk][4], xa[kk][5], xa[kk][6], xa[kk][7], b_hi + 2 * kk, 1);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_tf32(tmp, xa[kk][0], xa[kk][1], xa[kk][2], xa[kk][3], b_hi + 2 * kk, 1);
      issued();
    };
    // tmp = A.B over a transposed slab (the forward's pv_slab): fold the
    // previous slab's tmp into its output chunk (when fold), then 4 k-steps
    auto out_slab = [&](float (&tmp)[32], float (&o_prev)[32], bool fold, const uint32_t (&pa)[4][8]) {
      uint64_t b_hi, b_lo;
      take_split(b_hi, b_lo);
      wgmma_wait<0>();
      fence_acc(tmp);
      if (fold) {
#pragma unroll
        for (int i = 0; i < 32; ++i) o_prev[i] += tmp[i];
        mbar_arrive(&ctl.freed[held]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_3xtf32(tmp, pa[kk], b_hi + 2 * kk, b_lo + 2 * kk, kk != 0);
      issued();
    };

    mbar_wait(&ctl.x_full, 0);

#pragma unroll 1
    for (int c0 = 0; c0 < T_loop; c0 += 64) {
      // dq: which of this thread's 16 key columns are valid (bit 2j + e); a
      // quad covers the tile's 64 columns, so the tile skip is uniform
      uint32_t vbits = 0xFFFFFFFFu;
      if (DQ) {
        vbits = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (key_valid(mask_b, c0 + 8 * j + cc + e, Tk)) vbits |= 1u << (2 * j + e);
        uint32_t tile_bits = vbits;
        tile_bits |= __shfl_xor_sync(0xffffffffu, tile_bits, 1);
        tile_bits |= __shfl_xor_sync(0xffffffffu, tile_bits, 2);
        tile_bits = __shfl_sync(0xffffffffu, tile_bits, 0);
        if (tile_bits == 0) {  // the producer and the split warps skipped it too
          if (SBIAS && dab_bh != nullptr)  // d(ab) = 0 there: every element is written
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int h = 0; h < 2; ++h) put_dab2(c0, j, h, 0.f, 0.f);
          continue;
        }
      }

      // this tile's exchange: the bytes every sender will store here (the
      // previous tile's phase completed before this thread got here)
      if (tid == 0 && n_senders<NQ, DQ>(role) > 0) mbar_expect_tx(&ctl.xfull, n_senders<NQ, DQ>(role) * XSLOT);
      if (!DQ) {
        const int qc = c0 + (tid & 63);
        const uint32_t dst = smem_u32(&ctl.cols[tx & 1][tid >> 6][tid & 63]);
        if (qc < Tq)
          cp_async4(dst, (tid < 64 ? lse_bh : di_bh) + qc);
        else
          asm volatile("st.shared.f32 [%0], %1;" ::"r"(dst), "f"(tid < 64 ? INFINITY : 0.f) : "memory");
        cp_async_commit();
      }
      // the tile's bias (queries x keys), staged while the partial runs
      if (SBIAS) {
        stage_bias_tile<BLD>(bias_addr, ab_bh, DQ ? r0 : c0, DQ ? c0 : r0, Tq, Tk, ab_pairs, tid);
        cp_async_commit();
      }

      // this block's partial over its W columns: NSL slabs, each in a fresh
      // accumulator added to acc in f32. The fresh accumulator and the
      // fragments live in a phase only (zeroed here: a wgmma operand is read
      // as well as written), not across the exchange
      float acc[32], tmp[32];
      uint32_t xa[4][8];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        acc[i] = tmp[i] = 0.f;
        xa[i / 8][i % 8] = 0u;
      }
#pragma unroll 1
      for (int ks = 0; ks < NSL; ++ks) part_slab(acc, tmp, xa, ks);
      wgmma_wait<0>();
      fence_acc(tmp);
      keep_frags(xa);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] += tmp[i];
      mbar_arrive(&ctl.freed[held]);

      // the bias: added to the scores once, four values at a time as they
      // are pushed (dk/dv) or summed (dq), once every consumer's staging landed
      if (SBIAS) {
        cp_async_wait_all();
        consumer_sync();
      }

      // push it into its slot in every block that needs it, once they have
      // read the previous tile's
      if (n_receivers<NQ, DQ>(role) > 0) {
        if (tx > 0) mbar_wait_cluster(&ctl.xempty, (tx - 1) & 1);
        // this tile's acks, before this thread's own stores (a receiver acks
        // only after all of them have landed)
        if (tid == 0) mbar_expect_tx(&ctl.xempty, n_receivers<NQ, DQ>(role) * 4);
#pragma unroll
        for (int j = 0; j < CL; ++j) {
          if (!sends_to<NQ, DQ>(role, j)) continue;
          const uint32_t dst = peer_addr(xbuf_addr + slot_of(role, j) * XSLOT + tid * 16, j);
          const uint32_t bar = peer_addr(smem_u32(&ctl.xfull), j);
#pragma unroll
          for (int q4 = 0; q4 < 8; ++q4) {
            if (SBIAS) add_bias4(acc, q4);  // the one receiver, the dp block (NQ = 1)
            st_async4(dst + q4 * 128 * 16, acc[4 * q4], acc[4 * q4 + 1], acc[4 * q4 + 2], acc[4 * q4 + 3], bar);
          }
        }
      }
      if constexpr (OUT) {  // the dq kernel's dp block has nothing more to do
        // the partials this block needs: the scores summed in rank order (the
        // same bits in every block), dp from the dp block's slot (score blocks)
        mbar_wait_cluster(&ctl.xfull, tx & 1);
        if (!DQ) {  // the tile's lse and di, every consumer's cp.async landed
          cp_async_wait_all();
          consumer_sync();
        }
        float s[32], dp[32];
#pragma unroll
        for (int q4 = 0; q4 < 8; ++q4) {
          float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int i = 0; i < NQ; ++i) {
            float4 t;
            if (SCORE && i == role) {
              if (DQ && SBIAS) add_bias4(acc, q4);  // dq's score block pushes nothing
              t = make_float4(acc[4 * q4], acc[4 * q4 + 1], acc[4 * q4 + 2], acc[4 * q4 + 3]);
            } else
              t = ld_shared4(xbuf_addr + slot_of(i, role) * XSLOT + (q4 * 128 + tid) * 16);
            if (i == 0) {
              sum = t;
            } else {
              sum.x = __fadd_rn(sum.x, t.x);
              sum.y = __fadd_rn(sum.y, t.y);
              sum.z = __fadd_rn(sum.z, t.z);
              sum.w = __fadd_rn(sum.w, t.w);
            }
          }
          s[4 * q4] = sum.x, s[4 * q4 + 1] = sum.y, s[4 * q4 + 2] = sum.z, s[4 * q4 + 3] = sum.w;
          const float4 d = SCORE ? ld_shared4(xbuf_addr + slot_of(NQ, role) * XSLOT + (q4 * 128 + tid) * 16)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
          dp[4 * q4] = d.x, dp[4 * q4 + 1] = d.y, dp[4 * q4 + 2] = d.z, dp[4 * q4 + 3] = d.w;
        }

        // p (and ds in a score block) in place: a[i] is the A operand's value
        float a[32];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float2 l2 = make_float2(0.f, 0.f), d2 = make_float2(0.f, 0.f);
          if (!DQ) {
            l2 = *reinterpret_cast<const float2*>(&ctl.cols[tx & 1][0][8 * j + cc]);
            d2 = *reinterpret_cast<const float2*>(&ctl.cols[tx & 1][1][8 * j + cc]);
          }
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 4 * j + 2 * h + e;
              const bool seen = DQ ? ((vbits >> (2 * j + e)) & 1u) != 0 : rvalid[h];
              const float lse2 = DQ ? lse2_r[h] : __fmul_rn(e ? l2.y : l2.x, LOG2E);
              const float di = DQ ? di_r[h] : (e ? d2.y : d2.x);
              const float p = seen ? exp2f(__fmaf_rn(s[i], scale2, -lse2)) : 0.f;
              a[i] = SCORE ? __fmul_rn(__fmul_rn(p, __fsub_rn(dp[i], di)), sm_scale) : p;
            }
          // d(ab) = ds, stored as it is formed (the dq score block)
          if (DQ && SBIAS && dab_bh != nullptr)
#pragma unroll
            for (int h = 0; h < 2; ++h) put_dab2(c0, j, h, a[4 * j + 2 * h], a[4 * j + 2 * h + 1]);
        }

        // the output product, one 32-row half of the tile at a time (its A
        // fragments: k-step kk at positions c4, c4 + 4 = columns cc, cc + 1 of
        // the accumulator, the rows of the transposed slab permuted to match),
        // each (half, chunk) slab in a fresh accumulator added to its chunk
#pragma unroll
        for (int i = 0; i < 32; ++i) tmp[i] = 0.f;
#pragma unroll
        for (int kh = 0; kh < 2; ++kh) {
          uint32_t pa[4][8];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const int i = 16 * kh + 4 * kk;
            split_tf32(a[i + 0], pa[kk][0], pa[kk][4]);
            split_tf32(a[i + 2], pa[kk][1], pa[kk][5]);
            split_tf32(a[i + 1], pa[kk][2], pa[kk][6]);
            split_tf32(a[i + 3], pa[kk][3], pa[kk][7]);
          }
#pragma unroll
          for (int c = 0; c < NCH; ++c) out_slab(tmp, o[c > 0 ? c - 1 : 0], c > 0, pa);
          wgmma_wait<0>();
          fence_acc(tmp);
          keep_frags(pa);
#pragma unroll
          for (int i = 0; i < 32; ++i) o[NCH - 1][i] += tmp[i];
          mbar_arrive(&ctl.freed[held]);
        }
        // the slots were read (bar.sync orders every consumer's loads before
        // it): free them in every sender, which next needs them after its
        // next partial product
        consumer_sync();
        if (tid == 0)
          for (int j = 0; j < CL; ++j)
            if (sends_to<NQ, DQ>(j, role))
              st_async_ack(peer_addr(smem_u32(&ctl.ack), j), peer_addr(smem_u32(&ctl.xempty), j));
      }
      ++tx;
    }
    // every receiver of this block's partials has read the last one, so no
    // block of the cluster touches this block's shared memory after it exits
    if (n_receivers<NQ, DQ>(role) > 0 && tx > 0) mbar_wait_cluster(&ctl.xempty, (tx - 1) & 1);
  }
  if (!OUT) return;

  // epilogue: the output part in f32, rows r0 + quad_row + 8h
  const int T_rows = DQ ? Tq : Tk;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = r0 + quad_row + 8 * h;
    if (rr >= T_rows) continue;
    float* orow = out + ((size_t)bh * T_rows + rr) * out_ld + col0;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float2*>(orow + 64 * c + 8 * j + cc) =
            make_float2(o[c][4 * j + 2 * h], o[c][4 * j + 2 * h + 1]);
  }
}

// DQ false: the dk/dv kernel (maps x: k, v; y: q, do; w: q, do boxes; outs
// dk, dv). DQ true: the dq kernel (x: q, do; y: k, v; w: k boxes; out dq,
// and d(ab) when dab is not null). The score blocks take the *_s maps, the
// dp block the *_p ones. BIAS: ab [B, H, Tq, Tk] is added to the scores.
template <int DQK, int DV, bool DQ, bool BIAS>
__global__ void __launch_bounds__(NTHREADS_F, 1)
flash_attn_bwd_tc_f32_kernel(const __grid_constant__ CUtensorMap map_x_s,
                             const __grid_constant__ CUtensorMap map_x_p,
                             const __grid_constant__ CUtensorMap map_y_s,
                             const __grid_constant__ CUtensorMap map_y_p,
                             const __grid_constant__ CUtensorMap map_w_s,
                             const __grid_constant__ CUtensorMap map_w_p,
                             const uint8_t* __restrict__ key_mask, const float* __restrict__ lse,
                             const float* __restrict__ di, const float* __restrict__ ab,
                             float* __restrict__ out_s, float* __restrict__ out_p, float* __restrict__ dab, int H,
                             int Tq, int Tk, float scale2, float sm_scale) {
  using C = CfgB<DQK, DQ, BIAS>;
  static_assert(DQK % WS == 0 && DV % 64 == 0 && DV <= WS, "tc f32 backward widths");
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(16) Ctl ctl;
  // TMA's 128-byte swizzle repeats every 1024 bytes: align the slabs to it
  // (the same offset in every block of the cluster: one kernel, one layout)
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  // uniform to ptxas, so no wgmma sits on a divergent path
  const int role = __shfl_sync(0xffffffffu, (int)cluster_rank(), 0);
  const int bh = blockIdx.y;

  if (threadIdx.x == 0) {
    mbar_init(&ctl.x_full, 1);
    for (int i = 0; i < R_B; ++i) {
      mbar_init(&ctl.full[i], 1);
      mbar_init(&ctl.empty[i], NSPLITTERS);
    }
    for (int i = 0; i < NSB_B; ++i) {
      mbar_init(&ctl.ready[i], NSPLITTERS);
      mbar_init(&ctl.freed[i], 128);
    }
    mbar_init(&ctl.xfull, 1);  // one expect_tx arrive a tile; the senders' st.async bring the bytes
    mbar_init(&ctl.xempty, 1);  // one expect_tx arrive a tile; the receivers' st.async acks bring the bytes
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // no block pushes into a peer before the peer's barriers exist
  cluster_sync();

  const uint8_t* mask_b = key_mask ? key_mask + (size_t)(bh / H) * Tk : nullptr;
  const float* lse_bh = lse + (size_t)bh * Tq;
  const float* di_bh = di + (size_t)bh * Tq;
  const float* ab_bh = BIAS ? ab + (size_t)bh * Tq * Tk : nullptr;
  float* dab_bh = BIAS && dab != nullptr ? dab + (size_t)bh * Tq * Tk : nullptr;
  if (role < C::NQ)
    run_role<DQK, DQ, BIAS, WS, true>(&map_x_s, &map_y_s, &map_w_s, ctl, base, role, mask_b, lse_bh, di_bh, ab_bh,
                                      dab_bh, out_s, DQK, Tq, Tk, scale2, sm_scale);
  else
    run_role<DQK, DQ, BIAS, DV, false>(&map_x_p, &map_y_p, &map_w_p, ctl, base, role, mask_b, lse_bh, di_bh,
                                       ab_bh, dab_bh, out_p, DV, Tq, Tk, scale2, sm_scale);
}

template <int DQK, int DV, bool DQ, bool BIAS>
cudaError_t launch(const void* q, const void* k, const void* v, const void* ab, const void* key_mask,
                   const float* lse, const float* di, const void* dout, void* out_a, void* out_b, void* dab, int B,
                   int H, int Tq, int Tk, float sm_scale, cudaStream_t stream) {
  using C = CfgB<DQK, DQ, BIAS>;
  const int BH = B * H;
  // x, y: 32-column x 64-row boxes, swizzled, as the product reads them;
  // w: 64-column x 32-row boxes, plain, for the split pass to transpose
  const void* xs = DQ ? q : k;
  const void* xp = DQ ? dout : v;
  const void* ys = DQ ? k : q;
  const void* yp = DQ ? v : dout;
  const int Tx = DQ ? Tq : Tk, Ty = DQ ? Tk : Tq;
  CUtensorMap m[6];
  if (!make_map_f32(&m[0], xs, BH, Tx, DQK, 32, 64, true) || !make_map_f32(&m[1], xp, BH, Tx, DV, 32, 64, true) ||
      !make_map_f32(&m[2], ys, BH, Ty, DQK, 32, 64, true) || !make_map_f32(&m[3], yp, BH, Ty, DV, 32, 64, true) ||
      !make_map_f32(&m[4], ys, BH, Ty, DQK, 64, 32, false) ||
      !make_map_f32(&m[5], DQ ? ys : yp, BH, Ty, DQ ? DQK : DV, 64, 32, false))
    return cudaErrorInvalidValue;
  auto kernel = flash_attn_bwd_tc_f32_kernel<DQK, DV, DQ, BIAS>;
  static unsigned long long sized = 0;
  cudaError_t err = size_smem_once(kernel, C::SMEM, sized);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C::CL * (((DQ ? Tq : Tk) + 63) / 64), BH);
  cfg.blockDim = dim3(NTHREADS_F);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C::CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, m[0], m[1], m[2], m[3], m[4], m[5],
                           static_cast<const uint8_t*>(key_mask), lse, di, static_cast<const float*>(ab),
                           static_cast<float*>(out_a), static_cast<float*>(out_b), static_cast<float*>(dab), H, Tq,
                           Tk, sm_scale * LOG2E, sm_scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// the forms both kernels take: f32, non-causal, (Dqk, Dv) in {(192, 64),
// (576, 192)} without a bias, (192, 192) with or without one; q, k, v, dout
// 16-byte aligned (TMA), the outputs 8-byte aligned, ab and dab 4-byte
int check_form(const void* q, const void* k, const void* v, const void* ab, const void* dout, const void* out_a,
               const void* out_b, const void* dab, int B, int H, int Tq, int Tk, int Dqk, int Dv, int is_bf16,
               int causal) {
  if (is_bf16 || causal || Tq <= 0 || Tk <= 0 || B <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const bool k1_form = Dqk == 192 && Dv == 192;
  if (!(k1_form || (Dqk == 192 && Dv == 64) || (Dqk == 576 && Dv == 192))) return (int)cudaErrorInvalidValue;
  if ((ab != nullptr && !k1_form) || (dab != nullptr && ab == nullptr)) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout) % 16 != 0 ||
      ((uintptr_t)out_a | (uintptr_t)out_b) % 8 != 0 || ((uintptr_t)ab | (uintptr_t)dab) % 4 != 0)
    return (int)cudaErrorMisalignedAddress;
  return 0;
}

template <bool DQ>
int dispatch(const void* q, const void* k, const void* v, const void* ab, const void* key_mask, const void* lse,
             const void* di, const void* dout, void* out_a, void* out_b, void* dab, int B, int H, int Tq, int Tk,
             int Dqk, int Dv, float sm_scale, void* stream) {
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(di);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dqk == 576)
    return (int)launch<576, 192, DQ, false>(q, k, v, ab, key_mask, l, d, dout, out_a, out_b, dab, B, H, Tq, Tk,
                                            sm_scale, s);
  if (Dv == 64)
    return (int)launch<192, 64, DQ, false>(q, k, v, ab, key_mask, l, d, dout, out_a, out_b, dab, B, H, Tq, Tk,
                                           sm_scale, s);
  if (ab != nullptr)
    return (int)launch<192, 192, DQ, true>(q, k, v, ab, key_mask, l, d, dout, out_a, out_b, dab, B, H, Tq, Tk,
                                           sm_scale, s);
  return (int)launch<192, 192, DQ, false>(q, k, v, ab, key_mask, l, d, dout, out_a, out_b, dab, B, H, Tq, Tk,
                                          sm_scale, s);
}

}  // namespace

// The same arguments and semantics as jatts_flash_attn_bwd_dkv
// (flash_attn_bwd.cu) for the f32 forms: is_bf16 == 0, causal == 0, (Dqk,
// Dv) in {(192, 64), (576, 192)} with ab null (K1r), (192, 192) with ab
// null or f32 [B, H, Tq, Tk] (K1-bwd). q, k, v, dout 16-byte aligned, dk,
// dv 8-byte aligned. Returns a cudaError_t (0 = launched); anything else it
// refuses with cudaErrorInvalidValue (or cudaErrorMisalignedAddress).
extern "C" int jatts_flash_attn_bwd_dkv_tc_f32(const void* q, const void* k, const void* v, const void* ab,
                                               const void* key_mask, const void* lse, const void* di,
                                               const void* dout, void* dk, void* dv, int B, int H, int Tq, int Tk,
                                               int Dqk, int Dv, int is_bf16, int causal, float sm_scale,
                                               void* stream) {
  const int rc = check_form(q, k, v, ab, dout, dk, dv, nullptr, B, H, Tq, Tk, Dqk, Dv, is_bf16, causal);
  if (rc != 0) return rc;
  return dispatch<false>(q, k, v, ab, key_mask, lse, di, dout, dk, dv, nullptr, B, H, Tq, Tk, Dqk, Dv, sm_scale,
                         stream);
}

// As above for jatts_flash_attn_bwd_dq: dq 8-byte aligned; d(ab) = ds
// [B, H, Tq, Tk] f32 is written, every element, when dab is not null,
// which needs a bias (K1-bwd's (192, 192)).
extern "C" int jatts_flash_attn_bwd_dq_tc_f32(const void* q, const void* k, const void* v, const void* ab,
                                              const void* key_mask, const void* lse, const void* di,
                                              const void* dout, void* dq, void* dab, int B, int H, int Tq, int Tk,
                                              int Dqk, int Dv, int is_bf16, int causal, float sm_scale,
                                              void* stream) {
  const int rc = check_form(q, k, v, ab, dout, dq, nullptr, dab, B, H, Tq, Tk, Dqk, Dv, is_bf16, causal);
  if (rc != 0) return rc;
  return dispatch<true>(q, k, v, ab, key_mask, lse, di, dout, dq, nullptr, dab, B, H, Tq, Tk, Dqk, Dv, sm_scale,
                        stream);
}
