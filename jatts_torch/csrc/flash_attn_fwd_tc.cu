// K1, K1b and K1r in bf16 on Hopper's tensor cores (sm_90a), plain C
// interface.
//
// Replaces, for bf16 inputs, the Pallas TPU flash-attention forward (the
// pallas_call at jax/experimental/pallas/ops/tpu/flash_attention.py:758) as
// jatts_tpu/modules/attention.py:158 (_flash_attend) drives it, its fused
// "latest" rel-pos call (jatts_tpu/modules/attention.py:372-385), and its
// causal form (K1b, causal=True: the block skip below_or_on_diag at :325 and
// :379, the element mask col_ids <= row_ids AND-ed with the segment mask at
// :426-434), which VALL-E's AR trunk drives
// (jatts_tpu/modules/valle_modules.py:101).
// It computes exactly what the scalar kernels of flash_attn_fwd.cu compute,
// per (b, h):
//
//     out = softmax((q . k^T + ab) * sm_scale) . v      over valid keys
//
// - the bias [B,H,Tq,Tk] (optional) is added BEFORE the scale;
// - keys whose key_mask byte is 0, and keys past Tk, are never seen;
// - causal (K1b; Tq == Tk, d_qk == d_v): query row i sees key j only when
//   j <= i, AND-ed with the key mask;
// - a row with no valid key returns exactly 0 and, when lse is asked for,
//   lse = +inf; otherwise lse = m + log(l) of the scaled scores in f32, which
//   the backward kernels (flash_attn_bwd.cu, flash_attn_bwd_tc.cu) read.
// q and k have width D_QK, v and out width D_V (D_QK == D_V for K1's
// forms; (576, 192) and (192, 64) for K1r's).
//
// Numerics: S and the output accumulate in f32 on the tensor cores; the
// softmax runs in f32 in the base-2 domain (scores times sm_scale*log2(e),
// exp2). The one difference from the scalar kernel: P is rounded to bf16
// before the P.V product, where the scalar kernel keeps it in f32. The row
// sum l is taken over the f32 values. The output is rounded once to bf16.
//
// Bounds on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16):
// - K1 at the serving decoder (B,H,T,d = 8,2,1024,192, dense bias): q, k, v,
//   out (4 x 6.3 MB) and the bias (33.5 MB) are 58.7 MB -> 0.0175 ms by
//   bytes; 12.9 GFLOP -> 0.0130 ms.
// - K1r at the serving decoder (8,2,1024, d_qk 576, d_v 192, no bias): 25.8
//   GFLOP -> 0.0261 ms by operations; 50.3 MB -> 0.0150 ms.
// - K1b at VALL-E AR's attention (16,16,1088,64, key mask, lse): q, k, v,
//   out (4 x 35.7 MB), lse (1.1 MB) are 143.7 MB -> 0.0429 ms by bytes; the
//   causal half of the two products, 38.8 GFLOP -> 0.0392 ms.
// The scalar kernels ran all three on the CUDA cores in f32 (67 TFLOP/s)
// with bf16 widened to f32 in shared memory and synchronous loads: 43x, 72x
// and 44x off those bounds.
//
// Design:
// - One block a 64-row query tile of one (b, h): warps 0-3 are one consumer
//   warpgroup, warp 4 the producer. Grid (ceil(Tq/64), B*H); at the serving
//   decoder 16 x 16 = 256 blocks, two resident on each SM, one wave.
// - Everything in shared memory is bf16, in 64 x 64 slabs of 8 KB (a 128-byte
//   row each, 128-byte swizzle), written by TMA (cp.async.bulk.tensor, 3-d
//   maps over [B*H, T, D], so rows past T are zero-filled and never read from
//   the next head; encoded per call on the host by the CUDA driver API's
//   cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so the
//   library links no -lcuda, and passed as __grid_constant__ arguments).
//   The query tile stays resident (D_QK/64 slabs). Each key
//   tile is streamed as D_QK/64 slabs of k and then D_V/64 slabs of v through
//   one ring of R slabs with a full and an empty mbarrier each; the producer
//   runs up to R slabs ahead of the products. At (576, 192) that is K1r's
//   9 k slabs a key tile, accumulated into one S.
// - S = Q.K^T: wgmma.mma_async m64n64k16, both operands from shared memory,
//   K-major (k as stored), 4 k-steps a slab, f32 accumulators (32 a thread).
//   The slab's wgmma group is committed and the previous slab is released as
//   soon as its group retires, so the next slab's wait overlaps the products.
// - The online softmax runs on the accumulator fragments: a thread holds 2
//   rows x 16 columns, a row lives in the 4 threads of a quad, so a row max
//   and sum are two xor shuffles. Masking and the m = -inf guard are the
//   scalar kernel's.
// - O += P.V: wgmma m64n64k16 with A = P from registers (the S fragment,
//   exponentiated and packed to bf16x2 pairs in place: the accumulator
//   layout of m64n16 is the A-operand layout) and B = a v slab in its
//   transposed (MN-major) form; one product a 64-column slab of v, into
//   D_V/64 accumulator chunks of 32 floats.
// - The bias goes by cp.async (4 bytes, the 2 bf16 of one fragment position)
//   from global memory into a shared slab, each consumer thread staging just
//   the positions of its own S fragment, issued before the S product so the
//   copies overlap it, and read back after it (no barrier: a thread reads only
//   what it staged; 16 registers fewer held across the product). Where Tk is
//   odd a pair is not 4-byte aligned and is loaded and stored by the thread
//   instead, so Tk = 1 or 1001 need no padding copy. Each element is read
//   once. TMA cannot take it: its row stride Tk*2 bytes is not 16-byte aligned
//   for odd Tk.
// - Causal (a compile-time CAUSAL, so the non-causal forms are the code they
//   were): with BQ = BK = 64 and the top-left alignment, query tile q0
//   takes key tiles k0 < min(Tk, q0 + 64) only, the producer and the
//   consumers to the same bound, so the tiles above the diagonal are never
//   loaded, as the TPU kernel skips them. The one diagonal tile (k0 == q0)
//   is masked element by element on the S fragment before the row max. The
//   query tiles are taken in reverse block order, so the heaviest (last)
//   start first.
// - A key tile with no valid key (a padded tail of a shorter utterance) is
//   skipped by the producer and the consumers alike, decided from the key
//   mask by each: m, l and O stay bit-identical, and its slabs are never
//   loaded. No atomics, no split over keys: a row's result depends on its own
//   row, its keys and its bias only, never on the batch it sits in.
//
// Shared memory (dynamic, 1024-byte aligned; R slabs of ring; the d_qk == d_v
// forms also an 8 KB bias slab):
//   (64, 64)    Q 8 KB   + ring 6 x 8 KB  + bias 8 KB = 64 KB
//   (128, 128)  Q 16 KB  + ring 8 x 8 KB  + bias 8 KB = 88 KB
//   (192, 192)  Q 24 KB  + ring 9 x 8 KB  + bias 8 KB = 104 KB
//   (256, 256)  Q 32 KB  + ring 9 x 8 KB  + bias 8 KB = 112 KB
//   (192, 64)   Q 24 KB  + ring 8 x 8 KB  = 88 KB
//   (576, 192)  Q 72 KB  + ring 4 x 8 KB  = 104 KB
// plus 1 KB of alignment slack each: two blocks fit on an SM (228 KB, less 1
// KB a block for the system) in every form but (256, 256), whose 128 output
// accumulators a thread allow one block anyway. Registers: two blocks of 5
// warps put 3 warps on some of the SM's 4 register files, which caps a
// thread at 168 registers. (576, 192) trades lookahead for occupancy: two
// full 72 KB k tiles would not fit even in one block, and a ring of 18 slabs
// in one block a SM would make the 256 serving blocks two waves; with 4 slabs
// of lookahead the second resident block fills the first one's waits.

#include "tc_common.cuh"

namespace {

template <int DQK, int DV>
struct Cfg {
  static constexpr int NK = DQK / 64;  // k (and q) slabs a tile
  static constexpr int NV = DV / 64;   // v slabs a tile
  static constexpr int R = (DQK == 576) ? 4 : (DQK == 192 && DV == 192) ? 9
                         : (DQK == 256) ? 9 : (DQK == 128) ? 8 : (DQK == 192) ? 8 : 6;
  static constexpr int MINB = DV == 256 ? 1 : 2;  // blocks an SM the registers allow
  static constexpr int NB = DQK == DV ? 1 : 0;  // the bias staging slab (K1's forms)
  static constexpr size_t SMEM = (size_t)(NK + R + NB) * SLAB + 1024;  // + alignment slack
};

// the key columns kc, kc+1 of a bias row (null: a row past Tq) as bf16x2
// into the shared word dst: by cp.async where the pair is whole and 4-byte
// aligned (Tk even), else by plain loads (an odd Tk, the ragged edge)
__device__ __forceinline__ void stage_bias2(uint32_t dst, const __nv_bfloat16* row, int kc, int Tk,
                                            bool pairs) {
  if (row != nullptr && pairs && kc + 1 < Tk) {
    cp_async4(dst, row + kc);
    return;
  }
  uint32_t lo = 0u, hi = 0u;
  if (row != nullptr) {
    const unsigned short* r = reinterpret_cast<const unsigned short*>(row);
    lo = kc < Tk ? __ldg(r + kc) : 0u;
    hi = kc + 1 < Tk ? __ldg(r + kc + 1) : 0u;
  }
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(dst), "r"(lo | (hi << 16)) : "memory");
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

template <int DQK, int DV, bool BIAS, bool CAUSAL>
__global__ void __launch_bounds__(NTHREADS, Cfg<DQK, DV>::MINB)
flash_attn_fwd_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __nv_bfloat16* __restrict__ ab, const uint8_t* __restrict__ key_mask,
                         __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int H, int Tq,
                         int Tk, float scale2) {
  using C = Cfg<DQK, DV>;
  constexpr int NK = C::NK, NV = C::NV, R = C::R;
  static_assert(DQK % 64 == 0 && DV % 64 == 0 && DV <= 256, "tc widths");
  static_assert(!CAUSAL || DQK == DV, "no causal d_qk != d_v form");

  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full;
  __shared__ __align__(8) uint64_t full[R];
  __shared__ __align__(8) uint64_t empty[R];
  // TMA's 128-byte swizzle repeats every 1024 bytes: align the slabs to it
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* sQ = base;                 // NK slabs
  uint8_t* ring = base + NK * SLAB;   // R slabs
  uint8_t* sB = ring + R * SLAB;      // the bias tile (NB == 1): 16 words a consumer thread

  const int tid = threadIdx.x;
  // broadcast from lane 0: warp-uniform to ptxas, so no wgmma sits on a
  // divergent path
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int lane = tid % 32;
  // causal: the last query tile (the most key tiles) is scheduled first
  const int q0 = (CAUSAL ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * BQ;
  const int bh = blockIdx.y;  // b * H + h
  const uint8_t* mask_b = key_mask ? key_mask + (size_t)(bh / H) * Tk : nullptr;
  // causal (Tq == Tk, top-left aligned): no row of this tile sees a key at
  // or past q0 + BQ, so the key tiles stop at the diagonal one (k0 == q0).
  // The producer and the consumers both loop to this bound: a slab the
  // consumers never take would never be released, and the reverse hangs.
  const int k_end = CAUSAL ? min(Tk, q0 + BQ) : Tk;

  if (tid == 0) {
    mbar_init(&q_full, 1);
    for (int i = 0; i < R; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 128);  // every consumer thread arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {
    // ---- producer: the query tile, then every key tile with a valid key ----
    if (lane == 0) {
      mbar_expect_tx(&q_full, NK * SLAB);
      for (int s = 0; s < NK; ++s) tma_load(sQ + s * SLAB, &map_q, &q_full, 64 * s, q0, bh);
    }
    int slot = 0;
    uint32_t phase = 0;
    for (int k0 = 0; k0 < k_end; k0 += BK) {
      const bool any = __any_sync(0xffffffffu, key_valid(mask_b, k0 + lane, Tk) ||
                                                   key_valid(mask_b, k0 + 32 + lane, Tk));
      if (!any) continue;
      if (lane == 0) {
        for (int s = 0; s < NK + NV; ++s) {
          mbar_wait(&empty[slot], phase ^ 1);
          mbar_expect_tx(&full[slot], SLAB);
          if (s < NK)
            tma_load(ring + slot * SLAB, &map_k, &full[slot], 64 * s, k0, bh);
          else
            tma_load(ring + slot * SLAB, &map_v, &full[slot], 64 * (s - NK), k0, bh);
          if (++slot == R) {
            slot = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- consumers: one warpgroup, 2 rows x 16 columns of S a thread ----
  const int quad_row = 16 * warp + lane / 4;  // rows quad_row and quad_row + 8
  const int cc = 2 * (lane % 4);              // columns 8j + cc, 8j + cc + 1
  const bool pairs = (Tk % 2) == 0;           // bias pairs 4-byte aligned
  const __nv_bfloat16* brow[2] = {nullptr, nullptr};
  if (BIAS) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qr = q0 + quad_row + 8 * h;
      if (qr < Tq) brow[h] = ab + ((size_t)bh * Tq + qr) * Tk;
    }
  }

  float o[NV][32];
#pragma unroll
  for (int c = 0; c < NV; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  int slot = 0;
  uint32_t phase = 0;
  const uint32_t q_addr = smem_u32(sQ);
  const uint32_t ring_addr = smem_u32(ring);
  const uint32_t sb_addr = smem_u32(sB);

  mbar_wait(&q_full, 0);

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

    // the bias of this thread's fragment positions, staged while S runs:
    // word (h, j) of thread tid at sB + 4*(128*(8h + j) + tid): a warp's 32
    // words of one (h, j) lie on 32 banks
    if (BIAS) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          stage_bias2(sb_addr + 4 * (128 * (8 * h + j) + tid), brow[h], k0 + 8 * j + cc, Tk, pairs);
      cp_async_commit();
    }

    // S = Q.K^T over NK slabs of k, 4 k-steps each
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
    int prev = -1;
#pragma unroll 1
    for (int ks = 0; ks < NK; ++ks) {
      mbar_wait(&full[slot], phase);
      const uint64_t da = slab_desc(q_addr + ks * SLAB);
      const uint64_t db = slab_desc(ring_addr + slot * SLAB);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss(s, da + 2 * kk, db + 2 * kk, (ks | kk) != 0);
      wgmma_commit();
      if (prev >= 0) {
        wgmma_wait<1>();
        mbar_arrive(&empty[prev]);
      }
      prev = slot;
      if (++slot == R) {
        slot = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_acc(s);
    mbar_arrive(&empty[prev]);

    // bias, scale (base 2), mask; online softmax on the fragments
    uint32_t bias[2][8];
    if (BIAS) {
      cp_async_wait_all();  // each thread reads back only the words it staged
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          asm volatile("ld.shared.b32 %0, [%1];"
                       : "=r"(bias[h][j]) : "r"(sb_addr + 4 * (128 * (8 * h + j) + tid)) : "memory");
    }
    // the diagonal tile (causal, k0 == q0): column 8j + cc + e is seen by
    // row quad_row + 8h when 8j + e <= lim[h]. Written with k0 and q0 so
    // that the 32 comparisons are not hoisted out of the key loop into 32
    // registers held across it
    int lim[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) lim[h] = q0 + quad_row + 8 * h - k0 - cc;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = s[4 * j + 2 * h + e];
          if (BIAS) x += e ? bf16_hi(bias[h][j]) : bf16_lo(bias[h][j]);
          bool seen = (vbits >> (2 * j + e)) & 1u;
          if (CAUSAL && k0 == q0) seen = seen && 8 * j + e <= lim[h];
          x = seen ? x * scale2 : -INFINITY;
          s[4 * j + 2 * h + e] = x;
          mx[h] = fmaxf(mx[h], x);
        }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      // a row with no valid key so far keeps m = -inf and shifts by 0
      const float shift = m_new == -INFINITY ? 0.f : m_new;
      alpha[h] = exp2f(m[h] - shift);
      m[h] = m_new;
      mx[h] = shift;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(s[4 * j + 2 * h + e] - mx[h]);
          s[4 * j + 2 * h + e] = p;
          rs[h] += p;
        }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
      l[h] = l[h] * alpha[h] + rs[h];
    }
    // P as the A operand: k-step kk holds columns 16kk..16kk+15
    uint32_t pa[4][4];
    frag_to_a(s, pa);
#pragma unroll
    for (int c = 0; c < NV; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] *= alpha[(i >> 1) & 1];

    // O += P.V, one 64-column slab of v at a time
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      mbar_wait(&full[slot], phase);
      const uint64_t db = slab_desc(ring_addr + slot * SLAB);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs(o[c], pa[kk], db + 128 * kk);  // 16 keys = 2048 bytes
      wgmma_commit();
      if (c > 0) {
        wgmma_wait<1>();
        mbar_arrive(&empty[prev]);
      }
      prev = slot;
      if (++slot == R) {
        slot = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < NV; ++c) fence_acc(o[c]);
    mbar_arrive(&empty[prev]);
  }

  // epilogue: O / l in bf16, lse = (m + log2 l) ln 2
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qr = q0 + quad_row + 8 * h;
    if (qr >= Tq) continue;
    const float inv = l[h] > 0.f ? 1.f / l[h] : 0.f;
    __nv_bfloat16* orow = out + ((size_t)bh * Tq + qr) * DV;
#pragma unroll
    for (int c = 0; c < NV; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t v2 = pack_bf16(o[c][4 * j + 2 * h] * inv, o[c][4 * j + 2 * h + 1] * inv);
        *reinterpret_cast<uint32_t*>(orow + 64 * c + 8 * j + cc) = v2;
      }
    if (lse != nullptr && (lane % 4) == 0)
      lse[(size_t)bh * Tq + qr] = l[h] > 0.f ? (m[h] + log2f(l[h])) * LN2 : INFINITY;
  }
}

template <int DQK, int DV, bool BIAS, bool CAUSAL = false>
cudaError_t launch(const void* q, const void* k, const void* v, const void* ab, const void* key_mask,
                   void* out, float* lse, int B, int H, int Tq, int Tk, float sm_scale,
                   cudaStream_t stream) {
  using C = Cfg<DQK, DV>;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, B * H, Tq, DQK) || !make_map(&mk, k, B * H, Tk, DQK) ||
      !make_map(&mv, v, B * H, Tk, DV))
    return cudaErrorInvalidValue;
  static unsigned long long sized = 0;
  cudaError_t err = size_smem_once(flash_attn_fwd_tc_kernel<DQK, DV, BIAS, CAUSAL>, C::SMEM, sized);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + BQ - 1) / BQ, B * H);
  flash_attn_fwd_tc_kernel<DQK, DV, BIAS, CAUSAL><<<grid, NTHREADS, C::SMEM, stream>>>(
      mq, mk, mv, static_cast<const __nv_bfloat16*>(ab), static_cast<const uint8_t*>(key_mask),
      static_cast<__nv_bfloat16*>(out), lse, H, Tq, Tk, sm_scale * LOG2E);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, const void* ab, const void* key_mask,
                     void* out, float* lse, int B, int H, int Tq, int Tk, float sm_scale, bool causal,
                     cudaStream_t stream) {
  if (ab != nullptr) {
    if (causal) return launch<D, D, true, true>(q, k, v, ab, key_mask, out, lse, B, H, Tq, Tk, sm_scale, stream);
    return launch<D, D, true, false>(q, k, v, ab, key_mask, out, lse, B, H, Tq, Tk, sm_scale, stream);
  }
  if (causal) return launch<D, D, false, true>(q, k, v, ab, key_mask, out, lse, B, H, Tq, Tk, sm_scale, stream);
  return launch<D, D, false, false>(q, k, v, ab, key_mask, out, lse, B, H, Tq, Tk, sm_scale, stream);
}

}  // namespace

// The same arguments and semantics as jatts_flash_attn_fwd (flash_attn_fwd.cu)
// for the forms this kernel has: bf16 (is_bf16 != 0); Dqk == Dv in {64, 128,
// 192, 256} with or without ab, causal (Tq == Tk) or not, or (Dqk, Dv) in
// {(192, 64), (576, 192)} without ab and not causal. q, k, v 16-byte
// aligned, ab 4-byte aligned. Returns a cudaError_t (0 = launched); anything
// else it refuses with cudaErrorInvalidValue (or cudaErrorMisalignedAddress).
extern "C" int jatts_flash_attn_fwd_tc(const void* q, const void* k, const void* v, const void* ab,
                                       const void* key_mask, void* out, void* lse, int B, int H,
                                       int Tq, int Tk, int Dqk, int Dv, int is_bf16, int causal,
                                       float sm_scale, void* stream) {
  if (!is_bf16 || Tq <= 0 || Tk <= 0 || (causal && (Tq != Tk || Dqk != Dv)))
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 != 0 || (uintptr_t)ab % 4 != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (Dqk != Dv) {
    if (ab != nullptr) return (int)cudaErrorInvalidValue;
    if (Dqk == 192 && Dv == 64)
      return (int)launch<192, 64, false>(q, k, v, ab, key_mask, out, l, B, H, Tq, Tk, sm_scale, s);
    if (Dqk == 576 && Dv == 192)
      return (int)launch<576, 192, false>(q, k, v, ab, key_mask, out, l, B, H, Tq, Tk, sm_scale, s);
    return (int)cudaErrorInvalidValue;
  }
  const bool c = causal != 0;
  switch (Dqk) {
    case 64: return (int)launch_d<64>(q, k, v, ab, key_mask, out, l, B, H, Tq, Tk, sm_scale, c, s);
    case 128: return (int)launch_d<128>(q, k, v, ab, key_mask, out, l, B, H, Tq, Tk, sm_scale, c, s);
    case 192: return (int)launch_d<192>(q, k, v, ab, key_mask, out, l, B, H, Tq, Tk, sm_scale, c, s);
    case 256: return (int)launch_d<256>(q, k, v, ab, key_mask, out, l, B, H, Tq, Tk, sm_scale, c, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
