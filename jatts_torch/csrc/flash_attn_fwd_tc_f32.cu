// K1 and K1r in f32 on Hopper's tensor cores (sm_90a), 3xTF32, plain C
// interface.
//
// Replaces, for f32 non-causal inputs, the Pallas TPU flash-attention forward
// (the pallas_call at jax/experimental/pallas/ops/tpu/flash_attention.py:758)
// as jatts_tpu/modules/attention.py:158 (_flash_attend) drives it, and its
// fused "latest" rel-pos call (jatts_tpu/modules/attention.py:372-385): the
// forms FastSpeech2 trains through (f32 parameters, attn_backend flash). It
// computes exactly what the scalar kernels of flash_attn_fwd.cu compute, per
// (b, h):
//
//     out = softmax((q . k^T + ab) * sm_scale) . v      over valid keys
//
// - the bias [B,H,Tq,Tk] (optional, d_qk == d_v only) is added BEFORE the
//   scale;
// - keys whose key_mask byte is 0, and keys past Tk, are never seen;
// - a row with no valid key returns exactly 0 and, when lse is asked for,
//   lse = +inf; otherwise lse = m + log(l) of the scaled scores in f32, which
//   the backward kernels (flash_attn_bwd.cu) read.
// Forms: (d_qk, d_v) in {(64, 64), (128, 128), (192, 192)} with or without
// the bias, and K1r's (192, 64) and (576, 192) without; non-causal only. The
// f32 causal form (K1b) and d 256 stay on the scalar kernel.
//
// Numerics, 3xTF32 (CUTLASS's big + small convention): every operand x of
// both products is split into hi = rna(x) and lo = rna(x - hi), rna being
// cvt.rna.tf32.f32's rounding done in two integer operations, and a product
// is hi.lo + lo.hi + hi.hi on the tensor cores. hi is rounded explicitly, so
// nothing rests on what the tensor core does with an operand's 13 low bits.
// The dropped lo.lo term and x - hi - lo are ~2^-22 relative. What is left
// is the tensor cores' f32 sum, which truncates: a
// chain of wgmmas into one accumulator loses about half an ulp of the
// accumulator at each step. Over all of d_qk = 576 (216 steps) and all the
// keys (24 a key tile) that missed K1r's 1e-5 tolerance on the card, as a
// model of those sums does (tests/test_torch_flash_tc_f32.py: 1.55e-5). So
// every chain is short and starts fresh:
// one k slab's 12 wgmmas of S (the 8 small terms first, while the
// accumulator is small), one v slab's 12 of P.V, each added to S or O with
// an f32 add that rounds to nearest. The online softmax, l and m run in f32
// in the base-2 domain (scores times sm_scale*log2(e), exp2), as in the
// bf16 kernel; the output and lse are f32. One TF32 pass misses the f32
// tolerances (1e-4 absolute for K1, 1e-5 relative for K1r) by 5-100x.
//
// Bounds on an H100 SXM (3.35 TB/s; 495 TFLOP/s TF32, so 3xTF32 is 165
// TFLOP/s of f32-faithful products; the CUDA cores' f32 is 67 TFLOP/s):
// - K1 at the training decoder (B,H,T,d = 32,2,1024,192, dense f32 bias,
//   lse): 51.54 GFLOP x 3 -> 0.3124 ms by operations; q, k, v, out (4 x 50.3
//   MB), the bias (268.4 MB) and lse are 470.1 MB -> 0.1403 ms.
// - K1r at the training decoder (32,2,1024, d_qk 576, d_v 192, lse): 103.1
//   GFLOP x 3 -> 0.6248 ms; 402.9 MB -> 0.1203 ms.
// The scalar kernels (flash_attn_fwd.cu) run the same products as f32 FMAs
// on the CUDA cores: their floors are 0.7692 and 1.5385 ms.
//
// Design:
// - One block a 64-row query tile of one (b, h), 8 warps in three roles:
//   warps 0-3 are the consumer warpgroup (the products and the softmax),
//   warp 4 the TMA producer, warps 5-7 the split pass. Grid (ceil(Tq/64),
//   B*H), one block an SM (the shared memory below).
// - wgmma .tf32 is m64nNk8 and takes both shared-memory operands K-major (a
//   32-bit type has no transpose), so every slab here is 64 rows x 32 f32:
//   one 128-byte swizzle row a row, 8 KB, 1024-byte aligned.
// - The producer streams each key tile as raw f32 slabs by TMA
//   (cp.async.bulk.tensor, 3-d maps over [B*H, T, D], rows past T
//   zero-filled): d_qk/32 slabs of k (32 columns x 64 keys, 128-byte
//   swizzle, the layout the product reads), then 2 x d_v/64 slabs of v (64
//   columns x 32 keys, unswizzled; key half-major), through a ring of R raw
//   slabs with a full and an empty mbarrier each. The query tile lands raw
//   and stays (d_qk/32 slabs).
// - The split pass (warps 5-7, 96 threads): each raw slab becomes a hi and
//   a lo slab in the next of NSB split buffers, k element by element in its
//   own swizzled layout, v transposed (keys contiguous, as P.V's K-major B
//   operand needs) and with its keys permuted in each group of 8 (below);
//   fence.proxy.async orders the stores before the wgmma that reads them,
//   and a ready mbarrier a buffer hands it to the consumers, who free it
//   (a freed mbarrier) once the products that read it have retired. On the
//   consumers themselves the pass could not overlap their products; beside
//   them it still takes a fifth to a quarter of the kernel's time on an H100
//   (bin/study_fwd_tc_f32.py).
// - Each slab's products start once its split buffer is ready: the
//   consumers retire the previous slab's (wgmma.wait_group 0), fold their
//   accumulator in (Numerics) and free its buffer, then issue this slab's.
// - S = Q.K^T: A = Q from registers. Q at d_qk 576 in hi + lo would be 295
//   KB of shared memory; raw it is 147 KB, so each k-step's fragment (4
//   floats a thread) is read from the raw tile and split in registers, again
//   for every key tile (2-3% of the kernel's time on an H100). B = the k
//   split slabs, 4 k-steps of 8 each.
// - The online softmax runs on the S fragments as in the bf16 kernel: a
//   thread holds 2 rows x 16 columns (row 16w + lane/4 (+8), columns 8j +
//   2(lane%4) (+1)), a row lives in a quad, so a row max and sum are two xor
//   shuffles.
// - O += P.V: A = P from registers. The k8 .tf32 A fragment holds, for
//   k-step kk, row r at columns c and c + 4 (c = lane%4), where the S
//   accumulator holds columns 2c and 2c + 1. Instead of a shuffle, the split
//   pass writes v's keys into the transposed slab in that order: position a
//   of a group of 8 holds key pi(a) = 2a (a < 4) or 2(a - 4) + 1, so the A
//   fragment of k-step kk is {s[4kk], s[4kk+2], s[4kk+1], s[4kk+3]} as it
//   stands. The product sums over keys, so one consistent permutation of P's
//   columns and v's rows changes nothing but the summation order. B = the
//   v split slab of a 32-key half of the tile and a 64-column chunk of d_v
//   (streamed half by half), each into a fresh accumulator added to its
//   chunk of O; P's fragments are split one key half at a time (32
//   registers, not 64).
// - The f32 bias goes by cp.async (8 bytes, the 2 floats of one fragment
//   position) into a 16 KB shared slab, each consumer thread staging just
//   its own S fragment's positions before the S product and reading them
//   back after it, as in the bf16 kernel; where Tk is odd a pair is not
//   8-byte aligned and goes by plain loads, so any Tk needs no padding copy.
//   Each element is read once.
// - A key tile with no valid key is skipped by the producer, the split warps
//   and the consumers alike, each deciding from the key mask over the same
//   key bound, so no ring can hang and its slabs are never loaded. No
//   atomics, no split over keys: a row's result depends on its own row, its
//   keys and its bias only, never on the batch it sits in.
//
// Shared memory (dynamic, 1024-byte aligned, in 8 KB slabs: Q d_qk/32, the
// raw ring R, NSB split buffers of 2, the bias 2 where d_qk == d_v):
//   (64, 64)    Q 16 KB  + ring 8 x 8 KB + split 4 x 16 KB + bias 16 KB = 160 KB
//   (128, 128)  Q 32 KB  + ring 8 x 8 KB + split 4 x 16 KB + bias 16 KB = 176 KB
//   (192, 192)  Q 48 KB  + ring 8 x 8 KB + split 4 x 16 KB + bias 16 KB = 192 KB
//   (192, 64)   Q 48 KB  + ring 8 x 8 KB + split 4 x 16 KB              = 176 KB
//   (576, 192)  Q 144 KB + ring 4 x 8 KB + split 3 x 16 KB              = 224 KB
// plus 1 KB of alignment slack: one block an SM (227 KB a block at most).
// Registers: one block of 8 warps an SM leaves 255 a thread (at 9 warps,
// 224); a consumer holds at d_v 192 the 96 output accumulators, 32 of S, 32
// of the fresh accumulator and 32 of Q's or P's fragments (hi + lo): ptxas
// gives the kernel 174-244 by form, with no spill.

#include "tc_f32_common.cuh"

namespace {

template <int DQK, int DV>
struct CfgF {
  static constexpr int NS = DQK / 32;                 // q and k slabs a tile
  static constexpr int NV = DV / 64;                  // 64-column chunks of v and the output
  static constexpr int R = DQK == 576 ? 4 : 8;        // raw ring slabs
  static constexpr int NSB = DQK == 576 ? 3 : 4;      // split buffers (a hi and a lo slab each)
  static constexpr int NB = DQK == DV ? 2 : 0;        // the f32 bias staging slab (K1's forms)
  static constexpr size_t SMEM = (size_t)(NS + R + 2 * NSB + NB) * FSLAB + 1024;  // + alignment
};

// ---------------------------------------------------------------------------
// f32 helpers: the bias staging (the TF32 split and the .tf32 wgmma are
// tc_f32_common.cuh's)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(dst), "l"(src) : "memory");
}

// the key columns kc, kc+1 of a bias row (null: a row past Tq) into the
// shared pair dst: by cp.async where the pair is whole and 8-byte aligned,
// else by plain loads (an odd Tk, the ragged edge)
__device__ __forceinline__ void stage_bias2_f32(uint32_t dst, const float* row, int kc, int Tk, bool pairs) {
  if (row != nullptr && pairs && kc + 1 < Tk) {
    cp_async8(dst, row + kc);
    return;
  }
  float lo = 0.f, hi = 0.f;
  if (row != nullptr) {
    lo = kc < Tk ? __ldg(row + kc) : 0.f;
    hi = kc + 1 < Tk ? __ldg(row + kc + 1) : 0.f;
  }
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};" ::"r"(dst), "f"(lo), "f"(hi) : "memory");
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

template <int DQK, int DV, bool BIAS>
__global__ void __launch_bounds__(NTHREADS_F, 1)
flash_attn_fwd_tc_f32_kernel(const __grid_constant__ CUtensorMap map_q,
                             const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v,
                             const float* __restrict__ ab, const uint8_t* __restrict__ key_mask,
                             float* __restrict__ out, float* __restrict__ lse, int H, int Tq, int Tk,
                             float scale2) {
  using C = CfgF<DQK, DV>;
  constexpr int NS = C::NS, NV = C::NV, R = C::R, NSB = C::NSB;
  static_assert(DQK % 64 == 0 && DV % 64 == 0 && DV <= 192, "tc f32 widths");

  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full;
  __shared__ __align__(8) uint64_t full[R];     // a raw slab landed (TMA)
  __shared__ __align__(8) uint64_t empty[R];    // a raw slab read by the split warps
  __shared__ __align__(8) uint64_t ready[NSB];  // a split buffer written
  __shared__ __align__(8) uint64_t freed[NSB];  // a split buffer's products retired
  // TMA's 128-byte swizzle repeats every 1024 bytes: align the slabs to it
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* sQ = base;                     // NS raw slabs
  uint8_t* ring = sQ + NS * FSLAB;        // R raw slabs
  uint8_t* split = ring + R * FSLAB;      // NSB x (hi slab, lo slab)
  uint8_t* sB = split + 2 * NSB * FSLAB;  // the bias tile (NB == 2): 16 pairs a consumer thread

  const int tid = threadIdx.x;
  // broadcast from lane 0: warp-uniform to ptxas, so no wgmma sits on a
  // divergent path
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int lane = tid % 32;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;  // b * H + h
  const uint8_t* mask_b = key_mask ? key_mask + (size_t)(bh / H) * Tk : nullptr;

  if (tid == 0) {
    mbar_init(&q_full, 1);
    for (int i = 0; i < R; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], NSPLITTERS);  // every split thread arrives
    }
    for (int i = 0; i < NSB; ++i) {
      mbar_init(&ready[i], NSPLITTERS);
      mbar_init(&freed[i], 128);  // every consumer thread arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the producer, the split warps and the consumers walk the same slabs: every
  // key tile with a valid key (each decides it from the key mask), NS slabs of
  // k, then 2 NV of v (key half-major)
  auto tile_has_key = [&](int k0) {
    return __any_sync(0xffffffffu, key_valid(mask_b, k0 + lane, Tk) || key_valid(mask_b, k0 + 32 + lane, Tk));
  };

  if (warp == 4) {
    // ---- producer: the query tile, then every key tile's raw slabs ----
    if (lane == 0) {
      mbar_expect_tx(&q_full, NS * FSLAB);
      for (int s = 0; s < NS; ++s) tma_load(sQ + s * FSLAB, &map_q, &q_full, 32 * s, q0, bh);
    }
    int slot = 0;
    uint32_t phase = 0;
    for (int k0 = 0; k0 < Tk; k0 += BK) {
      if (!tile_has_key(k0)) continue;
      if (lane == 0) {
        for (int s = 0; s < NS + 2 * NV; ++s) {
          mbar_wait(&empty[slot], phase ^ 1);
          mbar_expect_tx(&full[slot], FSLAB);
          if (s < NS) {
            tma_load(ring + slot * FSLAB, &map_k, &full[slot], 32 * s, k0, bh);
          } else {
            const int j = s - NS;  // v key half j / NV, chunk j % NV
            tma_load(ring + slot * FSLAB, &map_v, &full[slot], 64 * (j % NV), k0 + 32 * (j / NV), bh);
          }
          if (++slot == R) {
            slot = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  if (warp > 4) {
    // ---- the split pass: warps 5-7 turn each raw slab into a hi and a lo
    // slab in the next free split buffer ----
    const int st = tid - 5 * 32;  // 0 .. NSPLITTERS - 1
    int slot = 0, sb = 0;
    uint32_t phase = 0, sphase = 0;
    for (int k0 = 0; k0 < Tk; k0 += BK) {
      if (!tile_has_key(k0)) continue;
      for (int s = 0; s < NS + 2 * NV; ++s) {
        mbar_wait(&freed[sb], sphase ^ 1);  // the products that read it have retired
        mbar_wait(&full[slot], phase);
        const uint8_t* src = ring + slot * FSLAB;
        uint8_t* hi = split + sb * 2 * FSLAB;
        if (s < NS) {
          // k: element by element, its swizzled layout kept
#pragma unroll 3
          for (int f = st; f < FSLAB / 16; f += NSPLITTERS) {
            uint4 h, w;
            split4(reinterpret_cast<const float4*>(src)[f], h, w);
            reinterpret_cast<uint4*>(hi)[f] = h;
            reinterpret_cast<uint4*>(hi + FSLAB)[f] = w;
          }
        } else {
          // v transposed and permuted: 16-byte chunk ch of row n (d_v column
          // n of the chunk) holds positions 4ch .. 4ch + 3 of the 32 keys,
          // keys 8g + par + 2i (g = ch / 2, par = ch % 2, i < 4): key pi(a)
          // at position a of each group of 8
#pragma unroll 3
          for (int c = st; c < FSLAB / 16; c += NSPLITTERS) {
            const int n = c % 64, ch = c / 64;
            const float* c0 = reinterpret_cast<const float*>(src) + (8 * (ch / 2) + ch % 2) * 64 + n;
            uint4 h, w;
            split4(make_float4(c0[0], c0[128], c0[256], c0[384]), h, w);
            const uint32_t off = swz(n, 4 * ch);
            *reinterpret_cast<uint4*>(hi + off) = h;
            *reinterpret_cast<uint4*>(hi + FSLAB + off) = w;
          }
        }
        fence_proxy_async();  // the stores, before the wgmma (async proxy) reads them
        mbar_arrive(&empty[slot]);
        mbar_arrive(&ready[sb]);
        if (++slot == R) {
          slot = 0;
          phase ^= 1;
        }
        if (++sb == NSB) {
          sb = 0;
          sphase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: one warpgroup, 2 rows x 16 columns of S a thread ----
  const int quad_row = 16 * warp + lane / 4;  // rows quad_row and quad_row + 8
  const int c4 = lane % 4;
  const int cc = 2 * c4;                      // columns 8j + cc, 8j + cc + 1
  const bool pairs = (Tk % 2) == 0 && (reinterpret_cast<uintptr_t>(ab) & 7) == 0;
  const float* brow[2] = {nullptr, nullptr};
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
  int sb = 0;  // the split buffer of the next slab
  uint32_t sphase = 0;
  int held = 0;  // the split buffer the products in flight read
  const uint32_t split_addr = smem_u32(split);
  const uint32_t sb_addr = smem_u32(sB);
  // this thread's Q fragment rows: quad_row and quad_row + 8 (1024 bytes on)
  const uint8_t* q_row = sQ + quad_row * 128;

  // the next slab's split buffer is written: its descriptors (hi, lo)
  auto take_split = [&](uint64_t& b_hi, uint64_t& b_lo) {
    mbar_wait(&ready[sb], sphase);
    const uint32_t b = split_addr + sb * 2 * FSLAB;
    b_hi = slab_desc(b);
    b_lo = slab_desc(b + FSLAB);
  };
  // the products issued on the slab just taken; the buffer is held until they retire
  auto issued = [&]() {
    wgmma_commit();
    held = sb;
    if (++sb == NSB) {
      sb = 0;
      sphase ^= 1;
    }
  };

  // tmp = Q.K^T over k slab ks: once its split buffer is ready, retire the
  // previous slab's products, fold their tmp into s and free their buffer,
  // then this slab's 4 k-steps into tmp, the small terms first
  auto s_slab = [&](float (&s)[32], float (&tmp)[32], uint32_t (&qa)[4][8], int ks) {
    uint64_t b_hi, b_lo;
    take_split(b_hi, b_lo);
    wgmma_wait<0>();
    fence_acc(tmp);
    keep_frags(qa);
    if (ks > 0) {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] += tmp[i];
      mbar_arrive(&freed[held]);
    }
    const uint8_t* qs = q_row + ks * FSLAB;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // rows r, r + 8 at columns 8kk + c4 (chunk 2kk) and 8kk + c4 + 4 (chunk 2kk + 1)
      const uint32_t o0 = ((((2 * kk) ^ (lane / 4))) << 4) + c4 * 4;
      const uint32_t o1 = ((((2 * kk + 1) ^ (lane / 4))) << 4) + c4 * 4;
      const float x00 = *reinterpret_cast<const float*>(qs + o0);
      const float x10 = *reinterpret_cast<const float*>(qs + 1024 + o0);
      const float x01 = *reinterpret_cast<const float*>(qs + o1);
      const float x11 = *reinterpret_cast<const float*>(qs + 1024 + o1);
      split_tf32(x00, qa[kk][0], qa[kk][4]);
      split_tf32(x10, qa[kk][1], qa[kk][5]);
      split_tf32(x01, qa[kk][2], qa[kk][6]);
      split_tf32(x11, qa[kk][3], qa[kk][7]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // hi.lo + lo.hi while tmp is small
      wgmma_tf32(tmp, qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3], b_lo + 2 * kk, kk != 0);
      wgmma_tf32(tmp, qa[kk][4], qa[kk][5], qa[kk][6], qa[kk][7], b_hi + 2 * kk, 1);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_tf32(tmp, qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3], b_hi + 2 * kk, 1);
    issued();
  };

  // tmp = P.V over v slab (key half kh, chunk c): once its split buffer is
  // ready, retire the previous slab's products, fold their tmp into its chunk
  // of O (o_prev, when fold) and free their buffer, then this slab's 4
  // k-steps into tmp
  auto pv_slab = [&](float (&tmp)[32], float (&o_prev)[32], bool fold, const uint32_t (&pa)[4][8]) {
    uint64_t b_hi, b_lo;
    take_split(b_hi, b_lo);
    wgmma_wait<0>();
    fence_acc(tmp);
    if (fold) {
#pragma unroll
      for (int i = 0; i < 32; ++i) o_prev[i] += tmp[i];
      mbar_arrive(&freed[held]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_3xtf32(tmp, pa[kk], b_hi + 2 * kk, b_lo + 2 * kk, kk != 0);
    issued();
  };

  uint32_t qa[4][8];  // the Q fragments of one k slab (hi, lo)
  float tmp[32];      // one k slab's S, one P.V slab's products
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    qa[i / 8][i % 8] = 0u;
    tmp[i] = 0.f;
  }
  mbar_wait(&q_full, 0);

  for (int k0 = 0; k0 < Tk; k0 += BK) {
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
    // pair (h, j) of thread tid at sB + 8*(128*(8h + j) + tid)
    if (BIAS) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          stage_bias2_f32(sb_addr + 8 * (128 * (8 * h + j) + tid), brow[h], k0 + 8 * j + cc, Tk, pairs);
      cp_async_commit();
    }

    // S = Q.K^T: the sum in f32 of NS slabs' products, each slab's in a
    // fresh accumulator (the tensor cores' f32 sums truncate: one chain
    // over all of d_qk loses ~1e-5 of |S|)
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll 1
    for (int ks = 0; ks < NS; ++ks) s_slab(s, tmp, qa, ks);
    wgmma_wait<0>();
    fence_acc(tmp);
    keep_frags(qa);
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] += tmp[i];
    mbar_arrive(&freed[held]);

    // bias, scale (base 2), mask; online softmax on the fragments
    float2 bias[2][8];
    if (BIAS) {
      cp_async_wait_all();  // each thread reads back only the pairs it staged
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];"
                       : "=f"(bias[h][j].x), "=f"(bias[h][j].y)
                       : "r"(sb_addr + 8 * (128 * (8 * h + j) + tid))
                       : "memory");
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = s[4 * j + 2 * h + e];
          if (BIAS) x += e ? bias[h][j].y : bias[h][j].x;
          const bool seen = (vbits >> (2 * j + e)) & 1u;
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
#pragma unroll
    for (int c = 0; c < NV; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] *= alpha[(i >> 1) & 1];

    // O += P.V, one (32-key half, 64-column chunk) slab of v at a time, each
    // slab's products in a fresh accumulator added to its chunk of O in f32.
    // P as the A operand of k-step kk of half kh (keys 32kh + 8kk .. + 7,
    // permuted by pi): rows r, r + 8 at positions c4 (key 2c4) and c4 + 4
    // (key 2c4 + 1), one half's fragments (hi, lo) at a time
#pragma unroll
    for (int kh = 0; kh < 2; ++kh) {
      uint32_t pa[4][8];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int i = 16 * kh + 4 * kk;
        split_tf32(s[i + 0], pa[kk][0], pa[kk][4]);
        split_tf32(s[i + 2], pa[kk][1], pa[kk][5]);
        split_tf32(s[i + 1], pa[kk][2], pa[kk][6]);
        split_tf32(s[i + 3], pa[kk][3], pa[kk][7]);
      }
      // each slab folds the one before it; the half's last slab is folded
      // after it, before the next half's fragments take the registers
#pragma unroll
      for (int c = 0; c < NV; ++c) pv_slab(tmp, o[c > 0 ? c - 1 : 0], c > 0, pa);
      wgmma_wait<0>();
      fence_acc(tmp);
      keep_frags(pa);
#pragma unroll
      for (int i = 0; i < 32; ++i) o[NV - 1][i] += tmp[i];
      mbar_arrive(&freed[held]);
    }
  }

  // epilogue: O / l in f32, lse = (m + log2 l) ln 2
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qr = q0 + quad_row + 8 * h;
    if (qr >= Tq) continue;
    const float inv = l[h] > 0.f ? 1.f / l[h] : 0.f;
    float* orow = out + ((size_t)bh * Tq + qr) * DV;
#pragma unroll
    for (int c = 0; c < NV; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float2*>(orow + 64 * c + 8 * j + cc) =
            make_float2(o[c][4 * j + 2 * h] * inv, o[c][4 * j + 2 * h + 1] * inv);
    if (lse != nullptr && c4 == 0)
      lse[(size_t)bh * Tq + qr] = l[h] > 0.f ? (m[h] + log2f(l[h])) * LN2 : INFINITY;
  }
}

template <int DQK, int DV, bool BIAS>
cudaError_t launch(const void* q, const void* k, const void* v, const void* ab, const void* key_mask, void* out,
                   float* lse, int B, int H, int Tq, int Tk, float sm_scale, cudaStream_t stream) {
  using C = CfgF<DQK, DV>;
  CUtensorMap mq, mk, mv;
  if (!make_map_f32(&mq, q, B * H, Tq, DQK, 32, 64, true) || !make_map_f32(&mk, k, B * H, Tk, DQK, 32, 64, true) ||
      !make_map_f32(&mv, v, B * H, Tk, DV, 64, 32, false))
    return cudaErrorInvalidValue;
  static unsigned long long sized = 0;
  cudaError_t err = size_smem_once(flash_attn_fwd_tc_f32_kernel<DQK, DV, BIAS>, C::SMEM, sized);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + BQ - 1) / BQ, B * H);
  flash_attn_fwd_tc_f32_kernel<DQK, DV, BIAS><<<grid, NTHREADS_F, C::SMEM, stream>>>(
      mq, mk, mv, static_cast<const float*>(ab), static_cast<const uint8_t*>(key_mask),
      static_cast<float*>(out), lse, H, Tq, Tk, sm_scale * LOG2E);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, const void* ab, const void* key_mask, void* out,
                     float* lse, int B, int H, int Tq, int Tk, float sm_scale, cudaStream_t stream) {
  if (ab != nullptr) return launch<D, D, true>(q, k, v, ab, key_mask, out, lse, B, H, Tq, Tk, sm_scale, stream);
  return launch<D, D, false>(q, k, v, ab, key_mask, out, lse, B, H, Tq, Tk, sm_scale, stream);
}

}  // namespace

// The same arguments and semantics as jatts_flash_attn_fwd (flash_attn_fwd.cu)
// for the forms this kernel has: f32 (is_bf16 == 0), non-causal; Dqk == Dv in
// {64, 128, 192} with or without ab, or (Dqk, Dv) in {(192, 64), (576, 192)}
// without ab. q, k, v 16-byte aligned, ab 4-byte aligned. Returns a
// cudaError_t (0 = launched); anything else it refuses with
// cudaErrorInvalidValue (or cudaErrorMisalignedAddress).
extern "C" int jatts_flash_attn_fwd_tc_f32(const void* q, const void* k, const void* v, const void* ab,
                                           const void* key_mask, void* out, void* lse, int B, int H, int Tq,
                                           int Tk, int Dqk, int Dv, int is_bf16, int causal, float sm_scale,
                                           void* stream) {
  if (is_bf16 || causal || Tq <= 0 || Tk <= 0) return (int)cudaErrorInvalidValue;
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
  switch (Dqk) {
    case 64: return (int)launch_d<64>(q, k, v, ab, key_mask, out, l, B, H, Tq, Tk, sm_scale, s);
    case 128: return (int)launch_d<128>(q, k, v, ab, key_mask, out, l, B, H, Tq, Tk, sm_scale, s);
    case 192: return (int)launch_d<192>(q, k, v, ab, key_mask, out, l, B, H, Tq, Tk, sm_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
