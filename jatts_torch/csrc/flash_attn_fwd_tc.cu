// K1 and K1r in bf16 on Hopper's tensor cores (sm_90a), plain C interface.
//
// Replaces, for bf16 inputs and the non-causal form, the Pallas TPU
// flash-attention forward (the pallas_call at
// jax/experimental/pallas/ops/tpu/flash_attention.py:758) as
// jatts_tpu/modules/attention.py:158 (_flash_attend) drives it, and its
// fused "latest" rel-pos call (jatts_tpu/modules/attention.py:372-385).
// It computes exactly what the scalar kernels of flash_attn_fwd.cu compute,
// per (b, h):
//
//     out = softmax((q . k^T + ab) * sm_scale) . v      over valid keys
//
// - the bias [B,H,Tq,Tk] (optional) is added BEFORE the scale;
// - keys whose key_mask byte is 0, and keys past Tk, are never seen;
// - a row with no valid key returns exactly 0 and, when lse is asked for,
//   lse = +inf; otherwise lse = m + log(l) of the scaled scores in f32, which
//   the backward (flash_attn_bwd.cu) reads.
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
// The scalar kernels ran both on the CUDA cores in f32 (67 TFLOP/s) with
// bf16 widened to f32 in shared memory and synchronous loads: 43x and 72x
// off those bounds.
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

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows a block (one warpgroup)
constexpr int BK = 64;        // keys a tile
constexpr int SLAB = 64 * 64 * 2;  // bytes of a 64 x 64 bf16 slab
constexpr int NTHREADS = 160;  // 4 consumer warps + 1 producer warp
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

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

// ---------------------------------------------------------------------------
// PTX wrappers: mbarrier, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// returns once the phase of parity `parity` has completed; the loop stays
// inside the asm, so the code after it is not a divergent path to ptxas
// (which would serialise the wgmmas there)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred p;\n"
      "WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT;\n}"
      ::"r"(smem_u32(bar)), "r"(parity) : "memory");
}

// the bias pair of one fragment position, global -> shared, 4 bytes
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;" ::: "memory"); }

// one 64 x 64 box of a 3-d map [BH, T, D] at (column c0, row c1, head c2)
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
        "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled 64 x 64 bf16 slab:
// rows of 128 bytes, 8-row groups 1024 bytes apart. The group stride goes in
// both offset fields: a K-major operand (Q, K) reads only the stride-dimension
// one, the MN-major V (64 columns, one swizzle atom wide) only the one along
// K, whichever field the hardware takes for it.
__device__ __forceinline__ uint64_t slab_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads of an accumulator across a wait
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_D32                                                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                       \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_OUT32(d)                                                                               \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),             \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),     \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),  \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),  \
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d (+)= A.B, m64n64k16, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}"
      : WG_OUT32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A.B, m64n64k16, A (4 bf16x2 registers a thread) from registers, B
// MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}"
      : WG_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_lo(uint32_t x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t x) { return __uint_as_float(x & 0xFFFF0000u); }

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

__device__ __forceinline__ bool key_valid(const uint8_t* mask_b, int kc, int Tk) {
  return kc < Tk && (mask_b == nullptr || __ldg(mask_b + kc) != 0);
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

template <int DQK, int DV, bool BIAS>
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
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;  // b * H + h
  const uint8_t* mask_b = key_mask ? key_mask + (size_t)(bh / H) * Tk : nullptr;

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
    for (int k0 = 0; k0 < Tk; k0 += BK) {
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
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = s[4 * j + 2 * h + e];
          if (BIAS) x += e ? bf16_hi(bias[h][j]) : bf16_lo(bias[h][j]);
          x = (vbits >> (2 * j + e)) & 1u ? x * scale2 : -INFINITY;
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
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
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

// ---------------------------------------------------------------------------
// host side: tensor maps through the CUDA driver API's entry point (no -lcuda)
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 3-d map over a contiguous bf16 [BH, T, D] with 64 x 64 boxes, 128-byte swizzle
bool make_map(CUtensorMap* map, const void* ptr, int BH, int T, int D) {
  EncodeTiled enc = encode_fn();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)T * D * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t estride[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
             estride, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DQK, int DV, bool BIAS>
cudaError_t launch(const void* q, const void* k, const void* v, const void* ab, const void* key_mask,
                   void* out, float* lse, int B, int H, int Tq, int Tk, float sm_scale,
                   cudaStream_t stream) {
  using C = Cfg<DQK, DV>;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, B * H, Tq, DQK) || !make_map(&mk, k, B * H, Tk, DQK) ||
      !make_map(&mv, v, B * H, Tk, DV))
    return cudaErrorInvalidValue;
  // once per device and instantiation (a race only sets it twice)
  static unsigned long long sized = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !((sized >> dev) & 1ull)) {
    err = cudaFuncSetAttribute(flash_attn_fwd_tc_kernel<DQK, DV, BIAS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
    if (err != cudaSuccess) return err;
    if (dev < 64) sized |= 1ull << dev;
  }
  const dim3 grid((Tq + BQ - 1) / BQ, B * H);
  flash_attn_fwd_tc_kernel<DQK, DV, BIAS><<<grid, NTHREADS, C::SMEM, stream>>>(
      mq, mk, mv, static_cast<const __nv_bfloat16*>(ab), static_cast<const uint8_t*>(key_mask),
      static_cast<__nv_bfloat16*>(out), lse, H, Tq, Tk, sm_scale * LOG2E);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, const void* ab, const void* key_mask,
                     void* out, float* lse, int B, int H, int Tq, int Tk, float sm_scale,
                     cudaStream_t stream) {
  if (ab != nullptr)
    return launch<D, D, true>(q, k, v, ab, key_mask, out, lse, B, H, Tq, Tk, sm_scale, stream);
  return launch<D, D, false>(q, k, v, ab, key_mask, out, lse, B, H, Tq, Tk, sm_scale, stream);
}

}  // namespace

// The same arguments and semantics as jatts_flash_attn_fwd (flash_attn_fwd.cu)
// for the forms this kernel has: bf16 (is_bf16 != 0), non-causal; Dqk == Dv
// in {64, 128, 192, 256} with or without ab, or (Dqk, Dv) in {(192, 64),
// (576, 192)} without ab. q, k, v 16-byte aligned, ab 4-byte aligned. Returns
// a cudaError_t (0 = launched); anything else it refuses with
// cudaErrorInvalidValue (or cudaErrorMisalignedAddress).
extern "C" int jatts_flash_attn_fwd_tc(const void* q, const void* k, const void* v, const void* ab,
                                       const void* key_mask, void* out, void* lse, int B, int H,
                                       int Tq, int Tk, int Dqk, int Dv, int is_bf16, int causal,
                                       float sm_scale, void* stream) {
  if (!is_bf16 || causal || Tq <= 0 || Tk <= 0) return (int)cudaErrorInvalidValue;
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
    case 256: return (int)launch_d<256>(q, k, v, ab, key_mask, out, l, B, H, Tq, Tk, sm_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
