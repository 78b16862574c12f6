// K1: flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU flash-attention forward that
// jatts_tpu/modules/attention.py:_flash_attend drives (the pallas_call in
// jax.experimental.pallas.ops.tpu.flash_attention). Computes, per (b, h),
//
//     out = softmax((q . k^T + ab) * sm_scale) . v      over valid keys
//
// with the bias added BEFORE the scale, as the TPU kernel does. No dropout,
// f32 accumulation; q/k/v/ab/out in f32 here. The bf16 forms of K1, K1b
// and K1r are no longer built here: flash_attn_fwd_tc.cu runs them on the
// tensor cores. This file keeps the f32 ones (K1, K1b, K1r).
//
// Causal form (K1b, the `causal=True` path of the same pallas_call: causal
// block skip at flash_attention.py:379, element mask :426-434): with Tq ==
// Tk, query row i sees key j only when j <= i, AND-ed with the key mask. A
// compile-time flag (CAUSAL) selects it, so the non-causal instantiations
// are the code they were. The causal block of query tile q0 stops at the
// last key tile that reaches its last row (keys < q0 + BQ): the tiles above
// the diagonal are never loaded, as the TPU kernel skips them; the diagonal
// tile is masked element by element. Query tiles are taken in reverse
// block order, so the heaviest (last) tiles start first.
// When asked (lse != null, the autograd path), it also writes each row's
// log-sum-exp lse = m + log(l) of the scaled scores in f32, which the
// backward (flash_attn_bwd.cu) uses to recompute p = exp(s - lse). A row
// with no valid key gets lse = +inf, so that its p is exactly 0 there.
//
// Masking is key padding: every query row attends the keys whose key_mask
// byte is nonzero (all keys when key_mask is null); keys past Tk are the
// ragged edge and are never seen. This is what the eager `_attend`
// computes on every row. A row with no valid key returns 0, as `_attend`
// does, never NaN. The TPU kernel masks by segment ids (valid<->valid,
// pad<->pad), so the two agree on valid query rows and differ only on
// padded query rows, which the conformer's zero_pad discards
// (jatts_tpu/modules/conformer.py:225).
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): at the decoder shape
// B=8, H=2, T=1024, d=192 in bf16 the call must move q, k, v, out (4 x 6.3
// MB) and the dense [B,H,T,T] bias (33.5 MB), 58.7 MB -> 17.5 us, and do
// 4*B*H*T*T*d = 12.9 GFLOP -> 13 us on the tensor cores: close to
// balanced, with the bias read setting the floor. This first version runs
// on the CUDA cores (67 TFLOP/s f32), so its own floor is ~0.19 ms.
//
// Design (simple first; wgmma/TMA are later work): one block of 256
// threads per (b, h, 64-row query tile) loops over 64-key tiles staged in
// shared memory as f32. Thread (ty, tx) of a 16 x 16 grid owns query rows
// ty + 16*i (i < 4); in the score phase it owns keys tx + 16*j (j < 4), in
// the value phase output columns tx + 16*c (c < d/16). The 16 threads of a
// row are 16 lanes of one warp, so row max and row sum are xor shuffles.
// Tile rows are padded to d + 1 floats so column reads are conflict-free.
// The scores and the value product run on the CUDA cores in f32.
//
// K1r, the fused rel-pos form (d_qk != d_v): the same pallas_call as
// jatts_tpu/modules/attention.py:372-385 makes it for the "latest" rel-pos
// attention, q = [q_u, u~] and k = [k, phi] of width d_qk = d_k + n_feat, v
// of width d_v = d_k, no bias, key mask, non-causal. The TPU wrapper pads
// q, k and v to one width (640 at adim 384, 2 heads) and slices the output;
// this kernel skips the padding and reads each at its own width. A kernel of
// its own (flash_attn_fwd_relpos_kernel, instantiated for the (d_qk, d_v)
// pairs the port uses), so the d_qk == d_v instantiations above are the code
// they were. Its problem is shared memory: K1's tiles at d = 576 would need
// ~449 KB of the 227 KB a block may hold. K1r keeps the whole 64-row query
// tile in shared memory (64 x 577 f32, 148 KB) and stages each 64-key tile
// of k in column slabs of 64 (17 KB), accumulating the 64 x 64 score tile in
// registers across the slabs; the V tile, the P tile and the output
// accumulator are K1's at d = d_v. 230,400 bytes at (576, 192), one block an
// SM as K1 at d = 192. Bound at the training decoder shape (B, H, T = 32, 2,
// 1024, f32): 2 * B*H*T*T*(d_qk + d_v) = 103.1 GFLOP -> 1.54 ms at the f32
// CUDA-core peak; 402.7 MB of q, k, v, out -> 0.12 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // keys per tile
constexpr int NTHREADS = 256;  // 16 x 16

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1));
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(NTHREADS)
flash_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ ab,
                      const uint8_t* __restrict__ key_mask, T* __restrict__ out,
                      float* __restrict__ lse, int H, int Tq, int Tk, float sm_scale) {
  constexpr int LD = D + 1;
  constexpr int LDP = BK + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * LD;

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  // causal: the last query tile (the most keys) is scheduled first
  const int q0 = (CAUSAL ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * BQ;
  const int bh = blockIdx.y;  // b * H + h
  const size_t q_base = (size_t)bh * Tq * D;
  const size_t kv_base = (size_t)bh * Tk * D;
  const T* ab_bh = ab ? ab + (size_t)bh * Tq * Tk : nullptr;
  const uint8_t* mask_b = key_mask ? key_mask + (size_t)(bh / H) * Tk : nullptr;

  for (int e = tid; e < BQ * D; e += NTHREADS) {
    const int r = e / D, c = e % D, qr = q0 + r;
    sQ[r * LD + c] = qr < Tq ? to_f32(q[q_base + (size_t)qr * D + c]) : 0.f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // causal: no key at or past q0 + BQ is seen by a row of this tile
  const int k_end = CAUSAL ? min(Tk, q0 + BQ) : Tk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's reads of sK/sV/sP are done
    for (int e = tid; e < BK * D; e += NTHREADS) {
      const int r = e / D, c = e % D, kr = k0 + r;
      const size_t g = kv_base + (size_t)kr * D + c;
      sK[r * LD + c] = kr < Tk ? to_f32(k[g]) : 0.f;
      sV[r * LD + c] = kr < Tk ? to_f32(v[g]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qd[4], kd[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qd[i] = sQ[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kd[j] = sK[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qd[i], kd[j], s[i][j]);
    }

    // bias, then scale, then key mask (-inf marks a key the row must not see)
    bool valid[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kc = k0 + tx + 16 * j;
      valid[j] = kc < Tk && (mask_b == nullptr || mask_b[kc] != 0);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = k0 + tx + 16 * j;
        float x = s[i][j];
        if (ab_bh != nullptr && qr < Tq && kc < Tk) x += to_f32(ab_bh[(size_t)qr * Tk + kc]);
        const bool seen = valid[j] && (!CAUSAL || kc <= qr);
        s[i][j] = seen ? x * sm_scale : -INFINITY;
      }
    }

    // online softmax; a row with no valid key so far keeps m = -inf and
    // uses 0 as its shift so that no inf - inf appears
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
      mx = row_max16(mx);
      const float m_new = fmaxf(m[i], mx);
      const float shift = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[i] - shift);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - shift);
        sP[(ty + 16 * i) * LDP + tx + 16 * j] = p;
        rs += p;
      }
      rs = row_sum16(rs);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(ty + 16 * i) * LDP + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = sV[kk * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty + 16 * i;
    if (qr >= Tq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      store_as(&out[q_base + (size_t)qr * D + tx + 16 * c], acc[i][c] * inv);
    if (lse != nullptr && tx == 0)
      lse[(size_t)bh * Tq + qr] = l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
  }
}

template <typename T, int D, bool CAUSAL>
cudaError_t launch(const void* q, const void* k, const void* v, const void* ab,
                   const void* key_mask, void* out, float* lse, int B, int H, int Tq,
                   int Tk, float sm_scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_attn_fwd_kernel<T, D, CAUSAL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + BQ - 1) / BQ, B * H);
  flash_attn_fwd_kernel<T, D, CAUSAL><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(ab), static_cast<const uint8_t*>(key_mask),
      static_cast<T*>(out), lse, H, Tq, Tk, sm_scale);
  return cudaGetLastError();
}

template <typename T, bool CAUSAL>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, const void* ab,
                       const void* key_mask, void* out, float* lse, int B, int H, int Tq,
                       int Tk, int D, float sm_scale, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<T, 64, CAUSAL>(q, k, v, ab, key_mask, out, lse, B, H, Tq, Tk, sm_scale, stream);
    case 128: return launch<T, 128, CAUSAL>(q, k, v, ab, key_mask, out, lse, B, H, Tq, Tk, sm_scale, stream);
    case 192: return launch<T, 192, CAUSAL>(q, k, v, ab, key_mask, out, lse, B, H, Tq, Tk, sm_scale, stream);
    case 256: return launch<T, 256, CAUSAL>(q, k, v, ab, key_mask, out, lse, B, H, Tq, Tk, sm_scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// K1r: the fused rel-pos form, d_qk != d_v (no bias, key mask, non-causal)
// ---------------------------------------------------------------------------

constexpr int SLAB = 64;  // key columns staged at a time

// sQ [BQ][DQK+1] (the whole query tile), sK [BK][SLAB+1] (one column slab of
// the key tile), sV [BK][DV+1], sP [BQ][BK+1], all f32
template <int DQK, int DV>
constexpr size_t relpos_smem_bytes() {
  return sizeof(float) *
         (size_t)(BQ * (DQK + 1) + BK * (SLAB + 1) + BK * (DV + 1) + BQ * (BK + 1));
}

template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(NTHREADS)
flash_attn_fwd_relpos_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const uint8_t* __restrict__ key_mask,
                             T* __restrict__ out, float* __restrict__ lse, int H, int Tq,
                             int Tk, float sm_scale) {
  static_assert(DQK % SLAB == 0 && DV % 16 == 0, "K1r widths");
  constexpr int LDQ = DQK + 1;
  constexpr int LDS = SLAB + 1;
  constexpr int LDV = DV + 1;
  constexpr int LDP = BK + 1;
  constexpr int DC = DV / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * LDQ;
  float* sV = sK + BK * LDS;
  float* sP = sV + BK * LDV;

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;  // b * H + h
  const size_t q_base = (size_t)bh * Tq * DQK;
  const size_t k_base = (size_t)bh * Tk * DQK;
  const size_t v_base = (size_t)bh * Tk * DV;
  const size_t o_base = (size_t)bh * Tq * DV;
  const uint8_t* mask_b = key_mask ? key_mask + (size_t)(bh / H) * Tk : nullptr;

  for (int e = tid; e < BQ * DQK; e += NTHREADS) {
    const int r = e / DQK, c = e % DQK, qr = q0 + r;
    sQ[r * LDQ + c] = qr < Tq ? to_f32(q[q_base + (size_t)qr * DQK + c]) : 0.f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < Tk; k0 += BK) {
    __syncthreads();  // the previous tile's reads of sK/sV/sP are done
    for (int e = tid; e < BK * DV; e += NTHREADS) {
      const int r = e / DV, c = e % DV, kr = k0 + r;
      sV[r * LDV + c] = kr < Tk ? to_f32(v[v_base + (size_t)kr * DV + c]) : 0.f;
    }

    // the 64 x 64 score tile, accumulated over the column slabs of k
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 1
    for (int s0 = 0; s0 < DQK; s0 += SLAB) {
      if (s0 > 0) __syncthreads();  // the previous slab's reads of sK are done
      for (int e = tid; e < BK * SLAB; e += NTHREADS) {
        const int r = e / SLAB, c = e % SLAB, kr = k0 + r;
        sK[r * LDS + c] = kr < Tk ? to_f32(k[k_base + (size_t)kr * DQK + s0 + c]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < SLAB; ++d) {
        float qd[4], kd[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qd[i] = sQ[(ty + 16 * i) * LDQ + s0 + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) kd[j] = sK[(tx + 16 * j) * LDS + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qd[i], kd[j], s[i][j]);
      }
    }

    // scale, then key mask (-inf marks a key the row must not see)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kc = k0 + tx + 16 * j;
      const bool valid = kc < Tk && (mask_b == nullptr || mask_b[kc] != 0);
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i][j] = valid ? s[i][j] * sm_scale : -INFINITY;
    }

    // online softmax, as K1
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
      mx = row_max16(mx);
      const float m_new = fmaxf(m[i], mx);
      const float shift = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[i] - shift);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - shift);
        sP[(ty + 16 * i) * LDP + tx + 16 * j] = p;
        rs += p;
      }
      rs = row_sum16(rs);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(ty + 16 * i) * LDP + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = sV[kk * LDV + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty + 16 * i;
    if (qr >= Tq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      store_as(&out[o_base + (size_t)qr * DV + tx + 16 * c], acc[i][c] * inv);
    if (lse != nullptr && tx == 0)
      lse[(size_t)bh * Tq + qr] = l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
  }
}

template <typename T, int DQK, int DV>
cudaError_t launch_relpos(const void* q, const void* k, const void* v, const void* key_mask,
                          void* out, float* lse, int B, int H, int Tq, int Tk, float sm_scale,
                          cudaStream_t stream) {
  constexpr size_t smem = relpos_smem_bytes<DQK, DV>();
  cudaError_t err = cudaFuncSetAttribute(flash_attn_fwd_relpos_kernel<T, DQK, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + BQ - 1) / BQ, B * H);
  flash_attn_fwd_relpos_kernel<T, DQK, DV><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(key_mask), static_cast<T*>(out), lse, H, Tq, Tk, sm_scale);
  return cudaGetLastError();
}

// the (d_qk, d_v) pairs of the port: 2 heads of 64 (adim 128) and of 192
// (adim 384, the JSUT/JVS width)
template <typename T>
cudaError_t dispatch_relpos(const void* q, const void* k, const void* v, const void* key_mask,
                            void* out, float* lse, int B, int H, int Tq, int Tk, int Dqk,
                            int Dv, float sm_scale, cudaStream_t stream) {
  if (Dqk == 192 && Dv == 64)
    return launch_relpos<T, 192, 64>(q, k, v, key_mask, out, lse, B, H, Tq, Tk, sm_scale, stream);
  if (Dqk == 576 && Dv == 192)
    return launch_relpos<T, 576, 192>(q, k, v, key_mask, out, lse, B, H, Tq, Tk, sm_scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q: [B, H, Tq, Dqk]; k: [B, H, Tk, Dqk]; v: [B, H, Tk, Dv]; out: [B, H,
// Tq, Dv]; ab: [B, H, Tq, Tk] or null; key_mask: [B, Tk] bytes (nonzero =
// valid) or null; lse: [B, H, Tq] f32 or null. All contiguous, one element
// type (is_bf16 ? bf16 : f32) but lse. Dqk == Dv takes K1 (causal != 0: K1b,
// which needs Tq == Tk); Dqk != Dv takes K1r, which needs no bias and no
// causal form and a (Dqk, Dv) pair it was built for. f32 only here: every
// bf16 call is jatts_flash_attn_fwd_tc's (flash_attn_fwd_tc.cu). Returns a
// cudaError_t (0 = launched).
extern "C" int jatts_flash_attn_fwd(const void* q, const void* k, const void* v,
                                    const void* ab, const void* key_mask, void* out,
                                    void* lse, int B, int H, int Tq, int Tk, int Dqk, int Dv,
                                    int is_bf16, int causal, float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  // the bf16 forms are flash_attn_fwd_tc.cu's (tensor cores)
  if (is_bf16) return (int)cudaErrorInvalidValue;
  if (Dqk != Dv) {
    if (ab != nullptr || causal) return (int)cudaErrorInvalidValue;
    return (int)dispatch_relpos<float>(q, k, v, key_mask, out, l, B, H, Tq, Tk, Dqk, Dv,
                                       sm_scale, s);
  }
  const int D = Dqk;
  if (causal) {
    if (Tq != Tk) return (int)cudaErrorInvalidValue;
    return (int)dispatch_d<float, true>(q, k, v, ab, key_mask, out, l, B, H, Tq, Tk, D, sm_scale,
                                        s);
  }
  return (int)dispatch_d<float, false>(q, k, v, ab, key_mask, out, l, B, H, Tq, Tk, D, sm_scale,
                                       s);
}
