// K1: flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU flash-attention forward that
// jatts_tpu/modules/attention.py:_flash_attend drives (the pallas_call in
// jax.experimental.pallas.ops.tpu.flash_attention). Computes, per (b, h),
//
//     out = softmax((q . k^T + ab) * sm_scale) . v      over valid keys
//
// with the bias added BEFORE the scale, as the TPU kernel does. Non-causal,
// no dropout, f32 accumulation; q/k/v/ab/out in f32 or bf16 (one type).
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

template <typename T, int D>
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
  const int q0 = blockIdx.x * BQ;
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

  for (int k0 = 0; k0 < Tk; k0 += BK) {
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
        s[i][j] = valid[j] ? x * sm_scale : -INFINITY;
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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* ab,
                   const void* key_mask, void* out, float* lse, int B, int H, int Tq,
                   int Tk, float sm_scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_attn_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + BQ - 1) / BQ, B * H);
  flash_attn_fwd_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(ab), static_cast<const uint8_t*>(key_mask),
      static_cast<T*>(out), lse, H, Tq, Tk, sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, const void* ab,
                       const void* key_mask, void* out, float* lse, int B, int H, int Tq,
                       int Tk, int D, float sm_scale, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<T, 64>(q, k, v, ab, key_mask, out, lse, B, H, Tq, Tk, sm_scale, stream);
    case 128: return launch<T, 128>(q, k, v, ab, key_mask, out, lse, B, H, Tq, Tk, sm_scale, stream);
    case 192: return launch<T, 192>(q, k, v, ab, key_mask, out, lse, B, H, Tq, Tk, sm_scale, stream);
    case 256: return launch<T, 256>(q, k, v, ab, key_mask, out, lse, B, H, Tq, Tk, sm_scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, out: [B, H, Tq, D]; k, v: [B, H, Tk, D]; ab: [B, H, Tq, Tk] or null;
// key_mask: [B, Tk] bytes (nonzero = valid) or null; lse: [B, H, Tq] f32 or
// null. All contiguous, one element type (is_bf16 ? bf16 : f32) but lse.
// Returns a cudaError_t (0 = launched).
extern "C" int jatts_flash_attn_fwd(const void* q, const void* k, const void* v,
                                    const void* ab, const void* key_mask, void* out,
                                    void* lse, int B, int H, int Tq, int Tk, int D,
                                    int is_bf16, float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (is_bf16)
    return (int)dispatch_d<__nv_bfloat16>(q, k, v, ab, key_mask, out, l, B, H, Tq, Tk, D,
                                          sm_scale, s);
  return (int)dispatch_d<float>(q, k, v, ab, key_mask, out, l, B, H, Tq, Tk, D, sm_scale, s);
}
