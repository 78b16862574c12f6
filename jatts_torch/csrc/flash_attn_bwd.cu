// K1-bwd: flash-attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces the two Pallas TPU kernels of the flash-attention custom VJP that
// jatts_tpu/modules/attention.py:_flash_attend drives (the installed
// jax/experimental/pallas/ops/tpu/flash_attention.py): `_flash_attention_bwd_dkv`
// (pallas_call at :1121, body `_flash_attention_dkv_kernel` :796) and
// `_flash_attention_bwd_dq` (pallas_call at :1456, body
// `_flash_attention_dq_kernel` :1146), which also writes d(ab).
//
// Given K1's forward s = (q . k^T + ab) * sm_scale over the valid keys,
// p = exp(s - lse) with K1's row log-sum-exp, o = p . v, the output gradient
// do and di = rowsum(o * do) (computed by the wrapper, as the JAX VJP does it
// outside any kernel), per (b, h):
//
//     dv = p^T . do        dp = do . v^T        ds = p * (dp - di) * sm_scale
//     dk = ds^T . q        dq = ds . k          d(ab) = ds
//
// The bias is added before the scale, so d(ab) = ds with sm_scale already in
// it, and dq, dk take no further scale. Masked keys (key_mask byte 0, or past
// Tk) have p = 0 and so zero dk, dv and d(ab); a row with no valid key has
// lse = +inf from K1 and p = 0 everywhere, so its dq is 0, never NaN.
//
//   jatts_flash_attn_bwd_dkv: one block per (b, h, 32-key tile) keeps its K
//     and V tile in shared memory and loops over the 64-row query tiles,
//     accumulating dk and dv in registers.
//   jatts_flash_attn_bwd_dq: one block per (b, h, 64-row query tile) keeps
//     its Q and dO tile and loops over the 32-key tiles, accumulating dq in
//     registers and writing each ds tile to d(ab) when a bias was given.
// Each output element is written by one block, with no atomics, so the
// result is the same from run to run. A key tile with no valid key is
// skipped (its dk, dv, d(ab) are written as 0).
//
// Bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s f32 on the CUDA cores, 989
// bf16 on the tensor cores): at the training decoder shape B=32, H=2,
// T=1024, d=192 in f32 the pair must read q, k, v, o, do (252 MB) and the
// bias (268 MB) and write dq, dk, dv (151 MB) and d(ab) (268 MB), ~0.94 GB
// -> 0.28 ms, and do five products of 2*B*H*T*T*d (p again, dv, dp, dk, dq)
// = 129 GFLOP, 1.9 ms at the f32 CUDA-core peak. This first version is
// scalar: f32 FMAs on the CUDA cores, tiles staged through shared memory as
// f32 (row pitch d + 1, conflict-free column reads), no tensor cores,
// wgmma or TMA; those are later work.
//
// Thread layout (256 threads, a 16 x 16 grid (ty, tx)): in the score phase
// thread (ty, tx) owns query rows ty + 16*i (i < 4) and keys tx + 16*j
// (j < 2) of the 64 x 32 tile; in the accumulation phase it owns output
// columns tx + 16*c (c < d/16) of key rows ty + 16*j (dkv) or query rows
// ty + 16*i (dq).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;         // query rows per tile
constexpr int BK = 32;         // keys per tile
constexpr int NTHREADS = 256;  // 16 x 16
constexpr int LDP = BK + 1;    // row pitch of the p / ds tiles

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// sQ, sdO [BQ][D+1]; sK, sV [BK][D+1]; sP, sdS [BQ][BK+1], all f32
template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)(2 * BQ + 2 * BK) * (D + 1) + 2 * BQ * LDP);
}

// rows [r0, r0 + n) of a [rows, D] matrix into a [n][D+1] f32 tile, 0 past `rows`
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, int r0, int n, int rows) {
  constexpr int LD = D + 1;
  for (int e = threadIdx.x; e < n * D; e += NTHREADS) {
    const int r = e / D, c = e % D, g = r0 + r;
    dst[r * LD + c] = g < rows ? to_f32(src[(size_t)g * D + c]) : 0.f;
  }
}

// whether key tile [k0, k0 + BK) holds a valid key; uniform over the block
__device__ __forceinline__ bool tile_has_valid_key(const uint8_t* mask_b, int k0, int Tk) {
  int any = 0;
  if (threadIdx.x < BK) {
    const int kc = k0 + threadIdx.x;
    any = kc < Tk && (mask_b == nullptr || mask_b[kc] != 0);
  }
  return __syncthreads_or(any) != 0;
}

// p and ds of this thread's 4 x 2 cells of the 64 x 32 tile (q0, k0), from
// the staged tiles. Rows past Tq and masked keys give p = ds = 0.
template <typename T, int D>
__device__ __forceinline__ void tile_p_ds(const float* sQ, const float* sdO, const float* sK,
                                          const float* sV, const T* ab_bh,
                                          const uint8_t* mask_b, const float* lse_bh,
                                          const float* di_bh, int q0, int k0, int Tq, int Tk,
                                          float sm_scale, float p[4][2], float ds[4][2]) {
  constexpr int LD = D + 1;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[4][2], dp[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qd[4], od[4], kd[2], vd[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qd[i] = sQ[(ty + 16 * i) * LD + d];
      od[i] = sdO[(ty + 16 * i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      kd[j] = sK[(tx + 16 * j) * LD + d];
      vd[j] = sV[(tx + 16 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[i][j] = fmaf(qd[i], kd[j], s[i][j]);
        dp[i][j] = fmaf(od[i], vd[j], dp[i][j]);
      }
  }
  bool valid[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int kc = k0 + tx + 16 * j;
    valid[j] = kc < Tk && (mask_b == nullptr || mask_b[kc] != 0);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty + 16 * i;
    const bool row = qr < Tq;
    const float lse = row ? lse_bh[qr] : INFINITY;
    const float di = row ? di_bh[qr] : 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int kc = k0 + tx + 16 * j;
      float x = s[i][j];
      if (ab_bh != nullptr && row && kc < Tk) x += to_f32(ab_bh[(size_t)qr * Tk + kc]);
      const float pv = (row && valid[j]) ? expf(x * sm_scale - lse) : 0.f;
      p[i][j] = pv;
      ds[i][j] = pv * (dp[i][j] - di) * sm_scale;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_attn_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ ab,
                          const uint8_t* __restrict__ key_mask, const float* __restrict__ lse,
                          const float* __restrict__ di, const T* __restrict__ dout,
                          T* __restrict__ dk, T* __restrict__ dv, int H, int Tq, int Tk,
                          float sm_scale) {
  constexpr int LD = D + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + BQ * LD;
  float* sK = sdO + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * LD;
  float* sdS = sP + BQ * LDP;

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int k0 = blockIdx.x * BK;
  const int bh = blockIdx.y;  // b * H + h
  const size_t q_base = (size_t)bh * Tq * D;
  const size_t kv_base = (size_t)bh * Tk * D;
  const T* ab_bh = ab ? ab + (size_t)bh * Tq * Tk : nullptr;
  const uint8_t* mask_b = key_mask ? key_mask + (size_t)(bh / H) * Tk : nullptr;

  float acc_k[2][DC], acc_v[2][DC];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc_k[j][c] = acc_v[j][c] = 0.f;

  if (tile_has_valid_key(mask_b, k0, Tk)) {
    stage<T, D>(sK, k + kv_base, k0, BK, Tk);
    stage<T, D>(sV, v + kv_base, k0, BK, Tk);
    for (int q0 = 0; q0 < Tq; q0 += BQ) {
      __syncthreads();  // the previous tile's reads of sQ/sdO/sP/sdS are done
      stage<T, D>(sQ, q + q_base, q0, BQ, Tq);
      stage<T, D>(sdO, dout + q_base, q0, BQ, Tq);
      __syncthreads();
      float p[4][2], ds[4][2];
      tile_p_ds<T, D>(sQ, sdO, sK, sV, ab_bh, mask_b, lse + (size_t)bh * Tq,
                      di + (size_t)bh * Tq, q0, k0, Tq, Tk, sm_scale, p, ds);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          sP[(ty + 16 * i) * LDP + tx + 16 * j] = p[i][j];
          sdS[(ty + 16 * i) * LDP + tx + 16 * j] = ds[i][j];
        }
      __syncthreads();
      // dv[key] += sum_r p[r, key] do[r];  dk[key] += sum_r ds[r, key] q[r]
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        float pr[2], dsr[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          pr[j] = sP[r * LDP + ty + 16 * j];
          dsr[j] = sdS[r * LDP + ty + 16 * j];
        }
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const float o = sdO[r * LD + tx + 16 * c];
          const float qq = sQ[r * LD + tx + 16 * c];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            acc_v[j][c] = fmaf(pr[j], o, acc_v[j][c]);
            acc_k[j][c] = fmaf(dsr[j], qq, acc_k[j][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int kr = k0 + ty + 16 * j;
    if (kr >= Tk) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const size_t g = kv_base + (size_t)kr * D + tx + 16 * c;
      store_as(&dk[g], acc_k[j][c]);
      store_as(&dv[g], acc_v[j][c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ ab,
                         const uint8_t* __restrict__ key_mask, const float* __restrict__ lse,
                         const float* __restrict__ di, const T* __restrict__ dout,
                         T* __restrict__ dq, T* __restrict__ dab, int H, int Tq, int Tk,
                         float sm_scale) {
  constexpr int LD = D + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + BQ * LD;
  float* sK = sdO + BQ * LD;
  float* sV = sK + BK * LD;
  float* sdS = sV + BK * LD + BQ * LDP;  // the p tile's room stays unused here

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const size_t q_base = (size_t)bh * Tq * D;
  const size_t kv_base = (size_t)bh * Tk * D;
  const T* ab_bh = ab ? ab + (size_t)bh * Tq * Tk : nullptr;
  T* dab_bh = dab ? dab + (size_t)bh * Tq * Tk : nullptr;
  const uint8_t* mask_b = key_mask ? key_mask + (size_t)(bh / H) * Tk : nullptr;

  stage<T, D>(sQ, q + q_base, q0, BQ, Tq);
  stage<T, D>(sdO, dout + q_base, q0, BQ, Tq);

  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < Tk; k0 += BK) {
    if (!tile_has_valid_key(mask_b, k0, Tk)) {  // also the barrier before restaging
      if (dab_bh != nullptr) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qr = q0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int kc = k0 + tx + 16 * j;
            if (qr < Tq && kc < Tk) store_as(&dab_bh[(size_t)qr * Tk + kc], 0.f);
          }
        }
      }
      continue;
    }
    stage<T, D>(sK, k + kv_base, k0, BK, Tk);
    stage<T, D>(sV, v + kv_base, k0, BK, Tk);
    __syncthreads();
    float p[4][2], ds[4][2];
    tile_p_ds<T, D>(sQ, sdO, sK, sV, ab_bh, mask_b, lse + (size_t)bh * Tq,
                    di + (size_t)bh * Tq, q0, k0, Tq, Tk, sm_scale, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kc = k0 + tx + 16 * j;
        sdS[(ty + 16 * i) * LDP + tx + 16 * j] = ds[i][j];
        if (dab_bh != nullptr && qr < Tq && kc < Tk)
          store_as(&dab_bh[(size_t)qr * Tk + kc], ds[i][j]);
      }
    }
    __syncthreads();
    // dq[r] += sum_key ds[r, key] k[key]
#pragma unroll 2
    for (int kk = 0; kk < BK; ++kk) {
      float dsr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsr[i] = sdS[(ty + 16 * i) * LDP + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float kv = sK[kk * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(dsr[i], kv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty + 16 * i;
    if (qr >= Tq) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) store_as(&dq[q_base + (size_t)qr * D + tx + 16 * c], acc[i][c]);
  }
}

struct Args {
  const void *q, *k, *v, *ab, *key_mask, *lse, *di, *dout;
  void *out_a, *out_b;  // dkv: dk, dv; dq: dq, dab
  int B, H, Tq, Tk;
  float sm_scale;
  cudaStream_t stream;
};

template <typename T, int D, bool DKV>
cudaError_t launch(const Args& a) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = DKV ? flash_attn_bwd_dkv_kernel<T, D> : flash_attn_bwd_dq_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = DKV ? (a.Tk + BK - 1) / BK : (a.Tq + BQ - 1) / BQ;
  kernel<<<dim3(tiles, a.B * a.H), NTHREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.ab), static_cast<const uint8_t*>(a.key_mask),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.di),
      static_cast<const T*>(a.dout), static_cast<T*>(a.out_a), static_cast<T*>(a.out_b), a.H,
      a.Tq, a.Tk, a.sm_scale);
  return cudaGetLastError();
}

template <bool DKV>
cudaError_t dispatch(const Args& a, int D, int is_bf16) {
  if (is_bf16) {
    switch (D) {
      case 64: return launch<__nv_bfloat16, 64, DKV>(a);
      case 128: return launch<__nv_bfloat16, 128, DKV>(a);
      case 192: return launch<__nv_bfloat16, 192, DKV>(a);
      case 256: return launch<__nv_bfloat16, 256, DKV>(a);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (D) {
    case 64: return launch<float, 64, DKV>(a);
    case 128: return launch<float, 128, DKV>(a);
    case 192: return launch<float, 192, DKV>(a);
    case 256: return launch<float, 256, DKV>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, dout: [B, H, Tq, D]; k, v: [B, H, Tk, D]; ab: [B, H, Tq, Tk] or null;
// key_mask: [B, Tk] bytes (nonzero = valid) or null; lse, di: [B, H, Tq] f32.
// dk, dv: [B, H, Tk, D]. All contiguous, one element type (is_bf16 ? bf16 :
// f32) but lse and di. Returns a cudaError_t (0 = launched).
extern "C" int jatts_flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                        const void* ab, const void* key_mask, const void* lse,
                                        const void* di, const void* dout, void* dk, void* dv,
                                        int B, int H, int Tq, int Tk, int D, int is_bf16,
                                        float sm_scale, void* stream) {
  const Args a{q, k, v, ab, key_mask, lse, di, dout, dk, dv, B, H, Tq, Tk, sm_scale,
               static_cast<cudaStream_t>(stream)};
  return (int)dispatch<true>(a, D, is_bf16);
}

// As above; dq: [B, H, Tq, D]; dab: [B, H, Tq, Tk] or null (written when ab
// was given: d(ab) = ds).
extern "C" int jatts_flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                       const void* ab, const void* key_mask, const void* lse,
                                       const void* di, const void* dout, void* dq, void* dab,
                                       int B, int H, int Tq, int Tk, int D, int is_bf16,
                                       float sm_scale, void* stream) {
  const Args a{q, k, v, ab, key_mask, lse, di, dout, dq, dab, B, H, Tq, Tk, sm_scale,
               static_cast<cudaStream_t>(stream)};
  return (int)dispatch<false>(a, D, is_bf16);
}
