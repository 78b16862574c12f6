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
// Causal form (K1b: the same two pallas_calls with causal=True, element mask
// at flash_attention.py:877-885 and in the dq body): with Tq == Tk, p = 0
// wherever key j > query row i, AND-ed with the key mask. A compile-time
// flag (CAUSAL) selects it, so the non-causal instantiations are unchanged.
// The work the mask removes is skipped, as the TPU kernels skip blocks
// above the diagonal: the dk/dv block of key tile k0 starts at the query
// tile that holds row k0 (no earlier row sees a key of the tile); the dq
// block of query tile q0 stops at the last key tile that reaches its last
// row (past it only d(ab) = 0 is written, when there is a bias). The tiles
// that straddle the diagonal, 64 query rows against 32 keys, are masked
// element by element. The dq blocks are taken in reverse order, so the
// heaviest start first; the dk/dv blocks are heaviest first already.
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
//
// K1r, the fused rel-pos form (d_qk != d_v): the backward of the call that
// jatts_tpu/modules/attention.py:372-385 makes for the "latest" rel-pos
// attention (q, k of width d_qk = d_k + n_feat, v, do of width d_v = d_k, no
// bias, key mask, non-causal): dq and dk of width d_qk, dv of width d_v. Two
// kernels of their own (the *_relpos kernels), instantiated for the
// (d_qk, d_v) pairs the port uses, so the d_qk == d_v instantiations above
// are the code they were. At d_qk = 576 the 64-row tiles above need ~296 KB
// of shared memory and the dq block 4 x 36 accumulators a thread; K1r takes
// 32 x 32 tiles instead: the dk/dv block holds its 32 keys of k and v and
// stages 32 query rows of q and do at a time (205,568 bytes at (576, 192)),
// thread (ty, tx) owns 2 x 2 cells of the score tile and 2 key rows of dk
// (2 x d_qk/16 accumulators) and dv (2 x d_v/16); the dq block holds its 32
// rows of q and do and stages 32 keys at a time (201,344 bytes), 2 rows of
// dq a thread (2 x d_qk/16). Bound at the training decoder shape (B, H, T =
// 32, 2, 1024, f32): dk/dv does the products s, dp, dv and dk, 2 * B*H*T*T
// * (576 + 192 + 192 + 576) = 206.2 GFLOP -> 3.08 ms at the f32 CUDA-core
// peak; dq does s, dp and dq, 180.4 GFLOP -> 2.69 ms.

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
// the staged tiles. Rows past Tq and masked keys (and, causal, keys past
// the row) give p = ds = 0.
template <typename T, int D, bool CAUSAL>
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
      const bool seen = row && valid[j] && (!CAUSAL || kc <= qr);
      const float pv = seen ? expf(x * sm_scale - lse) : 0.f;
      p[i][j] = pv;
      ds[i][j] = pv * (dp[i][j] - di) * sm_scale;
    }
  }
}

template <typename T, int D, bool CAUSAL>
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
    // causal: rows before k0 see no key of this tile
    for (int q0 = CAUSAL ? (k0 / BQ) * BQ : 0; q0 < Tq; q0 += BQ) {
      __syncthreads();  // the previous tile's reads of sQ/sdO/sP/sdS are done
      stage<T, D>(sQ, q + q_base, q0, BQ, Tq);
      stage<T, D>(sdO, dout + q_base, q0, BQ, Tq);
      __syncthreads();
      float p[4][2], ds[4][2];
      tile_p_ds<T, D, CAUSAL>(sQ, sdO, sK, sV, ab_bh, mask_b, lse + (size_t)bh * Tq,
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

template <typename T, int D, bool CAUSAL>
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
  // causal: the last query tile (the most keys) is scheduled first
  const int q0 = (CAUSAL ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * BQ;
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

  // causal: key tiles from q0 + BQ on are above the diagonal, p = 0 there;
  // they are visited only to write d(ab) = 0
  const int k_live = CAUSAL ? min(Tk, q0 + BQ) : Tk;
  const int k_end = dab_bh != nullptr ? Tk : k_live;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    // also the barrier before restaging; block-uniform, as is k0 < k_live
    if (!tile_has_valid_key(mask_b, k0, Tk) || k0 >= k_live) {
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
    tile_p_ds<T, D, CAUSAL>(sQ, sdO, sK, sV, ab_bh, mask_b, lse + (size_t)bh * Tq,
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

// ---------------------------------------------------------------------------
// K1r: the fused rel-pos form, d_qk != d_v (no bias, key mask, non-causal)
// ---------------------------------------------------------------------------

constexpr int BQR = 32;  // query rows per tile

// sQ [BQR][DQK+1], sdO [BQR][DV+1], sK [BK][DQK+1], sV [BK][DV+1], then
// sP and sdS [BQR][BK+1] (the dq kernel uses the first of the two), all f32
template <int DQK, int DV>
constexpr size_t relpos_smem_bytes() {
  return sizeof(float) * ((size_t)(BQR + BK) * (DQK + 1 + DV + 1) + 2 * BQR * LDP);
}

// p and ds of this thread's 2 x 2 cells of the 32 x 32 tile (q0, k0): s over
// d_qk, dp over d_v. Rows past Tq and masked keys give p = ds = 0.
template <int DQK, int DV>
__device__ __forceinline__ void relpos_tile_p_ds(const float* sQ, const float* sdO,
                                                 const float* sK, const float* sV,
                                                 const uint8_t* mask_b, const float* lse_bh,
                                                 const float* di_bh, int q0, int k0, int Tq,
                                                 int Tk, float sm_scale, float p[2][2],
                                                 float ds[2][2]) {
  constexpr int LDQ = DQK + 1, LDV = DV + 1;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[2][2], dp[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DQK; ++d) {
    float qd[2], kd[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) qd[i] = sQ[(ty + 16 * i) * LDQ + d];
#pragma unroll
    for (int j = 0; j < 2; ++j) kd[j] = sK[(tx + 16 * j) * LDQ + d];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) s[i][j] = fmaf(qd[i], kd[j], s[i][j]);
  }
#pragma unroll 4
  for (int d = 0; d < DV; ++d) {
    float od[2], vd[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) od[i] = sdO[(ty + 16 * i) * LDV + d];
#pragma unroll
    for (int j = 0; j < 2; ++j) vd[j] = sV[(tx + 16 * j) * LDV + d];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) dp[i][j] = fmaf(od[i], vd[j], dp[i][j]);
  }
  bool valid[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int kc = k0 + tx + 16 * j;
    valid[j] = kc < Tk && (mask_b == nullptr || mask_b[kc] != 0);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qr = q0 + ty + 16 * i;
    const bool row = qr < Tq;
    const float lse = row ? lse_bh[qr] : INFINITY;
    const float di = row ? di_bh[qr] : 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float pv = row && valid[j] ? expf(s[i][j] * sm_scale - lse) : 0.f;
      p[i][j] = pv;
      ds[i][j] = pv * (dp[i][j] - di) * sm_scale;
    }
  }
}

template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(NTHREADS)
flash_attn_bwd_dkv_relpos_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                 const T* __restrict__ v, const uint8_t* __restrict__ key_mask,
                                 const float* __restrict__ lse, const float* __restrict__ di,
                                 const T* __restrict__ dout, T* __restrict__ dk,
                                 T* __restrict__ dv, int H, int Tq, int Tk, float sm_scale) {
  constexpr int LDQ = DQK + 1, LDV = DV + 1;
  constexpr int CQ = DQK / 16, CV = DV / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + BQR * LDQ;
  float* sK = sdO + BQR * LDV;
  float* sV = sK + BK * LDQ;
  float* sP = sV + BK * LDV;
  float* sdS = sP + BQR * LDP;

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int k0 = blockIdx.x * BK;
  const int bh = blockIdx.y;  // b * H + h
  const size_t q_base = (size_t)bh * Tq * DQK;
  const size_t o_base = (size_t)bh * Tq * DV;
  const size_t k_base = (size_t)bh * Tk * DQK;
  const size_t v_base = (size_t)bh * Tk * DV;
  const uint8_t* mask_b = key_mask ? key_mask + (size_t)(bh / H) * Tk : nullptr;

  float acc_k[2][CQ], acc_v[2][CV];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int c = 0; c < CQ; ++c) acc_k[j][c] = 0.f;
#pragma unroll
    for (int c = 0; c < CV; ++c) acc_v[j][c] = 0.f;
  }

  if (tile_has_valid_key(mask_b, k0, Tk)) {
    stage<T, DQK>(sK, k + k_base, k0, BK, Tk);
    stage<T, DV>(sV, v + v_base, k0, BK, Tk);
    for (int q0 = 0; q0 < Tq; q0 += BQR) {
      __syncthreads();  // the previous tile's reads of sQ/sdO/sP/sdS are done
      stage<T, DQK>(sQ, q + q_base, q0, BQR, Tq);
      stage<T, DV>(sdO, dout + o_base, q0, BQR, Tq);
      __syncthreads();
      float p[2][2], ds[2][2];
      relpos_tile_p_ds<DQK, DV>(sQ, sdO, sK, sV, mask_b, lse + (size_t)bh * Tq,
                                di + (size_t)bh * Tq, q0, k0, Tq, Tk, sm_scale, p, ds);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          sP[(ty + 16 * i) * LDP + tx + 16 * j] = p[i][j];
          sdS[(ty + 16 * i) * LDP + tx + 16 * j] = ds[i][j];
        }
      __syncthreads();
      // dv[key] += sum_r p[r, key] do[r];  dk[key] += sum_r ds[r, key] q[r]
#pragma unroll 2
      for (int r = 0; r < BQR; ++r) {
        float pr[2], dsr[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          pr[j] = sP[r * LDP + ty + 16 * j];
          dsr[j] = sdS[r * LDP + ty + 16 * j];
        }
#pragma unroll
        for (int c = 0; c < CV; ++c) {
          const float o = sdO[r * LDV + tx + 16 * c];
#pragma unroll
          for (int j = 0; j < 2; ++j) acc_v[j][c] = fmaf(pr[j], o, acc_v[j][c]);
        }
#pragma unroll
        for (int c = 0; c < CQ; ++c) {
          const float qq = sQ[r * LDQ + tx + 16 * c];
#pragma unroll
          for (int j = 0; j < 2; ++j) acc_k[j][c] = fmaf(dsr[j], qq, acc_k[j][c]);
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int kr = k0 + ty + 16 * j;
    if (kr >= Tk) continue;
#pragma unroll
    for (int c = 0; c < CQ; ++c) store_as(&dk[k_base + (size_t)kr * DQK + tx + 16 * c], acc_k[j][c]);
#pragma unroll
    for (int c = 0; c < CV; ++c) store_as(&dv[v_base + (size_t)kr * DV + tx + 16 * c], acc_v[j][c]);
  }
}

template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(NTHREADS)
flash_attn_bwd_dq_relpos_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                const T* __restrict__ v, const uint8_t* __restrict__ key_mask,
                                const float* __restrict__ lse, const float* __restrict__ di,
                                const T* __restrict__ dout, T* __restrict__ dq,
                                T* __restrict__ /* no d(ab) */, int H, int Tq, int Tk, float sm_scale) {
  constexpr int LDQ = DQK + 1, LDV = DV + 1;
  constexpr int CQ = DQK / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + BQR * LDQ;
  float* sK = sdO + BQR * LDV;
  float* sV = sK + BK * LDQ;
  float* sdS = sV + BK * LDV;

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q0 = blockIdx.x * BQR;
  const int bh = blockIdx.y;
  const size_t q_base = (size_t)bh * Tq * DQK;
  const size_t o_base = (size_t)bh * Tq * DV;
  const size_t k_base = (size_t)bh * Tk * DQK;
  const size_t v_base = (size_t)bh * Tk * DV;
  const uint8_t* mask_b = key_mask ? key_mask + (size_t)(bh / H) * Tk : nullptr;

  stage<T, DQK>(sQ, q + q_base, q0, BQR, Tq);
  stage<T, DV>(sdO, dout + o_base, q0, BQR, Tq);

  float acc[2][CQ];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < CQ; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < Tk; k0 += BK) {
    // also the barrier before restaging; block-uniform
    if (!tile_has_valid_key(mask_b, k0, Tk)) continue;
    stage<T, DQK>(sK, k + k_base, k0, BK, Tk);
    stage<T, DV>(sV, v + v_base, k0, BK, Tk);
    __syncthreads();
    float p[2][2], ds[2][2];
    relpos_tile_p_ds<DQK, DV>(sQ, sdO, sK, sV, mask_b, lse + (size_t)bh * Tq,
                              di + (size_t)bh * Tq, q0, k0, Tq, Tk, sm_scale, p, ds);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) sdS[(ty + 16 * i) * LDP + tx + 16 * j] = ds[i][j];
    __syncthreads();
    // dq[r] += sum_key ds[r, key] k[key]
#pragma unroll 2
    for (int kk = 0; kk < BK; ++kk) {
      float dsr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) dsr[i] = sdS[(ty + 16 * i) * LDP + kk];
#pragma unroll
      for (int c = 0; c < CQ; ++c) {
        const float kv = sK[kk * LDQ + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 2; ++i) acc[i][c] = fmaf(dsr[i], kv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qr = q0 + ty + 16 * i;
    if (qr >= Tq) continue;
#pragma unroll
    for (int c = 0; c < CQ; ++c) store_as(&dq[q_base + (size_t)qr * DQK + tx + 16 * c], acc[i][c]);
  }
}

struct Args {
  const void *q, *k, *v, *ab, *key_mask, *lse, *di, *dout;
  void *out_a, *out_b;  // dkv: dk, dv; dq: dq, dab
  int B, H, Tq, Tk;
  float sm_scale;
  cudaStream_t stream;
};

template <typename T, int D, bool DKV, bool CAUSAL>
cudaError_t launch(const Args& a) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel =
      DKV ? flash_attn_bwd_dkv_kernel<T, D, CAUSAL> : flash_attn_bwd_dq_kernel<T, D, CAUSAL>;
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

template <bool DKV, bool CAUSAL>
cudaError_t dispatch_d(const Args& a, int D, int is_bf16) {
  if (is_bf16) {
    switch (D) {
      case 64: return launch<__nv_bfloat16, 64, DKV, CAUSAL>(a);
      case 128: return launch<__nv_bfloat16, 128, DKV, CAUSAL>(a);
      case 192: return launch<__nv_bfloat16, 192, DKV, CAUSAL>(a);
      case 256: return launch<__nv_bfloat16, 256, DKV, CAUSAL>(a);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (D) {
    case 64: return launch<float, 64, DKV, CAUSAL>(a);
    case 128: return launch<float, 128, DKV, CAUSAL>(a);
    case 192: return launch<float, 192, DKV, CAUSAL>(a);
    case 256: return launch<float, 256, DKV, CAUSAL>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <bool DKV>
cudaError_t dispatch(const Args& a, int D, int is_bf16, int causal) {
  if (!causal) return dispatch_d<DKV, false>(a, D, is_bf16);
  if (a.Tq != a.Tk) return cudaErrorInvalidValue;
  return dispatch_d<DKV, true>(a, D, is_bf16);
}

template <typename T, int DQK, int DV, bool DKV>
cudaError_t launch_relpos(const Args& a) {
  constexpr size_t smem = relpos_smem_bytes<DQK, DV>();
  auto kernel = DKV ? flash_attn_bwd_dkv_relpos_kernel<T, DQK, DV>
                    : flash_attn_bwd_dq_relpos_kernel<T, DQK, DV>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = DKV ? (a.Tk + BK - 1) / BK : (a.Tq + BQR - 1) / BQR;
  kernel<<<dim3(tiles, a.B * a.H), NTHREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const uint8_t*>(a.key_mask), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.di), static_cast<const T*>(a.dout), static_cast<T*>(a.out_a),
      static_cast<T*>(a.out_b), a.H, a.Tq, a.Tk, a.sm_scale);
  return cudaGetLastError();
}

// K1r: the (d_qk, d_v) pairs of the port, 2 heads of 64 (adim 128) and of
// 192 (adim 384, the JSUT/JVS width); no bias, no d(ab), no causal form
template <bool DKV>
cudaError_t dispatch_relpos(const Args& a, int Dqk, int Dv, int is_bf16, int causal) {
  if (a.ab != nullptr || (!DKV && a.out_b != nullptr) || causal) return cudaErrorInvalidValue;
  if (Dqk == 192 && Dv == 64)
    return is_bf16 ? launch_relpos<__nv_bfloat16, 192, 64, DKV>(a)
                   : launch_relpos<float, 192, 64, DKV>(a);
  if (Dqk == 576 && Dv == 192)
    return is_bf16 ? launch_relpos<__nv_bfloat16, 576, 192, DKV>(a)
                   : launch_relpos<float, 576, 192, DKV>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

// q: [B, H, Tq, Dqk]; k: [B, H, Tk, Dqk]; v: [B, H, Tk, Dv]; dout: [B, H,
// Tq, Dv]; ab: [B, H, Tq, Tk] or null; key_mask: [B, Tk] bytes (nonzero =
// valid) or null; lse, di: [B, H, Tq] f32. dk: [B, H, Tk, Dqk], dv: [B, H,
// Tk, Dv]. All contiguous, one element type (is_bf16 ? bf16 : f32) but lse
// and di. Dqk == Dv takes K1-bwd (causal != 0: K1b's, which needs Tq == Tk);
// Dqk != Dv takes K1r's, which needs no bias and no causal form and a
// (Dqk, Dv) pair it was built for. Returns a cudaError_t (0 = launched).
extern "C" int jatts_flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                        const void* ab, const void* key_mask, const void* lse,
                                        const void* di, const void* dout, void* dk, void* dv,
                                        int B, int H, int Tq, int Tk, int Dqk, int Dv,
                                        int is_bf16, int causal, float sm_scale, void* stream) {
  const Args a{q, k, v, ab, key_mask, lse, di, dout, dk, dv, B, H, Tq, Tk, sm_scale,
               static_cast<cudaStream_t>(stream)};
  if (Dqk != Dv) return (int)dispatch_relpos<true>(a, Dqk, Dv, is_bf16, causal);
  return (int)dispatch<true>(a, Dqk, is_bf16, causal);
}

// As above; dq: [B, H, Tq, Dqk]; dab: [B, H, Tq, Tk] or null (written when
// ab was given: d(ab) = ds; always null for K1r).
extern "C" int jatts_flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                       const void* ab, const void* key_mask, const void* lse,
                                       const void* di, const void* dout, void* dq, void* dab,
                                       int B, int H, int Tq, int Tk, int Dqk, int Dv,
                                       int is_bf16, int causal, float sm_scale, void* stream) {
  const Args a{q, k, v, ab, key_mask, lse, di, dout, dq, dab, B, H, Tq, Tk, sm_scale,
               static_cast<cudaStream_t>(stream)};
  if (Dqk != Dv) return (int)dispatch_relpos<false>(a, Dqk, Dv, is_bf16, causal);
  return (int)dispatch<false>(a, Dqk, is_bf16, causal);
}
