// f32 building blocks shared by the 3xTF32 tensor-core kernels
// (flash_attn_fwd_tc_f32.cu, flash_attn_bwd_tc_f32.cu), on tc_common.cuh:
// the TF32 split by integer rounding, the .tf32 wgmma, the 64 x 32 f32 slab
// (one 128-byte swizzle row a row, 8 KB, 1024-byte aligned) and its tensor
// maps, the block's three roles (a consumer warpgroup, a TMA producer warp,
// three split warps) and the f32 bias's staging by cp.async. sm_90a only
// (wgmma).

#pragma once

#include "tc_common.cuh"

namespace {

constexpr int FSLAB = 64 * 32 * 4;  // bytes of a 64 x 32 f32 slab
constexpr int NSPLITTERS = 96;      // the split pass's threads (warps 5-7)
constexpr int NTHREADS_F = 128 + 32 + NSPLITTERS;  // consumers, producer, split warps

// x rounded to TF32 as cvt.rna.tf32.f32 rounds (to nearest at bit 13, ties
// away from zero, the 13 low bits zero) for every finite x, in two integer
// operations: with the conversion instruction the kernel takes 10-13% longer
// on an H100 (bin/study_fwd_tc_f32.py)
__device__ __forceinline__ uint32_t tf32_rna(float x) { return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u; }

// x -> hi = rna(x), lo = rna(x - hi) (x - hi is exact in f32)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void split4(const float4& x, uint4& hi, uint4& lo) {
  split_tf32(x.x, hi.x, lo.x);
  split_tf32(x.y, hi.y, lo.y);
  split_tf32(x.z, hi.z, lo.z);
  split_tf32(x.w, hi.w, lo.w);
}

// d (+)= A.B, m64n64k8 .tf32: A (4 registers a thread: rows r and r + 8 at
// columns c and c + 4) from registers, B K-major in shared memory
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2,
                                           uint32_t a3, uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}"
      : WG_OUT32(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(accumulate));
}

// one k-step of 3xTF32: hi.lo + lo.hi + hi.hi, the small terms first.
// a[0..3] the hi fragment, a[4..7] the lo one
__device__ __forceinline__ void wgmma_3xtf32(float (&d)[32], const uint32_t (&a)[8], uint64_t b_hi,
                                             uint64_t b_lo, int accumulate) {
  wgmma_tf32(d, a[0], a[1], a[2], a[3], b_lo, accumulate);
  wgmma_tf32(d, a[4], a[5], a[6], a[7], b_hi, 1);
  wgmma_tf32(d, a[0], a[1], a[2], a[3], b_hi, 1);
}

// keeps fragments in their registers until the wait that retires the wgmmas
// reading them (the hardware reads them asynchronously)
template <int N>
__device__ __forceinline__ void keep_frags(uint32_t (&a)[N][8]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(dst), "l"(src) : "memory");
}

// the key columns kc, kc+1 of an f32 bias row (null: a row past Tq) into
// the shared pair dst: by cp.async where the pair is whole and 8-byte
// aligned, else by plain loads (an odd Tk, the ragged edge; 0 past Tk)
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

// byte offset of element (row, col < 32) in a 128-byte-swizzled f32 slab
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return (uint32_t)(row * 128 + ((((col >> 2) ^ (row & 7))) << 4) + (col & 3) * 4);
}

// a 3-d map over a contiguous f32 [BH, T, D] with (box_cols x box_rows)
// boxes, 128-byte swizzle (box_cols 32) or none; rows past T read as zeros,
// never as the next head's
bool make_map_f32(CUtensorMap* map, const void* ptr, int BH, int T, int D, int box_cols, int box_rows,
                  bool swizzle) {
  EncodeTiled enc = encode_fn();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 4, (cuuint64_t)T * D * 4};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t estride[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims, strides, box, estride,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
