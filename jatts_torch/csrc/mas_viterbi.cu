// K2, K3: Monotonic Alignment Search (Viterbi) for Hopper (sm_90a), plain C
// interface.
//
// Replaces the two Pallas TPU kernels of jatts_tpu/ops/mas_pallas.py:
// `_fwd_kernel` (the forward DP that emits decision bits) and `_bwd_kernel`
// (the backtrace), with the masking, shifting and argmax that their wrapper
// `mas_path_pallas` did around them folded into the kernels.
//
// K2 `jatts_mas_fwd`, per utterance b, over lp = log_p_attn[b] [T_feats, T_text]
// with tokens >= text_len[b] replaced by -1e9:
//     Q[0, i] = (i == 0) ? lp[0, 0] : -1e9
//     Q[j, i] = max(Q[j-1, i-1], Q[j-1, i]) + lp[j, i]      (Q[j-1, -1] = -1e9)
//     d[j, i] = Q[j-1, i-1] >= Q[j-1, i]  (the diagonal wins a tie), d[0] = 0
// and only d leaves the kernel, as packed bits: word w of frame j holds
// tokens 32w .. 32w+31, bit (i & 31) for token i, bits past T_text zero.
//
// K3 `jatts_mas_backtrace`, per utterance, walks the frames in reverse:
//     a[j] = text_len - 1                        for j >= feats_len - 1 and j = T_feats - 1
//     a[j] = max(a[j+1] - d[j+1, a[j+1]], 0)     otherwise
// and writes the int32 path a[0 .. T_feats-1]. A row with text_len = 0 has
// a = -1 on its pinned frames; -1 never indexes the bits (it reads as a 0
// bit, so an unpinned frame after it gets max(-1, 0) = 0, as the TPU pair
// gives).
//
// Bound on an H100 SXM (3.35 TB/s): at 16 x 1024 x 128 K2 reads 8.39 MB of
// lp once and writes 0.26 MB of bits (2.6 us); K3 reads those bits and
// writes 0.07 MB of path (0.1 us). Neither is near that bound and neither
// can be: each utterance is a chain of T_feats - 1 dependent steps, and a
// batch of 16 utterances fills 16 of the 132 SMs. What counts is the
// latency of one step, so the design keeps everything a step needs on the
// SM.
//
// K2: one block per utterance, one thread per token, a loop over frames in
// the block. The Q row lives in registers, one value a thread. Q[j-1, i-1]
// comes by a warp shuffle; lane 0 of a warp takes it from the last lane of
// the warp before through a two-slot shared array, double-buffered by frame
// parity so that one __syncthreads a frame is enough. The lp values of the
// next FWD_CHUNK frames are loaded while the current ones are consumed, so
// the global-memory latency is off the dependent chain. The bits of a warp
// are one __ballot_sync word, stored by lane 0.
//
// K3: one block per utterance. All threads stage a chunk of the packed bits
// (at most 32 KB) into shared memory with coalesced loads, thread 0 walks
// the chunk backward out of shared memory (a dependent global load a step
// would cost ~1 us each), and all threads write the chunk of the path back
// coalesced.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr float kNeg = -1e9f;     // the mask value: finite, so sums of it stay finite
constexpr int kFwdChunk = 8;      // frames of lp in flight per thread
constexpr int kBtThreads = 128;
constexpr int kBtWords = 8192;    // 32 KB of staged bits
constexpr int kBtFrames = 2048;   // 8 KB of staged path

__global__ void mas_fwd_kernel(const float* __restrict__ lp, const int* __restrict__ text_len,
                               int* __restrict__ bits, int t_feats, int t_text, int n_words) {
  __shared__ float edge[2][32];
  const int b = blockIdx.x;
  const int i = threadIdx.x;
  const int lane = i & 31;
  const int warp = i >> 5;
  const int tl = min(text_len[b], t_text);
  const bool in_range = i < t_text;
  const bool valid = i < tl;  // implies in_range: the only threads that read lp
  const float* col = lp + (size_t)b * t_feats * t_text + i;
  int* bits_w = bits + (size_t)b * t_feats * n_words + warp;

  // frame 0 reaches token 0 only
  float q = (i == 0 && valid) ? col[0] : kNeg;
  if (lane == 0) bits_w[0] = 0;

  float cur[kFwdChunk], nxt[kFwdChunk];
#pragma unroll
  for (int u = 0; u < kFwdChunk; ++u) {
    const int j = 1 + u;
    cur[u] = (valid && j < t_feats) ? col[(size_t)j * t_text] : kNeg;
  }
  for (int j0 = 1; j0 < t_feats; j0 += kFwdChunk) {
#pragma unroll
    for (int u = 0; u < kFwdChunk; ++u) {
      const int j = j0 + kFwdChunk + u;
      nxt[u] = (valid && j < t_feats) ? col[(size_t)j * t_text] : kNeg;
    }
#pragma unroll
    for (int u = 0; u < kFwdChunk; ++u) {
      const int j = j0 + u;
      if (j >= t_feats) break;  // uniform over the block
      if (lane == 31) edge[j & 1][warp] = q;
      __syncthreads();
      float up = __shfl_up_sync(0xffffffffu, q, 1);
      if (lane == 0) up = (warp == 0) ? kNeg : edge[j & 1][warp - 1];
      const unsigned word = __ballot_sync(0xffffffffu, in_range && (up >= q));
      q = fmaxf(up, q) + cur[u];
      if (lane == 0) bits_w[(size_t)j * n_words] = (int)word;
    }
#pragma unroll
    for (int u = 0; u < kFwdChunk; ++u) cur[u] = nxt[u];
  }
}

__global__ void mas_backtrace_kernel(const int* __restrict__ bits, const int* __restrict__ text_len,
                                     const int* __restrict__ feats_len, int* __restrict__ path,
                                     int t_feats, int t_text, int n_words) {
  __shared__ int s_bits[kBtWords];
  __shared__ int s_path[kBtFrames];
  __shared__ int s_a;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int last_tok = min(text_len[b], t_text) - 1;
  const int pin_from = feats_len[b] - 1;
  const int chunk = min(kBtFrames, kBtWords / n_words);
  const int* bits_b = bits + (size_t)b * t_feats * n_words;
  int* path_b = path + (size_t)b * t_feats;
  if (tid == 0) s_a = last_tok;

  for (int f1 = t_feats; f1 > 0; f1 -= chunk) {
    const int f0 = max(f1 - chunk, 0);
    const int n = f1 - f0;
    // s_bits row jj holds d[f0 + jj + 1]: the row that frame f0 + jj consults
    const int lo = (f0 + 1) * n_words;
    const int hi = min(f1 + 1, t_feats) * n_words;
    for (int k = tid; k < hi - lo; k += kBtThreads) s_bits[k] = bits_b[lo + k];
    __syncthreads();
    if (tid == 0) {
      int a = s_a;
      for (int jj = n - 1; jj >= 0; --jj) {
        const int j = f0 + jj;
        if (j >= pin_from || j == t_feats - 1) {
          a = last_tok;
        } else {
          int bit = 0;
          if (a >= 0) bit = ((unsigned)s_bits[jj * n_words + (a >> 5)] >> (a & 31)) & 1u;
          a = max(a - bit, 0);
        }
        s_path[jj] = a;
      }
      s_a = a;
    }
    __syncthreads();
    for (int k = tid; k < n; k += kBtThreads) path_b[f0 + k] = s_path[k];
    // the next round's first barrier orders these reads of s_path before
    // thread 0 writes it again
  }
}

}  // namespace

// lp: [B, T_feats, T_text] f32, contiguous; text_len: [B] int32;
// bits: [B, T_feats, ceil(T_text / 32)] int32 out. 1 <= T_text <= 1024.
// Returns a cudaError_t (0 = launched).
extern "C" int jatts_mas_fwd(const void* lp, const void* text_len, void* bits, int b, int t_feats,
                             int t_text, void* stream) {
  if (b <= 0 || t_feats <= 0 || t_text <= 0 || t_text > 1024) return (int)cudaErrorInvalidValue;
  const int n_words = (t_text + 31) / 32;
  mas_fwd_kernel<<<b, n_words * 32, 0, (cudaStream_t)stream>>>(
      (const float*)lp, (const int*)text_len, (int*)bits, t_feats, t_text, n_words);
  return (int)cudaGetLastError();
}

// bits as written by jatts_mas_fwd; text_len, feats_len: [B] int32;
// path: [B, T_feats] int32 out. Returns a cudaError_t (0 = launched).
extern "C" int jatts_mas_backtrace(const void* bits, const void* text_len, const void* feats_len,
                                   void* path, int b, int t_feats, int t_text, void* stream) {
  if (b <= 0 || t_feats <= 0 || t_text <= 0 || t_text > 1024) return (int)cudaErrorInvalidValue;
  const int n_words = (t_text + 31) / 32;
  mas_backtrace_kernel<<<b, kBtThreads, 0, (cudaStream_t)stream>>>(
      (const int*)bits, (const int*)text_len, (const int*)feats_len, (int*)path, t_feats, t_text,
      n_words);
  return (int)cudaGetLastError();
}
