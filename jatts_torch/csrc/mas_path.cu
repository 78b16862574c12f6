// The whole MAS Viterbi search, forward DP and backtrace, in one launch for
// Hopper (sm_90a), plain C interface.
//
// Replaces the two Pallas TPU kernels of jatts_tpu/ops/mas_pallas.py:
// `_fwd_kernel` (pallas_call at :139, the forward DP that emits decision
// bits) and `_bwd_kernel` (pallas_call at :161, the backtrace), with the
// masking, shifting and argmax of their wrapper `mas_path_pallas` folded in.
// It computes what K2 and K3 of mas_viterbi.cu compute, bit for bit:
//     Q[0, i] = (i == 0) ? lp[0, 0] : -1e9      (lp = -1e9 at tokens >= text_len)
//     Q[j, i] = max(Q[j-1, i-1], Q[j-1, i]) + lp[j, i]      (Q[j-1, -1] = -1e9)
//     d[j, i] = Q[j-1, i-1] >= Q[j-1, i]  (the diagonal wins a tie), d[0] = 0
//     a[j] = text_len - 1                     for j >= feats_len - 1 and j = T_feats - 1
//     a[j] = max(a[j+1] - d[j+1, a[j+1]], 0)  otherwise (a = -1 reads a 0 bit)
// and writes the int32 path a. Each Q cell is one f32 max and one f32 add of
// the same operands in any schedule, so the path is the plain version's.
//
// What bounds it. By the roofline, bytes: at 16 x 1024 x 128 the search
// reads at most 8.4 MB of lp and writes 0.07 MB of path, ~2.5 us at 3.35
// TB/s. In practice, latency: an utterance is a chain of T_feats - 1
// dependent frame steps forward and as many backward, and a batch of 16
// utterances fills 16 of the 132 SMs. The PR 2 pair spends ~155 cycles a
// forward step (a block barrier, a shared-memory round trip and a shuffle
// on the chain) and ~115 a backtrace step (a dependent shared-memory load),
// plus a second launch and 0.26 MB of bits through device memory between
// the two. The floor is one f32 max and one f32 add a frame.
//
// The design: one block per utterance; consumer warps run the forward, a
// barrier follows, and warp 0 walks the backtrace in the same block, with
// the decision bits kept in shared memory between them.
//
// Forward. Tokens are strided over a consumer warp's lanes: slot r of lane
// l holds token 32 s + l of the warp's slot s, so one __ballot_sync a slot
// is word s of K2's packed layout. Every left neighbour Q[j-1, i-1] comes by
// one rotating shuffle a slot (lane 0 takes lane 31's value of the slot
// before), all issued together: the chain a frame is a shuffle, a select, a
// max and an add, with no barrier. Up to T_text = 128 (4 slots) one warp
// does it all. Wider, each consumer warp owns up to 4 slots and also
// recomputes, as a halo, the last slot of the warp before: a halo lane l is
// exact for l frames after a refresh, and the warp's first token reads lane
// 31, so one exchange through shared memory and one barrier of the consumers
// every 32 frames are enough. The halo repeats the owner's operations on
// the same operands, so its values are the owner's.
//
// lp. One warp that issues its own global loads, or its own cp.asyncs,
// stalls on them for ~100 cycles a frame (bin/study_mas.py), so 3 producer
// warps (each alone on an SM sub-partition beside one consumer) stream lp
// into a ring of 4 chunks of 32 frames in shared memory: every load of a
// chunk in flight together, coalesced (128 bytes a slot), masked tokens
// written as -1e9, each lane's 4 values of a frame side by side for one
// 16-byte shared load. mbarriers hand the chunks over (full: the producers
// wrote it; empty: the consumers read it). The consumer loads the next
// frame's values while the current one runs, and lane 0 writes the row's
// words in one 16-byte store, predicated without a branch. The forward
// stops at the last frame the backtrace reads (feats_len - 1) unless the
// caller asked for every frame's bits (bits_out). Measured on an H100 at
// 16 x 1024 x 128: 62 cycles a frame, against 55 for the same step with no
// memory and 40 for its chain alone.
//
// Bits. T_feats x ceil(T_text / 32) words in dynamic shared memory (16 KB
// at 1024 x 128) when they fit in `smem_bits_bytes`; otherwise the
// consumers write them, a stage at a time, to device memory (bits_out, or a
// scratch the wrapper allocates), and the backtrace stages them back in
// chunks of whole frames.
//
// Backtrace, by warp 0, 32 frames at a time. From a known token a0 at frame
// f, the next 32 steps stay within tokens a0 - 31 .. a0, so lane k reads
// the two words of row f - k that hold them (independent loads, off the
// chain), shifts them into a 32-bit window, reverses it so bit delta is
// token a0 - delta, and clears the bit of token 0 (there max(a - 1, 0) = a).
// Then every lane walks the 32 windows, fetched by shuffles issued
// together, with a one-hot m = 1 << delta: m += window & m moves to the
// diagonal exactly when the bit under m is set. Two integer operations a
// step are the chain (~20 cycles a step measured, against ~105 for K3);
// lane k keeps m after its step and writes a0 - popc(m - 1) (popc also reads
// the overflow of delta = 32 as 0 - 1). The pinned frames are written by
// all threads before the search.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr float kNeg = -1e9f;       // the mask value: finite, so sums of it stay finite
constexpr int kMaxSlots = 4;        // 32-token slots a consumer warp owns
constexpr int kExchange = 32;       // frames between halo refreshes (a halo slot is 32 tokens)
constexpr int kMinStageRows = 32;   // a stage of bits in shared memory holds at least a chunk of frames
constexpr unsigned kFull = 0xffffffffu;

struct Whole { static constexpr bool value = true; };   // a chunk of F frames
struct Tail { static constexpr bool value = false; };   // the last chunk, fewer frames

template <bool HALO>
struct Ring {
  // the lp ring: kChunks chunks of kFrames frames; a frame holds, for each
  // consumer warp, 32 lanes x 4 floats (a lane's tokens of the warp's slots)
  static constexpr int kFrames = HALO ? 4 : 32;  // frames a chunk
  static constexpr int kChunks = HALO ? 3 : 4;   // chunks the producers may run ahead
};
constexpr int kProducers = 3;  // producer warps: with one consumer, each on an SM sub-partition of its own

__device__ __forceinline__ unsigned smem_addr(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }
__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("{\n .reg .b64 state;\n mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}
__device__ __forceinline__ void consumers_sync(int threads) {  // named barrier 1: the consumer warps
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}
__device__ __forceinline__ float4 lds4(unsigned addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ float lds1(unsigned addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}
// n words to device memory, by the consumer threads between two of their barriers
__device__ __forceinline__ void copy_rows(unsigned* dst, const unsigned* src, int n, int tid, int threads) {
  consumers_sync(threads);
  for (int k = tid; k < n; k += threads) dst[k] = src[k];
  consumers_sync(threads);
}

template <int R, bool HALO>
__global__ void __launch_bounds__(32 * ((HALO ? 8 : 1) + kProducers), 1)
mas_path_kernel(const float* __restrict__ lp, const int* __restrict__ text_len,
                const int* __restrict__ feats_len, int* __restrict__ path, unsigned* gbits,
                int full_bits, int t_feats, int t_text, int n_words, int smem_rows) {
  constexpr int F = Ring<HALO>::kFrames;
  constexpr int K = Ring<HALO>::kChunks;
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_cons = (int)(blockDim.x >> 5) - kProducers;  // consumer warps; the last warps produce
  const int cons_threads = 32 * n_cons;
  const int tl = min(text_len[b], t_text);
  const int last_tok = tl - 1;
  // frames >= max(s, 0) are pinned to last_tok; the walk starts at frame s
  const int s = min(feats_len[b] - 1, t_feats - 1);
  // shared memory holds rows [seg0, seg0 + smem_rows) of the bits: every
  // row when smem_rows >= t_feats, else a stage that goes to gbits when full
  const bool in_smem = smem_rows >= t_feats;
  // [K full, K empty mbarriers][ring: K x F frames x cons_threads x 4 floats][edge: 2 x cons_threads][bits]
  const unsigned bars = smem_addr(smem);
  const int frame_floats = HALO ? cons_threads * 4 : 128;  // one consumer without a halo
  float* ring = reinterpret_cast<float*>(smem + 16 * K);
  const unsigned ring_s = smem_addr(ring);
  float* edge = ring + K * F * frame_floats;
  unsigned* sbits = reinterpret_cast<unsigned*>(edge + (HALO ? 2 * cons_threads : 0));
  const float* lp_b = lp + (size_t)b * t_feats * t_text;
  int* path_b = path + (size_t)b * t_feats;
  unsigned* gbits_b = gbits ? gbits + (size_t)b * t_feats * n_words : nullptr;
  const int f_end = full_bits ? t_feats : max(s + 1, 1);  // frames the caller needs
  const int n_chunks = (f_end - 1 + F - 1) / F;           // frames 1 .. f_end - 1

  if (tid == 0) {
    for (int k = 0; k < K; ++k) {
      mbar_init(bars + 8 * k, 32 * kProducers);    // full: every producer thread
      mbar_init(bars + 8 * (K + k), cons_threads);  // empty: every consumer thread
    }
  }
  for (int j = max(s, 0) + tid; j < t_feats; j += blockDim.x) path_b[j] = last_tok;
  __syncthreads();

  if (warp >= n_cons) {
    // ---- producers: lp rows into the ring, a chunk of frames at a time,
    // frame u of a chunk by producer u % kProducers; masked tokens -1e9
    const int p = warp - n_cons;
    for (int c = 0; c < n_chunks; ++c) {
      const int k = c % K;
      if (c >= K) mbar_wait(bars + 8 * (K + k), (c / K - 1) & 1);  // the consumers are done with it
      const int j0 = 1 + c * F;
      for (int w = 0; w < n_cons; ++w) {
        // every load of the chunk first (rows past f_end read the last row
        // and are not stored), so they are in flight together
        constexpr int U = (F + kProducers - 1) / kProducers;
        bool ok[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) ok[r] = r < R && 32 * (w * R + r) + lane < tl;
        float4 v[U];
#pragma unroll
        for (int i = 0; i < U; ++i) {
          const int j = min(j0 + p + i * kProducers, f_end - 1);
          const float* row = lp_b + (size_t)j * t_text + 32 * w * R + lane;
          v[i].x = ok[0] ? row[0] : kNeg;
          v[i].y = ok[1] ? row[32] : kNeg;
          v[i].z = ok[2] ? row[64] : kNeg;
          v[i].w = ok[3] ? row[96] : kNeg;
        }
#pragma unroll
        for (int i = 0; i < U; ++i) {
          const int u = p + i * kProducers;
          if (u < F && j0 + u < f_end)
            *reinterpret_cast<float4*>(ring + (k * F + u) * frame_floats + (w * 32 + lane) * 4) = v[i];
        }
      }
      mbar_arrive(bars + 8 * k);
    }
  } else {
    // ---- consumers: the forward DP ----
    // slot r of this warp is slot warp * R + r of the row; the halo slot is
    // the slot before the warp's first (tokens -32 .. -1 for warp 0: masked)
    const int slot0 = warp * R;
    bool valid[R];
    unsigned in_range[R];  // the slot's tokens below T_text, as ballot bits
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int tok = 32 * (slot0 + r) + lane;
      in_range[r] = __ballot_sync(kFull, tok < t_text);
      valid[r] = tok < tl;
    }
    const int tok_h = 32 * (slot0 - 1) + lane;
    const bool valid_h = HALO && tok_h >= 0 && tok_h < tl;
    const bool left_from_halo = HALO && warp > 0;
    // this lane's 4 values of frame u of ring chunk k, and its halo value
    // (the warp before's last slot, same lane)
    auto my_frame = [&](int k, int u) { return ring_s + 4 * ((k * F + u) * frame_floats + tid * 4); };
    auto halo_at = [&](int k, int u) { return my_frame(k, u) + 4 * ((R - 1) - 32 * 4); };

    float q[R];
#pragma unroll
    for (int r = 0; r < R; ++r) q[r] = (slot0 + r == 0 && lane == 0 && valid[r]) ? lp_b[0] : kNeg;
    float qh = (tok_h == 0 && valid_h) ? lp_b[0] : kNeg;

    // lane 0 writes the warp's words of a row: one 16-byte store when the
    // warp holds the whole row of 4 words
    unsigned* my_words = sbits + slot0;
    int seg0 = 0;
    const int row_words = HALO ? n_words : R;  // one consumer warp holds the whole row
    const unsigned my_words_s = smem_addr(my_words);
    auto store_words = [&](int row, const unsigned (&w)[R]) {
      if constexpr (R == 4 && !HALO) {
        // lane 0 alone, without a branch
        asm volatile("{\n .reg .pred p;\n setp.eq.u32 p, %5, 0;\n @p st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n}\n"
                     ::"r"(my_words_s + 16 * row), "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3]), "r"(lane)
                     : "memory");
      } else if (lane == 0) {
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (slot0 + r < n_words) my_words[row * row_words + r] = w[r];
      }
    };
    {
      unsigned zero[R];
#pragma unroll
      for (int r = 0; r < R; ++r) zero[r] = 0u;
      store_words(0, zero);  // d[0] = 0
    }
    auto flush = [&](int j_end) {  // rows [seg0, j_end) to gbits; the consumers together
      copy_rows(gbits_b + (size_t)seg0 * n_words, sbits, (j_end - seg0) * n_words, tid, cons_threads);
    };

    auto step = [&](int j, float4 x, float lph) {
      const float lpv[4] = {x.x, x.y, x.z, x.w};
      float t[R];
#pragma unroll
      for (int r = 0; r < R; ++r) t[r] = __shfl_sync(kFull, q[r], (lane + 31) & 31);
      const float th = HALO ? __shfl_sync(kFull, qh, (lane + 31) & 31) : kNeg;
      unsigned w[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        // lane 0's left neighbour is lane 31 of the slot before
        const float first = r > 0 ? t[r > 0 ? r - 1 : 0] : (left_from_halo ? th : kNeg);
        const float left = lane == 0 ? first : t[r];
        w[r] = __ballot_sync(kFull, left >= q[r]);
        if (HALO || r == R - 1) w[r] &= in_range[r];  // one warp: only its last word can be ragged
        q[r] = fmaxf(left, q[r]) + lpv[r];
      }
      if (HALO) qh = fmaxf(lane == 0 ? kNeg : th, qh) + lph;  // lane 0 goes stale
      store_words(j - seg0, w);
      if (HALO && (j & (kExchange - 1)) == 0) {
        // refresh the halo with the exact values of frame j: the owner's last
        // slot, double-buffered by refresh parity
        float* buf = edge + ((j / kExchange) & 1) * cons_threads;
        buf[tid] = q[R - 1];
        consumers_sync(cons_threads);
        if (warp > 0) qh = buf[tid - 32];
      }
    };
    // chunk c of n frames: whole chunks take no test a frame
    auto chunk = [&](int c, int n, auto whole) {
      constexpr bool kWhole = decltype(whole)::value;
      const int k = c % K;
      const int j0 = 1 + c * F;
      mbar_wait(bars + 8 * k, (c / K) & 1);  // the producers filled it
      float4 x = lds4(my_frame(k, 0));
      float xh = left_from_halo ? lds1(halo_at(k, 0)) : kNeg;
#pragma unroll
      for (int u = 0; u < F; ++u) {
        if (!kWhole && u >= n) break;
        float4 nx = x;
        float nxh = xh;
        if (u + 1 < F && (kWhole || u + 1 < n)) {  // the next frame's values, loaded ahead of the chain
          nx = lds4(my_frame(k, u + 1));
          if (left_from_halo) nxh = lds1(halo_at(k, u + 1));
        }
        step(j0 + u, x, xh);
        x = nx;
        xh = nxh;
      }
      mbar_arrive(bars + 8 * (K + k));
    };

    const int n_whole = (f_end - 1) / F;
    for (int c = 0; c < n_chunks; ++c) {
      const int j0 = 1 + c * F;
      const int n = min(F, f_end - j0);  // frames of this chunk
      if (gbits_b && !in_smem && j0 + n - seg0 > smem_rows) {
        flush(j0);
        seg0 = j0;
      }
      if (c < n_whole) {
        chunk(c, F, Whole{});
      } else {
        chunk(c, n, Tail{});
      }
    }
    if (gbits_b) flush(f_end);  // bits_out, or the last stage of the scratch
  }
  __syncthreads();  // every row of bits written

  // ---- backtrace ----
  // rows [r0, f] of the bits are in shared memory, row r at (r - base) * n_words
  int a0 = max(last_tok, 0);  // warp 0's token at frame f
  int f = s;
  while (f >= 1) {
    int r0 = 1, base = 0;
    if (!in_smem) {
      r0 = max(1, f + 1 - smem_rows);
      base = r0;
      const int lo = r0 * n_words, n = (f + 1 - r0) * n_words;
      for (int k = threadIdx.x; k < n; k += blockDim.x) sbits[k] = gbits_b[lo + k];
      __syncthreads();
    }
    if (warp == 0) {
      for (int g = f; g >= r0;) {
        const int n = min(32, g - r0 + 1);
        unsigned rev = 0u;
        if (lane < n) {
          const unsigned* row = sbits + (size_t)(g - lane - base) * n_words;
          const int w = a0 >> 5;
          const unsigned hi = row[w];
          const unsigned lo = w > 0 ? row[w - 1] : 0u;
          rev = __brev(__funnelshift_rc(lo, hi, (a0 & 31) + 1));  // bit delta: token a0 - delta
          if (a0 < 32) rev &= ~(1u << a0);
        }
        unsigned m = 1u, mine = 1u;
#pragma unroll
        for (int k = 0; k < 32; ++k) {
          m += __shfl_sync(kFull, rev, k) & m;
          if (lane == k) mine = m;
        }
        if (lane < n) path_b[g - 1 - lane] = a0 - __popc(mine - 1u);
        a0 -= __popc(m - 1u);
        g -= n;
      }
    }
    f = r0 - 1;
    if (!in_smem) __syncthreads();  // the next stage overwrites what warp 0 read
  }
}

template <int R, bool HALO>
int launch(const float* lp, const int* tl, const int* fl, int* path, unsigned* gbits, int full_bits, int b,
           int t_feats, int t_text, int n_words, int smem_rows, size_t smem_bytes, int n_cons,
           cudaStream_t stream) {
  auto kernel = mas_path_kernel<R, HALO>;
  // past 48 KB of dynamic shared memory a form opts in, once a device, to
  // the 227 KB a block may have
  static unsigned long long opted_in = 0;
  int dev = 0;
  if (smem_bytes > 48 * 1024 && cudaGetDevice(&dev) == cudaSuccess && dev < 64 && !(opted_in >> dev & 1)) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (err != cudaSuccess) return (int)err;
    opted_in |= 1ull << dev;
  }
  kernel<<<b, 32 * (n_cons + kProducers), smem_bytes, stream>>>(lp, tl, fl, path, gbits, full_bits, t_feats,
                                                                t_text, n_words, smem_rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int jatts_mas_path(const void* lp, const void* text_len, const void* feats_len, void* path,
                              void* bits_out, void* scratch, int b, int t_feats, int t_text,
                              int smem_bits_bytes, void* stream) {
  if (b <= 0 || t_feats <= 0 || t_text <= 0 || t_text > 1024) return (int)cudaErrorInvalidValue;
  const int n_words = (t_text + 31) / 32;
  const size_t row_bytes = (size_t)n_words * 4;
  if (smem_bits_bytes < (int)row_bytes) return (int)cudaErrorInvalidValue;
  const bool in_smem = (size_t)t_feats * row_bytes <= (size_t)smem_bits_bytes;
  unsigned* gbits = (unsigned*)(bits_out ? bits_out : scratch);
  if (!in_smem && gbits == nullptr) return (int)cudaErrorInvalidValue;
  // a stage holds at least a chunk of frames (the forward flushes between
  // chunks), and fewer than T_feats (so the kernel reads the route from it)
  const int smem_rows = in_smem ? t_feats
                                : min(max((int)((size_t)smem_bits_bytes / row_bytes), kMinStageRows), t_feats - 1);
  // one consumer warp up to 4 slots; wider, the fewest of at most 4 slots
  const int n_warps = (n_words + kMaxSlots - 1) / kMaxSlots;
  const int r = (n_words + n_warps - 1) / n_warps;
  const size_t threads = 32 * (size_t)n_warps;
  // the mbarriers and the lp ring, with a halo the exchange, then the bits
  const size_t ring_bytes = n_warps > 1 ? 16 * Ring<true>::kChunks + Ring<true>::kChunks * Ring<true>::kFrames *
                                                                          threads * 16 + 2 * threads * 4
                                        : 16 * Ring<false>::kChunks + Ring<false>::kChunks *
                                                                          Ring<false>::kFrames * threads * 16;
  const size_t smem_bytes = ring_bytes + (size_t)smem_rows * row_bytes;
  const float* lp_f = (const float*)lp;
  const int* tl = (const int*)text_len;
  const int* fl = (const int*)feats_len;
  int* out = (int*)path;
  cudaStream_t st = (cudaStream_t)stream;
  const int full = bits_out != nullptr;
  if (n_warps == 1) {
    switch (r) {
      case 1: return launch<1, false>(lp_f, tl, fl, out, gbits, full, b, t_feats, t_text, n_words, smem_rows,
                                      smem_bytes, 1, st);
      case 2: return launch<2, false>(lp_f, tl, fl, out, gbits, full, b, t_feats, t_text, n_words, smem_rows,
                                      smem_bytes, 1, st);
      case 3: return launch<3, false>(lp_f, tl, fl, out, gbits, full, b, t_feats, t_text, n_words, smem_rows,
                                      smem_bytes, 1, st);
      default: return launch<4, false>(lp_f, tl, fl, out, gbits, full, b, t_feats, t_text, n_words, smem_rows,
                                       smem_bytes, 1, st);
    }
  }
  if (r == 3)
    return launch<3, true>(lp_f, tl, fl, out, gbits, full, b, t_feats, t_text, n_words, smem_rows, smem_bytes,
                           n_warps, st);
  return launch<4, true>(lp_f, tl, fl, out, gbits, full, b, t_feats, t_text, n_words, smem_rows, smem_bytes,
                         n_warps, st);
}
