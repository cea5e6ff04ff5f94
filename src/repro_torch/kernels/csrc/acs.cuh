// Branch metrics + add-compare-select: the register-resident recursion that
// the port's two Viterbi kernels share.
//
// CUDA counterpart of repro.kernels.acs.acs_scan (the JAX package's shared
// Pallas body) and of the plain torch acs_scan in repro_torch/kernels/acs.py.
// The unified kernel and the split path's forward kernel both include this
// header, so the two kernels run one recursion and cannot drift apart.
//
// Mapping. One warp holds a frame's S = 2^(k-1) path metrics in registers:
// state s = 32 r + l lies in lane l, register r < R = S / 32 (S >= 32).
// Codes with S < 32 give each frame a segment of P = S lanes, R = 1, and a
// warp decodes 32 / P frames side by side. With P = min(S, 32):
//   * the predecessors of s, (2 s) & (S-1) and its | 1, lie in lanes
//     (2 l) & (P-1) and (2 l + 1) & (P-1), register (2 r + (l >= 16)) mod R;
//     states r and r + R/2 share them. A stage is 2R __shfl_sync and R
//     selects, with no shared memory and no barrier;
//   * __ballot_sync of register r is packing.py's LANE word r (state s at bit
//     s % 32 of word s / 32); a segment's word is cut out of the ballot and
//     zero-padded, as packing.py pads S < 32;
//   * the stage's max is R - 1 local fmaxf and one redux.sync over the
//     segment, on an order-preserving integer image of the floats.
//
// What bounds it. A stage of a warp is R / 2 butterflies of 4 shuffles,
// beta shuffles of the stage's LLRs, R ballots, one redux and, per state,
// two candidate sums, a compare and a select; no memory is waited on and
// nothing is block-wide. The six float operations per state and stage are
// the card's bound; the stage's chain (shuffle, add, compare, max, redux,
// subtract) and the instructions that share the SM's shuffle and redux
// pipe are what it spends its time on. The resident frames that hide the
// chain are bounded by registers (autotune.py models them).
//
// Arithmetic, held bit for bit against the plain version:
//   bm_h   = sum_b signs_half[h][b] * llr[b], over b in order, in float32,
//            rounded once to bfloat16 (nearest even) when bm_dtype is bf16
//            (a constant argument of the inlined loop: the kernels inline
//            one loop per bm_dtype);
//            edge p into state j has the metric sgn_p[j] * bm[idx_p[j]].
//            Every product is +-x, exact, and rounding to nearest even is
//            odd-symmetric, so a sign may be folded in before or after the
//            sum and the rounding (a zero may change sign, which no
//            comparison sees): each edge folds its sign into its terms.
//   cand_p = sigma[((j << 1) & (S-1)) | p] + edge metric
//   sel    = cand1 >= cand0          (ties go to predecessor 1)
//   sigma' = sel ? cand1 : cand0, then minus the frame's max, every stage.
//   The first maximal state (JAX's argmax) is the least s with v[s] == max:
//   a redux.sync min over the lanes' first hits.
// Radix 4 is two exact radix-2 stages; here every stage runs the same code.
//
// Codes 12 <= k <= 15 take a second mapping, VitBlock (below): one block a
// frame, path metrics in shared memory. Every other code the plain version
// takes (k >= 16, or beta > 8 at any k) takes a third, VitWide (at the end):
// one block a frame, k and beta at run time.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

#define VIT_MAX_BETA 8
#define VIT_FULL 0xffffffffu
// Most threads one block of either kernel runs (eight warps): nothing in the
// recursion is block-wide, so a block is only a unit of scheduling.
#define VIT_BLOCK_THREADS 256
// The large-code mapping (below): codes 12 <= k <= 15, one block of 1024
// threads a frame.
#define VIT_SMEM_THREADS 1024
#define VIT_SMEM_MIN_K 12
#define VIT_SMEM_MAX_K 15

enum VitLlrDtype { VIT_F32 = 0, VIT_BF16 = 1, VIT_F16 = 2 };

// One LLR, cast to float32 as the JAX kernel casts its input block.
__device__ __forceinline__ float vit_load_llr(const void* p, int dtype,
                                              long long i) {
  if (dtype == VIT_BF16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  if (dtype == VIT_F16)
    return __half2float(static_cast<const __half*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

// Registers per lane (R) of a code with 2^(k-1) states.
__host__ __device__ inline int vit_regs_per_lane(int k) {
  const int S = 1 << (k - 1);
  return S < 32 ? 1 : S >> 5;
}
// Lanes per frame (P) and frames per warp (32 / P).
__host__ __device__ inline int vit_lanes_per_frame(int k) {
  const int S = 1 << (k - 1);
  return S < 32 ? S : 32;
}

// Most frames one block takes: VIT_BLOCK_THREADS / 32 warps of 32 / P;
// one for a large code.
__host__ __device__ inline int vit_max_frames_per_block(int k) {
  if (k >= VIT_SMEM_MIN_K) return 1;
  return VIT_BLOCK_THREADS / 32 * (32 / vit_lanes_per_frame(k));
}

// Order-preserving image of a float in a signed int (its own inverse):
// a < b as floats iff key(a) < key(b) as ints (-0 sorts below +0).
__device__ __forceinline__ int vit_key(int i) {
  return i ^ ((i >> 31) & 0x7fffffff);
}

// The lane's view of one frame: geometry, edge signs, path metrics.
template <int R, int BETA>
struct VitFrame {
  int P;              // lanes per frame
  int l;              // lane within the frame's segment (state s = P r + l)
  int segbase;        // first lane of the segment
  unsigned segmask;   // the segment's lanes
  unsigned lowmask;   // P low bits
  int src0, src1;     // lanes of the predecessors within the segment
  bool hi;            // l >= 16: predecessors in register 2r + 1
  // Each edge sums its own terms, off the stage's critical path (the
  // predecessor's metric joins in one add), by an fma chain over its
  // terms' signs held as floats: 2 R beta registers, which spill past a
  // few dozen and are still faster than sign bits negated term by term
  // at every code tools/acs_variants.py timed.
  float sg[R][2][BETA];  // sign of term b of edge p into state P r + l
  float sig[R];

  // idx (2, S), sgn (2, S), signs_half (half, beta) as the wrapper passes
  // them (kernels/tables.py).
  __device__ __forceinline__ void init(int k, const int* idx, const float* sgn,
                                       const float* signs_half) {
    const int S = 1 << (k - 1);
    const int lane = threadIdx.x & 31;
    P = vit_lanes_per_frame(k);
    l = lane & (P - 1);
    segbase = lane - l;
    lowmask = P == 32 ? VIT_FULL : (1u << P) - 1u;
    segmask = lowmask << segbase;
    src0 = (2 * l) & (P - 1);
    src1 = src0 | 1;
    hi = l >= 16;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int s = P * r + l;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int h = idx[p * S + s];
        const float e = sgn[p * S + s];
#pragma unroll
        for (int b = 0; b < BETA; ++b)
          sg[r][p][b] = e * signs_half[h * BETA + b];       // +-1
      }
      sig[r] = 0.f;
    }
  }

  // The segment's width and lanes and its cut of a ballot: compile-time for
  // R >= 2, where a frame fills the warp.
  __device__ __forceinline__ int lanes() const { return R >= 2 ? 32 : P; }
  __device__ __forceinline__ unsigned mask() const {
    return R >= 2 ? VIT_FULL : segmask;
  }
  __device__ __forceinline__ unsigned cut(unsigned ballot) const {
    return R >= 2 ? ballot : (ballot >> segbase) & lowmask;
  }

  // Signed branch metric of edge p into state r from this stage's LLRs x.
  __device__ __forceinline__ float bm(int r, int p, const float (&x)[BETA],
                                      bool bf16) const {
    float acc = __fmul_rn(sg[r][p][0], x[0]);
#pragma unroll
    for (int b = 1; b < BETA; ++b) acc = __fmaf_rn(sg[r][p][b], x[b], acc);
    if (bf16) acc = __bfloat162float(__float2bfloat16_rn(acc));
    return acc;
  }

  // One radix-2 stage: sig becomes this stage's normalised path metrics,
  // words its survivor words (LANE word r of this frame, the same in every
  // lane of the segment). Each register of sig is read by one butterfly
  // pair only and each selector is balloted at once, so a lane holds about
  // R path metrics, R sign words and R survivor words at a time.
  __device__ __forceinline__ void step(const float (&x)[BETA], bool bf16,
                                       unsigned (&words)[R]) {
    float v[R];
    auto acs = [&](int r, float p0, float p1) {
      const float c0 = __fadd_rn(p0, bm(r, 0, x, bf16));
      const float c1 = __fadd_rn(p1, bm(r, 1, x, bf16));
      const bool sel = c1 >= c0;
      v[r] = sel ? c1 : c0;
      words[r] = cut(__ballot_sync(VIT_FULL, sel));
    };
    if constexpr (R == 1) {
      acs(0, __shfl_sync(VIT_FULL, sig[0], src0, P),
          __shfl_sync(VIT_FULL, sig[0], src1, P));
    } else {
#pragma unroll
      for (int q = 0; q < R / 2; ++q) {
        const float a0 = __shfl_sync(VIT_FULL, sig[2 * q], src0);
        const float a1 = __shfl_sync(VIT_FULL, sig[2 * q + 1], src0);
        const float b0 = __shfl_sync(VIT_FULL, sig[2 * q], src1);
        const float b1 = __shfl_sync(VIT_FULL, sig[2 * q + 1], src1);
        const float p0 = hi ? a1 : a0;
        const float p1 = hi ? b1 : b0;
        acs(q, p0, p1);
        acs(q + R / 2, p0, p1);
      }
    }
    float m = v[0];
#pragma unroll
    for (int r = 1; r < R; ++r) m = fmaxf(m, v[r]);
    m = __int_as_float(
        vit_key(__reduce_max_sync(mask(), vit_key(__float_as_int(m)))));
#pragma unroll
    for (int r = 0; r < R; ++r) sig[r] = __fsub_rn(v[r], m);   // normalise
  }

  // The first maximal state of the stage step() just ran: after the
  // normalisation sig is exactly 0 there and negative elsewhere (v - max
  // is 0 only for v == max; no flush to zero). Each lane's first hit, then
  // one redux.sync min over the segment.
  __device__ __forceinline__ int first_max() const {
    int a = 0x7fffffff;
#pragma unroll
    for (int r = R - 1; r >= 0; --r)
      if (sig[r] == 0.f) a = lanes() * r + l;
    return __reduce_min_sync(mask(), a);
  }
};

// The LLRs of one chunk of P stages: lane l of the segment loads stage
// c0 + l (zeros past L and for an invalid frame). Stage c0 + u is then
// __shfl_sync(x, u, P) in every lane of the segment.
template <int BETA>
__device__ __forceinline__ void vit_load_chunk(const void* llr, int dtype,
                                               long long frame_base, int c0,
                                               int l, int L, bool fvalid,
                                               float (&out)[BETA]) {
  const int t = c0 + l;
  const bool ok = fvalid && t < L;
#pragma unroll
  for (int b = 0; b < BETA; ++b)
    out[b] = ok ? vit_load_llr(llr, dtype,
                               frame_base + (long long)t * BETA + b)
                : 0.f;
}

// Shared-memory stores and loads at a 32-bit shared address
// (__cvta_generic_to_shared): the survivors and run buffers sit in shared
// memory in one mode and device memory in another, and an explicit
// st.shared keeps the stage loop's store off the generic path. The stores
// are predicated (one lane of a segment stores what the segment holds),
// so the stage loop has no divergent branch.
__device__ __forceinline__ void vit_sts_u8(uint32_t a, unsigned v) {
  asm volatile("st.shared.u8 [%0], %1;" ::"r"(a), "r"(v) : "memory");
}
__device__ __forceinline__ void vit_sts_u32_if(bool p, uint32_t a,
                                               unsigned v) {
  asm volatile(
      "{ .reg .pred q; setp.ne.u32 q, %0, 0; @q st.shared.u32 [%1], %2; }"
      ::"r"((unsigned)p), "r"(a), "r"(v) : "memory");
}
__device__ __forceinline__ unsigned vit_lds_u32(uint32_t a) {
  unsigned v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(a) : "memory");
  return v;
}
template <int R>
__device__ __forceinline__ void vit_sts_words_if(bool p, uint32_t a,
                                                 const unsigned (&w)[R]) {
  if constexpr (R == 1) {
    vit_sts_u32_if(p, a, w[0]);
  } else if constexpr (R == 2) {
    asm volatile(
        "{ .reg .pred q; setp.ne.u32 q, %0, 0;"
        " @q st.shared.v2.u32 [%1], {%2, %3}; }"
        ::"r"((unsigned)p), "r"(a), "r"(w[0]), "r"(w[1]) : "memory");
  } else {
#pragma unroll
    for (int i = 0; i < R / 4; ++i)
      asm volatile(
          "{ .reg .pred q; setp.ne.u32 q, %0, 0;"
          " @q st.shared.v4.u32 [%1], {%2, %3, %4, %5}; }"
          ::"r"((unsigned)p), "r"(a + 16 * i), "r"(w[4 * i]),
          "r"(w[4 * i + 1]), "r"(w[4 * i + 2]), "r"(w[4 * i + 3])
          : "memory");
  }
}

// One stage's R survivor words to dst (R 32-bit words, aligned to 4 R
// bytes up to 16): vector stores of up to four words.
template <int R>
__device__ __forceinline__ void vit_store_words(uint32_t* dst,
                                                const unsigned (&w)[R]) {
  if constexpr (R == 1) {
    dst[0] = w[0];
  } else if constexpr (R == 2) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  } else {
#pragma unroll
    for (int i = 0; i < R / 4; ++i)
      reinterpret_cast<uint4*>(dst)[i] =
          make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
  }
}

// The stages of one run: RUN = P / R stages, whose R words each fill the
// P lanes of a segment once (word i % R of stage i / R in slot i).
// Runs the recursion over all L stages of a frame and calls, per stage,
// st.stage(t, u, words) (u: the stage within its run) and, after each run,
// st.run_end(t0, n) (n stages from t0). The LLR chunk of P stages is
// loaded one chunk ahead.
template <int R, int BETA, class Store>
__device__ __forceinline__ void vit_recursion(VitFrame<R, BETA>& fr,
                                              const void* llr, int dtype,
                                              bool bf16,
                                              long long frame_base, int L,
                                              bool fvalid, Store& st) {
  const int P = fr.lanes();
  const int run = R >= 2 ? 32 / R : P;
  float cur[BETA], nxt[BETA], x[BETA];
  unsigned words[R];
  vit_load_chunk<BETA>(llr, dtype, frame_base, 0, fr.l, L, fvalid, nxt);
  auto stage = [&](int t, int u, int xl) {
#pragma unroll
    for (int b = 0; b < BETA; ++b) x[b] = __shfl_sync(VIT_FULL, cur[b], xl, P);
    fr.step(x, bf16, words);
    st.stage(t, u, words);
  };
  for (int c0 = 0; c0 < L; c0 += P) {
#pragma unroll
    for (int b = 0; b < BETA; ++b) cur[b] = nxt[b];
    vit_load_chunk<BETA>(llr, dtype, frame_base, c0 + P, fr.l, L, fvalid,
                         nxt);
    for (int q = 0; q < R; ++q) {
      const int t0 = c0 + q * run;
      if (t0 >= L) break;
      const int n = min(run, L - t0);
      if (n == run) {
        if constexpr (R >= 2) {
#pragma unroll
          for (int u = 0; u < 32 / R; ++u) stage(t0 + u, u, q * run + u);
        } else {
#pragma unroll 4
          for (int u = 0; u < run; ++u) stage(t0 + u, u, u);
        }
      } else {
#pragma unroll 1
        for (int u = 0; u < n; ++u) stage(t0 + u, u, q * run + u);
      }
      st.run_end(t0, n);
    }
  }
}

// Calls F::template run<R, BETA>(a...) for the instantiation that serves
// (k, beta): one per registers-per-lane R in {1, 2, 4, ..., 32} (k <= 11)
// and per code rate 1/beta, beta in 2..8.
template <class F, int R, class... A>
int vit_dispatch_beta(int beta, A... a) {
  switch (beta) {
    case 2: return F::template run<R, 2>(a...);
    case 3: return F::template run<R, 3>(a...);
    case 4: return F::template run<R, 4>(a...);
    case 5: return F::template run<R, 5>(a...);
    case 6: return F::template run<R, 6>(a...);
    case 7: return F::template run<R, 7>(a...);
    default: return F::template run<R, 8>(a...);
  }
}

template <class F, class... A>
int vit_dispatch(int k, int beta, A... a) {
  switch (vit_regs_per_lane(k)) {
    case 1: return vit_dispatch_beta<F, 1>(beta, a...);
    case 2: return vit_dispatch_beta<F, 2>(beta, a...);
    case 4: return vit_dispatch_beta<F, 4>(beta, a...);
    case 8: return vit_dispatch_beta<F, 8>(beta, a...);
    case 16: return vit_dispatch_beta<F, 16>(beta, a...);
    default: return vit_dispatch_beta<F, 32>(beta, a...);
  }
}

// ---------------------------------------------------------------------------
// Large codes (12 <= k <= 15): path metrics in shared memory.
//
// At k = 11 a lane already holds R = 32 path metrics; past it the register
// mapping runs out of registers. Codes with 2^11 <= S <= 2^14 states take
// a mapping of their own, which the two kernels instantiate beside (not
// inside) the register one, so the k <= 11 instantiations do not change:
//   * one block of VIT_SMEM_THREADS = 1024 threads per frame, R = S / 1024
//     states a thread (R = 2, 4, 8, 16 at k = 12..15): thread t holds
//     states s = t + 1024 r. __ballot_sync of register r in warp w is then
//     packing.py's LANE word 32 r + w, so survivors pack as before;
//   * the path metrics live in two shared buffers of S float32 (16 KB at
//     k = 12, 128 KB at k = 15): stage t reads the predecessors 2s and
//     2s + 1 of the butterfly (s, s + S/2) from the old buffer as one
//     float2 and writes the new one; one __syncthreads per stage;
//   * the buffer holds each stage's path metrics before the normalisation;
//     the reader subtracts the stage's max (sigma = v - max, the same
//     __fsub_rn as the register path, taken when it is read);
//   * the stage max: fmaxf per thread, redux.sync per warp on vit_key's
//     integer image, then the 32 warp maxima through shared memory, read
//     after the stage's barrier by every warp and reduced once more;
//   * the first maximal state: each thread keeps the first of its states
//     that reached its own max, for the low half (r < R/2) and the high
//     half of its states apart, so the least state is known without a
//     second pass; a redux.sync min per warp and, after the next stage's
//     barrier, the min over the warps (the argmax of stage t is known
//     during stage t + 1);
//   * branch metrics: 2^(beta-1) threads compute the compressed table
//     bm_half[h] of stage t + 1 during stage t, into a second table
//     (the stage's barrier publishes it); an edge reads bm_half[idx] and
//     flips its sign bit for sgn = -1. Each state keeps its two edges'
//     (idx, sgn) as two bytes: R / 2 registers a thread, not the 2 R beta
//     sign registers of the register path, which would spill here.
// The arithmetic is the register path's: bm_half[h] = sum_b
// signs_half[h][b] * x[b] in b order (the first product, then one
// rounded add per term: fma(+-1, x, acc) is that add), bf16 rounded once;
// folding the edge's sign in after the sum and the rounding gives the same
// value (both are odd-symmetric); ties >= to predecessor 1; normalise
// every stage; the least maximal state.
#define VIT_MAX_HALF 128

// Bytes of the mapping's own shared memory: two path-metric buffers, two
// branch-metric tables and the warp partials (maxima and first maxima of
// two stages).
__host__ __device__ inline long long vit_smem_core_bytes(int k) {
  return 8LL * (1LL << (k - 1)) + 8 * VIT_MAX_HALF + 4 * 4 * 32;
}

// One compressed branch metric of the stage whose LLRs are x: terms in b
// order, signs_half[h][b] = 1 - 2 * bit (beta - 1 - b) of h (tables.py).
template <int BETA>
__device__ __forceinline__ float vit_bm_half(int h, const float (&x)[BETA],
                                             bool bf16) {
  float acc = __int_as_float(__float_as_int(x[0]) ^
                             (((h >> (BETA - 1)) & 1) << 31));
#pragma unroll
  for (int b = 1; b < BETA; ++b)
    acc = __fadd_rn(acc, __int_as_float(__float_as_int(x[b]) ^
                                        (((h >> (BETA - 1 - b)) & 1) << 31)));
  if (bf16) acc = __bfloat162float(__float2bfloat16_rn(acc));
  return acc;
}

// One frame on one block. Shared memory at `sm` (16-byte aligned):
// pm [2][S] float, tbl [2][VIT_MAX_HALF] float, red [4][32] int.
template <int R, int BETA>
struct VitBlock {
  static constexpr int T = VIT_SMEM_THREADS;
  unsigned code[R / 2];  // bytes (idx | sign << 7) of edges p of states r
                         // and r + R/2, byte 2 h + p of word r
  int S, half;
  float* pm;
  float* tbl;
  int* red;

  __device__ __forceinline__ void init(int k, const int* idx,
                                       const float* sgn, unsigned char* sm) {
    S = 1 << (k - 1);
    half = 1 << (BETA - 1);
    pm = reinterpret_cast<float*>(sm);
    tbl = pm + 2 * S;
    red = reinterpret_cast<int*>(tbl + 2 * VIT_MAX_HALF);
    const int tid = threadIdx.x;
#pragma unroll
    for (int q = 0; q < R / 2; ++q) {
      unsigned c = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int s = tid + T * (q + h * (R / 2));
          const unsigned e = (unsigned)idx[p * S + s] |
                             (sgn[p * S + s] < 0.f ? 0x80u : 0u);
          c |= e << (16 * h + 8 * p);
        }
      code[q] = c;
    }
  }

  __device__ __forceinline__ float edge(const float* tb, unsigned e) const {
    return __int_as_float(__float_as_int(tb[e & 0x7f]) ^ ((e & 0x80u) << 24));
  }
};

// The recursion of one frame over L stages on the block. Calls, per state,
// st.state(t, r, s, sel, word) (word: the warp's ballot of register r; s =
// threadIdx.x + 1024 r) and, for each stage t with st.wants_argmax(t)
// (block-uniform), st.argmax(t, a) in warp 0 once a, the stage's first
// maximal state, is known (during stage t + 1, or after the loop).
template <int R, int BETA, class Store>
__device__ __forceinline__ void vit_block_recursion(VitBlock<R, BETA>& b,
                                                    const void* llr,
                                                    int dtype, bool bf16,
                                                    long long frame_base,
                                                    int L, Store& st) {
  constexpr int T = VIT_SMEM_THREADS;
  const int S = b.S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int s = tid; s < S; s += T) b.pm[S + s] = 0.f;    // stage -1: zeros
  const bool tw = warp * 32 < b.half;      // warps that build the tables
  float cur[BETA], nxt[BETA], x[BETA];
  if (tw) {
    vit_load_chunk<BETA>(llr, dtype, frame_base, 0, lane, L, true, cur);
    vit_load_chunk<BETA>(llr, dtype, frame_base, 32, lane, L, true, nxt);
#pragma unroll
    for (int i = 0; i < BETA; ++i) x[i] = __shfl_sync(VIT_FULL, cur[i], 0);
    if (tid < b.half) b.tbl[tid] = vit_bm_half<BETA>(tid, x, bf16);
  }
  __syncthreads();
  float m = 0.f;              // the previous stage's max
  int pend = -1;              // stage whose first maximum is pending
  int c0 = 0;                 // first stage of the chunk in cur
  for (int t = 0; t < L; ++t) {
    const float2* old = reinterpret_cast<const float2*>(
        b.pm + ((t + 1) & 1) * S);
    float* nw = b.pm + (t & 1) * S;
    const float* tb = b.tbl + (t & 1) * VIT_MAX_HALF;
    float mlo = -INFINITY, mhi = -INFINITY;
    int rlo = 0, rhi = 0;
#pragma unroll
    for (int q = 0; q < R / 2; ++q) {
      const int s = tid + T * q;
      const float2 pp = old[s];              // v of 2s and 2s + 1
      const float p0 = __fsub_rn(pp.x, m);
      const float p1 = __fsub_rn(pp.y, m);
      const unsigned c = b.code[q];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = q + h * (R / 2);
        const float c0v = __fadd_rn(p0, b.edge(tb, c >> (16 * h)));
        const float c1v = __fadd_rn(p1, b.edge(tb, c >> (16 * h + 8)));
        const bool sel = c1v >= c0v;
        const float v = sel ? c1v : c0v;
        nw[s + h * (S / 2)] = v;
        st.state(t, r, s + h * (S / 2), sel, __ballot_sync(VIT_FULL, sel));
        if (h == 0) {
          if (v > mlo) { mlo = v; rlo = r; }
        } else {
          if (v > mhi) { mhi = v; rhi = r; }
        }
      }
    }
    const int key = __reduce_max_sync(
        VIT_FULL, vit_key(__float_as_int(fmaxf(mlo, mhi))));
    if (lane == 0) b.red[(t & 1) * 32 + warp] = key;
    if (tw) {                                 // the next stage's table
      const int u = t - c0;
#pragma unroll
      for (int i = 0; i < BETA; ++i)
        x[i] = __shfl_sync(VIT_FULL, u < 31 ? cur[i] : nxt[i], (u + 1) & 31);
      if (tid < b.half)
        b.tbl[((t + 1) & 1) * VIT_MAX_HALF + tid] =
            vit_bm_half<BETA>(tid, x, bf16);
      if (u == 31) {
#pragma unroll
        for (int i = 0; i < BETA; ++i) cur[i] = nxt[i];
        c0 += 32;
        vit_load_chunk<BETA>(llr, dtype, frame_base, c0 + 32, lane, L, true,
                             nxt);
      }
    }
    __syncthreads();
    if (pend >= 0 && warp == 0) {
      const int a = __reduce_min_sync(
          VIT_FULL, b.red[64 + (pend & 1) * 32 + lane]);
      st.argmax(pend, a);
    }
    pend = -1;
    m = __int_as_float(vit_key(
        __reduce_max_sync(VIT_FULL, b.red[(t & 1) * 32 + lane])));
    if (st.wants_argmax(t)) {
      int a = 0x7fffffff;
      if (mhi == m) a = tid + T * rhi;
      if (mlo == m) a = tid + T * rlo;        // low states come first
      a = __reduce_min_sync(VIT_FULL, a);
      if (lane == 0) b.red[64 + (t & 1) * 32 + warp] = a;
      pend = t;
    }
  }
  __syncthreads();
  if (pend >= 0 && warp == 0) {
    const int a = __reduce_min_sync(VIT_FULL,
                                    b.red[64 + (pend & 1) * 32 + lane]);
    st.argmax(pend, a);
  }
}

// Calls F::template run_smem<R, BETA>(a...) for the large-code
// instantiation that serves (k, beta): R = 2^(k-1) / 1024, one per k.
template <class F, int R, class... A>
int vit_dispatch_smem_beta(int beta, A... a) {
  switch (beta) {
    case 2: return F::template run_smem<R, 2>(a...);
    case 3: return F::template run_smem<R, 3>(a...);
    case 4: return F::template run_smem<R, 4>(a...);
    case 5: return F::template run_smem<R, 5>(a...);
    case 6: return F::template run_smem<R, 6>(a...);
    case 7: return F::template run_smem<R, 7>(a...);
    default: return F::template run_smem<R, 8>(a...);
  }
}

template <class F, class... A>
int vit_dispatch_smem(int k, int beta, A... a) {
  switch (k) {
    case 12: return vit_dispatch_smem_beta<F, 2>(beta, a...);
    case 13: return vit_dispatch_smem_beta<F, 4>(beta, a...);
    case 14: return vit_dispatch_smem_beta<F, 8>(beta, a...);
    default: return vit_dispatch_smem_beta<F, 16>(beta, a...);
  }
}

// ---------------------------------------------------------------------------
// Every other code (k >= 16, or beta > 8 at any k): the wide mapping.
//
// Past k = 15 two buffers of S float32 path metrics outgrow a block's shared
// memory (256 KB at k = 16, over the 227 KB a block can have), and past
// beta = 8 VitBlock's compressed table of 2^(beta-1) entries outgrows the
// 7-bit index of its edge bytes (and the register path's 2 R beta sign
// registers). Those codes take a third mapping, instantiated once in each
// kernel beside the other two (so their instantiations do not change), which
// takes k and beta at run time: per-(k, beta) templates would multiply the
// build for codes that are rare.
//   * one block a frame, T = clamp(S/2, 32, 1024) threads (vit_wide_threads);
//     thread t runs the butterflies q = t + T i, i < max(1, S/2 / T), each the
//     states q and q + S/2 with the predecessors 2q and 2q + 1. A block
//     takes frames blockIdx.x, + gridDim.x, ...: the wrapper sizes the grid
//     to the blocks that are resident at once, so the device-memory scratch
//     is per block, not per frame;
//   * path metrics: two buffers of S float32, in the block's shared memory
//     for k <= VIT_WIDE_SMEM_MAX_K and in its device-memory scratch past it,
//     both read and written through one generic pointer. Stage t reads the
//     old buffer (the predecessors 2q, 2q + 1 as one float2) and writes the
//     new one; the stage's __syncthreads makes the writes visible to the
//     block in either memory. As in VitBlock the buffer holds the stage's
//     metrics before the normalisation and the reader subtracts the max;
//   * branch metrics: each edge sums its own terms. Term b of the edge with
//     encoder word w is x[b] with its sign bit flipped by parity(w & g_b)
//     (g_b: generator polynomial b); in b order, the first term and then
//     one rounded add per term, rounded once to bf16 for bm_dtype bf16. By
//     the identity at the head of this file that is the compressed table's
//     sgn * bm_half[idx] of the other mappings and of the plain version.
//     The four edges of a butterfly share the word 2q: predecessor 2q + 1
//     adds the bottom tap, the high state the top tap (bit k-1) of each g_b;
//   * the stage's LLRs: thread b < beta loads term b two stages ahead into a
//     register and stores it to a two-stage buffer in shared memory one
//     stage ahead, so the stage's barrier publishes it;
//   * the stage max, the first maximal state (least state; the low half of
//     the states before the high half) and ties, as VitBlock: a redux per
//     warp, the warps' partials through shared memory after the barrier.
// What bounds it: the same six float operations a state and stage as the
// other mappings, with beta adds per edge for the branch metrics; past
// k = 15 each stage also moves 2 x 4 S bytes of path metrics through the L2
// cache (a block's 256 KB at k = 16 stay in the 50 MB L2 for 132 blocks).
#define VIT_WIDE_MAX_THREADS 1024
// Most beta the mapping takes (a warp loads a stage's terms; the plain
// version's 2^beta-entry tables end far below).
#define VIT_WIDE_MAX_BETA 32
// Largest k whose path metrics the mapping keeps in shared memory (two
// buffers of 2^14 float32, 128 KB); past it they go to device memory.
#define VIT_WIDE_SMEM_MAX_K 15
// Largest k: a state is an int (S = 2^30 states at k = 31).
#define VIT_WIDE_MAX_K 31
// The fixed part of the mapping's shared memory: warp partials [4][32] int,
// the LLR buffer [2][VIT_WIDE_MAX_BETA] float, the polynomials
// [VIT_WIDE_MAX_BETA] int; then the path metrics [2][S] float if on chip.
#define VIT_WIDE_CORE_BYTES (4 * 4 * 32 + 2 * 4 * VIT_WIDE_MAX_BETA + \
                             4 * VIT_WIDE_MAX_BETA)

// Whether (k, beta) is outside the two fast mappings' domain.
__host__ __device__ inline bool vit_wide_code(int k, int beta) {
  return k > VIT_SMEM_MAX_K || beta > VIT_MAX_BETA;
}

// Threads of one wide-mapping block: one a butterfly, at least a warp and
// at most VIT_WIDE_MAX_THREADS.
__host__ __device__ inline int vit_wide_threads(int k) {
  const long long h = 1LL << (k - 2);
  return h < 32 ? 32 : (h > VIT_WIDE_MAX_THREADS ? VIT_WIDE_MAX_THREADS
                                                 : (int)h);
}

// Whether the mapping keeps the path metrics of a k code in shared memory.
__host__ __device__ inline bool vit_wide_pm_on_chip(int k) {
  return k <= VIT_WIDE_SMEM_MAX_K;
}

// Dynamic shared memory of one wide-mapping block.
__host__ __device__ inline long long vit_wide_smem_bytes(int k) {
  return VIT_WIDE_CORE_BYTES +
         (vit_wide_pm_on_chip(k) ? 8LL * (1LL << (k - 1)) : 0);
}

// One frame on one block. Shared memory at `sm` (16-byte aligned), laid
// out as VIT_WIDE_CORE_BYTES says; the path metrics at `pm_global` (the
// block's [2][S] float in device memory) or after the core.
struct VitWide {
  int k, beta, S, H, T, nit;
  float* pm;
  int* red;
  float* sx;
  unsigned* g;

  __device__ __forceinline__ void init(int k_, int beta_, const int* polys,
                                       unsigned char* sm, float* pm_global) {
    k = k_;
    beta = beta_;
    S = 1 << (k - 1);
    H = S >> 1;
    T = blockDim.x;
    nit = H > T ? H / T : 1;
    red = reinterpret_cast<int*>(sm);
    sx = reinterpret_cast<float*>(sm + 4 * 4 * 32);
    g = reinterpret_cast<unsigned*>(sx + 2 * VIT_WIDE_MAX_BETA);
    pm = pm_global != nullptr
             ? pm_global
             : reinterpret_cast<float*>(sm + VIT_WIDE_CORE_BYTES);
    const int tid = threadIdx.x;
    if (tid < beta) g[tid] = (unsigned)polys[tid];
  }

  // The branch metrics of butterfly q from the stage's LLRs x: e[h][p] is
  // edge p (from 2q + p) into state q + h S/2.
  __device__ __forceinline__ void bm(int q, const float* x, bool bf16,
                                     float (&e)[2][2]) const {
    const unsigned base = 2u * (unsigned)q;
    const int top = k - 1;
    for (int b = 0; b < beta; ++b) {
      const unsigned gb = g[b];
      const unsigned s = (unsigned)__popc(base & gb) & 1u;
      const unsigned bot = gb & 1u, tp = (gb >> top) & 1u;
      const int xi = __float_as_int(x[b]);
      const float t00 = __int_as_float(xi ^ (int)(s << 31));
      const float t01 = __int_as_float(xi ^ (int)((s ^ bot) << 31));
      const float t10 = __int_as_float(xi ^ (int)((s ^ tp) << 31));
      const float t11 = __int_as_float(xi ^ (int)((s ^ bot ^ tp) << 31));
      if (b == 0) {
        e[0][0] = t00;
        e[0][1] = t01;
        e[1][0] = t10;
        e[1][1] = t11;
      } else {
        e[0][0] = __fadd_rn(e[0][0], t00);
        e[0][1] = __fadd_rn(e[0][1], t01);
        e[1][0] = __fadd_rn(e[1][0], t10);
        e[1][1] = __fadd_rn(e[1][1], t11);
      }
    }
    if (bf16) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int p = 0; p < 2; ++p)
          e[h][p] = __bfloat162float(__float2bfloat16_rn(e[h][p]));
    }
  }
};

// The recursion of one frame over L stages on the block. Calls, per
// butterfly and stage, st.butterfly(t, q, valid, sel_lo, sel_hi, b_lo,
// b_hi) in every thread (b_lo / b_hi: the warp's ballots of the low and
// high states' selectors; lanes past S/2 are not valid and ballot 0) and,
// for each stage t with st.wants_argmax(t) (block-uniform), st.argmax(t, a)
// in warp 0 once a, the stage's first maximal state, is known (during
// stage t + 1, or after the loop). Ends with a __syncthreads.
template <class Store>
__device__ __forceinline__ void vit_wide_recursion(VitWide& w,
                                                   const void* llr,
                                                   int dtype, bool bf16,
                                                   long long frame_base,
                                                   int L, Store& st) {
  const int S = w.S, H = w.H, T = w.T, beta = w.beta;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = T >> 5;
  for (int s = tid; s < S; s += T) w.pm[S + s] = 0.f;    // stage -1: zeros
  const bool ld = tid < beta;
  float pf = 0.f;                       // term tid of stage t + 1
  if (ld) {
    w.sx[tid] = vit_load_llr(llr, dtype, frame_base + tid);
    if (L > 1) pf = vit_load_llr(llr, dtype, frame_base + beta + tid);
  }
  __syncthreads();
  float m = 0.f;              // the previous stage's max
  int pend = -1;              // stage whose first maximum is pending
  for (int t = 0; t < L; ++t) {
    if (ld) {
      w.sx[((t + 1) & 1) * VIT_WIDE_MAX_BETA + tid] = pf;
      if (t + 2 < L)
        pf = vit_load_llr(llr, dtype,
                          frame_base + (long long)(t + 2) * beta + tid);
    }
    const float* x = w.sx + (t & 1) * VIT_WIDE_MAX_BETA;
    const float2* old = reinterpret_cast<const float2*>(
        w.pm + ((t + 1) & 1) * S);
    float* nwb = w.pm + (t & 1) * S;
    float mlo = -INFINITY, mhi = -INFINITY;
    int slo = 0, shi = 0;
    int q = tid;
    for (int i = 0; i < w.nit; ++i, q += T) {
      const bool valid = q < H;
      bool sl = false, sh = false;
      if (valid) {
        const float2 pp = old[q];              // v of 2q and 2q + 1
        const float p0 = __fsub_rn(pp.x, m);
        const float p1 = __fsub_rn(pp.y, m);
        float e[2][2];
        w.bm(q, x, bf16, e);
        const float l0 = __fadd_rn(p0, e[0][0]);
        const float l1 = __fadd_rn(p1, e[0][1]);
        const float h0 = __fadd_rn(p0, e[1][0]);
        const float h1 = __fadd_rn(p1, e[1][1]);
        sl = l1 >= l0;
        sh = h1 >= h0;
        const float vl = sl ? l1 : l0;
        const float vh = sh ? h1 : h0;
        nwb[q] = vl;
        nwb[q + H] = vh;
        if (vl > mlo) { mlo = vl; slo = q; }
        if (vh > mhi) { mhi = vh; shi = q + H; }
      }
      st.butterfly(t, q, valid, sl, sh, __ballot_sync(VIT_FULL, sl),
                   __ballot_sync(VIT_FULL, sh));
    }
    const int key = __reduce_max_sync(
        VIT_FULL, vit_key(__float_as_int(fmaxf(mlo, mhi))));
    if (lane == 0) w.red[(t & 1) * 32 + warp] = key;
    __syncthreads();
    if (pend >= 0 && warp == 0) {
      const int a = __reduce_min_sync(
          VIT_FULL, lane < nw ? w.red[64 + (pend & 1) * 32 + lane]
                              : 0x7fffffff);
      st.argmax(pend, a);
    }
    pend = -1;
    m = __int_as_float(vit_key(__reduce_max_sync(
        VIT_FULL, lane < nw ? w.red[(t & 1) * 32 + lane]
                            : (int)0x80000000)));
    if (st.wants_argmax(t)) {
      int a = 0x7fffffff;
      if (mhi == m) a = shi;
      if (mlo == m) a = slo;                  // low states come first
      a = __reduce_min_sync(VIT_FULL, a);
      if (lane == 0) w.red[64 + (t & 1) * 32 + warp] = a;
      pend = t;
    }
  }
  __syncthreads();
  if (pend >= 0 && warp == 0) {
    const int a = __reduce_min_sync(
        VIT_FULL, lane < nw ? w.red[64 + (pend & 1) * 32 + lane]
                            : 0x7fffffff);
    st.argmax(pend, a);
  }
  __syncthreads();
}

// The survivor words of one butterfly step, as packing.py's LANE words:
// with S/2 >= 32 a warp's ballots are whole words (its lanes run 32
// neighbouring butterflies q0 = q of lane 0, a multiple of 32): word q0 / 32
// (low states) and (q0 + S/2) / 32 (high states); with S <= 32 the one word
// of the stage is the low ballot with the high one above it.
struct VitWideWords {
  int n;                 // words this warp holds: 1 or 2
  int i0, i1;            // their indices
  unsigned w0, w1;
  __device__ __forceinline__ VitWideWords(int H, int q, unsigned blo,
                                          unsigned bhi) {
    if (H >= 32) {
      const int q0 = q & ~31;
      n = 2;
      i0 = q0 >> 5;
      i1 = (q0 + H) >> 5;
      w0 = blo;
      w1 = bhi;
    } else {
      n = 1;
      i0 = i1 = 0;
      w0 = w1 = blo | (bhi << H);
    }
  }
};

// numRegs, localSizeBytes (spills) and maxThreadsPerBlock of one kernel
// instantiation, for the tile planner (kernels/autotune.py).
__host__ inline int vit_func_attrs(const void* fn, int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = a.maxThreadsPerBlock;
  return 0;
}
