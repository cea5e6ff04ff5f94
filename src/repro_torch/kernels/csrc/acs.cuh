// Branch metrics + add-compare-select: the register-resident recursion that
// the port's two Viterbi kernels share.
//
// CUDA counterpart of repro.kernels.acs.acs_scan (the JAX package's shared
// Pallas body) and of the plain torch acs_scan in repro_torch/kernels/acs.py.
// The unified kernel and the split path's forward kernel both include this
// header and run its recursions, with one exception: at 3 <= k <= 7 and
// beta <= 3 the unified kernel runs its own thread mapping (one thread a
// frame, viterbi_unified.cu's VitThread) in launches that fill the card,
// so at K=7 the two kernels no longer share a recursion there; the
// forward kernel keeps VitFrame. Both are held bit for bit to the plain
// version.
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
// Codes past beta = 8 (rates below 1/8) take the same mapping with beta at
// run time (VitFrame<R, 0>, one instantiation per R): each butterfly's
// encoder word in a register instead of 2 R beta sign registers, the
// stage's LLRs staged a chunk at a time in the warp's shared memory and
// read as broadcasts (vit_recursion_rt).
//
// Every code the plain version takes past the register mapping's k <= 11
// takes one of two more mappings. VitCluster (at the end): one thread-block
// cluster of C = 2^(k-15) blocks a frame at 16 <= k <= 19, the path metrics
// in the cluster's shared memory, exchanged through distributed shared
// memory; and its one-block form (C = 1, a compile-time case) at
// 12 <= k <= 15, the path metrics in the block's shared memory (a
// butterfly table a stage at beta <= 8, per-edge sums of each butterfly's
// encoder word past it). VitWide (below): one block a frame, k and beta at
// run time, for k >= 20 and for k = 16-19 where the card holds no cluster.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

// The largest beta the register mapping instantiates per beta and the
// one-block and cluster forms tabulate (2^beta entries a stage); past it
// they take beta at run time.
#define VIT_MAX_BETA 8
#define VIT_FULL 0xffffffffu
// Most threads one block of either kernel runs (eight warps): nothing in the
// recursion is block-wide, so a block is only a unit of scheduling.
#define VIT_BLOCK_THREADS 256
// The large codes: 12 <= k <= 15 run VitCluster's one-block form, one
// block a frame.
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

// The lane's view of one frame: geometry and path metrics, and the stage
// step from each edge's branch metric (both forms of VitFrame below).
template <int R>
struct VitLanes {
  int P;              // lanes per frame
  int l;              // lane within the frame's segment (state s = P r + l)
  int segbase;        // first lane of the segment
  unsigned segmask;   // the segment's lanes
  unsigned lowmask;   // P low bits
  int src0, src1;     // lanes of the predecessors within the segment
  bool hi;            // l >= 16: predecessors in register 2r + 1
  float sig[R];

  __device__ __forceinline__ void init_lanes(int k) {
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
    for (int r = 0; r < R; ++r) sig[r] = 0.f;
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

  // One radix-2 stage, bm(r, p) the metric of edge p into state P r + l:
  // sig becomes this stage's normalised path metrics, words its survivor
  // words (LANE word r of this frame, the same in every lane of the
  // segment). Each register of sig is read by one butterfly pair only and
  // each selector is balloted at once, so a lane holds about R path
  // metrics and R survivor words at a time.
  template <class BM>
  __device__ __forceinline__ void acs_step(const BM& bm,
                                           unsigned (&words)[R]) {
    float v[R];
    auto acs = [&](int r, float p0, float p1) {
      const float c0 = __fadd_rn(p0, bm(r, 0));
      const float c1 = __fadd_rn(p1, bm(r, 1));
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

  // The first maximal state of the stage the last step ran: after the
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

// The register mapping at a compile-time beta <= VIT_MAX_BETA: edge signs in
// registers.
template <int R, int BETA>
struct VitFrame : VitLanes<R> {
  // Each edge sums its own terms, off the stage's critical path (the
  // predecessor's metric joins in one add), by an fma chain over its
  // terms' signs held as floats: 2 R beta registers, which spill past a
  // few dozen and are still faster than sign bits negated term by term
  // at every code tools/acs_variants.py timed.
  float sg[R][2][BETA];  // sign of term b of edge p into state P r + l

  // idx (2, S), sgn (2, S), signs_half (half, beta) as the wrapper passes
  // them (kernels/tables.py).
  __device__ __forceinline__ void init(int k, const int* idx, const float* sgn,
                                       const float* signs_half) {
    const int S = 1 << (k - 1);
    this->init_lanes(k);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int s = this->P * r + this->l;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int h = idx[p * S + s];
        const float e = sgn[p * S + s];
#pragma unroll
        for (int b = 0; b < BETA; ++b)
          sg[r][p][b] = e * signs_half[h * BETA + b];       // +-1
      }
    }
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

  __device__ __forceinline__ void step(const float (&x)[BETA], bool bf16,
                                       unsigned (&words)[R]) {
    this->acs_step([&](int r, int p) { return bm(r, p, x, bf16); }, words);
  }
};

// The encoder word of the edges out of state e2 / 2 (e2 even): bit b the
// parity of e2 & g_b, the sign of term b of the edge from predecessor e2
// (vit_wide_edges' s).
__device__ __forceinline__ unsigned vit_encoder_word(unsigned e2,
                                                     const int* polys,
                                                     int beta) {
  unsigned a = 0u;
  for (int b = 0; b < beta; ++b)
    a |= ((unsigned)__popc(e2 & (unsigned)polys[b]) & 1u) << b;
  return a;
}

// The polynomials' taps at bit `bit` as a mask, bit b for g_b: bit 0 the
// bottom taps (predecessor 2q + 1's edges flip them), bit k-1 the top taps
// (state q + S/2's edges).
__device__ __forceinline__ unsigned vit_tap_mask(int bit, int beta,
                                                 const int* polys) {
  unsigned m = 0u;
  for (int b = 0; b < beta; ++b) m |= (((unsigned)polys[b] >> bit) & 1u) << b;
  return m;
}

// Whether every one of the beta polynomials has both taps.
__device__ __forceinline__ bool vit_all_taps(unsigned bot, unsigned top,
                                             int beta) {
  const unsigned all = beta >= 32 ? VIT_FULL : (1u << beta) - 1u;
  return bot == all && top == all;
}

// The branch metrics of NE edges with encoder words w from one stage's
// beta LLRs x (shared memory, 16-byte aligned, read four at a time, as
// broadcasts): term b is x[b] with its sign bit flipped by bit b of the
// word; in b order, the first term and then one rounded add per term
// (vit_wide_edges' sums), rounded once to bf16 for bm_dtype bf16. By the
// identity at the head of this file that is the plain version's
// sgn * bm_half[idx].
template <int NE>
__device__ __forceinline__ void vit_word_sums(const unsigned (&w)[NE],
                                              const float* x, int beta,
                                              bool bf16, float (&e)[NE]) {
#pragma unroll 1
  for (int b0 = 0; b0 < beta; b0 += 4) {
    const float4 v = *reinterpret_cast<const float4*>(x + b0);
    const int xs[4] = {__float_as_int(v.x), __float_as_int(v.y),
                       __float_as_int(v.z), __float_as_int(v.w)};
#pragma unroll
    for (int i = 0; i < NE; ++i) {
      const unsigned wi = w[i] >> b0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float t =
            __int_as_float(xs[j] ^ (int)((wi << (31 - j)) & 0x80000000u));
        if (b0 + j < beta) e[i] = b0 + j == 0 ? t : __fadd_rn(e[i], t);
      }
    }
  }
  if (bf16) {
#pragma unroll
    for (int i = 0; i < NE; ++i)
      e[i] = __bfloat162float(__float2bfloat16_rn(e[i]));
  }
}

// The four branch metrics e[h][p] of a butterfly (edge p from 2q + p into
// q + h S/2) whose first edge has the encoder word a: the other edges flip
// the bottom taps (predecessor 2q + 1) and the top taps (state q + S/2).
// Where every polynomial has both (taps), edges 01 and 10 are edge 00's
// negation and edge 11 edge 00 itself (negation commutes with each rounded
// add and with the bf16 rounding; a zero may change sign, which no
// comparison sees): one sum.
__device__ __forceinline__ void vit_quad_word(unsigned a, unsigned bot,
                                              unsigned top, bool taps,
                                              const float* x, int beta,
                                              bool bf16, float (&e)[2][2]) {
  if (taps) {
    const unsigned w[1] = {a};
    float s[1];
    vit_word_sums<1>(w, x, beta, bf16, s);
    e[0][0] = e[1][1] = s[0];
    e[0][1] = e[1][0] = -s[0];
  } else {
    const unsigned w[4] = {a, a ^ bot, a ^ top, a ^ bot ^ top};
    float s[4];
    vit_word_sums<4>(w, x, beta, bf16, s);
    e[0][0] = s[0];
    e[0][1] = s[1];
    e[1][0] = s[2];
    e[1][1] = s[3];
  }
}

// The register mapping at a run-time beta (beta > VIT_MAX_BETA, one
// instantiation per R): each butterfly's encoder word in a register, the
// stage's LLRs in shared memory (vit_recursion_rt). For R >= 2 the lane's
// butterfly i is its states in registers i and i + R/2 (the low state
// 32 i + l and the high one S/2 above it, whose predecessors they share);
// for R = 1 the lane holds one state of a butterfly, low or high. What
// bounds it: beside the mapping's six operations a state, a lane's R/2
// sums of beta terms a stage (2 R where a polynomial lacks a tap), three
// instructions a term, and a shared-memory broadcast per four terms; the
// words take R/2 registers where the signs took 2 R beta.
template <int R>
struct VitFrame<R, 0> : VitLanes<R> {
  static constexpr int NQ = R >= 2 ? R / 2 : 1;
  unsigned a[NQ];        // encoder word of butterfly i's first edge
  unsigned bot, top;     // the polynomials' bottom and top taps
  bool taps;             // every polynomial has both: one sum a butterfly
  bool high;             // R = 1: the lane's state is a high one

  __device__ __forceinline__ void init(int k, int beta, const int* polys) {
    this->init_lanes(k);
    const int H = 1 << (k - 2);
    bot = vit_tap_mask(0, beta, polys);
    top = vit_tap_mask(k - 1, beta, polys);
    taps = vit_all_taps(bot, top, beta);
    high = R == 1 && this->l >= H;
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const int q = R >= 2 ? 32 * i + this->l : (this->l & (H - 1));
      a[i] = vit_encoder_word(2u * (unsigned)q, polys, beta);
    }
  }

  // One radix-2 stage from the stage's beta LLRs x (shared memory): the
  // edges' sums over their words first, then VitLanes' step. TAPS is
  // `taps`, a constant of the frame that the recursion branches on once.
  template <bool TAPS>
  __device__ __forceinline__ void step(const float* x, int beta, bool bf16,
                                       unsigned (&words)[R]) {
    float e[R][2];
    if constexpr (R == 1) {
      const unsigned w0 = a[0] ^ (high ? top : 0u);
      if constexpr (TAPS) {
        const unsigned w[1] = {w0};
        float s[1];
        vit_word_sums<1>(w, x, beta, bf16, s);
        e[0][0] = s[0];
        e[0][1] = -s[0];
      } else {
        const unsigned w[2] = {w0, w0 ^ bot};
        vit_word_sums<2>(w, x, beta, bf16, e[0]);
      }
    } else if constexpr (TAPS) {
      float s[NQ];
      vit_word_sums<NQ>(a, x, beta, bf16, s);
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        e[i][0] = e[i + NQ][1] = s[i];
        e[i][1] = e[i + NQ][0] = -s[i];
      }
    } else {
      unsigned w[2 * R];
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        w[2 * i] = a[i];
        w[2 * i + 1] = a[i] ^ bot;
        w[2 * (i + NQ)] = a[i] ^ top;
        w[2 * (i + NQ) + 1] = a[i] ^ bot ^ top;
      }
      float s[2 * R];
      vit_word_sums<2 * R>(w, x, beta, bf16, s);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        e[r][0] = s[2 * r];
        e[r][1] = s[2 * r + 1];
      }
    }
    this->acs_step([&](int r, int p) { return e[r][p]; }, words);
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

// Floats of one stage's row in the run-time-beta form's LLR chunks: beta
// rounded up to whole float4.
__host__ __device__ inline int vit_llr_row(int beta) {
  return (beta + 3) & ~3;
}

// Shared memory of one warp's LLR chunks in the run-time-beta form (none at
// beta <= VIT_MAX_BETA): two chunks of 32 stage rows.
__host__ __device__ inline long long vit_llr_chunk_bytes(int beta) {
  return beta > VIT_MAX_BETA ? 2LL * 32 * vit_llr_row(beta) * 4 : 0;
}

// One segment's LLRs of the chunk of P stages from stage c0, as
// vit_recursion_rt stages them: lane l loads the chunk's elements l,
// l + P, ... (eight loads in flight) and stores element i to row i / beta,
// term i % beta of dst, walking (i / beta, i % beta) from (u0, b0) by
// (du, db); zeros past L and for an invalid frame. A function of its own,
// so that no closure holds the frame's registers.
__device__ __forceinline__ void vit_stage_llr_chunk(
    const void* llr, int dtype, long long src, int P, int beta, int row,
    int u0, int b0, int du, int db, int c0, int L, bool fvalid, float* dst) {
  int u = u0, b = b0;
#pragma unroll 1
  for (int m = 0; m < beta; m += 8) {
    float v[8];
    int o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bool ok = m + j < beta && fvalid && c0 + u < L;
      v[j] = ok ? vit_load_llr(llr, dtype, src + (long long)P * (m + j))
                : 0.f;
      o[j] = u * row + b;
      b += db;
      u += du;
      if (b >= beta) {
        b -= beta;
        ++u;
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (m + j < beta) dst[o[j]] = v[j];
  }
}

// vit_recursion at a run-time beta (VitFrame<R, 0>), with the same runs,
// Store interface and zeros past L and for an invalid frame. The LLRs of
// each chunk of P stages go to the warp's shared memory `buf` (two chunks
// of 32 rows of vit_llr_row(beta) floats: stage c0 + u of the segment in
// row segbase + u of chunk (c0 / P) & 1) one chunk ahead: the segment's
// lanes load its P beta contiguous elements (lane l the elements l,
// l + P, ..., eight loads in flight a lane) at the chunk's start, and each
// stage reads its row as broadcasts. A __syncwarp at each chunk's start
// publishes the chunk loaded during the last one and orders the last
// one's reads before the next chunk's stores into its buffer.
template <bool TAPS, int R, class Store>
__device__ __forceinline__ void vit_recursion_rt_taps(
    VitFrame<R, 0>& fr, const void* llr, int dtype, bool bf16,
    long long frame_base, int L, bool fvalid, int beta, float* buf,
    Store& st) {
  const int P = fr.lanes();
  const int run = R >= 2 ? 32 / R : P;
  const int row = vit_llr_row(beta);
  const int du = P / beta, db = P % beta;     // element i + P: (stage, term)
  const int l = fr.l, u0 = l / beta, b0 = l % beta;
  float* mine = buf + fr.segbase * row;
  unsigned words[R];
  vit_stage_llr_chunk(llr, dtype, frame_base + l, P, beta, row, u0, b0, du,
                      db, 0, L, fvalid, mine);
  for (int c0 = 0, h = 0; c0 < L; c0 += P, h ^= 1) {
    __syncwarp();
    if (c0 + P < L)
      vit_stage_llr_chunk(llr, dtype,
                          frame_base + (long long)(c0 + P) * beta + l, P,
                          beta, row, u0, b0, du, db, c0 + P, L, fvalid,
                          mine + (h ^ 1) * 32 * row);
    const float* cur = mine + h * 32 * row;
    for (int q = 0; q < R; ++q) {
      const int t0 = c0 + q * run;
      if (t0 >= L) break;
      const int n = min(run, L - t0);
#pragma unroll 1
      for (int u = 0; u < n; ++u) {
        fr.template step<TAPS>(cur + (q * run + u) * row, beta, bf16,
                               words);
        st.stage(t0 + u, u, words);
      }
      st.run_end(t0, n);
    }
  }
}

// One loop per value of the frame's taps, chosen once outside the stages,
// so that no stage branches on it.
template <int R, class Store>
__device__ __forceinline__ void vit_recursion_rt(VitFrame<R, 0>& fr,
                                                 const void* llr, int dtype,
                                                 bool bf16,
                                                 long long frame_base, int L,
                                                 bool fvalid, int beta,
                                                 float* buf, Store& st) {
  if (fr.taps)
    vit_recursion_rt_taps<true>(fr, llr, dtype, bf16, frame_base, L, fvalid,
                                beta, buf, st);
  else
    vit_recursion_rt_taps<false>(fr, llr, dtype, bf16, frame_base, L, fvalid,
                                 beta, buf, st);
}

// Calls F::template run<R, BETA>(a...) for the instantiation that serves
// (k, beta): one per registers-per-lane R in {1, 2, 4, ..., 32} (k <= 11)
// and per code rate 1/beta, beta in 2..8; BETA = 0 (beta at run time) for
// every rate below 1/8.
template <class F, int R, class... A>
int vit_dispatch_beta(int beta, A... a) {
  switch (beta) {
    case 2: return F::template run<R, 2>(a...);
    case 3: return F::template run<R, 3>(a...);
    case 4: return F::template run<R, 4>(a...);
    case 5: return F::template run<R, 5>(a...);
    case 6: return F::template run<R, 6>(a...);
    case 7: return F::template run<R, 7>(a...);
    case 8: return F::template run<R, 8>(a...);
    default: return F::template run<R, 0>(a...);
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
// Every other code (k >= 16): the wide mapping. (Codes 16 <= k <= 19 run
// on a thread-block cluster instead where the card holds one: VitCluster,
// after it.) Any code a test forces on it (the wrappers' _wide) runs too.
//
// Past k = 15 two buffers of S float32 path metrics outgrow a block's shared
// memory (256 KB at k = 16, over the 227 KB a block can have). Those codes
// take a mapping instantiated once in each kernel beside the others (so
// their instantiations do not change), which takes k and beta at run time:
// per-(k, beta) templates would multiply the build for codes that are rare.
// (Until the register mapping and the one-block form took beta at run
// time, every code past beta = 8 ran it too: at k <= 15 they are faster,
// PERF.md.)
//   * one block a frame, T = clamp(S/2, 32, 1024) threads (vit_wide_threads);
//     thread t runs the butterflies q = t + T i, i < max(1, S/2 / T), each the
//     states q and q + S/2 with the predecessors 2q and 2q + 1. A block
//     takes frames blockIdx.x, + gridDim.x, ...: the wrapper sizes the grid
//     to the blocks that are resident at once, so the device-memory scratch
//     is per block, not per frame;
//   * path metrics: two buffers of S float32 in the block's device-memory
//     scratch (at every k: no code the planner routes here fits them in
//     shared memory, and a forced code runs as those do). Stage t reads the
//     old buffer (the predecessors 2q, 2q + 1 as one float2) and writes the
//     new one; the stage's __syncthreads makes the writes visible to the
//     block. The buffer holds the stage's metrics before
//     the normalisation and the reader subtracts the max (the same __fsub_rn
//     as the register path, taken when it is read);
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
//     the states before the high half) and ties: a redux per
//     warp, the warps' partials through shared memory after the barrier.
// What bounds it: the same six float operations a state and stage as the
// other mappings, with beta adds per edge for the branch metrics; each
// stage also moves 2 x 4 S bytes of path metrics through the L2
// cache (a block's 256 KB at k = 16 stay in the 50 MB L2 for 132 blocks).
#define VIT_WIDE_MAX_THREADS 1024
// Most beta the mapping takes (a warp loads a stage's terms; the plain
// version's 2^beta-entry tables end far below).
#define VIT_WIDE_MAX_BETA 32
// Largest k: a state is an int (S = 2^30 states at k = 31).
#define VIT_WIDE_MAX_K 31
// The fixed part of the mapping's shared memory: warp partials [4][32] int,
// the LLR buffer [2][VIT_WIDE_MAX_BETA] float, the polynomials
// [VIT_WIDE_MAX_BETA] int: all of it (the path metrics are in device
// memory).
#define VIT_WIDE_CORE_BYTES (4 * 4 * 32 + 2 * 4 * VIT_WIDE_MAX_BETA + \
                             4 * VIT_WIDE_MAX_BETA)

// Whether (k, beta) is outside the two fast mappings' domain (the register
// mapping to k = 11 and the one-block form to k = 15, at every beta).
__host__ __device__ inline bool vit_wide_code(int k, int beta) {
  (void)beta;
  return k > VIT_SMEM_MAX_K;
}

// Threads of one wide-mapping block: one a butterfly, at least a warp and
// at most VIT_WIDE_MAX_THREADS.
__host__ __device__ inline int vit_wide_threads(int k) {
  const long long h = 1LL << (k - 2);
  return h < 32 ? 32 : (h > VIT_WIDE_MAX_THREADS ? VIT_WIDE_MAX_THREADS
                                                 : (int)h);
}

// The branch metrics of butterfly q of a k code with beta polynomials g
// from the stage's LLRs x: e[h][p] is edge p (from 2q + p) into state
// q + h S/2.
__device__ __forceinline__ void vit_wide_edges(int k, int beta,
                                               const unsigned* g, int q,
                                               const float* x, bool bf16,
                                               float (&e)[2][2]) {
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

// One frame on one block. Shared memory at `sm` (16-byte aligned), laid
// out as VIT_WIDE_CORE_BYTES says; the path metrics at `pm_global` (the
// block's [2][S] float in device memory).
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
    pm = pm_global;
    const int tid = threadIdx.x;
    if (tid < beta) g[tid] = (unsigned)polys[tid];
  }

  // The branch metrics of butterfly q (vit_wide_edges).
  __device__ __forceinline__ void bm(int q, const float* x, bool bf16,
                                     float (&e)[2][2]) const {
    vit_wide_edges(k, beta, g, q, x, bf16, e);
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

// ---------------------------------------------------------------------------
// Codes 16 <= k <= 19: the cluster mapping.
//
// Past k = 15 the two buffers of S float32 path metrics outgrow a block's
// shared memory (256 KB at k = 16), and VitWide keeps them in a device-memory
// scratch that every stage reads and writes through L2 (or, past the 50 MB
// L2 at k = 17, through device memory). Hopper's thread-block clusters put
// 2-16 blocks on neighbouring SMs that read and write each other's shared
// memory (distributed shared memory) and meet at one cluster barrier. So a
// k code with 16 <= k <= 19 runs one frame on a cluster of C = 2^(k-15)
// blocks, the least power of two whose blocks hold the double-buffered 8 S
// bytes in 128 KB each (vit_cluster_size). Kernels instantiate this mapping
// beside the other three, so their instantiations do not change; a test
// may force it on any code with any C (the `cluster` launch argument; the
// kernel reads C back from %cluster_nctarank).
//   * ownership: with Hc = S/2/C, block c (its rank in the cluster) owns
//     the old states [2 c Hc, 2 (c+1) Hc) and runs the butterflies q in
//     [c Hc, (c+1) Hc), whose predecessors 2q and 2q + 1 it reads from its
//     own shared memory as one float2. T = clamp(Hc, 32, 512) threads,
//     NB = max(1, Hc / T) butterflies a thread, a template constant (16 at
//     k = 16-19), the loop unrolled;
//   * the exchange: new state q belongs to block c/2 and new state q + S/2
//     to block c/2 + C/2, both at offset (c & 1) Hc + (q - c Hc); the block
//     writes them there with plain stores through the owners' shared
//     memory mapped into its address space (__cluster_map_shared_rank, once
//     a launch). One cluster barrier a stage (barrier.cluster.arrive.release
//     / wait.acquire) stands in for the block barrier: it publishes the
//     writes, and the double buffer lets the next stage's writes start
//     only after every block has read the buffer they overwrite. Between
//     the arrive and the wait a block stores the stage's survivors;
//   * butterfly i + 1's two shared-memory loads are issued before
//     butterfly i's stores, which the compiler may not move loads past;
//   * the stage max: each warp's redux max (on vit_key's integer image) goes
//     to every block of the cluster (lane j stores to block j), into a slot
//     per (block, warp); after the barrier every warp reduces the C x warps
//     partials. The first maximal state, only at the stages the store asks
//     for (B1: its traceback starts; B3: every stage): each warp's least
//     first hit goes to block 0, whose warp 0 takes the least after the
//     next stage's barrier. Both are exact and order-free (a max, and a
//     min of state indices);
//   * lazy normalisation as VitWide: the buffers hold each stage's metrics
//     before it, and the reader subtracts the previous stage's max;
//   * branch metrics (beta <= 8): the four edges of butterfly q are the
//     metrics of the encoder words a, a ^ bottom taps, a ^ top taps and
//     a ^ both (a: the parities of 2q and the polynomials), so a table of
//     2^beta entries a stage, built one stage ahead from the LLRs in shared
//     memory, serves every butterfly through its byte a (in registers):
//     one float4 a butterfly, or, where every polynomial has both taps,
//     one float whose negation is two of the edges (vit_edge0). Past
//     beta = 8 (TBL = false) each butterfly sums its own terms from its
//     encoder word, a register a butterfly computed once a launch
//     (vit_quad_word: one sum where every polynomial has both taps, else
//     four), the terms read as broadcasts from the LLR buffer. Both are
//     vit_wide_edges' sums, the plain version's sgn * bm_half[idx];
//   * survivors: each block's warps ballot 32 neighbouring butterflies, so
//     packed they are packing.py's LANE words, contiguous ranges of words
//     per block; lane i of a warp holds the word of its butterfly run i
//     (lane NB + i the high states') and stores it. A forced small code
//     (Hc < 32: one partial word a block) ORs its bits into a staging word
//     of block 0 (red.shared::cluster), which block 0 stores after the
//     barrier.
// What bounds it: the six float operations a state and stage, as the other
// mappings, now with no path-metric bytes off the chip: per SM and stage
// S/C states (16384 at k = 16-19) and one cluster barrier. 512 threads a
// block leave a thread 128 registers for its 16 butterflies (1024 threads,
// 64 registers, spilled and ran no faster).
//
// The one-block form (template CL = false): codes 12 <= k <= 15 (the large
// codes), one frame a block, with no cluster; the butterfly table at
// beta <= 8, per-edge sums past it (TBL = false). The block owns all
// S states (C = 1, Hc = S/2): the exchange is a store to its own shared
// memory (new state q at q, q + S/2 at q + S/2 of the new buffer), the
// cluster barrier one __syncthreads a stage (the survivor words are stored
// before it), and the max and first-hit partials one block's warps'. The
// branch metrics, the loads a butterfly ahead and the lazy normalisation
// are the cluster's. T = vit_block_threads(k, beta) threads of NB = S/2 / T
// butterflies each (16 of 512 at k = 15, the cluster block's shape); the
// kernels take frames blockIdx.x, + gridDim.x, ... on the blocks the card
// keeps resident (cudaOccupancyMaxActiveBlocksPerMultiprocessor), so that
// a smaller block leaves room for more frames an SM, which hide each
// other's barrier. It takes any k with S/2 >= 32 (whole survivor words a
// warp) up to 15; below 12 only when a test forces it.
#define VIT_CLUSTER_MIN_K 16
#define VIT_CLUSTER_MAX_K 19
// Most blocks of a cluster the mapping lays out room for: the H100's
// largest, non-portable cluster. A larger one is refused before any launch
// (vit_cluster_ok).
#define VIT_CLUSTER_MAX_DIM 16
// Most threads of a cluster block, and most butterflies a thread runs: 16
// of 512 threads, 2^14 states a block (512 threads leave a thread 128
// registers for its 16 butterflies; 1024, at 64, spilled).
#define VIT_CLUSTER_THREADS 512
#define VIT_CLUSTER_MAX_NB 16
// Words a stage's small-code staging holds (S < 64 C <= 1024 states).
#define VIT_CLUSTER_WORDS 32
// Entries of a stage's butterfly table: one per encoder word of the
// butterfly's first edge, 2^beta for beta <= 8.
#define VIT_CLUSTER_QUADS (1 << VIT_MAX_BETA)
// The fixed part of a cluster block's shared memory: the butterfly tables
// [2][VIT_CLUSTER_QUADS] float4, the max and argmax partials
// [2][VIT_CLUSTER_MAX_DIM * 32] int each, the word staging
// [2][VIT_CLUSTER_WORDS], the LLR buffer [2][VIT_WIDE_MAX_BETA] and the
// polynomials; then the path metrics [2][S/C] float.
#define VIT_CLUSTER_CORE_BYTES                                         \
  (2 * VIT_CLUSTER_QUADS * 16 + 2 * 2 * VIT_CLUSTER_MAX_DIM * 32 * 4 + \
   2 * VIT_CLUSTER_WORDS * 4 + 2 * VIT_WIDE_MAX_BETA * 4 +             \
   VIT_WIDE_MAX_BETA * 4)

// The one-block form's fixed shared memory: VIT_CLUSTER_CORE_BYTES' layout
// with the partials of one block ([2][32] int each); then the path metrics
// [2][S] float.
#define VIT_BLOCK_CORE_BYTES                                          \
  (2 * VIT_CLUSTER_QUADS * 16 + 2 * 2 * 32 * 4 + 2 * VIT_CLUSTER_WORDS * 4 + \
   2 * VIT_WIDE_MAX_BETA * 4 + VIT_WIDE_MAX_BETA * 4)
// Least k the one-block form takes: S/2 >= 32 butterflies.
#define VIT_BLOCK_MIN_K 7

// Threads of a one-block frame of a (k, beta) code (at most S/2): at
// beta <= 8 (the table) 256, 128, 256, 512 at k = 12..15, the fastest of
// 128, 256 and 512 at eight frames an SM on an H100 (tools/variant_turns.py
// --large; PERF.md); past it (per-edge sums, costlier a butterfly) 256,
// 512, 512, 512 (tools/variant_turns.py --low-rate); 128 below k = 12.
__host__ __device__ inline int vit_block_threads(int k, int beta) {
  const int h = 1 << (k - 2);
  const int t = k >= 15 || (beta > VIT_MAX_BETA && k >= 13) ? 512
                : k == 12 || k == 14                       ? 256
                                                           : 128;
  return h < t ? h : t;
}

// Butterflies a thread runs in the one-block form (NB).
__host__ __device__ inline int vit_block_nb(int k, int beta) {
  return (1 << (k - 2)) / vit_block_threads(k, beta);
}

// Whether the one-block form takes a k code.
__host__ __device__ inline bool vit_block_ok(int k) {
  return k >= VIT_BLOCK_MIN_K && k <= VIT_SMEM_MAX_K;
}

// Dynamic shared memory of a one-block frame's recursion: the core and the
// path metrics (8 S bytes).
__host__ __device__ inline long long vit_block_smem_bytes(int k) {
  return VIT_BLOCK_CORE_BYTES + 8LL * (1LL << (k - 1));
}

// The cluster a k code runs on by default: 2^(k-15) blocks for 16 <= k <=
// 19, else 1 (no cluster).
__host__ __device__ inline int vit_cluster_size(int k) {
  return k >= VIT_CLUSTER_MIN_K && k <= VIT_CLUSTER_MAX_K ? 1 << (k - 15)
                                                          : 1;
}

// Butterflies of one block of a cluster of C (Hc).
__host__ __device__ inline long long vit_cluster_half(int k, int C) {
  return (1LL << (k - 2)) / C;
}

// Threads of one block of a cluster of C: one a butterfly, at least a warp
// and at most VIT_CLUSTER_THREADS.
__host__ __device__ inline int vit_cluster_threads(int k, int C) {
  const long long h = vit_cluster_half(k, C);
  return h < 32 ? 32 : (h > VIT_CLUSTER_THREADS ? VIT_CLUSTER_THREADS
                                                : (int)h);
}

// Butterflies a thread runs (NB).
__host__ __device__ inline int vit_cluster_nb(int k, int C) {
  const long long h = vit_cluster_half(k, C);
  return h > VIT_CLUSTER_THREADS ? (int)(h / VIT_CLUSTER_THREADS) : 1;
}

// Dynamic shared memory of one block of a cluster of C: the core and the
// path metrics (8 S / C bytes).
__host__ __device__ inline long long vit_cluster_smem_bytes(int k, int C) {
  return VIT_CLUSTER_CORE_BYTES + 8LL * ((1LL << (k - 1)) / C);
}

// Whether the mapping takes a k code on a cluster of C: C a power of two,
// 2 <= C <= VIT_CLUSTER_MAX_DIM, a butterfly a block at least, at most
// VIT_CLUSTER_MAX_NB a thread.
__host__ __device__ inline bool vit_cluster_ok(int k, int C) {
  return C >= 2 && C <= VIT_CLUSTER_MAX_DIM && (C & (C - 1)) == 0 &&
         k >= 2 && k <= VIT_WIDE_MAX_K && vit_cluster_half(k, C) >= 1 &&
         vit_cluster_nb(k, C) <= VIT_CLUSTER_MAX_NB;
}

__device__ __forceinline__ unsigned vit_cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ unsigned vit_cluster_blocks() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ unsigned vit_cluster_id() {
  unsigned r;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return r;
}
__device__ __forceinline__ unsigned vit_cluster_count() {
  unsigned r;
  asm volatile("mov.u32 %0, %%nclusterid.x;" : "=r"(r));
  return r;
}
// The shared::cluster address of `a` (this block's shared address) in
// block `rank` of the cluster.
__device__ __forceinline__ uint32_t vit_mapa(uint32_t a, unsigned rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(a), "r"(rank));
  return r;
}
__device__ __forceinline__ void vit_st_cluster_s32(uint32_t a, int v) {
  asm volatile("st.shared::cluster.s32 [%0], %1;" :: "r"(a), "r"(v));
}
__device__ __forceinline__ void vit_or_cluster_u32(uint32_t a, unsigned v) {
  asm volatile("red.relaxed.cluster.shared::cluster.or.b32 [%0], %1;"
               :: "r"(a), "r"(v) : "memory");
}
// A generic pointer to `p` (in this block's shared memory) in block `rank`
// of the cluster: plain stores through it reach that block.
__device__ __forceinline__ float* vit_map_rank(float* p, unsigned rank) {
  return static_cast<float*>(__cluster_map_shared_rank(p, rank));
}
// Every thread of the cluster: what each wrote before (shared memory of any
// block, device memory) is visible to each after. Split in two, the
// thread's work between arrive and wait overlaps the others' arrival but
// is not published by this barrier.
__device__ __forceinline__ void vit_cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void vit_cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
__device__ __forceinline__ void vit_cluster_sync() {
  vit_cluster_arrive();
  vit_cluster_wait();
}

// The four branch metrics of the butterflies whose first edge has the
// encoder word `a` (bit b = the sign of term b), as vit_wide_edges sums
// them: the other edges flip the terms of the polynomials' bottom taps
// (predecessor 2q + 1) and top taps (state q + S/2). Component 2 h + p of
// the float4 is edge p into state q + h S/2.
__device__ __forceinline__ float4 vit_quad(unsigned a, const float* x,
                                           const unsigned* g, int k,
                                           int beta, bool bf16) {
  float e[4];
#pragma unroll
  for (int b = 0; b < VIT_MAX_BETA; ++b) {
    if (b < beta) {
      const unsigned gb = g[b];
      const unsigned s = (a >> b) & 1u, bot = gb & 1u;
      const unsigned tp = (gb >> (k - 1)) & 1u;
      const int xi = __float_as_int(x[b]);
      const float t[4] = {__int_as_float(xi ^ (int)(s << 31)),
                          __int_as_float(xi ^ (int)((s ^ bot) << 31)),
                          __int_as_float(xi ^ (int)((s ^ tp) << 31)),
                          __int_as_float(xi ^ (int)((s ^ bot ^ tp) << 31))};
#pragma unroll
      for (int i = 0; i < 4; ++i) e[i] = b == 0 ? t[i] : __fadd_rn(e[i], t[i]);
    }
  }
  if (bf16) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      e[i] = __bfloat162float(__float2bfloat16_rn(e[i]));
  }
  return make_float4(e[0], e[1], e[2], e[3]);
}

// The first edge's metric alone (component 0 of vit_quad). Where every
// polynomial has its top and bottom taps, the butterfly's other edges flip
// every term: edges 01 and 10 are its negation and edge 11 itself
// (negation commutes with each rounded add and with the bf16 rounding; a
// zero may change sign, which no comparison sees).
__device__ __forceinline__ float vit_edge0(unsigned a, const float* x,
                                          int beta, bool bf16) {
  float e = __int_as_float(__float_as_int(x[0]) ^ (int)((a & 1u) << 31));
#pragma unroll
  for (int b = 1; b < VIT_MAX_BETA; ++b)
    if (b < beta)
      e = __fadd_rn(e, __int_as_float(__float_as_int(x[b]) ^
                                      (int)(((a >> b) & 1u) << 31)));
  if (bf16) e = __bfloat162float(__float2bfloat16_rn(e));
  return e;
}

// One frame on one block of a cluster (CL) or on one block alone (the
// one-block form). Shared memory at `sm` (16-byte aligned), laid out as
// VIT_CLUSTER_CORE_BYTES (CL) or VIT_BLOCK_CORE_BYTES says, then the
// block's path metrics [2][S/C] float. Loop invariants live in shared
// memory and in 32-bit shared addresses, so that a thread keeps its
// registers for its NB butterflies.
template <int NB, bool TBL, bool CL = true>
struct VitCluster {
  // Blocks whose partials a block keeps, and one stage's slot of them.
  static constexpr int DIM = CL ? VIT_CLUSTER_MAX_DIM : 1;
  static constexpr int SLOT = DIM * 32;
  int k, beta, S, H, C, c, Hc, T, nw, nq;
  bool small;            // Hc < 32: a block's survivors are a partial word
  bool taps;             // every polynomial has its top and bottom taps
  float* pm;             // [2][2 Hc], this block's old states
  float4* quad;          // [2][VIT_CLUSTER_QUADS] butterfly tables (TBL);
                         // with taps, slot s holds VIT_CLUSTER_QUADS floats
                         // (vit_edge0) at quad + s VIT_CLUSTER_QUADS
  // The encoder word of butterfly i's first edge: byte i, its table entry
  // (TBL), or word i (per-edge sums)
  unsigned aw[TBL ? (NB + 3) / 4 : NB];
  unsigned bot, top;     // the polynomials' bottom and top taps (!TBL)
  int* rmax;             // [2][DIM][32] warp maxima (keys)
  int* rarg;             // [2][DIM][32] warp first hits
  unsigned* sw;          // [2][VIT_CLUSTER_WORDS] small-code words
  float* sx;             // [2][VIT_WIDE_MAX_BETA] LLRs
  unsigned* g;           // [VIT_WIDE_MAX_BETA] polynomials
  float* lo_dst;         // buffer 0 of blocks c/2, c/2 + C/2 (generic
  float* hi_dst;         // addresses of their shared memory), + offset
                         // (one block: its own buffer 0 and S/2 into it)
  uint32_t max_dst;      // lane j < C: block j's rmax + this block's row
  uint32_t arg_dst;      // block 0's rarg + this block's row
  uint32_t sw_dst;       // block 0's sw (CL)

  __device__ __forceinline__ void init(int k_, int beta_, const int* polys,
                                       unsigned char* sm) {
    constexpr int RED = 2 * SLOT;
    k = k_;
    beta = beta_;
    S = 1 << (k - 1);
    H = S >> 1;
    C = CL ? (int)vit_cluster_blocks() : 1;
    c = CL ? (int)vit_cluster_rank() : 0;
    Hc = H / C;
    T = blockDim.x;
    nw = T >> 5;
    nq = TBL ? 1 << beta : 0;
    small = Hc < 32;
    quad = reinterpret_cast<float4*>(sm);
    rmax = reinterpret_cast<int*>(quad + 2 * VIT_CLUSTER_QUADS);
    rarg = rmax + RED;
    sw = reinterpret_cast<unsigned*>(rarg + RED);
    sx = reinterpret_cast<float*>(sw + 2 * VIT_CLUSTER_WORDS);
    g = reinterpret_cast<unsigned*>(sx + 2 * VIT_WIDE_MAX_BETA);
    pm = reinterpret_cast<float*>(
        sm + (CL ? VIT_CLUSTER_CORE_BYTES : VIT_BLOCK_CORE_BYTES));
    const int tid = threadIdx.x, lane = tid & 31;
    if (tid < beta) g[tid] = (unsigned)polys[tid];
    taps = true;
    for (int b = 0; b < beta; ++b)
      taps = taps && (polys[b] & 1) && ((polys[b] >> (k - 1)) & 1);
    const uint32_t rmax_s =
        static_cast<uint32_t>(__cvta_generic_to_shared(rmax));
    const uint32_t rarg_s =
        static_cast<uint32_t>(__cvta_generic_to_shared(rarg));
    if constexpr (CL) {
      lo_dst = vit_map_rank(pm, c >> 1) + (c & 1) * Hc;
      hi_dst = vit_map_rank(pm, (c >> 1) + C / 2) + (c & 1) * Hc;
      max_dst = vit_mapa(rmax_s, lane < C ? lane : 0) + 4u * 32 * c;
      arg_dst = vit_mapa(rarg_s, 0) + 4u * 32 * c;
      sw_dst = vit_mapa(static_cast<uint32_t>(__cvta_generic_to_shared(sw)),
                        0);
    } else {
      lo_dst = pm;
      hi_dst = pm + H;
      max_dst = rmax_s;
      arg_dst = rarg_s;
      sw_dst = 0u;
    }
    if constexpr (TBL) {
#pragma unroll
      for (int w = 0; w < (NB + 3) / 4; ++w) aw[w] = 0u;
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const unsigned e2 = 2u * (unsigned)(c * Hc + tid + T * i);
        unsigned a = 0u;
        for (int b = 0; b < beta; ++b)
          a |= ((unsigned)__popc(e2 & (unsigned)polys[b]) & 1u) << b;
        aw[i >> 2] |= a << (8 * (i & 3));
      }
    } else {
      bot = vit_tap_mask(0, beta, polys);
      top = vit_tap_mask(k - 1, beta, polys);
#pragma unroll
      for (int i = 0; i < NB; ++i)
        aw[i] = vit_encoder_word(2u * (unsigned)(c * Hc + tid + T * i),
                                 polys, beta);
    }
    __syncthreads();          // the polynomials
  }

  // Stage `slot`'s butterfly table from its LLRs x, entries a = tid,
  // tid + T, ...
  __device__ __forceinline__ void table(int slot, const float* x,
                                        bool bf16) const {
    float* tp = reinterpret_cast<float*>(quad + slot * VIT_CLUSTER_QUADS);
    for (int a = threadIdx.x; a < nq; a += T) {
      if (taps)
        tp[a] = vit_edge0((unsigned)a, x, beta, bf16);
      else
        quad[slot * VIT_CLUSTER_QUADS + a] =
            vit_quad((unsigned)a, x, g, k, beta, bf16);
    }
  }
};

// The first maximal state of stage `t`, from the warps' first hits in
// block 0 (after the barrier that follows their stores); in warp 0 of
// block 0.
template <int NB, bool TBL, bool CL>
__device__ __forceinline__ int vit_cluster_first_max(
    const VitCluster<NB, TBL, CL>& v, int t) {
  const int lane = threadIdx.x & 31;
  const int* r = v.rarg + (t & 1) * v.SLOT;
  int a = 0x7fffffff;
  if (lane < v.nw)
    for (int j = 0; j < v.C; ++j) a = min(a, r[32 * j + lane]);
  return __reduce_min_sync(VIT_FULL, a);
}

// The recursion of one frame over L stages on the cluster, with VitWide's
// Store interface and st.argmax_at(t) (whether stage t's first maximal
// state is wanted, without consuming it): packed, st.word(t, i, w) in the
// lane that holds word i
// (lane i < NB the low states of butterfly run i, lane NB + i the high
// ones), or in warp 0 of block 0 for a small code; unpacked,
// st.butterfly(t, q, valid, sel_lo, sel_hi, b_lo, b_hi) per butterfly in
// every thread; st.wants_argmax(t) in every thread (cluster uniform) and
// st.argmax(t, a) in warp 0 of block 0. Starts and ends with a cluster
// barrier (one block: a block barrier): the frame's survivors and first
// maxima are then visible to the whole cluster, and its buffers free.
template <bool PACK, bool TAPS, int NB, bool TBL, bool CL, class Store>
__device__ __forceinline__ void vit_cluster_recursion(
    VitCluster<NB, TBL, CL>& v, const void* llr, int dtype, bool bf16,
    long long frame_base, int L, Store& st) {
  const int Hc = v.Hc, T = v.T, beta = v.beta;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int SC = 2 * Hc;                      // old states a block owns
  constexpr int SLOT = VitCluster<NB, TBL, CL>::SLOT;
  const bool words = CL && v.small && PACK;   // one block: never small
  auto sync = [] {
    if constexpr (CL) vit_cluster_sync();
    else __syncthreads();
  };
  for (int s = tid; s < SC; s += T) v.pm[SC + s] = 0.f;   // stage -1
  for (int i = tid; i < 2 * VIT_CLUSTER_WORDS; i += T) v.sw[i] = 0u;
  // The LLRs: thread b < beta loads term b ahead into pf and stores it to
  // the two-stage buffer sx, which a barrier publishes. TBL: the tables
  // of stage t + 1 are built during stage t from sx (stage t + 1's terms,
  // stored during stage t - 1), so pf runs three stages ahead; else the
  // butterflies read sx (stage t's terms, stored during stage t - 1).
  float pf = 0.f;
  if (tid < beta) {
    v.sx[tid] = vit_load_llr(llr, dtype, frame_base + tid);
    if (TBL) {
      if (L > 1)
        v.sx[VIT_WIDE_MAX_BETA + tid] =
            vit_load_llr(llr, dtype, frame_base + beta + tid);
      if (L > 2)
        pf = vit_load_llr(llr, dtype, frame_base + 2LL * beta + tid);
    } else if (L > 1) {
      pf = vit_load_llr(llr, dtype, frame_base + beta + tid);
    }
  }
  if (TBL) {                  // stage 0's table, from the thread's loads
    float x0[VIT_MAX_BETA];
    if (tid < v.nq) {
#pragma unroll
      for (int b = 0; b < VIT_MAX_BETA; ++b)
        if (b < beta) x0[b] = vit_load_llr(llr, dtype, frame_base + b);
      v.table(0, x0, bf16);
    }
  }
  sync();
  float m = 0.f;              // the previous stage's max
  int pend = -1;              // stage whose first maximum is pending
  for (int t = 0; t < L; ++t) {
    if (TBL) {
      if (t + 1 < L)          // the next stage's table
        v.table((t + 1) & 1, v.sx + ((t + 1) & 1) * VIT_WIDE_MAX_BETA, bf16);
      if (tid < beta) {
        if (t + 2 < L) v.sx[(t & 1) * VIT_WIDE_MAX_BETA + tid] = pf;
        if (t + 3 < L)
          pf = vit_load_llr(llr, dtype,
                            frame_base + (long long)(t + 3) * beta + tid);
      }
    } else if (tid < beta) {
      v.sx[((t + 1) & 1) * VIT_WIDE_MAX_BETA + tid] = pf;
      if (t + 2 < L)
        pf = vit_load_llr(llr, dtype,
                          frame_base + (long long)(t + 2) * beta + tid);
    }
    const float4* qd = v.quad + (t & 1) * VIT_CLUSTER_QUADS;
    const float* tp = reinterpret_cast<const float*>(qd);
    const float* x = v.sx + (t & 1) * VIT_WIDE_MAX_BETA;
    const float2* old = reinterpret_cast<const float2*>(
        v.pm + ((t + 1) & 1) * SC) + tid;
    float* lo = v.lo_dst + (t & 1) * SC + tid;
    float* hi = v.hi_dst + (t & 1) * SC + tid;
    float mlo = -INFINITY, mhi = -INFINITY;
    int slo = 0, shi = 0;
    unsigned myw = 0u;        // packed: the survivor word this lane holds
    // The first maximal state only where the store wants it (B1: at the
    // traceback starts; B3: every stage); else the max alone.
    const bool track = st.argmax_at(t);
    // Butterfly i + 1's loads go out before butterfly i's stores: the
    // compiler may not move a shared-memory load past a store that may
    // alias it.
    float2 ppn = make_float2(0.f, 0.f);
    float4 en = make_float4(0.f, 0.f, 0.f, 0.f);
    if (NB > 1 || tid < Hc) {
      ppn = old[0];                         // v of 2q and 2q + 1
      if (TAPS) en.x = tp[v.aw[0] & 0xffu];
      else if (TBL) en = qd[v.aw[0] & 0xffu];
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int j = tid + T * i;              // butterfly within the block
      const int q = v.c * Hc + j;
      const bool valid = NB > 1 || j < Hc;    // false only for small codes
      const float2 pp = ppn;
      float e[2][2] = {{en.x, en.y}, {en.z, en.w}};
      if (TAPS) {
        e[0][1] = e[1][0] = -en.x;
        e[1][1] = en.x;
      }
      if (i + 1 < NB) {
        ppn = old[T * (i + 1)];
        const unsigned a = (v.aw[(i + 1) >> 2] >> (8 * ((i + 1) & 3))) & 0xffu;
        if (TAPS) en.x = tp[a];
        else if (TBL) en = qd[a];
      }
      bool sl = false, sh = false;
      if (valid) {
        const float p0 = __fsub_rn(pp.x, m);
        const float p1 = __fsub_rn(pp.y, m);
        if (!TBL)
          vit_quad_word(v.aw[i], v.bot, v.top, v.taps, x, beta, bf16, e);
        const float l0 = __fadd_rn(p0, e[0][0]);
        const float l1 = __fadd_rn(p1, e[0][1]);
        const float h0 = __fadd_rn(p0, e[1][0]);
        const float h1 = __fadd_rn(p1, e[1][1]);
        sl = l1 >= l0;
        sh = h1 >= h0;
        const float vl = sl ? l1 : l0;
        const float vh = sh ? h1 : h0;
        // the exchange: new state q to block c/2, q + S/2 to c/2 + C/2
        lo[T * i] = vl;
        hi[T * i] = vh;
        if (track) {
          if (vl > mlo) { mlo = vl; slo = q; }
          if (vh > mhi) { mhi = vh; shi = q + v.H; }
        } else {
          mlo = fmaxf(mlo, vl);
          mhi = fmaxf(mhi, vh);
        }
      }
      if (PACK) {
        const unsigned blo = __ballot_sync(VIT_FULL, sl);
        const unsigned bhi = __ballot_sync(VIT_FULL, sh);
        if (lane == i) myw = blo;
        if (lane == NB + i) myw = bhi;
      } else {
        st.butterfly(t, q, valid, sl, sh, 0u, 0u);
      }
    }
    const int key = __reduce_max_sync(
        VIT_FULL, vit_key(__float_as_int(fmaxf(mlo, mhi))));
    if constexpr (!CL)
      vit_sts_u32_if(lane == 0, v.max_dst + 4u * ((t & 1) * SLOT + warp),
                     (unsigned)key);
    else if (lane < v.C)
      vit_st_cluster_s32(v.max_dst + 4u * ((t & 1) * SLOT + warp), key);
    if (words) {              // one warp; bits at lanes < Hc (NB = 1)
      const unsigned bhi = __shfl_sync(VIT_FULL, myw, 1);
      if (lane == 0) {
        const int s0 = v.c * Hc, s1 = s0 + v.H;
        const uint32_t base = v.sw_dst + 4u * (t & 1) * VIT_CLUSTER_WORDS;
        vit_or_cluster_u32(base + 4u * (s0 >> 5), myw << (s0 & 31));
        vit_or_cluster_u32(base + 4u * (s1 >> 5), bhi << (s1 & 31));
      }
    }
    if constexpr (CL) vit_cluster_arrive();
    // While the cluster gathers: the stage's survivor words, which only the
    // recursion's closing barrier (or the next stage's) has to publish (one
    // block: before its barrier).
    if (PACK && !words && lane < 2 * NB) {
      const int q0 = v.c * Hc + warp * 32 + T * (lane % NB);
      st.word(t, (lane < NB ? q0 : q0 + v.H) >> 5, myw);
    }
    if constexpr (CL) vit_cluster_wait();
    else __syncthreads();
    if (v.c == 0 && warp == 0) {
      if (pend >= 0) st.argmax(pend, vit_cluster_first_max(v, pend));
      if (words) {
        unsigned* sw = v.sw + (t & 1) * VIT_CLUSTER_WORDS;
        for (int i = lane; i < (v.S + 31) / 32; i += 32) {
          st.word(t, i, sw[i]);
          sw[i] = 0u;
        }
      }
    }
    pend = -1;
    {
      const int* r = v.rmax + (t & 1) * SLOT;
      int k = (int)0x80000000;
      if (lane < v.nw)
        for (int b = 0; b < v.C; ++b) k = max(k, r[32 * b + lane]);
      m = __int_as_float(vit_key(__reduce_max_sync(VIT_FULL, k)));
    }
    if (st.wants_argmax(t)) {
      int a = 0x7fffffff;
      if (mhi == m) a = shi;
      if (mlo == m) a = slo;                  // low states come first
      a = __reduce_min_sync(VIT_FULL, a);
      if constexpr (!CL)
        vit_sts_u32_if(lane == 0, v.arg_dst + 4u * ((t & 1) * SLOT + warp),
                       (unsigned)a);
      else if (lane == 0)
        vit_st_cluster_s32(v.arg_dst + 4u * ((t & 1) * SLOT + warp), a);
      pend = t;
    }
  }
  sync();
  if (pend >= 0 && v.c == 0 && warp == 0)
    st.argmax(pend, vit_cluster_first_max(v, pend));
  sync();
}

// The recursion with the store's survivor format (st.pack) and, for the
// table, whether one metric a butterfly serves its four edges (v.taps)
// constants.
template <int NB, bool TBL, bool CL, class Store>
__device__ __forceinline__ void vit_cluster_run(VitCluster<NB, TBL, CL>& v,
                                                const void* llr, int dtype,
                                                bool bf16,
                                                long long frame_base, int L,
                                                Store& st) {
  if (TBL && v.taps) {
    if (st.pack)
      vit_cluster_recursion<true, true>(v, llr, dtype, bf16, frame_base, L,
                                        st);
    else
      vit_cluster_recursion<false, true>(v, llr, dtype, bf16, frame_base, L,
                                         st);
  } else if (st.pack) {
    vit_cluster_recursion<true, false>(v, llr, dtype, bf16, frame_base, L,
                                       st);
  } else {
    vit_cluster_recursion<false, false>(v, llr, dtype, bf16, frame_base, L,
                                        st);
  }
}

// Calls F::template run_cluster<NB, TBL>(a...) for the cluster
// instantiation that serves (k, beta) on a cluster of C: NB butterflies a
// thread, the compressed table for beta <= 8.
template <class F, class... A>
int vit_dispatch_cluster(int k, int beta, int C, A... a) {
  const bool tbl = beta <= VIT_MAX_BETA;
  switch (vit_cluster_nb(k, C)) {
    case 1: return tbl ? F::template run_cluster<1, true>(a...)
                       : F::template run_cluster<1, false>(a...);
    case 2: return tbl ? F::template run_cluster<2, true>(a...)
                       : F::template run_cluster<2, false>(a...);
    case 4: return tbl ? F::template run_cluster<4, true>(a...)
                       : F::template run_cluster<4, false>(a...);
    case 8: return tbl ? F::template run_cluster<8, true>(a...)
                       : F::template run_cluster<8, false>(a...);
    default: return tbl ? F::template run_cluster<16, true>(a...)
                        : F::template run_cluster<16, false>(a...);
  }
}

// Calls F::template run_block<NB, TBL>(a...) for the one-block
// instantiation that serves (k, beta): NB = vit_block_nb(k, beta)
// butterflies a thread, the compressed table for beta <= 8.
template <class F, class... A>
int vit_dispatch_block(int k, int beta, A... a) {
  const bool tbl = beta <= VIT_MAX_BETA;
  switch (vit_block_nb(k, beta)) {
    case 1: return tbl ? F::template run_block<1, true>(a...)
                       : F::template run_block<1, false>(a...);
    case 2: return tbl ? F::template run_block<2, true>(a...)
                       : F::template run_block<2, false>(a...);
    case 4: return tbl ? F::template run_block<4, true>(a...)
                       : F::template run_block<4, false>(a...);
    case 8: return tbl ? F::template run_block<8, true>(a...)
                       : F::template run_block<8, false>(a...);
    default: return tbl ? F::template run_block<16, true>(a...)
                        : F::template run_block<16, false>(a...);
  }
}

// The launch configuration of `clusters` clusters of C blocks of a k code's
// cluster kernel (the attribute array must outlive it), after setting the
// kernel's shared memory and non-portable cluster size (16 needs it).
// Returns the CUDA error of the attribute calls.
template <class P>
__host__ inline cudaError_t vit_cluster_config(void (*kern)(const P), int k,
                                               int C, int clusters,
                                               cudaStream_t stream,
                                               cudaLaunchAttribute* attr,
                                               cudaLaunchConfig_t* cfg) {
  const long long smem = vit_cluster_smem_bytes(k, C);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)clusters * C, 1, 1);
  cfg->blockDim = dim3(vit_cluster_threads(k, C), 1, 1);
  cfg->dynamicSmemBytes = (size_t)smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return err;
}

// Launches `kern` (a cluster kernel taking P) on `clusters` clusters of C
// blocks: the cluster size is a launch attribute (cudaLaunchKernelEx).
// Returns the launch's CUDA error (0 = ok), cleared from the runtime's
// last error so that it is reported once; a cluster the card cannot hold
// is refused here, never replaced.
template <class P>
__host__ inline int vit_cluster_launch(void (*kern)(const P), const P& p,
                                       int k, int C, int clusters,
                                       cudaStream_t stream) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err =
      vit_cluster_config(kern, k, C, clusters, stream, &attr, &cfg);
  if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, kern, p);
  if (err != cudaSuccess) {
    (void)cudaGetLastError();
    return (int)err;
  }
  return (int)cudaGetLastError();
}

// The clusters of C blocks of `kern` the card keeps resident at once
// (cudaOccupancyMaxActiveClusters) into *out. Returns 0 or the CUDA error.
template <class P>
__host__ inline int vit_cluster_occupancy(void (*kern)(const P), int k,
                                          int C, int* out) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err = vit_cluster_config(kern, k, C, 1, 0, &attr, &cfg);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(out, kern, &cfg);
  if (err != cudaSuccess) (void)cudaGetLastError();
  return (int)err;
}

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
