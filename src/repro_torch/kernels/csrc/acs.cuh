// Branch metrics + add-compare-select: the device functions shared by the
// port's Viterbi kernels.
//
// CUDA counterpart of repro.kernels.acs.acs_scan (the JAX package's shared
// Pallas body) and of the plain torch acs_scan in repro_torch/kernels/acs.py.
// The unified kernel and the split path's forward kernel both include this
// header, so the two kernels run one recursion and cannot drift apart.
//
// Arithmetic, held bit for bit against the plain version:
//   bm(h)  = sum_b signs_half[h][b] * llr[b], over b in order, in float32,
//            rounded once to bfloat16 (nearest even) when bm_dtype is bf16.
//            The signs are +-1, so every product is exact: the kernel
//            negates instead of multiplying.
//   cand_p = sigma[((j << 1) & (S-1)) | p] + sgn_p[j] * bm(idx_p[j])
//   sel    = cand1 >= cand0          (ties go to predecessor 1)
//   sigma' = sel ? cand1 : cand0, then minus the frame's max, every stage.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#define VIT_MAX_BETA 8

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

// The two incoming edges of one state j: which terms of their compressed
// branch-metric words are negated (bit b set where signs_half[idx_p[j]][b]
// is -1) and their signs sgn_p[j].
struct VitEdges {
  unsigned neg0, neg1;
  float sgn0, sgn1;
};

__device__ __forceinline__ VitEdges vit_load_edges(const int* idx,
                                                   const float* sgn,
                                                   const float* signs_half,
                                                   int j, int S, int beta) {
  VitEdges e;
  const int i0 = idx[j], i1 = idx[S + j];
  e.neg0 = e.neg1 = 0u;
  for (int b = 0; b < beta; ++b) {
    e.neg0 |= (signs_half[i0 * beta + b] < 0.f ? 1u : 0u) << b;
    e.neg1 |= (signs_half[i1 * beta + b] < 0.f ? 1u : 0u) << b;
  }
  e.sgn0 = sgn[j];
  e.sgn1 = sgn[S + j];
  return e;
}

// Compressed branch metric of one word (eq. 9) from one stage's LLRs x:
// sum_b (+-1) * x[b] in b order; a product with -1 is the exact negation.
template <int BETA>
__device__ __forceinline__ float vit_bm(unsigned neg, const float* x,
                                        bool bf16) {
  float acc = (neg & 1u) ? -x[0] : x[0];
#pragma unroll
  for (int b = 1; b < BETA; ++b) acc = acc + (((neg >> b) & 1u) ? -x[b] : x[b]);
  if (bf16) acc = __bfloat162float(__float2bfloat16_rn(acc));
  return acc;
}

// One radix-2 ACS half-step for state j: returns the surviving candidate
// (not yet normalised) and its selector.
template <int BETA>
__device__ __forceinline__ float vit_acs(const float* sigma, int j, int S,
                                         const VitEdges& e, const float* x,
                                         bool bf16, bool* sel) {
  const int base = (j << 1) & (S - 1);
  const float c0 = sigma[base] + e.sgn0 * vit_bm<BETA>(e.neg0, x, bf16);
  const float c1 = sigma[base | 1] + e.sgn1 * vit_bm<BETA>(e.neg1, x, bf16);
  *sel = c1 >= c0;
  return *sel ? c1 : c0;
}

// Max over the 32 lanes of a warp (every lane takes part).
__device__ __forceinline__ float vit_warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
