// Forward-only Viterbi kernel for Hopper (sm_90a): the split path's first
// half, the prior-work baseline of the paper's Table I (row b). Branch
// metrics and ACS as in the unified kernel, but every stage's survivors and
// argmax state are streamed to device memory, for a separate traceback
// kernel (traceback_frames.cu) to read back.
//
// Replaces the TPU kernel repro.kernels.viterbi_fwd.forward_frames
// (src/repro/kernels/viterbi_fwd.py, pl.pallas_call at :114, body _kernel
// at :44-69). Plain version: forward_frames_plain in
// repro_torch/kernels/viterbi_fwd.py, which the outputs equal element for
// element, in shape, dtype and orientation.
//
// Outputs, as the JAX kernel lays them out (F = the padded frame count):
//   lane     packed  sel (F, L, W) int32    unpacked (F, L, S) int8
//   sublane  packed  sel (L*W, F) int32     unpacked (L, S, F) int8
//   amax (F, L) int32 in both layouts: the first maximal state per stage.
//
// What bounds it. The ACS recursion is the unified kernel's (acs.cuh: the
// two kernels include one recursion and cannot drift apart), about six
// float32 operations per state and stage. Unlike the unified kernel, this
// one writes the survivor stream and an argmax per stage to device memory:
// at K=7 packed that is as many bytes out as LLR bytes in, plus half as
// many again of argmax, so its bound is on the bytes side. In practice the
// latency of the per-stage exchange still rules, as in the unified kernel.
//
// Design: the unified kernel's mapping. One thread per state (S < 32 is
// padded to a warp), a few frames per block, path metrics double-buffered
// in shared memory, two __syncthreads per stage. The survivor word of a
// warp is its __ballot_sync (packing.py's LANE word: state s at bit s % 32
// of word s / 32; S < 32 gives one zero-padded word), written by lane 0;
// unpacked, each state writes its byte. The argmax of every stage: after
// normalisation sigma - max(sigma) is exactly 0 only at the maximal
// states, so each warp ballots (v == max) into shared memory, and after the
// stage's second barrier the frame's first thread takes the first set bit
// over its warps' words (JAX's argmax: the first maximal state) and writes
// it. `radix` 4 unrolls two exact radix-2 stages per loop step.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "acs.cuh"

namespace {

struct FwdParams {
  const void* llr;          // (F, L, beta) f32 | bf16 | f16
  const int* idx;           // (2, S) compressed BM word of edge p into j
  const float* sgn;         // (2, S) its sign
  const float* signs_half;  // (half, beta)
  void* sel;                // survivor stream, see above
  int* amax;                // (F, L)
  int F, L, k, llr_dtype, pack, sublane, radix, bf16_bm, fpb;
};

struct FwdSmem {
  long long sig, red, hit, total;
};

// Shared-memory carve-up of one block of fpb frames.
__host__ __device__ inline FwdSmem fwd_smem(int k, int fpb) {
  const int S = 1 << (k - 1);
  const int tpf = S < 32 ? 32 : S;
  const int nw = tpf >> 5;
  FwdSmem s;
  s.sig = 0;                                       // [2][fpb][tpf] f32
  s.red = s.sig + 2LL * fpb * tpf * 4;             // [fpb][nw] f32
  s.hit = s.red + (long long)fpb * nw * 4;         // [fpb][nw] u32
  s.total = s.hit + (long long)fpb * nw * 4;
  return s;
}

template <int BETA>
__global__ void __launch_bounds__(1024) viterbi_fwd_kernel(const FwdParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = 1 << (p.k - 1);
  const int tpf = S < 32 ? 32 : S;
  const int nw = tpf >> 5;                 // warps per frame
  const int W = (S + 31) >> 5;             // packed words per stage
  const int lf = threadIdx.x / tpf;        // frame within the block
  const int j = threadIdx.x - lf * tpf;    // state
  const int lane = threadIdx.x & 31;
  const int wf = j >> 5;                   // warp within the frame
  const bool svalid = j < S;
  const long long frame = (long long)blockIdx.x * p.fpb + lf;
  const bool fvalid = frame < p.F;
  const bool bf16 = p.bf16_bm != 0;
  const FwdSmem lay = fwd_smem(p.k, p.fpb);

  float* sig = reinterpret_cast<float*>(smem + lay.sig);
  float* red = reinterpret_cast<float*>(smem + lay.red) + lf * nw;
  uint32_t* hitw = reinterpret_cast<uint32_t*>(smem + lay.hit) + lf * nw;
  uint32_t* sel32 = static_cast<uint32_t*>(p.sel);
  int8_t* sel8 = static_cast<int8_t*>(p.sel);
  int* amax = p.amax + frame * p.L;

  VitEdges e = {};
  if (svalid) e = vit_load_edges(p.idx, p.sgn, p.signs_half, j, S, BETA);

  const long long lbase = frame * p.L * BETA;
  float x[BETA], xn[BETA];
#pragma unroll
  for (int b = 0; b < BETA; ++b)
    x[b] = fvalid ? vit_load_llr(p.llr, p.llr_dtype, lbase + b) : 0.f;
  sig[lf * tpf + j] = 0.f;
  __syncthreads();

  int cur = 0;
  const int bstride = p.fpb * tpf;

  // The argmax of stage t - 1, from the hit words its second barrier made
  // visible; they are overwritten only after this stage's first barrier.
  auto write_amax = [&](int t) {
    if (j == 0 && fvalid) {
      int a = 0;
      for (int w = 0; w < nw; ++w) {
        const unsigned h = hitw[w];
        if (h) {
          a = (w << 5) + __ffs(h) - 1;
          break;
        }
      }
      amax[t] = a;
    }
  };

  auto stage = [&](int t) {
#pragma unroll
    for (int b = 0; b < BETA; ++b)
      xn[b] = (fvalid && t + 1 < p.L)
                  ? vit_load_llr(p.llr, p.llr_dtype,
                                 lbase + (long long)(t + 1) * BETA + b)
                  : 0.f;
    if (t > 0) write_amax(t - 1);
    const float* sc = sig + cur * bstride + lf * tpf;
    float* sn = sig + (cur ^ 1) * bstride + lf * tpf;
    bool s = false;
    float v = -INFINITY;
    if (svalid) v = vit_acs<BETA>(sc, j, S, e, x, bf16, &s);
    const float wmax = vit_warp_max(v);
    if (lane == 0) red[wf] = wmax;
    const unsigned bal = __ballot_sync(0xffffffffu, s);
    if (fvalid) {
      if (p.pack) {
        if (lane == 0) {
          const long long o = p.sublane
                                  ? ((long long)t * W + wf) * p.F + frame
                                  : (frame * p.L + t) * W + wf;
          sel32[o] = bal;
        }
      } else if (svalid) {
        const long long o = p.sublane ? ((long long)t * S + j) * p.F + frame
                                      : (frame * p.L + t) * S + j;
        sel8[o] = s ? 1 : 0;
      }
    }
    __syncthreads();
    float m = red[0];
    for (int w = 1; w < nw; ++w) m = fmaxf(m, red[w]);
    const unsigned hit = __ballot_sync(0xffffffffu, svalid && v == m);
    if (lane == 0) hitw[wf] = hit;
    sn[j] = v - m;                                      // normalise
    __syncthreads();
    cur ^= 1;
#pragma unroll
    for (int b = 0; b < BETA; ++b) x[b] = xn[b];
  };

  int t = 0;
  if (p.radix == 4) {
    for (; t + 1 < p.L; t += 2) {
      stage(t);
      stage(t + 1);
    }
  }
  for (; t < p.L; ++t) stage(t);
  write_amax(p.L - 1);
}

template <int BETA>
int launch(const FwdParams& p, long long smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        viterbi_fwd_kernel<BETA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int S = 1 << (p.k - 1);
  const int tpf = S < 32 ? 32 : S;
  const int grid = (p.F + p.fpb - 1) / p.fpb;
  viterbi_fwd_kernel<BETA><<<grid, p.fpb * tpf, (size_t)smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block of fpb frames.
long long viterbi_fwd_smem_bytes(int k, int fpb) {
  return fwd_smem(k, fpb).total;
}

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = ok).
int viterbi_fwd_launch(const void* llr, const void* idx, const void* sgn,
                       const void* signs_half, void* sel, void* amax, int F,
                       int L, int beta, int k, int llr_dtype, int pack,
                       int sublane, int radix, int bf16_bm, int fpb,
                       void* stream) {
  const int S = 1 << (k - 1);
  const int tpf = S < 32 ? 32 : S;
  if (k < 2 || k > 11 || beta < 2 || beta > VIT_MAX_BETA || fpb < 1 ||
      fpb * tpf > 1024 || F < 1 || L < 1)
    return (int)cudaErrorInvalidValue;
  FwdParams p;
  p.llr = llr;
  p.idx = static_cast<const int*>(idx);
  p.sgn = static_cast<const float*>(sgn);
  p.signs_half = static_cast<const float*>(signs_half);
  p.sel = sel;
  p.amax = static_cast<int*>(amax);
  p.F = F;
  p.L = L;
  p.k = k;
  p.llr_dtype = llr_dtype;
  p.pack = pack;
  p.sublane = sublane;
  p.radix = radix;
  p.bf16_bm = bf16_bm;
  p.fpb = fpb;
  const long long smem = fwd_smem(k, fpb).total;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (beta) {              // one instantiation per code rate 1/beta
    case 2: return launch<2>(p, smem, s);
    case 3: return launch<3>(p, smem, s);
    case 4: return launch<4>(p, smem, s);
    case 5: return launch<5>(p, smem, s);
    case 6: return launch<6>(p, smem, s);
    case 7: return launch<7>(p, smem, s);
    default: return launch<8>(p, smem, s);
  }
}

}  // extern "C"
