// Unified Viterbi decode kernel for Hopper (sm_90a): branch metrics, ACS and
// parallel traceback in one launch, with the survivors kept in shared memory.
//
// Replaces the TPU kernel repro.kernels.viterbi_unified.unified_decode_frames
// (src/repro/kernels/viterbi_unified.py, pl.pallas_call at :199, body
// _kernel at :72-146). Plain version: unified_decode_frames_plain in
// repro_torch/kernels/viterbi_unified.py, which the outputs equal bit for bit.
//
// What bounds it. Per frame the work is an L-stage recursion in which every
// stage depends on the previous one: about six float32 operations per state
// and stage, a max over the frame's S states, and a butterfly exchange of
// path metrics between states. Bytes are few (each LLR is read once, each
// bit written once), so the bound is on the operations side, and in
// practice on the latency of the per-stage exchange.
//
// Design. One thread per state (S < 32 is padded to a warp), a few frames
// per thread block. Path metrics sit in shared memory, double-buffered, and
// two __syncthreads per stage separate the max reduction and the exchange.
// Survivors never touch device memory: per stage one __ballot_sync word per
// warp (state s at bit s % 32 of word s / 32, packing.py's LANE word) or
// one byte per state. Only the argmax at the traceback start stages is
// kept, as ballot words of the states that reach the frame's max; the
// first set bit is the first maximal state. Then nsub = f / f0 traceback
// cursors per frame, one per thread, chase the survivors in shared memory.
// Each stage's LLRs are fetched one stage ahead into registers.
//
// When one frame's survivors exceed the shared memory a block can have
// (unpacked K=7 survivors of one f=4096 frame need L*S ~ 266 KB), the same
// kernel keeps survivors and argmax words in a device-memory scratch that
// the wrapper allocates: slower, but it decodes every shape JAX decodes.
//
// `radix` 4 unrolls two exact radix-2 stages per loop step; `layout` is a
// TPU orientation knob and is not passed here. Both decode identically.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "acs.cuh"

namespace {

struct UnifiedParams {
  const void* llr;            // (F, L, beta) f32 | bf16 | f16
  const int* idx;             // (2, S) compressed BM word of edge p into j
  const float* sgn;           // (2, S) its sign
  const float* signs_half;    // (half, beta)
  int* out;                   // (F, f) decoded bits
  unsigned char* sel_global;  // survivor scratch, or null for shared memory
  uint32_t* amax_global;      // argmax-word scratch (with sel_global)
  int F, L, beta, k, v1, f, f0, v2s, nsub;
  int llr_dtype, start_fixed, pack, radix, bf16_bm, fpb;
};

struct SmemLayout {
  long long sig, red, am, sel, total;
};

// Shared-memory carve-up of one block of fpb frames. row = survivor bytes
// per stage (4*W packed, S unpacked).
__host__ __device__ inline SmemLayout smem_layout(int k, int L, int nsub,
                                                  int pack, int start_fixed,
                                                  int fpb, int global) {
  const int S = 1 << (k - 1);
  const int tpf = S < 32 ? 32 : S;
  const int W = (S + 31) >> 5;
  const long long row = pack ? 4LL * W : S;
  SmemLayout s;
  s.sig = 0;                                           // [2][fpb][tpf] f32
  s.red = s.sig + 2LL * fpb * tpf * 4;                 // [fpb][tpf/32] f32
  s.am = s.red + (long long)fpb * (tpf >> 5) * 4;      // [fpb][nsub][W] u32
  s.sel = s.am + (global || start_fixed ? 0 : (long long)fpb * nsub * W * 4);
  s.total = s.sel + (global ? 0 : (long long)fpb * L * row);
  return s;
}

template <int BETA>
__global__ void __launch_bounds__(1024)
    viterbi_unified_kernel(const UnifiedParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = 1 << (p.k - 1);
  const int tpf = S < 32 ? 32 : S;
  const int nw = tpf >> 5;                 // warps per frame
  const int W = (S + 31) >> 5;             // packed words per stage
  const int kshift = p.k - 2;
  const int lf = threadIdx.x / tpf;        // frame within the block
  const int j = threadIdx.x - lf * tpf;    // state
  const int lane = threadIdx.x & 31;
  const int wf = j >> 5;                   // warp within the frame
  const bool svalid = j < S;
  const long long frame = (long long)blockIdx.x * p.fpb + lf;
  const bool fvalid = frame < p.F;
  const bool bf16 = p.bf16_bm != 0;
  const long long row = p.pack ? 4LL * W : S;
  const int global = p.sel_global != nullptr;
  const SmemLayout lay =
      smem_layout(p.k, p.L, p.nsub, p.pack, p.start_fixed, p.fpb, global);

  float* sig = reinterpret_cast<float*>(smem + lay.sig);
  float* red = reinterpret_cast<float*>(smem + lay.red) + lf * nw;
  unsigned char* sel;
  uint32_t* am;
  if (global) {                            // scratch holds gridDim*fpb frames
    sel = p.sel_global + frame * p.L * row;
    am = p.amax_global + frame * p.nsub * W;
  } else {
    sel = smem + lay.sel + (long long)lf * p.L * row;
    am = reinterpret_cast<uint32_t*>(smem + lay.am) + lf * p.nsub * W;
  }

  VitEdges e = {};
  if (svalid) e = vit_load_edges(p.idx, p.sgn, p.signs_half, j, S, BETA);

  // ---- phases 1+2: branch metrics + ACS; survivors stay on chip ----------
  const long long lbase = frame * p.L * BETA;
  float x[BETA], xn[BETA];
#pragma unroll
  for (int b = 0; b < BETA; ++b)
    x[b] = fvalid ? vit_load_llr(p.llr, p.llr_dtype, lbase + b) : 0.f;
  sig[lf * tpf + j] = 0.f;
  __syncthreads();

  int cur = 0;
  int q = 0;                                   // next traceback start
  int next_e = p.v1 + p.f0 - 1 + p.v2s;        // its stage
  const int bstride = p.fpb * tpf;

  auto stage = [&](int t) {
#pragma unroll
    for (int b = 0; b < BETA; ++b)
      xn[b] = (fvalid && t + 1 < p.L)
                  ? vit_load_llr(p.llr, p.llr_dtype,
                                 lbase + (long long)(t + 1) * BETA + b)
                  : 0.f;
    const float* sc = sig + cur * bstride + lf * tpf;
    float* sn = sig + (cur ^ 1) * bstride + lf * tpf;
    bool s = false;
    float v = -INFINITY;
    if (svalid) v = vit_acs<BETA>(sc, j, S, e, x, bf16, &s);
    const float wmax = vit_warp_max(v);
    if (lane == 0) red[wf] = wmax;
    const unsigned bal = __ballot_sync(0xffffffffu, s);
    if (p.pack) {
      if (lane == 0) reinterpret_cast<uint32_t*>(sel + t * row)[wf] = bal;
    } else if (svalid) {
      sel[t * row + j] = s ? 1 : 0;
    }
    __syncthreads();
    float m = red[0];
    for (int w = 1; w < nw; ++w) m = fmaxf(m, red[w]);
    if (!p.start_fixed && q < p.nsub && t == next_e) {  // block-uniform
      const unsigned hit = __ballot_sync(0xffffffffu, svalid && v == m);
      if (lane == 0) am[q * W + wf] = hit;
      ++q;
      next_e += p.f0;
    }
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

  // ---- phase 3: nsub traceback cursors per frame, one per thread ---------
  // (the last __syncthreads made every survivor of the block visible)
  const int T = p.f0 + p.v2s;
  const int ncur = p.fpb * p.nsub;
  for (int c = threadIdx.x; c < ncur; c += blockDim.x) {
    const int lf2 = c / p.nsub;
    const int q2 = c - lf2 * p.nsub;
    const long long fr2 = (long long)blockIdx.x * p.fpb + lf2;
    if (fr2 >= p.F) continue;
    const unsigned char* sel2;
    const uint32_t* am2;
    if (global) {
      sel2 = p.sel_global + fr2 * p.L * row;
      am2 = p.amax_global + fr2 * p.nsub * W;
    } else {
      sel2 = smem + lay.sel + (long long)lf2 * p.L * row;
      am2 = reinterpret_cast<const uint32_t*>(smem + lay.am) +
            lf2 * p.nsub * W;
    }
    int state = 0;                                      // start = "fixed"
    if (!p.start_fixed) {                               // first maximal state
      for (int w = 0; w < W; ++w) {
        const unsigned h = am2[q2 * W + w];
        if (h) {
          state = (w << 5) + __ffs(h) - 1;
          break;
        }
      }
    }
    const int e2 = p.v1 + (q2 + 1) * p.f0 - 1 + p.v2s;
    int* o = p.out + fr2 * p.f + (long long)q2 * p.f0;
    for (int r = 0; r < T; ++r) {
      const long long ts = e2 - r;
      if (r >= p.v2s) o[p.f0 - 1 - (r - p.v2s)] = state >> kshift;
      int bit;
      if (p.pack)
        bit = (reinterpret_cast<const uint32_t*>(sel2 + ts * row)[state >> 5] >>
               (state & 31)) & 1;
      else
        bit = sel2[ts * row + state];
      state = ((state << 1) & (S - 1)) | bit;
    }
  }
}

template <int BETA>
int launch(const UnifiedParams& p, long long smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        viterbi_unified_kernel<BETA>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int S = 1 << (p.k - 1);
  const int tpf = S < 32 ? 32 : S;
  const int grid = (p.F + p.fpb - 1) / p.fpb;
  viterbi_unified_kernel<BETA>
      <<<grid, p.fpb * tpf, (size_t)smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block of fpb frames (global_scratch != 0:
// survivors and argmax words live in device memory instead).
long long viterbi_unified_smem_bytes(int k, int L, int nsub, int pack,
                                     int start_fixed, int fpb,
                                     int global_scratch) {
  return smem_layout(k, L, nsub, pack, start_fixed, fpb, global_scratch)
      .total;
}

// The limits the tile planner (kernels/autotune.py) models, for `device`:
// out = {opt-in shared memory per block, shared memory per SM, threads per
// SM, resident blocks per SM, shared memory the runtime reserves per
// block}. Returns 0, or the CUDA error of the first query that fails.
int viterbi_device_limits(int device, int* out) {
  const cudaDeviceAttr attrs[5] = {
      cudaDevAttrMaxSharedMemoryPerBlockOptin,
      cudaDevAttrMaxSharedMemoryPerMultiprocessor,
      cudaDevAttrMaxThreadsPerMultiProcessor,
      cudaDevAttrMaxBlocksPerMultiprocessor,
      cudaDevAttrReservedSharedMemoryPerBlock};
  for (int i = 0; i < 5; ++i) {
    const cudaError_t err = cudaDeviceGetAttribute(&out[i], attrs[i], device);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = ok).
int viterbi_unified_launch(const void* llr, const void* idx, const void* sgn,
                           const void* signs_half, void* out,
                           void* sel_global, void* amax_global, int F, int L,
                           int beta, int k, int v1, int f, int f0, int v2s,
                           int llr_dtype, int start_fixed, int pack,
                           int radix, int bf16_bm, int fpb, void* stream) {
  const int S = 1 << (k - 1);
  const int tpf = S < 32 ? 32 : S;
  if (k < 2 || k > 11 || beta < 2 || beta > VIT_MAX_BETA || fpb < 1 ||
      fpb * tpf > 1024 || f0 < 1 || f % f0 != 0 || F < 1 ||
      (sel_global == nullptr) != (amax_global == nullptr))
    return (int)cudaErrorInvalidValue;
  UnifiedParams p;
  p.llr = llr;
  p.idx = static_cast<const int*>(idx);
  p.sgn = static_cast<const float*>(sgn);
  p.signs_half = static_cast<const float*>(signs_half);
  p.out = static_cast<int*>(out);
  p.sel_global = static_cast<unsigned char*>(sel_global);
  p.amax_global = static_cast<uint32_t*>(amax_global);
  p.F = F;
  p.L = L;
  p.beta = beta;
  p.k = k;
  p.v1 = v1;
  p.f = f;
  p.f0 = f0;
  p.v2s = v2s;
  p.nsub = f / f0;
  p.llr_dtype = llr_dtype;
  p.start_fixed = start_fixed;
  p.pack = pack;
  p.radix = radix;
  p.bf16_bm = bf16_bm;
  p.fpb = fpb;
  const long long smem = smem_layout(k, L, p.nsub, pack, start_fixed, fpb,
                                     sel_global != nullptr).total;
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
