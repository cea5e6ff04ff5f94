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
// two kernels include one recursion and cannot drift apart). Unlike the
// unified kernel, this one writes the survivor stream and an argmax per
// stage to device memory: at K=7 packed that is as many bytes out as LLR
// bytes in, plus half as many again of argmax, so its bound is on the
// bytes side. What the card reaches is set, as in the unified kernel, by
// the instructions per stage (here also the argmax's redux every stage) and
// the resident frames that hide each stage's dependent chain.
//
// Design: the unified kernel's mapping, one warp per frame (32 / S frames
// per warp for S < 32) with the path metrics in registers and nothing
// block-wide in the stage loop. Every stage's first maximal state is one
// redux.sync min over the lanes' first hits. The segment's first lane
// stages it, and the stage's R survivor words, in the warp's run buffers
// in shared memory (256 bytes a warp); after each run of 32 / R stages a
// __syncwarp, and every lane stores one word and one argmax: the lane
// stream's words of a run are one contiguous 128-byte row, its argmax one
// row of 128 / R bytes; in the sublane stream each lane's word goes to its
// own row of frames. Unpacked, each lane writes its states' bytes every
// stage, 32 neighbouring bytes per warp in the lane stream. `radix` 4 and 2
// run the same loop (the wrapper checks it; the card never sees it); the
// kernel inlines one loop per bm_dtype.
//
// Rates below 1/8 (beta > 8) run the same mapping with beta at run time
// (VitFrame<R, 0>): each butterfly's encoder word in a register, the LLRs
// staged a chunk at a time in the warp's shared memory after the block's
// run buffers; but K=9 (VIT_FWD_WIDE_K) past beta = 8 runs the wide
// mapping below.
//
// Codes 12 <= k <= 15 run the one-block form of acs.cuh's VitCluster
// instead, in kernels of their own (viterbi_fwd_block_kernel, the
// butterfly table at beta <= 8; viterbi_fwd_block_pe_kernel, per-edge sums
// past it): one frame a block
// of vit_block_threads(k, beta) threads, path metrics in shared
// memory, the grid the blocks the card keeps resident, each taking frames
// in turn. It stores as the cluster kernel does: lane i of a warp the
// survivor word of its butterfly run i, every thread its states' bytes
// unpacked, warp 0 each stage's first maximal state, known during the next
// stage.
//
// Every other code (k >= 16, and K=9 past beta = 8) runs acs.cuh's wide
// mapping, in a third kernel (viterbi_fwd_wide_kernel): one block a frame,
// k and beta at run time, path metrics in a device-memory scratch. It
// stores as the large-code kernel does (packed: lane 0 of each warp its
// words; unpacked: every thread its states' bytes; warp 0 the first
// maximal state). A block decodes frames blockIdx.x, + gridDim.x, ...;
// its path-metric scratch is its own. Codes 16 <= k <= 19 run it on a
// thread-block cluster instead (a fourth kernel,
// viterbi_fwd_cluster_kernel, acs.cuh's VitCluster): one frame a cluster
// of 2^(k-15) blocks, the path metrics in the cluster's shared memory,
// each block storing its butterflies' survivors and block 0 each stage's
// first maximal state.

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
  const int* polys;         // (beta,) generator polynomials (wide mapping)
  float* pm_global;         // wide mapping past k = 15: [grid][2][S]
  int F, L, k, beta, llr_dtype, pack, sublane, bf16_bm, fpb;
};

// What the forward kernel keeps of each stage: its first maximal state and
// its survivors. The segment's first lane stages both in the warp's run
// buffers in shared memory (R words in one vector store, one int); at the
// end of each run every lane stores one word and one argmax of them, so a
// run leaves as contiguous rows. Unpacked survivors go out as bytes every
// stage.
template <int R, int BETA>
struct FwdStore {
  const VitFrame<R, BETA>& fr;
  uint32_t run_w;            // this warp's 32 staged words (shared address)
  uint32_t run_a;            // this warp's 32 staged argmax
  uint32_t* sel32;
  int8_t* sel8;
  int* amax;                 // this frame's (L,) row
  long long frame;
  int F, L, S, pack, sublane;
  bool fvalid;
  __device__ __forceinline__ void stage(int t, int u,
                                        const unsigned (&w)[R]) {
    const int a = fr.first_max();
    const bool first = fr.l == 0;
    vit_sts_u32_if(first, run_a + 4 * (fr.segbase + u), a);
    if (pack) vit_sts_words_if<R>(first, run_w + 4 * (fr.segbase + u * R), w);
    if (!pack && fvalid) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const long long s = fr.lanes() * r + fr.l;
        const long long o = sublane ? ((long long)t * S + s) * F + frame
                                    : (frame * L + t) * S + s;
        sel8[o] = (int8_t)((w[r] >> fr.l) & 1u);
      }
    }
  }
  __device__ __forceinline__ void run_end(int t0, int n) {
    __syncwarp();                           // the run's staged values
    if (fvalid) {
      const int slot = 4 * (fr.segbase + fr.l);
      if (fr.l < n) amax[t0 + fr.l] = (int)vit_lds_u32(run_a + slot);
      if (pack && fr.l < n * R) {
        const long long i = (long long)t0 * R + fr.l;    // word of the frame
        sel32[sublane ? i * F + frame : frame * L * R + i] =
            vit_lds_u32(run_w + slot);
      }
    }
    __syncwarp();                           // read before the next run
  }
};

template <int R, int BETA>
__global__ void __launch_bounds__(VIT_BLOCK_THREADS)
    viterbi_fwd_kernel(const FwdParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  VitFrame<R, BETA> fr;
  if constexpr (BETA == 0)
    fr.init(p.k, p.beta, p.polys);
  else
    fr.init(p.k, p.idx, p.sgn, p.signs_half);
  const int warp = threadIdx.x >> 5;
  const int fpw = 32 / fr.P;               // frames per warp
  const int lf = warp * fpw + fr.segbase / fr.P;
  const long long frame = (long long)blockIdx.x * p.fpb + lf;
  const bool fvalid = lf < p.fpb && frame < p.F;
  const uint32_t run =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem)) + warp * 256;
  FwdStore<R, BETA> st{fr, run, run + 128,
                       static_cast<uint32_t*>(p.sel),
                       static_cast<int8_t*>(p.sel), p.amax + frame * p.L,
                       frame, p.F, p.L, 1 << (p.k - 1), p.pack, p.sublane,
                       fvalid};
  if constexpr (BETA == 0) {
    const long long base = frame * p.L * p.beta;
    float* buf = reinterpret_cast<float*>(
        smem + (blockDim.x >> 5) * 256 + warp * vit_llr_chunk_bytes(p.beta));
    if (p.bf16_bm)        // one inlined loop per bm_dtype
      vit_recursion_rt(fr, p.llr, p.llr_dtype, true, base, p.L, fvalid,
                       p.beta, buf, st);
    else
      vit_recursion_rt(fr, p.llr, p.llr_dtype, false, base, p.L, fvalid,
                       p.beta, buf, st);
  } else {
    const long long base = frame * p.L * BETA;
    if (p.bf16_bm)        // one inlined loop per bm_dtype
      vit_recursion(fr, p.llr, p.llr_dtype, true, base, p.L, fvalid, st);
    else
      vit_recursion(fr, p.llr, p.llr_dtype, false, base, p.L, fvalid, st);
  }
}

// ---- every other code: one frame a block, acs.cuh's VitWide -------------

// What the wide kernel keeps of each stage: packed, lane 0 of each warp
// stores its words (VitWideWords); unpacked, every thread its states'
// bytes; warp 0 the stage's first maximal state.
struct FwdWideStore {
  uint32_t* sel32;
  int8_t* sel8;
  int* amax;                 // this frame's (L,) row
  long long frame;
  int F, L, S, W, H, pack, sublane;
  __device__ __forceinline__ bool wants_argmax(int) const { return true; }
  __device__ __forceinline__ bool argmax_at(int) const { return true; }
  __device__ __forceinline__ void argmax(int t, int a) {
    if ((threadIdx.x & 31) == 0) amax[t] = a;
  }
  __device__ __forceinline__ void put8(int t, int s, bool v) {
    const long long o = sublane ? ((long long)t * S + s) * F + frame
                                : (frame * L + t) * S + s;
    sel8[o] = (int8_t)v;
  }
  __device__ __forceinline__ void put32(int t, int wi, unsigned v) {
    const long long i = (long long)t * W + wi;
    sel32[sublane ? i * F + frame : frame * L * W + i] = v;
  }
  __device__ __forceinline__ void word(int t, int i, unsigned w) {
    put32(t, i, w);
  }
  __device__ __forceinline__ void butterfly(int t, int q, bool valid,
                                            bool slo, bool shi, unsigned blo,
                                            unsigned bhi) {
    if (pack) {
      if ((threadIdx.x & 31) == 0) {
        const VitWideWords w(H, q, blo, bhi);
        put32(t, w.i0, w.w0);
        if (w.n == 2) put32(t, w.i1, w.w1);
      }
    } else if (valid) {
      put8(t, q, slo);
      put8(t, q + H, shi);
    }
  }
};

__global__ void __launch_bounds__(VIT_WIDE_MAX_THREADS)
    viterbi_fwd_wide_kernel(const FwdParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = 1 << (p.k - 1);
  VitWide w;
  w.init(p.k, p.beta, p.polys, smem,
         p.pm_global != nullptr ? p.pm_global + blockIdx.x * 2LL * S
                                : nullptr);
  for (long long frame = blockIdx.x; frame < p.F; frame += gridDim.x) {
    FwdWideStore st{static_cast<uint32_t*>(p.sel),
                    static_cast<int8_t*>(p.sel), p.amax + frame * p.L,
                    frame, p.F, p.L, S, (S + 31) / 32, S >> 1, p.pack,
                    p.sublane};
    const long long base = frame * p.L * p.beta;
    if (p.bf16_bm)        // one inlined loop per bm_dtype
      vit_wide_recursion(w, p.llr, p.llr_dtype, true, base, p.L, st);
    else
      vit_wide_recursion(w, p.llr, p.llr_dtype, false, base, p.L, st);
  }
}

// ---- 16 <= k <= 19: one frame a cluster, acs.cuh's VitCluster -----------

// The wide kernel's work on a cluster of blocks: each block
// stores its butterflies' survivors as the wide kernel does, block 0's
// warp 0 each stage's first maximal state.
template <int NB, bool TBL>
__global__ void __launch_bounds__(VIT_CLUSTER_THREADS, 1)
    viterbi_fwd_cluster_kernel(const FwdParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = 1 << (p.k - 1);
  VitCluster<NB, TBL> v;
  v.init(p.k, p.beta, p.polys, smem);
  for (long long frame = vit_cluster_id(); frame < p.F;
       frame += vit_cluster_count()) {
    FwdWideStore st{static_cast<uint32_t*>(p.sel),
                    static_cast<int8_t*>(p.sel), p.amax + frame * p.L,
                    frame, p.F, p.L, S, (S + 31) / 32, S >> 1, p.pack,
                    p.sublane};
    const long long base = frame * p.L * p.beta;
    vit_cluster_run(v, p.llr, p.llr_dtype, p.bf16_bm != 0, base, p.L, st);
  }
}

// ---- 12 <= k <= 15: one frame a block, acs.cuh's VitCluster on one block --

// The cluster kernel's work on one block, which takes frames blockIdx.x, +
// gridDim.x, ....
template <int NB, bool TBL>
__device__ __forceinline__ void fwd_block(const FwdParams& p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = 1 << (p.k - 1);
  VitCluster<NB, TBL, false> v;
  v.init(p.k, p.beta, p.polys, smem);
  for (long long frame = blockIdx.x; frame < p.F; frame += gridDim.x) {
    FwdWideStore st{static_cast<uint32_t*>(p.sel),
                    static_cast<int8_t*>(p.sel), p.amax + frame * p.L,
                    frame, p.F, p.L, S, S / 32, S >> 1, p.pack, p.sublane};
    const long long base = frame * p.L * p.beta;
    vit_cluster_run(v, p.llr, p.llr_dtype, p.bf16_bm != 0, base, p.L, st);
  }
}

// The table (beta <= 8), one instantiation per NB.
template <int NB>
__global__ void __launch_bounds__(VIT_CLUSTER_THREADS)
    viterbi_fwd_block_kernel(const FwdParams p) {
  fwd_block<NB, true>(p);
}

// The per-edge sums (beta > 8): at most 4 butterflies a thread (k = 12, 13)
// built for two blocks an SM (64 registers), else one.
template <int NB>
__global__ void __launch_bounds__(VIT_CLUSTER_THREADS, NB <= 4 ? 2 : 1)
    viterbi_fwd_block_pe_kernel(const FwdParams p) {
  fwd_block<NB, false>(p);
}

using BlockKernel = void (*)(const FwdParams);

// The one-block kernel of NB butterflies a thread, table or per-edge sums.
template <int NB, bool TBL>
inline BlockKernel block_kernel() {
  if constexpr (TBL)
    return viterbi_fwd_block_kernel<NB>;
  else
    return viterbi_fwd_block_pe_kernel<NB>;
}

struct LaunchBlock {
  template <int NB, bool TBL>
  static int run_block(const FwdParams* p, int grid, cudaStream_t stream) {
    const long long smem = vit_block_smem_bytes(p->k);
    const cudaError_t err = cudaFuncSetAttribute(
        block_kernel<NB, TBL>(),
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    block_kernel<NB, TBL>()<<<grid, vit_block_threads(p->k, p->beta),
                             (size_t)smem, stream>>>(*p);
    return (int)cudaGetLastError();
  }
  template <int NB, bool TBL>
  static int run_block(int k, int beta, int* out) {
    const long long smem = vit_block_smem_bytes(k);
    cudaError_t err = cudaFuncSetAttribute(
        block_kernel<NB, TBL>(),
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          out, block_kernel<NB, TBL>(),
          vit_block_threads(k, beta), (size_t)smem);
    if (err != cudaSuccess) (void)cudaGetLastError();
    return (int)err;
  }
};

struct AttrsBlock {
  template <int NB, bool TBL>
  static int run_block(int* out) {
    return vit_func_attrs(
        reinterpret_cast<const void*>(block_kernel<NB, TBL>()),
        out);
  }
};

struct LaunchCluster {
  template <int NB, bool TBL>
  static int run_cluster(const FwdParams* p, int C, int clusters,
                         cudaStream_t stream) {
    return vit_cluster_launch(viterbi_fwd_cluster_kernel<NB, TBL>, *p, p->k,
                              C, clusters, stream);
  }
  template <int NB, bool TBL>
  static int run_cluster(int k, int C, int* out) {
    return vit_cluster_occupancy(viterbi_fwd_cluster_kernel<NB, TBL>, k, C,
                                 out);
  }
};

struct AttrsCluster {
  template <int NB, bool TBL>
  static int run_cluster(int* out) {
    return vit_func_attrs(
        reinterpret_cast<const void*>(viterbi_fwd_cluster_kernel<NB, TBL>),
        out);
  }
};

// The code whose forward kernel runs the wide mapping past beta = 8 (as
// autotune.FWD_WIDE_K): at 8 registers a lane the run-time-beta form
// compiles each warp-collective with a divergent slow path (BRA.DIV, where
// the unified kernel's form has none) and loses to the wide mapping
// (PERF.md), so it is not built.
#define VIT_FWD_WIDE_K 9

// Whether the forward kernel runs (k, beta) on the wide mapping.
inline bool fwd_wide_code(int k, int beta) {
  return vit_wide_code(k, beta) ||
         (k == VIT_FWD_WIDE_K && beta > VIT_MAX_BETA);
}

// Shared memory of one block of fpb frames: each warp's run buffers, 32
// words and 32 argmax, then at beta > 8 each warp's LLR chunks; for a
// large code, the one-block form's path metrics, tables and partials; for
// a wide code off a cluster, the wide mapping's.
inline long long fwd_smem(int k, int beta, int fpb) {
  if (fwd_wide_code(k, beta)) return VIT_WIDE_CORE_BYTES;
  if (k >= VIT_SMEM_MIN_K) return vit_block_smem_bytes(k);
  const int fpw = 32 / vit_lanes_per_frame(k);
  return (long long)(fpb + fpw - 1) / fpw *
         (64 * 4 + vit_llr_chunk_bytes(beta));
}

// Whether viterbi_fwd_kernel<R, BETA> is built: not where fwd_wide_code
// sends every code it would serve.
template <int R, int BETA>
constexpr bool fwd_built() {
  return !(BETA == 0 && R == (1 << (VIT_FWD_WIDE_K - 1)) / 32);
}

struct Launch {
  template <int R, int BETA>
  static int run(const FwdParams* p, cudaStream_t stream) {
    if constexpr (!fwd_built<R, BETA>()) {
      return (int)cudaErrorInvalidValue;
    } else {
      const int fpw = 32 / vit_lanes_per_frame(p->k);
      const int threads = (p->fpb + fpw - 1) / fpw * 32;
      const int grid = (p->F + p->fpb - 1) / p->fpb;
      viterbi_fwd_kernel<R, BETA>
          <<<grid, threads, (size_t)fwd_smem(p->k, p->beta, p->fpb),
             stream>>>(*p);
      return (int)cudaGetLastError();
    }
  }
};

struct Attrs {
  template <int R, int BETA>
  static int run(int* out) {
    if constexpr (!fwd_built<R, BETA>())
      return (int)cudaErrorInvalidValue;
    else
      return vit_func_attrs(
          reinterpret_cast<const void*>(viterbi_fwd_kernel<R, BETA>), out);
  }
};

// Launches the wide kernel on `grid` blocks.
inline int launch_wide(const FwdParams* p, int grid, cudaStream_t stream) {
  const long long smem = VIT_WIDE_CORE_BYTES;
  viterbi_fwd_wide_kernel<<<grid, vit_wide_threads(p->k), (size_t)smem,
                            stream>>>(*p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block of fpb frames: the warps' run
// buffers (the path metrics live in registers); a large or wide code's
// mapping's own.
long long viterbi_fwd_smem_bytes(int k, int beta, int fpb) {
  return fwd_smem(k, beta, fpb);
}

// out = {numRegs, localSizeBytes, maxThreadsPerBlock} of the instantiation
// that runs (k, beta) off a cluster: the one-block kernel for a large code,
// the wide kernel for every code past them. Returns 0 or the CUDA error.
int viterbi_fwd_func_attrs(int k, int beta, int* out) {
  if (k < 2 || k > VIT_WIDE_MAX_K || beta < 2 || beta > VIT_WIDE_MAX_BETA)
    return (int)cudaErrorInvalidValue;
  if (fwd_wide_code(k, beta))
    return vit_func_attrs(
        reinterpret_cast<const void*>(viterbi_fwd_wide_kernel), out);
  if (k >= VIT_SMEM_MIN_K)
    return vit_dispatch_block<AttrsBlock>(k, beta, out);
  return vit_dispatch<Attrs>(k, beta, out);
}

// *out = the blocks of the one-block kernel that runs a (k, beta) code the
// card keeps resident on one SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), and out = its {numRegs,
// localSizeBytes, maxThreadsPerBlock}. Return 0 or the CUDA error.
int viterbi_fwd_block_occupancy(int k, int beta, int* out) {
  if (!vit_block_ok(k) || beta < 2 || beta > VIT_WIDE_MAX_BETA)
    return (int)cudaErrorInvalidValue;
  return vit_dispatch_block<LaunchBlock>(k, beta, k, beta, out);
}
int viterbi_fwd_block_attrs(int k, int beta, int* out) {
  if (!vit_block_ok(k) || beta < 2 || beta > VIT_WIDE_MAX_BETA)
    return (int)cudaErrorInvalidValue;
  return vit_dispatch_block<AttrsBlock>(k, beta, out);
}

// *out = the clusters of C blocks of the cluster kernel that runs (k,
// beta) the card keeps resident at once (cudaOccupancyMaxActiveClusters).
// Returns 0 or the CUDA error.
int viterbi_fwd_max_clusters(int k, int beta, int C, int* out) {
  if (!vit_cluster_ok(k, C) || beta < 2 || beta > VIT_WIDE_MAX_BETA)
    return (int)cudaErrorInvalidValue;
  return vit_dispatch_cluster<LaunchCluster>(k, beta, C, k, C, out);
}

// out = {numRegs, localSizeBytes, maxThreadsPerBlock} of the cluster
// kernel that runs (k, beta) on a cluster of C. Returns 0 or the error.
int viterbi_fwd_cluster_attrs(int k, int beta, int C, int* out) {
  if (!vit_cluster_ok(k, C) || beta < 2 || beta > VIT_WIDE_MAX_BETA)
    return (int)cudaErrorInvalidValue;
  return vit_dispatch_cluster<AttrsCluster>(k, beta, C, out);
}

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = ok).
// The wide mapping (every code outside the fast mappings' domain, or any
// code with wide != 0, which the wrapper passes only to test the mapping)
// takes `grid` blocks and the path metrics in pm_global
// (grid of [2][S] float32); with cluster > 1 it runs on `grid` clusters of
// that many blocks instead (no pm_global). The large codes (or any code the
// one-block form takes, with block != 0, which the wrapper passes only to
// test it) take `grid` blocks of one frame at a time. The register mapping
// takes fpb frames a block.
int viterbi_fwd_launch(const void* llr, const void* idx, const void* sgn,
                       const void* signs_half, const void* polys, void* sel,
                       void* amax, void* pm_global, int F, int L, int beta,
                       int k, int llr_dtype, int pack, int sublane,
                       int bf16_bm, int fpb, int wide, int grid, int cluster,
                       int block, void* stream) {
  if (block && (wide || cluster > 1)) return (int)cudaErrorInvalidValue;
  wide = wide || cluster > 1 || (!block && fwd_wide_code(k, beta));
  block = block || (!wide && k >= VIT_SMEM_MIN_K);
  if (k < 2 || k > VIT_WIDE_MAX_K || beta < 2 ||
      beta > VIT_WIDE_MAX_BETA || F < 1 || L < 1)
    return (int)cudaErrorInvalidValue;
  if (wide ? (polys == nullptr || grid < 1 ||
              (cluster > 1 ? (!vit_cluster_ok(k, cluster) ||
                              pm_global != nullptr)
                           : pm_global == nullptr))
      : block ? (!vit_block_ok(k) || polys == nullptr || grid < 1 ||
                 pm_global != nullptr)
              : (fpb < 1 || fpb > vit_max_frames_per_block(k) ||
                 polys == nullptr))
    return (int)cudaErrorInvalidValue;
  FwdParams p;
  p.llr = llr;
  p.idx = static_cast<const int*>(idx);
  p.sgn = static_cast<const float*>(sgn);
  p.signs_half = static_cast<const float*>(signs_half);
  p.sel = sel;
  p.amax = static_cast<int*>(amax);
  p.polys = static_cast<const int*>(polys);
  p.pm_global = static_cast<float*>(pm_global);
  p.F = F;
  p.L = L;
  p.k = k;
  p.beta = beta;
  p.llr_dtype = llr_dtype;
  p.pack = pack;
  p.sublane = sublane;
  p.bf16_bm = bf16_bm;
  p.fpb = fpb;
  if (cluster > 1)
    return vit_dispatch_cluster<LaunchCluster>(
        k, beta, cluster, &p, cluster, grid,
        static_cast<cudaStream_t>(stream));
  if (wide) return launch_wide(&p, grid, static_cast<cudaStream_t>(stream));
  if (block)
    return vit_dispatch_block<LaunchBlock>(k, beta, &p, grid,
                                           static_cast<cudaStream_t>(stream));
  return vit_dispatch<Launch>(k, beta, &p, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
