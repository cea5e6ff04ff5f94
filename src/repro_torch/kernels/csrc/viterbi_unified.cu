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
// bit written once), so the bound is on the operations side; what the card
// can reach is set by the instructions each stage issues (shuffles, the
// max's redux, ballots, survivor bookkeeping besides the six operations) and
// by how many frames are resident to hide each stage's dependent chain.
//
// Design. Codes 3 <= k <= 7 at beta <= 3 run the thread mapping
// (viterbi_unified_thread_kernel, VitThread below: one thread a frame, all
// its path metrics in the thread's registers) in launches whose frames
// fill the card (the wrapper's choice: autotune.thread_mapping), and the
// warp mapping in smaller ones. Every other code to k = 11:
// one warp per frame (32 / S frames per warp for S < 32), with the
// path metrics in registers: acs.cuh's VitFrame, shared with the forward
// kernel. Nothing in the stage loop is block-wide: no __syncthreads, no
// shared-memory path metrics. The LLRs come 32 stages at a time, one stage
// per lane, a chunk ahead, and reach the segment by __shfl_sync. Survivors
// never touch device memory: packed, the segment's first lane stores each
// stage's R ballot words to shared memory in one vector store; unpacked,
// each lane writes its states' bytes. The argmax is taken only at the
// traceback start stages, as the first maximal state. After one
// __syncwarp the frame's warp runs its nsub = f / f0 traceback cursors,
// one per lane, over the survivors in shared memory. Blocks are up to
// eight warps; a block is only a unit of scheduling. The kernel inlines
// one loop per bm_dtype, so the f32 loop carries no bf16 rounding.
//
// Rates below 1/8 (beta > 8) run the same mapping with beta at run time
// (VitFrame<R, 0>, one instantiation per R): each butterfly's encoder word
// in a register, the LLRs staged a chunk at a time in the warp's shared
// memory, before the traceback starts and the survivors.
//
// Codes 12 <= k <= 15 run the one-block form of acs.cuh's VitCluster
// instead, in kernels of their own (viterbi_unified_block_kernel, one
// instantiation per butterflies a thread NB, with the butterfly table at
// beta <= 8; viterbi_unified_block_pe_kernel with per-edge sums past it):
// one frame a block of
// vit_block_threads(k, beta) threads, path metrics in
// shared memory, one __syncthreads a stage; the grid is the blocks the card
// keeps resident, each taking frames in turn. The block keeps the frame's
// survivors and starts in shared memory beside the path metrics or in a
// device-memory scratch of its own, as the wrapper asks (the planner's
// autotune.block_survivors_on_chip). Phase 3 runs the frame's nsub cursors
// on the block's threads.
//
// Every other code (k >= 16) runs acs.cuh's wide mapping, in a third
// kernel (viterbi_unified_wide_kernel): one block a frame, k and
// beta at run time, path metrics, survivors and traceback starts in a
// device-memory scratch. A block decodes frames blockIdx.x, +
// gridDim.x, ...; its scratch is its own, reused frame after frame. Codes
// 16 <= k <= 19 run it on a thread-block cluster instead (a fourth kernel,
// viterbi_unified_cluster_kernel, acs.cuh's VitCluster): one frame a
// cluster of 2^(k-15) blocks, the path metrics in the cluster's shared
// memory, the survivors and starts in a scratch per cluster, the nsub
// cursors spread over the cluster's blocks; a cluster decodes frames
// %clusterid, + %nclusterid, ....
//
// When one frame's survivors exceed the shared memory a block can have
// (unpacked K=7 survivors of one f=4096 frame need L*S ~ 266 KB), the same
// kernel keeps survivors and traceback starts in a device-memory scratch
// that the wrapper allocates: slower, but it decodes every shape JAX
// decodes.
//
// `radix` 4 and 2 run the same loop (every stage is one exact radix-2
// step, unrolled over a run) and `layout` is a TPU orientation knob: the
// wrapper checks both and passes neither. All decode identically.

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
  int* amax_global;           // traceback-start scratch (with sel_global)
  const int* polys;           // (beta,) generator polynomials (wide mapping)
  float* pm_global;           // wide mapping past k = 15: [grid][2][S]
  int F, L, k, beta, v1, f, f0, v2s, nsub;
  int llr_dtype, start_fixed, pack, bf16_bm, fpb;
};

struct SmemLayout {
  long long am, sel, total;
};

// Shared-memory carve-up of one block of fpb frames: at beta > 8 each
// warp's LLR chunks (vit_llr_chunk_bytes), then the traceback starts
// [fpb][nsub] int32 (none for start=fixed), padded to 16 bytes, then the
// survivors [fpb][L][row] bytes, row = 4 * R packed (R = max(1, S/32)
// words, stored as one vector per stage), S unpacked.
__host__ __device__ inline SmemLayout smem_layout(int k, int beta, int L,
                                                  int nsub, int pack,
                                                  int start_fixed, int fpb,
                                                  int global) {
  const int S = 1 << (k - 1);
  const long long row = pack ? 4LL * vit_regs_per_lane(k) : S;
  const int fpw = 32 / vit_lanes_per_frame(k);
  SmemLayout s;
  s.am = (fpb + fpw - 1) / fpw * vit_llr_chunk_bytes(beta);
  s.sel = s.am + (global || start_fixed
                      ? 0 : ((long long)fpb * nsub * 4 + 15) & ~15LL);
  s.total = s.sel + (global ? 0 : (long long)fpb * L * row);
  return s;
}

// What the unified kernel keeps of each stage: the survivors (packed: the
// segment's first lane stores the stage's R words, one vector store; else
// every lane its states' bytes) and, at the traceback start stages, the
// first maximal state. Survivors go to shared memory (ssel, a shared
// address) or, for frames too long for it, to the device-memory scratch.
template <int R, int BETA>
struct UnifiedStore {
  const VitFrame<R, BETA>& fr;
  uint32_t ssel;                               // this frame's [L][row]
  unsigned char* gsel;                         // or its scratch
  int* am;                                     // its [nsub] starts
  int S, pack, nsub, f0, q;
  int next_e;                                  // next start; INT_MAX: none
  bool global, fvalid, writer;                 // writer: fvalid && l == 0
  __device__ __forceinline__ void stage(int t, int /*u*/,
                                        const unsigned (&w)[R]) {
    if (pack) {
      if (!global)
        vit_sts_words_if<R>(writer, ssel + t * 4 * R, w);
      else if (writer)
        vit_store_words<R>(
            reinterpret_cast<uint32_t*>(gsel + (long long)t * 4 * R), w);
    } else if (fvalid) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int s = fr.lanes() * r + fr.l;
        const unsigned bit = (w[r] >> fr.l) & 1u;
        if (global)
          gsel[(long long)t * S + s] = (unsigned char)bit;
        else
          vit_sts_u8(ssel + t * S + s, bit);
      }
    }
    if (t == next_e) {                                  // warp-uniform
      const int a = fr.first_max();
      if (writer) am[q] = a;
      ++q;
      next_e = q < nsub ? next_e + f0 : 0x7fffffff;
    }
  }
  __device__ __forceinline__ void run_end(int, int) {}
};

template <int R, int BETA>
__global__ void __launch_bounds__(VIT_BLOCK_THREADS)
    viterbi_unified_kernel(const UnifiedParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  VitFrame<R, BETA> fr;
  if constexpr (BETA == 0)
    fr.init(p.k, p.beta, p.polys);
  else
    fr.init(p.k, p.idx, p.sgn, p.signs_half);
  const int S = 1 << (p.k - 1);
  const int P = fr.P;
  const int fpw = 32 / P;                  // frames per warp
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int lf = warp * fpw + fr.segbase / P;   // frame within the block
  const long long frame = (long long)blockIdx.x * p.fpb + lf;
  const bool fvalid = lf < p.fpb && frame < p.F;
  const long long row = p.pack ? 4LL * R : S;
  const int global = p.sel_global != nullptr;
  const SmemLayout lay = smem_layout(p.k, BETA ? BETA : p.beta, p.L, p.nsub,
                                     p.pack, p.start_fixed, p.fpb, global);
  auto sel_of = [&](int lfr, long long fr_) -> unsigned char* {
    return global ? p.sel_global + fr_ * p.L * row
                  : smem + lay.sel + (long long)lfr * p.L * row;
  };
  auto am_of = [&](int lfr, long long fr_) -> int* {
    return global ? p.amax_global + fr_ * p.nsub
                  : reinterpret_cast<int*>(smem + lay.am) + lfr * p.nsub;
  };

  // ---- phases 1+2: branch metrics + ACS; survivors stay on chip ----------
  UnifiedStore<R, BETA> st{
      fr,
      static_cast<uint32_t>(__cvta_generic_to_shared(
          smem + lay.sel + (global ? 0 : (long long)lf * p.L * row))),
      p.sel_global + (global ? frame * p.L * row : 0),
      am_of(lf, frame), S, p.pack, p.nsub, p.f0, 0,
      p.start_fixed ? 0x7fffffff : p.v1 + p.f0 - 1 + p.v2s, global != 0,
      fvalid, fvalid && fr.l == 0};
  if constexpr (BETA == 0) {
    const long long base = frame * p.L * p.beta;
    float* buf = reinterpret_cast<float*>(
        smem + warp * vit_llr_chunk_bytes(p.beta));
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
  __syncwarp();                 // the warp's survivors and starts, visible

  // ---- phase 3: the warp's nsub cursors per frame, one per lane ----------
  const int kshift = p.k - 2;
  const int T = p.f0 + p.v2s;
  const int ncur = fpw * p.nsub;
  for (int c = lane; c < ncur; c += 32) {
    const int lf2 = warp * fpw + c / p.nsub;
    const int q2 = c - (c / p.nsub) * p.nsub;
    const long long fr2 = (long long)blockIdx.x * p.fpb + lf2;
    if (lf2 >= p.fpb || fr2 >= p.F) continue;
    const unsigned char* sel2 = sel_of(lf2, fr2);
    int state = p.start_fixed ? 0 : am_of(lf2, fr2)[q2];
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

// ---- every other code: one frame a block, acs.cuh's VitWide -------------

// What the wide kernel keeps of each stage: the survivors in the block's
// scratch (packed: lane 0 of each warp stores the warp's words; else every
// thread its states' bytes) and the first maximal state of each traceback
// start stage.
struct UnifiedWideStore {
  unsigned char* sel;       // the block's [L][row]
  int* am;                  // its [nsub] starts
  long long row;
  int H, pack, f0, e_first, next_e;
  __device__ __forceinline__ bool argmax_at(int t) const {
    return t == next_e;
  }
  __device__ __forceinline__ bool wants_argmax(int t) {
    if (t != next_e) return false;
    next_e += f0;
    return true;
  }
  __device__ __forceinline__ void argmax(int t, int a) {
    if ((threadIdx.x & 31) == 0) am[(t - e_first) / f0] = a;
  }
  __device__ __forceinline__ void word(int t, int i, unsigned w) {
    reinterpret_cast<uint32_t*>(sel + (long long)t * row)[i] = w;
  }
  __device__ __forceinline__ void butterfly(int t, int q, bool valid,
                                            bool slo, bool shi, unsigned blo,
                                            unsigned bhi) {
    unsigned char* r = sel + (long long)t * row;
    if (pack) {
      if ((threadIdx.x & 31) == 0) {
        const VitWideWords w(H, q, blo, bhi);
        uint32_t* r32 = reinterpret_cast<uint32_t*>(r);
        r32[w.i0] = w.w0;
        if (w.n == 2) r32[w.i1] = w.w1;
      }
    } else if (valid) {
      r[q] = (unsigned char)slo;
      r[q + H] = (unsigned char)shi;
    }
  }
};

__global__ void __launch_bounds__(VIT_WIDE_MAX_THREADS)
    viterbi_unified_wide_kernel(const UnifiedParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = 1 << (p.k - 1);
  const long long row = p.pack ? 4LL * ((S + 31) / 32) : S;
  unsigned char* sel = p.sel_global + (long long)blockIdx.x * p.L * row;
  int* am = p.amax_global + (long long)blockIdx.x * p.nsub;
  VitWide w;
  w.init(p.k, p.beta, p.polys, smem,
         p.pm_global != nullptr ? p.pm_global + blockIdx.x * 2LL * S
                                : nullptr);
  const int e_first = p.v1 + p.f0 - 1 + p.v2s;
  const int kshift = p.k - 2;
  const int T = p.f0 + p.v2s;
  for (long long frame = blockIdx.x; frame < p.F; frame += gridDim.x) {
    UnifiedWideStore st{sel, am, row, S >> 1, p.pack, p.f0, e_first,
                        p.start_fixed ? 0x7fffffff : e_first};
    const long long base = frame * p.L * p.beta;
    if (p.bf16_bm)        // one inlined loop per bm_dtype
      vit_wide_recursion(w, p.llr, p.llr_dtype, true, base, p.L, st);
    else
      vit_wide_recursion(w, p.llr, p.llr_dtype, false, base, p.L, st);

    // ---- phase 3: the frame's nsub cursors, one per thread ----------------
    for (int q = threadIdx.x; q < p.nsub; q += blockDim.x) {
      int state = p.start_fixed ? 0 : am[q];
      const int e2 = p.v1 + (q + 1) * p.f0 - 1 + p.v2s;
      int* o = p.out + frame * p.f + (long long)q * p.f0;
      for (int r = 0; r < T; ++r) {
        const long long ts = e2 - r;
        if (r >= p.v2s) o[p.f0 - 1 - (r - p.v2s)] = state >> kshift;
        int bit;
        if (p.pack)
          bit = (reinterpret_cast<const uint32_t*>(sel + ts * row)
                     [state >> 5] >> (state & 31)) & 1;
        else
          bit = sel[ts * row + state];
        state = ((state << 1) & (S - 1)) | bit;
      }
    }
    __syncthreads();      // the scratch is read before the next frame's
  }
}

// ---- 16 <= k <= 19: one frame a cluster, acs.cuh's VitCluster -----------

// The wide kernel's work on a cluster of blocks: survivors and
// starts in the cluster's scratch, stored as the wide kernel stores them;
// phase 3's nsub cursors spread over the cluster's blocks (cursor q on
// block q mod C), after the recursion's closing cluster barrier.
template <int NB, bool TBL>
__global__ void __launch_bounds__(VIT_CLUSTER_THREADS, 1)
    viterbi_unified_cluster_kernel(const UnifiedParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = 1 << (p.k - 1);
  const long long row = p.pack ? 4LL * ((S + 31) / 32) : S;
  const long long cl = vit_cluster_id();
  unsigned char* sel = p.sel_global + cl * p.L * row;
  int* am = p.amax_global + cl * p.nsub;
  VitCluster<NB, TBL> v;
  v.init(p.k, p.beta, p.polys, smem);
  const int e_first = p.v1 + p.f0 - 1 + p.v2s;
  const int kshift = p.k - 2;
  const int T = p.f0 + p.v2s;
  const int C = v.C;
  for (long long frame = cl; frame < p.F; frame += vit_cluster_count()) {
    UnifiedWideStore st{sel, am, row, S >> 1, p.pack, p.f0, e_first,
                        p.start_fixed ? 0x7fffffff : e_first};
    const long long base = frame * p.L * p.beta;
    vit_cluster_run(v, p.llr, p.llr_dtype, p.bf16_bm != 0, base, p.L, st);

    // ---- phase 3: the frame's nsub cursors over the cluster's blocks ------
    for (int q = v.c + C * threadIdx.x; q < p.nsub; q += C * blockDim.x) {
      int state = p.start_fixed ? 0 : am[q];
      const int e2 = p.v1 + (q + 1) * p.f0 - 1 + p.v2s;
      int* o = p.out + frame * p.f + (long long)q * p.f0;
      for (int r = 0; r < T; ++r) {
        const long long ts = e2 - r;
        if (r >= p.v2s) o[p.f0 - 1 - (r - p.v2s)] = state >> kshift;
        int bit;
        if (p.pack)
          bit = (reinterpret_cast<const uint32_t*>(sel + ts * row)
                     [state >> 5] >> (state & 31)) & 1;
        else
          bit = sel[ts * row + state];
        state = ((state << 1) & (S - 1)) | bit;
      }
    }
    // the next frame's recursion opens with a cluster barrier: the scratch
    // is read before it is written again
  }
}

struct LaunchCluster {
  template <int NB, bool TBL>
  static int run_cluster(const UnifiedParams* p, int C, int clusters,
                         cudaStream_t stream) {
    return vit_cluster_launch(viterbi_unified_cluster_kernel<NB, TBL>, *p,
                              p->k, C, clusters, stream);
  }
  template <int NB, bool TBL>
  static int run_cluster(int k, int C, int* out) {
    return vit_cluster_occupancy(viterbi_unified_cluster_kernel<NB, TBL>, k,
                                 C, out);
  }
};

struct AttrsCluster {
  template <int NB, bool TBL>
  static int run_cluster(int* out) {
    return vit_func_attrs(reinterpret_cast<const void*>(
                              viterbi_unified_cluster_kernel<NB, TBL>),
                          out);
  }
};

// ---- 12 <= k <= 15: one frame a block, acs.cuh's VitCluster on one block --

// Shared-memory carve-up of one block of the one-block form: the
// recursion's core and path metrics (vit_block_smem_bytes), the traceback
// starts [nsub] int32 (none for start=fixed or with the scratch) padded to
// 16 bytes, then the survivors [L][row] (none with the scratch).
__host__ __device__ inline SmemLayout smem_layout_block(int k, int L,
                                                        int nsub, int pack,
                                                        int start_fixed,
                                                        int global) {
  const long long row = pack ? (1LL << (k - 1)) / 8 : 1LL << (k - 1);
  SmemLayout s;
  s.am = vit_block_smem_bytes(k);
  s.sel = s.am + (global || start_fixed ? 0
                                        : ((long long)nsub * 4 + 15) & ~15LL);
  s.total = s.sel + (global ? 0 : (long long)L * row);
  return s;
}

// The cluster kernel's work on one block: survivors and starts in the
// block's shared memory after the recursion's (sel_global null) or in its
// device-memory scratch, stored as the wide kernel stores them; phase 3's
// nsub cursors on the block's threads, after the recursion's closing
// barrier. A block decodes frames blockIdx.x, + gridDim.x, ....
template <int NB, bool TBL>
__device__ __forceinline__ void unified_block(const UnifiedParams& p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = 1 << (p.k - 1);
  const long long row = p.pack ? S / 8 : S;
  const int global = p.sel_global != nullptr;
  const SmemLayout lay =
      smem_layout_block(p.k, p.L, p.nsub, p.pack, p.start_fixed, global);
  const long long b = blockIdx.x;
  unsigned char* sel = global ? p.sel_global + b * p.L * row : smem + lay.sel;
  int* am = global ? p.amax_global + b * p.nsub
                   : reinterpret_cast<int*>(smem + lay.am);
  VitCluster<NB, TBL, false> v;
  v.init(p.k, p.beta, p.polys, smem);
  const int e_first = p.v1 + p.f0 - 1 + p.v2s;
  const int kshift = p.k - 2;
  const int T = p.f0 + p.v2s;
  for (long long frame = blockIdx.x; frame < p.F; frame += gridDim.x) {
    UnifiedWideStore st{sel, am, row, S >> 1, p.pack, p.f0, e_first,
                        p.start_fixed ? 0x7fffffff : e_first};
    const long long base = frame * p.L * p.beta;
    vit_cluster_run(v, p.llr, p.llr_dtype, p.bf16_bm != 0, base, p.L, st);

    // ---- phase 3: the frame's nsub cursors, one per thread ----------------
    for (int q = threadIdx.x; q < p.nsub; q += blockDim.x) {
      int state = p.start_fixed ? 0 : am[q];
      const int e2 = p.v1 + (q + 1) * p.f0 - 1 + p.v2s;
      int* o = p.out + frame * p.f + (long long)q * p.f0;
      for (int r = 0; r < T; ++r) {
        const long long ts = e2 - r;
        if (r >= p.v2s) o[p.f0 - 1 - (r - p.v2s)] = state >> kshift;
        int bit;
        if (p.pack)
          bit = (reinterpret_cast<const uint32_t*>(sel + ts * row)
                     [state >> 5] >> (state & 31)) & 1;
        else
          bit = sel[ts * row + state];
        state = ((state << 1) & (S - 1)) | bit;
      }
    }
    // the next frame's recursion opens with a block barrier: the
    // survivors are read before they are written again
  }
}

// The table (beta <= 8), one instantiation per NB.
template <int NB>
__global__ void __launch_bounds__(VIT_CLUSTER_THREADS)
    viterbi_unified_block_kernel(const UnifiedParams p) {
  unified_block<NB, true>(p);
}

// The per-edge sums (beta > 8): at most 4 butterflies a thread (k = 12, 13)
// built for two blocks an SM (64 registers; left free they take 91 and
// keep one or two), else one.
template <int NB>
__global__ void __launch_bounds__(VIT_CLUSTER_THREADS, NB <= 4 ? 2 : 1)
    viterbi_unified_block_pe_kernel(const UnifiedParams p) {
  unified_block<NB, false>(p);
}

using BlockKernel = void (*)(const UnifiedParams);

// The one-block kernel of NB butterflies a thread, table or per-edge sums.
template <int NB, bool TBL>
inline BlockKernel block_kernel() {
  if constexpr (TBL)
    return viterbi_unified_block_kernel<NB>;
  else
    return viterbi_unified_block_pe_kernel<NB>;
}

// Sets the one-block kernel's dynamic shared memory.
template <int NB, bool TBL>
inline cudaError_t block_smem_attr(long long smem) {
  return cudaFuncSetAttribute(block_kernel<NB, TBL>(),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

struct LaunchBlock {
  template <int NB, bool TBL>
  static int run_block(const UnifiedParams* p, long long smem, int grid,
                       cudaStream_t stream) {
    const cudaError_t err = block_smem_attr<NB, TBL>(smem);
    if (err != cudaSuccess) return (int)err;
    block_kernel<NB, TBL>()<<<grid, vit_block_threads(p->k, p->beta),
                             (size_t)smem, stream>>>(*p);
    return (int)cudaGetLastError();
  }
  template <int NB, bool TBL>
  static int run_block(int k, int beta, long long smem, int* out) {
    cudaError_t err = block_smem_attr<NB, TBL>(smem);
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

// Threads of a block of fpb frames: whole warps of 32 / P frames each.
inline int block_threads(int k, int fpb) {
  const int fpw = 32 / vit_lanes_per_frame(k);
  return (fpb + fpw - 1) / fpw * 32;
}

struct Launch {
  template <int R, int BETA>
  static int run(const UnifiedParams* p, long long smem,
                 cudaStream_t stream) {
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          viterbi_unified_kernel<R, BETA>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    const int grid = (p->F + p->fpb - 1) / p->fpb;
    viterbi_unified_kernel<R, BETA>
        <<<grid, block_threads(p->k, p->fpb), (size_t)smem, stream>>>(*p);
    return (int)cudaGetLastError();
  }
};

struct Attrs {
  template <int R, int BETA>
  static int run(int* out) {
    return vit_func_attrs(
        reinterpret_cast<const void*>(viterbi_unified_kernel<R, BETA>), out);
  }
};

// Launches the wide kernel on `grid` blocks.
inline int launch_wide(const UnifiedParams* p, int grid,
                       cudaStream_t stream) {
  const long long smem = VIT_WIDE_CORE_BYTES;
  viterbi_unified_wide_kernel<<<grid, vit_wide_threads(p->k), (size_t)smem,
                                stream>>>(*p);
  return (int)cudaGetLastError();
}

// Shared memory of one block for any mapping off a cluster (wide: the
// mapping's own; its survivors are always in the scratch).
inline long long unified_smem(int k, int beta, int L, int nsub, int pack,
                              int start_fixed, int fpb, int global) {
  if (vit_wide_code(k, beta)) return VIT_WIDE_CORE_BYTES;
  if (k >= VIT_SMEM_MIN_K)
    return smem_layout_block(k, L, nsub, pack, start_fixed, global).total;
  return smem_layout(k, beta, L, nsub, pack, start_fixed, fpb, global).total;
}

// ---- 3 <= k <= 7 at beta <= VIT_THREAD_MAX_BETA: one thread a frame -------
//
// The thread mapping. One thread holds all S = 2^(k-1) path metrics of its
// frame in registers, so a stage is arithmetic in one thread: no shuffle,
// no ballot, no redux. The butterfly of predecessors (2j, 2j+1) into
// states (j, j + S/2) writes its two results into the registers that held
// its inputs (state s then lies in register s rotated left by one bit of
// k - 1), and the stage ends by putting every state back in its own
// register, a permutation the compiler resolves: the loop body is one
// stage. (Unrolling the k - 1 stages after which the rotation returns by
// itself ran no faster, with five times the code and twice the
// registers: PERF.md.)
//
// Branch metrics: the stage's 2^(beta-1) half metrics, summed in b order
// exactly as VitFrame::bm sums them (the first term, then one rounded add
// or subtract a term: the fma by +-1 of the plain version), rounded once
// to bf16 for bm_dtype bf16. Edge p into state s takes sgn_p[s] *
// bm_half[idx_p[s]] as sum_h coef[p][s][h] * bm_half[h], a multiply and
// an fma chain whose coefficients (kernel parameters) are +-1 at
// h = idx_p[s] and 0 elsewhere: every other term is an exact zero, so the
// sum is the one signed metric, exactly, for every code of the launch.
// Where every polynomial has both taps (taps) edges 01 and 10 are edge
// 00's negation and edge 11 edge 00 itself (acs.cuh's vit_quad_word): one
// metric a butterfly.
//
// LLRs: each warp stages its frames' LLRs in shared memory a chunk of
// VIT_THREAD_CHUNK stages ahead with cp.async, so that its copies are runs
// of consecutive stages of a few frames (a load of each thread's own
// frame touched 32 lines a warp; PERF.md); a stage's LLRs are then one
// shared-memory read a thread, a stage ahead.
//
// Survivors: each stage's decisions as packing.py's LANE words (state s at
// bit s % 32 of word s / 32), W = 1 or 2 words, in a ring of Z = f0 + v2s
// stages laid out [Z][W][frames] in the block's shared memory, so that a
// warp stores whole rows. At each traceback start the thread traces back
// at once; the ring holds the start's f0 + v2s stages. The wrapper shrinks
// the block until its ring fits; where one frame's does not (a serial
// traceback of tens of thousands of stages), the code runs on the warp
// mapping, whose survivors then go to its device-memory scratch.
//
// What bounds it: per state and stage two candidate adds, a compare, a
// select, a predicated or of the decision bit, the max's fmaxf and the
// normalising subtract, and per butterfly its metric: the FP32 and integer
// pipes, not the shuffle pipe; then each start's serial traceback.
#define VIT_THREAD_MIN_K 3
#define VIT_THREAD_MAX_K 7
#define VIT_THREAD_MAX_BETA 3
#define VIT_THREAD_MAX_S (1 << (VIT_THREAD_MAX_K - 1))
#define VIT_THREAD_MAX_HALF (1 << (VIT_THREAD_MAX_BETA - 1))
// Stages of one LLR chunk.
#define VIT_THREAD_CHUNK 8

// Whether the thread mapping takes (k, beta).
__host__ __device__ inline bool vit_thread_code(int k, int beta) {
  return k >= VIT_THREAD_MIN_K && k <= VIT_THREAD_MAX_K && beta >= 2 &&
         beta <= VIT_THREAD_MAX_BETA;
}

// Survivor words a stage (W) and ring slots (Z) of the thread mapping.
__host__ __device__ inline int vit_thread_words(int k) {
  return k > 6 ? 2 : 1;
}
__host__ __device__ inline int vit_thread_slots(int f0, int v2s) {
  return f0 + v2s;
}

// 32-bit words of one frame's LLR chunk in shared memory: the chunk as
// float32, and two words that spread the frames over the banks.
__host__ __device__ inline int vit_thread_chunk_words(int beta) {
  return VIT_THREAD_CHUNK * beta + 2;
}

// Shared memory of a block of fpb frames: the survivor ring, padded to 16
// bytes, then each warp's two LLR chunks.
__host__ __device__ inline long long vit_thread_ring_bytes(int k, int f0,
                                                           int v2s, int fpb) {
  return (4LL * vit_thread_slots(f0, v2s) * vit_thread_words(k) * fpb + 15) &
         ~15LL;
}
__host__ __device__ inline long long vit_thread_smem_bytes(int k, int beta,
                                                           int f0, int v2s,
                                                           int fpb) {
  return vit_thread_ring_bytes(k, f0, v2s, fpb) +
         (fpb + 31) / 32 * 2LL * 32 * vit_thread_chunk_words(beta) * 4;
}

struct ThreadParams {
  const void* llr;       // (F, L, beta) f32 | bf16 | f16
  int* out;              // (F, f) decoded bits
  int F, L, v1, f, f0, v2s, Z;
  int llr_dtype, start_fixed, bf16_bm, taps;
  // Edge p into state s: sum_h coef[p][s][h] * bm_half[h].
  float coef[2][VIT_THREAD_MAX_S][VIT_THREAD_MAX_HALF];
};

// The register of state s after the stage's butterflies: s rotated left by
// one bit of k - 1.
template <int K>
__host__ __device__ constexpr int vit_thread_reg(int s) {
  return ((s << 1) | (s >> (K - 2))) & ((1 << (K - 1)) - 1);
}

__device__ __forceinline__ void vit_cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst),
               "l"(src) : "memory");
}
__device__ __forceinline__ void vit_cp_async8(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(dst),
               "l"(src) : "memory");
}
__device__ __forceinline__ void vit_cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void vit_cp_wait() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// One warp's LLR chunk c into its buffer `buf` (a shared address): the nf
// frames from frame0, each a run of VIT_THREAD_CHUNK stages (fewer at the
// frame's end), copied in granules of 8 bytes where a stage is a multiple
// of 8 bytes, else 4, granule g of the warp by lane g % nl.
template <int BETA>
__device__ __forceinline__ void vit_thread_stage(const ThreadParams& p,
                                                 int esize, long long frame0,
                                                 int nf, int c, uint32_t buf,
                                                 int lane, int nl) {
  const int sb = BETA * esize;                    // bytes a stage
  const int G = sb % 8 == 0 ? 8 : 4;
  const int ng = VIT_THREAD_CHUNK * sb / G;       // granules a frame
  const int t0 = c * VIT_THREAD_CHUNK;
  const int nstage = min(VIT_THREAD_CHUNK, p.L - t0);
  const int nbytes = nstage * sb;
  const char* src = static_cast<const char*>(p.llr) +
                    ((frame0 * p.L + t0) * BETA) * (long long)esize;
  const long long fbytes = (long long)p.L * sb;
#pragma unroll 1
  for (int g = lane; g < nf * ng; g += nl) {
    const int fi = g / ng, off = (g - fi * ng) * G;
    if (off >= nbytes || frame0 + fi >= p.F) continue;
    const uint32_t dst =
        buf + (uint32_t)(fi * vit_thread_chunk_words(BETA) * 4 + off);
    if (G == 8)
      vit_cp_async8(dst, src + fi * fbytes + off);
    else
      vit_cp_async4(dst, src + fi * fbytes + off);
  }
}

// One stage's beta LLRs from a staged chunk (s: the frame's row, stage u's
// first byte), as float32.
template <int BETA>
__device__ __forceinline__ void vit_thread_read(const unsigned char* s,
                                                int dtype,
                                                float (&x)[BETA]) {
  if (dtype == VIT_F32) {
    if constexpr (BETA == 2) {
      const float2 v = *reinterpret_cast<const float2*>(s);
      x[0] = v.x;
      x[1] = v.y;
    } else {
#pragma unroll
      for (int b = 0; b < BETA; ++b)
        x[b] = reinterpret_cast<const float*>(s)[b];
    }
  } else if (dtype == VIT_BF16) {
#pragma unroll
    for (int b = 0; b < BETA; ++b)
      x[b] = __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(s)[b]);
  } else {
#pragma unroll
    for (int b = 0; b < BETA; ++b)
      x[b] = __half2float(reinterpret_cast<const __half*>(s)[b]);
  }
}

template <int K, int BETA, bool TAPS>
struct VitThread {
  static constexpr int S = 1 << (K - 1);
  static constexpr int H = 1 << (BETA - 1);
  static constexpr int W = S > 32 ? 2 : 1;
  float pm[S];

  // Edge p into state s from the stage's half metrics.
  __device__ __forceinline__ static float edge(const ThreadParams& p, int e,
                                               int s, const float (&bm)[H]) {
    float m = __fmul_rn(p.coef[e][s][0], bm[0]);
#pragma unroll
    for (int h = 1; h < H; ++h) m = __fmaf_rn(p.coef[e][s][h], bm[h], m);
    return m;
  }

  // One level of the max's tree: m[i] = max(m[i], m[i + N]), i < N.
  template <int N>
  __device__ __forceinline__ static void halve(float (&m)[S / 2]) {
    if constexpr (N >= 1) {
#pragma unroll
      for (int i = 0; i < N; ++i) m[i] = fmaxf(m[i], m[i + N]);
    }
  }

  // One stage from its LLRs x: the path metrics, normalised, each state
  // in its own register again, and the survivor words w.
  __device__ __forceinline__ void step(const ThreadParams& p,
                                       const float (&x)[BETA], bool bf16,
                                       unsigned (&w)[W]) {
    float bm[H];
#pragma unroll
    for (int h = 0; h < H; ++h) {
      float acc = x[0];
#pragma unroll
      for (int b = 1; b < BETA; ++b)
        acc = (h >> (BETA - 1 - b)) & 1 ? __fsub_rn(acc, x[b])
                                        : __fadd_rn(acc, x[b]);
      bm[h] = bf16 ? __bfloat162float(__float2bfloat16_rn(acc)) : acc;
    }
#pragma unroll
    for (int i = 0; i < W; ++i) w[i] = 0u;
#pragma unroll
    for (int j = 0; j < S / 2; ++j) {
      const float a = pm[2 * j], b = pm[2 * j + 1];
      float c00, c01, c10, c11;
      if constexpr (TAPS) {
        const float m = edge(p, 0, j, bm);
        c00 = __fadd_rn(a, m);
        c01 = __fsub_rn(b, m);
        c10 = __fsub_rn(a, m);
        c11 = __fadd_rn(b, m);
      } else {
        c00 = __fadd_rn(a, edge(p, 0, j, bm));
        c01 = __fadd_rn(b, edge(p, 1, j, bm));
        c10 = __fadd_rn(a, edge(p, 0, j + S / 2, bm));
        c11 = __fadd_rn(b, edge(p, 1, j + S / 2, bm));
      }
      const bool s0 = c01 >= c00, s1 = c11 >= c10;    // ties: predecessor 1
      pm[2 * j] = s0 ? c01 : c00;                      // state j
      pm[2 * j + 1] = s1 ? c11 : c10;                  // state j + S/2
      if (s0) w[0] |= 1u << j;
      if (s1) w[W - 1] |= 1u << (W == 2 ? j : j + S / 2);
    }
    float m[S / 2];
#pragma unroll
    for (int i = 0; i < S / 2; ++i) m[i] = fmaxf(pm[i], pm[i + S / 2]);
    halve<S / 4>(m);
    halve<S / 8>(m);
    halve<S / 16>(m);
    halve<S / 32>(m);
    halve<S / 64>(m);
    float nx[S];
#pragma unroll
    for (int s = 0; s < S; ++s)                              // normalise
      nx[s] = __fsub_rn(pm[vit_thread_reg<K>(s)], m[0]);
#pragma unroll
    for (int s = 0; s < S; ++s) pm[s] = nx[s];
  }

  // The first maximal state: the least s whose normalised metric is 0
  // (v - max is 0 only for v == max).
  __device__ __forceinline__ int first_max() const {
    int a = 0;
#pragma unroll
    for (int s = S - 1; s >= 0; --s)
      if (pm[s] == 0.f) a = s;
    return a;
  }

  // One start's traceback from ring slot `slot` (its stage) over the
  // f0 + v2s stages before it: v2s stages to converge, then the
  // subframe's f0 bits, last first, into its row from o (the subframe's
  // first bit), four at a time where the rows allow (vec), whereafter o
  // is the next subframe's first bit.
  __device__ __forceinline__ static void traceback(const ThreadParams& p,
                                                   int state, int slot,
                                                   const uint32_t* ring,
                                                   long long stride,
                                                   bool valid, bool vec,
                                                   int*& o) {
    // the bit of `state`, then one stage back; a stage's words are read
    // whatever the state, so the reads of the next stages need not wait
    // for it
    auto back = [&]() {
      const int bit = state >> (K - 2);
      const uint32_t* row = ring + (long long)slot * W * stride;
      unsigned next;
      if constexpr (W == 2) {
        const unsigned long long v =
            (unsigned long long)row[stride] << 32 | row[0];
        next = (unsigned)(v >> state) & 1u;
      } else {
        next = (row[0] >> state) & 1u;
      }
      state = ((state << 1) & (S - 1)) | (int)next;
      slot = slot ? slot - 1 : p.Z - 1;
      return bit;
    };
    int r = 0;
#pragma unroll 1
    for (; r + 4 <= p.v2s; r += 4) {
      back();
      back();
      back();
      back();
    }
#pragma unroll 1
    for (; r < p.v2s; ++r) back();
    if (vec) {
#pragma unroll 1
      for (int i = p.f0 - 4; i >= 0; i -= 4) {
        const int b3 = back(), b2 = back(), b1 = back(), b0 = back();
        if (valid)
          *reinterpret_cast<int4*>(o + i) = make_int4(b0, b1, b2, b3);
      }
    } else {
#pragma unroll 1
      for (int i = p.f0 - 1; i >= 0; --i) {
        const int b = back();
        if (valid) o[i] = b;
      }
    }
    o += p.f0;
  }

  // The frame's recursion through its last traceback start (stage
  // v1 + f + v2s - 1), one stage a loop iteration: the warp's LLR chunks
  // staged one ahead in `llr` (two buffers), each stage's words into the
  // ring, each start traced back at once.
  __device__ __forceinline__ void run(const ThreadParams& p, long long frame,
                                      bool valid, uint32_t* ring,
                                      long long stride,
                                      const unsigned char* llr, int lane,
                                      int nl, unsigned mask) {
    const bool bf16 = p.bf16_bm != 0;
    const int esize = p.llr_dtype == VIT_F32 ? 4 : 2;
    const int cw = vit_thread_chunk_words(BETA) * 4;    // a frame's row
    const int bufb = 32 * cw;                          // a buffer
    const uint32_t sllr = static_cast<uint32_t>(__cvta_generic_to_shared(llr));
    const long long frame0 = frame - lane;
    const int last = p.v1 + p.f + p.v2s;
    const int nchunk = (last + VIT_THREAD_CHUNK - 1) / VIT_THREAD_CHUNK;
    int next_e = p.v1 + p.f0 - 1 + p.v2s;
    int* o = p.out + frame * p.f;               // the next subframe's bits
    const bool vec = p.f % 4 == 0 && p.f0 % 4 == 0;
    vit_thread_stage<BETA>(p, esize, frame0, nl, 0, sllr, lane, nl);
    vit_cp_commit();
    vit_cp_wait();
    __syncwarp(mask);
    if (nchunk > 1)
      vit_thread_stage<BETA>(p, esize, frame0, nl, 1, sllr + bufb, lane, nl);
    vit_cp_commit();
    float x[BETA];
    vit_thread_read<BETA>(llr + lane * cw, p.llr_dtype, x);
#pragma unroll
    for (int s = 0; s < S; ++s) pm[s] = 0.f;
    int slot = 0;
#pragma unroll 1
    for (int t = 0; t < last; ++t) {
      const int tn = t + 1, c = tn / VIT_THREAD_CHUNK;
      float xn[BETA];
      if ((tn & (VIT_THREAD_CHUNK - 1)) == 0 && tn < last) {
        vit_cp_wait();                   // chunk c is in; c - 1 is read
        __syncwarp(mask);
        if (c + 1 < nchunk)
          vit_thread_stage<BETA>(p, esize, frame0, nl, c + 1,
                                 sllr + ((c + 1) & 1) * bufb, lane, nl);
        vit_cp_commit();
      }
      vit_thread_read<BETA>(
          llr + (c & 1) * bufb + lane * cw +
              (tn & (VIT_THREAD_CHUNK - 1)) * BETA * esize,
          p.llr_dtype, xn);
      unsigned w[W];
      step(p, x, bf16, w);
      uint32_t* row = ring + (long long)slot * W * stride;
#pragma unroll
      for (int i = 0; i < W; ++i) row[i * stride] = w[i];
      if (t == next_e) {
        traceback(p, p.start_fixed ? 0 : first_max(), slot, ring, stride,
                  valid, vec, o);
        next_e = next_e + p.f0 < last ? next_e + p.f0 : 0x7fffffff;
      }
      slot = slot + 1 == p.Z ? 0 : slot + 1;
#pragma unroll
      for (int b = 0; b < BETA; ++b) x[b] = xn[b];
    }
  }
};

template <int K, int BETA>
__global__ void __launch_bounds__(VIT_BLOCK_THREADS)
    viterbi_unified_thread_kernel(const __grid_constant__ ThreadParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long frame = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nl = min(32, (int)blockDim.x - warp * 32);   // the warp's lanes
  const unsigned mask = nl == 32 ? VIT_FULL : (1u << nl) - 1u;
  const unsigned char* llr =
      smem + vit_thread_ring_bytes(K, p.f0, p.v2s, blockDim.x) +
      warp * 2LL * 32 * vit_thread_chunk_words(BETA) * 4;
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem) + threadIdx.x;
  const long long stride = blockDim.x;
  const bool valid = frame < p.F;
  if (p.taps) {
    VitThread<K, BETA, true> fr;
    fr.run(p, frame, valid, ring, stride, llr, lane, nl, mask);
  } else {
    VitThread<K, BETA, false> fr;
    fr.run(p, frame, valid, ring, stride, llr, lane, nl, mask);
  }
}

using ThreadKernel = void (*)(const ThreadParams);

// The thread kernel of a (k, beta) code the mapping takes, else null.
template <int K>
inline ThreadKernel thread_kernel_beta(int beta) {
  switch (beta) {
    case 2: return viterbi_unified_thread_kernel<K, 2>;
    case 3: return viterbi_unified_thread_kernel<K, 3>;
    default: return nullptr;
  }
}
inline ThreadKernel thread_kernel(int k, int beta) {
  switch (k) {
    case 3: return thread_kernel_beta<3>(beta);
    case 4: return thread_kernel_beta<4>(beta);
    case 5: return thread_kernel_beta<5>(beta);
    case 6: return thread_kernel_beta<6>(beta);
    case 7: return thread_kernel_beta<7>(beta);
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block of fpb frames (global_scratch != 0:
// survivors and traceback starts live in device memory instead; the wide
// mapping's always do; a large code's block is one frame).
long long viterbi_unified_smem_bytes(int k, int beta, int L, int nsub,
                                     int pack, int start_fixed, int fpb,
                                     int global_scratch) {
  return unified_smem(k, beta, L, nsub, pack, start_fixed, fpb,
                      global_scratch);
}

// Whether (k, beta) runs on the wide mapping: 1 or 0.
int viterbi_wide_code(int k, int beta) { return vit_wide_code(k, beta); }

// Threads of one wide-mapping block of a k code.
int viterbi_wide_threads(int k) { return vit_wide_threads(k); }

// The cluster a k code runs on by default (1: none), and, for a cluster
// of C, its blocks' threads and dynamic shared memory; -1 where the
// mapping does not take (k, C).
int viterbi_cluster_size(int k) { return vit_cluster_size(k); }
int viterbi_cluster_threads(int k, int C) {
  return vit_cluster_ok(k, C) ? vit_cluster_threads(k, C) : -1;
}
long long viterbi_cluster_smem_bytes(int k, int C) {
  return vit_cluster_ok(k, C) ? vit_cluster_smem_bytes(k, C) : -1;
}

// Threads of a one-block frame of a (k, beta) code (the large codes'
// mapping), and the dynamic shared memory of a block with its survivors in
// shared memory (global_scratch 0) or in the scratch; -1 where the form
// does not take k.
int viterbi_block_threads(int k, int beta) {
  return vit_block_ok(k) ? vit_block_threads(k, beta) : -1;
}
long long viterbi_unified_block_smem_bytes(int k, int L, int nsub, int pack,
                                           int start_fixed,
                                           int global_scratch) {
  return vit_block_ok(k) ? smem_layout_block(k, L, nsub, pack, start_fixed,
                                             global_scratch)
                               .total
                         : -1;
}

// *out = the blocks of `smem` bytes of the one-block kernel that runs a
// (k, beta) code the card keeps resident on one SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Returns 0 or the CUDA
// error.
int viterbi_unified_block_occupancy(int k, int beta, long long smem,
                                    int* out) {
  if (!vit_block_ok(k) || beta < 2 || beta > VIT_WIDE_MAX_BETA)
    return (int)cudaErrorInvalidValue;
  return vit_dispatch_block<LaunchBlock>(k, beta, k, beta, smem, out);
}

// out = {numRegs, localSizeBytes, maxThreadsPerBlock} of the one-block
// kernel that runs a (k, beta) code. Returns 0 or the CUDA error.
int viterbi_unified_block_attrs(int k, int beta, int* out) {
  if (!vit_block_ok(k) || beta < 2 || beta > VIT_WIDE_MAX_BETA)
    return (int)cudaErrorInvalidValue;
  return vit_dispatch_block<AttrsBlock>(k, beta, out);
}

// *out = the clusters of C blocks of the cluster kernel that runs (k,
// beta) the card keeps resident at once (cudaOccupancyMaxActiveClusters).
// Returns 0 or the CUDA error.
int viterbi_unified_max_clusters(int k, int beta, int C, int* out) {
  if (!vit_cluster_ok(k, C) || beta < 2 || beta > VIT_WIDE_MAX_BETA)
    return (int)cudaErrorInvalidValue;
  return vit_dispatch_cluster<LaunchCluster>(k, beta, C, k, C, out);
}

// out = {numRegs, localSizeBytes, maxThreadsPerBlock} of the cluster
// kernel that runs (k, beta) on a cluster of C. Returns 0 or the error.
int viterbi_unified_cluster_attrs(int k, int beta, int C, int* out) {
  if (!vit_cluster_ok(k, C) || beta < 2 || beta > VIT_WIDE_MAX_BETA)
    return (int)cudaErrorInvalidValue;
  return vit_dispatch_cluster<AttrsCluster>(k, beta, C, out);
}

// out = {numRegs, localSizeBytes, maxThreadsPerBlock} of the instantiation
// that runs (k, beta) off a cluster: the one-block kernel for a large code,
// the wide kernel for every code past them. Returns 0 or the CUDA error.
int viterbi_unified_func_attrs(int k, int beta, int* out) {
  if (k < 2 || k > VIT_WIDE_MAX_K || beta < 2 || beta > VIT_WIDE_MAX_BETA)
    return (int)cudaErrorInvalidValue;
  if (vit_wide_code(k, beta))
    return vit_func_attrs(
        reinterpret_cast<const void*>(viterbi_unified_wide_kernel), out);
  if (k >= VIT_SMEM_MIN_K)
    return vit_dispatch_block<AttrsBlock>(k, beta, out);
  return vit_dispatch<Attrs>(k, beta, out);
}

// The limits the tile planner (kernels/autotune.py) models, for `device`:
// out = {opt-in shared memory per block, shared memory per SM, threads per
// SM, resident blocks per SM, shared memory the runtime reserves per
// block, 32-bit registers per SM}. Returns 0, or the CUDA error of the
// first query that fails.
int viterbi_device_limits(int device, int* out) {
  const cudaDeviceAttr attrs[6] = {
      cudaDevAttrMaxSharedMemoryPerBlockOptin,
      cudaDevAttrMaxSharedMemoryPerMultiprocessor,
      cudaDevAttrMaxThreadsPerMultiProcessor,
      cudaDevAttrMaxBlocksPerMultiprocessor,
      cudaDevAttrReservedSharedMemoryPerBlock,
      cudaDevAttrMaxRegistersPerMultiprocessor};
  for (int i = 0; i < 6; ++i) {
    const cudaError_t err = cudaDeviceGetAttribute(&out[i], attrs[i], device);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = ok).
// The wide mapping (every code outside the fast mappings' domain, or any
// code with wide != 0, which the wrapper passes only to test the mapping)
// takes `grid` blocks, survivors and starts in the scratch (grid of [L][row]
// bytes and of [nsub] int32) and the path metrics in pm_global
// (grid of [2][S] float32); with cluster > 1 it runs on `grid` clusters of
// that many blocks instead (the scratch per cluster, no pm_global). The
// large codes (or any code the one-block form takes, with block != 0, which
// the wrapper passes only to test it) take `grid` blocks of one frame at a
// time, survivors and starts in shared memory or, with sel_global, in the
// scratch (grid of each). The register mapping takes fpb frames a block.
int viterbi_unified_launch(const void* llr, const void* idx, const void* sgn,
                           const void* signs_half, const void* polys,
                           void* out, void* sel_global, void* amax_global,
                           void* pm_global, int F, int L, int beta, int k,
                           int v1, int f, int f0, int v2s, int llr_dtype,
                           int start_fixed, int pack, int bf16_bm, int fpb,
                           int wide, int grid, int cluster, int block,
                           void* stream) {
  if (block && (wide || cluster > 1)) return (int)cudaErrorInvalidValue;
  wide = wide || cluster > 1 || vit_wide_code(k, beta);
  block = block || (!wide && k >= VIT_SMEM_MIN_K);
  if (k < 2 || k > VIT_WIDE_MAX_K || beta < 2 ||
      beta > VIT_WIDE_MAX_BETA || f0 < 1 || f % f0 != 0 || F < 1 ||
      (sel_global == nullptr) != (amax_global == nullptr))
    return (int)cudaErrorInvalidValue;
  if (wide ? (sel_global == nullptr || polys == nullptr || grid < 1 ||
              (cluster > 1 ? (!vit_cluster_ok(k, cluster) ||
                              pm_global != nullptr)
                           : pm_global == nullptr))
      : block ? (!vit_block_ok(k) || polys == nullptr || grid < 1 ||
                 pm_global != nullptr)
              : (fpb < 1 || fpb > vit_max_frames_per_block(k) ||
                 polys == nullptr))
    return (int)cudaErrorInvalidValue;
  UnifiedParams p;
  p.llr = llr;
  p.idx = static_cast<const int*>(idx);
  p.sgn = static_cast<const float*>(sgn);
  p.signs_half = static_cast<const float*>(signs_half);
  p.out = static_cast<int*>(out);
  p.sel_global = static_cast<unsigned char*>(sel_global);
  p.amax_global = static_cast<int*>(amax_global);
  p.polys = static_cast<const int*>(polys);
  p.pm_global = static_cast<float*>(pm_global);
  p.F = F;
  p.L = L;
  p.k = k;
  p.beta = beta;
  p.v1 = v1;
  p.f = f;
  p.f0 = f0;
  p.v2s = v2s;
  p.nsub = f / f0;
  p.llr_dtype = llr_dtype;
  p.start_fixed = start_fixed;
  p.pack = pack;
  p.bf16_bm = bf16_bm;
  p.fpb = fpb;
  if (cluster > 1)
    return vit_dispatch_cluster<LaunchCluster>(
        k, beta, cluster, &p, cluster, grid,
        static_cast<cudaStream_t>(stream));
  if (wide)
    return launch_wide(&p, grid, static_cast<cudaStream_t>(stream));
  if (block)
    return vit_dispatch_block<LaunchBlock>(
        k, beta, &p,
        smem_layout_block(k, L, p.nsub, pack, start_fixed,
                          sel_global != nullptr)
            .total,
        grid, static_cast<cudaStream_t>(stream));
  const long long smem = unified_smem(k, beta, L, p.nsub, pack, start_fixed,
                                      fpb, sel_global != nullptr);
  return vit_dispatch<Launch>(k, beta, &p, smem,
                              static_cast<cudaStream_t>(stream));
}

// Whether B1's thread mapping takes (k, beta): 1 or 0.
int viterbi_thread_code(int k, int beta) { return vit_thread_code(k, beta); }

// Ring slots of the thread mapping's survivors, and the dynamic shared
// memory of a block of fpb frames (its survivor ring and LLR chunks); -1
// where the mapping does not take (k, beta).
int viterbi_thread_slots(int f0, int v2s) { return vit_thread_slots(f0, v2s); }
long long viterbi_unified_thread_smem_bytes(int k, int beta, int f0, int v2s,
                                            int fpb) {
  return vit_thread_code(k, beta)
             ? vit_thread_smem_bytes(k, beta, f0, v2s, fpb)
             : -1;
}

// out = {numRegs, localSizeBytes, maxThreadsPerBlock} of the thread
// mapping's instantiation for (k, beta). Returns 0 or the CUDA error.
int viterbi_unified_thread_attrs(int k, int beta, int* out) {
  const ThreadKernel kern = thread_kernel(k, beta);
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  return vit_func_attrs(reinterpret_cast<const void*>(kern), out);
}

// Launches the thread mapping on `stream`: blocks of fpb frames (one
// thread each), coef the host's [2][S][2^(beta-1)] edge coefficients,
// taps != 0 where every polynomial has both taps; the survivor ring of
// Z = f0 + v2s stages in the block's shared memory, which the caller sizes
// fpb to fit. Returns cudaGetLastError() (0 = ok).
int viterbi_unified_thread_launch(const void* llr, const float* coef,
                                  void* out, int F, int L,
                                  int beta, int k, int v1, int f, int f0,
                                  int v2s, int llr_dtype, int start_fixed,
                                  int bf16_bm, int taps, int fpb,
                                  void* stream) {
  const ThreadKernel kern = thread_kernel(k, beta);
  if (kern == nullptr || coef == nullptr || F < 1 || fpb < 1 ||
      fpb > VIT_BLOCK_THREADS || f0 < 1 || f % f0 != 0 || v2s < 0 ||
      L < v1 + f + v2s)
    return (int)cudaErrorInvalidValue;
  ThreadParams p;
  p.llr = llr;
  p.out = static_cast<int*>(out);
  p.F = F;
  p.L = L;
  p.v1 = v1;
  p.f = f;
  p.f0 = f0;
  p.v2s = v2s;
  p.Z = vit_thread_slots(f0, v2s);
  p.llr_dtype = llr_dtype;
  p.start_fixed = start_fixed;
  p.bf16_bm = bf16_bm;
  p.taps = taps;
  const int S = 1 << (k - 1), H = 1 << (beta - 1);
  for (int e = 0; e < 2; ++e)
    for (int s = 0; s < VIT_THREAD_MAX_S; ++s)
      for (int h = 0; h < VIT_THREAD_MAX_HALF; ++h)
        p.coef[e][s][h] =
            s < S && h < H ? coef[(e * S + s) * H + h] : 0.f;
  const long long smem = vit_thread_smem_bytes(k, beta, f0, v2s, fpb);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = (F + fpb - 1) / fpb;
  kern<<<grid, fpb, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
