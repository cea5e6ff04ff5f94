// Traceback of the split path on Hopper (sm_90a): the second half of the
// prior-work baseline (paper Table I, row b). Reads the survivor stream and
// the per-stage argmax that the forward kernel (viterbi_fwd.cu) wrote to
// device memory and chases them back to decoded bits.
//
// Not a TPU kernel: in the JAX package this step is an XLA lax.scan outside
// Pallas (repro.core.traceback.serial_traceback_frames and
// parallel_traceback_frames, src/repro/core/traceback.py:129,160). Plain
// version: the same functions in repro_torch/core/traceback.py, which the
// output equals bit for bit. It is a kernel because a Python loop of torch
// operations would cost several launches per chase step (77 steps for the
// parallel traceback at the main shape, 321 for the serial one).
//
// What bounds it. Each step of a chase is one dependent read of a survivor
// word (or byte): per cursor f0 + v2s reads in a row. The bytes it needs
// are those words, one argmax per cursor and the (F, f) int32 bits out.
// Read one thread per cursor straight from device memory, each step costs
// a device-memory latency, and in the lane layout every lane of a warp
// reads its own 32-byte sector for 4 bytes.
//
// Design. A block takes a group of G frames (the wrapper picks G and the
// mode, traceback_frames.py's chase_plan states the rule) and runs their
// G * nsub cursors, one per thread, one step at a time (a step's read
// depends on the step before). Two modes:
//   * staged: the stages the cursors read ([v1, v1 + f + v2s) of each
//     frame) are copied into shared memory first, then chased there, so a
//     step costs a shared-memory latency and the device-memory reads
//     stream. Lane layout: the group's window is one contiguous range,
//     copied by one cp.async.bulk (the TMA's 1-D bulk copy) that completes
//     on an mbarrier; the bytes before its first and after its last
//     16-byte boundary (the bulk copy needs 16-byte alignment, and a frame
//     is L * row bytes) are copied by the threads. Sublane layout: each
//     stage row holds the group's G frames side by side, a strided 2-D
//     tile (rows at the stream's stride ld, which a frame slice need not
//     align to 16 bytes), copied with cp.async (4-byte words) or, for int8
//     rows, by the threads. The copies of one block overlap the chases of
//     the others: the group is sized so that several blocks share an SM;
//   * direct: the cursors chase the stream in device memory. Taken where a
//     stage row is wide, and copying whole rows would read far more than
//     the chase's one sector per step.
// Any code up to k = 31 (a state is an int): the rows of the codes past
// k = 15 (4 KB a stage packed at k = 16) are chased direct by the rule.
// Frames are fastest within a warp (neighbouring words of a sublane row;
// banks spread by the frame stride in shared memory), except in the direct
// lane chase, where a frame's subframes are (a warp reads a few frames'
// rows). In both modes each cursor shifts its bits into a register word
// and ORs it into a packed bit buffer in shared memory (atomicOr: a
// subframe's bits may share a word with its neighbour's); then the block
// writes the group's (G, f) int32 bits out with 16-byte stores,
// neighbouring threads on neighbouring addresses.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct TbParams {
  const void* sel;   // lane (F, L, W|S); sublane (L*W|L*S rows, ld) words
  const int* amax;   // (F, L)
  int* out;          // (F, f)
  long long ld;      // sublane: elements between consecutive rows
  int F, L, k, v1, f, f0, v2s, nsub, start_fixed;
  int G;             // frames per block
};

// Shared-memory carve-up of one block: the mbarrier (16 bytes), the packed
// bits [ceil(G f / 32)] words padded to 16 bytes, then (staged) the slab:
// lane, the group's window with 16 bytes of alignment slack; sublane,
// [(f + v2s) * rows per stage][G] elements.
struct TbLayout {
  long long bits, slab, total;
};

__host__ __device__ inline TbLayout tb_layout(int k, int f, int v2s, int L,
                                              int pack, int sublane, int G,
                                              int staged) {
  const long long S = 1LL << (k - 1);
  const long long W = (S + 31) >> 5;
  const long long row = pack ? 4 * W : S;       // bytes of one stage row
  TbLayout t;
  t.bits = 16;
  t.slab = t.bits + (((long long)G * f + 31) / 32 * 4 + 15) / 16 * 16;
  long long slab = 0;
  if (staged) {
    const long long win = f + v2s;              // stages the chase reads
    if (sublane)
      slab = win * (pack ? W * 4 : S) * G;
    else
      slab = ((long long)(G - 1) * L + win) * row + 16;
  }
  t.total = t.slab + slab;
  return t;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// One bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from device memory into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src,
                                         unsigned bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

__device__ __forceinline__ int word_bit(uint32_t w, int st) {
  return (int)((w >> (st & 31)) & 1u);
}

// One cursor's chase, one step at a time as the plain version: at step r
// (stage e - r), from step v2s on, the state's input bit goes out (highest
// position first, shifted into a register word that is ORed into the
// block's bit buffer at each 32-bit word's lowest position); then state =
// ((state << 1) & (S-1)) | sel_bit(stage, state).
template <class SelBit>
__device__ __forceinline__ void chase_cursor(int state, int e, int T,
                                             int v2s, int S, int kshift,
                                             int pos, unsigned* bits,
                                             SelBit sel_bit) {
  unsigned acc = 0;
  for (int r = 0; r < T; ++r) {
    if (r >= v2s) {
      acc = (acc << 1) | (unsigned)(state >> kshift);
      if ((pos & 31) == 0 || r == T - 1) {
        atomicOr(&bits[pos >> 5], acc << (pos & 31));
        acc = 0;
      }
      --pos;
    }
    state = ((state << 1) & (S - 1)) | sel_bit(e - r, state);
  }
}

// One instantiation per mode, layout and packing, so the chase's step has
// no branch on them.
template <bool STAGED, bool SUB, bool PACK>
__global__ void __launch_bounds__(1024)
    traceback_frames_kernel(const TbParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = 1 << (p.k - 1);
  const int W = (S + 31) >> 5;
  const long long row = PACK ? 4LL * W : S;
  const int win = p.f + p.v2s;
  const int fr0 = blockIdx.x * p.G;
  const int nf = min(p.G, p.F - fr0);
  const TbLayout lay = tb_layout(p.k, p.f, p.v2s, p.L, PACK, SUB, p.G,
                                 STAGED);
  unsigned* bits = reinterpret_cast<unsigned*>(smem + lay.bits);
  unsigned char* slab = smem + lay.slab;
  const uint32_t bar = smem_addr(smem);
  const int tid = threadIdx.x;
  const unsigned char* sel8 = static_cast<const unsigned char*>(p.sel);

  // ---- stage the group's survivors (staged mode) -------------------------
  unsigned head = 0;             // lane: slab offset of the window's byte 0
  bool bulk = false;
  if (STAGED && !SUB) {
    const unsigned char* a =
        sel8 + ((long long)fr0 * p.L + p.v1) * row;
    const unsigned char* e =
        sel8 + ((long long)(fr0 + nf - 1) * p.L + p.v1 + win) * row;
    head = (unsigned)(reinterpret_cast<uintptr_t>(a) & 15);
    const unsigned char* a16 = reinterpret_cast<const unsigned char*>(
        (reinterpret_cast<uintptr_t>(a) + 15) & ~(uintptr_t)15);
    const unsigned char* e16 = reinterpret_cast<const unsigned char*>(
        reinterpret_cast<uintptr_t>(e) & ~(uintptr_t)15);
    bulk = e16 > a16;
    if (tid == 0 && bulk) {
      mbar_init(bar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (tid == 0 && bulk) {
      const unsigned n = (unsigned)(e16 - a16);
      mbar_expect_tx(bar, n);
      bulk_g2s(smem_addr(slab + head + (a16 - a)), a16, n, bar);
    }
    // the bytes outside the 16-byte-aligned middle, by the threads
    const long long nbytes = e - a;
    const long long lo = bulk ? a16 - a : nbytes;
    const long long hi = bulk ? e16 - a : nbytes;
    for (long long i = tid; i < lo; i += blockDim.x) slab[head + i] = a[i];
    for (long long i = hi + tid; i < nbytes; i += blockDim.x)
      slab[head + i] = a[i];
  } else if (STAGED) {
    const int rps = PACK ? W : S;               // rows per stage
    const long long rows = (long long)win * rps;
    const long long r0 = (long long)p.v1 * rps;
    if (PACK) {
      const uint32_t* src = static_cast<const uint32_t*>(p.sel);
      const uint32_t dst = smem_addr(slab);
      for (long long i = tid; i < rows * nf; i += blockDim.x) {
        const long long r = i / nf;
        const int fl = (int)(i - r * nf);
        cp_async4(dst + (uint32_t)((r * p.G + fl) * 4),
                  src + (r0 + r) * p.ld + fr0 + fl);
      }
      cp_async_wait_all();
    } else {
      for (long long i = tid; i < rows * nf; i += blockDim.x) {
        const long long r = i / nf;
        const int fl = (int)(i - r * nf);
        slab[r * p.G + fl] = sel8[(r0 + r) * p.ld + fr0 + fl];
      }
    }
  }
  const int nbits = (p.G * p.f + 31) / 32;
  for (int i = tid; i < nbits; i += blockDim.x) bits[i] = 0u;
  if (bulk) mbar_wait(bar, 0);
  __syncthreads();

  // ---- the chase: one cursor per thread ----------------------------------
  const int kshift = p.k - 2;
  const int T = p.f0 + p.v2s;
  const uint32_t* s32 = static_cast<const uint32_t*>(p.sel);
  for (int c = tid; c < nf * p.nsub; c += blockDim.x) {
    int q, fl;                        // subframe, frame within the group
    if (!STAGED && !SUB) {
      fl = c / p.nsub;
      q = c - fl * p.nsub;
    } else {
      q = c / nf;
      fl = c - q * nf;
    }
    const long long fr = fr0 + fl;
    const int e = p.v1 + (q + 1) * p.f0 - 1 + p.v2s;     // chase start stage
    const int state0 = p.start_fixed ? 0 : p.amax[fr * p.L + e];
    const int pos = fl * p.f + q * p.f0 + p.f0 - 1;      // its highest bit
    const int v1 = p.v1, L = p.L, G = p.G;
    const long long ld = p.ld;
    if constexpr (STAGED && !SUB) {
      const unsigned char* fs = slab + head + ((long long)fl * L - v1) * row;
      chase_cursor(state0, e, T, p.v2s, S, kshift, pos, bits,
                   [=](int ts, int st) {
                     const unsigned char* r8 = fs + (long long)ts * row;
                     return PACK ? word_bit(reinterpret_cast<const uint32_t*>(
                                                r8)[st >> 5], st)
                                 : (int)r8[st];
                   });
    } else if constexpr (STAGED) {
      chase_cursor(state0, e, T, p.v2s, S, kshift, pos, bits,
                   [=](int ts, int st) {
                     const long long lt = ts - v1;
                     return PACK ? word_bit(reinterpret_cast<const uint32_t*>(
                                                slab)[(lt * W + (st >> 5)) *
                                                          G + fl], st)
                                 : (int)slab[(lt * S + st) * G + fl];
                   });
    } else {
      chase_cursor(state0, e, T, p.v2s, S, kshift, pos, bits,
                   [=](int ts, int st) {
                     if (PACK)
                       return word_bit(
                           __ldg(s32 + (SUB ? ((long long)ts * W + (st >> 5)) *
                                                  ld + fr
                                            : (fr * L + ts) * W + (st >> 5))),
                           st);
                     return (int)sel8[SUB ? ((long long)ts * S + st) * ld + fr
                                          : (fr * L + ts) * S + st];
                   });
    }
  }
  __syncthreads();

  // ---- the group's (nf, f) bits out: 16-byte stores ----------------------
  int* o = p.out + (long long)fr0 * p.f;
  const long long n = (long long)nf * p.f;
  const long long h = min(n, (long long)((16 - (reinterpret_cast<uintptr_t>(
                                                  o) & 15)) & 15) / 4);
  auto bit_at = [&](long long i) -> int {
    return (int)((bits[i >> 5] >> (i & 31)) & 1u);
  };
  for (long long i = tid; i < h; i += blockDim.x) o[i] = bit_at(i);
  const long long nv = (n - h) / 4;
  int4* o4 = reinterpret_cast<int4*>(o + h);
  for (long long i = tid; i < nv; i += blockDim.x) {
    const long long j = h + 4 * i;
    o4[i] = make_int4(bit_at(j), bit_at(j + 1), bit_at(j + 2), bit_at(j + 3));
  }
  for (long long i = h + 4 * nv + tid; i < n; i += blockDim.x)
    o[i] = bit_at(i);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block (see TbLayout).
long long traceback_frames_smem_bytes(int k, int f, int v2s, int L, int pack,
                                      int sublane, int G, int staged) {
  return tb_layout(k, f, v2s, L, pack, sublane, G, staged).total;
}

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = ok).
int traceback_frames_launch(const void* sel, const void* amax, void* out,
                            long long ld, int F, int L, int k, int v1, int f,
                            int f0, int v2s, int pack, int sublane,
                            int start_fixed, int G, int staged, int threads,
                            void* stream) {
  if (k < 2 || k > 31 || F < 1 || f0 < 1 || f % f0 != 0 || v2s < 0 ||
      v1 < 0 || v1 + f + v2s > L || threads < 32 || threads > 1024 ||
      threads % 32 != 0 || G < 1)
    return (int)cudaErrorInvalidValue;
  TbParams p;
  p.sel = sel;
  p.amax = static_cast<const int*>(amax);
  p.out = static_cast<int*>(out);
  p.ld = ld;
  p.F = F;
  p.L = L;
  p.k = k;
  p.v1 = v1;
  p.f = f;
  p.f0 = f0;
  p.v2s = v2s;
  p.nsub = f / f0;
  p.start_fixed = start_fixed;
  p.G = G;
  const long long smem =
      tb_layout(k, f, v2s, L, pack, sublane, G, staged).total;
  const int grid = (F + G - 1) / G;
  auto go = [&](auto kernel) -> int {
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    kernel<<<grid, threads, (size_t)smem,
             static_cast<cudaStream_t>(stream)>>>(p);
    return (int)cudaGetLastError();
  };
  switch ((staged ? 4 : 0) | (sublane ? 2 : 0) | (pack ? 1 : 0)) {
    case 0: return go(traceback_frames_kernel<false, false, false>);
    case 1: return go(traceback_frames_kernel<false, false, true>);
    case 2: return go(traceback_frames_kernel<false, true, false>);
    case 3: return go(traceback_frames_kernel<false, true, true>);
    case 4: return go(traceback_frames_kernel<true, false, false>);
    case 5: return go(traceback_frames_kernel<true, false, true>);
    case 6: return go(traceback_frames_kernel<true, true, false>);
    default: return go(traceback_frames_kernel<true, true, true>);
  }
}

}  // extern "C"
