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
// What bounds it. Each step of a chase is one dependent load of a survivor
// word (or byte) from device memory: per cursor f0 + v2s loads in a row.
// The bytes it needs are those words, one argmax per cursor and the (F, f)
// int32 bits out; the latency of the dependent loads is what rules.
//
// Design: one thread per (frame, subframe) cursor, the unified kernel's
// phase 3 with the survivors in device memory (its sel_global mode), the
// chase copied from it (sharing it as one templated device function raised
// the unified kernel's registers from 32 to 45-63 and slowed it; PERF.md)
// and reading either layout. The
// serial traceback is the one cursor per frame with f0 = f, v2s = v2 that
// starts at the last stage from its argmax. In the sublane layout the
// threads of a warp are neighbouring frames of one subframe, so each step's
// loads of a warp fall in one or two rows of frames side by side; in the
// lane layout they are the subframes of a frame.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct TbParams {
  const void* sel;   // lane (F, L, W|S); sublane (L*W|L*S rows, ld) words
  const int* amax;   // (F, L)
  int* out;          // (F, f)
  long long ld;      // sublane: elements between consecutive rows
  int F, L, k, v1, f, f0, v2s, nsub, pack, sublane, start_fixed;
};

__global__ void traceback_frames_kernel(const TbParams p) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= (long long)p.F * p.nsub) return;
  int fr, q;
  if (p.sublane) {
    q = (int)(c / p.F);
    fr = (int)(c - (long long)q * p.F);
  } else {
    fr = (int)(c / p.nsub);
    q = (int)(c - (long long)fr * p.nsub);
  }
  const int S = 1 << (p.k - 1);
  const int W = (S + 31) >> 5;
  const int kshift = p.k - 2;
  const int e = p.v1 + (q + 1) * p.f0 - 1 + p.v2s;   // chase start stage
  int state = p.start_fixed ? 0 : p.amax[(long long)fr * p.L + e];
  const uint32_t* sel32 = static_cast<const uint32_t*>(p.sel);
  const int8_t* sel8 = static_cast<const int8_t*>(p.sel);
  int* o = p.out + (long long)fr * p.f + (long long)q * p.f0;
  const int T = p.f0 + p.v2s;
  for (int r = 0; r < T; ++r) {
    const long long ts = e - r;
    if (r >= p.v2s) o[p.f0 - 1 - (r - p.v2s)] = state >> kshift;
    int bit;
    if (p.pack) {
      const long long w = p.sublane ? (ts * W + (state >> 5)) * p.ld + fr
                                    : ((long long)fr * p.L + ts) * W +
                                          (state >> 5);
      bit = (sel32[w] >> (state & 31)) & 1;
    } else {
      const long long b = p.sublane ? (ts * S + state) * p.ld + fr
                                    : ((long long)fr * p.L + ts) * S + state;
      bit = sel8[b];
    }
    state = ((state << 1) & (S - 1)) | bit;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = ok).
int traceback_frames_launch(const void* sel, const void* amax, void* out,
                            long long ld, int F, int L, int k, int v1, int f,
                            int f0, int v2s, int pack, int sublane,
                            int start_fixed, int threads, void* stream) {
  if (k < 2 || k > 11 || F < 1 || f0 < 1 || f % f0 != 0 || v2s < 0 ||
      v1 < 0 || v1 + f + v2s > L || threads < 32 || threads > 1024 ||
      threads % 32 != 0)
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
  p.pack = pack;
  p.sublane = sublane;
  p.start_fixed = start_fixed;
  const long long cursors = (long long)F * p.nsub;
  const long long grid = (cursors + threads - 1) / threads;
  traceback_frames_kernel<<<(unsigned)grid, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
