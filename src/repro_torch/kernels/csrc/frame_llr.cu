// The receiver call's clip and framing on Hopper (sm_90a): (n, beta) LLRs
// in, (F, L, beta) overlapping frames out, the LLRs clipped on the way
// when asked:
//
//   out[m, j, b] = g(x[m*f - v1 + j, b])  where 0 <= m*f - v1 + j < n,
//                  else 0;
//   g(v) = isfinite(v) ? min(max(v, -clip), clip) : 0   (clip on)
//   g(v) = v                                            (clip off)
//
// Not a TPU kernel: in the JAX package the clip is jnp.where/jnp.clip in
// repro.core.pipeline.make_decoder and the framing jnp.pad plus a gather in
// repro.core.framed.frame_llr, which XLA fuses. Plain version:
// repro_torch/kernels/framing.py's frame_llr_plain (ATen's isfinite, where,
// clamp, pad and index), which the output equals bit for bit: the same
// arithmetic per dtype (float for float16 and bfloat16, double for
// float64; the clip's bounds rounded to the dtype first, as ATen's clamp
// does), -0.0 kept, every non-finite value +0.0, and with the clip off
// the bits copied as they are.
//
// What bounds it. Bytes: one read of the LLRs and one write of the frames,
// L/f times as many (1.25 at the paper's frame); there is no arithmetic to
// speak of. At 2^24 bits of K=7 rate 1/2 in float32 that is 134 MB in and
// 168 MB out, 0.090 ms at 3.35 TB/s.
//
// Design. The frames lie one after another in the output, and frame m is
// the contiguous window of L*beta input elements that starts at element
// (m*f - v1)*beta. So the output is cut into 16-byte vectors, one thread
// each, U = 4 vectors a thread in flight (loads first, then stores), a
// warp's vectors side by side: every store is 16 bytes and coalesced. A
// vector inside one frame and inside the input reads its V elements from
// one contiguous run of the input, with the widest loads that run's
// alignment allows: 16 bytes where it lines up with the output (every
// frame at beta = 4, the even frames at beta = 2 in float32), else two
// 8-byte loads (the odd frames at beta = 2) or narrower. A vector that
// straddles two frames or an edge of the input takes its elements one at a
// time, and zeros where the window runs past the stream. An input row is
// read by at most two frames (v1 + v2 < f): the second read is a
// neighbouring vector's, from L1 or L2. The input is one contiguous run
// (the wrapper copies a non-contiguous tensor first).
//
// The punctured receiver call (frame_punctured_kernel, its own entry
// point frame_punctured_launch): the (m,) soft symbols of a pattern of
// `period` stages of the mother code in, the (rows, L, beta) frames that
// B1 reads out, rows = F padded to B1's tile, in one launch that replaces
// the clip, the depuncture's fill and strided copies, the framing and the
// pad's fill and copy:
//
//   s = m*f - v1 + j,  t = s mod period,
//   out[m, j, b] = g(x[(s div period)*kept + rank[t*beta + b]])
//                  where 0 <= s < n, m < F and the pattern keeps (b, t),
//                = 0 otherwise (an erasure, an edge or a padding row);
//
// g the clip above, rank the period's prefix count of kept symbols in the
// order they are sent (at most 64 entries, passed by value). Plain
// version: framing.py's frame_punctured_plain, equal bit for bit to the
// chain it replaces (clip_llr_plain, depuncture, frame_llr_plain, zero
// rows). Not a TPU kernel: XLA fuses repro.core.puncture.depuncture and
// frame_llr's jnp ops there.
//
// What bounds it. Bytes: one read of the symbols, one write of the
// frames. At the k7_r34_batch call (2^24 stages of K=7 rate 3/4, f = 252,
// L = 318, float32; 66576 frames padded to 66624 at tile 64) that is 89.5
// MB in and 169.5 MB out, 0.0773 ms at 3.35 TB/s; the ATen chain it
// replaces took 0.9365 ms on an H100 80GB HBM3 at 700 W.
//
// Design. The output is cut into 16-byte vectors as above, U = 4 a thread,
// every store 16 bytes and coalesced. Frames start on a period boundary,
// so inside a frame that lies wholly within the stream (all but about one
// frame at each end) a vector's elements come from one run of symbols from
// the first of its first element's period: the launch builds, for each
// phase p of a period at which a vector can start, the V offsets of its
// elements into that run (-1 for an erasure), and a block keeps that table
// in shared memory. Such a vector costs two divisions by a multiply and a
// shift (its frame; its period) and one table read, and gathers its kept
// elements with 4-byte __ldg loads, which L1 merges across the warp. A
// vector at a frame's edge, in a padding row or at the output's end walks
// its elements one by one (gather_edge, out of line). Measured on the
// card at the cell's call, in turns with the ATen chain: this design
// 0.0967 ms (79.9 % of the bytes bound); the same with each block's run of
// symbols first staged in shared memory by 16-byte loads, 0.1355 ms (57.1
// %: the stores wait on the block's barrier); the first version, which
// walked every element from its frame and stage, 0.1515 ms (51.0 %), and
// staged, 0.1927 ms (40.1 %): integer work, not bytes, bounded it.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>

namespace {

// A dtype: its raw bits R, the arithmetic C of its clip, and the moves
// between them.
struct F32 {
  using R = uint32_t;
  using C = float;
  static __device__ __forceinline__ C to_c(R r) { return __uint_as_float(r); }
  static __device__ __forceinline__ R to_r(C c) { return __float_as_uint(c); }
};
struct F64 {
  using R = unsigned long long;
  using C = double;
  static __device__ __forceinline__ C to_c(R r) {
    return __longlong_as_double(static_cast<long long>(r));
  }
  static __device__ __forceinline__ R to_r(C c) {
    return static_cast<R>(__double_as_longlong(c));
  }
};
struct F16 {
  using R = uint16_t;
  using C = float;
  static __device__ __forceinline__ C to_c(R r) {
    return __half2float(__ushort_as_half(r));
  }
  static __device__ __forceinline__ R to_r(C c) {
    return __half_as_ushort(__float2half_rn(c));
  }
};
struct BF16 {
  using R = uint16_t;
  using C = float;
  static __device__ __forceinline__ C to_c(R r) {
    return __bfloat162float(__ushort_as_bfloat16(r));
  }
  static __device__ __forceinline__ R to_r(C c) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(c));
  }
};

// The clip of one element. lo and hi are the bounds as the dtype holds
// them, so every result is a value of the dtype and converts back exactly.
// A finite v below lo is lo, above hi is hi, else v itself (-0.0 kept).
template <class D>
__device__ __forceinline__ typename D::R clip_elem(typename D::R r,
                                                   typename D::C lo,
                                                   typename D::C hi) {
  const typename D::C v = D::to_c(r);
  if (!isfinite(v)) return 0;                 // +0.0 in every dtype
  return D::to_r(v < lo ? lo : (v > hi ? hi : v));
}

struct FrameArgs {
  long long N;       // input elements, n * beta
  long long total;   // output elements, F * L * beta
  long long S;       // input elements between frame starts, f * beta
  long long P;       // left overlap in elements, v1 * beta
  long long nvec;    // output vectors, ceil(total / V)
  int W;             // elements a frame, L * beta
};

constexpr int THREADS = 256;
constexpr int U = 4;   // vectors a thread

template <class D>
union Vec {
  static constexpr int V = 16 / sizeof(typename D::R);
  uint4 q;
  uint2 d[2];
  uint32_t w[4];
  uint16_t h[8];
  typename D::R e[V];
};

// Gather the V elements of output vector q (elements o0 .. o0 + V - 1).
template <class D>
__device__ __forceinline__ Vec<D> gather(const unsigned char* __restrict__ x,
                                         const FrameArgs& a, long long q) {
  using R = typename D::R;
  constexpr int V = Vec<D>::V;
  constexpr int ES = sizeof(R);
  Vec<D> r;
  const long long o0 = q * V;
  long long m;
  if (a.total <= 0xffffffffLL)                // uniform: 32-bit division
    m = static_cast<unsigned>(o0) / static_cast<unsigned>(a.W);
  else
    m = o0 / a.W;
  const long long t = o0 - m * a.W;
  const long long s0 = m * a.S - a.P + t;
  if (t + V <= a.W && s0 >= 0 && s0 + V <= a.N && o0 + V <= a.total) {
    const unsigned char* p = x + s0 * ES;
    const unsigned al = static_cast<unsigned>(reinterpret_cast<uintptr_t>(p))
                        & 15u;
    if (al == 0) {
      r.q = __ldg(reinterpret_cast<const uint4*>(p));
    } else if ((al & 7u) == 0) {
      const uint2* p2 = reinterpret_cast<const uint2*>(p);
      r.d[0] = __ldg(p2);
      r.d[1] = __ldg(p2 + 1);
    } else if ((al & 3u) == 0) {
      const uint32_t* p4 = reinterpret_cast<const uint32_t*>(p);
#pragma unroll
      for (int i = 0; i < 4; ++i) r.w[i] = __ldg(p4 + i);
    } else {                                  // 2-byte dtypes only
      const unsigned short* p2 = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
      for (int i = 0; i < 8; ++i) r.h[i] = __ldg(p2 + i);
    }
    return r;
  }
  // a frame boundary, an edge of the input or the output's last vector
  const R* xe = reinterpret_cast<const R*>(x);
#pragma unroll
  for (int e = 0; e < V; ++e) {
    long long me = m, te = t + e;
    while (te >= a.W) {                       // frames shorter than V too
      te -= a.W;
      ++me;
    }
    const long long s = me * a.S - a.P + te;
    r.e[e] = (o0 + e < a.total && s >= 0 && s < a.N) ? __ldg(xe + s) : R(0);
  }
  return r;
}

template <class D, bool CLIP>
__global__ void __launch_bounds__(THREADS)
frame_llr_kernel(const unsigned char* __restrict__ x,
                 unsigned char* __restrict__ out, FrameArgs a,
                 typename D::C lo, typename D::C hi) {
  using R = typename D::R;
  constexpr int V = Vec<D>::V;
  const long long base = static_cast<long long>(blockIdx.x) * U * THREADS +
                         threadIdx.x;
  Vec<D> buf[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long q = base + static_cast<long long>(u) * THREADS;
    if (q < a.nvec) buf[u] = gather<D>(x, a, q);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long q = base + static_cast<long long>(u) * THREADS;
    if (q >= a.nvec) continue;
    if (CLIP) {
#pragma unroll
      for (int e = 0; e < V; ++e)
        buf[u].e[e] = clip_elem<D>(buf[u].e[e], lo, hi);
    }
    const long long o0 = q * V;
    if (o0 + V <= a.total) {
      *reinterpret_cast<uint4*>(out + o0 * static_cast<long long>(sizeof(R))) =
          buf[u].q;
    } else {
      R* oe = reinterpret_cast<R*>(out);
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (o0 + e < a.total) oe[o0 + e] = buf[u].e[e];
    }
  }
}

template <class D, bool CLIP>
cudaError_t launch(const void* x, void* out, long long n, int beta,
                   long long F, int f, int v1, int L, double lo, double hi,
                   cudaStream_t stream) {
  using C = typename D::C;
  constexpr int V = Vec<D>::V;
  const auto* xb = static_cast<const unsigned char*>(x);
  auto* ob = static_cast<unsigned char*>(out);
  const long long total = F * L * static_cast<long long>(beta);
  if (total == 0) return cudaSuccess;
  if (reinterpret_cast<uintptr_t>(out) & 15u) return cudaErrorInvalidValue;
  FrameArgs a;
  a.N = n * beta;
  a.total = total;
  a.S = static_cast<long long>(f) * beta;
  a.P = static_cast<long long>(v1) * beta;
  a.nvec = (total + V - 1) / V;
  a.W = L * beta;
  const long long blocks = (a.nvec + U * THREADS - 1) / (U * THREADS);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  frame_llr_kernel<D, CLIP><<<static_cast<unsigned>(blocks), THREADS, 0,
                              stream>>>(xb, ob, a, static_cast<C>(lo),
                                        static_cast<C>(hi));
  return cudaGetLastError();
}

template <class D>
cudaError_t launch_clip(int clip, const void* x, void* out, long long n,
                        int beta, long long F, int f, int v1, int L,
                        double lo, double hi, cudaStream_t s) {
  return clip ? launch<D, true>(x, out, n, beta, F, f, v1, L, lo, hi, s)
              : launch<D, false>(x, out, n, beta, F, f, v1, L, lo, hi, s);
}

// ---- the punctured receiver call (see the head note) -----------------

constexpr int MAX_TABLE = 64;   // period * beta entries at most

// x / d by a multiply and a shift, for 0 <= x < 2^31 (Granlund and
// Montgomery; the form of CUTLASS's FastDivmod).
struct FastDiv {
  unsigned d, mul, shr;
  void init(unsigned div) {
    d = div;
    mul = shr = 0;
    if (d != 1) {
      unsigned l = 0;
      while ((1u << l) < d) ++l;              // ceil(log2(d))
      const unsigned p = 31 + l;
      mul = static_cast<unsigned>(((1ull << p) + d - 1) / d);
      shr = p - 32;
    }
  }
  __device__ __forceinline__ unsigned operator()(unsigned x) const {
    return d == 1 ? x : __umulhi(x, mul) >> shr;
  }
};

struct PuncArgs {
  long long m;        // stream symbols
  long long n;        // stages of the mother code
  long long F;        // frames that hold stages; rows F.. are zero
  long long total;    // output elements, rows * L * beta
  long long nvec;     // output vectors, ceil(total / V)
  long long kept;     // symbols a period keeps
  long long fk;       // symbols between frame starts, f / period * kept
  long long vk;       // symbols before frame 0's first, v1 / period * kept
  long long lo, hi;   // frames lo .. hi - 1 lie wholly inside the stream
  int f, v1, L, beta, period;
  int W;              // elements a frame, L * beta
  int PB;             // entries of the table, period * beta
  FastDiv divW, divPB;
  signed char rank[MAX_TABLE];  // at t * beta + b: rank among the period's
                                // kept symbols, -1 where dropped
  uint2 off[MAX_TABLE];         // at p: for a vector whose first element
                                // has phase p, each element's symbol from
                                // that period's first, -1 where dropped
};

// Where output element o0 lies, and how to step to the next: frame m,
// element ein of the frame, output b, stage s, the table's entry idx =
// (s mod period) * beta + b, and sym, the stream index of the first symbol
// of s's period. A frame starts on a period boundary.
struct Walk {
  long long m, s, sym;
  int ein, b, idx;

  __device__ __forceinline__ Walk(const PuncArgs& a, long long o0) {
    m = o0 / a.W;
    ein = static_cast<int>(o0 - m * a.W);
    const int j = ein / a.beta;
    b = ein - j * a.beta;
    const int jd = j / a.period;
    idx = (j - jd * a.period) * a.beta + b;
    const long long s0 = m * a.f - a.v1;      // a multiple of the period
    s = s0 + j;
    sym = (s0 / a.period + jd) * a.kept;
  }

  // The stream index of the element, or -1 for a zero.
  __device__ __forceinline__ long long at(const PuncArgs& a) const {
    const int k = a.rank[idx];
    return (m < a.F && s >= 0 && s < a.n && k >= 0) ? sym + k : -1;
  }

  __device__ __forceinline__ void step(const PuncArgs& a) {
    ++ein;
    if (++b == a.beta) {
      b = 0;
      ++s;
    }
    if (++idx == a.PB) {
      idx = 0;
      sym += a.kept;
    }
    if (ein == a.W) {                         // the next frame
      ein = 0;
      b = 0;
      idx = 0;
      ++m;
      s = m * a.f - a.v1;
      sym = s / a.period * a.kept;
    }
  }
};

// A vector at a frame's edge, in a padding row or in the output's last
// vector: element by element.
template <class D>
__device__ __noinline__ Vec<D> gather_edge(const typename D::R* __restrict__ x,
                                           const PuncArgs& a, long long o0) {
  constexpr int V = Vec<D>::V;
  Vec<D> r;
  Walk w(a, o0);
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const long long k = w.at(a);
    r.e[e] = (k >= 0 && o0 + e < a.total) ? __ldg(x + k)
                                          : typename D::R(0);
    w.step(a);
  }
  return r;
}

template <class D>
__global__ void __launch_bounds__(THREADS)
frame_punctured_kernel(const unsigned char* __restrict__ xb,
                       unsigned char* __restrict__ out,
                       const __grid_constant__ PuncArgs a,
                       typename D::C lo, typename D::C hi) {
  using R = typename D::R;
  constexpr int V = Vec<D>::V;
  __shared__ uint2 off[MAX_TABLE];
  const R* x = reinterpret_cast<const R*>(xb);
  if (static_cast<int>(threadIdx.x) < a.PB)
    off[threadIdx.x] = a.off[threadIdx.x];
  __syncthreads();
  const long long base = static_cast<long long>(blockIdx.x) * U * THREADS +
                         threadIdx.x;
  const bool small = a.total <= 0x7fffffffLL;  // uniform
  Vec<D> buf[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long q = base + static_cast<long long>(u) * THREADS;
    if (q >= a.nvec) continue;
    const long long o0 = q * V;
    long long m;
    int ein;
    if (small) {
      const unsigned um = a.divW(static_cast<unsigned>(o0));
      m = um;
      ein = static_cast<int>(static_cast<unsigned>(o0) - um * a.W);
    } else {
      m = o0 / a.W;
      ein = static_cast<int>(o0 - m * a.W);
    }
    if (m >= a.lo && m < a.hi && ein + V <= a.W) {
      // inside a whole frame: the first symbol of the element's period,
      // and the vector's offsets from it
      const unsigned pi = a.divPB(static_cast<unsigned>(ein));
      const int p = ein - static_cast<int>(pi) * a.PB;
      const R* run = x + (m * a.fk - a.vk + pi * a.kept);
      union {
        uint2 w;
        signed char c[8];
      } o;
      o.w = off[p];
#pragma unroll
      for (int e = 0; e < V; ++e)
        buf[u].e[e] = o.c[e] < 0 ? R(0) : __ldg(run + o.c[e]);
    } else {
      buf[u] = gather_edge<D>(x, a, o0);
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long q = base + static_cast<long long>(u) * THREADS;
    if (q >= a.nvec) continue;
#pragma unroll
    for (int e = 0; e < V; ++e)
      buf[u].e[e] = clip_elem<D>(buf[u].e[e], lo, hi);
    const long long o0 = q * V;
    if (o0 + V <= a.total) {
      *reinterpret_cast<uint4*>(out + o0 * static_cast<long long>(sizeof(R))) =
          buf[u].q;
    } else {
      R* oe = reinterpret_cast<R*>(out);
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (o0 + e < a.total) oe[o0 + e] = buf[u].e[e];
    }
  }
}

template <class D>
cudaError_t launch_punctured(const void* x, void* out, long long m,
                             long long n, int beta, long long F,
                             long long rows, int f, int v1, int L,
                             int period, int kept, const signed char* rank,
                             double lo, double hi, cudaStream_t stream) {
  using C = typename D::C;
  constexpr int V = Vec<D>::V;
  const long long total = rows * L * static_cast<long long>(beta);
  if (total == 0) return cudaSuccess;
  if (reinterpret_cast<uintptr_t>(out) & 15u) return cudaErrorInvalidValue;
  if (period <= 0 || beta <= 0 || period * beta > MAX_TABLE || rows < F ||
      f % period || v1 % period || L % period)
    return cudaErrorInvalidValue;
  PuncArgs a;
  a.m = m;
  a.n = n;
  a.F = F;
  a.total = total;
  a.nvec = (total + V - 1) / V;
  a.kept = kept;
  a.fk = static_cast<long long>(f / period) * kept;
  a.vk = static_cast<long long>(v1 / period) * kept;
  // whole frames: m * f - v1 >= 0 and m * f - v1 + L <= n, m < F
  a.lo = (v1 + f - 1) / f;
  a.hi = n + v1 - L < 0 ? 0 : std::min<long long>(F, (n + v1 - L) / f + 1);
  a.f = f;
  a.v1 = v1;
  a.L = L;
  a.beta = beta;
  a.period = period;
  a.W = L * beta;
  a.PB = period * beta;
  a.divW.init(static_cast<unsigned>(a.W));
  a.divPB.init(static_cast<unsigned>(a.PB));
  for (int i = 0; i < MAX_TABLE; ++i) a.rank[i] = i < a.PB ? rank[i] : -1;
  for (int p = 0; p < MAX_TABLE; ++p) {
    signed char c[8] = {-1, -1, -1, -1, -1, -1, -1, -1};
    for (int e = 0; p < a.PB && e < V; ++e) {
      const int per = (p + e) / a.PB, k = a.rank[(p + e) % a.PB];
      c[e] = static_cast<signed char>(k < 0 ? -1 : per * kept + k);
    }
    memcpy(&a.off[p], c, 8);
  }
  const long long blocks = (a.nvec + U * THREADS - 1) / (U * THREADS);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  frame_punctured_kernel<D><<<static_cast<unsigned>(blocks), THREADS, 0,
                               stream>>>(
      static_cast<const unsigned char*>(x), static_cast<unsigned char*>(out),
      a, static_cast<C>(lo), static_cast<C>(hi));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 float64, 2 float16, 3 bfloat16 (framing.py's DTYPES).
// x: (n, beta) contiguous; out: (F, L, beta) contiguous, 16-byte aligned.
// lo, hi: the clip's bounds as the dtype holds them (clip != 0). Launches
// on `stream` and returns cudaGetLastError().
extern "C" int frame_llr_launch(const void* x, void* out, int dtype,
                                long long n, int beta, long long F, int f,
                                int v1, int L, int clip, double lo, double hi,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_clip<F32>(clip, x, out, n, beta, F, f, v1, L, lo, hi, s);
    case 1:
      return launch_clip<F64>(clip, x, out, n, beta, F, f, v1, L, lo, hi, s);
    case 2:
      return launch_clip<F16>(clip, x, out, n, beta, F, f, v1, L, lo, hi, s);
    case 3:
      return launch_clip<BF16>(clip, x, out, n, beta, F, f, v1, L, lo, hi, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The punctured receiver call: the (m,) soft-symbol stream of a pattern of
// `period` stages and `beta` outputs in, (rows, L, beta) frames out, every
// element clipped, rows F.. zero. rank: period * beta entries (t * beta + b;
// -1 where the pattern drops the symbol), kept the symbols a period keeps.
// f, v1 and L are multiples of the period. lo, hi: the clip's bounds as the
// dtype holds them. Launches on `stream` and returns cudaGetLastError().
extern "C" int frame_punctured_launch(const void* x, void* out, int dtype,
                                      long long m, long long n, int beta,
                                      long long F, long long rows, int f,
                                      int v1, int L, int period, int kept,
                                      const signed char* rank, double lo,
                                      double hi, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_punctured<F32>(x, out, m, n, beta, F, rows, f, v1, L,
                                   period, kept, rank, lo, hi, s);
    case 1:
      return launch_punctured<F64>(x, out, m, n, beta, F, rows, f, v1, L,
                                   period, kept, rank, lo, hi, s);
    case 2:
      return launch_punctured<F16>(x, out, m, n, beta, F, rows, f, v1, L,
                                   period, kept, rank, lo, hi, s);
    case 3:
      return launch_punctured<BF16>(x, out, m, n, beta, F, rows, f, v1, L,
                                    period, kept, rank, lo, hi, s);
    default:
      return cudaErrorInvalidValue;
  }
}
