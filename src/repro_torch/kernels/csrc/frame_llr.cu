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

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
