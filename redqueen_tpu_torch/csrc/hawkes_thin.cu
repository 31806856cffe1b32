// hawkes_thin.cu — Ogata thinning of exponential-kernel Hawkes sources,
// each source's whole stream in one thread, hand-written CUDA C++ for
// Hopper (sm_90a).
//
// Replaces: redqueen_tpu/ops/streams.py:74 `hawkes_stream`, a `lax.scan`
// over `cap + 1` slots (one thinning loop a slot); the JAX package has no
// Pallas kernel for it.  The plain PyTorch version is
// ops/streams.py:_hawkes_stream_plain, a masked loop in which one step is
// one proposal of every source still drawing.
//
// What it computes, for every source i of N (key k_i, l0, alpha, beta):
// the events on (t0, T] of the process whose slot s is the thinning from
// fold_in(k_i, s), carrying the time and the excitation, exactly as the
// plain loop does: each proposal splits its chain key in three (the next
// key, the gap's key, the test's key; split and random_bits of
// ops/prng.py), the gap is -log1p(-u) / bound with the 23-bit uniform of
// jax.random.uniform, the intensity there is
// l0 + exc * exp(min(-beta * (t - exc_t), 80)), and the proposal is
// accepted when u * bound <= intensity.  A chain stops when it accepts,
// passes T, has no positive bound, or has made DEFAULT_MAX_PROPOSALS
// proposals; a slot without an event within T absorbs the source, and so
// does the slot past `cap` (the truncation probe).  An accepted event
// within T starts the next slot's chain from fold_in(k_i, slot) with the
// intensity there as its bound.
//
// Output: the finished stream, what the plain loop's `_finish` gives of
// its [N, cap + 1] slots.  times [N, cap], which the wrapper fills with
// +inf beforehand, gets the events of slots < cap that lie after t0, in
// order and closed up (events never decrease, so an event at exactly t0
// can only lead the row); n [N] counts them; truncated [N] says whether
// the probe slot `cap` fired.  The most loop steps any source needed (the
// plain loop's step count, exact) is folded into steps[0] by a warp
// maximum and one atomicMax a warp; the caller zeroes it.
//
// What bounds it: the integer work of the draws.  Every proposal costs
// five threefry blocks of ~74 integer instructions and every event one
// more; the benchmark's star batch (256,000 sources to T = 100, ~21.25 M
// wall events, ~21.5 M proposals at the least) is ~9.6e9 integer
// operations, ~0.57 ms at the card's INT32 rate, and the 256,000 x 1,024
// float32 rows (1.05 GB) ~0.31 ms at 3.35 TB/s, which can overlap: the
// bound is the larger, ~0.57 ms (smoke/hawkes_thin.py:bound).  The
// plain loop spends ~600 small int64 operations a step on the host's
// issue and the device, over ~225 steps, and scatters each step into a
// [N, cap + 1] buffer that it then sorts.  Here sources are independent
// and a source's proposals strictly sequential, so one thread walks one
// source from t0 to absorption with everything (chain key, time, bound,
// count, excitation, slot) in registers: no host loop, no int64 carrier
// (native uint32 arithmetic, the five blocks of a proposal interleaved
// three and two at a time), no [N, cap + 1] buffer and no sort.  A warp
// runs to its longest source: that divergence is what is left above the
// bound.
//
// Numerics.  Built without --use_fast_math and with --fmad=false (see
// ops/kernels.py): IEEE division, expf and log1pf from the CUDA math
// library, and no fused multiply-adds, so each operation rounds as the
// plain loop's separate PyTorch operations do, in their order, and the
// streams are the plain loop's bit for bit.
//
// Keys cross the boundary as int32 tensors holding the uint32 bit
// patterns, [N, 2].

#include <cstdint>
#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

constexpr int THREADS = 256;   // sources (threads) per block

// runtime.numerics.safe_exp: torch.clamp(x, max=80) keeps NaN, then exp.
__device__ __forceinline__ float safe_exp(float x) {
  return expf(x > 80.f ? 80.f : x);
}

// ops.sampling.hawkes_intensity.
__device__ __forceinline__ float intensity(float t, float l0, float exc,
                                           float exc_t, float beta) {
  return l0 + exc * safe_exp(-beta * (t - exc_t));
}

// ops.prng.uniform_from_bits23: the top 23 bits as the mantissa of a
// float in [1, 2), minus 1 (jax.random.uniform's, not the 24-bit
// rq::uniform_from_bits of the event kernel).
__device__ __forceinline__ float uniform23(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

__global__ void __launch_bounds__(THREADS)
hawkes_thin_kernel(const uint32_t* __restrict__ key,
                   const float* __restrict__ l0s,
                   const float* __restrict__ alphas,
                   const float* __restrict__ betas, int N, int cap,
                   float t0, float T, int max_proposals,
                   float* __restrict__ times, int32_t* __restrict__ n_out,
                   bool* __restrict__ trunc_out,
                   unsigned int* __restrict__ steps_out) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  unsigned int steps = 0;
  if (i < N) {
    const uint32_t k0 = key[2 * i], k1 = key[2 * i + 1];
    const float l0 = l0s[i], alpha = alphas[i], beta = betas[i];
    float* row = times + static_cast<size_t>(i) * cap;
    float t = t0, exc = 0.f, exc_t = t0;
    int slot = 0, kept = 0;
    bool probe = false, done = false;
    // The current slot's chain: its key, time, bound and count.
    uint32_t p0, p1;
    rq::threefry2x32(k0, k1, 0u, 0u, p0, p1);   // fold_in(key, 0)
    float tp = t, lbd = intensity(t, l0, exc, exc_t, beta);
    int n = 0;
    while (!done) {
      ++steps;
      const bool run = (tp <= T) && (lbd > 0.f) && (n < max_proposals);
      bool acc = false;
      if (run) {
        // split(chain key, 3): counters (0, 0), (0, 1), (0, 2).
        const uint32_t sk0[3] = {p0, p0, p0}, sk1[3] = {p1, p1, p1};
        uint32_t s0[3] = {0u, 0u, 0u}, s1[3] = {0u, 1u, 2u};
        rq::threefry2x32_n<3>(sk0, sk1, s0, s1);
        // random_bits of the gap's and the test's keys: counter (0, 0).
        const uint32_t bk0[2] = {s0[1], s0[2]}, bk1[2] = {s1[1], s1[2]};
        uint32_t b0[2] = {0u, 0u}, b1[2] = {0u, 0u};
        rq::threefry2x32_n<2>(bk0, bk1, b0, b1);
        const float e = -log1pf(-uniform23(b0[0] ^ b1[0]));
        const float u = uniform23(b0[1] ^ b1[1]);
        const float t_new = tp + e / lbd;   // safe_div: lbd > 0 here
        const float lbd_new = intensity(t_new, l0, exc, exc_t, beta);
        acc = u * lbd <= lbd_new;
        p0 = s0[0];
        p1 = s1[0];
        tp = t_new;
        lbd = lbd_new;
        ++n;
      }
      const bool fired = run && acc && (tp <= T);
      if (fired) {
        if (slot < cap) {
          if (tp > t0) row[kept++] = tp;
        } else {
          probe = true;
        }
        exc = exc * safe_exp(-beta * (tp - exc_t)) + alpha;
        exc_t = tp;
        t = tp;
        ++slot;
      }
      // A slot without an event absorbs the source: the chain stopped
      // (past T, no intensity, the proposal cap) or accepted past T.
      done = !run || (acc && !fired) || slot > cap;
      if (fired && !done) {   // the next slot's chain starts at t
        rq::threefry2x32(k0, k1, 0u, static_cast<uint32_t>(slot), p0, p1);
        lbd = intensity(t, l0, exc, exc_t, beta);
        n = 0;
      }
    }
    n_out[i] = kept;
    trunc_out[i] = probe;
  }
  const unsigned int most = __reduce_max_sync(0xffffffffu, steps);
  if ((threadIdx.x & 31) == 0) atomicMax(steps_out, most);
}

}  // namespace

extern "C" {

const char* rq_hawkes_thin_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One launch on `stream`: one thread a source, THREADS a block.  Returns a
// cudaError_t (0 = queued).  `times` [N, cap] holds +inf on entry; `steps`
// is one zeroed word.
int rq_hawkes_thin_launch(const void* key, const void* l0,
                          const void* alpha, const void* beta, int N,
                          int cap, float t0, float T, int max_proposals,
                          void* times, void* n, void* truncated, void* steps,
                          void* stream) {
  if (N < 0 || cap < 0 || max_proposals < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  hawkes_thin_kernel<<<(N + THREADS - 1) / THREADS, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(key), static_cast<const float*>(l0),
      static_cast<const float*>(alpha), static_cast<const float*>(beta), N,
      cap, t0, T, max_proposals, static_cast<float*>(times),
      static_cast<int32_t*>(n), static_cast<bool*>(truncated),
      static_cast<unsigned int*>(steps));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
