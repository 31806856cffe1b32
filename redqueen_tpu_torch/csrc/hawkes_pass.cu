// hawkes_pass.cu — the event pass of the Hawkes learn path, hand-written
// CUDA C++ for Hopper (sm_90a).
//
// Replaces: redqueen_tpu/learn/loglik.py:125 `_stream_pass` (and the
// gradient of `_ll_events_fn`, :182), a `lax.scan` over every event in
// global time order; the JAX package has no Pallas kernel for it.  The
// plain PyTorch versions are `learn/loglik.py:hawkes_pass_plain` (the
// pass) and `hawkes_carry_plain` (its phases (A) and (B) below).
//
// What it computes, for an exponential-kernel multivariate Hawkes model
// (mu f32[D], alpha f32[D, D], beta f32[D]) over a chunked stream
// (dt, dims, mask, tail [C, K]): the decay recursion
//     R_j <- e^{-beta_j dt} R_j,  Q_j <- e^{-beta_j dt} (Q_j + dt R_j)
// carried across all C*K events (R_i += 1 at an unmasked event of dim i),
// the intensity lambda = mu_i + sum_j alpha_ij R_j at each event, and per
// chunk c:
//   stats mode (the EM E-step and the likelihood):
//     ll[c]   = sum log lambda over events with m and a valid lambda
//     A[c, i] = s0_i = sum mu_i / lambda          (same gate)
//     B[c, i, j] = S_ij = sum alpha_ij R_j / lambda
//     W[c, j] = sum alpha_ij Q_j / lambda
//   grad mode (the Frank-Wolfe objective and its exact gradient):
//     ll[c]   = sum m * safe_log(lambda)          (no validity gate)
//     A[c, i] = g_mu_i    = sum_{m, lambda > FLT_MIN} 1 / lambda
//     B[c, i, j] = g_alpha_ij = sum_{m, lambda > FLT_MIN} R_j / lambda
//     W = 0
//   both modes:
//     E[c, i] = sum_{m} exp(-beta_i tail)         (the censored mass)
//     health[i] |= BIT_NONFINITE_STATE where an unmasked event of dim i
//                  met a non-finite or non-positive lambda (ORed over all)
//
// What bounds it: only R and Q carry from event to event, and they depend
// on the times and beta alone; everything else (lambda, the logs, the
// divides, the partials) is per event.  The bound (chip_smoke's
// corpus_bound) is the float32 issue rate over 13 (stats) or 7 (grad)
// operations per (event, dimension).  A single walk over all C*K events
// is a latency chain on one SM, so the pass is cut in three phases, each
// filling the card:
//
//  (A) segment summaries: each chunk is cut into W segments of
//      L = ceil(K / W) events (the last one shorter, some empty when K is
//      small), one warp each, every segment at once.  A warp walks its
//      segment from a zero state through the decay recursion alone and
//      writes, per dimension, P = the product of its decays in event
//      order (what the walk multiplies, safe_exp's cap kept), dR and dQ,
//      and once span = sum dt.  A segment of padding only (no mask, dt 0)
//      is marked dead.  Warp 0 then folds the chunk's W summaries, in
//      order, into the chunk's summary.
//  (B) carries, in a fixed order: one block copies the chunk summaries
//      into shared memory a tile at a time, and one thread per dimension
//      walks them, R_in(c+1) = P R_in(c) + dR,
//      Q_in(c+1) = P (Q_in(c) + span R_in(c)) + dQ, exact in real
//      arithmetic (the homogeneous solution is e^{-b(t-t0)}(Q + (t-t0)R));
//      the shape of the order depends on the sizes only, so two passes
//      give the same bits (no look-back scan).
//  (C) the pass: one block per chunk, one warp per segment.  Each warp
//      folds its chunk's R_in/Q_in through the segments before its own,
//      then walks its segment with the per-event arithmetic: lane l owns
//      dimensions j = l, l + 32, ... (NJ = ceil(D / 32) of them) with
//      their R_j, Q_j, W_j, s0, E and health words in registers; 32
//      events are loaded coalesced and broadcast by shuffles;
//      sum_j alpha_ij R_j is a butterfly shuffle sum, which leaves the
//      same bits in every lane.  alpha and mu are read through the
//      read-only path (L1), so their loads never wait on the partial's
//      stores; each warp keeps its own [D, D] B partial in shared memory,
//      each lane touching only its own columns, so the event loop has no
//      barrier.  Events go four at a time: the later ones' decays and
//      sums do not wait on the earlier ones' lambda, and the partials are
//      updated by selects, not branches, so the four chains interleave;
//      lane n takes event n's log and mu_i / lambda, once for the four.
//      Dead segments are skipped (an exact no-op).  At the end the block
//      sums the warps' partials in warp order and writes one row per
//      chunk; health is ORed across blocks with atomicOr (order-free)
//      into a zeroed buffer.
//
// W per D (rq_hawkes_segments): as many warps as the W [D, D] partials
// and the launch bound allow (D = 64: 12, one block per SM; D = 128: 3).
// Every sum runs in a fixed order, so a pass gives the same bits on every
// run.
//
// Built with --fmad=false and no fast math, as the event kernel: every
// multiply and add rounds on its own, divisions and 1/lambda are IEEE.
// expf and logf differ from the CPU's by an ulp or two, and the carries
// are composed where the plain version walks, so the kernel agrees with
// its plain version within a tolerance, not bit for bit.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#define RQ_HAWKES_MAX_D 128
#define RQ_HAWKES_SMEM_BYTES 232448  // a block's shared memory on sm_90
#define RQ_BIT_NONFINITE_STATE 2u
#define RQ_FULL_MASK 0xffffffffu

namespace {

// The most segments (warps of a block) for NJ = ceil(D / 32) dimensions a
// lane: the compile-time bound of __launch_bounds__, so that the
// registers of NJ dimensions fit (NJ = 2: 12 warps, up to 170 registers).
template <int NJ> struct MaxW;
template <> struct MaxW<1> { static constexpr int value = 32; };
template <> struct MaxW<2> { static constexpr int value = 12; };
template <> struct MaxW<3> { static constexpr int value = 6; };
template <> struct MaxW<4> { static constexpr int value = 3; };

int max_w(int D) {
  switch ((D + 31) / 32) {
    case 1: return MaxW<1>::value;
    case 2: return MaxW<2>::value;
    case 3: return MaxW<3>::value;
    default: return MaxW<4>::value;
  }
}

// Shared memory of a pass block: W B partials [D, D], then per warp its
// s0, W and E [3, D] and its ll.
size_t pass_smem(int D, int W) {
  return (size_t)W * (D * D + 3 * D + 1) * sizeof(float);
}

// runtime.numerics.safe_exp: the exponent capped at 80; NaN stays NaN.
__device__ __forceinline__ float safe_exp_f(float x) {
  return expf(x > 80.0f ? 80.0f : x);
}

// runtime.numerics.safe_log: NaN and arguments below FLT_MIN read as
// FLT_MIN, so the result is finite.
__device__ __forceinline__ float safe_log_f(float x) {
  float y = (x != x) ? FLT_MIN : x;
  return logf(y < FLT_MIN ? FLT_MIN : y);
}

// NE butterfly sums at once (their shuffles interleave); each leaves the
// same bits in every lane.
template <int NE>
__device__ __forceinline__ void warp_sums(float (&v)[NE]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    float s[NE];
#pragma unroll
    for (int n = 0; n < NE; ++n)
      s[n] = __shfl_xor_sync(RQ_FULL_MASK, v[n], o);
#pragma unroll
    for (int n = 0; n < NE; ++n) v[n] += s[n];
  }
}

// Events a warp of phase (C) takes at once.
constexpr int kGroup = 4;

// The workspace of phases (A) and (B), carved from one float buffer that
// the wrapper allocates: per segment (C*W of them) P, dR, dQ [D], span and
// the live flag; per chunk P, dR, dQ [D], span, and R_in, Q_in [D].
struct Work {
  float *sP, *sR, *sQ, *sspan;
  int* slive;
  float *cP, *cR, *cQ, *cspan, *cRin, *cQin;
};

long long work_floats(long long C, long long W, long long D) {
  return C * W * (3 * D + 2) + C * (5 * D + 1);
}

Work carve(void* base, long long C, long long W, long long D) {
  float* p = (float*)base;
  Work w;
  w.sP = p; p += C * W * D;
  w.sR = p; p += C * W * D;
  w.sQ = p; p += C * W * D;
  w.sspan = p; p += C * W;
  w.slive = (int*)p; p += C * W;
  w.cP = p; p += C * D;
  w.cR = p; p += C * D;
  w.cQ = p; p += C * D;
  w.cspan = p; p += C;
  w.cRin = p; p += C * D;
  w.cQin = p;
  return w;
}

// Phase (A).  grid C, block 32 * W.
template <int NJ, bool GRAD>
__global__ void __launch_bounds__(32 * MaxW<NJ>::value)
summary_kernel(const float* __restrict__ dt, const int* __restrict__ dims,
               const unsigned char* __restrict__ mask,
               const float* __restrict__ beta, Work ws, int K, int D,
               int W) {
  const int c = blockIdx.x, w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int L = (K + W - 1) / W;
  const int lo = min(w * L, K), hi = min(lo + L, K);
  const long long row = (long long)c * K;
  int live = 0;
  for (int base = lo; base < hi && !live; base += 32) {
    const int k = base + lane;
    const bool x = k < hi && (mask[row + k] != 0 || dt[row + k] != 0.0f);
    live = __any_sync(RQ_FULL_MASK, x);
  }
  float negb[NJ], P[NJ], R[NJ], Q[NJ];
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj) {
    const int j = lane + 32 * jj;
    negb[jj] = j < D ? -beta[j] : 0.0f;
    P[jj] = 1.0f;
    R[jj] = Q[jj] = 0.0f;
  }
  float span = 0.0f;
  for (int base = live ? lo : hi; base < hi; base += 32) {
    const int k = base + lane;
    float dt_r = 0.0f;
    int dim_r = 0, m_r = 0;
    if (k < hi) {
      dt_r = dt[row + k];
      dim_r = dims[row + k];
      m_r = mask[row + k] != 0;
    }
    const int nb = min(32, hi - base);
#pragma unroll 4
    for (int e = 0; e < nb; ++e) {
      const float x = __shfl_sync(RQ_FULL_MASK, dt_r, e);
      int i = __shfl_sync(RQ_FULL_MASK, dim_r, e);
      const int m = __shfl_sync(RQ_FULL_MASK, m_r, e);
      i = i < 0 ? 0 : (i >= D ? D - 1 : i);  // dims are validated on the host
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int j = lane + 32 * jj;
        if (j < D) {
          const float d = safe_exp_f(negb[jj] * x);
          if (!GRAD) Q[jj] = d * (Q[jj] + x * R[jj]);
          R[jj] = d * R[jj];
          P[jj] = P[jj] * d;
          R[jj] += (m && j == i) ? 1.0f : 0.0f;
        }
      }
      span += x;
    }
  }
  const long long s = (long long)c * W + w;
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj) {
    const int j = lane + 32 * jj;
    if (j < D) {
      ws.sP[s * D + j] = P[jj];
      ws.sR[s * D + j] = R[jj];
      ws.sQ[s * D + j] = Q[jj];
    }
  }
  if (lane == 0) {
    ws.sspan[s] = span;
    ws.slive[s] = live;
  }
  __syncthreads();
  if (w != 0) return;
  // The chunk's summary: segments 0..W-1 folded in order.
  float cP[NJ], cR[NJ], cQ[NJ], csp = 0.0f;
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj) {
    cP[jj] = 1.0f;
    cR[jj] = cQ[jj] = 0.0f;
  }
  for (int v = 0; v < W; ++v) {
    const long long t = (long long)c * W + v;
    const float sp = ws.sspan[t];
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int j = lane + 32 * jj;
      if (j < D) {
        const float p = ws.sP[t * D + j];
        if (!GRAD) cQ[jj] = p * (cQ[jj] + sp * cR[jj]) + ws.sQ[t * D + j];
        cR[jj] = p * cR[jj] + ws.sR[t * D + j];
        cP[jj] = cP[jj] * p;
      }
    }
    csp = csp + sp;
  }
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj) {
    const int j = lane + 32 * jj;
    if (j < D) {
      ws.cP[(long long)c * D + j] = cP[jj];
      ws.cR[(long long)c * D + j] = cR[jj];
      ws.cQ[(long long)c * D + j] = cQ[jj];
    }
  }
  if (lane == 0) ws.cspan[c] = csp;
}

// Phase (B).  One block: its threads copy the chunk summaries a tile of
// `tile` chunks at a time into shared memory (coalesced), then thread j
// walks dimension j through the tile.
template <bool GRAD>
__global__ void __launch_bounds__(1024)
carry_kernel(const float* __restrict__ cP, const float* __restrict__ cR,
             const float* __restrict__ cQ, const float* __restrict__ cspan,
             float* __restrict__ cRin, float* __restrict__ cQin, int C,
             int D, int tile) {
  extern __shared__ float smem[];
  float* tP = smem;
  float* tR = tP + (long long)tile * D;
  float* tQ = tR + (long long)tile * D;
  float* tS = tQ + (long long)tile * D;
  const int j = threadIdx.x;
  float R = 0.0f, Q = 0.0f;
  for (int c0 = 0; c0 < C; c0 += tile) {
    const int n = min(tile, C - c0);
    const long long base = (long long)c0 * D;
    __syncthreads();
    for (int x = threadIdx.x; x < n * D; x += blockDim.x) {
      tP[x] = cP[base + x];
      tR[x] = cR[base + x];
      tQ[x] = GRAD ? 0.0f : cQ[base + x];
    }
    for (int x = threadIdx.x; x < n; x += blockDim.x) tS[x] = cspan[c0 + x];
    __syncthreads();
    if (j < D) {
      for (int t = 0; t < n; ++t) {
        const long long o = base + (long long)t * D + j;
        cRin[o] = R;
        cQin[o] = Q;
        const float p = tP[t * D + j], sp = tS[t];
        if (!GRAD) Q = p * (Q + sp * R) + tQ[t * D + j];
        R = p * R + tR[t * D + j];
      }
    }
  }
}

// Chunks a tile of phase (B), and its shared memory.
constexpr int kCarrySmem = 96 * 1024;
int carry_tile(int D) {
  return kCarrySmem / (int)((3 * D + 1) * sizeof(float));
}

// R and Q at the start of segment w of chunk c: the chunk's R_in/Q_in
// folded through the segments before w, in order.
template <int NJ, bool GRAD>
__device__ __forceinline__ void segment_start(const Work& ws, int c, int w,
                                              int W, int D, int lane,
                                              float (&R)[NJ],
                                              float (&Q)[NJ]) {
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj) {
    const int j = lane + 32 * jj;
    R[jj] = j < D ? ws.cRin[(long long)c * D + j] : 0.0f;
    Q[jj] = (!GRAD && j < D) ? ws.cQin[(long long)c * D + j] : 0.0f;
  }
  for (int v = 0; v < w; ++v) {
    const long long t = (long long)c * W + v;
    const float sp = ws.sspan[t];
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int j = lane + 32 * jj;
      if (j < D) {
        const float p = ws.sP[t * D + j];
        if (!GRAD) Q[jj] = p * (Q[jj] + sp * R[jj]) + ws.sQ[t * D + j];
        R[jj] = p * R[jj] + ws.sR[t * D + j];
      }
    }
  }
}

// The carries at every segment start, [C, W, D] each (the exported phases
// (A) + (B), for the tests).  grid C, block 32 * W.
template <int NJ, bool GRAD>
__global__ void __launch_bounds__(32 * MaxW<NJ>::value)
starts_kernel(Work ws, float* __restrict__ r_in, float* __restrict__ q_in,
              int D, int W) {
  const int c = blockIdx.x, w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float R[NJ], Q[NJ];
  segment_start<NJ, GRAD>(ws, c, w, W, D, lane, R, Q);
  const long long s = (long long)c * W + w;
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj) {
    const int j = lane + 32 * jj;
    if (j < D) {
      r_in[s * D + j] = R[jj];
      q_in[s * D + j] = Q[jj];
    }
  }
}

// Phase (C) on NE consecutive events of the loaded batch, from batch slot
// e, for one lane whose state is negb, R, Q, W (Wl), s0 (A), E and health
// (h) for each of its dimensions, and its part of the warp's ll.  The
// decays of all NE events run first (R's +1 does not wait on lambda),
// then the NE shuffle sums together, then each event's partials in event
// order.
template <int NJ, bool GRAD, int NE>
__device__ __forceinline__ void walk_events(
    const float (&negb)[NJ], float (&R)[NJ], float (&Q)[NJ],
    float (&Wl)[NJ], float (&A)[NJ], float (&E)[NJ], unsigned (&h)[NJ],
    float& ll, int e, float dt_r, float tail_r, int dim_r, int m_r,
    const float* __restrict__ mu, const float* __restrict__ alpha,
    float* brow0, int D, int lane) {
  float x_tail[NE], part[NE], keep[NE][NJ], lag[NE][NJ], arow_j[NE][NJ];
  int xi[NE], xm[NE];
#pragma unroll
  for (int n = 0; n < NE; ++n) {
    const float x_dt = __shfl_sync(RQ_FULL_MASK, dt_r, e + n);
    x_tail[n] = __shfl_sync(RQ_FULL_MASK, tail_r, e + n);
    int i = __shfl_sync(RQ_FULL_MASK, dim_r, e + n);
    xm[n] = __shfl_sync(RQ_FULL_MASK, m_r, e + n);
    i = i < 0 ? 0 : (i >= D ? D - 1 : i);  // dims are validated on the host
    xi[n] = i;
    const float* arow = alpha + i * D;
    part[n] = 0.0f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int j = lane + 32 * jj;
      keep[n][jj] = lag[n][jj] = arow_j[n][jj] = 0.0f;
      if (j < D) {
        const float a = __ldg(arow + j);
        const float d = safe_exp_f(negb[jj] * x_dt);
        if (!GRAD) Q[jj] = d * (Q[jj] + x_dt * R[jj]);
        R[jj] = d * R[jj];
        const float exc = a * R[jj];
        part[n] += exc;
        arow_j[n][jj] = a;
        // stats: alpha_ij R_j; grad: R_j (both after the decay, before
        // the event's own +1)
        keep[n][jj] = GRAD ? R[jj] : exc;
        if (!GRAD) lag[n][jj] = Q[jj];
      }
    }
    // the event's own +1 (adding 0 elsewhere is exact: R >= +0)
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
      R[jj] += (xm[n] && lane == (i & 31) && jj == (i >> 5)) ? 1.0f : 0.0f;
  }
  float lam[NE];
  warp_sums<NE>(part);
#pragma unroll
  for (int n = 0; n < NE; ++n) lam[n] = __ldg(mu + xi[n]) + part[n];
  // Lane n takes event n's scalar work (its log and, in stats mode,
  // mu_i / lambda): one warp instruction for the NE events.  ll is then a
  // per-lane partial, summed over the warp at the end of the segment.
  float my_l = lam[0];
  int my_i = xi[0], my_m = xm[0];
#pragma unroll
  for (int n = 1; n < NE; ++n) {
    my_l = lane == n ? lam[n] : my_l;
    my_i = lane == n ? xi[n] : my_i;
    my_m = lane == n ? xm[n] : my_m;
  }
  const bool mine = lane < NE && my_m;
  const float my_log = safe_log_f(my_l);
  if (GRAD) {
    ll += mine ? my_log : 0.0f;
  } else {
    ll += (mine && isfinite(my_l) && my_l > 0.0f) ? my_log : 0.0f;
  }
  const float my_a0 = GRAD ? 0.0f : __ldg(mu + my_i) / my_l;
#pragma unroll
  for (int n = 0; n < NE; ++n) {
    const int i = xi[n], m = xm[n];
    const float l = lam[n];
    const bool ok = isfinite(l) && l > 0.0f;
    const int owner = i & 31, slot = i >> 5;
    float* brow = brow0 + i * D;
    // Selects, not branches, so that the NE events' chains interleave;
    // adding 0 leaves a partial as it is.
    if (GRAD) {
      const float cinv = (m && l > FLT_MIN) ? 1.0f / l : 0.0f;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int j = lane + 32 * jj;
        if (j < D) brow[j] += cinv * keep[n][jj];
        A[jj] += (jj == slot && lane == owner) ? cinv : 0.0f;
      }
    } else {
      const bool use = m && ok;
      const float a0 = __shfl_sync(RQ_FULL_MASK, my_a0, n);
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int j = lane + 32 * jj;
        if (j < D) {
          const float s = keep[n][jj] / l;
          const float v = (arow_j[n][jj] * lag[n][jj]) / l;
          brow[j] += use ? s : 0.0f;
          Wl[jj] += use ? v : 0.0f;
        }
        A[jj] += (use && jj == slot && lane == owner) ? a0 : 0.0f;
      }
    }
    // the censored mass of the event's own dimension (the owner lane's)
    float negb_own = 0.0f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
      negb_own = jj == slot ? negb[jj] : negb_own;
    const float t = safe_exp_f(negb_own * x_tail[n]);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const bool own = m && lane == owner && jj == slot;
      h[jj] |= (own && !ok) ? RQ_BIT_NONFINITE_STATE : 0u;
      E[jj] += own ? t : 0.0f;
    }
  }
}

// Phase (C).  grid C, block 32 * W, dynamic shared memory pass_smem(D, W).
template <int NJ, bool GRAD>
__global__ void __launch_bounds__(32 * MaxW<NJ>::value, 1)
pass_kernel(const float* __restrict__ dt, const int* __restrict__ dims,
            const unsigned char* __restrict__ mask,
            const float* __restrict__ tail, const float* __restrict__ mu,
            const float* __restrict__ alpha, const float* __restrict__ beta,
            Work ws, float* __restrict__ ll_out, float* __restrict__ a_out,
            float* __restrict__ b_out, float* __restrict__ w_out,
            float* __restrict__ e_out, unsigned* __restrict__ health_out,
            int K, int D, int W) {
  extern __shared__ float smem[];
  const int c = blockIdx.x, w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int DD = D * D;
  float* b_s = smem + (long long)w * DD;          // this warp's B partial
  float* v_s = smem + (long long)W * DD;          // [W][3][D]: s0, W, E
  float* ll_s = v_s + 3LL * W * D;                // [W]
  for (int x = lane; x < DD; x += 32) b_s[x] = 0.0f;
  __syncwarp();

  float negb[NJ], R[NJ], Q[NJ], Wl[NJ], A[NJ], E[NJ], ll = 0.0f;
  unsigned h[NJ];
  segment_start<NJ, GRAD>(ws, c, w, W, D, lane, R, Q);
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj) {
    const int j = lane + 32 * jj;
    negb[jj] = j < D ? -beta[j] : 0.0f;
    Wl[jj] = A[jj] = E[jj] = 0.0f;
    h[jj] = 0u;
  }
  const long long s = (long long)c * W + w;
  if (ws.slive[s]) {
    const int L = (K + W - 1) / W;
    const int lo = min(w * L, K), hi = min(lo + L, K);
    const long long row = (long long)c * K;
    for (int base = lo; base < hi; base += 32) {
      const int k = base + lane;
      float dt_r = 0.0f, tail_r = 0.0f;
      int dim_r = 0, m_r = 0;
      if (k < hi) {
        dt_r = dt[row + k];
        tail_r = tail[row + k];
        dim_r = dims[row + k];
        m_r = mask[row + k] != 0;
      }
      const int nb = min(32, hi - base);
      int e = 0;
      for (; e + kGroup <= nb; e += kGroup)
        walk_events<NJ, GRAD, kGroup>(negb, R, Q, Wl, A, E, h, ll, e, dt_r,
                                      tail_r, dim_r, m_r, mu, alpha, b_s, D,
                                      lane);
      for (; e < nb; ++e)
        walk_events<NJ, GRAD, 1>(negb, R, Q, Wl, A, E, h, ll, e, dt_r,
                                 tail_r, dim_r, m_r, mu, alpha, b_s, D, lane);
    }
  }
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj) {
    const int j = lane + 32 * jj;
    if (j < D) {
      v_s[(3LL * w + 0) * D + j] = A[jj];
      v_s[(3LL * w + 1) * D + j] = Wl[jj];
      v_s[(3LL * w + 2) * D + j] = E[jj];
      if (h[jj]) atomicOr(health_out + j, h[jj]);
    }
  }
  float llv[1] = {ll};
  warp_sums<1>(llv);
  if (lane == 0) ll_s[w] = llv[0];
  __syncthreads();
  // The chunk's row: the warps' partials summed in warp order.
  for (int x = threadIdx.x; x < DD; x += blockDim.x) {
    float t = smem[x];
    for (int v = 1; v < W; ++v) t += smem[(long long)v * DD + x];
    b_out[(long long)c * DD + x] = t;
  }
  for (int x = threadIdx.x; x < 3 * D; x += blockDim.x) {
    float t = v_s[x];
    for (int v = 1; v < W; ++v) t += v_s[3LL * v * D + x];
    float* out = x < D ? a_out : (x < 2 * D ? w_out : e_out);
    out[(long long)c * D + x % D] = t;
  }
  if (threadIdx.x == 0) {
    float t = ll_s[0];
    for (int v = 1; v < W; ++v) t += ll_s[v];
    ll_out[c] = t;
  }
}

struct Args {
  const void *dt, *dims, *mask, *tail, *mu, *alpha, *beta;
  void *ll, *a, *b, *w, *e, *health, *r_in, *q_in;
  int C, K, D, W;
  Work ws;
  cudaStream_t stream;
};

// Phases (A) and (B).
template <int NJ, bool GRAD>
cudaError_t carries(const Args& g) {
  summary_kernel<NJ, GRAD><<<g.C, 32 * g.W, 0, g.stream>>>(
      (const float*)g.dt, (const int*)g.dims, (const unsigned char*)g.mask,
      (const float*)g.beta, g.ws, g.K, g.D, g.W);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  const int tile = carry_tile(g.D);
  const size_t smem = (size_t)tile * (3 * g.D + 1) * sizeof(float);
  rc = cudaFuncSetAttribute(carry_kernel<GRAD>,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            (int)smem);
  if (rc != cudaSuccess) return rc;
  carry_kernel<GRAD><<<1, 1024, smem, g.stream>>>(
      g.ws.cP, g.ws.cR, g.ws.cQ, g.ws.cspan, g.ws.cRin, g.ws.cQin, g.C, g.D,
      tile);
  return cudaGetLastError();
}

template <int NJ, bool GRAD>
cudaError_t run_pass(const Args& g) {
  cudaError_t rc = carries<NJ, GRAD>(g);
  if (rc != cudaSuccess) return rc;
  const size_t smem = pass_smem(g.D, g.W);
  auto kern = pass_kernel<NJ, GRAD>;
  rc = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                            (int)smem);
  if (rc != cudaSuccess) return rc;
  kern<<<g.C, 32 * g.W, smem, g.stream>>>(
      (const float*)g.dt, (const int*)g.dims, (const unsigned char*)g.mask,
      (const float*)g.tail, (const float*)g.mu, (const float*)g.alpha,
      (const float*)g.beta, g.ws, (float*)g.ll, (float*)g.a, (float*)g.b,
      (float*)g.w, (float*)g.e, (unsigned*)g.health, g.K, g.D, g.W);
  return cudaGetLastError();
}

template <int NJ, bool GRAD>
cudaError_t run_carry(const Args& g) {
  cudaError_t rc = carries<NJ, GRAD>(g);
  if (rc != cudaSuccess) return rc;
  starts_kernel<NJ, GRAD><<<g.C, 32 * g.W, 0, g.stream>>>(
      g.ws, (float*)g.r_in, (float*)g.q_in, g.D, g.W);
  return cudaGetLastError();
}

template <template <int, bool> class F>
cudaError_t dispatch(const Args& g, bool grad) {
  switch ((g.D + 31) / 32) {
    case 1: return grad ? F<1, true>::run(g) : F<1, false>::run(g);
    case 2: return grad ? F<2, true>::run(g) : F<2, false>::run(g);
    case 3: return grad ? F<3, true>::run(g) : F<3, false>::run(g);
    default: return grad ? F<4, true>::run(g) : F<4, false>::run(g);
  }
}

template <int NJ, bool GRAD> struct PassF {
  static cudaError_t run(const Args& g) { return run_pass<NJ, GRAD>(g); }
};
template <int NJ, bool GRAD> struct CarryF {
  static cudaError_t run(const Args& g) { return run_carry<NJ, GRAD>(g); }
};

}  // namespace

extern "C" int rq_hawkes_max_dims() { return RQ_HAWKES_MAX_D; }

extern "C" const char* rq_hawkes_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The segments a chunk (warps a block) the pass uses at D dimensions: as
// many as shared memory and the launch bound allow.  0 for a D it does
// not take.
extern "C" int rq_hawkes_segments(int D) {
  if (D < 1 || D > RQ_HAWKES_MAX_D) return 0;
  int w = (int)(RQ_HAWKES_SMEM_BYTES / pass_smem(D, 1));
  const int cap = max_w(D);
  return w < cap ? w : cap;
}

// The most segments a chunk the carry entry takes at D dimensions.
extern "C" int rq_hawkes_max_segments(int D) {
  return (D < 1 || D > RQ_HAWKES_MAX_D) ? 0 : max_w(D);
}

// Floats of workspace a pass or a carry launch needs (C chunks, W
// segments a chunk, D dimensions).
extern "C" long long rq_hawkes_workspace_floats(int C, int W, int D) {
  return work_floats(C, W, D);
}

// One pass on `stream`; returns a cudaError_t (0 = queued).  Outputs:
// ll [C], a [C, D], b [C, D, D], w [C, D], e [C, D], and health [D],
// which the caller zeroes (the pass ORs into it).  `workspace` holds
// rq_hawkes_workspace_floats(C, rq_hawkes_segments(D), D) floats.
extern "C" int rq_hawkes_pass_launch(const void* dt, const void* dims,
                                     const void* mask, const void* tail,
                                     const void* mu, const void* alpha,
                                     const void* beta, void* ll, void* a,
                                     void* b, void* w, void* e, void* health,
                                     int C, int K, int D, int grad,
                                     void* workspace, void* stream) {
  if (D < 1 || D > RQ_HAWKES_MAX_D || C < 1 || K < 1)
    return (int)cudaErrorInvalidValue;
  Args g = {};
  g.dt = dt; g.dims = dims; g.mask = mask; g.tail = tail;
  g.mu = mu; g.alpha = alpha; g.beta = beta;
  g.ll = ll; g.a = a; g.b = b; g.w = w; g.e = e; g.health = health;
  g.C = C; g.K = K; g.D = D; g.W = rq_hawkes_segments(D);
  g.ws = carve(workspace, C, g.W, D);
  g.stream = (cudaStream_t)stream;
  return (int)dispatch<PassF>(g, grad != 0);
}

// Phases (A) and (B) alone at W segments a chunk: R and Q at the start of
// every segment, r_in and q_in [C, W, D] (q_in zero in grad mode).
// `workspace` holds rq_hawkes_workspace_floats(C, W, D) floats.
extern "C" int rq_hawkes_carry_launch(const void* dt, const void* dims,
                                      const void* mask, const void* beta,
                                      void* r_in, void* q_in, int C, int K,
                                      int D, int W, int grad,
                                      void* workspace, void* stream) {
  if (D < 1 || D > RQ_HAWKES_MAX_D || C < 1 || K < 1 || W < 1 ||
      W > max_w(D))
    return (int)cudaErrorInvalidValue;
  Args g = {};
  g.dt = dt; g.dims = dims; g.mask = mask; g.beta = beta;
  g.r_in = r_in; g.q_in = q_in;
  g.C = C; g.K = K; g.D = D; g.W = W;
  g.ws = carve(workspace, C, W, D);
  g.stream = (cudaStream_t)stream;
  return (int)dispatch<CarryF>(g, grad != 0);
}
