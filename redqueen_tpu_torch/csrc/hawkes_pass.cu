// hawkes_pass.cu — the event pass of the Hawkes learn path, hand-written
// CUDA C++ for Hopper (sm_90a).
//
// Replaces: redqueen_tpu/learn/loglik.py:125 `_stream_pass` (and the
// gradient of `_ll_events_fn`, :182), a `lax.scan` over every event in
// global time order; the JAX package has no Pallas kernel for it.  The
// plain PyTorch version is `learn/loglik.py:hawkes_pass_plain`.
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
// Partials are per chunk (the wrapper sums them over chunks), each one a
// sequential float32 sum in event order, so the result is the same on
// every run.
//
// What bounds it: the recursion is sequential over all C*K events
// (R and Q carry across chunks).  One warp walks the stream; lane l owns
// dimensions j = l, l + 32, ... (NJ = ceil(D / 32) of them) with their
// R_j, Q_j, W_j, s0, E and health words in registers.  A batch of 32
// events is loaded coalesced (one per lane) and broadcast by shuffles;
// sum_j alpha_ij R_j is a butterfly shuffle sum, which leaves the same
// bits in every lane.  alpha and the chunk's B partial live in shared
// memory, each lane touching only its own columns, so the event loop
// has no barrier.  The walk is latency-bound: about 9.4 M padded events
// at the corpus shape, each a chain of shuffles, an exp and a divide.
// The throughput bound (bytes, or operations spread over the card) is far
// lower; a chunk-parallel design (a cheap pass for each chunk's incoming
// R and Q, then every chunk at once) is the way there (PERF.md section 7).
//
// Built with --fmad=false and no fast math, as the event kernel: every
// multiply and add rounds on its own, divisions and 1/lambda are IEEE.
// expf and logf differ from the CPU's by an ulp or two, so the kernel
// agrees with its plain version within a tolerance, not bit for bit.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#define RQ_HAWKES_MAX_D 128
#define RQ_BIT_NONFINITE_STATE 2u
#define RQ_FULL_MASK 0xffffffffu

namespace {

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(RQ_FULL_MASK, v, o);
  return v;
}

template <int NJ, bool GRAD>
__global__ void __launch_bounds__(32, 1)
hawkes_pass_kernel(const float* __restrict__ dt, const int* __restrict__ dims,
                   const unsigned char* __restrict__ mask,
                   const float* __restrict__ tail,
                   const float* __restrict__ mu,
                   const float* __restrict__ alpha,
                   const float* __restrict__ beta, float* __restrict__ ll_out,
                   float* __restrict__ a_out, float* __restrict__ b_out,
                   float* __restrict__ w_out, float* __restrict__ e_out,
                   unsigned* __restrict__ health_out, int C, int K, int D) {
  extern __shared__ float smem[];
  float* alpha_s = smem;          // [D, D], read only
  float* b_s = alpha_s + D * D;   // [D, D], the chunk's B partial
  float* mu_s = b_s + D * D;      // [D], read only
  const int lane = threadIdx.x;
  for (int x = lane; x < D * D; x += 32) {
    alpha_s[x] = alpha[x];
    b_s[x] = 0.0f;
  }
  for (int x = lane; x < D; x += 32) mu_s[x] = mu[x];
  __syncwarp();

  float negb[NJ], R[NJ], Q[NJ], W[NJ], A[NJ], E[NJ];
  unsigned h[NJ];
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj) {
    const int j = lane + 32 * jj;
    negb[jj] = j < D ? -beta[j] : 0.0f;
    R[jj] = Q[jj] = W[jj] = A[jj] = E[jj] = 0.0f;
    h[jj] = 0u;
  }
  float ll = 0.0f;
  const long long N = (long long)C * K;
  int c = 0, left = K;
  for (long long base = 0; base < N; base += 32) {
    const long long kk = base + lane;
    float dt_r = 0.0f, tail_r = 0.0f;
    int dim_r = 0, m_r = 0;
    if (kk < N) {
      dt_r = dt[kk];
      tail_r = tail[kk];
      dim_r = dims[kk];
      m_r = mask[kk] != 0;
    }
    const int nb = (N - base) < 32 ? (int)(N - base) : 32;
    for (int e = 0; e < nb; ++e) {
      const float x_dt = __shfl_sync(RQ_FULL_MASK, dt_r, e);
      const float x_tail = __shfl_sync(RQ_FULL_MASK, tail_r, e);
      int i = __shfl_sync(RQ_FULL_MASK, dim_r, e);
      const int m = __shfl_sync(RQ_FULL_MASK, m_r, e);
      i = i < 0 ? 0 : (i >= D ? D - 1 : i);  // dims are validated on the host
      const float* arow = alpha_s + i * D;
      float* brow = b_s + i * D;
      float exc[NJ];
      float part = 0.0f;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int j = lane + 32 * jj;
        exc[jj] = 0.0f;
        if (j < D) {
          const float d = safe_exp_f(negb[jj] * x_dt);
          if (!GRAD) Q[jj] = d * (Q[jj] + x_dt * R[jj]);
          R[jj] = d * R[jj];
          exc[jj] = arow[j] * R[jj];
          part += exc[jj];
        }
      }
      const float lam = mu_s[i] + warp_sum(part);
      const bool ok = isfinite(lam) && lam > 0.0f;
      const int owner = i & 31, slot = i >> 5;
      if (GRAD) {
        ll += (m ? 1.0f : 0.0f) * safe_log_f(lam);
        const float cinv = (m && lam > FLT_MIN) ? 1.0f / lam : 0.0f;
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const int j = lane + 32 * jj;
          if (j < D) brow[j] += cinv * R[jj];
          if (jj == slot && lane == owner) A[jj] += cinv;
        }
      } else if (m && ok) {
        ll += safe_log_f(lam);
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const int j = lane + 32 * jj;
          if (j < D) {
            brow[j] += exc[jj] / lam;
            W[jj] += (arow[j] * Q[jj]) / lam;
          }
          if (jj == slot && lane == owner) A[jj] += mu_s[i] / lam;
        }
      }
      if (m && lane == owner) {
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          if (jj == slot) {
            if (!ok) h[jj] |= RQ_BIT_NONFINITE_STATE;
            E[jj] += safe_exp_f(negb[jj] * x_tail);
            R[jj] += 1.0f;
          }
        }
      }
      if (--left == 0) {  // chunk c ends: write its partials, start anew
        if (lane == 0) ll_out[c] = ll;
        ll = 0.0f;
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const int j = lane + 32 * jj;
          if (j < D) {
            a_out[(long long)c * D + j] = A[jj];
            w_out[(long long)c * D + j] = W[jj];
            e_out[(long long)c * D + j] = E[jj];
            float* out = b_out + (long long)c * D * D + j;
            for (int r = 0; r < D; ++r) {
              out[(long long)r * D] = b_s[r * D + j];
              b_s[r * D + j] = 0.0f;
            }
          }
          A[jj] = W[jj] = E[jj] = 0.0f;
        }
        ++c;
        left = K;
      }
    }
  }
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj) {
    const int j = lane + 32 * jj;
    if (j < D) health_out[j] = h[jj];
  }
}

template <int NJ, bool GRAD>
cudaError_t launch(const void* dt, const void* dims, const void* mask,
                   const void* tail, const void* mu, const void* alpha,
                   const void* beta, void* ll, void* a, void* b, void* w,
                   void* e, void* health, int C, int K, int D,
                   cudaStream_t stream) {
  const size_t smem = (size_t)(2 * D * D + D) * sizeof(float);
  auto kern = hawkes_pass_kernel<NJ, GRAD>;
  cudaError_t rc = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return rc;
  kern<<<1, 32, smem, stream>>>(
      (const float*)dt, (const int*)dims, (const unsigned char*)mask,
      (const float*)tail, (const float*)mu, (const float*)alpha,
      (const float*)beta, (float*)ll, (float*)a, (float*)b, (float*)w,
      (float*)e, (unsigned*)health, C, K, D);
  return cudaGetLastError();
}

template <bool GRAD>
cudaError_t dispatch(const void* dt, const void* dims, const void* mask,
                     const void* tail, const void* mu, const void* alpha,
                     const void* beta, void* ll, void* a, void* b, void* w,
                     void* e, void* health, int C, int K, int D,
                     cudaStream_t s) {
  switch ((D + 31) / 32) {
    case 1: return launch<1, GRAD>(dt, dims, mask, tail, mu, alpha, beta, ll,
                                   a, b, w, e, health, C, K, D, s);
    case 2: return launch<2, GRAD>(dt, dims, mask, tail, mu, alpha, beta, ll,
                                   a, b, w, e, health, C, K, D, s);
    case 3: return launch<3, GRAD>(dt, dims, mask, tail, mu, alpha, beta, ll,
                                   a, b, w, e, health, C, K, D, s);
    default: return launch<4, GRAD>(dt, dims, mask, tail, mu, alpha, beta,
                                    ll, a, b, w, e, health, C, K, D, s);
  }
}

}  // namespace

extern "C" int rq_hawkes_max_dims() { return RQ_HAWKES_MAX_D; }

extern "C" const char* rq_hawkes_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// One launch of the pass on `stream`; returns a cudaError_t (0 = queued).
// Outputs: ll [C], a [C, D], b [C, D, D], w [C, D], e [C, D], health [D].
extern "C" int rq_hawkes_pass_launch(const void* dt, const void* dims,
                                     const void* mask, const void* tail,
                                     const void* mu, const void* alpha,
                                     const void* beta, void* ll, void* a,
                                     void* b, void* w, void* e, void* health,
                                     int C, int K, int D, int grad,
                                     void* stream) {
  if (D < 1 || D > RQ_HAWKES_MAX_D || C < 1 || K < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t rc =
      grad ? dispatch<true>(dt, dims, mask, tail, mu, alpha, beta, ll, a, b,
                            w, e, health, C, K, D, s)
           : dispatch<false>(dt, dims, mask, tail, mu, alpha, beta, ll, a, b,
                             w, e, health, C, K, D, s);
  return (int)rc;
}
