// The event kernel: the fused per-event simulation step of a batch of
// independent components, run k chunks of `capacity` events per launch.
//
// Replaces the TPU megakernel redqueen_tpu/ops/pallas_engine.py:311
// (pl.pallas_call in _chunk_call, body _build_kernel) and its step
// redqueen_tpu/ops/pallas_step.py:164 (make_step).  It covers all five
// kinds of that kernel: Poisson, Opt, Hawkes, RealData replay and
// piecewise-constant rates.  The plain PyTorch version, with the same
// arithmetic in the same order, is redqueen_tpu_torch/ops/event_step.py.
//
// Design.  One thread per lane (component), LANES lanes to a block: one
// warp, the finest grain the block scheduler spreads over the SMs.  At the
// start of a launch each thread copies its lane's per-source constants
// (k0, k1, kind, rate) and state (t_next, ctr, exc, exc_t, rd_ptr) into
// shared memory and computes its react table there once: for each Opt row
// r_j (in opt_mask order) and source s, rs[j][s] = sum_f adj[r_j,f] *
// adj[s,f] * sqrtf(ssink[f] / q_r), in the plain version's f order.  The
// event loop reads rs[j][s_star] where the plain version sums over F.
// Shared memory holds one column of words per lane, word w of lane i at
// smem[w * LANES + i], so a warp's 32 threads always hit 32 banks whatever
// source each indexes; source s takes words s*stride .. s*stride+stride-1
// of the column, so every field sits at a compile-time offset from the
// source's base.  Neighbouring threads take neighbouring lanes, so every
// [.., B] load and every row of the times/srcs log is coalesced; the lane
// count needs no padding (the kernel masks lane < B).  The carry is
// written back once at the end.
//
// A step is a chain of dependent operations, so the kernel shortens the
// chain rather than adding threads (a lane spread over G threads was
// measured slower at every G > 1: see PERF.md).  Once s_star is known, the
// draws run two at a time with their threefry chains interleaved: the
// fired source's on (key; ctr, 0) beside the first Opt row's on (key; ctr,
// 1) (it reads ctr[r] with r != s_star, which the fire does not touch),
// then the other Opt rows pairwise.  Beside them a pairwise-tree argmin
// reduces the clocks the step leaves as they are (every source but s_star
// and the Opt rows); the new clocks are folded into that minimum as they
// come, so the next step's argmin adds only a few compares to the chain.
// A step that absorbs moves no clock and keeps its argmin.
//
// No draw is made before s_star is known, but once it is, every Opt row
// draws, whether or not it reacts to s_star: the rows that do not (s_star
// itself among them) drop their draw.  That is deliberate.  The set of
// reacting rows differs between the lanes of a warp, and drawing only for
// it splits the warp into paths that run one after the other: measured
// 24% slower at the headline (PERF.md).
//
// What bounds it.  At the headline shape (B = 10,000 lanes, S = 11,
// F = 10) 10,000 threads are about 2.4 warps per SM, fewer than one per
// scheduler: the step's chain (shared-memory loads, threefry, log1pf, an
// IEEE division, the fold) sets the pace, not the issue rate and not the
// roughly 8 bytes per lane-step of log traffic.
//
// Numerics.  Built without --use_fast_math and with --fmad=false (see
// ops/kernels.py): IEEE division and sqrtf, expf and log1pf from the CUDA
// math library, and no fused multiply-adds, so each operation rounds as the
// plain version's separate PyTorch operations do.  min/max propagate NaN as
// jnp.minimum/jnp.maximum do (fminf/fmaxf would drop it), so a NaN clock
// makes the step's minimum NaN and freezes the lane.
//
// Keys, counters and health words cross the boundary as int32 tensors
// holding the uint32 bit patterns.

#include <cstdint>
#include <cuda_runtime.h>

#include "threefry.cuh"

#define RQ_MAX_S 32

namespace {

constexpr int KIND_POISSON = 0;
constexpr int KIND_HAWKES = 1;
constexpr int KIND_PIECEWISE = 2;
constexpr int KIND_REALDATA = 3;
constexpr uint32_t BIT_NONFINITE_TIME = 1u;
constexpr uint32_t BIT_NONFINITE_STATE = 2u;
constexpr int NEWTON_ITERS = 24;
constexpr float TINY = 1e-30f;
constexpr int LANES = 32;   // lanes (threads) per block: one warp
constexpr int BLOCK = 128;       // threads per block of the threefry check

// Specialisation flags (the kinds the component has).
constexpr int HAS_HAWKES = 1;
constexpr int HAS_RD = 2;
constexpr int HAS_PW = 4;

// A source's words in its lane's column: constants, state, then one react
// rate sum per Opt row.
constexpr int W_K0 = 0;
constexpr int W_K1 = 1;
constexpr int W_KIND = 2;
constexpr int W_RATE = 3;
constexpr int W_TNEXT = 4;
constexpr int W_CTR = 5;
constexpr int W_EXC = 6;
constexpr int W_EXCT = 7;
constexpr int W_RDPTR = 8;
constexpr int W_RS = 9;

__device__ __forceinline__ float f_inf() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ float f_nan() { return __int_as_float(0x7fc00000); }
__device__ __forceinline__ bool is_nan(float x) { return x != x; }

// jnp.maximum / jnp.minimum: NaN in either operand gives NaN.
__device__ __forceinline__ float jmax(float a, float b) {
  return (is_nan(a) || is_nan(b)) ? f_nan() : fmaxf(a, b);
}
__device__ __forceinline__ float jmin(float a, float b) {
  return (is_nan(a) || is_nan(b)) ? f_nan() : fminf(a, b);
}

// runtime.numerics.safe_exp: the exponent clamped at 80 (finite in f32).
__device__ __forceinline__ float safe_exp(float x) { return expf(jmin(x, 80.f)); }

// Exact inversion of the exponential-kernel Hawkes compensator:
// l0*tau + (exc/beta)*(1 - exp(-beta*tau)) = e, Newton from the tangent.
__device__ float hawkes_invert(float e, float l0, float exc, float beta) {
  const float c = exc / jmax(beta, TINY);
  const bool never = (l0 <= 0.f) && (e >= c);
  float tau = e / jmax(l0 + exc, TINY);
  for (int it = 0; it < NEWTON_ITERS; ++it) {
    const float em = safe_exp(-beta * tau);
    const float g = l0 * tau + c * (1.f - em) - e;
    tau = tau - g / jmax(l0 + exc * em, TINY);
  }
  tau = jmax(tau, 0.f);
  return never ? f_inf() : tau;
}

// The fired source's piecewise profile: knots/rates at stride B.
__device__ float piecewise_invert(float e, float t_from, const float* knots,
                                  const float* rates, int Kp, size_t B) {
  float cum = 0.f;
  for (int k = 0; k < Kp; ++k) {
    const float t0k = knots[k * B];
    const float t1k = (k + 1 < Kp) ? knots[(k + 1) * B] : f_inf();
    const float rk = rates[k * B];
    const float lo = jmax(t0k, t_from);
    const float span = t1k - lo;
    const float hz = (rk > 0.f && span > 0.f) ? rk * span : 0.f;
    const float cum_next = cum + hz;
    if (cum_next >= e) return lo + (e - cum) / jmax(rk, TINY);
    cum = cum_next;
  }
  return f_inf();
}

// Exp(1) draws from N independent threefry blocks (key; ctr, stream),
// their chains interleaved.
template <int N>
__device__ __forceinline__ void exp_draws(const uint32_t (&k0)[N],
                                          const uint32_t (&k1)[N],
                                          const uint32_t (&ctr)[N],
                                          uint32_t stream0, float (&e)[N]) {
  uint32_t x0[N], x1[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    x0[n] = ctr[n];
    x1[n] = n == 0 ? stream0 : 1u;
  }
  rq::threefry2x32_n<N>(k0, k1, x0, x1);
#pragma unroll
  for (int n = 0; n < N; ++n) e[n] = rq::exponential_from_bits(x0[n]);
}

struct Params {
  const int32_t* kind;      // [S, B]
  const float* rate;        // [S, B]
  const uint32_t* k0;       // [S, B]
  const uint32_t* k1;       // [S, B]
  const float* q;           // [S, B]
  const float* ssink;       // [F, B]
  const float* adj;         // [S, F, B]
  const float* l0;          // [S, B]
  const float* alpha;       // [S, B]
  const float* beta;        // [S, B]
  const float* rd_times;    // [S, Kr, B]
  const float* pw_times;    // [S, Kp, B]
  const float* pw_rates;    // [S, Kp, B]
};

struct Carry {
  float* t_next;     // [S, B]
  uint32_t* ctr;     // [S, B]
  float* t;          // [B]
  int32_t* nev;      // [B]
  uint32_t* health;  // [B]
  float* exc;        // [S, B]
  float* exc_t;      // [S, B]
  int32_t* rd_ptr;   // [S, B]
};

// NS: a power of two at least S, the width of the argmin tree.
template <int NS>
__global__ void __launch_bounds__(LANES)
event_kernel(Params p, Carry in, Carry out, float* __restrict__ times,
             int32_t* __restrict__ srcs, int B_, int S, int F, int Kr, int Kp,
             int steps, float end_time, uint32_t opt_mask, int flags) {
  extern __shared__ uint32_t smem[];
  const int lane = blockIdx.x * LANES + threadIdx.x;
  if (lane >= B_) return;
  const size_t B = static_cast<size_t>(B_);
  const bool has_hawkes = flags & HAS_HAWKES;
  const bool has_rd = flags & HAS_RD;
  const bool has_pw = flags & HAS_PW;
  // Words per source in a column, times LANES.
  const int stride = (W_RS + __popc(opt_mask)) * LANES;
  uint32_t* const col = smem + threadIdx.x;
  auto w = [&](int s, int word) -> uint32_t& {
    return col[s * stride + word * LANES];
  };
  auto wf = [&](int s, int word) -> float& {
    return reinterpret_cast<float&>(w(s, word));
  };

  // ---- the lane's constants, state and react table, once per launch ----
  for (int s = 0; s < S; ++s) {
    const size_t x = s * B + lane;
    w(s, W_K0) = p.k0[x];
    w(s, W_K1) = p.k1[x];
    w(s, W_KIND) = static_cast<uint32_t>(p.kind[x]);
    wf(s, W_RATE) = p.rate[x];
    wf(s, W_TNEXT) = in.t_next[x];
    w(s, W_CTR) = in.ctr[x];
    wf(s, W_EXC) = in.exc[x];
    wf(s, W_EXCT) = in.exc_t[x];
    w(s, W_RDPTR) = static_cast<uint32_t>(in.rd_ptr[x]);
  }
  {
    // f outer, so each rs is summed in f order from 0, as the plain
    // version's per-event sum.
    int j = 0;
    for (uint32_t m = opt_mask; m != 0u; m &= m - 1u, ++j) {
      const int r = __ffs(m) - 1;
      const float qr = jmax(p.q[r * B + lane], TINY);
      for (int s = 0; s < S; ++s) wf(s, W_RS + j) = 0.f;
      for (int f = 0; f < F; ++f) {
        const float wt = sqrtf(p.ssink[f * B + lane] / qr);
        const float arf = p.adj[(r * static_cast<size_t>(F) + f) * B + lane];
        for (int s = 0; s < S; ++s) {
          const float aff =
              arf * p.adj[(s * static_cast<size_t>(F) + f) * B + lane];
          wf(s, W_RS + j) = wf(s, W_RS + j) + aff * wt;
        }
      }
    }
  }

  // ---- argmin commit (lowest-index tie-break) over the sources in
  // mask: their clocks read at once and reduced by a pairwise tree whose
  // left side holds the lower indices, so a tie keeps the lower one; a
  // source outside the mask, and padding (i >= S), is +inf at its own
  // index, which never displaces a real clock of the same source.  A NaN
  // clock sets nan. ----
  auto argmin_of = [&](uint32_t mask, float& vmin, int& imin, bool& nan) {
    float v[NS];
    int ix[NS];
    nan = false;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const float x = wf(i < S ? i : 0, W_TNEXT);
      v[i] = (i < S && ((mask >> i) & 1u)) ? x : f_inf();
      ix[i] = i;
      nan |= is_nan(v[i]);
    }
#pragma unroll
    for (int d = 1; d < NS; d <<= 1) {
#pragma unroll
      for (int i = 0; i + d < NS; i += 2 * d) {
        if (v[i + d] < v[i]) {
          v[i] = v[i + d];
          ix[i] = ix[i + d];
        }
      }
    }
    vmin = v[0];
    imin = ix[0];
  };

  float t = in.t[lane];
  int32_t nev = in.nev[lane];
  uint32_t health = in.health[lane];
  float tmin;
  int s_star;
  {
    bool nan;
    argmin_of(0xffffffffu, tmin, s_star, nan);
    if (nan) {
      tmin = f_nan();
      s_star = S;
    }
  }

  for (int step = 0; step < steps; ++step) {
    // ---- lane gating ----
    const bool nan_t = is_nan(tmin);
    const bool healthy = health == 0u;
    const bool regressed = tmin < t;
    const bool valid = (tmin <= end_time) && (s_star < S) && healthy &&
                       !nan_t && !regressed;
    const size_t row = static_cast<size_t>(step) * B + lane;
    if (!valid) {
      // Absorbing: no clock moves, so the argmin stands.
      times[row] = f_inf();
      srcs[row] = -1;
      health |= (healthy && (nan_t || regressed)) ? BIT_NONFINITE_TIME : 0u;
      continue;
    }

    // ---- the fired source's draw on (key; ctr, 0) and every Opt row's
    // react draw on (key; ctr, 1), two at a time.  A react touches only
    // its own row r != s_star. ----
    const int s = s_star;
    const uint32_t ctr_s = w(s, W_CTR);
    const int kd = static_cast<int>(w(s, W_KIND));
    const float rate = wf(s, W_RATE);
    // The clocks this step leaves as they are, every source but s and the
    // Opt rows, are reduced beside the draws; the others are folded in as
    // their new values come.
    float best;
    int best_i;
    bool nan_seen;
    auto fold = [&](float v, int i) {
      nan_seen |= is_nan(v);
      if (v < best || (v == best && i < best_i)) {
        best = v;
        best_i = i;
      }
    };
    argmin_of(~(opt_mask | (1u << s)), best, best_i, nan_seen);
    // The Opt rows in opt_mask order, -1 past the last; opt_mask is the
    // same in every lane, so every branch on a row is uniform in a warp.
    uint32_t m = opt_mask;
    auto take = [&]() -> int {
      if (m == 0u) return -1;
      const int r = __ffs(m) - 1;
      m &= m - 1u;
      return r;
    };
    // Opt row r (ordinal j in opt_mask, clock tr, read before its draw)
    // reacts to s with rs[j][s] when rs > 0; a row that does not react, s
    // itself among them, drops its draw.
    auto react = [&](int r, int j, float e, float tr) {
      if (r == s) return;
      const float rs = wf(s, W_RS + j);
      if (rs > 0.f) {
        tr = jmin(tr, tmin + e / jmax(rs, TINY));
        wf(r, W_TNEXT) = tr;
        w(r, W_CTR) += 1u;
      }
      fold(tr, r);
    };
    // Exp(1) draws of source a on (key; ctr, stream_a) and, when Opt row
    // b >= 0 (ordinal jb), of b on (key; ctr, 1), their threefry chains
    // interleaved; then b's react.
    auto draw_pair = [&](int a, uint32_t stream_a, int b, int jb) -> float {
      if (b < 0) {
        const uint32_t k0[1] = {w(a, W_K0)}, k1[1] = {w(a, W_K1)};
        const uint32_t c[1] = {w(a, W_CTR)};
        float e[1];
        exp_draws<1>(k0, k1, c, stream_a, e);
        return e[0];
      }
      const uint32_t k0[2] = {w(a, W_K0), w(b, W_K0)};
      const uint32_t k1[2] = {w(a, W_K1), w(b, W_K1)};
      const uint32_t c[2] = {w(a, W_CTR), w(b, W_CTR)};
      const float tb = wf(b, W_TNEXT);
      float e[2];
      exp_draws<2>(k0, k1, c, stream_a, e);
      react(b, jb, e[1], tb);
      return e[0];
    };
    const float e_fire = draw_pair(s, 0u, take(), 0);
    for (int j = 1; m != 0u; j += 2) {
      const int a = take();
      const float ta = wf(a, W_TNEXT);
      react(a, j, draw_pair(a, 1u, take(), j + 1), ta);
    }

    // ---- per-kind resample (Opt and uncompiled kinds stay +inf) ----
    const size_t sb = s * B + lane;
    float t_new = (kd == KIND_POISSON && rate > 0.f)
                      ? tmin + e_fire / jmax(rate, TINY)
                      : f_inf();
    float exc_new = 0.f;
    if (has_hawkes && kd == KIND_HAWKES) {
      const float beta = p.beta[sb];
      exc_new = wf(s, W_EXC) * safe_exp(-beta * (tmin - wf(s, W_EXCT))) +
                p.alpha[sb];
      t_new = tmin + hawkes_invert(e_fire, p.l0[sb], exc_new, beta);
    } else if (has_rd && kd == KIND_REALDATA) {
      const int ptr1 = static_cast<int>(w(s, W_RDPTR)) + 1;
      t_new = (ptr1 < Kr)
                  ? p.rd_times[(s * static_cast<size_t>(Kr) + ptr1) * B + lane]
                  : f_inf();
    } else if (has_pw && kd == KIND_PIECEWISE) {
      const size_t base = s * static_cast<size_t>(Kp) * B + lane;
      t_new = piecewise_invert(e_fire, tmin, p.pw_times + base,
                               p.pw_rates + base, Kp, B);
    }

    // ---- write-back: never store a NaN time, flag the lane ----
    uint32_t bits = 0u;
    if (is_nan(t_new)) {
      bits |= BIT_NONFINITE_TIME;
      t_new = f_inf();
    }
    wf(s, W_TNEXT) = t_new;
    w(s, W_CTR) = ctr_s + 1u;
    if (has_hawkes && kd == KIND_HAWKES) {
      if (!((exc_new - exc_new) == 0.f)) bits |= BIT_NONFINITE_STATE;
      wf(s, W_EXC) = exc_new;
      wf(s, W_EXCT) = tmin;
    }
    if (has_rd && kd == KIND_REALDATA) w(s, W_RDPTR) += 1u;

    // ---- emit the event, advance the clock, next argmin ----
    times[row] = tmin;
    srcs[row] = s;
    t = tmin;
    nev += 1;
    health |= bits;
    fold(t_new, s);
    tmin = nan_seen ? f_nan() : best;
    s_star = nan_seen ? S : best_i;
  }

  for (int s = 0; s < S; ++s) {
    const size_t x = s * B + lane;
    out.t_next[x] = wf(s, W_TNEXT);
    out.ctr[x] = w(s, W_CTR);
    out.exc[x] = wf(s, W_EXC);
    out.exc_t[x] = wf(s, W_EXCT);
    out.rd_ptr[x] = static_cast<int32_t>(w(s, W_RDPTR));
  }
  out.t[lane] = t;
  out.nev[lane] = nev;
  out.health[lane] = health;
}

__global__ void threefry_kernel(const uint32_t* k0, const uint32_t* k1,
                                const uint32_t* x0, const uint32_t* x1,
                                uint32_t* y0, uint32_t* y1, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  rq::threefry2x32(k0[i], k1[i], x0[i], x1[i], y0[i], y1[i]);
}

Carry carry_from(void* const* ptrs) {
  Carry c;
  c.t_next = static_cast<float*>(ptrs[0]);
  c.ctr = static_cast<uint32_t*>(ptrs[1]);
  c.t = static_cast<float*>(ptrs[2]);
  c.nev = static_cast<int32_t*>(ptrs[3]);
  c.health = static_cast<uint32_t*>(ptrs[4]);
  c.exc = static_cast<float*>(ptrs[5]);
  c.exc_t = static_cast<float*>(ptrs[6]);
  c.rd_ptr = static_cast<int32_t*>(ptrs[7]);
  return c;
}

}  // namespace

extern "C" {

int rq_max_sources() { return RQ_MAX_S; }

// The launch geometry of B lanes, S sources and the Opt rows in opt_mask:
// one warp of lanes to a block, as many blocks as B needs, and the dynamic
// shared memory of each block in bytes, (W_RS + number of Opt rows) * S
// words of each lane's column.
void rq_event_kernel_geometry(int B, int S, unsigned int opt_mask,
                              int* lanes_per_block, int* blocks,
                              int* smem_bytes) {
  *lanes_per_block = LANES;
  *blocks = (B + LANES - 1) / LANES;
  *smem_bytes = 4 * LANES * (W_RS + __builtin_popcount(opt_mask)) * S;
}

const char* rq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// params: 13 device pointers in the order of ops/event_step.PARAM_NAMES;
// carry_in / carry_out: 8 device pointers in the order of CARRY_NAMES.
// Launched in the geometry rq_event_kernel_geometry gives.  Returns
// cudaGetLastError() after the launch (0 on success).
int rq_event_kernel_launch(void* const* params, void* const* carry_in,
                           void* const* carry_out, void* times, void* srcs,
                           int B, int S, int F, int Kr, int Kp, int steps,
                           float end_time, unsigned int opt_mask, int flags,
                           void* stream) {
  if (S < 1 || S > RQ_MAX_S || B < 1 || steps < 0 ||
      (S < 32 && (opt_mask >> S) != 0u))
    return static_cast<int>(cudaErrorInvalidValue);
  int lanes, blocks, smem_bytes;
  rq_event_kernel_geometry(B, S, opt_mask, &lanes, &blocks, &smem_bytes);
  Params p;
  p.kind = static_cast<const int32_t*>(params[0]);
  p.rate = static_cast<const float*>(params[1]);
  p.k0 = static_cast<const uint32_t*>(params[2]);
  p.k1 = static_cast<const uint32_t*>(params[3]);
  p.q = static_cast<const float*>(params[4]);
  p.ssink = static_cast<const float*>(params[5]);
  p.adj = static_cast<const float*>(params[6]);
  p.l0 = static_cast<const float*>(params[7]);
  p.alpha = static_cast<const float*>(params[8]);
  p.beta = static_cast<const float*>(params[9]);
  p.rd_times = static_cast<const float*>(params[10]);
  p.pw_times = static_cast<const float*>(params[11]);
  p.pw_rates = static_cast<const float*>(params[12]);
  decltype(&event_kernel<2>) kernel;
  if (S <= 2) {
    kernel = event_kernel<2>;
  } else if (S <= 4) {
    kernel = event_kernel<4>;
  } else if (S <= 8) {
    kernel = event_kernel<8>;
  } else if (S <= 16) {
    kernel = event_kernel<16>;
  } else {
    kernel = event_kernel<32>;
  }
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<blocks, lanes, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      p, carry_from(carry_in), carry_from(carry_out),
      static_cast<float*>(times), static_cast<int32_t*>(srcs), B, S, F, Kr,
      Kp, steps, end_time, opt_mask, flags);
  return static_cast<int>(cudaGetLastError());
}

// One threefry-2x32 block per element, for checking the device function
// against the random123 vectors.
int rq_threefry_launch(const void* k0, const void* k1, const void* x0,
                       const void* x1, void* y0, void* y1, int n,
                       void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  threefry_kernel<<<(n + BLOCK - 1) / BLOCK, BLOCK, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(k0), static_cast<const uint32_t*>(k1),
      static_cast<const uint32_t*>(x0), static_cast<const uint32_t*>(x1),
      static_cast<uint32_t*>(y0), static_cast<uint32_t*>(y1), n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
