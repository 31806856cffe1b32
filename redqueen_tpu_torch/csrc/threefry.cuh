// Threefry-2x32 as a device function: the generator of the event kernel.
//
// Bit-identical to the JAX package's redqueen_tpu/ops/threefry.py and to
// the random123 reference (Salmon et al., SC'11): 20 rounds with rotations
// (13,15,26,6)/(17,29,16,24), a key injection after every 4 rounds, and
// the parity word 0x1BD11BDA.  The plain PyTorch version is
// redqueen_tpu_torch/ops/threefry.py.
#pragma once

#include <cstdint>

namespace rq {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int d) {
  return (x << d) | (x >> (32 - d));
}

// N independent blocks, round by round, so that their dependency chains
// interleave: keys (k0[n], k1[n]), counters (x0[n], x1[n]) in place.
template <int N>
__device__ __forceinline__ void threefry2x32_n(const uint32_t (&k0)[N],
                                               const uint32_t (&k1)[N],
                                               uint32_t (&x0)[N],
                                               uint32_t (&x1)[N]) {
  constexpr int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t ks[3][N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    ks[0][n] = k0[n];
    ks[1][n] = k1[n];
    ks[2][n] = k0[n] ^ k1[n] ^ 0x1BD11BDAu;
    x0[n] += ks[0][n];
    x1[n] += ks[1][n];
  }
#pragma unroll
  for (int g = 0; g < 5; ++g) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int n = 0; n < N; ++n) {
        x0[n] += x1[n];
        x1[n] = rotl32(x1[n], kRot[g & 1][i]);
        x1[n] ^= x0[n];
      }
    }
#pragma unroll
    for (int n = 0; n < N; ++n) {
      x0[n] += ks[(g + 1) % 3][n];
      x1[n] += ks[(g + 2) % 3][n] + static_cast<uint32_t>(g + 1);
    }
  }
}

// One block: key (k0, k1), counter (x0, x1) -> (y0, y1).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t x0, uint32_t x1,
                                             uint32_t& y0, uint32_t& y1) {
  const uint32_t k0s[1] = {k0}, k1s[1] = {k1};
  uint32_t x0s[1] = {x0}, x1s[1] = {x1};
  threefry2x32_n<1>(k0s, k1s, x0s, x1s);
  y0 = x0s[0];
  y1 = x1s[0];
}

// uint32 bits -> float32 uniform in [0, 1): the top 24 bits times 2^-24.
__device__ __forceinline__ float uniform_from_bits(uint32_t bits) {
  return static_cast<float>(static_cast<int32_t>(bits >> 8)) *
         5.9604644775390625e-08f;
}

// uint32 bits -> Exp(1) draw, -log1p(-U) with the IEEE log1pf.
__device__ __forceinline__ float exponential_from_bits(uint32_t bits) {
  return -log1pf(-uniform_from_bits(bits));
}

}  // namespace rq
