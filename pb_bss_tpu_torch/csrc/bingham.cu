// Batched Bingham moment inversion: one chord Gauss-Newton round per
// problem (ops/bingham.py: bingham_chord_solve).
//
// Replaces pb_bss_tpu/ops/pallas_bingham.py:bingham_chord_solve (the
// Pallas TPU kernel, problems in the lanes of a (D, tile) block). Here a
// group of D lanes of one warp owns one problem (32 / D problems a warp,
// one warp a block): it loads the sorted moments and the start, clips the
// start's diffs into [lower, upper], and runs the round:
//
//   Jacobian  the base point and the D - 1 shifted points at once, lane c
//             running the cascade at u (c = 0) or at u shifted in diff
//             c - 1 (relative step fd_step max(1, |u|); a column whose
//             clipped step is below 1% of the intended one is zeroed), each
//             on its own thread (chord_cascade<D>, bingham.cuh); lane c
//             writes row c - 1 of J to the group's shared memory;
//   inverse   the group's first lane forms the inverse of
//             J^T J (1 + 1e-5) + 1e-20 by the unrolled Cholesky
//             (normal_inverse, bingham.cuh, shared with the whole-fit
//             kernel);
//   steps     `iterations` steps u <- clip(u - clip(Minv J^T (g(u) - s),
//             +-1e3)), each one cascade, run by every lane of the group
//             on the same values (chord_cascade<D>), every lane forming
//             the update;
//
// then writes lambda = lam_of_u(u), ascending with the maximum pinned to 0.
//
// What bounds it on the H100: the step chain, 16 cascades one after
// another per problem (12 kFLOP a cascade at D=6), not the bytes (3 D
// floats a problem). At the M-step's 3,084 problems a warp carries 5
// problems (D=6) and an SM ~5 warps, too few to hide the chain's latency:
// a step cascade takes ~5 us on one lane, and 8x the problems take only
// ~4.3x the time (PERF.md). The design shortens the chain (the round's D
// finite-difference cascades run at once: 1 + iterations cascades long,
// not D + iterations) and keeps every cascade in registers, off shared
// memory. Splitting a step cascade's rows over 2, 4 or D lanes, the rows
// exchanged by __shfl_sync once a squaring, measured slower than one lane
// (PERF.md): the shuffles cost more than the multiply-adds they spread.
//
// Layouts (all contiguous): s, x0, out (B, D) float.
#include <cfloat>
#include <cmath>
#include <cuda_runtime.h>

#include "bingham.cuh"

namespace {

constexpr int kThreads = 32;  // one warp a block
// floats of shared memory a problem: J and Minv, 7 rows of 8 each; odd, so
// that the groups of a warp read their rows from distinct banks
constexpr int kProblemFloats = 113;

template <int D>
__global__ void __launch_bounds__(kThreads)
bingham_chord_kernel(const float* __restrict__ s_in,
                     const float* __restrict__ x0_in,
                     float* __restrict__ out, int B, int iterations,
                     float lower, float upper, float fd_step) {
  constexpr int D1 = D - 1;
  constexpr int kPer = 32 / D;  // problems a warp
  __shared__ float scratch[kPer * kProblemFloats];
  const int lane = threadIdx.x;
  const int group = lane / D;
  if (group >= kPer) return;  // lanes past the last group
  const int sub = lane - group * D;
  const int base = group * D;
  const unsigned mask = ((1u << D) - 1u) << base;
  const int p = blockIdx.x * kPer + group;
  if (p >= B) return;  // the whole group leaves together
  float* Jm = scratch + group * kProblemFloats;
  float* Mi = Jm + 56;
  float s[D], u[D1], lam[D], g[D];
#pragma unroll
  for (int j = 0; j < D; ++j) s[j] = s_in[size_t(p) * D + j];
#pragma unroll
  for (int j = 0; j < D1; ++j)
    u[j] = clip_diff(x0_in[size_t(p) * D + j] - x0_in[size_t(p) * D + j + 1],
                     lower, upper);

  // ---- the finite-difference Jacobian: a cascade a lane -----------------
  {
    float us[D1];
    float h = 0.f, h_int = 0.f;
#pragma unroll
    for (int j = 0; j < D1; ++j) {
      const float shift =
          (j == sub - 1) ? fd_step * fmaxf(1.f, fabsf(u[j])) : 0.f;
      us[j] = sub == 0 ? u[j] : clip_diff(u[j] + shift, lower, upper);
      h += us[j] - u[j];
      h_int += shift;
    }
    lam_of_u<D>(us, lam);
    chord_cascade<D>(lam, g);
    float g0[D];
#pragma unroll
    for (int d = 0; d < D; ++d) g0[d] = __shfl_sync(mask, g[d], base);
    if (sub > 0) {
      const bool dead = fabsf(h) < 0.01f * fabsf(h_int);
      const float inv_h = dead ? 0.f : 1.f / h;
#pragma unroll
      for (int d = 0; d < D; ++d)
        Jm[(sub - 1) * 8 + d] = (g[d] - g0[d]) * inv_h;
    }
  }
  __syncwarp(mask);
  if (sub == 0) normal_inverse<D>(Jm, Mi);
  __syncwarp(mask);

  // ---- the chord steps: a cascade each -----------------------------------
#pragma unroll 1
  for (int it = 0; it < iterations; ++it) {
    lam_of_u<D>(u, lam);
    chord_cascade<D>(lam, g);
    float r[D], b[D1];
#pragma unroll
    for (int d = 0; d < D; ++d) r[d] = g[d] - s[d];
#pragma unroll
    for (int a = 0; a < D1; ++a) {
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) acc += Jm[a * 8 + d] * r[d];
      b[a] = acc;
    }
#pragma unroll
    for (int a = 0; a < D1; ++a) {
      float delta = 0.f;
#pragma unroll
      for (int k = 0; k < D1; ++k) delta += Mi[a * 8 + k] * b[k];
      delta = fminf(fmaxf(delta, -1e3f), 1e3f);
      u[a] = clip_diff(u[a] - delta, lower, upper);
    }
  }
  lam_of_u<D>(u, lam);
  if (sub == 0) {
#pragma unroll
    for (int j = 0; j < D; ++j) out[size_t(p) * D + j] = lam[j];
  }
}

template <int D>
int launch(const float* s, const float* x0, float* out, int B,
           int iterations, float lower, float upper, float fd_step,
           cudaStream_t stream) {
  constexpr int per_block = 32 / D;
  bingham_chord_kernel<D><<<(B + per_block - 1) / per_block, kThreads, 0,
                               stream>>>(s, x0, out, B, iterations, lower,
                                         upper, fd_step);
  return int(cudaGetLastError());
}

}  // namespace

// Launch one chord round for B problems of dimension D (2 <= D <= 8) on
// `stream`. Returns a cudaError_t (0 on success; cudaErrorInvalidValue for
// an unsupported D); neither synchronizes nor allocates.
extern "C" int bingham_chord_launch(const void* s, const void* x0, void* out,
                                    int B, int D, int iterations,
                                    float lower, float upper, float fd_step,
                                    void* stream) {
  const auto* s_ = static_cast<const float*>(s);
  const auto* x_ = static_cast<const float*>(x0);
  auto* o_ = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
#define LAUNCH(DV) \
  launch<DV>(s_, x_, o_, B, iterations, lower, upper, fd_step, st)
  switch (D) {
    case 2: return LAUNCH(2);
    case 3: return LAUNCH(3);
    case 4: return LAUNCH(4);
    case 5: return LAUNCH(5);
    case 6: return LAUNCH(6);
    case 7: return LAUNCH(7);
    case 8: return LAUNCH(8);
    default: return int(cudaErrorInvalidValue);
  }
#undef LAUNCH
}
