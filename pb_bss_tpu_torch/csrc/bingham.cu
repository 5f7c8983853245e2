// Batched Bingham moment inversion: one chord Gauss-Newton round per
// problem (ops/bingham.py: bingham_chord_solve).
//
// Replaces pb_bss_tpu/ops/pallas_bingham.py:bingham_chord_solve (the
// Pallas TPU kernel, problems in the lanes of a (D, tile) block). Here a
// group of 8 lanes owns one problem (bingham.cuh): it loads the sorted
// moments and the start, clips the start's diffs into [lower, upper],
// runs bingham_chord_round (1 + (D - 1) + iterations cascades) and writes
// lambda = lam_of_u(u), ascending with the maximum pinned to 0.
//
// What bounds it on the H100: the cascades' fp32 FMAs (about 12 kFLOP per
// cascade at D=6, 16 cascades per problem for a 10-step round); the bytes
// are 3 D floats per problem. The design keeps every cascade in registers
// and a 1.5 KB shared scratch per problem, and uses blocks of 8 problems
// (64 threads) so that the few thousand problems of an M-step spread over
// all 132 SMs.
//
// Layouts (all contiguous): s, x0, out (B, D) float.
#include <cfloat>
#include <cmath>
#include <cuda_runtime.h>

#include "bingham.cuh"

namespace {

constexpr int kThreads = 64;  // 8 problems per block

template <int D>
__global__ void __launch_bounds__(kThreads)
bingham_chord_kernel(const float* __restrict__ s_in,
                     const float* __restrict__ x0_in,
                     float* __restrict__ out, int B, int iterations,
                     float lower, float upper, float fd_step) {
  extern __shared__ float4 smem_raw[];
  float* scratch = reinterpret_cast<float*>(smem_raw) +
                   (threadIdx.x / kGroup) * kGroupFloats;
  const int p = blockIdx.x * (kThreads / kGroup) + threadIdx.x / kGroup;
  if (p >= B) return;  // the whole group leaves together
  float s[D], x0[D], u[D - 1], lam[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    s[j] = s_in[size_t(p) * D + j];
    x0[j] = x0_in[size_t(p) * D + j];
  }
#pragma unroll
  for (int j = 0; j < D - 1; ++j)
    u[j] = clip_diff(x0[j] - x0[j + 1], lower, upper);
  bingham_chord_round<D>(s, u, iterations, lower, upper, fd_step, scratch);
  lam_of_u<D>(u, lam);
  if ((threadIdx.x & 7) == 0) {
#pragma unroll
    for (int j = 0; j < D; ++j) out[size_t(p) * D + j] = lam[j];
  }
}

template <int D>
int launch(const float* s, const float* x0, float* out, int B,
           int iterations, float lower, float upper, float fd_step,
           cudaStream_t stream) {
  const size_t bytes = sizeof(float) * kGroupFloats * (kThreads / kGroup);
  const int per_block = kThreads / kGroup;
  bingham_chord_kernel<D><<<(B + per_block - 1) / per_block, kThreads, bytes,
                            stream>>>(s, x0, out, B, iterations, lower,
                                      upper, fd_step);
  return int(cudaGetLastError());
}

}  // namespace

// Launch one chord round for B problems of dimension D (2 <= D <= 8) on
// `stream`. Returns a cudaError_t (0 on success; cudaErrorInvalidValue
// for an unsupported D); neither synchronizes nor allocates.
extern "C" int bingham_chord_launch(const void* s, const void* x0, void* out,
                                    int B, int D, int iterations,
                                    float lower, float upper, float fd_step,
                                    void* stream) {
  const auto* s_ = static_cast<const float*>(s);
  const auto* x_ = static_cast<const float*>(x0);
  auto* o_ = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 2: return launch<2>(s_, x_, o_, B, iterations, lower, upper, fd_step, st);
    case 3: return launch<3>(s_, x_, o_, B, iterations, lower, upper, fd_step, st);
    case 4: return launch<4>(s_, x_, o_, B, iterations, lower, upper, fd_step, st);
    case 5: return launch<5>(s_, x_, o_, B, iterations, lower, upper, fd_step, st);
    case 6: return launch<6>(s_, x_, o_, B, iterations, lower, upper, fd_step, st);
    case 7: return launch<7>(s_, x_, o_, B, iterations, lower, upper, fd_step, st);
    case 8: return launch<8>(s_, x_, o_, B, iterations, lower, upper, fd_step, st);
    default: return int(cudaErrorInvalidValue);
  }
}
