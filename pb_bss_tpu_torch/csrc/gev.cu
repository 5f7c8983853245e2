// Fused GEV beamformer (K3): the dominant generalized eigenvector of each
// Hermitian pencil (phi_xx, phi_nn) in ONE launch, and on request the
// diagonal-loading retry of get_gev_vector in the same launch.
//
// Replaces pb_bss_tpu/ops/pallas_gev.py:gev_pallas (the Pallas TPU
// kernel). There the pencils lay in the TPU's vector lanes; here every
// pencil lives in registers, as the batched Jacobi (eigh.cu, K1) keeps its
// matrices: a lane owns one column of each working matrix of one pencil
// (D a template parameter, 1..16), floor(32 / D) pencils to a warp, and
// every stage is a chain of shuffles between the lanes of a pencil:
//
//   1. the complex Cholesky phi_nn = L L^H, right-looking: in step k lane
//      k broadcasts column k of L and the lanes right of it update their
//      columns. A non-positive pivot gives sqrtf(negative) = NaN and the
//      vector comes out non-finite. Each lane keeps its column of L, its
//      row of L and the diagonal.
//   2. X = L^-1 phi_xx (each lane its column, fed by the same broadcasts
//      of step 1) and C = X L^-H (column k final on lane k, then
//      broadcast), each sum in the plain twin's order.
//   3. C hermitized, (C + C^H) / 2, the transpose by D - 1 rotations of
//      shuffles.
//   4. the twin's cyclic Jacobi sweeps in disjoint steps with the twin's
//      rotation at any scale (em_iter.cuh: column_jacobi_wavefront and
//      twin_rotation), the twin never moved onto the kernel's schedule.
//   5. the dominant eigenvector: the first index among equal maxima, NaN
//      above every number, as torch.argmax.
//   6. the back-substitution w = L^-H u, one entry a step, broadcast.
//
// The result is B-normalized: w^H phi_nn w = 1. With `retry`, a pencil
// whose vector is not finite (|w_d| not finite for some d, as
// torch.isfinite(w.abs())) runs again in the same launch on its loaded
// noise PSD, (phi_nn + gamma tr(phi_nn) / D I) / (1 + gamma), as
// condition_hermitian loads it; the warps without such a pencil skip the
// second pass.
//
// What bounds it on the H100: a 6 x 6 pencil is 576 bytes in and 48 out
// (3.8 MB at 6,168 pencils, ~1.1 us at 3.35 TB/s), against the Cholesky,
// the solves and 6 sweeps of 15 rotations (~3.5 us at the fp32 rate): the
// dependent steps of one pencil set the time. So they run in registers
// with no barrier, a warp's pencils, contiguous in memory, go in through
// shared memory in coalesced runs, the vectors go out coalesced (lane l
// of a warp writes entry l of its pencils' vectors), and the host picks
// the warps a CTA (1, 2 or 4) so that the CTAs spread over every SM.
// Tensor cores are not used: a 6 x 6 pencil is far below wgmma's 64-row
// tile, and TF32 would round the whitening to ~1e-3.
//
// Layouts (contiguous): phi_xx, phi_nn (B, D, D) complex64 as float2;
// beam (B, D) complex64.
#include <cfloat>
#include <cmath>
#include <cuda_runtime.h>

#include "em_iter.cuh"

namespace {

constexpr int kMaxWarps = 4;

__device__ __forceinline__ float2 shfl2(float2 v, int src) {
  return make_float2(__shfl_sync(kFullMask, v.x, src),
                     __shfl_sync(kFullMask, v.y, src));
}

// The GEV of the pencil whose columns j of phi_xx (x) and phi_nn (n) this
// lane holds (lanes base .. base + D - 1 hold its D columns; `own` false
// for lanes without a pencil). Returns entry j of the vector. Every lane
// of the warp calls it.
template <int D>
__device__ __forceinline__ float2 pencil_gev(float2 (&x)[D], float2 (&n)[D],
                                             int base, int j, bool own,
                                             int sweeps) {
  float2 lrow[D];  // row j of L
  float ldiag[D];  // the diagonal of L
#pragma unroll
  for (int k = 0; k < D; ++k) lrow[k] = make_float2(0.f, 0.f);

  // ---- 1, 2a: Cholesky, column k from lane k; X = L^-1 phi_xx ---------
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const float d = sqrtf(__shfl_sync(kFullMask, n[k].x, base + k));
    const float inv = 1.f / d;  // a zero or NaN pivot: non-finite
    ldiag[k] = d;
    float2 col[D];  // L[i][k], i > k
#pragma unroll
    for (int i = k + 1; i < D; ++i) {
      col[i] = c_scale(inv, shfl2(n[i], base + k));
      if (i == j) lrow[k] = col[i];
    }
    if (j == k) {
      lrow[k] = make_float2(d, 0.f);
      n[k] = lrow[k];  // the lane's column becomes column k of L
#pragma unroll
      for (int i = k + 1; i < D; ++i) n[i] = col[i];
    } else if (j > k) {
      // A[i][j] -= L[i][k] conj(L[j][k])
#pragma unroll
      for (int i = k + 1; i < D; ++i)
        n[i] = c_sub(n[i], c_mul_conj(col[i], lrow[k]));
    }
    // row k of X, then its share of the rows below
    x[k] = c_scale(inv, x[k]);
#pragma unroll
    for (int i = k + 1; i < D; ++i) x[i] = c_sub(x[i], c_mul(col[i], x[k]));
  }

  // ---- 2b: C = X L^-H, column k final on lane k ------------------------
#pragma unroll
  for (int k = 0; k < D; ++k) {
    if (j == k) {
      const float inv = 1.f / ldiag[k];
#pragma unroll
      for (int i = 0; i < D; ++i) x[i] = c_scale(inv, x[i]);
    }
    const float2 lc = c_conj(lrow[k]);
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const float2 ck = shfl2(x[i], base + k);
      if (j > k) x[i] = c_sub(x[i], c_mul(ck, lc));
    }
  }

  // ---- 3: hermitize, (C + C^H) / 2 -------------------------------------
  // in rotation r lane j reads C[j][s] from lane s = j + r (mod D), which
  // sends its entry s - r (mod D)
  float2 a[D];
#pragma unroll
  for (int i = 0; i < D; ++i)
    a[i] = i == j ? make_float2(x[i].x, 0.f) : x[i];
#pragma unroll
  for (int r = 1; r < D; ++r) {
    const int e = j >= r ? j - r : j - r + D;
    const int s = j + r < D ? j + r : j + r - D;
    float2 send = x[0];
#pragma unroll
    for (int i = 1; i < D; ++i)
      if (i == e) send = x[i];
    const float2 got = shfl2(send, base + s);
#pragma unroll
    for (int i = 0; i < D; ++i)
      if (i == s)
        a[i] = make_float2(0.5f * (x[i].x + got.x), 0.5f * (x[i].y - got.y));
  }

  // ---- 4: the twin's cyclic Jacobi, disjoint rotations a step ----------
  float2 v[D];
#pragma unroll
  for (int i = 0; i < D; ++i) v[i] = make_float2(i == j ? 1.f : 0.f, 0.f);
  column_jacobi_wavefront<D, true>(a, v, base, j, own, sweeps);

  // ---- 5: the dominant eigenvector, torch.argmax's index ---------------
  float lam = a[0].x;
#pragma unroll
  for (int i = 1; i < D; ++i)
    if (i == j) lam = a[i].x;
  int best = 0;
  float top = __shfl_sync(kFullMask, lam, base);
#pragma unroll
  for (int m = 1; m < D; ++m) {
    const float lm = __shfl_sync(kFullMask, lam, base + m);
    if (lm > top || (isnan(lm) && !isnan(top))) {
      top = lm;
      best = m;
    }
  }

  // ---- 6: w = L^-H u, u = V[:, best]; entry i on lane i, broadcast -----
  float2 u = make_float2(0.f, 0.f);
#pragma unroll
  for (int i = 0; i < D; ++i) {
    const float2 ui = shfl2(v[i], base + best);
    if (i == j) u = ui;
  }
  float2 w[D];
#pragma unroll
  for (int i = D - 1; i >= 0; --i) {
    // on lane i: u_i - sum_{k > i} conj(L[k][i]) w_k, over L[i][i]
    float2 t = u;
#pragma unroll
    for (int k = i + 1; k < D; ++k) t = c_sub(t, c_conj_mul(n[k], w[k]));
    w[i] = shfl2(c_scale(1.f / ldiag[i], t), base + i);
  }
  float2 out = w[0];
#pragma unroll
  for (int i = 1; i < D; ++i)
    if (i == j) out = w[i];
  return out;
}

template <int D>
__global__ void __launch_bounds__(kMaxWarps * 32)
gev_kernel(const float2* __restrict__ phi_xx,
           const float2* __restrict__ phi_nn, float2* __restrict__ beam,
           int B, int sweeps, bool retry, float gamma) {
  constexpr int DD = D * D;
  constexpr int kPerWarp = 32 / D;  // pencils a warp
  __shared__ float2 stage[kMaxWarps][2 * kPerWarp * DD];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long b0 =
      (static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp) *
      kPerWarp;
  if (b0 >= B) return;  // the whole warp leaves; no block-wide barrier
  const int count = static_cast<int>(
      B - b0 < kPerWarp ? B - b0 : kPerWarp);
  float2* sx = stage[warp];
  float2* sn = sx + kPerWarp * DD;

  // the warp's pencils in, coalesced
  for (int i = lane; i < count * DD; i += 32) {
    sx[i] = phi_xx[b0 * DD + i];
    sn[i] = phi_nn[b0 * DD + i];
  }
  __syncwarp();

  // this lane's column j of pencil b0 + slot
  const int slot = lane / D;
  const int j = lane - slot * D;
  const int base = slot * D;
  const bool own = slot < count;
  const unsigned group = ((1u << D) - 1u) << base;
  float2 result = make_float2(0.f, 0.f);
  bool redo = false;
#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {
    // the second pass loads the noise PSD: (x + gamma tr(x) / D I) /
    // (1 + gamma), the division as torch's by a scalar, times the
    // reciprocal
    const float load_scale = 1.f / (1.f + gamma);
    float shift = 0.f;
    if (pass == 1 && own) {
      float tr = 0.f;
      for (int m = 0; m < D; ++m) tr += sn[slot * DD + m * D + m].x;
      shift = gamma * tr / float(D);
    }
    float2 x[D], n[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      x[i] = own ? sx[slot * DD + i * D + j] : make_float2(0.f, 0.f);
      n[i] = own ? sn[slot * DD + i * D + j] : make_float2(0.f, 0.f);
      if (pass == 1)
        n[i] = c_scale(load_scale,
                       make_float2(n[i].x + (i == j ? shift : 0.f), n[i].y));
    }
    const float2 w = pencil_gev<D>(x, n, base, j, own, sweeps);
    if (pass == 1) {
      if (redo) result = w;
      break;
    }
    result = w;
    const unsigned bad =
        __ballot_sync(kFullMask, own && !isfinite(hypotf(w.x, w.y)));
    redo = (bad & group) != 0;  // this lane's pencil
    if (!retry || bad == 0) break;  // the same on every lane
  }
  if (own) beam[b0 * D + lane] = result;
}

template <int D>
cudaError_t launch(const void* xx, const void* nn, void* beam, int B,
                   int sweeps, int warps, bool retry, float gamma,
                   cudaStream_t stream) {
  const long long per_cta = static_cast<long long>(warps) * (32 / D);
  const int blocks = static_cast<int>((B + per_cta - 1) / per_cta);
  gev_kernel<D><<<blocks, warps * 32, 0, stream>>>(
      static_cast<const float2*>(xx), static_cast<const float2*>(nn),
      static_cast<float2*>(beam), B, sweeps, retry, gamma);
  return cudaGetLastError();
}

}  // namespace

// Launch the fused GEV on `stream` for B pencils of size d x d, `warps`
// (1..4) warps a CTA. With `retry`, a pencil whose vector is not finite is
// solved again on its noise PSD loaded by `gamma`. Returns a cudaError_t (0 on success; cudaErrorInvalidValue for
// d outside 1..16 or warps outside 1..4); neither synchronizes nor
// allocates.
extern "C" int gev_launch(const void* phi_xx, const void* phi_nn, void* beam,
                          int B, int d, int sweeps, int warps, int retry,
                          float gamma, void* stream) {
  if (warps < 1 || warps > kMaxWarps) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool r = retry != 0;
#define CALL(DV) \
  int(launch<DV>(phi_xx, phi_nn, beam, B, sweeps, warps, r, gamma, s))
  switch (d) {
    case 1: return CALL(1); case 2: return CALL(2);
    case 3: return CALL(3); case 4: return CALL(4);
    case 5: return CALL(5); case 6: return CALL(6);
    case 7: return CALL(7); case 8: return CALL(8);
    case 9: return CALL(9); case 10: return CALL(10);
    case 11: return CALL(11); case 12: return CALL(12);
    case 13: return CALL(13); case 14: return CALL(14);
    case 15: return CALL(15); case 16: return CALL(16);
    default: return int(cudaErrorInvalidValue);
  }
#undef CALL
}
