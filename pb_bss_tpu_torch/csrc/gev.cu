// Fused GEV beamformer: the dominant generalized eigenvector of each
// Hermitian pencil (phi_xx, phi_nn) in ONE launch.
//
// Replaces pb_bss_tpu/ops/pallas_gev.py:gev_pallas (the Pallas TPU
// kernel). One warp owns one pencil, its D x D matrices (D <= 16) in
// shared memory, lanes over the row or column index:
//
//   complex Cholesky phi_nn = L L^H (column by column; a non-positive
//   pivot gives sqrtf(negative) = NaN and the whole vector comes out
//   non-finite, which the caller's diagonal-loading retry relies on),
//   X = L^-1 phi_xx (rows in order), C = X L^-H (columns in order),
//   C hermitized from its upper triangle, cyclic Jacobi (jacobi.cuh),
//   the dominant eigenvector (first index among equal maxima), and the
//   back-substitution w = L^-H u. The result is B-normalized:
//   w^H phi_nn w = 1.
//
// What bounds it on the H100: a pencil is ~1 KB in and 48 bytes out at
// D=6, and a call holds a few hundred to a few thousand pencils, so the
// kernel is bound by latency (the sequential Cholesky, solves and
// Jacobi sweeps of one pencil), not by bytes or FLOPs. The design keeps
// every pencil on one warp with no block-wide barrier, and packs
// kWarps pencils per CTA; the batch tail is a bounds check (no padded
// identity pencils).
//
// Layouts (contiguous): phi_xx, phi_nn (B, D, D) complex64 as float2;
// beam (B, D) complex64.
#include <cfloat>
#include <cuda_runtime.h>

#include "jacobi.cuh"

namespace {

constexpr int kWarps = 4;

__global__ void __launch_bounds__(kWarps * 32)
gev_kernel(const float2* __restrict__ phi_xx,
           const float2* __restrict__ phi_nn, float2* __restrict__ beam,
           int B, int D, int sweeps) {
  extern __shared__ float4 smem_raw[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int DD = D * D;
  const long b = long(blockIdx.x) * kWarps + warp;
  if (b >= B) return;  // whole warp leaves; no block-wide barrier below

  float2* N = reinterpret_cast<float2*>(smem_raw) + size_t(warp) * 4 * DD;
  float2* L = N + DD;
  float2* C = L + DD;
  float2* V = C + DD;
  for (int i = lane; i < DD; i += 32) {
    N[i] = phi_nn[b * DD + i];
    C[i] = phi_xx[b * DD + i];
    L[i] = make_float2(0.f, 0.f);
  }
  __syncwarp();

  // ---- Cholesky phi_nn = L L^H (lower) -----------------------------
  for (int j = 0; j < D; ++j) {
    float s = N[j * D + j].x;
    for (int k = 0; k < j; ++k) {
      const float2 l = L[j * D + k];
      s -= l.x * l.x + l.y * l.y;
    }
    const float dj = sqrtf(s);  // negative pivot -> NaN (non-PD bin)
    const int i = lane;
    if (i > j && i < D) {
      float2 t = N[i * D + j];
      for (int k = 0; k < j; ++k)
        t = c_sub(t, c_mul_conj(L[i * D + k], L[j * D + k]));
      L[i * D + j] = make_float2(t.x / dj, t.y / dj);
    }
    if (lane == j) L[j * D + j] = make_float2(dj, 0.f);
    __syncwarp();
  }

  // ---- X = L^-1 phi_xx, row by row (lane = column) ------------------
  for (int i = 0; i < D; ++i) {
    if (lane < D) {
      float2 r = C[i * D + lane];
      for (int k = 0; k < i; ++k)
        r = c_sub(r, c_mul(L[i * D + k], C[k * D + lane]));
      const float inv = 1.f / L[i * D + i].x;
      C[i * D + lane] = c_scale(inv, r);
    }
    __syncwarp();
  }

  // ---- C = X L^-H, column by column (lane = row) --------------------
  for (int j = 0; j < D; ++j) {
    if (lane < D) {
      float2 q = C[lane * D + j];
      for (int k = 0; k < j; ++k)
        q = c_sub(q, c_mul_conj(C[lane * D + k], L[j * D + k]));
      const float inv = 1.f / L[j * D + j].x;
      C[lane * D + j] = c_scale(inv, q);
    }
    __syncwarp();
  }

  // ---- hermitize from the upper triangle ----------------------------
  if (lane < D) {
    const int i = lane;
    C[i * D + i].y = 0.f;
    for (int j = i + 1; j < D; ++j) {
      const float2 u = C[i * D + j];
      const float2 l = C[j * D + i];
      const float2 h = make_float2(0.5f * (u.x + l.x), 0.5f * (u.y - l.y));
      C[i * D + j] = h;
      C[j * D + i] = c_conj(h);
    }
  }
  __syncwarp();

  // ---- eigendecomposition, dominant eigenvector ---------------------
  warp_set_identity(V, D);
  warp_jacobi(C, V, D, sweeps);
  if (lane == 0) {
    int best = 0;
    float wbest = C[0].x;
    for (int e = 1; e < D; ++e) {
      if (C[e * D + e].x > wbest) {  // strict: first index wins ties
        wbest = C[e * D + e].x;
        best = e;
      }
    }
    // ---- back-substitute w = L^-H u, u = V[:, best] -----------------
    float2* x = N;  // phi_nn is no longer needed
    for (int i = D - 1; i >= 0; --i) {
      float2 r = V[i * D + best];
      for (int k = i + 1; k < D; ++k)
        r = c_sub(r, c_conj_mul(L[k * D + i], x[k]));
      x[i] = c_scale(1.f / L[i * D + i].x, r);
    }
    for (int i = 0; i < D; ++i) beam[b * D + i] = x[i];
  }
}

size_t gev_smem_bytes(int D) {
  return sizeof(float2) * size_t(kWarps) * 4 * D * D;
}

}  // namespace

// Launch the fused GEV on `stream` for B pencils. Returns a cudaError_t
// (0 on success); neither synchronizes nor allocates.
extern "C" int gev_launch(const void* phi_xx, const void* phi_nn,
                          void* beam, int B, int D, int sweeps,
                          void* stream) {
  const int blocks = (B + kWarps - 1) / kWarps;
  gev_kernel<<<blocks, kWarps * 32, gev_smem_bytes(D),
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(phi_xx), static_cast<const float2*>(phi_nn),
      static_cast<float2*>(beam), B, D, sweeps);
  return int(cudaGetLastError());
}
