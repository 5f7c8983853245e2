// Batched Hermitian eigendecomposition by cyclic Jacobi sweeps.
//
// Replaces pb_bss_tpu/ops/pallas_eigh.py:eigh_jacobi_pallas (the Pallas
// TPU kernel). There the batch lay in the TPU's vector lanes, a tile of
// 256 matrices per grid step, and each rotation was a few lane-wide
// vector ops. Here ONE WARP owns one d x d matrix (d <= 16) in shared
// memory and runs every sweep on it with warp_jacobi (jacobi.cuh, the
// rotation shared with the whole-fit EM and the GEV kernels); kWarps
// matrices share a CTA, and the batch tail is a bounds check (no padded
// identity matrices).
//
// Real symmetric input runs the same complex rotation with zero
// imaginary parts (s = sr * apq / |apq| = sr * sign(apq), the real
// Jacobi's rotation) and returns the real part of V. A zero off-diagonal
// entry is skipped as an identity rotation, so identity and diagonal
// matrices come out exactly diagonal with V = I.
//
// What bounds it on the H100: a 6 x 6 complex matrix is 288 bytes in
// and 312 bytes out, against 6 sweeps x 15 rotations of dependent,
// warp-synchronous steps, so the kernel is bound by the latency of one
// matrix's sweeps, not by bytes or FLOPs; the design keeps each matrix
// on one warp with no block-wide barrier so that many matrices are in
// flight per SM.
//
// Layouts (contiguous): a (B, d, d) complex64 as float2, or float32;
// w (B, d) float32, unsorted (the wrapper sorts); v (B, d, d) complex64
// or float32 like a, eigenvectors in columns.
#include <cuda_runtime.h>

#include "jacobi.cuh"

namespace {

constexpr int kWarps = 4;

template <bool kComplex>
__global__ void __launch_bounds__(kWarps * 32)
eigh_jacobi_kernel(const void* __restrict__ a_in, float* __restrict__ w,
                   void* __restrict__ v_out, int B, int d, int sweeps) {
  extern __shared__ float4 smem_raw[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int dd = d * d;
  const long b = long(blockIdx.x) * kWarps + warp;
  if (b >= B) return;  // whole warp leaves; no block-wide barrier below

  float2* A = reinterpret_cast<float2*>(smem_raw) + size_t(warp) * 2 * dd;
  float2* V = A + dd;
  for (int i = lane; i < dd; i += 32) {
    if (kComplex)
      A[i] = static_cast<const float2*>(a_in)[b * dd + i];
    else
      A[i] = make_float2(static_cast<const float*>(a_in)[b * dd + i], 0.f);
  }
  warp_set_identity(V, d);  // ends with __syncwarp
  warp_jacobi(A, V, d, sweeps);

  if (lane < d) w[b * d + lane] = A[lane * d + lane].x;
  for (int i = lane; i < dd; i += 32) {
    if (kComplex)
      static_cast<float2*>(v_out)[b * dd + i] = V[i];
    else
      static_cast<float*>(v_out)[b * dd + i] = V[i].x;
  }
}

}  // namespace

// Launch the batched Jacobi on `stream` for B matrices of size d x d
// (complex64 when is_complex, else float32). Returns a cudaError_t
// (0 on success); neither synchronizes nor allocates.
extern "C" int eigh_jacobi_launch(const void* a, void* w, void* v, int B,
                                  int d, int sweeps, int is_complex,
                                  void* stream) {
  const int blocks = (B + kWarps - 1) / kWarps;
  const size_t bytes = sizeof(float2) * size_t(kWarps) * 2 * d * d;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_complex)
    eigh_jacobi_kernel<true><<<blocks, kWarps * 32, bytes, s>>>(
        a, static_cast<float*>(w), v, B, d, sweeps);
  else
    eigh_jacobi_kernel<false><<<blocks, kWarps * 32, bytes, s>>>(
        a, static_cast<float*>(w), v, B, d, sweeps);
  return int(cudaGetLastError());
}
