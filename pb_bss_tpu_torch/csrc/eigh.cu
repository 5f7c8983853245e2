// Batched Hermitian eigendecomposition by cyclic Jacobi sweeps, the
// eigenpairs sorted in the kernel (K1).
//
// Replaces pb_bss_tpu/ops/pallas_eigh.py:eigh_jacobi_pallas (the Pallas
// TPU kernel). There the batch lay in the TPU's vector lanes, a tile of
// 256 matrices per grid step, each rotation a few lane-wide vector ops,
// and the sort a rank count and a one-hot product outside the kernel.
// Here every matrix lives in registers: a lane owns one column of A and
// of V of one matrix (D a template parameter, 1..16), floor(32 / D)
// matrices to a warp. The sweeps take the plain twin's cyclic order
// (p, q) = (0, 1), (0, 2), .., (D - 2, D - 1), its disjoint rotations in
// one step (em_iter.cuh's column_jacobi_wavefront: 2 D - 3 steps a sweep,
// not D (D - 1) / 2), the two lanes of a pair computing its rotation and
// exchanging their columns by shuffle. The rotation is the twin's at any
// scale (twin_rotation: |a_pq| without squaring it, and no rotation only
// where a_pq is exactly zero), so identity and diagonal matrices come out
// exactly, and a matrix of entries near 1e-20 rotates as the twin rotates
// it.
//
// The sort: each lane ranks its eigenvalue among its matrix's D by
// counting over shuffles (ascending, ties to the lower index, NaN after
// every number: the order of the twin's stable torch.sort, and a strict
// total order, so the ranks are a permutation for any input, NaN
// included), then writes its eigenvalue and its column of V at its rank.
// Without the sort, at its own index (the Jacobi's order).
//
// Real symmetric input loads with zero imaginary parts into the same
// instantiation (the rotation is then the real Jacobi's, s = sr sign(a_pq))
// and stores the real part of V: a run-time flag that touches only the
// load and the store.
//
// What bounds it on the H100: a 6 x 6 complex matrix is 288 bytes in and
// 312 out (1.9 MB at 3,084 matrices, ~0.6 us at 3.35 TB/s), against 6
// sweeps of 15 rotations, each O(D) complex multiply-adds on rows, columns
// and V (~1.6 us at the fp32 rate): the dependent steps of the sweeps set
// the time. So the sweeps run in registers with no barrier (54 steps a
// matrix at D=6), a warp's matrices, contiguous in memory, go in and out
// through shared memory in coalesced runs, and the host picks the warps a
// CTA (1, 2 or 4) so that the CTAs spread over every SM.
//
// Layouts (contiguous): a (B, D, D) complex64 as float2, or float32;
// w (B, D) float32; v (B, D, D) complex64 or float32 like a, eigenvectors
// in columns.
#include <cmath>
#include <cuda_runtime.h>

#include "em_iter.cuh"

namespace {

constexpr int kMaxWarps = 4;

// Does eigenvalue lm of column m sort before eigenvalue lj of column j?
// Ascending, ties to the lower index, NaN after every number and NaNs in
// index order: the order of a stable torch.sort. It is strict and total,
// so counting what sorts before each eigenvalue ranks them without
// duplicates.
__device__ __forceinline__ bool sorts_before(float lm, int m, float lj,
                                             int j) {
  const bool nm = isnan(lm), nj = isnan(lj);
  if (nm || nj) return nm == nj ? m < j : nj;
  return lm < lj || (lm == lj && m < j);
}

template <int D>
__global__ void __launch_bounds__(kMaxWarps * 32)
eigh_jacobi_kernel(const void* __restrict__ a_in, float* __restrict__ w,
                   void* __restrict__ v_out, int B, int sweeps,
                   bool is_complex, bool sort) {
  constexpr int DD = D * D;
  constexpr int kPerWarp = 32 / D;  // matrices a warp
  __shared__ float2 stage[kMaxWarps][kPerWarp * DD];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long b0 =
      (static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp) *
      kPerWarp;
  if (b0 >= B) return;  // the whole warp leaves; no block-wide barrier
  const int count = static_cast<int>(
      B - b0 < kPerWarp ? B - b0 : kPerWarp);
  float2* sm = stage[warp];

  // the warp's matrices in, coalesced
  const float2* ac = static_cast<const float2*>(a_in) + b0 * DD;
  const float* ar = static_cast<const float*>(a_in) + b0 * DD;
  for (int i = lane; i < count * DD; i += 32)
    sm[i] = is_complex ? ac[i] : make_float2(ar[i], 0.f);
  __syncwarp();

  // this lane's column j of matrix b0 + slot
  const int slot = lane / D;
  const int j = lane - slot * D;
  const int base = slot * D;
  const bool own = slot < count;
  float2 a[D], v[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    a[i] = own ? sm[slot * DD + i * D + j] : make_float2(0.f, 0.f);
    v[i] = make_float2(i == j ? 1.f : 0.f, 0.f);
  }
  column_jacobi_wavefront<D, true>(a, v, base, j, own, sweeps);
  float lam = 0.f;
#pragma unroll
  for (int i = 0; i < D; ++i)
    if (i == j) lam = a[i].x;

  int rank = j;
  if (sort) {
    rank = 0;
#pragma unroll
    for (int m = 0; m < D; ++m)
      rank += sorts_before(__shfl_sync(kFullMask, lam, base + m), m, lam, j);
  }
  __syncwarp();  // every lane has read its column of the staged input
  if (own) {
    w[(b0 + slot) * D + rank] = lam;
#pragma unroll
    for (int i = 0; i < D; ++i) sm[slot * DD + i * D + rank] = v[i];
  }
  __syncwarp();

  // the warp's eigenvectors out, coalesced
  float2* vc = static_cast<float2*>(v_out) + b0 * DD;
  float* vr = static_cast<float*>(v_out) + b0 * DD;
  for (int i = lane; i < count * DD; i += 32) {
    if (is_complex)
      vc[i] = sm[i];
    else
      vr[i] = sm[i].x;
  }
}

template <int D>
cudaError_t launch(const void* a, void* w, void* v, int B, int sweeps,
                   bool is_complex, bool sort, int warps,
                   cudaStream_t stream) {
  const long long per_cta = static_cast<long long>(warps) * (32 / D);
  const int blocks = static_cast<int>((B + per_cta - 1) / per_cta);
  eigh_jacobi_kernel<D><<<blocks, warps * 32, 0, stream>>>(
      a, static_cast<float*>(w), v, B, sweeps, is_complex, sort);
  return cudaGetLastError();
}

}  // namespace

// Launch the batched Jacobi on `stream` for B matrices of size d x d
// (complex64 when is_complex, else float32), `warps` (1..4) warps a CTA;
// with `sort` the eigenpairs come out ascending. Returns a cudaError_t
// (0 on success; cudaErrorInvalidValue for d outside 1..16 or warps
// outside 1..4); neither synchronizes nor allocates.
extern "C" int eigh_jacobi_launch(const void* a, void* w, void* v, int B,
                                  int d, int sweeps, int is_complex,
                                  int sort, int warps, void* stream) {
  if (warps < 1 || warps > kMaxWarps) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool c = is_complex != 0, o = sort != 0;
#define CALL(DV) int(launch<DV>(a, w, v, B, sweeps, c, o, warps, s))
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
