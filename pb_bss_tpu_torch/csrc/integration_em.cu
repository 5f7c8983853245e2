// Integration-model EM statistics: one pass of E-step + M-step sums per EM
// iteration of VMFCACGMMTrainer / GCACGMMTrainer (K10).
//
// Replaces pb_bss_tpu/ops/pallas_integration_em.py:e_stats_staged (the
// Pallas TPU kernel, bins in the lanes, one grid step per frequency tile
// holding all T). The integration models couple a per-bin spatial cACG
// with a GLOBAL spectral model (vMF or Gaussian) over all bins of an
// utterance, so the M-step cannot stay inside a bin; this pass emits the
// sums it needs and the finish runs in PyTorch (the Banerjee or Gaussian
// closed form over the bins, the covariance D S / max(asum, tiny) and its
// eigh, K1). The posterior never reaches device memory.
//
//   grid (bins N, splits S): CTA (n, s) owns bin n and the frames
//   [s * chunk, min(T, (s + 1) * chunk)), walks them in tiles of
//   integration::kTile frames in shared memory (integration.cuh: the
//   E-step a thread per frame, the sums a warp per (class, item)) and
//   writes its own partial sums. The wrapper adds the S partials in a
//   fixed order (no float atomics), so runs repeat bit for bit. The time
//   split fills the card for a single utterance (513 bins on 132 SMs); a
//   CTA takes any T, so the kernel has no T limit (the TPU's VMEM budget
//   had one).
//
// What bounds it on the H100: y and the embedding are read once per pass
// (at F=513, T=300, D=6, E=20: 7.4 + 12.3 MB, ~5.9 us at 3.35 TB/s),
// against ~1 kFLOP a frame (the quadratic forms, the spectral dots, the
// scatter and resultant sums) of ~0.15 GFLOP, ~2.3 us at the fp32 rate:
// the bytes, so the design reads each input once, coalesced along time,
// and keeps the posterior in shared memory only.
//
// Layouts (all contiguous): y (N, D, T) complex64 as float2; emb (N, E, T)
// float; sal (N, T) or null; eigval (N, K, D); eigvec (N, K, D, D)
// complex64, eigenvectors in columns; weight (N, K); the spectral state of
// utterance u = n / bins_per_utt: vec (U, K, E), prec_or_scale (U, K, E)
// Gaussian precisions or (U, K) vMF concentrations, cnst (U, K); outputs
// scatter (S, N, K, D, D) complex64 full Hermitian, asum (S, N, K), res
// (S, N, K, E), m2 (S, N, K, E) (Gaussian only).
#include <cfloat>
#include <cmath>
#include <cuda_runtime.h>

#include "integration.cuh"

namespace {

using integration::kThreads;
using integration::kTile;

inline size_t stats_smem_bytes(int D, int K, int E) {
  const size_t P = size_t(D) * (D + 1) / 2;
  return sizeof(float2) * (size_t(D) * kTile + size_t(K) * D * D + K * P) +
         sizeof(float) * (size_t(E) * kTile + 2 * size_t(K) * kTile +
                          4 * size_t(K) * E + 5 * size_t(K) + size_t(K) * D);
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
integration_stats_kernel(const float2* __restrict__ y,
                         const float* __restrict__ emb,
                         const float* __restrict__ sal,
                         const float* __restrict__ eigval,
                         const float2* __restrict__ eigvec,
                         const float* __restrict__ weight,
                         const float* __restrict__ vec,
                         const float* __restrict__ prec_or_scale,
                         const float* __restrict__ cnst,
                         float2* __restrict__ scatter_out,
                         float* __restrict__ asum_out,
                         float* __restrict__ res_out,
                         float* __restrict__ m2_out, int N, int D, int K,
                         int T, int E, int bins_per_utt, int chunk,
                         float spatial_weight, float spectral_weight,
                         float affiliation_eps) {
  extern __shared__ float4 smem_raw[];
  const int DD = D * D;
  const int P = D * (D + 1) / 2;
  integration::Tile tile;
  tile.y = reinterpret_cast<float2*>(smem_raw);           // D*kTile
  float2* V = tile.y + size_t(D) * kTile;                 // K*DD
  integration::Accum acc;
  acc.scatter = V + K * DD;                               // K*P
  tile.emb = reinterpret_cast<float*>(acc.scatter + K * P);  // E*kTile
  tile.aff = tile.emb + size_t(E) * kTile;                // K*kTile
  tile.wq = tile.aff + size_t(K) * kTile;                 // K*kTile
  acc.res = tile.wq + size_t(K) * kTile;                  // K*E
  acc.m2 = acc.res + K * E;                               // K*E
  integration::Spectral sp;
  sp.vec = acc.m2 + K * E;                                // K*E
  sp.prec = sp.vec + K * E;                               // K*E
  acc.asum = sp.prec + K * E;                             // K
  float* logdet = acc.asum + K;                           // K
  float* wgt = logdet + K;                                // K
  sp.scale = wgt + K;                                     // K
  sp.cnst = sp.scale + K;                                 // K
  float* inv_lam = sp.cnst + K;                           // K*D

  const size_t n = blockIdx.x;
  const int split = blockIdx.y;
  const int t_begin = split * chunk;
  const int t_end = min(T, t_begin + chunk);

  integration::zero_accum<MODE>(acc, D, K, E);
  integration::load_spectral<MODE>(vec, prec_or_scale, cnst,
                                   n / bins_per_utt, sp, K, E);
  for (int i = threadIdx.x; i < K * DD; i += blockDim.x)
    V[i] = eigvec[n * K * DD + i];
  integration::load_cacg(eigval + n * K * D, weight + n * K, inv_lam, logdet,
                         wgt, D, K);
  integration::accumulate_frames<MODE>(
      y, emb, sal, n, t_begin, t_end, T, tile, V, inv_lam, logdet, wgt, sp,
      acc, spatial_weight, spectral_weight, affiliation_eps, D, K, E);

  // ---- this split's partial sums, the scatter as full Hermitian matrices
  const size_t slot = size_t(split) * N + n;
  float2* out = scatter_out + slot * K * DD;
  for (int i = threadIdx.x; i < K * DD; i += blockDim.x) {
    const int k = i / DD;
    const int d = (i % DD) / D;
    const int e = i % D;
    const int lo = min(d, e);
    const int hi = max(d, e);
    const float2 v = acc.scatter[k * P + lo * D - lo * (lo - 1) / 2 + hi - lo];
    out[i] = (d == e) ? make_float2(v.x, 0.f) : (d < e ? v : c_conj(v));
  }
  for (int k = threadIdx.x; k < K; k += blockDim.x)
    asum_out[slot * K + k] = acc.asum[k];
  for (int i = threadIdx.x; i < K * E; i += blockDim.x) {
    res_out[slot * K * E + i] = acc.res[i];
    if (MODE == integration::kGaussian) m2_out[slot * K * E + i] = acc.m2[i];
  }
}

template <int MODE>
int launch(const void* y, const void* emb, const void* sal,
           const void* eigval, const void* eigvec, const void* weight,
           const void* vec, const void* prec_or_scale, const void* cnst,
           void* scatter, void* asum, void* res, void* m2, int N, int D,
           int K, int T, int E, int bins_per_utt, int splits, int chunk,
           float spatial_weight, float spectral_weight,
           float affiliation_eps, cudaStream_t stream) {
  const size_t bytes = stats_smem_bytes(D, K, E);
  cudaError_t err = cudaFuncSetAttribute(
      integration_stats_kernel<MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(N, splits);
  integration_stats_kernel<MODE><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float2*>(y), static_cast<const float*>(emb),
      static_cast<const float*>(sal), static_cast<const float*>(eigval),
      static_cast<const float2*>(eigvec), static_cast<const float*>(weight),
      static_cast<const float*>(vec),
      static_cast<const float*>(prec_or_scale),
      static_cast<const float*>(cnst), static_cast<float2*>(scatter),
      static_cast<float*>(asum), static_cast<float*>(res),
      static_cast<float*>(m2), N, D, K, T, E, bins_per_utt, chunk,
      spatial_weight, spectral_weight, affiliation_eps);
  return int(cudaGetLastError());
}

}  // namespace

// Launch one integration statistics pass on `stream` for N bins (utterance
// u = n / bins_per_utt) of T frames in `splits` time chunks of `chunk`
// frames. mode 0 is the vMF, 1 the Gaussian (m2 written only there). sal
// may be null. Returns a cudaError_t (0 on success;
// cudaErrorInvalidValue for an unknown mode); neither synchronizes nor
// allocates.
extern "C" int integration_stats_launch(
    const void* y, const void* emb, const void* sal, const void* eigval,
    const void* eigvec, const void* weight, const void* vec,
    const void* prec_or_scale, const void* cnst, void* scatter, void* asum,
    void* res, void* m2, int N, int D, int K, int T, int E, int bins_per_utt,
    int splits, int chunk, int mode, float spatial_weight,
    float spectral_weight, float affiliation_eps, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (mode == integration::kVmf)
    return launch<integration::kVmf>(
        y, emb, sal, eigval, eigvec, weight, vec, prec_or_scale, cnst,
        scatter, asum, res, m2, N, D, K, T, E, bins_per_utt, splits, chunk,
        spatial_weight, spectral_weight, affiliation_eps, s);
  if (mode == integration::kGaussian)
    return launch<integration::kGaussian>(
        y, emb, sal, eigval, eigvec, weight, vec, prec_or_scale, cnst,
        scatter, asum, res, m2, N, D, K, T, E, bins_per_utt, splits, chunk,
        spatial_weight, spectral_weight, affiliation_eps, s);
  return int(cudaErrorInvalidValue);
}
