// Whole-fit integration-model EM (VMFCACGMM / GCACGMM): every EM iteration
// of a fit in ONE cooperative launch (K12).
//
// Replaces pb_bss_tpu/ops/pallas_integration_em_loop.py:integration_em_full
// (the Pallas TPU kernel on a sequential (iteration, frequency tile) grid,
// whose scratch carried the state from one grid step to the next). The
// spectral model is GLOBAL over the bins of an utterance, so each
// iteration's M-step reduces over all of them: on the H100 that needs a
// grid-wide step, which a one-CTA-per-bin launch (em_loop.cu) has not.
// This kernel is persistent and cooperative (cudaLaunchCooperativeKernel,
// cooperative_groups::this_grid().sync()): the grid is sized to what can
// be co-resident (the occupancy per SM times the SMs, at most one CTA per
// bin), and the CTAs stride over the bins. One iteration:
//
//   per bin  the bin's cACG state (eigenvectors, eigenvalues, weight) and
//            its utterance's spectral state come from device memory; the
//            E-step and the sums walk the frames in tiles
//            (integration.cuh, as the per-iteration kernel K10 does); the
//            spectral rows (resultants, sum_t a, second moments) go to a
//            (N, A) buffer; the M-step of the bin: weight sum_t a /
//            max(sum_k sum_t a, tiny), covariance D S / max(asum, tiny)
//            rotated into the previous eigenbasis and `sweeps` (iteration
//            0) or `warm_sweeps` Jacobi sweeps (jacobi.cuh), the
//            eigenvalues max-normalized and floored; the state goes back
//            to device memory;
//   sync     grid.sync();
//   spectral the CTA u (striding over utterances) adds the rows of its
//            utterance's bins in a fixed order (a warp per strided subset
//            of bins, then the warps in order), writes them as the
//            iteration's accumulator and, unless the iteration is the
//            last, runs the closed-form spectral M-step: Banerjee's vMF
//            (log C interpolated in a sqrt-spaced table, two loads) or
//            the Gaussian moment match; then grid.sync() again.
//
// One CTA per utterance does the spectral step, with a second sync, rather
// than every CTA redundantly: a CTA's bins span every utterance of a batch,
// so the redundant variant would read the whole (N, A) buffer in every CTA
// (1 MB at B=8) each iteration.
//
// What bounds it on the H100: each iteration re-reads y and the embedding
// (20 MB at F=513, T=300, D=6, E=20; L2 holds them at one utterance) and
// runs the E-step's ~1 kFLOP a frame, as K10 does, plus the serial part:
// a warp's Jacobi per class and two grid-wide syncs. A launch that cannot
// be co-resident fails with cudaErrorCooperativeLaunchTooLarge, which the
// wrapper raises.
//
// Layouts (all contiguous): y (N, D, T) complex64 as float2; emb (N, E, T);
// state, updated in place: vec (N, K, D, D) complex64, eigenvectors in
// columns; eig (N, K, D) unsorted; weight (N, K); spectral state of
// utterance u = n / bins_per_utt, updated in place: svec (U, K, E), sb
// (U, K, E) Gaussian precisions or (U, K) vMF concentrations, sc (U, K);
// rows (N, A) scratch; acc (U, A); A = K E (resultants, class-major) + K
// (sum_t a) [+ K E second moments, Gaussian]; table (table_size) the vMF
// log normalizer at kappa = (s0 + g ds)^2. The state is written by one
// CTA and read by others across grid syncs, so its pointers carry no
// __restrict__ (no non-coherent read-only loads).
#include <cfloat>
#include <cmath>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "integration.cuh"

namespace cg = cooperative_groups;

namespace {

using integration::kThreads;
using integration::kTile;
constexpr int kWarps = kThreads / 32;
constexpr float kLog2Pi = 1.8378770664093453f;  // log(2 pi)

__host__ __device__ inline int acc_rows(int K, int E, int mode) {
  return K * E + K + (mode == integration::kGaussian ? K * E : 0);
}

inline size_t loop_smem_bytes(int D, int K, int E, int mode) {
  const size_t P = size_t(D) * (D + 1) / 2;
  const size_t A = acc_rows(K, E, mode);
  return sizeof(float2) * (size_t(D) * kTile + 3 * size_t(K) * D * D +
                           K * P) +
         sizeof(float) * (size_t(E) * kTile + 2 * size_t(K) * kTile +
                          4 * size_t(K) * E + 5 * size_t(K) +
                          2 * size_t(K) * D + (kWarps + 1) * A);
}

// The closed-form spectral M-step of one utterance from its accumulator
// row `a` (A floats in shared memory), a thread per class, into the
// spectral state of u in device memory.
template <int MODE>
__device__ void spectral_m_step(const float* a, size_t u, float* svec,
                                float* sb, float* sc, const float* table,
                                int table_size, float s0, float ds,
                                float min_concentration,
                                float max_concentration, bool spherical,
                                int K, int E) {
  const float tiny = FLT_MIN;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const float* r = a + k * E;
    const float n = a[K * E + k];
    float* vk = svec + (u * K + k) * E;
    if (MODE == integration::kVmf) {
      // [Banerjee2005] Equations 2.4, 2.5 and 4.4
      float norm2 = 0.f;
      for (int e = 0; e < E; ++e) norm2 += r[e] * r[e];
      const float norm = sqrtf(norm2);
      const float inv = 1.f / fmaxf(norm, tiny);
      for (int e = 0; e < E; ++e) vk[e] = r[e] * inv;
      const float rb = norm / fmaxf(n, tiny);
      const float kappa = fminf(
          fmaxf((rb * float(E) - rb * rb * rb) / (1.f - rb * rb),
                min_concentration),
          max_concentration);
      const float idx =
          fminf(fmaxf((sqrtf(kappa) - s0) / ds, 0.f), float(table_size - 1));
      const int lo = min(int(floorf(idx)), table_size - 2);
      const float w = idx - float(lo);
      sb[u * K + k] = kappa;
      sc[u * K + k] = table[lo] * (1.f - w) + table[lo + 1] * w;
    } else {
      // moment matching: mean r / n, centered second moment floored
      const float* m2 = a + K * E + K + k * E;
      const float den = fmaxf(n, tiny);
      float* pk = sb + (u * K + k) * E;
      float cov = 0.f, ldpc = 0.f;
      for (int e = 0; e < E; ++e) {
        const float m = r[e] / den;
        const float c = fmaxf(m2[e] / den - m * m, tiny);
        cov += c;
        ldpc += logf(c);
        pk[e] = c;  // the centered moment, until the precision below
      }
      if (spherical) {
        cov /= float(E);
        ldpc = -0.5f * float(E) * logf(cov);
      } else {
        ldpc = -0.5f * ldpc;
      }
      float quad = 0.f;
      for (int e = 0; e < E; ++e) {
        const float m = r[e] / den;
        const float p = 1.f / (spherical ? cov : pk[e]);
        pk[e] = p;
        vk[e] = p * m;
        quad += m * m * p;
      }
      sc[u * K + k] = 0.5f * float(E) * kLog2Pi - ldpc + 0.5f * quad;
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
integration_em_loop_kernel(
    const float2* __restrict__ y, const float* __restrict__ emb,
    float2* vec, float* eig, float* weight, float* svec, float* sb, float* sc,
    float* rows, float* acc_out, const float* __restrict__ table, int N,
    int D, int K, int T, int E, int bins_per_utt, int iterations, int sweeps,
    int warm_sweeps, float eigenvalue_floor, float spatial_weight,
    float spectral_weight, float affiliation_eps, float min_concentration,
    float max_concentration, int table_size, float s0, float ds,
    int spherical) {
  extern __shared__ float4 smem_raw[];
  cg::grid_group grid = cg::this_grid();
  const int DD = D * D;
  const int P = D * (D + 1) / 2;
  const int A = acc_rows(K, E, MODE);
  const int U = N / bins_per_utt;
  integration::Tile tile;
  tile.y = reinterpret_cast<float2*>(smem_raw);  // D*kTile
  float2* S = tile.y + size_t(D) * kTile;        // K*DD covariance / eig
  float2* V = S + K * DD;                        // K*DD eigenvectors
  float2* C = V + K * DD;                        // K*DD rotation scratch
  integration::Accum acc;
  acc.scatter = C + K * DD;                                  // K*P
  tile.emb = reinterpret_cast<float*>(acc.scatter + K * P);  // E*kTile
  tile.aff = tile.emb + size_t(E) * kTile;                   // K*kTile
  tile.wq = tile.aff + size_t(K) * kTile;                    // K*kTile
  acc.res = tile.wq + size_t(K) * kTile;                     // K*E
  acc.m2 = acc.res + K * E;                                  // K*E
  integration::Spectral sp;
  sp.vec = acc.m2 + K * E;    // K*E
  sp.prec = sp.vec + K * E;   // K*E
  acc.asum = sp.prec + K * E;  // K
  float* logdet = acc.asum + K;  // K
  float* wgt = logdet + K;       // K
  sp.scale = wgt + K;            // K
  sp.cnst = sp.scale + K;        // K
  float* lam = sp.cnst + K;      // K*D
  float* inv_lam = lam + K * D;  // K*D
  float* part = inv_lam + K * D;  // kWarps*A
  float* accs = part + kWarps * A;  // A

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const float tiny = FLT_MIN;

  for (int it = 0; it < iterations; ++it) {
    for (size_t n = blockIdx.x; n < size_t(N); n += gridDim.x) {
      // ---- the bin's model --------------------------------------------
      integration::zero_accum<MODE>(acc, D, K, E);
      integration::load_spectral<MODE>(svec, sb, sc, n / bins_per_utt, sp,
                                       K, E);
      for (int i = tid; i < K * DD; i += blockDim.x) V[i] = vec[n * K * DD + i];
      for (int i = tid; i < K * D; i += blockDim.x) lam[i] = eig[n * K * D + i];
      __syncthreads();
      integration::load_cacg(lam, weight + n * K, inv_lam, logdet, wgt, D,
                             K);

      // ---- E-step and sums over all frames ----------------------------
      integration::accumulate_frames<MODE>(
          y, emb, nullptr, n, 0, T, T, tile, V, inv_lam, logdet, wgt, sp,
          acc, spatial_weight, spectral_weight, affiliation_eps, D, K, E);

      // ---- the spectral rows of the bin -------------------------------
      float* row = rows + n * A;
      for (int i = tid; i < K * E; i += blockDim.x) {
        row[i] = acc.res[i];
        if (MODE == integration::kGaussian) row[K * E + K + i] = acc.m2[i];
      }
      for (int k = tid; k < K; k += blockDim.x) row[K * E + k] = acc.asum[k];

      // ---- M-step of the bin: weight, covariance, warm Jacobi, floor --
      for (int k = warp; k < K; k += kWarps) {
        float total = 0.f;
        for (int j = 0; j < K; ++j) total += acc.asum[j];
        const float den = fmaxf(acc.asum[k], tiny);
        float2* Sk = S + k * DD;
        for (int i = lane; i < DD; i += 32) {
          const int d = i / D;
          const int e = i % D;
          const int lo = min(d, e);
          const int hi = max(d, e);
          const float2 v =
              acc.scatter[k * P + lo * D - lo * (lo - 1) / 2 + hi - lo];
          const float re = float(D) * v.x / den;
          const float im = float(D) * v.y / den;
          Sk[i] = (d == e) ? make_float2(re, 0.f)
                           : make_float2(re, d < e ? im : -im);
        }
        __syncwarp();
        float2* Vk = V + k * DD;
        warp_warm_rotate(Sk, Vk, C + k * DD, D);
        warp_jacobi(Sk, Vk, D, it == 0 ? sweeps : warm_sweeps);
        warp_floor_eigenvalues(Sk, lam + k * D, D, eigenvalue_floor);
        if (lane == 0) weight[n * K + k] = acc.asum[k] / fmaxf(total, tiny);
        for (int i = lane; i < DD; i += 32) vec[(n * K + k) * DD + i] = Vk[i];
        if (lane < D) eig[(n * K + k) * D + lane] = lam[k * D + lane];
      }
      __syncthreads();
    }

    grid.sync();

    // ---- the spectral step of each utterance ---------------------------
    const int F = bins_per_utt;
    for (size_t u = blockIdx.x; u < size_t(U); u += gridDim.x) {
      for (int r = lane; r < A; r += 32) {
        float s = 0.f;
        for (int f = warp; f < F; f += kWarps) s += rows[(u * F + f) * A + r];
        part[warp * A + r] = s;
      }
      __syncthreads();
      for (int r = tid; r < A; r += blockDim.x) {
        float s = 0.f;
        for (int w = 0; w < kWarps; ++w) s += part[w * A + r];
        accs[r] = s;
        acc_out[u * A + r] = s;
      }
      __syncthreads();
      if (it < iterations - 1)
        spectral_m_step<MODE>(accs, u, svec, sb, sc, table, table_size, s0,
                              ds, min_concentration, max_concentration,
                              spherical != 0, K, E);
      __syncthreads();
    }
    if (it < iterations - 1) grid.sync();
  }
}

template <int MODE>
int occupancy(int D, int K, int E, int* per_sm, int* sms, size_t* bytes) {
  *bytes = loop_smem_bytes(D, K, E, MODE);
  cudaError_t err = cudaFuncSetAttribute(
      integration_em_loop_kernel<MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(*bytes));
  if (err != cudaSuccess) return int(err);
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  int coop = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return int(err);
  if (!coop) return int(cudaErrorNotSupported);
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return int(err);
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, integration_em_loop_kernel<MODE>, kThreads, *bytes));
}

template <int MODE>
int launch(const void* y, const void* emb, void* vec, void* eig,
           void* weight, void* svec, void* sb, void* sc, void* rows,
           void* acc, const void* table, int N, int D, int K, int T, int E,
           int bins_per_utt, int iterations, int sweeps, int warm_sweeps,
           float eigenvalue_floor, float spatial_weight,
           float spectral_weight, float affiliation_eps,
           float min_concentration, float max_concentration, int table_size,
           float s0, float ds, int spherical, int grid_size, int* grid_used,
           cudaStream_t stream) {
  int per_sm = 0, sms = 0;
  size_t bytes = 0;
  int err = occupancy<MODE>(D, K, E, &per_sm, &sms, &bytes);
  if (err) return err;
  if (per_sm < 1) return int(cudaErrorInvalidConfiguration);
  const int grid = grid_size > 0 ? grid_size : min(N, per_sm * sms);
  *grid_used = grid;
  const float2* y_ = static_cast<const float2*>(y);
  const float* emb_ = static_cast<const float*>(emb);
  float2* vec_ = static_cast<float2*>(vec);
  float* eig_ = static_cast<float*>(eig);
  float* weight_ = static_cast<float*>(weight);
  float* svec_ = static_cast<float*>(svec);
  float* sb_ = static_cast<float*>(sb);
  float* sc_ = static_cast<float*>(sc);
  float* rows_ = static_cast<float*>(rows);
  float* acc_ = static_cast<float*>(acc);
  const float* table_ = static_cast<const float*>(table);
  void* args[] = {
      &y_, &emb_, &vec_, &eig_, &weight_, &svec_, &sb_, &sc_, &rows_, &acc_,
      &table_, &N, &D, &K, &T, &E, &bins_per_utt, &iterations, &sweeps,
      &warm_sweeps, &eigenvalue_floor, &spatial_weight, &spectral_weight,
      &affiliation_eps, &min_concentration, &max_concentration, &table_size,
      &s0, &ds, &spherical};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(integration_em_loop_kernel<MODE>), dim3(grid),
      dim3(kThreads), args, bytes, stream);
  if (e != cudaSuccess) return int(e);
  return int(cudaGetLastError());
}

}  // namespace

// Launch the whole-fit integration EM on `stream`: `iterations` E + M
// steps for N bins (utterance u = n / bins_per_utt), the state updated in
// place. grid_size 0 sizes the grid to min(N, co-resident CTAs); another
// value is launched as given (a grid that cannot be co-resident fails with
// cudaErrorCooperativeLaunchTooLarge). The grid launched is written to
// *grid_used. Returns a cudaError_t (0 on success); neither synchronizes
// nor allocates.
extern "C" int integration_em_loop_launch(
    const void* y, const void* emb, void* vec, void* eig, void* weight,
    void* svec, void* sb, void* sc, void* rows, void* acc, const void* table,
    int N, int D, int K, int T, int E, int bins_per_utt, int iterations,
    int sweeps, int warm_sweeps, int mode, float eigenvalue_floor,
    float spatial_weight, float spectral_weight, float affiliation_eps,
    float min_concentration, float max_concentration, int table_size,
    float s0, float ds, int spherical, int grid_size, int* grid_used,
    void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
#define LOOP_LAUNCH(MODE)                                                    \
  return launch<MODE>(y, emb, vec, eig, weight, svec, sb, sc, rows, acc,     \
                      table, N, D, K, T, E, bins_per_utt, iterations,        \
                      sweeps, warm_sweeps, eigenvalue_floor, spatial_weight, \
                      spectral_weight, affiliation_eps, min_concentration,   \
                      max_concentration, table_size, s0, ds, spherical,      \
                      grid_size, grid_used, s)
  if (mode == integration::kVmf) LOOP_LAUNCH(integration::kVmf);
  if (mode == integration::kGaussian) LOOP_LAUNCH(integration::kGaussian);
#undef LOOP_LAUNCH
  return int(cudaErrorInvalidValue);
}
