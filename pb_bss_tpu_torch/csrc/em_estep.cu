// The opt-in cACGMM E-step kernels: the E-step posterior alone, and the
// E-step folded into the M-step scatter.
//
// Replaces pb_bss_tpu/ops/pallas_em.py: cacgmm_e_step (_e_step_kernel)
// and cacgmm_em_scatter (_em_iteration_kernel), the Pallas TPU kernels
// behind CACGMMTrainer.fit(use_pallas_em=True). On the TPU one grid step
// held a whole bin (D x T planes) in VMEM and computed z = V^H y with
// two real matrix products per plane. Here the quadratic form is the
// projection on the scaled eigenbasis W = V diag(sqrt(1/l)), built once
// per (bin, class) in shared memory, q = sum_i |(W^H y)_i|^2, as in the
// other cACGMM kernels (em_common.cuh); the JAX kernels' assembled
// inverse V diag(1/l) V^H cancels once an eigenvalue sits at the floor.
//
//   em_e_step_kernel: grid (bins F, frame blocks of kThreads), a thread
//     per frame reads its D entries from the y planes (coalesced along
//     time), runs the E-step (max(q, tiny), -D log q - logdet, max-shift
//     softmax with the linear weights, max(den, tiny); no clip) and
//     writes the (K, T) posterior and quadratic form.
//   em_scatter_kernel: a CTA per bin walks T in shared-memory tiles of
//     kTile frames (any T, as the streamed kernel em_stream.cu does): the
//     same E-step into shared memory, m = a / q, then the K D(D+1)/2
//     sums of m y y^H (a warp per sum, lanes over the tile) and the
//     affiliation sums, added into shared accumulators; finally
//     S = D sum written as full Hermitian re/im planes.
//
// What bounds it on the H100: y is read once per call (the scatter at
// F=257, T=304, D=6 reads 3.7 MB), so both kernels are latency-bound at
// the sizes the trainer gives them; the design keeps everything but y
// and the outputs in shared memory and reads y coalesced.
//
// Layouts (all contiguous float): y_re/y_im (F, D, T); v_re/v_im
// (F, K, D, D), eigenvectors in columns; inv_lam (F, K, D); logdet and
// weight (F, K); aff/qf (F, K, T); s_re/s_im (F, K, D, D); asum (F, K).
#include <cfloat>
#include <cmath>
#include <cuda_runtime.h>

#include "em_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 512;  // frames per shared-memory tile (scatter)

// Scaled eigenbases, log-determinants and weights of bin f into shared
// memory (V staged as complex in Vs first); then a __syncthreads().
__device__ void load_model(const float* __restrict__ v_re,
                           const float* __restrict__ v_im,
                           const float* __restrict__ inv_lam,
                           const float* __restrict__ logdet_in,
                           const float* __restrict__ weight, size_t f,
                           float2* Vs, float2* Wh, float* logdet, float* wgt,
                           int D, int K) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nwarps = blockDim.x >> 5;
  const int DD = D * D;
  for (int i = tid; i < K * DD; i += blockDim.x)
    Vs[i] = make_float2(v_re[f * K * DD + i], v_im[f * K * DD + i]);
  for (int k = tid; k < K; k += blockDim.x) {
    logdet[k] = logdet_in[f * K + k];
    wgt[k] = weight[f * K + k];
  }
  __syncthreads();
  for (int k = warp; k < K; k += nwarps) {
    const float* ik = inv_lam + (f * K + k) * D;
    warp_scaled_basis(Vs + k * DD, [&](int i) { return sqrtf(ik[i]); },
                      Wh + k * DD, D);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
em_e_step_kernel(const float* __restrict__ y_re,
                 const float* __restrict__ y_im,
                 const float* __restrict__ v_re,
                 const float* __restrict__ v_im,
                 const float* __restrict__ inv_lam,
                 const float* __restrict__ logdet_in,
                 const float* __restrict__ weight,
                 float* __restrict__ aff_out, float* __restrict__ qf_out,
                 int D, int K, int T) {
  extern __shared__ float4 smem_raw[];
  const int DD = D * D;
  float2* Vs = reinterpret_cast<float2*>(smem_raw);  // K * DD
  float2* Wh = Vs + K * DD;                          // K * DD
  float* aff = reinterpret_cast<float*>(Wh + K * DD);  // K * kThreads
  float* qf = aff + K * kThreads;                      // K * kThreads
  float* logdet = qf + K * kThreads;                   // K
  float* wgt = logdet + K;                             // K

  const size_t f = blockIdx.x;
  load_model(v_re, v_im, inv_lam, logdet_in, weight, f, Vs, Wh, logdet, wgt,
             D, K);
  const int tl = threadIdx.x;
  const int t = blockIdx.y * kThreads + tl;
  if (t >= T) return;
  const float* yr = y_re + f * D * T + t;
  const float* yi = y_im + f * D * T + t;
  e_step_frame(
      [&](int k) {
        return projection_form(
            [&](int d) { return make_float2(yr[d * T], yi[d * T]); },
            Wh + k * DD, D);
      },
      logdet, wgt, nullptr, 0, 0.f, aff + tl, qf + tl, kThreads, D, K);
  for (int k = 0; k < K; ++k) {
    aff_out[(f * K + k) * T + t] = aff[k * kThreads + tl];
    qf_out[(f * K + k) * T + t] = qf[k * kThreads + tl];
  }
}

__global__ void __launch_bounds__(kThreads)
em_scatter_kernel(const float* __restrict__ y_re,
                  const float* __restrict__ y_im,
                  const float* __restrict__ v_re,
                  const float* __restrict__ v_im,
                  const float* __restrict__ inv_lam,
                  const float* __restrict__ logdet_in,
                  const float* __restrict__ weight,
                  float* __restrict__ s_re, float* __restrict__ s_im,
                  float* __restrict__ asum_out, int D, int K, int T) {
  extern __shared__ float4 smem_raw[];
  const int DD = D * D;
  const int P = D * (D + 1) / 2;
  float2* ys = reinterpret_cast<float2*>(smem_raw);  // D * kTile
  float2* Vs = ys + size_t(D) * kTile;               // K * DD
  float2* Wh = Vs + K * DD;                          // K * DD
  float2* S = Wh + K * DD;                           // K * P
  float* aff = reinterpret_cast<float*>(S + K * P);  // K * kTile
  float* wq = aff + size_t(K) * kTile;   // K * kTile q, then m = a / q
  float* asum = wq + size_t(K) * kTile;  // K
  float* logdet = asum + K;              // K
  float* wgt = logdet + K;               // K

  const size_t f = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nwarps = blockDim.x >> 5;

  for (int i = tid; i < K * P; i += blockDim.x) S[i] = make_float2(0.f, 0.f);
  for (int k = tid; k < K; k += blockDim.x) asum[k] = 0.f;
  load_model(v_re, v_im, inv_lam, logdet_in, weight, f, Vs, Wh, logdet, wgt,
             D, K);

  for (int t0 = 0; t0 < T; t0 += kTile) {
    const int nt = min(kTile, T - t0);
    for (int i = tid; i < D * nt; i += blockDim.x) {
      const int d = i / nt;
      const int t = i - d * nt;
      const size_t g = (f * D + d) * T + t0 + t;
      ys[d * kTile + t] = make_float2(y_re[g], y_im[g]);
    }
    __syncthreads();

    for (int t = tid; t < nt; t += blockDim.x) {
      e_step_frame(
          [&](int k) {
            return projection_form([&](int d) { return ys[d * kTile + t]; },
                                   Wh + k * DD, D);
          },
          logdet, wgt, nullptr, 0, 0.f, aff + t, wq + t, kTile, D, K);
      for (int k = 0; k < K; ++k)
        wq[k * kTile + t] = aff[k * kTile + t] / wq[k * kTile + t];
    }
    __syncthreads();

    // a warp per (class, entry); entry P is the affiliation sum
    for (int item = warp; item < K * (P + 1); item += nwarps) {
      const int k = item / (P + 1);
      const int r = item % (P + 1);
      if (r == P) {
        const float acc = warp_frame_sum(aff + k * kTile, nt);
        if (lane == 0) asum[k] += acc;
        continue;
      }
      int d, e;
      upper_entry(r, D, &d, &e);
      const float2 v = warp_weighted_pair_sum(ys + d * kTile, ys + e * kTile,
                                              wq + k * kTile, nt);
      if (lane == 0) {
        S[k * P + r].x += v.x;
        S[k * P + r].y += v.y;
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < K * DD; i += blockDim.x) {
    const int k = i / DD;
    const int d = (i % DD) / D;
    const int e = i % D;
    const int lo = min(d, e);
    const int hi = max(d, e);
    const float2 v = S[k * P + lo * D - lo * (lo - 1) / 2 + hi - lo];
    s_re[f * K * DD + i] = float(D) * v.x;
    s_im[f * K * DD + i] = (d == e) ? 0.f : float(D) * (d < e ? v.y : -v.y);
  }
  for (int k = tid; k < K; k += blockDim.x) asum_out[f * K + k] = asum[k];
}

}  // namespace

// Launch the E-step on `stream` for F bins of T frames. Returns a
// cudaError_t (0 on success); neither synchronizes nor allocates.
extern "C" int em_e_step_launch(const void* y_re, const void* y_im,
                                const void* v_re, const void* v_im,
                                const void* inv_lam, const void* logdet,
                                const void* weight, void* aff, void* qf,
                                int F, int D, int K, int T, void* stream) {
  const size_t bytes = sizeof(float2) * 2 * size_t(K) * D * D +
                       sizeof(float) * (2 * size_t(K) * kThreads + 2 * K);
  cudaError_t err = cudaFuncSetAttribute(
      em_e_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(bytes));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(F, (T + kThreads - 1) / kThreads);
  em_e_step_kernel<<<grid, kThreads, bytes,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y_re), static_cast<const float*>(y_im),
      static_cast<const float*>(v_re), static_cast<const float*>(v_im),
      static_cast<const float*>(inv_lam), static_cast<const float*>(logdet),
      static_cast<const float*>(weight), static_cast<float*>(aff),
      static_cast<float*>(qf), D, K, T);
  return int(cudaGetLastError());
}

// Launch the E-step + scatter on `stream` for F bins of T frames.
// Returns a cudaError_t (0 on success); neither synchronizes nor
// allocates.
extern "C" int em_scatter_launch(const void* y_re, const void* y_im,
                                 const void* v_re, const void* v_im,
                                 const void* inv_lam, const void* logdet,
                                 const void* weight, void* s_re, void* s_im,
                                 void* asum, int F, int D, int K, int T,
                                 void* stream) {
  const size_t P = size_t(D) * (D + 1) / 2;
  const size_t bytes =
      sizeof(float2) * (size_t(D) * kTile + 2 * size_t(K) * D * D + K * P) +
      sizeof(float) * (2 * size_t(K) * kTile + 3 * K);
  cudaError_t err = cudaFuncSetAttribute(
      em_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(bytes));
  if (err != cudaSuccess) return int(err);
  em_scatter_kernel<<<F, kThreads, bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y_re), static_cast<const float*>(y_im),
      static_cast<const float*>(v_re), static_cast<const float*>(v_im),
      static_cast<const float*>(inv_lam), static_cast<const float*>(logdet),
      static_cast<const float*>(weight), static_cast<float*>(s_re),
      static_cast<float*>(s_im), static_cast<float*>(asum), D, K, T);
  return int(cudaGetLastError());
}
