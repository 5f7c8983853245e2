// Streamed mixture statistics: one pass of E-step + M-step sums over a
// long signal, for the complex Watson and complex Bingham fits the
// whole-fit kernels (cwmm_loop.cu, cbmm_loop.cu) do not take:
// frequency-constant weights at any T, and per-bin weights past their
// gates.
//
// Replaces pb_bss_tpu/ops/pallas_mm_stream.py:_stream_machinery /
// _mm_stats_stream_kernel as launched by cwmm_em_long and cbmm_em_long
// (the Pallas TPU kernel, both families). The TPU walked a sequential grid
// of (frequency tile, time block), carried the sums from block to block in
// VMEM and shrank the from-init time block to fit VMEM. Here, as in the
// streamed cACGMM kernel (em_stream.cu), the time axis is split twice:
//
//   grid (bins N, splits S): CTA (n, s) owns bin n and the frames
//   [s * chunk, min(T, (s + 1) * chunk)); it walks them in tiles of
//   kTile frames held in shared memory and writes its own partial sums.
//   The wrapper adds the S partials in a fixed order (no float atomics),
//   so runs repeat bit for bit.
//
// Per tile:
//   E-step   a thread per frame. Watson step mode: kappa |<y, m>|^2 -
//            log Z per class (watson.cuh); Bingham step mode:
//            y^H V diag(lambda) V^H y - log c per class, with the
//            Hermitian forms B_k = V diag(lambda) V^H built once per CTA
//            (bingham.cuh), and the clip to [eps, 1 - eps] when eps != 0.
//            Both: max-shift softmax with the mixture weight (per bin, or
//            frequency-constant: the weight of bin n is
//            weight[n / bins_per_weight]), max(den, tiny). From-init mode:
//            the given affiliations. Then saliency multiplies them.
//   sums     a warp per (class, upper-triangle entry), lanes over the
//            tile's frames, shuffle reduction, added into the CTA's
//            shared accumulator by the one warp that owns it; and the
//            affiliation sum per class the same way.
//
// Output: the upper triangle of each class's scatter sum_t a y y^H (row
// by row, real diagonal) and the affiliation sums; the wrapper mirrors
// the triangle, and the M-step finish (normalization, eigh, and the
// concentration table or the Bingham moment inversion, weight) runs in
// PyTorch.
//
// What bounds it on the H100: y is read once per pass (98.5 MB at one
// T=4000 recording of 513 bins, D=6; ~29 us at 3.35 TB/s), and each frame
// costs K D(D+1)/2 complex multiply-adds from shared memory for the sums
// plus, for the E-step, K rank-1 forms (Watson) or K full quadratic forms
// over the upper triangle (Bingham), a log-density and an exp. The design
// reads y from device memory once, coalesced along time, keeps the
// posteriors in shared memory only, and splits T so that even one
// utterance fills the card.
//
// There is no padding: loops run over the real frames of each chunk.
//
// Layouts (all contiguous): y (N, D, T) complex64 as float2; aff0
// (N, K, T); sal (N, T); mode (N, K, D) complex64; kappa (N, K); vec
// (N, K, D, D) complex64 (eigenvectors in columns); lam (N, K, D); logz
// (N, K) (log Z or log c); weight (N / bins_per_weight, K); upper
// (S, N, K, D(D+1)/2) complex64; asum (S, N, K).
#include <cfloat>
#include <cmath>
#include <cuda_runtime.h>

#include "em_common.cuh"
#include "bingham.cuh"
#include "watson.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 512;  // frames per shared-memory tile

// Bingham step mode adds the K Hermitian forms B_k (D x D complex each).
inline size_t mm_smem_bytes(int D, int K, bool bingham) {
  const size_t P = size_t(D) * (D + 1) / 2;
  return sizeof(float2) * (size_t(D) * kTile + K * P + size_t(K) * D +
                           (bingham ? size_t(K) * D * D : 0)) +
         sizeof(float) * (size_t(K) * kTile + 4 * size_t(K));
}

__global__ void __launch_bounds__(kThreads)
mm_stream_kernel(const float2* __restrict__ y,
                 const float* __restrict__ aff0,
                 const float2* __restrict__ mode_in,
                 const float* __restrict__ kappa_in,
                 const float* __restrict__ logz_in,
                 const float* __restrict__ weight,
                 const float* __restrict__ sal,
                 const float2* __restrict__ vec_in,
                 const float* __restrict__ lam_in,
                 float2* __restrict__ upper_out,
                 float* __restrict__ asum_out, int N, int D, int K, int T,
                 int chunk, int bins_per_weight, float eps) {
  extern __shared__ float4 smem_raw[];
  const int P = D * (D + 1) / 2;  // upper-triangle entries per class
  float2* ys = reinterpret_cast<float2*>(smem_raw);  // D * kTile
  float2* S = ys + size_t(D) * kTile;                // K * P
  float2* mode = S + K * P;                          // K * D
  float* aff = reinterpret_cast<float*>(mode + K * D);  // K * kTile
  float* asum = aff + size_t(K) * kTile;             // K
  float* kappa = asum + K;                           // K
  float* logz = kappa + K;                           // K
  float* wgt = logz + K;                             // K
  float2* Bm = reinterpret_cast<float2*>(wgt + K);   // K*D*D (Bingham)

  const bool from_init = aff0 != nullptr;
  const bool bingham = !from_init && vec_in != nullptr;
  const size_t n = blockIdx.x;
  const int split = blockIdx.y;
  const int t_begin = split * chunk;
  const int t_end = min(T, t_begin + chunk);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nwarps = blockDim.x >> 5;

  for (int i = tid; i < K * P; i += blockDim.x) S[i] = make_float2(0.f, 0.f);
  for (int k = tid; k < K; k += blockDim.x) {
    asum[k] = 0.f;
    if (!from_init) {
      if (!bingham) kappa[k] = kappa_in[n * K + k];
      logz[k] = logz_in[n * K + k];
      wgt[k] = weight[(n / bins_per_weight) * K + k];
    }
  }
  if (bingham) {
    const int DD = D * D;
    for (int k = warp; k < K; k += nwarps)
      warp_bingham_form(vec_in + (n * K + k) * DD, lam_in + (n * K + k) * D,
                        Bm + k * DD, D);
  } else if (!from_init) {
    for (int i = tid; i < K * D; i += blockDim.x)
      mode[i] = mode_in[n * K * D + i];
  }
  __syncthreads();

  for (int t0 = t_begin; t0 < t_end; t0 += kTile) {
    const int nt = min(kTile, t_end - t0);
    for (int i = tid; i < D * nt; i += blockDim.x) {
      const int d = i / nt;
      const int t = i - d * nt;
      ys[d * kTile + t] = y[(n * D + d) * T + t0 + t];
    }
    __syncthreads();

    // ---- E-step (or the given affiliations), then saliency ----------
    for (int t = tid; t < nt; t += blockDim.x) {
      const size_t g = size_t(t0) + t;
      if (from_init) {
        for (int k = 0; k < K; ++k)
          aff[k * kTile + t] = aff0[(n * K + k) * T + g];
      } else if (bingham) {
        bingham_e_step_frame([&](int d) { return ys[d * kTile + t]; }, Bm,
                             logz, wgt, eps, aff + t, kTile, D, K);
      } else {
        watson_e_step_frame([&](int d) { return ys[d * kTile + t]; }, mode,
                            kappa, logz, wgt, aff + t, kTile, D, K);
      }
      if (sal != nullptr) {
        const float s = sal[n * T + g];
        for (int k = 0; k < K; ++k) aff[k * kTile + t] *= s;
      }
    }
    __syncthreads();

    // ---- sums: a warp per (class, entry); entry P is the affiliation
    // sum -------------------------------------------------------------
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
                                              aff + k * kTile, nt);
      if (lane == 0) {
        S[k * P + r].x += v.x;
        S[k * P + r].y += v.y;
      }
    }
    __syncthreads();
  }

  // ---- this split's partial sums: the upper triangle, real diagonal --
  float2* out = upper_out + (size_t(split) * N + n) * K * P;
  for (int i = tid; i < K * P; i += blockDim.x) {
    int d, e;
    upper_entry(i % P, D, &d, &e);
    out[i] = (d == e) ? make_float2(S[i].x, 0.f) : S[i];
  }
  for (int k = tid; k < K; k += blockDim.x)
    asum_out[(size_t(split) * N + n) * K + k] = asum[k];
}

}  // namespace

// Launch one statistics pass on `stream` for N bins of T frames in
// `splits` time chunks of `chunk` frames. From-init mode when aff0 is
// non-null (the model pointers unused); otherwise Bingham step mode when
// vec is non-null (vec, lam, logz = log c, weight, eps; mode and kappa
// unused), else Watson step mode (mode, kappa, logz, weight). sal may be
// null. Returns a cudaError_t (0 on success); neither synchronizes nor
// allocates.
extern "C" int mm_stream_launch(const void* y, const void* aff0,
                                const void* mode, const void* kappa,
                                const void* logz, const void* weight,
                                const void* sal, const void* vec,
                                const void* lam, void* upper, void* asum,
                                int N, int D, int K, int T, int splits,
                                int chunk, int bins_per_weight, float eps,
                                void* stream) {
  const size_t bytes =
      mm_smem_bytes(D, K, aff0 == nullptr && vec != nullptr);
  cudaError_t err = cudaFuncSetAttribute(
      mm_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(bytes));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(N, splits);
  mm_stream_kernel<<<grid, kThreads, bytes,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(y), static_cast<const float*>(aff0),
      static_cast<const float2*>(mode), static_cast<const float*>(kappa),
      static_cast<const float*>(logz), static_cast<const float*>(weight),
      static_cast<const float*>(sal), static_cast<const float2*>(vec),
      static_cast<const float*>(lam), static_cast<float2*>(upper),
      static_cast<float*>(asum), N, D, K, T, chunk, bins_per_weight, eps);
  return int(cudaGetLastError());
}
