// Streamed cACGMM EM statistics: one pass of E-step + M-step sums over
// a long signal, for signals too long for the whole-fit kernel.
//
// Replaces pb_bss_tpu/ops/pallas_em_stream.py:_e_stats_stream_kernel as
// launched by cacgmm_em_long (the Pallas TPU kernel). The TPU walked a
// sequential grid of (frequency tile, time block) and carried the sums
// from one time block to the next in VMEM. On the H100 the CTAs run in
// parallel with nothing carried between them, so the time axis is split
// twice:
//
//   grid (bins N, splits S): CTA (n, s) owns bin n and the frames
//   [s * chunk, min(T, (s + 1) * chunk)); it walks them in tiles of
//   kTile frames held in shared memory and writes its own partial sums.
//   The wrapper adds the S partials in a fixed order (a deterministic
//   two-pass reduction, no float atomics), so runs repeat bit for bit.
//   The split lets a single utterance (257 bins on 132 SMs) fill the
//   card.
//
// Per tile:
//   E-step   a thread per frame. model mode: quadratic form through the
//            inverse covariance V diag(1/l) V^H (assembled once per
//            (bin, class) in the CTA's preamble, not per frame),
//            max(qf, tiny), log-pdf, max-shift softmax with the mixture
//            weight, the source-activity mask on the numerators,
//            max(den, tiny), the clip to [eps, 1 - eps]. from_init mode:
//            the given affiliations and quadratic forms as they are.
//            Then saliency multiplies the affiliations, and
//            w = aff / max(qf, 10 tiny).
//   sums     a warp per (class, upper-triangle entry), lanes over the
//            tile's frames, shuffle reduction, added into the CTA's
//            shared accumulator by the one warp that owns it; and the
//            affiliation sum per class the same way.
//
// What bounds it on the H100: y is read once per pass (185 MB for four
// 60 s recordings at D=6, ~55 us at 3.35 TB/s), and each frame costs
// K D(D+1)/2 complex multiply-adds from shared memory for the sums plus
// K quadratic forms, a log and an exp for the E-step. The design reads y
// from device memory exactly once, coalesced along time, and keeps the
// per-frame posteriors in shared memory only. Measured at that shape on
// an H100 80GB HBM3 (700 W): ~0.45 ms per pass, so the shared-memory
// sums and their per-tile warp reductions bound it, not the bytes.
//
// There is no padding: loops run over the real frames of each chunk, so
// no padded frame can feed 0 * inf into a sum.
//
// Layouts (all contiguous): y (N, D, T) complex64 as float2;
// aff0/qf0/mask (N, K, T) float; sal (N, T) float; eigval (N, K, D);
// eigvec (N, K, D, D) complex64, eigenvectors in columns; weight (N, K);
// scatter (S, N, K, D, D) complex64, the full Hermitian partial sums;
// asum (S, N, K).
#include <cfloat>
#include <cmath>
#include <cuda_runtime.h>

#include "em_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 512;  // frames per shared-memory tile

inline size_t stream_smem_bytes(int D, int K) {
  const size_t P = size_t(D) * (D + 1) / 2;
  return sizeof(float2) * (size_t(D) * kTile + size_t(K) * D * D + K * P) +
         sizeof(float) * (2 * size_t(K) * kTile + 3 * size_t(K));
}

__global__ void __launch_bounds__(kThreads)
em_stream_kernel(const float2* __restrict__ y,
                 const float* __restrict__ aff0,
                 const float* __restrict__ qf0,
                 const float* __restrict__ eigval,
                 const float2* __restrict__ eigvec,
                 const float* __restrict__ weight,
                 const float* __restrict__ sal,
                 const float* __restrict__ mask,
                 float2* __restrict__ scatter_out,
                 float* __restrict__ asum_out, int N, int D, int K, int T,
                 int chunk, float affiliation_eps) {
  extern __shared__ float4 smem_raw[];
  const int DD = D * D;
  const int P = D * (D + 1) / 2;  // upper-triangle entries per class
  float2* ys = reinterpret_cast<float2*>(smem_raw);  // D * kTile
  float2* Ci = ys + size_t(D) * kTile;               // K * DD
  float2* S = Ci + K * DD;                           // K * P
  float* wq = reinterpret_cast<float*>(S + K * P);   // K * kTile
  float* aff = wq + size_t(K) * kTile;               // K * kTile
  float* asum = aff + size_t(K) * kTile;             // K
  float* logdet = asum + K;                          // K
  float* wgt = logdet + K;                           // K

  const bool from_init = aff0 != nullptr;
  const size_t n = blockIdx.x;
  const int split = blockIdx.y;
  const int t_begin = split * chunk;
  const int t_end = min(T, t_begin + chunk);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nwarps = blockDim.x >> 5;
  const float tiny = FLT_MIN;

  for (int i = tid; i < K * P; i += blockDim.x) S[i] = make_float2(0.f, 0.f);
  for (int k = tid; k < K; k += blockDim.x) asum[k] = 0.f;
  if (!from_init) {
    // inverse covariance V diag(1/l) V^H and log-determinant, once per
    // (bin, class)
    for (int k = warp; k < K; k += nwarps) {
      const float* lk = eigval + (n * K + k) * D;
      warp_inverse_covariance(eigvec + (n * K + k) * DD,
                              [&](int i) { return 1.f / lk[i]; },
                              Ci + k * DD, D);
      if (lane == 0) {
        float ld = 0.f;
        for (int i = 0; i < D; ++i) ld += logf(lk[i]);
        logdet[k] = ld;
        wgt[k] = weight[n * K + k];
      }
    }
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

    // ---- E-step: aff <- posterior, wq <- quadratic form -------------
    for (int t = tid; t < nt; t += blockDim.x) {
      const size_t g = size_t(t0) + t;
      if (from_init) {
        for (int k = 0; k < K; ++k) {
          aff[k * kTile + t] = aff0[(n * K + k) * T + g];
          wq[k * kTile + t] = qf0[(n * K + k) * T + g];
        }
      } else {
        e_step_frame([&](int d) { return ys[d * kTile + t]; }, Ci, logdet,
                     wgt, mask == nullptr ? nullptr : mask + n * K * T + g,
                     T, affiliation_eps, aff + t, wq + t, kTile, D, K);
      }
      const float s = (sal != nullptr) ? sal[n * T + g] : 1.f;
      for (int k = 0; k < K; ++k) {
        const float a = aff[k * kTile + t] * s;
        aff[k * kTile + t] = a;
        wq[k * kTile + t] = a / fmaxf(wq[k * kTile + t], 10.f * tiny);
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
                                              wq + k * kTile, nt);
      if (lane == 0) {
        S[k * P + r].x += v.x;
        S[k * P + r].y += v.y;
      }
    }
    __syncthreads();
  }

  // ---- this split's partial sums, written as full Hermitian matrices
  float2* out = scatter_out + (size_t(split) * N + n) * K * DD;
  for (int i = tid; i < K * DD; i += blockDim.x) {
    const int k = i / DD;
    const int d = (i % DD) / D;
    const int e = i % D;
    const int lo = min(d, e);
    const int hi = max(d, e);
    const float2 v = S[k * P + lo * D - lo * (lo - 1) / 2 + hi - lo];
    out[i] = (d == e) ? make_float2(v.x, 0.f)
                      : (d < e ? v : c_conj(v));
  }
  for (int k = tid; k < K; k += blockDim.x)
    asum_out[(size_t(split) * N + n) * K + k] = asum[k];
}

}  // namespace

// Launch one statistics pass on `stream` for N bins of T frames in
// `splits` time chunks of `chunk` frames. from_init mode when aff0 is
// non-null (then qf0 too; eigval/eigvec/weight unused), model mode
// otherwise. sal and mask may be null. Returns a cudaError_t (0 on
// success); neither synchronizes nor allocates.
extern "C" int em_stream_launch(
    const void* y, const void* aff0, const void* qf0, const void* eigval,
    const void* eigvec, const void* weight, const void* sal,
    const void* mask, void* scatter, void* asum, int N, int D, int K, int T,
    int splits, int chunk, float affiliation_eps, void* stream) {
  const size_t bytes = stream_smem_bytes(D, K);
  cudaError_t err = cudaFuncSetAttribute(
      em_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(bytes));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(N, splits);
  em_stream_kernel<<<grid, kThreads, bytes,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(y), static_cast<const float*>(aff0),
      static_cast<const float*>(qf0), static_cast<const float*>(eigval),
      static_cast<const float2*>(eigvec), static_cast<const float*>(weight),
      static_cast<const float*>(sal), static_cast<const float*>(mask),
      static_cast<float2*>(scatter), static_cast<float*>(asum), N, D, K, T,
      chunk, affiliation_eps);
  return int(cudaGetLastError());
}
