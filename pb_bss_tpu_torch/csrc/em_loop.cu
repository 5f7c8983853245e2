// Whole-fit cACGMM EM: every EM iteration of a fit in ONE launch.
//
// Replaces pb_bss_tpu/ops/pallas_em_loop.py:cacgmm_em_full (the Pallas
// TPU kernel). Frequency bins are independent, so one CTA owns one
// (utterance, bin) and runs all iterations for it, with y, the scatter
// weights and the model of the bin in shared memory. Per iteration:
//
//   M-step  lanes over the upper-triangle entries (and one more lane for
//           the affiliation sum), warps over groups of G frames
//           (scatter_frames): lane j reads its group's frames of rows d
//           and e of y and each class's weights in 16-byte loads and adds
//           w_k y_d conj(y_e) into registers for a class group sized to K;
//           then one cross-warp reduction, warp by warp in a fixed order
//           (scatter_sums_grouped; at D <= 3, G = 1: scatter_sums), and
//           the covariance
//           D sum / max(asum, tiny) (a division, never the sum times
//           D / max(asum, tiny): at D >= 5 that factor overflows when a
//           class's sum is 0 in a real bin, and 0 * inf would poison the
//           scatter) and the mixture weight (the mean over T, or with
//           saliency the sums L1-normalized over classes).
//   eigh    the parallel (round-robin) complex Jacobi in registers: a lane
//           owns one column of A and of V of one class, floor(32 / D)
//           classes to a warp. A sweep is D - 1 steps of D / 2 disjoint
//           rotations (the cyclic order the JAX package and the plain twin
//           take runs D (D - 1) / 2 rotations one after another); the
//           column exchange is a shuffle. Cold at `sweeps` in iteration 0,
//           then warm-started from the previous eigenbasis (A = V^H S V
//           by the column lanes) at `warm_sweeps`. Both orders converge
//           to f32 rounding in the sweeps given (6 cold, 2 warm from a
//           near-diagonal start), so the eigenpairs agree with the
//           twin's to the one-iteration tolerances.
//           Then eigenvalue max-normalization and floor, log-determinant
//           and the scaled eigenbasis W = V diag(l^{-1/2}).
//   E-step  a thread per frame, D a template parameter: the frame in
//           registers, the quadratic form as the projection
//           sum_i |(W^H y)_i|^2 (never through the assembled inverse,
//           which cancels once an eigenvalue sits at the floor), log-pdf,
//           max-shift softmax with the mixture weight, the source-activity
//           mask on the numerators, affiliation_eps clipping (none in the
//           final iteration, whose posterior is written out and equals
//           predict()); then saliency and w = a / max(q, 10 tiny).
//
// What bounds it on the H100: y is read from device memory once per
// fit, so the kernel is bound by the instructions it issues: the E-step's
// D^2 complex multiply-adds per class and frame, the scatter's pair
// products, and the Jacobi's serial chain, which only one warp of the CTA
// runs. At the slice shape (D=6, K=3, T=304, 4 warps, 8 CTAs an SM) the
// one-frame scatter's loop was half of the kernel's time (compiled out,
// 416.6 -> 213.8 ms at B=512 F=257, 80 iterations): ~30 instructions a
// lane and frame, ~10 of them arithmetic (scalar broadcast loads of four
// classes' weights, a select for the sum lane, FMAs on a fourth class of
// zeros). The design cuts each: unrolled loops over a compile-time D,
// broadcast reads of W, a scatter from 16-byte loads of G frames with the
// G products formed once for a class group sized to K (~13-16 a lane and
// frame; the kernel 284.3 ms at that shape), register accumulation with
// one reduction per iteration, parallel rotations with one column a lane.
// The CTA has as many warps as fill two or more rounds of frames nearly
// evenly (the host's choice, ops/em_loop.py), and idle warps of a short T
// do not hold occupancy.
//
// Shared memory: y (D x Tp complex), the covariance, the eigenvectors and
// the scaled eigenbasis (K x D x D complex each), the posterior times
// saliency and the scatter weights (K x Tw each) and the per-class
// scalars; never more than the gate's formula (ops/em_loop.smem_bytes)
// allows. At G = 1 (D <= 3, where that formula leaves no room for pads)
// Tp is T rounded up to odd, so that the channels of a frame fall in
// distinct banks, and Tw = T. At G = 2 or 4 Tp is the least stride >= T
// with Tp = 2 mod 4: each row starts on a 16-byte boundary and the
// 16-byte chunks of D <= 8 rows at one frame fall in distinct banks for
// the scatter, while the E-step's reads (a thread per frame) stay
// contiguous; Tw is T rounded up to G and the (K, Tw) arrays start on a
// 16-byte boundary (8 bytes of pad where needed). The scatter's run of
// ones lives in the covariance's space, which is free while the scatter
// runs.
//
// There is no padding of frames: loops run over the real T (the frames of
// T mod G one by one), pads are never read, and the grid has exactly one
// CTA per bin, so no padded lane can feed 0 * inf into a reduction.
//
// The Jacobi and the E-step are em_iter.cuh's, shared with the
// frequency-constant-weight EM (em_step.cu); the grouped scatter is this
// kernel's own (em_step.cu and cwmm_loop.cu keep scatter_sums).
//
// Layouts (all contiguous): y (N, D, T) complex64 as float2;
// aff0/qf0/aff/mask (N, K, T) float; sal (N, T); weight (N, K); eig
// (N, K, D) unsorted; V (N, K, D, D) complex64, eigenvectors in columns.
#include <cfloat>
#include <cmath>
#include <cuda_runtime.h>

#include "em_iter.cuh"

namespace {

constexpr int kMaxThreads = 256;

// Frames a lane of the M-step scatter sums from one group of 16-byte
// loads, a function of D alone (ops/em_loop.scatter_frames), the faster of
// 2 and 4 on the H100 (B=512 F=257 T=304 K=3, 80 iterations: 2 took
// 284.4 ms against 289.8 at D=6 and 1-3% less at D=7-10; 4 took 9% less
// at D=12 and as long at D=16); 1 (scatter_sums) at D <= 3, where the
// gate's budget leaves no room for the alignment pads.
__host__ __device__ constexpr int scatter_frames(int D) {
  return D <= 3 ? 1 : (D <= 10 ? 2 : 4);
}

// y's row stride: at G = 1 T rounded up to odd (T at D = 1); else the
// least stride >= T with stride = 2 mod 4.
__host__ __device__ constexpr int row_stride(int D, int T) {
  return scatter_frames(D) == 1 ? (D == 1 ? T : (T | 1))
                                : T + (6 - T % 4) % 4;
}

// The (K, T) arrays' row stride: T rounded up to the frame group.
__host__ __device__ constexpr int weight_stride(int D, int T) {
  return (T + scatter_frames(D) - 1) / scatter_frames(D) *
         scatter_frames(D);
}

// float2s of y and the three K x D x D arrays, rounded up to a 16-byte
// boundary at G > 1 (where the (K, Tw) arrays that follow take 16-byte
// loads).
__host__ __device__ inline size_t em_matrix_float2s(int D, int K, int T) {
  const size_t n = size_t(D) * row_stride(D, T) + 3 * size_t(K) * D * D;
  return scatter_frames(D) == 1 ? n : (n + 1) / 2 * 2;
}

inline size_t em_smem_bytes(int D, int K, int T) {
  return sizeof(float2) * em_matrix_float2s(D, K, T) +
         sizeof(float) * (2 * size_t(K) * weight_stride(D, T) +
                          size_t(K) * D + 4 * K);
}

// Registers: up to 64 a thread for D <= 6, so that a 160-thread CTA of
// the slice shape leaves room for six on an SM; more for larger D.
template <int D>
__global__ void __launch_bounds__(kMaxThreads, D <= 6 ? 4 : (D <= 10 ? 3 : 2))
cacgmm_em_full_kernel(const float2* __restrict__ y,
                      const float* __restrict__ aff0,
                      const float* __restrict__ qf0,
                      const float* __restrict__ sal_in,
                      const float* __restrict__ mask_in,
                      float* __restrict__ weight_out,
                      float* __restrict__ eig_out,
                      float2* __restrict__ v_out,
                      float* __restrict__ aff_out, int K, int T,
                      int iterations, int sweeps, int warm_sweeps,
                      float eigenvalue_floor, float affiliation_eps) {
  constexpr int DD = D * D;
  constexpr int G = scatter_frames(D);
  extern __shared__ float4 smem_raw[];
  const int Tp = row_stride(D, T);
  const int Tw = weight_stride(D, T);
  float2* ys = reinterpret_cast<float2*>(smem_raw);  // D * Tp
  float2* S = ys + size_t(D) * Tp;  // K * DD covariance; the scatter's ones
  float2* V = S + K * DD;           // K * DD eigvecs
  float2* Wh = V + K * DD;  // K * DD scaled eigenbasis; the scatter sums
  // K * Tw a * saliency, on a 16-byte boundary at G > 1
  float* aw = reinterpret_cast<float*>(ys + em_matrix_float2s(D, K, T));
  float* wq = aw + size_t(K) * Tw;  // K * Tw quadratic form, then weights
  float* eig = wq + size_t(K) * Tw;  // K * D
  float* wsum = eig + K * D;        // K
  float* wgt = wsum + K;            // K
  float* logdet = wgt + K;          // K
  float2* Su = Wh;  // the upper-triangle sums, K * P, before the eigh

  const size_t n = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const size_t KT = size_t(K) * T;
  const float tiny = FLT_MIN;
  const bool has_sal = sal_in != nullptr;
  const float* sal = has_sal ? sal_in + n * T : nullptr;
  const float* mask = mask_in != nullptr ? mask_in + n * KT : nullptr;

  for (int d = 0; d < D; ++d)
    for (int t = tid; t < T; t += nthreads)
      ys[d * Tp + t] = y[(n * D + d) * T + t];
  for (size_t i = tid; i < KT; i += nthreads) {
    const int k = int(i / T);
    const int t = int(i - size_t(k) * T);
    const float a = aff0[n * KT + i] * (has_sal ? sal[t] : 1.f);
    aw[k * Tw + t] = a;
    wq[k * Tw + t] = a / fmaxf(qf0[n * KT + i], 10.f * tiny);
  }
  __syncthreads();

  for (int it = 0; it < iterations; ++it) {
    const bool warm = it > 0 && warm_sweeps >= 0;

    // ---- M-step sums, covariance D sum / max(asum, tiny), weight ------
    if constexpr (G == 1)
      scatter_sums<D>(ys, Tp, aw, wq, Su, wsum, K, T);
    else
      scatter_sums_grouped<D, G>(ys, Tp, S, aw, wq, Tw, Su, wsum, K, T);
    covariance_from_sums<D>(Su, wsum, S, K, float(D));
    for (int k = tid; k < K; k += nthreads)
      wgt[k] = mixture_weight(wsum, k, K, has_sal, float(T));
    __syncthreads();

    // ---- eigh: the column Jacobi; normalization, floor, log-determinant
    // and the scaled eigenbasis W = V diag(l^{-1/2}) --------------------
    column_eigh<D>(
        S, V, K, warm, warm ? warm_sweeps : sweeps,
        [&](int k, int jc, float lam, const float2 (&v)[D], int jbase,
            bool jown) {
          float ld;
          const float ev =
              floored_eigenvalue<D>(lam, jbase, eigenvalue_floor, &ld);
          if (jown) {
            eig[k * D + jc] = ev;
            if (jc == 0) logdet[k] = ld;
            const float scale = 1.f / sqrtf(ev);
#pragma unroll
            for (int i = 0; i < D; ++i) {
              V[k * DD + i * D + jc] = v[i];
              Wh[k * DD + jc * D + i] = c_scale(scale, c_conj(v[i]));
            }
          }
        });
    __syncthreads();

    // ---- E-step: a thread per frame; the last one is unclipped and is
    // written out --------------------------------------------------------
    const bool last = it == iterations - 1;
    e_step_pass<D>(ys, Tp, Wh, logdet, wgt, mask, sal,
                   last ? 0.f : affiliation_eps, aw, wq,
                   last ? aff_out + n * KT : nullptr, !last, K, T, Tw);
    __syncthreads();
  }

  for (int k = tid; k < K; k += nthreads) weight_out[n * K + k] = wgt[k];
  for (int i = tid; i < K * D; i += nthreads)
    eig_out[n * K * D + i] = eig[i];
  for (int i = tid; i < K * DD; i += nthreads)
    v_out[n * K * DD + i] = V[i];
}

template <int D>
cudaError_t launch(int N, int threads, size_t bytes, cudaStream_t stream,
                   const void* y, const void* aff0, const void* qf0,
                   const void* sal, const void* mask, void* weight,
                   void* eig, void* v, void* aff, int K, int T,
                   int iterations, int sweeps, int warm_sweeps,
                   float eigenvalue_floor, float affiliation_eps) {
  cudaError_t err = cudaFuncSetAttribute(
      cacgmm_em_full_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(bytes));
  if (err != cudaSuccess) return err;
  cacgmm_em_full_kernel<D><<<N, threads, bytes, stream>>>(
      static_cast<const float2*>(y), static_cast<const float*>(aff0),
      static_cast<const float*>(qf0), static_cast<const float*>(sal),
      static_cast<const float*>(mask), static_cast<float*>(weight),
      static_cast<float*>(eig), static_cast<float2*>(v),
      static_cast<float*>(aff), K, T, iterations, sweeps, warm_sweeps,
      eigenvalue_floor, affiliation_eps);
  return cudaGetLastError();
}

}  // namespace

// Frames a lane of the M-step scatter sums at once at D.
extern "C" int cacgmm_em_full_scatter_frames(int D) {
  return scatter_frames(D);
}

// CTAs of the whole-fit EM resident on one SM at (D, K, T) with `threads`
// threads (the occupancy query). Returns a negative cudaError_t on
// failure.
extern "C" int cacgmm_em_full_occupancy(int D, int K, int T, int threads) {
  const size_t bytes = em_smem_bytes(D, K, T);
  int blocks = 0;
  cudaError_t err = cudaErrorInvalidValue;
#define QUERY(DV)                                                          \
  err = cudaFuncSetAttribute(cacgmm_em_full_kernel<DV>,                   \
                             cudaFuncAttributeMaxDynamicSharedMemorySize, \
                             int(bytes));                                 \
  if (err == cudaSuccess)                                                 \
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                  \
        &blocks, cacgmm_em_full_kernel<DV>, threads, bytes);              \
  break;
  switch (D) {
    case 1: QUERY(1) case 2: QUERY(2) case 3: QUERY(3) case 4: QUERY(4)
    case 5: QUERY(5) case 6: QUERY(6) case 7: QUERY(7) case 8: QUERY(8)
    case 9: QUERY(9) case 10: QUERY(10) case 11: QUERY(11)
    case 12: QUERY(12) case 13: QUERY(13) case 14: QUERY(14)
    case 15: QUERY(15) case 16: QUERY(16)
    default: break;
  }
#undef QUERY
  return err == cudaSuccess ? blocks : -int(err);
}

// Launch the whole-fit EM on `stream` for N independent bins, `threads`
// threads (a multiple of 32, at most 256) per bin. sal and mask may be null.
// Returns a cudaError_t (0 on success); neither synchronizes nor
// allocates.
extern "C" int cacgmm_em_full_launch(
    const void* y, const void* aff0, const void* qf0, const void* sal,
    const void* mask, void* weight, void* eig, void* v, void* aff, int N,
    int D, int K, int T, int threads, int iterations, int sweeps,
    int warm_sweeps, float eigenvalue_floor, float affiliation_eps,
    void* stream) {
  if (threads % 32 != 0 || threads < 32 || threads > kMaxThreads)
    return int(cudaErrorInvalidValue);
  const size_t bytes = em_smem_bytes(D, K, T);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL(DV)                                                            \
  int(launch<DV>(N, threads, bytes, s, y, aff0, qf0, sal, mask, weight, eig, \
                 v, aff, K, T, iterations, sweeps, warm_sweeps,              \
                 eigenvalue_floor, affiliation_eps))
  switch (D) {
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
