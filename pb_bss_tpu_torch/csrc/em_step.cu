// cACGMM EM with FREQUENCY-CONSTANT mixture weights: one launch per EM
// iteration.
//
// Replaces pb_bss_tpu/ops/pallas_em_step.py:cacgmm_em_fc, whose two
// Pallas TPU kernels are _m_init_kernel (the first M-step) and
// _em_step_kernel (one EM iteration). With weight_constant_axis=(-3, -1)
// every M-step reduces the affiliation sums over all bins of an
// utterance, and the CTAs of one launch cannot share that reduction. So
// the fit is split at the one global reduction, as the TPU kernels split
// it: each launch writes the per-(bin, class) affiliation sums, and the
// wrapper reduces them over the bins of each utterance into the (B, K)
// weight that the next launch reads (pb_bss_tpu_torch/ops/em_step.py).
//
//   grid: one CTA per (utterance, bin) n = b * F + f; the bin's y
//   (D x T complex, rows of stride Tp) sits in shared memory for the
//   launch. Both kernels are the whole-fit EM's iteration body
//   (em_iter.cuh, shared with em_loop.cu), templated on D:
//
//   em_fc_init_kernel (the first M-step): a = aff0 * saliency,
//     w = a / max(qf0, 10 tiny), the register scatter (lanes over the
//     upper-triangle entries and the affiliation sum, warps over frames,
//     one cross-warp reduction in a fixed order),
//     S_k = D sum / max(asum_k, tiny), the column Jacobi cold at `sweeps`
//     (a lane per column, floor(32 / D) classes to a warp, in the plain
//     twin's cyclic order, which also leaves the unsorted eigenvalues in
//     the twin's order), eigenvalue max-normalization and floor. Writes
//     V, eig (unsorted) and asum.
//   em_fc_step_kernel (one EM iteration): the scaled eigenbases
//     W = V diag(l^{-1/2}) and log-determinants from the previous state,
//     the E-step (a thread per frame: the quadratic form as the
//     projection sum_i |(W^H y)_i|^2, log-pdf, max-shift softmax with the
//     utterance's weight weight[(n / F) K + k], source-activity mask, clip
//     to [eps, 1 - eps]); the posterior is written out when the inline
//     aligner needs it (clipped, before saliency, as the scan path's
//     model._predict returns it); then saliency, the scatter as above,
//     and the column Jacobi warm-started from the previous eigenbasis
//     (A = V^H S V, `warm_sweeps` sweeps in the plain twin's cyclic order:
//     two sweeps from a matrix that the new statistics moved do not
//     converge, and the order decides what they leave off the diagonal),
//     floor. Writes V, eig, asum.
//
// The guard ladder: the covariance is D sum / max(asum, tiny), a
// division (covariance_from_sums), so a class silenced in a real bin
// stays finite at D >= 5. There is no padding (exact loop bounds, one CTA
// per real bin), so no padded lane feeds the weight reduction.
//
// What bounds it on the H100: y is read from device memory once per
// launch (59 MB at B=8, F=513, D=6, T=300, ~18 us at 3.35 TB/s) and the
// work is ~1 GFLOP per launch at that shape, so by the card's peaks a
// step is bound by the operations, ~27 us; in practice by the
// instructions of the scatter, the E-step and the Jacobi's latency chain,
// which the iteration body cuts as it does for the whole-fit kernel:
// unrolled loops over a compile-time D, register sums, rotations in
// registers with shuffles. The host picks the CTA's warps from the bin's shared memory
// (ops/em_step.py). The measured time is in PERF.md.
//
// Shared memory (both kernels): y (D x Tp complex; Tp = T rounded up to
// odd where the budget allows, the host's choice), the covariance, the
// eigenvectors and the scaled eigenbasis / scatter sums (K x D x D
// complex each), the posterior and the weights (K x T each), the
// eigenvalues and 3 K scalars: ops/em_step.kernel_smem_bytes.
//
// Layouts (all contiguous): y (N, D, T) complex64 as float2;
// aff0/qf0/mask/aff_out (N, K, T) float; sal (N, T); weight (B, K) for
// N = B * F bins; V (N, K, D, D) complex64, eigenvectors in columns;
// eig (N, K, D); asum (N, K).
#include <cfloat>
#include <cmath>
#include <cuda_runtime.h>

#include "em_iter.cuh"

namespace {

constexpr int kMaxThreads = 256;

inline size_t fc_smem_bytes(int D, int K, int T, int Tp) {
  return sizeof(float2) * (size_t(D) * Tp + 3 * size_t(K) * D * D) +
         sizeof(float) * (2 * size_t(K) * T + size_t(K) * D + 3 * K);
}

// The shared-memory carve-up of both kernels.
struct FcSmem {
  float2 *ys, *S, *V, *Wh;
  float *aw, *wq, *eig, *asum, *logdet, *wgt;
};

__device__ __forceinline__ FcSmem fc_smem(float4* raw, int D, int K, int T,
                                          int Tp) {
  const int DD = D * D;
  FcSmem m;
  m.ys = reinterpret_cast<float2*>(raw);  // D * Tp
  m.S = m.ys + size_t(D) * Tp;            // K * DD covariance
  m.V = m.S + K * DD;                     // K * DD eigenvectors
  m.Wh = m.V + K * DD;  // K * DD scaled eigenbasis, then the scatter sums
  m.aw = reinterpret_cast<float*>(m.Wh + K * DD);  // K * T
  m.wq = m.aw + size_t(K) * T;                      // K * T
  m.eig = m.wq + size_t(K) * T;                     // K * D
  m.asum = m.eig + K * D;                           // K
  m.logdet = m.asum + K;                            // K
  m.wgt = m.logdet + K;                             // K
  return m;
}

template <int D>
__device__ __forceinline__ void load_y(const float2* __restrict__ y,
                                       float2* ys, size_t n, int T, int Tp) {
  for (int d = 0; d < D; ++d)
    for (int t = threadIdx.x; t < T; t += blockDim.x)
      ys[d * Tp + t] = y[(n * D + d) * T + t];
}

// The M-step from the weights in shared memory: the scatter sums, asum
// out, the covariance, the column Jacobi in the plain twin's cyclic order
// (cold from the identity, or warm from V) and the floored eigenvalues,
// written to v_out / eig_out at bin n. Called by the whole block, which
// it leaves unsynchronized.
template <int D>
__device__ __forceinline__ void fc_m_step(const FcSmem& m, size_t n, int K,
                                          int T, int Tp, bool warm,
                                          int sweeps, float eigenvalue_floor,
                                          float2* __restrict__ v_out,
                                          float* __restrict__ eig_out,
                                          float* __restrict__ asum_out) {
  constexpr int DD = D * D;
  float2* Su = m.Wh;
  scatter_sums<D>(m.ys, Tp, m.aw, m.wq, Su, m.asum, K, T);
  covariance_from_sums<D>(Su, m.asum, m.S, K, float(D));
  for (int k = threadIdx.x; k < K; k += blockDim.x)
    asum_out[n * K + k] = m.asum[k];
  __syncthreads();
  column_eigh<D, JacobiOrder::kCyclic>(
      m.S, m.V, K, warm, sweeps,
      [&](int k, int jc, float lam, const float2 (&v)[D], int jbase,
          bool jown) {
        float ld;
        const float ev =
            floored_eigenvalue<D>(lam, jbase, eigenvalue_floor, &ld);
        if (jown) {
          eig_out[(n * K + k) * D + jc] = ev;
#pragma unroll
          for (int i = 0; i < D; ++i)
            v_out[(n * K + k) * DD + i * D + jc] = v[i];
        }
      });
}

// Registers: up to 64 a thread for D <= 6, as the whole-fit kernel.
template <int D>
__global__ void __launch_bounds__(kMaxThreads, D <= 6 ? 4 : (D <= 10 ? 3 : 2))
em_fc_init_kernel(const float2* __restrict__ y,
                  const float* __restrict__ aff0,
                  const float* __restrict__ qf0,
                  const float* __restrict__ sal,
                  float2* __restrict__ v_out, float* __restrict__ eig_out,
                  float* __restrict__ asum_out, int K, int T, int Tp,
                  int sweeps, float eigenvalue_floor) {
  extern __shared__ float4 smem_raw[];
  const FcSmem m = fc_smem(smem_raw, D, K, T, Tp);
  const size_t n = blockIdx.x;
  const size_t KT = size_t(K) * T;

  load_y<D>(y, m.ys, n, T, Tp);
  for (size_t i = threadIdx.x; i < KT; i += blockDim.x) {
    const int t = int(i % T);
    const float a = aff0[n * KT + i] * (sal != nullptr ? sal[n * T + t] : 1.f);
    m.aw[i] = a;
    m.wq[i] = a / fmaxf(qf0[n * KT + i], 10.f * FLT_MIN);
  }
  __syncthreads();
  fc_m_step<D>(m, n, K, T, Tp, false, sweeps, eigenvalue_floor, v_out,
               eig_out, asum_out);
}

template <int D>
__global__ void __launch_bounds__(kMaxThreads, D <= 6 ? 4 : (D <= 10 ? 3 : 2))
em_fc_step_kernel(const float2* __restrict__ y,
                  const float2* __restrict__ v_in,
                  const float* __restrict__ eig_in,
                  const float* __restrict__ weight,
                  const float* __restrict__ sal,
                  const float* __restrict__ mask,
                  float2* __restrict__ v_out, float* __restrict__ eig_out,
                  float* __restrict__ asum_out,
                  float* __restrict__ aff_out, int F, int K, int T, int Tp,
                  int warm_sweeps, float eigenvalue_floor,
                  float affiliation_eps) {
  constexpr int DD = D * D;
  extern __shared__ float4 smem_raw[];
  const FcSmem m = fc_smem(smem_raw, D, K, T, Tp);
  const size_t n = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t KT = size_t(K) * T;

  load_y<D>(y, m.ys, n, T, Tp);
  for (int i = tid; i < K * DD; i += blockDim.x) m.V[i] = v_in[n * K * DD + i];
  for (int i = tid; i < K * D; i += blockDim.x) m.eig[i] = eig_in[n * K * D + i];
  __syncthreads();
  // the scaled eigenbases W = V diag(l^{-1/2}), stored conjugate-
  // transposed (projection_form's layout), the log-determinants and the
  // utterance's weight
  for (int id = tid; id < K * DD; id += blockDim.x) {
    const int k = id / DD;
    const int i = (id - k * DD) / D;
    const int d = id - k * DD - i * D;
    m.Wh[id] = c_scale(1.f / sqrtf(m.eig[k * D + i]),
                       c_conj(m.V[k * DD + d * D + i]));
  }
  for (int k = tid; k < K; k += blockDim.x) {
    float ld = 0.f;
    for (int i = 0; i < D; ++i) ld += logf(m.eig[k * D + i]);
    m.logdet[k] = ld;
    m.wgt[k] = weight[(n / F) * K + k];
  }
  __syncthreads();

  // ---- E-step: aw <- a s, wq <- a s / max(q, 10 tiny) ----------------
  e_step_pass<D>(m.ys, Tp, m.Wh, m.logdet, m.wgt,
                 mask != nullptr ? mask + n * KT : nullptr,
                 sal != nullptr ? sal + n * T : nullptr, affiliation_eps,
                 m.aw, m.wq, aff_out != nullptr ? aff_out + n * KT : nullptr,
                 true, K, T);
  __syncthreads();

  // ---- M-step, the Jacobi warm-started from the previous eigenbasis --
  fc_m_step<D>(m, n, K, T, Tp, true, warm_sweeps, eigenvalue_floor, v_out,
               eig_out, asum_out);
}

template <int D>
cudaError_t init_launch(int N, int threads, size_t bytes, cudaStream_t s,
                        const void* y, const void* aff0, const void* qf0,
                        const void* sal, void* v, void* eig, void* asum,
                        int K, int T, int Tp, int sweeps,
                        float eigenvalue_floor) {
  cudaError_t err = cudaFuncSetAttribute(
      em_fc_init_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(bytes));
  if (err != cudaSuccess) return err;
  em_fc_init_kernel<D><<<N, threads, bytes, s>>>(
      static_cast<const float2*>(y), static_cast<const float*>(aff0),
      static_cast<const float*>(qf0), static_cast<const float*>(sal),
      static_cast<float2*>(v), static_cast<float*>(eig),
      static_cast<float*>(asum), K, T, Tp, sweeps, eigenvalue_floor);
  return cudaGetLastError();
}

template <int D>
cudaError_t step_launch(int N, int threads, size_t bytes, cudaStream_t s,
                        const void* y, const void* v_in, const void* eig_in,
                        const void* weight, const void* sal,
                        const void* mask, void* v_out, void* eig_out,
                        void* asum, void* aff_out, int F, int K, int T,
                        int Tp, int warm_sweeps, float eigenvalue_floor,
                        float affiliation_eps) {
  cudaError_t err = cudaFuncSetAttribute(
      em_fc_step_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(bytes));
  if (err != cudaSuccess) return err;
  em_fc_step_kernel<D><<<N, threads, bytes, s>>>(
      static_cast<const float2*>(y), static_cast<const float2*>(v_in),
      static_cast<const float*>(eig_in), static_cast<const float*>(weight),
      static_cast<const float*>(sal), static_cast<const float*>(mask),
      static_cast<float2*>(v_out), static_cast<float*>(eig_out),
      static_cast<float*>(asum), static_cast<float*>(aff_out), F, K, T, Tp,
      warm_sweeps, eigenvalue_floor, affiliation_eps);
  return cudaGetLastError();
}

bool valid(int D, int T, int Tp, int threads) {
  return D >= 1 && D <= 16 && (Tp == T || (D > 1 && Tp == (T | 1))) &&
         threads % 32 == 0 && threads >= 32 && threads <= kMaxThreads;
}

}  // namespace

#define FC_DISPATCH(CALL)                                                  \
  switch (D) {                                                             \
    case 1: return int(CALL(1)); case 2: return int(CALL(2));              \
    case 3: return int(CALL(3)); case 4: return int(CALL(4));              \
    case 5: return int(CALL(5)); case 6: return int(CALL(6));              \
    case 7: return int(CALL(7)); case 8: return int(CALL(8));              \
    case 9: return int(CALL(9)); case 10: return int(CALL(10));            \
    case 11: return int(CALL(11)); case 12: return int(CALL(12));          \
    case 13: return int(CALL(13)); case 14: return int(CALL(14));          \
    case 15: return int(CALL(15)); case 16: return int(CALL(16));          \
    default: return int(cudaErrorInvalidValue);                            \
  }

// Launch the first M-step on `stream` for N bins (1 <= D <= 16), `threads`
// threads (a multiple of 32, at most 256) a bin, y's rows at stride Tp (T,
// or T | 1 for D > 1) in shared memory. sal may be null. Returns a
// cudaError_t (0 on success); neither synchronizes nor allocates.
extern "C" int em_fc_init_launch(const void* y, const void* aff0,
                                 const void* qf0, const void* sal, void* v,
                                 void* eig, void* asum, int N, int D, int K,
                                 int T, int Tp, int threads, int sweeps,
                                 float eigenvalue_floor, void* stream) {
  if (!valid(D, T, Tp, threads)) return int(cudaErrorInvalidValue);
  const size_t bytes = fc_smem_bytes(D, K, T, Tp);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL(DV)                                                            \
  init_launch<DV>(N, threads, bytes, s, y, aff0, qf0, sal, v, eig, asum, K, \
                  T, Tp, sweeps, eigenvalue_floor)
  FC_DISPATCH(CALL)
#undef CALL
}

// Launch one EM iteration on `stream` for N = B * F bins, as the init.
// sal, mask and aff_out may be null (aff_out non-null: write the
// posterior). Returns a cudaError_t (0 on success); neither synchronizes
// nor allocates.
extern "C" int em_fc_step_launch(const void* y, const void* v_in,
                                 const void* eig_in, const void* weight,
                                 const void* sal, const void* mask,
                                 void* v_out, void* eig_out, void* asum,
                                 void* aff_out, int N, int F, int D, int K,
                                 int T, int Tp, int threads, int warm_sweeps,
                                 float eigenvalue_floor,
                                 float affiliation_eps, void* stream) {
  if (!valid(D, T, Tp, threads)) return int(cudaErrorInvalidValue);
  const size_t bytes = fc_smem_bytes(D, K, T, Tp);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL(DV)                                                             \
  step_launch<DV>(N, threads, bytes, s, y, v_in, eig_in, weight, sal, mask, \
                  v_out, eig_out, asum, aff_out, F, K, T, Tp, warm_sweeps,  \
                  eigenvalue_floor, affiliation_eps)
  FC_DISPATCH(CALL)
#undef CALL
}

#undef FC_DISPATCH
