// The opt-in cACGMM E-step kernels (K11): the E-step posterior alone, and
// the E-step folded into the M-step scatter.
//
// Replaces pb_bss_tpu/ops/pallas_em.py: cacgmm_e_step (_e_step_kernel)
// and cacgmm_em_scatter (_em_iteration_kernel), the Pallas TPU kernels
// behind CACGMMTrainer.fit(use_pallas_em=True). On the TPU one grid step
// held a whole bin (D x T planes) in VMEM and computed z = V^H y with
// two real matrix products per plane. Here the quadratic form is the
// projection on the scaled eigenbasis W = V diag(sqrt(1/l)),
// q = sum_i |(W^H y)_i|^2, as in the other cACGMM kernels (em_common.cuh);
// the JAX kernels' assembled inverse V diag(1/l) V^H cancels once an
// eigenvalue sits at the floor. Both kernels walk the plan of the
// streamed passes (stream.cuh, ops/_plan.py): the N T frames of the bins
// laid end to end, cut into equal spans over whole waves of CTAs of
// kThreads threads, each piece of a bin that a CTA covers a segment. D is
// a template parameter (1..16), so a frame sits in registers:
//
//   em_e_step_kernel: per segment the bin's scaled bases, log-determinants
//     and weights in shared memory, then a thread a frame: the frame from
//     y (coalesced along time), the E-step (max(q, tiny),
//     -D log q - logdet, the max-shift softmax with the linear weights,
//     max(den, tiny); no clip), the class values in the thread's own
//     column of shared memory (any K), and the (K, T) posterior and
//     quadratic form written coalesced.
//   em_scatter_kernel: stream.cuh's pass (the cp.async ring, register
//     sums, one cross-warp reduction a segment) with this file's model,
//     the same E-step and the scatter weight m = a / q. A bin that one CTA
//     covers whole is written straight out; a bin split over CTAs gets a
//     partial sum a segment in its own slot, which the last CTA on the bin
//     adds in slot order in the same launch (stream::sum_split_bin). No
//     float atomics and no zeroing launch: runs repeat bit for bit.
//     S = D sum is written as the full Hermitian re/im planes.
//
// What bounds it on the H100: y is read once per call (the scatter at
// F=257, T=304, D=6 reads 3.7 MB, ~1.1 us at 3.35 TB/s), against ~1.5 us
// of float32 operations; at the trainer's sizes a launch is short and its
// fixed costs (the model's set-up, the barriers, the ticket) count. So
// every CTA takes the same share of frames, a segment's model is set up
// once, the copies of y run ahead of the work, and the call is one
// launch. Tensor cores are not used: a tile's scatter is at most 32 x 32
// in real terms, below wgmma's 64-row tile, and TF32 would round it to
// ~1e-3, which the EM amplifies.
//
// Operands (contiguous): y (N, D, T) complex64 as float2; the eigenvectors
// (N, K, D, D) complex64, in columns; inv_lam (N, K, D); logdet and weight
// (N, K). Outputs (contiguous float): aff/qf (N, K, T); s_re/s_im (N, K,
// D, D); asum (N, K); work: slots (slots, N, K, D (D + 1) / 2 + 1) float2
// and counters (N) int, all 0 at the start of a launch and left so.
#include <cfloat>
#include <cmath>
#include <cuda_runtime.h>

#include "em_common.cuh"
#include "stream.cuh"

namespace {

using stream::kGroup;

// a CTA's threads, one a frame of a tile: on an H100, 128 ran ahead of 256
// at the trainer's shape (ops/em_estep.py)
constexpr int kThreads = 128;
constexpr int kRow = kThreads + 1;  // the ring's row stride, odd
constexpr int kWarps = kThreads / 32;

// The operands of one call.
struct Model {
  const float2* y;
  const float2* v;  // eigenvectors, in columns
  const float* inv_lam;
  const float* logdet;
  const float* weight;
};

// Shared memory of the model and the E-step's class values: the scaled
// bases (K D^2 complex), the class values of a tile (2 K kThreads), the
// log-determinants and weights.
inline size_t model_words(int D, int K) {
  return 2 * size_t(K) * D * D + 2 * size_t(K) * kThreads + 2 * size_t(K);
}

// Shared memory of a scatter CTA: the pass's ring, scatter weights and
// reduction (stream.cuh), the model and the ticket's flag.
inline size_t scatter_smem_bytes(int D, int K) {
  return 4 * (stream::ring_words(D, kThreads) + stream::pass_words(kThreads) +
              model_words(D, K) + 1);
}

// Shared memory of an E-step CTA: the model alone.
inline size_t e_step_smem_bytes(int D, int K) { return 4 * model_words(D, K); }

// Where the model of a CTA sits in shared memory, from `words` on.
struct Smem {
  float2* Wh;  // K x D^2
  float* lp;   // K x kThreads
  float* qv;   // K x kThreads
  float* logdet;
  float* wgt;
};

template <int D>
__device__ __forceinline__ Smem model_smem(float* words, int K) {
  Smem s;
  s.Wh = reinterpret_cast<float2*>(words);
  s.lp = reinterpret_cast<float*>(s.Wh + K * D * D);
  s.qv = s.lp + K * kThreads;
  s.logdet = s.qv + K * kThreads;
  s.wgt = s.logdet + K;
  return s;
}

// The model of bin n by the CTA: the scaled bases Wh[k][i][d] =
// sqrt(1 / l_i) conj(V[d][i]) (projection_form's layout), the
// log-determinants and the weights. The caller synchronizes.
template <int D>
__device__ __forceinline__ void load_model(const Model& m, int n, int K,
                                           const Smem& sm) {
  constexpr int DD = D * D;
  for (int id = threadIdx.x; id < K * DD; id += kThreads) {
    const int k = id / DD;
    const int i = (id - k * DD) / D;
    const int d = id - k * DD - i * D;
    const size_t nk = size_t(n) * K + k;
    sm.Wh[id] = c_scale(sqrtf(m.inv_lam[nk * D + i]),
                        c_conj(m.v[nk * DD + d * D + i]));
  }
  for (int k = threadIdx.x; k < K; k += kThreads) {
    sm.logdet[k] = m.logdet[size_t(n) * K + k];
    sm.wgt[k] = m.weight[size_t(n) * K + k];
  }
}

// The E-step of frame yf into column t of the class values.
template <int D>
__device__ __forceinline__ void e_step(const float2 (&yf)[D], const Smem& sm,
                                       int t, int K) {
  e_step_frame(
      [&](int k) { return projection_form<D>(yf, sm.Wh + k * D * D); },
      sm.logdet, sm.wgt, nullptr, 0, 0.f, sm.lp + t, sm.qv + t, kThreads, D,
      K);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
em_e_step_kernel(Model m, float* __restrict__ aff_out,
                 float* __restrict__ qf_out, int N, int K, int T,
                 long long span) {
  extern __shared__ float4 smem_raw[];
  const Smem sm = model_smem<D>(reinterpret_cast<float*>(smem_raw), K);
  const int tid = threadIdx.x;
  stream::for_each_segment(N, T, span, [&](const stream::Segment& s) {
    __syncthreads();  // the previous segment is done with the model
    load_model<D>(m, s.n, K, sm);
    __syncthreads();
    for (int t = s.t_begin + tid; t < s.t_end; t += kThreads) {
      float2 yf[D];
#pragma unroll
      for (int d = 0; d < D; ++d) yf[d] = m.y[(size_t(s.n) * D + d) * T + t];
      e_step<D>(yf, sm, tid, K);
      for (int k = 0; k < K; ++k) {
        const size_t at = (size_t(s.n) * K + k) * T + t;
        aff_out[at] = sm.lp[k * kThreads + tid];
        qf_out[at] = sm.qv[k * kThreads + tid];
      }
    }
  });
}

// Registers: up to 64 a thread for D <= 8, as K4's pass; more for larger D.
template <int D>
__global__ void __launch_bounds__(kThreads, D <= 8 ? 8 : 4)
em_scatter_kernel(Model m, float* __restrict__ s_re,
                  float* __restrict__ s_im, float* __restrict__ asum_out,
                  float2* slots, int* counters, int N, int K, int T,
                  long long span) {
  constexpr int DD = D * D;
  constexpr int P = stream::entries(D);
  constexpr int I = P + 1;  // items a class: the upper triangle, the sum
  extern __shared__ float4 smem_raw[];
  float* words = reinterpret_cast<float*>(smem_raw);
  float2* ring = reinterpret_cast<float2*>(words);
  float* wq = words + stream::ring_words(D, kThreads);  // kThreads x kGroup
  float* red_a = wq + kThreads * kGroup;                // kWarps x kGroup
  const Smem sm = model_smem<D>(red_a + kWarps * kGroup, K);
  int* flag = reinterpret_cast<int*>(sm.wgt + K);

  // D times the sums of item r of class k of bin n, written out
  auto out = [&](int n, int k, int r, float2 v) {
    const size_t nk = size_t(n) * K + k;
    if (r == P) {
      asum_out[nk] = v.x;
      return;
    }
    int d, e;
    upper_entry(r, D, &d, &e);
    float* re = s_re + nk * DD;
    float* im = s_im + nk * DD;
    const float sr = float(D) * v.x;
    const float si = d == e ? 0.f : float(D) * v.y;
    re[d * D + e] = sr;
    re[e * D + d] = sr;
    im[d * D + e] = si;
    im[e * D + d] = -si;
  };

  auto frame = [&](int n, const float2* ys, int t, size_t, float, int g0,
                   int G, float (&a)[kGroup], float (&w)[kGroup]) {
    float2 yf[D];
#pragma unroll
    for (int d = 0; d < D; ++d) yf[d] = ys[d * kRow + t];
    e_step<D>(yf, sm, t, K);
#pragma unroll
    for (int c = 0; c < kGroup; ++c) {
      if (c < G) {
        a[c] = sm.lp[(g0 + c) * kThreads + t];
        w[c] = a[c] / sm.qv[(g0 + c) * kThreads + t];
      }
    }
  };

  stream::pass_to<D, kThreads>(
      m.y, nullptr, ring, wq, red_a, N, K, T, span,
      [&](int n) { load_model<D>(m, n, K, sm); }, frame,
      [&](const stream::Segment& s, int k, int r, float2 v) {
        if (s.nseg == 1)
          out(s.n, k, r, v);
        else
          slots[(size_t(s.slot) * N + s.n) * K * I + size_t(k) * I + r] = v;
      },
      [&](const stream::Segment& s) {
        stream::sum_split_bin(s, slots, counters, flag, N, K, I,
                              [&](int k, int r, float2 v) {
                                out(s.n, k, r, v);
                              });
      });
}

// kind 0: the E-step kernel, 1: the scatter kernel
template <int D>
const void* kernel_of(int kind) {
  return kind == 0 ? reinterpret_cast<const void*>(&em_e_step_kernel<D>)
                   : reinterpret_cast<const void*>(&em_scatter_kernel<D>);
}

size_t smem_bytes(int kind, int D, int K) {
  return kind == 0 ? e_step_smem_bytes(D, K) : scatter_smem_bytes(D, K);
}

template <int D>
cudaError_t prepare(int kind, size_t bytes) {
  return cudaFuncSetAttribute(kernel_of<D>(kind),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(bytes));
}

template <int D>
cudaError_t resident(int kind, size_t bytes, int* blocks) {
  cudaError_t err = prepare<D>(kind, bytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel_of<D>(kind), kThreads, bytes);
}

cudaError_t resident_any(int kind, int D, size_t bytes, int* blocks) {
#define CALL(DV) resident<DV>(kind, bytes, blocks)
  STREAM_DISPATCH(D, CALL)
#undef CALL
}

template <int D>
cudaError_t launch_e_step(const Model& m, float* aff, float* qf, int N, int K,
                          int T, int ctas, long long span,
                          cudaStream_t stream) {
  const size_t bytes = e_step_smem_bytes(D, K);
  cudaError_t err = prepare<D>(0, bytes);
  if (err != cudaSuccess) return err;
  em_e_step_kernel<D><<<ctas, kThreads, bytes, stream>>>(m, aff, qf, N, K,
                                                         T, span);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_scatter(const Model& m, float* s_re, float* s_im,
                           float* asum, float2* slots, int* counters, int N,
                           int K, int T, int ctas, long long span,
                           cudaStream_t stream) {
  const size_t bytes = scatter_smem_bytes(D, K);
  cudaError_t err = prepare<D>(1, bytes);
  if (err != cudaSuccess) return err;
  em_scatter_kernel<D><<<ctas, kThreads, bytes, stream>>>(
      m, s_re, s_im, asum, slots, counters, N, K, T, span);
  return cudaGetLastError();
}

Model make_model(const void* y, const void* v, const void* inv_lam,
                 const void* logdet, const void* weight) {
  return Model{static_cast<const float2*>(y), static_cast<const float2*>(v),
               static_cast<const float*>(inv_lam),
               static_cast<const float*>(logdet),
               static_cast<const float*>(weight)};
}

}  // namespace

// CTAs of kernel `kind` (0 the E-step, 1 the scatter) resident on the
// whole card at once for (D, K): blocks per SM from the occupancy query
// times the SMs. Returns a negative cudaError_t on failure.
extern "C" int em_estep_capacity(int kind, int D, int K) {
  int blocks = 0, device = 0, sms = 0;
  cudaError_t err = resident_any(kind, D, smem_bytes(kind, D, K), &blocks);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return -int(err);
  return blocks * sms;
}

// Launch the E-step on `stream` for N bins of T frames: `ctas` CTAs, each
// over `span` frames of the bins laid end to end. Returns a cudaError_t
// (0 on success); neither synchronizes nor allocates.
extern "C" int em_e_step_launch(const void* y, const void* v,
                                const void* inv_lam, const void* logdet,
                                const void* weight, void* aff, void* qf,
                                int N, int D, int K, int T, int ctas,
                                long long span, void* stream) {
  const Model m = make_model(y, v, inv_lam, logdet, weight);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL(DV)                                                         \
  launch_e_step<DV>(m, static_cast<float*>(aff), static_cast<float*>(qf), \
                    N, K, T, ctas, span, s)
  return int([&]() -> cudaError_t { STREAM_DISPATCH(D, CALL) }());
#undef CALL
}

// Launch the E-step + scatter on `stream` for N bins of T frames, as
// em_e_step_launch. slots holds (slots, N, K, D (D + 1) / 2 + 1) complex
// partial sums of the bins split over CTAs, counters N ints that are 0
// (and stay so). Returns a cudaError_t (0 on success); neither
// synchronizes nor allocates.
extern "C" int em_scatter_launch(const void* y, const void* v,
                                 const void* inv_lam, const void* logdet,
                                 const void* weight, void* s_re, void* s_im,
                                 void* asum, void* slots, void* counters,
                                 int N, int D, int K, int T, int ctas,
                                 long long span, void* stream) {
  const Model m = make_model(y, v, inv_lam, logdet, weight);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL(DV)                                                          \
  launch_scatter<DV>(m, static_cast<float*>(s_re),                        \
                     static_cast<float*>(s_im), static_cast<float*>(asum), \
                     static_cast<float2*>(slots),                         \
                     static_cast<int*>(counters), N, K, T, ctas, span, s)
  return int([&]() -> cudaError_t { STREAM_DISPATCH(D, CALL) }());
#undef CALL
}
