// Whole-fit cACGMM EM: every EM iteration of a fit in ONE launch.
//
// Replaces pb_bss_tpu/ops/pallas_em_loop.py:cacgmm_em_full (the Pallas
// TPU kernel). Frequency bins are independent, so one CTA owns one
// (utterance, bin) and runs all iterations for it, with y, the scatter
// weights and the model of the bin in shared memory. Per iteration:
//
//   M-step  lanes over the upper-triangle entries (and one more lane for
//           the affiliation sum), warps over frames: lane j adds
//           w_k y_d conj(y_e) of its warp's frames into registers for a
//           group of kGroup classes; then one cross-warp reduction, warp
//           by warp in a fixed order, and the covariance
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
// fit, so the kernel is bound by its instructions: the E-step's D^2
// complex multiply-adds per class and frame, the scatter's pair products,
// and the Jacobi's serial chain, which only one warp of the CTA runs.
// The design cuts each: unrolled loops over a compile-time D, broadcast
// reads of W, register accumulation with one reduction per iteration,
// parallel rotations with one column a lane. The CTA has as many warps as
// fill two or more rounds of frames nearly evenly (the host's choice,
// ops/em_loop.py), and idle warps of a short T do not hold occupancy.
//
// Shared memory: y (D x Tp complex, Tp = T rounded up to odd so that the
// channels of a frame fall in distinct banks), the posterior times
// saliency and the scatter weights (K x T each), the scatter, the
// eigenvectors and the scaled eigenbasis (K x D x D complex each) and
// the per-class scalars; never more than the gate's formula
// (ops/em_loop.smem_bytes) allows.
//
// There is no padding of frames: loops run over the real T and the grid
// has exactly one CTA per bin, so no padded lane can feed 0 * inf into a
// reduction.
//
// Layouts (all contiguous): y (N, D, T) complex64 as float2;
// aff0/qf0/aff/mask (N, K, T) float; sal (N, T); weight (N, K); eig
// (N, K, D) unsorted; V (N, K, D, D) complex64, eigenvectors in columns.
#include <cfloat>
#include <cmath>
#include <cuda_runtime.h>

#include "em_common.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kGroup = 4;  // classes summed in registers at once
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int row_stride(int D, int T) {
  return D == 1 ? T : (T | 1);
}

inline size_t em_smem_bytes(int D, int K, int T) {
  const size_t DD = size_t(D) * D;
  return sizeof(float2) * (size_t(D) * row_stride(D, T) + 3 * K * DD) +
         sizeof(float) * (2 * size_t(K) * T + size_t(K) * D + 4 * K);
}

// The round-robin (circle) schedule of Dn = D + (D & 1) indices: step s
// pairs (s, Dn - 1) and ((s + m) mod (Dn - 1), (s - m) mod (Dn - 1)) for
// m = 1 .. Dn / 2 - 1; the Dn - 1 steps pair every two indices once. A
// pair with the padding index D is skipped.
__host__ __device__ constexpr int rr_a(int Dn, int s, int m) {
  return m == 0 ? s : (s + m) % (Dn - 1);
}
__host__ __device__ constexpr int rr_b(int Dn, int s, int m) {
  return m == 0 ? Dn - 1 : (s - m + Dn - 1) % (Dn - 1);
}

// The rotation of pair (p, q) from a_pp, a_qq, a_pq: the JAX package's
// algebra (tau = (a_qq - a_pp) / 2|a_pq|, t = sign(tau) / (|tau| +
// sqrt(1 + tau^2)) with t = 1 at tau = 0, c = 1 / sqrt(1 + t^2),
// s = t c a_pq / |a_pq|, none when a_pq is zero) in the card's fast
// reciprocal square roots: a Jacobi rotation only has to be applied
// consistently to rows, columns and V, which the shared (c, s) ensure,
// and the sweeps then converge to f32 rounding as with exact parameters.
// An |a_pq| below 1e-18 (of entries ~1) counts as zero.
__device__ __forceinline__ void rotation(float app, float aqq, float2 apq,
                                         float* c_out, float2* s_out) {
  const float n2 = fmaf(apq.x, apq.x, apq.y * apq.y);
  const bool rotate = n2 > 1e-36f;
  const float inv = rotate ? rsqrtf(n2) : 0.f;
  const float tau = 0.5f * (aqq - app) * inv;
  const float t = copysignf(
      __frcp_rn(fabsf(tau) + sqrtf(fmaf(tau, tau, 1.f))), tau);
  const float c = rotate ? rsqrtf(fmaf(t, t, 1.f)) : 1.f;
  const float sr = rotate ? t * c * inv : 0.f;
  *c_out = c;
  *s_out = make_float2(sr * apq.x, sr * apq.y);
}

// `sweeps` parallel Jacobi sweeps on the Hermitian matrices whose columns
// the lanes hold: lane `base + j` holds column j of A (a) and of V (v) of
// its class, j = lane - base < D (`own` false for lanes without a
// column). In each step the two lanes of a pair compute its rotation from
// their own entries (each lane's diagonal and its entry in the partner's
// row), the step's D / 2 rotations reach every lane by shuffle for the
// row updates, and the two lanes exchange their columns by shuffle.
// Afterwards a[j].x is the lane's eigenvalue.
template <int D>
__device__ __forceinline__ void column_jacobi(float2 (&a)[D], float2 (&v)[D],
                                              int base, int j, bool own,
                                              int sweeps) {
  constexpr int Dn = D + (D & 1);
  constexpr int M = Dn / 2;
  for (int sweep = 0; sweep < sweeps; ++sweep) {
#pragma unroll
    for (int s = 0; s < Dn - 1; ++s) {
      // this lane's partner in step s of the circle schedule
      int partner = j == Dn - 1 ? s
          : j == s ? Dn - 1 : (2 * s - j + 2 * (Dn - 1)) % (Dn - 1);
      if (!own || partner >= D) partner = j;
      const bool is_p = j < partner;
      float2 diag = a[0], off = a[0];
#pragma unroll
      for (int i = 1; i < D; ++i) {
        if (i == j) diag = a[i];
        if (i == partner) off = a[i];
      }
      // the partner's diagonal, and A[p][q] from the q lane (its entry in
      // row p)
      const float other = __shfl_sync(kFull, diag.x, base + partner);
      const float2 off_q = make_float2(
          __shfl_sync(kFull, off.x, base + partner),
          __shfl_sync(kFull, off.y, base + partner));
      float c = 1.f;
      float2 sv = make_float2(0.f, 0.f);
      if (partner != j)
        rotation(is_p ? diag.x : other, is_p ? other : diag.x,
                 is_p ? off_q : off, &c, &sv);
      // rows p and q of the lane's column, for every pair of the step:
      // A[p] = c A[p] - s A[q]; A[q] = conj(s) A[p] + c A[q]
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int p0 = rr_a(Dn, s, m), q0 = rr_b(Dn, s, m);
        const int p = p0 < q0 ? p0 : q0, q = p0 < q0 ? q0 : p0;
        if (q < D) {
          const float cm = __shfl_sync(kFull, c, base + q);
          const float2 sm = make_float2(__shfl_sync(kFull, sv.x, base + q),
                                        __shfl_sync(kFull, sv.y, base + q));
          const float2 rp = a[p], rq = a[q];
          a[p] = c_sub(c_scale(cm, rp), c_mul(sm, rq));
          a[q] = c_add(c_mul(c_conj(sm), rp), c_scale(cm, rq));
        }
      }
      // columns: A[:,p] = c A[:,p] - conj(s) A[:,q];
      // A[:,q] = s A[:,p] + c A[:,q] (V the same), the partner's column
      // by shuffle
      const float2 coef = is_p ? make_float2(-sv.x, sv.y) : sv;
      const int src = base + partner;
#pragma unroll
      for (int i = 0; i < D; ++i) {
        const float2 xa = make_float2(__shfl_sync(kFull, a[i].x, src),
                                      __shfl_sync(kFull, a[i].y, src));
        const float2 xv = make_float2(__shfl_sync(kFull, v[i].x, src),
                                      __shfl_sync(kFull, v[i].y, src));
        a[i] = c_add(c_scale(c, a[i]), c_mul(coef, xa));
        v[i] = c_add(c_scale(c, v[i]), c_mul(coef, xv));
      }
    }
  }
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
  constexpr int P = D * (D + 1) / 2;
  constexpr int E = (P + 1 + 31) / 32;  // entries (and the sum) per lane
  constexpr int kClassesPerWarp = 32 / D;
  extern __shared__ float4 smem_raw[];
  const int Tp = row_stride(D, T);
  float2* ys = reinterpret_cast<float2*>(smem_raw);  // D * Tp
  float2* S = ys + size_t(D) * Tp;                   // K * DD covariance
  float2* V = S + K * DD;                            // K * DD eigvecs
  float2* Wh = V + K * DD;  // K * DD scaled eigenbasis; the scatter sums
  float* aw = reinterpret_cast<float*>(Wh + K * DD);  // K * T a * saliency
  float* wq = aw + size_t(K) * T;  // K * T quadratic form, then weights
  float* eig = wq + size_t(K) * T;  // K * D
  float* wsum = eig + K * D;        // K
  float* wgt = wsum + K;            // K
  float* logdet = wgt + K;          // K
  float2* Su = Wh;  // the upper-triangle sums, K * P, before the eigh

  const size_t n = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nwarps = nthreads >> 5;
  const size_t KT = size_t(K) * T;
  const float tiny = FLT_MIN;
  const bool has_sal = sal_in != nullptr;
  const float* sal = has_sal ? sal_in + n * T : nullptr;
  const float* mask = mask_in != nullptr ? mask_in + n * KT : nullptr;

  // this lane's scatter entries: (d, e) of r = lane + 32 j, or the
  // affiliation sum (r == P); lanes past it point at (0, 0), unused
  int ed[E], ee[E], er[E];
#pragma unroll
  for (int j = 0; j < E; ++j) {
    er[j] = lane + 32 * j;
    upper_entry(er[j] < P ? er[j] : 0, D, &ed[j], &ee[j]);
  }
  // this lane's Jacobi column: column jc of the warp's class jslot
  const int jslot = lane / D;
  const int jc = lane - jslot * D;
  const int jbase = jslot * D;

  for (int d = 0; d < D; ++d)
    for (int t = tid; t < T; t += nthreads)
      ys[d * Tp + t] = y[(n * D + d) * T + t];
  for (size_t i = tid; i < KT; i += nthreads) {
    const float a = aff0[n * KT + i] * (has_sal ? sal[i % T] : 1.f);
    aw[i] = a;
    wq[i] = a / fmaxf(qf0[n * KT + i], 10.f * tiny);
  }
  __syncthreads();

  for (int it = 0; it < iterations; ++it) {
    const bool warm = it > 0 && warm_sweeps >= 0;

    // ---- M-step sums: lanes over entries, warps over frames -----------
    for (int g0 = 0; g0 < K; g0 += kGroup) {
      const int G = min(kGroup, K - g0);
      float2 acc[E][kGroup];
#pragma unroll
      for (int j = 0; j < E; ++j)
#pragma unroll
        for (int c = 0; c < kGroup; ++c) acc[j][c] = make_float2(0.f, 0.f);
#pragma unroll 4
      for (int t = warp; t < T; t += nwarps) {
        float w[kGroup], a[kGroup];
#pragma unroll
        for (int c = 0; c < kGroup; ++c) {
          w[c] = c < G ? wq[(g0 + c) * T + t] : 0.f;
          a[c] = c < G ? aw[(g0 + c) * T + t] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const bool is_sum = er[j] == P;
          float2 p = c_mul_conj(ys[ed[j] * Tp + t], ys[ee[j] * Tp + t]);
          if (is_sum) p = make_float2(1.f, 0.f);
#pragma unroll
          for (int c = 0; c < kGroup; ++c) {
            const float f = is_sum ? a[c] : w[c];
            acc[j][c].x = fmaf(f, p.x, acc[j][c].x);
            acc[j][c].y = fmaf(f, p.y, acc[j][c].y);
          }
        }
      }
      // the cross-warp reduction, warp by warp in a fixed order
      for (int w = 0; w < nwarps; ++w) {
        if (warp == w) {
#pragma unroll
          for (int j = 0; j < E; ++j) {
#pragma unroll
            for (int c = 0; c < kGroup; ++c) {
              if (c >= G || er[j] > P) continue;
              const int k = g0 + c;
              if (er[j] == P) {
                wsum[k] = (w == 0 ? 0.f : wsum[k]) + acc[j][c].x;
              } else {
                float2* su = Su + k * P + er[j];
                *su = w == 0 ? acc[j][c] : c_add(*su, acc[j][c]);
              }
            }
          }
        }
        __syncthreads();
      }
    }

    // ---- covariance D sum / max(asum, tiny), Hermitian; mixture weight
    for (int id = tid; id < K * DD; id += nthreads) {
      const int k = id / DD;
      const int d = (id - k * DD) / D;
      const int e = id - k * DD - d * D;
      const int lo = min(d, e), hi = max(d, e);
      const float2 s = Su[k * P + lo * D - lo * (lo - 1) / 2 + hi - lo];
      const float den = fmaxf(wsum[k], tiny);
      const float re = float(D) * s.x / den;
      const float im = float(D) * s.y / den;
      S[id] = d == e ? make_float2(re, 0.f)
                     : make_float2(re, d < e ? im : -im);
    }
    for (int k = tid; k < K; k += nthreads)
      wgt[k] = mixture_weight(wsum, k, K, has_sal, float(T));
    __syncthreads();

    // ---- eigh: the column Jacobi, a lane per column, floor(32 / D)
    // classes to a warp ---------------------------------------------------
    for (int k0 = warp * kClassesPerWarp; k0 < K;
         k0 += nwarps * kClassesPerWarp) {
      const bool jown = jslot < kClassesPerWarp && k0 + jslot < K;
      const int k = jown ? k0 + jslot : 0;
      const float2* Sk = S + k * DD;
      const float2* Vk = V + k * DD;
      float2 a[D], v[D];
      if (!jown) {
#pragma unroll
        for (int i = 0; i < D; ++i) {
          a[i] = make_float2(0.f, 0.f);
          v[i] = make_float2(0.f, 0.f);
        }
      } else if (warm) {
        // A = V^H S V: this lane's column V^H (S v_j)
        float2 sv[D];
#pragma unroll
        for (int i = 0; i < D; ++i) v[i] = Vk[i * D + jc];
#pragma unroll
        for (int r = 0; r < D; ++r) {
          float2 acc = make_float2(0.f, 0.f);
#pragma unroll
          for (int b = 0; b < D; ++b)
            acc = c_add(acc, c_mul(Sk[r * D + b], v[b]));
          sv[r] = acc;
        }
#pragma unroll
        for (int i = 0; i < D; ++i) {
          float2 acc = make_float2(0.f, 0.f);
#pragma unroll
          for (int r = 0; r < D; ++r)
            acc = c_add(acc, c_conj_mul(Vk[r * D + i], sv[r]));
          a[i] = i == jc ? make_float2(acc.x, 0.f) : acc;
        }
      } else {
#pragma unroll
        for (int i = 0; i < D; ++i) {
          a[i] = Sk[i * D + jc];
          v[i] = make_float2(i == jc ? 1.f : 0.f, 0.f);
        }
      }
      column_jacobi<D>(a, v, jbase, jc, jown, warm ? warm_sweeps : sweeps);
      float lam = 0.f;
#pragma unroll
      for (int i = 0; i < D; ++i)
        if (i == jc) lam = a[i].x;
      float lmax = -INFINITY;
      for (int m = 0; m < D; ++m)
        lmax = fmaxf(lmax, __shfl_sync(kFull, lam, jbase + m));
      lmax = fmaxf(lmax, tiny);
      const float ev = fmaxf(lam / lmax, eigenvalue_floor);
      float ld = 0.f;
      for (int m = 0; m < D; ++m)
        ld += logf(__shfl_sync(kFull, ev, jbase + m));
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
    }
    __syncthreads();

    // ---- E-step: a thread per frame -----------------------------------
    const bool last = it == iterations - 1;
    const float eps = last ? 0.f : affiliation_eps;
    for (int t = tid; t < T; t += nthreads) {
      float2 yf[D];
#pragma unroll
      for (int d = 0; d < D; ++d) yf[d] = ys[d * Tp + t];
      e_step_frame(
          [&](int k) { return projection_form<D>(yf, Wh + k * DD); }, logdet,
          wgt, mask != nullptr ? mask + t : nullptr, T, eps, aw + t, wq + t,
          T, D, K);
      const float s = has_sal ? sal[t] : 1.f;
      for (int k = 0; k < K; ++k) {
        const float a = aw[k * T + t];
        if (last) {
          aff_out[n * KT + size_t(k) * T + t] = a;
        } else {
          aw[k * T + t] = a * s;
          wq[k * T + t] = a * s / fmaxf(wq[k * T + t], 10.f * tiny);
        }
      }
    }
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
