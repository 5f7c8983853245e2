// Whole-fit complex Bingham mixture EM: every EM iteration of a fit in ONE
// launch.
//
// Replaces pb_bss_tpu/ops/pallas_cbmm_loop.py:cbmm_em_full (the Pallas TPU
// kernel, frequency bins in the lanes, the chord solver of
// pallas_bingham.py inlined). Frequency bins are independent, so one CTA
// owns one (utterance, bin) and runs all iterations for it:
//
//   load y (D x T complex), the initial affiliations and the optional
//   saliency into shared memory once; then per iteration
//     M-step  a = aff * saliency, the weight sums and the K D(D+1)/2
//             Hermitian scatter sums sum_t a y y^H / max(asum, tiny)
//             (m_stats, em_common.cuh), the mixture weight (the mean over
//             T, or with saliency the sums L1-normalized over classes),
//     eigh    the K D x D Jacobis (a warp per class, jacobi.cuh): cold at
//             `sweeps` in iteration 0, then warm-started from the
//             previous eigenbasis at `warm_sweeps`,
//     sort    the moments max(eigenvalue, 0) ascending by a bubble
//             network that swaps the eigenvector columns with them, then
//             the minimum spacing spacing_eps,
//     solve   the moment inversion grad log c(lambda) = s by chord
//             Gauss-Newton: iteration 0 from the -1/s start floored at
//             -(cap_init - j) with `cold_rounds` rounds of `cold_steps`
//             steps, later iterations one round of `warm_steps` from the
//             previous eigenvalues; then the floor at -max_concentration
//             and the spacing again when it is finite,
//     log c   one more cascade: log 2 + D log pi + log exp[lambda],
//     E-step  the forms B_k = V diag(lambda) V^H (a warp per class), then
//             threads over T: y^H B_k y - log c_k, max-shift softmax with
//             the weight, max(den, tiny), the clip to [eps, 1 - eps]
//             except in the last iteration, which is CBMM.predict.
//
// What bounds it on the H100: the cascades of the solve, a serial chain of
// 3 (1 + 5 + 10) + 1 cascades per class in the first iteration and
// 1 + 5 + 16 + 1 after it at D=6 (486 per 20-iteration fit), each of 13
// Taylor terms and 15 squarings (E, X) <- (E E, E X + X E). The first
// design (a cascade on 8 lanes, a row each, one after another) was bound
// by the latency of that chain, not by its ~12 kFLOP a cascade nor by the
// y it reads once. This one shortens the chain, and is then bound by the
// shared-memory loads through which a warp exchanges a cascade's entries
// (~650 a cascade at D=6; PERF.md):
//
//   * a cascade runs on a whole warp (warp_cascade): lanes over the
//     entries of X (D^2) and of E's upper triangle (D(D+1)/2), a segment
//     of 2 entries of one row a lane at D=6 (1 at D <= 4, 4 at D >= 7);
//     each Taylor term and each squaring publishes the entries to the
//     warp's exchange rows in shared memory (a stride of 9 floats keeps
//     the loads of a row and of a column free of bank conflicts), and a
//     lane forms its segment from its rows i of E and X and the columns
//     j. Each entry's sum runs in the row-per-lane cascade's order
//     (bingham.cuh, m ascending; E's lower triangle and a zero row stand
//     for the products that cascade multiplies by exact zeros, which
//     leave an FMA's sum as it is), so both give the same values (on the
//     card the same bits at D=6; at D=8 they part in the last bits);
//   * a chord round's D finite-difference cascades (the base point and
//     the D - 1 shifts) of all K classes run at once, a warp each, over
//     the CTA's warps; the first thread of each class then forms the
//     Jacobian, and the inverse of J^T J by the unrolled Cholesky, as
//     before; the round's steps run a warp per class, lane a forming
//     (J^T r)_a and the update of u_a;
//   * the CTA's warps are the host's choice (ops/cbmm_loop._threads): at
//     least one per class, and as many as the bins that an SM's shared
//     memory holds leave room for.
//
// The M-step and the E-step are the first design's (at D=6 the kernel
// gives that design's results bit for bit); K2's register scatter and
// column Jacobi (em_iter.cuh) measured no faster here (PERF.md).
//
// A bin's working set lives in shared memory,
// 4 (152 W + 163 K + K T) + 8 (D T + 3 K D^2), plus 4 T with
// saliency, for W warps (ops/cbmm_loop.kernel_smem_bytes); at one warp it
// stays within the gate's formula (ops/cbmm_loop.smem_bytes), and the
// host takes fewer warps where more would not fit.
//
// There is no padding: loops run over the real T and the grid has
// exactly one CTA per bin.
//
// Layouts (all contiguous): y (N, D, T) complex64 as float2; aff0/aff
// (N, K, T) float; sal (N, T); weight/logz (N, K); lamb (N, K, D);
// vec (N, K, D, D) complex64, eigenvectors in columns.
#include <cfloat>
#include <cmath>
#include <cuda_runtime.h>

#include "bingham.cuh"
#include "em_common.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

constexpr int kMaxThreads = 256;
constexpr int kExchange = 152;  // floats of a warp's exchange rows (E, X, 0)
constexpr int kClassFloats = 163;  // per-class scalars and solve state

inline size_t cbmm_smem_bytes(int D, int K, int T, bool has_sal, int warps) {
  return sizeof(float) * (size_t(kExchange) * warps +
                          size_t(kClassFloats) * K + size_t(K) * T +
                          (has_sal ? size_t(T) : 0)) +
         sizeof(float2) * (size_t(D) * T + 3 * size_t(K) * D * D);
}

// The entries of the cascade that this lane forms: a segment of kSeg
// consecutive entries (i, j0 .. j0 + kSeg - 1) of one row of X or of E's
// upper triangle, so that the lane loads its rows once for all of them
// (segments of X first, row by row, then of E; lanes past the last
// segment form nothing).
template <int D>
struct CascadeLanes {
  static constexpr int kSeg = D <= 4 ? 1 : (D <= 6 ? 2 : 4);
  int i, j0;
  bool x, ok;

  __host__ __device__ static constexpr int segments() {
    int n = 0;
    for (int r = 0; r < D; ++r)
      n += (D + kSeg - 1) / kSeg + (D - r + kSeg - 1) / kSeg;
    return n;
  }
  __device__ __forceinline__ CascadeLanes() {
    static_assert(segments() <= 32, "a warp forms every segment");
    const int lane = threadIdx.x & 31;
    int seg = 0;
    i = 0;
    j0 = 0;
    x = false;
    ok = false;
    for (int r = 0; r < D; ++r)
      for (int c = 0; c < D; c += kSeg, ++seg)
        if (seg == lane) {
          i = r;
          j0 = c;
          x = true;
          ok = true;
        }
    for (int r = 0; r < D; ++r)
      for (int c = r; c < D; c += kSeg, ++seg)
        if (seg == lane) {
          i = r;
          j0 = c;
          ok = true;
        }
  }
};

// The warp's exchange rows: E (or T) and X (or TX), 8 rows at stride
// kRow each, then a row of zeros. The odd stride puts the rows of a
// column, and the columns of a row, in distinct banks.
constexpr int kRow = 9;
constexpr int kXRows = 8 * kRow;
constexpr int kZeroRow = 2 * kXRows;
static_assert(kZeroRow + 8 <= kExchange, "the exchange rows fit");

// grad log Z at the ascending nodes lam (each <= 0) into g (every lane
// receives all D entries), by one warp; returns dd = exp[lam_1..lam_D]
// (floored at FLT_MIN). The block-Frechet cascade of bingham.cuh's
// chord_cascade (13 Taylor terms, 15 squarings at the scaling 2^-15)
// with the entries over the lanes: each Taylor term and each squaring
// publishes the lanes' entries to the warp's exchange rows ex and forms
// the new ones from them. E's (and T's) lower triangle and the zero row
// in ex must hold zeros (only E's upper triangle is ever written). Every
// lane of the warp must call it with the same lam.
template <int D>
__device__ float warp_cascade(const CascadeLanes<D>& L,
                              const float (&lam)[D], float (&g)[D],
                              float* ex) {
  constexpr int NS = CascadeLanes<D>::kSeg;
  float* Eb = ex;
  float* Xb = ex + kXRows;
  const int i = L.i;
  const float cs = 1.f / 32768.f;
  float t[NS], v[NS], lj[NS];
  bool ok[NS];
  // Taylor init: term_1 = A = cs J (row i: cs lam_i at i, cs at i + 1);
  // E = I + A; the Frechet part starts as cs e_{D-1} e_0^T
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int j = L.j0 + s;
    ok[s] = L.ok && j < D;
    lj[s] = lam[0];
#pragma unroll
    for (int q = 1; q < D; ++q)
      if (q == j) lj[s] = lam[q];
    if (L.x) {
      t[s] = (i == D - 1 && j == 0) ? cs : 0.f;
      v[s] = t[s];
    } else {
      const float a = (j == i) ? cs * lj[s] : (j == i + 1 ? cs : 0.f);
      t[s] = a;
      v[s] = (j == i ? 1.f : 0.f) + a;
    }
  }
  float* own = (L.x ? Xb : Eb) + i * kRow + L.j0;  // the lane's segment
#pragma unroll 1
  for (int k = 2; k <= kTaylorTerms; ++k) {
    const float csk = float(1.0 / 32768.0 / k);
    __syncwarp();
#pragma unroll
    for (int s = 0; s < NS; ++s)
      if (ok[s]) own[s] = t[s];
    __syncwarp();
    // M A = cs (M * lam_cols + shift(M)): entry (i, j) from (i, j) and
    // (i, j - 1) of the previous term (the segment's own, or its left
    // neighbour's); TX's column 0 also takes T's last column
    const float t_last = Eb[i * kRow + D - 1];
    const bool has_left = L.j0 > (L.x ? 0 : i);
    const float left_v = own[has_left ? -1 : 0];
    const float left = has_left ? left_v : 0.f;
#pragma unroll
    for (int s = NS - 1; s >= 0; --s) {
      const int j = L.j0 + s;
      const float prev = s > 0 ? t[s - 1] : left;
      float tn;
      if (L.x)
        tn = ((j == 0 ? t_last : 0.f) + t[s] * lj[s] + prev) * csk;
      else
        tn = (t[s] * lj[s] + prev) * csk;
      t[s] = tn;
      v[s] += tn;
    }
  }
  // squarings: (E, X) <- (E E, E X + X E); E stays upper triangular.
  // X: sum_m E[i][m] X[m][j] + X[i][m] E[m][j]; E: sum_m E[i][m] E[m][j]
  // + 0 E[m][j] (the zero row). E's lower triangle holds zeros, so the
  // products outside i <= m (first) and m <= j (second) are exact zeros
  // and leave each sum as the row-per-lane order has it
  const float* r2p = L.x ? Xb + i * kRow : ex + kZeroRow;
  const float* Bp = (L.x ? Xb : Eb) + L.j0;
#pragma unroll 1
  for (int q = 0; q < kSquarings; ++q) {
    __syncwarp();
#pragma unroll
    for (int s = 0; s < NS; ++s)
      if (ok[s]) own[s] = v[s];
    __syncwarp();
    float re[D], r2[D];
#pragma unroll
    for (int m = 0; m < D; ++m) {
      re[m] = Eb[i * kRow + m];
      r2[m] = r2p[m];
    }
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      float acc = 0.f;
#pragma unroll
      for (int m = 0; m < D; ++m) {
        acc = fmaf(re[m], Bp[m * kRow + s], acc);
        acc = fmaf(r2[m], Eb[m * kRow + L.j0 + s], acc);
      }
      v[s] = acc;
    }
  }
  __syncwarp();
#pragma unroll
  for (int s = 0; s < NS; ++s)
    if (ok[s]) own[s] = v[s];
  __syncwarp();
  const float dd = fmaxf(Eb[D - 1], FLT_MIN);
  const float inv_dd = 1.f / dd;
#pragma unroll
  for (int q = 0; q < D; ++q) g[q] = Xb[q * kRow + q] * inv_dd;
  __syncwarp();
  return dd;
}

// Registers: up to 64 a thread for D <= 6 (four 256-thread CTAs, or eight
// of 128, an SM); more for larger D.
template <int D>
__global__ void __launch_bounds__(kMaxThreads, D <= 6 ? 4 : 2)
cbmm_em_full_kernel(const float2* __restrict__ y,
                    const float* __restrict__ aff0,
                    const float* __restrict__ sal_in,
                    float* __restrict__ weight_out,
                    float* __restrict__ lamb_out,
                    float2* __restrict__ vec_out,
                    float* __restrict__ logz_out,
                    float* __restrict__ aff_out, int K, int T,
                    int iterations, int sweeps, int warm_sweeps,
                    int cold_rounds, int cold_steps, int warm_steps,
                    float spacing_eps, float lower, float upper,
                    float fd_step, float affiliation_eps, float cap_init,
                    float max_concentration, float log2pi_d) {
  extern __shared__ float4 smem_raw[];
  constexpr int DD = D * D;
  constexpr int D1 = D - 1;
  const int nwarps = blockDim.x >> 5;
  // 16-byte aligned first: the exchange rows and the per-class solve
  // state, then y and the per-class matrices, then the rest
  float* exch = reinterpret_cast<float*>(smem_raw);  // W * 152
  float* Jm = exch + kExchange * nwarps;             // K * 64 Jacobians
  // K * 64: the gradients of a round's cascades, then the inverses
  float* G = Jm + 64 * K;
  float* Mi = G;
  float* lamb = G + 64 * K;      // K * 8 eigenvalues
  float* sreg = lamb + 8 * K;    // K * 8 moments
  float* U = sreg + 8 * K;       // K * 8 diffs u
  float* inv_h = U + 8 * K;      // K * 8 finite-difference 1 / h
  float2* ys = reinterpret_cast<float2*>(inv_h + 8 * K);  // D * T
  float2* S = ys + size_t(D) * T;   // K * DD scatter / moments
  float2* V = S + K * DD;           // K * DD eigenvectors
  float2* C = V + K * DD;           // K * DD scatter sums, then B
  float* aff = reinterpret_cast<float*>(C + K * DD);  // K * T
  float* sal = aff + size_t(K) * T;                   // T, with saliency
  float* wsum = sal + (sal_in != nullptr ? T : 0);    // K
  float* wgt = wsum + K;                              // K
  float* logz = wgt + K;                              // K

  const size_t n = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t DT = size_t(D) * T;
  const size_t KT = size_t(K) * T;
  const bool has_sal = sal_in != nullptr;
  float* ex = exch + kExchange * warp;
  const CascadeLanes<D> lanes;

  // the exchange rows start (and E's lower triangle stays) at zero
  for (int i = tid; i < kExchange * nwarps; i += blockDim.x) exch[i] = 0.f;
  for (size_t i = tid; i < DT; i += blockDim.x) ys[i] = y[n * DT + i];
  for (size_t i = tid; i < KT; i += blockDim.x) aff[i] = aff0[n * KT + i];
  if (has_sal)
    for (int t = tid; t < T; t += blockDim.x) sal[t] = sal_in[n * T + t];
  __syncthreads();

  for (int it = 0; it < iterations; ++it) {
    const bool warm = it > 0;

    // ---- M-step: a <- aff * saliency, the sums and the scatter -------
    if (has_sal) {
      for (size_t i = tid; i < KT; i += blockDim.x) aff[i] *= sal[i % T];
      __syncthreads();
    }
    m_stats(ys, aff, aff, S, wsum, nullptr, D, K, T, 1.f);
    for (int k = tid; k < K; k += blockDim.x)
      wgt[k] = mixture_weight(wsum, k, K, has_sal, float(T));
    __syncthreads();

    // ---- eigendecomposition (a warp per class): the moments on S's
    // diagonal -------------------------------------------------------------
    for (int k = warp; k < K; k += nwarps) {
      if (warm) {
        warp_warm_rotate(S + k * DD, V + k * DD, C + k * DD, D);
        warp_jacobi(S + k * DD, V + k * DD, D, warm_sweeps);
      } else {
        warp_set_identity(V + k * DD, D);
        warp_jacobi(S + k * DD, V + k * DD, D, sweeps);
      }
    }
    __syncthreads();

    // ---- ascending sort, spacing, the solve's start (a warp per class)
    for (int k = warp; k < K; k += nwarps) {
      float2* Sk = S + k * DD;
      float2* Vk = V + k * DD;
      float sn[D];
#pragma unroll
      for (int j = 0; j < D; ++j) sn[j] = fmaxf(Sk[j * D + j].x, 0.f);
#pragma unroll
      for (int pass = 0; pass < D - 1; ++pass) {
#pragma unroll
        for (int j = 0; j < D - 1 - pass; ++j) {
          if (sn[j] > sn[j + 1]) {  // the same decision on every lane
            const float tmp = sn[j];
            sn[j] = sn[j + 1];
            sn[j + 1] = tmp;
            if (lane < D) {  // each lane swaps within its own row
              const float2 v = Vk[lane * D + j];
              Vk[lane * D + j] = Vk[lane * D + j + 1];
              Vk[lane * D + j + 1] = v;
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) {
        float s[D], lam[D];
        float acc = sn[0];
        s[0] = acc;
#pragma unroll
        for (int j = 1; j < D; ++j) {
          acc += fmaxf(sn[j] - sn[j - 1], spacing_eps);
          s[j] = acc;
        }
#pragma unroll
        for (int j = 0; j < D; ++j) {
          sreg[k * 8 + j] = s[j];
          // warm: the previous eigenvalues; cold: lambda ~ -1/s, the
          // largest pinned to 0, floored into the cascade's exact domain
          if (warm) {
            lam[j] = lamb[k * 8 + j];
          } else {
            const float x0 = (j < D - 1) ? -1.f / fmaxf(s[j], 1e-12f) : 0.f;
            lam[j] = fmaxf(x0, -(cap_init - float(j)));
          }
        }
#pragma unroll
        for (int j = 0; j < D1; ++j)
          U[k * 8 + j] = clip_diff(lam[j] - lam[j + 1], lower, upper);
      }
    }
    __syncthreads();

    // ---- moment inversion: chord rounds ----------------------------------
    const int rounds = warm ? 1 : cold_rounds;
    const int steps = warm ? warm_steps : cold_steps;
    for (int r = 0; r < rounds; ++r) {
      // the round's finite-difference cascades, a warp each: c = 0 at u,
      // c > 0 at u shifted in diff c - 1 (relative step fd_step max(1, |u|);
      // a column whose clipped step is below 1% of the intended one is
      // zeroed)
      for (int task = warp; task < K * D; task += nwarps) {
        const int k = task / D;
        const int c = task - k * D;
        float us[D1], lam[D], g[D];
        float h = 0.f, h_int = 0.f;
#pragma unroll
        for (int j = 0; j < D1; ++j) {
          const float u = U[k * 8 + j];
          const float shift =
              (j == c - 1) ? fd_step * fmaxf(1.f, fabsf(u)) : 0.f;
          us[j] = c == 0 ? u : clip_diff(u + shift, lower, upper);
          h += us[j] - u;
          h_int += shift;
        }
        lam_of_u<D>(us, lam);
        warp_cascade<D>(lanes, lam, g, ex);
        if (lane == 0) {
#pragma unroll
          for (int d = 0; d < D; ++d) G[k * 64 + c * 8 + d] = g[d];
          if (c > 0) {
            const bool dead = fabsf(h) < 0.01f * fabsf(h_int);
            inv_h[k * 8 + c - 1] = dead ? 0.f : 1.f / h;
          }
        }
      }
      __syncthreads();
      // the Jacobian and the inverse normal matrix, a thread per class
      for (int k = tid; k < K; k += blockDim.x) {
        float* Jk = Jm + k * 64;
        const float* Gk = G + k * 64;
#pragma unroll
        for (int c = 0; c < D1; ++c)
#pragma unroll
          for (int d = 0; d < D; ++d)
            Jk[c * 8 + d] = (Gk[(c + 1) * 8 + d] - Gk[d]) * inv_h[k * 8 + c];
        normal_inverse<D>(Jk, Mi + k * 64);  // over the gradients
      }
      __syncthreads();
      // the chord steps u <- clip(u - clip(Minv J^T (g(u) - s), +-1e3)), a
      // warp per class: lane a < D - 1 holds row a of J and of Minv and
      // forms (J^T r)_a and the update of u_a; every lane then takes u by
      // shuffle
      for (int k = warp; k < K; k += nwarps) {
        const int a = lane < D1 ? lane : 0;
        float u[D1], s[D], lam[D], g[D], jr[D], mr[D1];
#pragma unroll
        for (int j = 0; j < D1; ++j) {
          u[j] = U[k * 8 + j];
          mr[j] = Mi[k * 64 + a * 8 + j];
        }
#pragma unroll
        for (int j = 0; j < D; ++j) {
          s[j] = sreg[k * 8 + j];
          jr[j] = Jm[k * 64 + a * 8 + j];
        }
#pragma unroll 1
        for (int st = 0; st < steps; ++st) {
          lam_of_u<D>(u, lam);
          warp_cascade<D>(lanes, lam, g, ex);
          float b = 0.f;
#pragma unroll
          for (int d = 0; d < D; ++d) b += jr[d] * (g[d] - s[d]);
          float delta = 0.f;
#pragma unroll
          for (int q = 0; q < D1; ++q)
            delta += mr[q] * __shfl_sync(kFullMask, b, q);
          delta = fminf(fmaxf(delta, -1e3f), 1e3f);
          float ua = u[0];
#pragma unroll
          for (int q = 1; q < D1; ++q)
            if (q == a) ua = u[q];
          ua = clip_diff(ua - delta, lower, upper);
#pragma unroll
          for (int q = 0; q < D1; ++q) u[q] = __shfl_sync(kFullMask, ua, q);
        }
        __syncwarp();
        if (lane == 0)
#pragma unroll
          for (int j = 0; j < D1; ++j) U[k * 8 + j] = u[j];
      }
      __syncthreads();
    }

    // ---- the eigenvalues, the bound and log c (a warp per class) ------
    for (int k = warp; k < K; k += nwarps) {
      float u[D1], lam[D], g[D];
#pragma unroll
      for (int j = 0; j < D1; ++j) u[j] = U[k * 8 + j];
      lam_of_u<D>(u, lam);
      if (max_concentration > 0.f) {
        // the floor can collapse the lowest eigenvalues onto -mc: space
        // them again
        float prev = fmaxf(lam[0], -max_concentration);
        float acc = prev;
        lam[0] = acc;
#pragma unroll
        for (int j = 1; j < D; ++j) {
          const float node = fmaxf(lam[j], -max_concentration);
          acc += fmaxf(node - prev, spacing_eps);
          prev = node;
          lam[j] = acc;
        }
      }
      const float dd = warp_cascade<D>(lanes, lam, g, ex);
      if (lane == 0) {
#pragma unroll
        for (int j = 0; j < D; ++j) lamb[k * 8 + j] = lam[j];
        logz[k] = log2pi_d + logf(dd);
      }
    }
    __syncthreads();

    // ---- E-step ------------------------------------------------------
    for (int k = warp; k < K; k += nwarps)
      warp_bingham_form(V + k * DD, lamb + k * 8, C + k * DD, D);
    __syncthreads();
    const float eps = (it == iterations - 1) ? 0.f : affiliation_eps;
    for (int t = tid; t < T; t += blockDim.x)
      bingham_e_step_frame([&](int d) { return ys[d * T + t]; }, C, logz,
                           wgt, eps, aff + t, T, D, K);
    __syncthreads();
  }

  for (int k = tid; k < K; k += blockDim.x) {
    weight_out[n * K + k] = wgt[k];
    logz_out[n * K + k] = logz[k];
  }
  for (int i = tid; i < K * D; i += blockDim.x)
    lamb_out[n * K * D + i] = lamb[(i / D) * 8 + i % D];
  for (int i = tid; i < K * DD; i += blockDim.x)
    vec_out[n * K * DD + i] = V[i];
  for (size_t i = tid; i < KT; i += blockDim.x) aff_out[n * KT + i] = aff[i];
}

template <int D>
int launch(const float2* y, const float* aff0, const float* sal,
           float* weight, float* lamb, float2* vec, float* logz, float* aff,
           int N, int K, int T, int threads, int iterations, int sweeps,
           int warm_sweeps, int cold_rounds, int cold_steps, int warm_steps,
           float spacing_eps, float lower, float upper, float fd_step,
           float affiliation_eps, float cap_init, float max_concentration,
           float log2pi_d, cudaStream_t stream) {
  const size_t bytes =
      cbmm_smem_bytes(D, K, T, sal != nullptr, threads / 32);
  cudaError_t err = cudaFuncSetAttribute(
      cbmm_em_full_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(bytes));
  if (err != cudaSuccess) return int(err);
  cbmm_em_full_kernel<D><<<N, threads, bytes, stream>>>(
      y, aff0, sal, weight, lamb, vec, logz, aff, K, T, iterations, sweeps,
      warm_sweeps, cold_rounds, cold_steps, warm_steps, spacing_eps, lower,
      upper, fd_step, affiliation_eps, cap_init, max_concentration,
      log2pi_d);
  return int(cudaGetLastError());
}

}  // namespace

// Launch the whole-fit Bingham EM on `stream` for N independent bins
// (2 <= D <= 8), `threads` threads a bin (a multiple of 32, at most 256).
// sal may be null; max_concentration <= 0 means unbounded. Returns a
// cudaError_t (0 on success; cudaErrorInvalidValue for an unsupported D
// or CTA); neither synchronizes nor allocates.
extern "C" int cbmm_em_full_launch(
    const void* y, const void* aff0, const void* sal, void* weight,
    void* lamb, void* vec, void* logz, void* aff, int N, int D, int K,
    int T, int threads, int iterations, int sweeps, int warm_sweeps,
    int cold_rounds, int cold_steps, int warm_steps, float spacing_eps,
    float lower, float upper, float fd_step, float affiliation_eps,
    float cap_init, float max_concentration, float log2pi_d, void* stream) {
  if (threads % 32 != 0 || threads < 32 || threads > kMaxThreads)
    return int(cudaErrorInvalidValue);
#define CBMM_LAUNCH(DIM)                                                     \
  return launch<DIM>(                                                       \
      static_cast<const float2*>(y), static_cast<const float*>(aff0),       \
      static_cast<const float*>(sal), static_cast<float*>(weight),          \
      static_cast<float*>(lamb), static_cast<float2*>(vec),                 \
      static_cast<float*>(logz), static_cast<float*>(aff), N, K, T,         \
      threads, iterations, sweeps, warm_sweeps, cold_rounds, cold_steps,    \
      warm_steps, spacing_eps, lower, upper, fd_step, affiliation_eps,      \
      cap_init, max_concentration, log2pi_d,                                \
      static_cast<cudaStream_t>(stream))
  switch (D) {
    case 2: CBMM_LAUNCH(2);
    case 3: CBMM_LAUNCH(3);
    case 4: CBMM_LAUNCH(4);
    case 5: CBMM_LAUNCH(5);
    case 6: CBMM_LAUNCH(6);
    case 7: CBMM_LAUNCH(7);
    case 8: CBMM_LAUNCH(8);
    default: return int(cudaErrorInvalidValue);
  }
#undef CBMM_LAUNCH
}
