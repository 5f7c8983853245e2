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
//            frames go in tiles through shared memory (one tile where the
//            host's tile holds all T: then a CTA that owns one bin keeps
//            y and the embedding resident across iterations and reads
//            them from device memory once);
//     E-step a thread per frame, the frame in registers, D a template
//            parameter: the spatial quadratic form as the projection
//            q = sum_i |v_i^H y|^2 / lam_i (never through the assembled
//            inverse, which cancels once an eigenvalue sits at the floor),
//            -D log q - logdet; the spectral log-pdf, vMF
//            kappa mu.e / |e| - log C or Gaussian (P m).e - e.diag(P).e / 2
//            - const; their weighted sum, the max-shift softmax with the
//            mixture weight, max(den, tiny), the clip to [eps, 1 - eps];
//     sums   two passes over the tile's frames, warps over frames, a
//            group of classes in registers, each ending in one cross-warp
//            reduction, warp by warp in a fixed order, added tile by tile
//            (runs repeat bit for bit): lanes over the upper-triangle
//            entries of sum_t a / max(q, 10 tiny) y y^H; lanes over the
//            embedding's dimensions for the resultants sum_t a e on the
//            raw embedding (and, for the Gaussian, the second moments
//            sum_t a e^2) and one more lane for sum_t a;
//     M-step the spectral rows (resultants, sum_t a, second moments) to a
//            (N, A) buffer; the weight sum_t a / max(sum_k sum_t a, tiny);
//            the covariance D S / max(asum, tiny) (a division); the column
//            Jacobi in registers (em_iter.cuh's column_eigh: a lane owns
//            one column of one class, all K classes of a bin on one warp
//            where K D <= 32) warm from the previous eigenbasis, `sweeps`
//            sweeps in iteration 0 and `warm_sweeps` after it, in the
//            plain twin's cyclic order, its rotations in 2 D - 3 steps of
//            disjoint ones (the wavefront; two sweeps from a matrix that
//            the new statistics moved need not converge, and the order
//            decides what they leave off the diagonal: the parallel
//            round-robin order parts from the twin by 4.3e-5 at D=8); the
//            eigenvalues max-normalized and floored; the state back to
//            device memory;
//   sync     grid.sync();
//   spectral the CTA c (striding over the utterances' classes) adds the
//            rows of class k of utterance u (c = u K + k: its resultants,
//            its sum_t a, its second moments) over the utterance's bins in
//            a fixed order (threads over the rows and groups of bins, then
//            the groups in order), writes them to the iteration's
//            accumulator and, unless the iteration is the last, runs the
//            class's closed-form spectral M-step: Banerjee's vMF (log C
//            interpolated in a sqrt-spaced table, two loads) or the
//            Gaussian moment match; then grid.sync() again.
//
// K CTAs per utterance do the spectral step, each for its class (the
// M-step of one class reads only that class's rows), with a second sync,
// rather than every CTA redundantly: a CTA's bins span every utterance of
// a batch, so the redundant variant would read the whole (N, A) buffer in
// every CTA (1 MB at B=8) each iteration. (One CTA an utterance, all its
// classes' rows, took 1.2842-1.3056 ms a 19-iteration fit at config 3
// against 1.2207-1.2560 on an H100; at B=8 the two were even.)
//
// What bounds it on the H100: per iteration the E-step's ~1 kFLOP a frame
// and the sums (0.15 GFLOP at F=513, T=300, D=6, E=20), against a serial
// part: a bin's Jacobi on one warp, the spectral step and two grid-wide
// syncs. So it takes as many CTAs as an SM's registers and the host's
// tile leave room for (four an SM at D <= 6: 528 >= 513 bins, one round
// of bins an iteration, where two CTAs an SM took two), a tile of all T
// where it fits (no partial second tile), the sums in registers with one
// reduction a pass (not a shuffle reduction per sum), a bin's Jacobis on
// one warp in registers, the spectral step on K CTAs an utterance, and
// unrolls over D. A launch that cannot be co-resident fails with
// cudaErrorCooperativeLaunchTooLarge, which the wrapper raises.
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

#include "em_iter.cuh"
#include "integration.cuh"

namespace cg = cooperative_groups;

namespace {

using integration::kGaussian;
using integration::kThreads;
using integration::kVmf;
constexpr float kLog2Pi = 1.8378770664093453f;  // log(2 pi)

__host__ __device__ inline int acc_rows(int K, int E, int mode) {
  return K * E + K + (mode == kGaussian ? K * E : 0);
}

// floats of the work buffer: the tile's posterior and scatter weights
// (2 K tile), which the spectral step reuses for its partial sums and its
// accumulator row
__host__ __device__ inline int work_floats(int K, int E, int tile,
                                           int mode) {
  const int A = acc_rows(K, E, mode);
  const int spectral = (A < kThreads ? kThreads : A) + A;
  return 2 * K * tile > spectral ? 2 * K * tile : spectral;
}

inline size_t loop_smem_bytes(int D, int K, int E, int tile, int mode) {
  const size_t P = size_t(D) * (D + 1) / 2;
  const size_t Tr = size_t(tile | 1);
  const size_t g = mode == kGaussian ? 1 : 0;
  return sizeof(float2) * (size_t(D) * Tr + 3 * size_t(K) * D * D + K * P) +
         sizeof(float) * (size_t(E) * Tr + work_floats(K, E, tile, mode) +
                          size_t(K) * E * (2 + 2 * g) + 5 * size_t(K) +
                          size_t(K) * D);
}

// The sums of one tile of nt frames, by the whole block, added into the
// bin's accumulators (assigned at the first tile) in two passes over the
// frames, each with warps over frames, a group of kScatterGroup classes in
// registers and then a cross-warp reduction warp by warp in a fixed
// order:
//   scatter   lanes over the upper-triangle entries r = (d, e):
//             Su[k * P + r] = sum_t wq y_d conj(y_e);
//   embedding lanes over the dimensions (32 a pass) and one more lane for
//             the affiliation sum: res[k * E + e] = sum_t aw e, for the
//             Gaussian m2[k * E + e] = sum_t aw e^2 on the same lane, and
//             asum[k] = sum_t aw.
// Each pass runs the same code on every lane (no per-lane kind of item).
// Ends with the block synchronized.
template <int D>
__device__ void tile_sums(const float2* ys, const float* embs, int Tr,
                          const float* aw, const float* wq, int tile, int nt,
                          float2* Su, float* asum, float* res, float* m2,
                          int K, int E, bool gaussian, bool first) {
  constexpr int P = D * (D + 1) / 2;
  constexpr int SP = (P + 31) / 32;  // scatter entries a lane
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  // this lane's scatter entries (d, e) of r = lane + 32 j (past P: (0, 0),
  // unused)
  int ed[SP], ee[SP];
#pragma unroll
  for (int j = 0; j < SP; ++j) {
    const int r = lane + 32 * j;
    upper_entry(r < P ? r : 0, D, &ed[j], &ee[j]);
    ed[j] *= Tr;
    ee[j] *= Tr;
  }
  for (int g0 = 0; g0 < K; g0 += kScatterGroup) {
    const int G = min(kScatterGroup, K - g0);
    // ---- the scatter ------------------------------------------------------
    {
      float2 acc[SP][kScatterGroup];
#pragma unroll
      for (int j = 0; j < SP; ++j)
#pragma unroll
        for (int c = 0; c < kScatterGroup; ++c)
          acc[j][c] = make_float2(0.f, 0.f);
#pragma unroll 2
      for (int t = warp; t < nt; t += nwarps) {
        float w[kScatterGroup];
#pragma unroll
        for (int c = 0; c < kScatterGroup; ++c)
          w[c] = c < G ? wq[(g0 + c) * tile + t] : 0.f;
#pragma unroll
        for (int j = 0; j < SP; ++j) {
          const float2 p = c_mul_conj(ys[ed[j] + t], ys[ee[j] + t]);
#pragma unroll
          for (int c = 0; c < kScatterGroup; ++c) {
            acc[j][c].x = fmaf(w[c], p.x, acc[j][c].x);
            acc[j][c].y = fmaf(w[c], p.y, acc[j][c].y);
          }
        }
      }
      for (int w = 0; w < nwarps; ++w) {
        if (warp == w) {
          const bool assign = first && w == 0;
#pragma unroll
          for (int j = 0; j < SP; ++j) {
            const int r = lane + 32 * j;
            if (r >= P) continue;
#pragma unroll
            for (int c = 0; c < kScatterGroup; ++c) {
              if (c >= G) continue;
              float2* su = Su + (g0 + c) * P + r;
              *su = assign ? acc[j][c] : c_add(*su, acc[j][c]);
            }
          }
        }
        __syncthreads();
      }
    }
    // ---- the embedding's sums and the affiliation sum -----------------------
    for (int e0 = 0; e0 <= E; e0 += 32) {
      // lane e0 + lane: dimension e < E, or the affiliation sum at e == E
      const int e = e0 + lane;
      const bool is_sum = e == E;
      const int row = (e < E ? e : 0) * Tr;
      float ar[kScatterGroup], am[kScatterGroup];
#pragma unroll
      for (int c = 0; c < kScatterGroup; ++c) ar[c] = am[c] = 0.f;
#pragma unroll 2
      for (int t = warp; t < nt; t += nwarps) {
        const float v = is_sum ? 1.f : embs[row + t];
        const float v2 = v * v;
#pragma unroll
        for (int c = 0; c < kScatterGroup; ++c) {
          const float a = c < G ? aw[(g0 + c) * tile + t] : 0.f;
          ar[c] = fmaf(a, v, ar[c]);
          if (gaussian) am[c] = fmaf(a, v2, am[c]);
        }
      }
      for (int w = 0; w < nwarps; ++w) {
        if (warp == w && e <= E) {
          const bool assign = first && w == 0;
#pragma unroll
          for (int c = 0; c < kScatterGroup; ++c) {
            if (c >= G) continue;
            const int k = g0 + c;
            float* dr = is_sum ? asum + k : res + k * E + e;
            *dr = assign ? ar[c] : *dr + ar[c];
            if (gaussian && !is_sum) {
              float* dm = m2 + k * E + e;
              *dm = assign ? am[c] : *dm + am[c];
            }
          }
        }
        __syncthreads();
      }
    }
  }
}

// The closed-form spectral M-step of class k of utterance u from its
// accumulator row `a` (A floats in shared memory; the class's entries),
// into the spectral state of u in device memory. By one thread.
__device__ void spectral_m_step(const float* a, size_t u, int k, float* svec,
                                float* sb, float* sc, const float* table,
                                int table_size, float s0, float ds,
                                float min_concentration,
                                float max_concentration, bool gaussian,
                                bool spherical, int K, int E) {
  const float tiny = FLT_MIN;
  const float* r = a + k * E;
  const float n = a[K * E + k];
  float* vk = svec + (u * K + k) * E;
  if (!gaussian) {
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

// Registers: up to 64 a thread for D <= 6, so that four 256-thread CTAs
// share an SM; more for larger D, as the whole-fit cACGMM kernel.
template <int D>
__global__ void __launch_bounds__(kThreads, D <= 6 ? 4 : (D <= 10 ? 3 : 2))
integration_em_loop_kernel(
    const float2* __restrict__ y, const float* __restrict__ emb,
    float2* vec, float* eig, float* weight, float* svec, float* sb, float* sc,
    float* rows, float* acc_out, const float* __restrict__ table, int N,
    int K, int T, int E, int tile, int mode, int bins_per_utt,
    int iterations, int sweeps, int warm_sweeps, float eigenvalue_floor,
    float spatial_weight, float spectral_weight, float affiliation_eps,
    float min_concentration, float max_concentration, int table_size,
    float s0, float ds, int spherical) {
  constexpr int DD = D * D;
  constexpr int P = D * (D + 1) / 2;
  extern __shared__ float4 smem_raw[];
  cg::grid_group grid = cg::this_grid();
  const bool gaussian = mode == kGaussian;
  const int A = acc_rows(K, E, mode);
  const int U = N / bins_per_utt;
  const int F = bins_per_utt;
  const int Tr = tile | 1;  // odd row strides: distinct banks per row
  float2* ys = reinterpret_cast<float2*>(smem_raw);  // D * Tr
  float2* S = ys + size_t(D) * Tr;                   // K * DD covariance
  float2* V = S + K * DD;                            // K * DD eigenvectors
  float2* Vh = V + K * DD;                           // K * DD, V^H
  float2* Su = Vh + K * DD;                          // K * P scatter sums
  float* embs = reinterpret_cast<float*>(Su + K * P);  // E * Tr
  float* work = embs + size_t(E) * Tr;
  float* aw = work;                     // K * tile posterior
  float* wq = work + size_t(K) * tile;  // K * tile scatter weights
  float* part = work;                   // the spectral step's partials
  float* accs = work + (A < kThreads ? kThreads : A);  // A
  float* res = work + work_floats(K, E, tile, mode);  // K * E
  float* m2 = res + K * E;                             // K * E, Gaussian
  float* smu = m2 + (gaussian ? K * E : 0);            // K * E
  float* sprec = smu + K * E;                          // K * E, Gaussian
  float* sscale = sprec + (gaussian ? K * E : 0);      // K
  float* scnst = sscale + K;                           // K
  float* asum = scnst + K;                             // K
  float* logdet = asum + K;                            // K
  float* wgt = logdet + K;                             // K
  float* inv_lam = wgt + K;                            // K * D
  const integration::Spectral sp{smu, sprec, sscale, scnst};

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const float tiny = FLT_MIN;
  // a CTA that owns one bin whose frames fit one tile keeps them resident
  const bool resident = int(gridDim.x) >= N && tile >= T;

  for (int it = 0; it < iterations; ++it) {
    for (size_t n = blockIdx.x; n < size_t(N); n += gridDim.x) {
      // ---- the bin's model ----------------------------------------------
      const size_t u = n / F;
      for (int i = tid; i < K * DD; i += nthreads) {
        const int k = i / DD;
        const int r = (i - k * DD) / D;
        const int c = i - k * DD - r * D;
        V[i] = vec[n * K * DD + i];
        // Vh[k][r][c] = conj(V[k][c][r])
        Vh[i] = c_conj(vec[n * K * DD + k * DD + c * D + r]);
      }
      for (int i = tid; i < K * D; i += nthreads)
        inv_lam[i] = 1.f / eig[n * K * D + i];
      for (int k = tid; k < K; k += nthreads) {
        float ld = 0.f;
        for (int i = 0; i < D; ++i) ld += logf(eig[(n * K + k) * D + i]);
        logdet[k] = ld;
        wgt[k] = weight[n * K + k];
        sscale[k] = gaussian ? 0.f : sb[u * K + k];
        scnst[k] = sc[u * K + k];
      }
      for (int i = tid; i < K * E; i += nthreads) {
        smu[i] = svec[u * K * E + i];
        if (gaussian) sprec[i] = sb[u * K * E + i];
      }
      __syncthreads();

      // ---- E-step and sums over the frames, tile by tile ----------------
      for (int t0 = 0; t0 < T; t0 += tile) {
        const int nt = min(tile, T - t0);
        if (!resident || it == 0) {
          for (int d = 0; d < D; ++d)
            for (int t = tid; t < nt; t += nthreads)
              ys[d * Tr + t] = y[(n * D + d) * T + t0 + t];
          for (int e = 0; e < E; ++e)
            for (int t = tid; t < nt; t += nthreads)
              embs[e * Tr + t] = emb[(n * E + e) * T + t0 + t];
          __syncthreads();
        }
        for (int t = tid; t < nt; t += nthreads) {
          float2 yf[D];
#pragma unroll
          for (int d = 0; d < D; ++d) yf[d] = ys[d * Tr + t];
          integration::e_step_frame(
              [&](int k) {
                return integration::projection_quad_h<D>(yf, Vh + k * DD,
                                                          inv_lam + k * D);
              },
              [&](int e) { return embs[e * Tr + t]; }, logdet, wgt, sp,
              gaussian, spatial_weight, spectral_weight, affiliation_eps,
              1.f, aw + t, wq + t, tile, D, K, E);
        }
        __syncthreads();
        tile_sums<D>(ys, embs, Tr, aw, wq, tile, nt, Su, asum, res, m2, K, E,
                     gaussian, t0 == 0);
      }

      // ---- the spectral rows, the weight, the covariance ----------------
      float* row = rows + n * A;
      for (int i = tid; i < K * E; i += nthreads) {
        row[i] = res[i];
        if (gaussian) row[K * E + K + i] = m2[i];
      }
      for (int k = tid; k < K; k += nthreads) {
        float total = 0.f;
        for (int j = 0; j < K; ++j) total += asum[j];
        row[K * E + k] = asum[k];
        weight[n * K + k] = asum[k] / fmaxf(total, tiny);
      }
      covariance_from_sums<D>(Su, asum, S, K, float(D));
      __syncthreads();

      // ---- the warm Jacobi, the floored eigenvalues, the state out ------
      column_eigh<D, JacobiOrder::kWavefront>(
          S, V, K, true, it == 0 ? sweeps : warm_sweeps,
          [&](int k, int jc, float lam, const float2 (&v)[D], int jbase,
              bool jown) {
            float ld;
            const float ev =
                floored_eigenvalue<D>(lam, jbase, eigenvalue_floor, &ld);
            if (jown) {
              eig[(n * K + k) * D + jc] = ev;
#pragma unroll
              for (int i = 0; i < D; ++i)
                vec[(n * K + k) * DD + i * D + jc] = v[i];
            }
          });
      __syncthreads();
    }

    grid.sync();

    // ---- the spectral step of each (utterance, class) -------------------
    // the class's rows (its E resultants, its sum_t a and, for the
    // Gaussian, its E second moments): threads over the rows and `groups`
    // groups of bins, each group's sum in bin order, then the groups in
    // order
    const int R = gaussian ? 2 * E + 1 : E + 1;
    const int groups = R < nthreads ? nthreads / R : 1;
    for (size_t c = blockIdx.x; c < size_t(U) * K; c += gridDim.x) {
      const size_t u = c / K;
      const int k = int(c - u * K);
      for (int i = tid; i < R * groups; i += nthreads) {
        const int j = i % R;
        const int g = i / R;
        const int r = j < E ? k * E + j
                            : (j == E ? K * E + k : K * E + K + k * E + j -
                                                        E - 1);
        const float* src = rows + u * F * A + r;
        float s = 0.f;
#pragma unroll 8
        for (int f = g; f < F; f += groups) s += src[size_t(f) * A];
        part[g * R + j] = s;
      }
      __syncthreads();
      for (int j = tid; j < R; j += nthreads) {
        const int r = j < E ? k * E + j
                            : (j == E ? K * E + k : K * E + K + k * E + j -
                                                        E - 1);
        float s = 0.f;
        for (int g = 0; g < groups; ++g) s += part[g * R + j];
        accs[r] = s;
        acc_out[u * A + r] = s;
      }
      __syncthreads();
      if (it < iterations - 1 && tid == 0)
        spectral_m_step(accs, u, k, svec, sb, sc, table, table_size, s0, ds,
                        min_concentration, max_concentration, gaussian,
                        spherical != 0, K, E);
      __syncthreads();
    }
    if (it < iterations - 1) grid.sync();
  }
}

template <int D>
cudaError_t occupancy(int K, int E, int tile, int mode, int* per_sm,
                      int* sms, size_t* bytes) {
  *bytes = loop_smem_bytes(D, K, E, tile, mode);
  cudaError_t err = cudaFuncSetAttribute(
      integration_em_loop_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(*bytes));
  if (err != cudaSuccess) return err;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int coop = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, integration_em_loop_kernel<D>, kThreads, *bytes);
}

template <int D>
cudaError_t launch(const void* y, const void* emb, void* vec, void* eig,
                   void* weight, void* svec, void* sb, void* sc, void* rows,
                   void* acc, const void* table, int N, int K, int T, int E,
                   int tile, int mode, int bins_per_utt, int iterations,
                   int sweeps, int warm_sweeps, float eigenvalue_floor,
                   float spatial_weight, float spectral_weight,
                   float affiliation_eps, float min_concentration,
                   float max_concentration, int table_size, float s0,
                   float ds, int spherical, int grid_size, int* grid_used,
                   cudaStream_t stream) {
  int per_sm = 0, sms = 0;
  size_t bytes = 0;
  cudaError_t err = occupancy<D>(K, E, tile, mode, &per_sm, &sms, &bytes);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
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
      &table_, &N, &K, &T, &E, &tile, &mode, &bins_per_utt, &iterations,
      &sweeps, &warm_sweeps, &eigenvalue_floor, &spatial_weight,
      &spectral_weight, &affiliation_eps, &min_concentration,
      &max_concentration, &table_size, &s0, &ds, &spherical};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(integration_em_loop_kernel<D>), dim3(grid),
      dim3(kThreads), args, bytes, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// CTAs of the kernel at D that an SM's registers hold (the occupancy
// query with no dynamic shared memory), from which the host picks the
// frame tile (ops/integration_em_loop.frames_per_tile). Returns a negative
// cudaError_t on failure.
extern "C" int integration_em_loop_register_ctas(int D) {
  int blocks = 0;
  cudaError_t err = cudaErrorInvalidValue;
#define QUERY(DV)                                                      \
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                \
      &blocks, integration_em_loop_kernel<DV>, kThreads, 0);          \
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

// Launch the whole-fit integration EM on `stream`: `iterations` E + M
// steps for N bins (utterance u = n / bins_per_utt), the state updated in
// place, the frames in tiles of `tile` (the host's choice). grid_size 0
// sizes the grid to min(N, co-resident CTAs); another value is launched as
// given (a grid that cannot be co-resident fails with
// cudaErrorCooperativeLaunchTooLarge). The grid launched is written to
// *grid_used. Returns a cudaError_t (0 on success); neither synchronizes
// nor allocates.
extern "C" int integration_em_loop_launch(
    const void* y, const void* emb, void* vec, void* eig, void* weight,
    void* svec, void* sb, void* sc, void* rows, void* acc, const void* table,
    int N, int D, int K, int T, int E, int tile, int bins_per_utt,
    int iterations, int sweeps, int warm_sweeps, int mode,
    float eigenvalue_floor, float spatial_weight, float spectral_weight,
    float affiliation_eps, float min_concentration, float max_concentration,
    int table_size, float s0, float ds, int spherical, int grid_size,
    int* grid_used, void* stream) {
  if (mode != kVmf && mode != kGaussian) return int(cudaErrorInvalidValue);
  if (tile < 1) return int(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
#define CALL(DV)                                                             \
  int(launch<DV>(y, emb, vec, eig, weight, svec, sb, sc, rows, acc, table,   \
                 N, K, T, E, tile, mode, bins_per_utt, iterations, sweeps,   \
                 warm_sweeps, eigenvalue_floor, spatial_weight,              \
                 spectral_weight, affiliation_eps, min_concentration,        \
                 max_concentration, table_size, s0, ds, spherical,           \
                 grid_size, grid_used, s))
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
