// Integration-model EM statistics: one pass of E-step + M-step sums per EM
// iteration of VMFCACGMMTrainer / GCACGMMTrainer (K10).
//
// Replaces pb_bss_tpu/ops/pallas_integration_em.py:e_stats_staged (the
// Pallas TPU kernel, bins in the lanes, one grid step per frequency tile
// holding all T). The integration models couple a per-bin spatial cACG
// with a GLOBAL spectral model (vMF or Gaussian) over all bins of an
// utterance, so the M-step cannot stay inside a bin; this pass emits the
// sums it needs and the finish runs in PyTorch (the Banerjee or Gaussian
// closed form over the bins, the covariance D S / max(asum, tiny) and its
// eigh, K1). The posterior never reaches device memory. D is a template
// parameter (1..16), and so is the spectral mode:
//
//   work    a grid of whole waves (from the occupancy query; ops/_plan.py),
//           each CTA owning an equal span of the frames of the bins laid
//           end to end, as the streamed cACGMM and Watson passes take them
//           (stream.cuh): a span covers the tail of a bin, whole bins and
//           the head of another, each piece of a bin a segment. A bin that
//           one CTA covers whole gets its sums written straight out; a bin
//           split over CTAs gets one partial sum a segment in its own slot,
//           and the CTA that finishes the bin last (a ticket on the bin's
//           counter) adds the slots in slot order and writes the sums, in
//           the same launch. No float atomics: runs repeat bit for bit. The
//           last CTA puts the counter back to 0 for the next launch.
//   copies  y and the embedding stream through a ring of tiles in shared
//           memory with cp.async (two stages where they fit the shared
//           memory, else one), a tile a frame for each of the CTA's 128 or
//           256 threads: the next tile is in flight while this one
//           computes. Rows keep an odd stride (the tile + 1), so the
//           channels of a frame and the dimensions of its embedding fall in
//           distinct banks.
//   E-step  a thread per frame, the frame's D channels in registers, the
//           E-step that K12 shares (integration.cuh: e_step_frame with the
//           projection form projection_quad_h, the spectral log-pdf, the
//           max-shift softmax, the clip, saliency, the scatter weight
//           a / max(q, 10 tiny)); posterior and weight go to shared memory.
//   sums    lanes over the items of a class, a lane set holding one kind:
//           the P upper-triangle scatter entries sum_t w y_d conj(y_e) in
//           sets of 32, then one set for the affiliation sum sum_t a and 31
//           embedding dimensions sum_t a e (with, for the Gaussian,
//           sum_t a e^2 beside it); warps over frames, a group of kGroup
//           classes in registers at once (classes past K skipped alike on
//           every lane); one cross-warp reduction a segment, warp by warp
//           in a fixed order. More dimensions or classes take another pass
//           over the segment. The first tile's copy is issued before the
//           segment's model is loaded.
//
// What bounds it on the H100: y and the embedding are read once per pass
// (at F=513, T=300, D=6, E=20: 7.4 + 12.3 MB, ~5.9 us at 3.35 TB/s),
// against ~1 kFLOP a frame (the quadratic forms, the spectral dots, the
// scatter and resultant sums) of ~0.15 GFLOP, ~2.3 us at the fp32 rate:
// the bytes, so the design reads each input once, coalesced along time and
// off the critical path, keeps every CTA busy with equal work, and makes
// the call one launch.
//
// Layouts (all contiguous): y (N, D, T) complex64 as float2; emb (N, E, T)
// float; sal (N, T) or null; eigval (N, K, D); eigvec (N, K, D, D)
// complex64, eigenvectors in columns; weight (N, K); the spectral state of
// utterance u = n / bins_per_utt: vec (U, K, E), prec_or_scale (U, K, E)
// Gaussian precisions or (U, K) vMF concentrations, cnst (U, K); outputs
// scatter (N, K, D, D) complex64 full Hermitian, asum (N, K), res
// (N, K, E), m2 (N, K, E) (Gaussian only); work: slots (slots, N, K, I)
// float2, I = P + 1 + E items a class, and counters (N) int, all 0 at the
// start of a launch and left so.
#include <cfloat>
#include <cmath>
#include <cuda_runtime.h>

#include "integration.cuh"
#include "stream.cuh"

namespace {

using integration::kGaussian;
using integration::kVmf;
using stream::cp_async4;
using stream::cp_async8;
using stream::cp_async_commit;
using stream::cp_async_wait;

// a CTA's threads, 128 or 256 (the host's choice): one a frame of a tile
// in the E-step, so a tile holds as many frames, rows at an odd stride
constexpr int kMaxThreads = integration::kThreads;
constexpr int kGroup = 4;  // classes summed in registers at once

// Lane sets of the scatter entries (lane l of set j takes entry 32 j + l),
// and the item sets a pass holds in registers: those and one more for the
// affiliation sum and 31 dimensions of the embedding (lane l of it takes
// item 32 r + l of {the sum, e_0, .., e_{E-1}} in round r).
__host__ __device__ constexpr int scatter_sets(int D) {
  return (D * (D + 1) / 2 + 31) / 32;
}
__host__ __device__ constexpr int item_sets(int D) {
  return scatter_sets(D) + 1;
}

// Float-sized words of the ring of `stages` tiles of `tile` frames (y as
// float2, then the embedding), or of the cross-warp reduction's scratch
// that reuses it if that is larger; a multiple of 4, so what follows is
// 16-byte aligned.
__host__ __device__ inline size_t ring_words(int D, int E, int stages,
                                             int tile) {
  const size_t ring = size_t(stages) * (tile + 1) * (2 * D + E);
  const size_t scratch = size_t(tile / 32) * kGroup * item_sets(D) * 32 * 2;
  return ((ring > scratch ? ring : scratch) + 3) / 4 * 4;
}

// Shared memory of one CTA: the ring, the bin's eigenvectors (K D^2
// complex), the tile's posterior and scatter weights (K tile each), the
// reciprocal eigenvalues (K D), log-determinants and weights (K each), the
// spectral state (2 K E + 2 K) and the ticket's flag.
inline size_t stats_smem_bytes(int D, int K, int E, int stages, int tile) {
  return 4 * (ring_words(D, E, stages, tile) + 2 * size_t(K) * D * D +
              2 * size_t(K) * tile + size_t(K) * D + 2 * size_t(K) +
              2 * size_t(K) * E + 2 * size_t(K) + 1);
}

template <int D, int MODE>
__global__ void __launch_bounds__(kMaxThreads, D <= 8 ? 3 : 2)
integration_stats_kernel(const float2* __restrict__ y,
                         const float* __restrict__ emb,
                         const float* __restrict__ sal,
                         const float* __restrict__ eigval,
                         const float2* __restrict__ eigvec,
                         const float* __restrict__ weight,
                         const float* __restrict__ vec,
                         const float* __restrict__ prec_or_scale,
                         const float* __restrict__ cnst,
                         float2* __restrict__ scatter_out,
                         float* __restrict__ asum_out,
                         float* __restrict__ res_out,
                         float* __restrict__ m2_out, float2* slots,
                         int* counters, int N, int K, int T, int E,
                         int bins_per_utt, int stages, long long span,
                         float spatial_weight, float spectral_weight,
                         float affiliation_eps) {
  constexpr bool kGauss = MODE == kGaussian;
  constexpr int DD = D * D;
  constexpr int P = D * (D + 1) / 2;
  constexpr int SPL = scatter_sets(D);
  constexpr int J = item_sets(D);
  const int tile = blockDim.x;  // frames a tile
  const int row = tile + 1;      // the tiles' row stride, odd
  const int nwarps = tile >> 5;
  extern __shared__ float4 smem_raw[];
  float* words = reinterpret_cast<float*>(smem_raw);
  float2* ring_y = reinterpret_cast<float2*>(words);  // stages x D x row
  float* ring_e = words + 2 * size_t(stages) * D * row;  // stages x E x row
  float2* scratch = reinterpret_cast<float2*>(words);  // the reduction's
  float2* Vh =
      reinterpret_cast<float2*>(words + ring_words(D, E, stages, tile));
  float* aff = reinterpret_cast<float*>(Vh + K * DD);  // K x tile
  float* wq = aff + K * tile;                           // K x tile
  float* inv_lam = wq + K * tile;                       // K x D
  float* logdet = inv_lam + K * D;                      // K
  float* wgt = logdet + K;                              // K
  const integration::Spectral sp{wgt + K, wgt + K + K * E,
                                 wgt + K + 2 * K * E,
                                 wgt + 2 * K + 2 * K * E};
  int* flag = reinterpret_cast<int*>(sp.cnst + K);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int I = P + 1 + E;  // items a class
  const long long total = static_cast<long long>(N) * T;
  const long long begin = static_cast<long long>(blockIdx.x) * span;
  const long long end = begin + span < total ? begin + span : total;

  // the sums of item r of class k of bin n, written out
  auto emit = [&](size_t n, int k, int r, float2 v) {
    const size_t nk = n * K + k;
    if (r < P) {
      int d, e;
      upper_entry(r, D, &d, &e);
      float2* S = scatter_out + nk * DD;
      if (d == e) {
        S[d * D + d] = make_float2(v.x, 0.f);
      } else {
        S[d * D + e] = v;
        S[e * D + d] = c_conj(v);
      }
    } else if (r == P) {
      asum_out[nk] = v.x;
    } else {
      res_out[nk * E + r - P - 1] = v.x;
      if (kGauss) m2_out[nk * E + r - P - 1] = v.y;
    }
  };

  for (long long pos = begin; pos < end;) {
    const stream::Segment seg = stream::segment(pos, end, T, span);
    const int n = seg.n;
    const int t_begin = seg.t_begin;
    const int t_end = seg.t_end;
    pos = static_cast<long long>(n) * T + t_end;

    __syncthreads();  // the previous segment is done with the model, ring
    const float2* yn = y + size_t(n) * D * T;
    const float* en = emb + size_t(n) * E * T;
    const float* sn = sal != nullptr ? sal + size_t(n) * T : nullptr;
    auto issue = [&](int i) {
      const int t0 = t_begin + i * tile;
      const int nt = min(tile, t_end - t0);
      float2* yd = ring_y + (i % stages) * D * row;
      float* ed = ring_e + (i % stages) * E * row;
      if (tid < nt) {
#pragma unroll
        for (int d = 0; d < D; ++d)
          cp_async8(yd + d * row + tid, yn + size_t(d) * T + t0 + tid);
        for (int e = 0; e < E; ++e)
          cp_async4(ed + e * row + tid, en + size_t(e) * T + t0 + tid);
      }
      cp_async_commit();
    };
    issue(0);  // the first tile's copy overlaps the model's loads

    // ---- the bin's model: V^H, 1 / lam, log-determinants, weights, and
    // its utterance's spectral state
    const size_t u = n / bins_per_utt;
    for (int i = tid; i < K * DD; i += tile) {
      const int k = i / DD;
      const int r = (i - k * DD) / D;
      const int c = i - k * DD - r * D;
      Vh[i] = c_conj(eigvec[(size_t(n) * K + k) * DD + c * D + r]);
    }
    for (int i = tid; i < K * D; i += tile)
      inv_lam[i] = 1.f / eigval[size_t(n) * K * D + i];
    for (int k = tid; k < K; k += tile) {
      float ld = 0.f;
      for (int i = 0; i < D; ++i) ld += logf(eigval[(size_t(n) * K + k) * D + i]);
      logdet[k] = ld;
      wgt[k] = weight[size_t(n) * K + k];
      sp.scale[k] = kGauss ? 0.f : prec_or_scale[u * K + k];
      sp.cnst[k] = cnst[u * K + k];
    }
    for (int i = tid; i < K * E; i += tile) {
      sp.vec[i] = vec[u * K * E + i];
      if (kGauss) sp.prec[i] = prec_or_scale[u * K * E + i];
    }
    __syncthreads();

    const int tiles = (t_end - t_begin + tile - 1) / tile;

    for (int g0 = 0; g0 < K; g0 += kGroup) {
      const int G = min(kGroup, K - g0);
      for (int round = 0; 32 * round <= E; ++round) {
        // the first tile of the segment's first pass is in flight already
        if (g0 > 0 || round > 0) issue(0);
        // this lane's items: scatter entries (rows ra, rb of y) and item
        // m of the affiliation sum (m = 0) and the embedding (row m - 1)
        int ra[SPL], rb[SPL];
#pragma unroll
        for (int j = 0; j < SPL; ++j) {
          const int r = 32 * j + lane;
          int d, e;
          upper_entry(r < P ? r : 0, D, &d, &e);
          ra[j] = d * row;
          rb[j] = e * row;
        }
        const int m = 32 * round + lane;
        const bool dim = m >= 1 && m <= E;
        const int re = (dim ? m - 1 : 0) * row;
        float2 acc[J][kGroup];
#pragma unroll
        for (int j = 0; j < J; ++j)
#pragma unroll
          for (int c = 0; c < kGroup; ++c) acc[j][c] = make_float2(0.f, 0.f);

        for (int i = 0; i < tiles; ++i) {
          if (stages > 1) {
            if (i + 1 < tiles) issue(i + 1);
            else cp_async_commit();  // empty: keeps the group count
            cp_async_wait<1>();
          } else {
            cp_async_wait<0>();
          }
          __syncthreads();
          const float2* ys = ring_y + (i % stages) * D * row;
          const float* es = ring_e + (i % stages) * E * row;
          const int t0 = t_begin + i * tile;
          const int nt = min(tile, t_end - t0);

          // ---- E-step: a thread per frame ------------------------------
          if (tid < nt) {
            float2 yf[D];
#pragma unroll
            for (int d = 0; d < D; ++d) yf[d] = ys[d * row + tid];
            integration::e_step_frame(
                [&](int k) {
                  return integration::projection_quad_h<D>(
                      yf, Vh + k * DD, inv_lam + k * D);
                },
                [&](int e) { return es[e * row + tid]; }, logdet, wgt, sp,
                kGauss, spatial_weight, spectral_weight, affiliation_eps,
                sn != nullptr ? sn[t0 + tid] : 1.f, aff + tid, wq + tid,
                tile, D, K, E);
          }
          __syncthreads();

          // ---- sums: lanes over items, warps over frames ---------------
#pragma unroll 2
          for (int t = warp; t < nt; t += nwarps) {
            float a[kGroup], w[kGroup];
#pragma unroll
            for (int c = 0; c < kGroup; ++c) {
              a[c] = c < G ? aff[(g0 + c) * tile + t] : 0.f;
              w[c] = c < G ? wq[(g0 + c) * tile + t] : 0.f;
            }
            if (round == 0) {
#pragma unroll
              for (int j = 0; j < SPL; ++j) {
                const float2 p = c_mul_conj(ys[ra[j] + t], ys[rb[j] + t]);
#pragma unroll
                for (int c = 0; c < kGroup; ++c) {
                  if (c >= G) continue;  // G is the same on every lane
                  acc[j][c].x = fmaf(w[c], p.x, acc[j][c].x);
                  acc[j][c].y = fmaf(w[c], p.y, acc[j][c].y);
                }
              }
            }
            const float v = dim ? es[re + t] : 1.f;
            const float v2 = kGauss ? v * v : 0.f;
#pragma unroll
            for (int c = 0; c < kGroup; ++c) {
              if (c >= G) continue;
              acc[SPL][c].x = fmaf(a[c], v, acc[SPL][c].x);
              acc[SPL][c].y = fmaf(a[c], v2, acc[SPL][c].y);
            }
          }
          __syncthreads();  // this stage is free for the next copy
          if (stages == 1 && i + 1 < tiles) issue(i + 1);
        }
        cp_async_wait<0>();

        // ---- one cross-warp reduction for the segment, in warp order ----
#pragma unroll
        for (int c = 0; c < kGroup; ++c)
#pragma unroll
          for (int j = 0; j < J; ++j)
            scratch[((warp * kGroup + c) * J + j) * 32 + lane] = acc[j][c];
        __syncthreads();
        for (int id = tid; id < G * 32 * J; id += tile) {
          const int c = id / (32 * J);
          const int j = (id - c * 32 * J) / 32;
          const int l = id - c * 32 * J - 32 * j;
          // item r: scatter entry 32 j + l, or the sum / a dimension
          const int r = j < SPL ? 32 * j + l : P + 32 * round + l;
          if (j < SPL ? (round > 0 || r >= P) : r > P + E) continue;
          float2 v = make_float2(0.f, 0.f);
          for (int w = 0; w < nwarps; ++w)
            v = c_add(v, scratch[((w * kGroup + c) * J + j) * 32 + l]);
          if (seg.nseg == 1)
            emit(n, g0 + c, r, v);
          else
            slots[(size_t(seg.slot) * N + n) * K * I + size_t(g0 + c) * I +
                  r] = v;
        }
        __syncthreads();  // the scratch (the ring) is free again
      }
    }

    // ---- a bin split over CTAs: the last to finish adds the slots -------
    stream::sum_split_bin(seg, slots, counters, flag, N, K, I,
                          [&](int k, int r, float2 v) { emit(n, k, r, v); });
  }
}

template <int D, int MODE>
cudaError_t prepare(size_t bytes) {
  return cudaFuncSetAttribute(integration_stats_kernel<D, MODE>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(bytes));
}

template <int D, int MODE>
cudaError_t resident(int threads, size_t bytes, int* blocks) {
  cudaError_t err = prepare<D, MODE>(bytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, integration_stats_kernel<D, MODE>, threads, bytes);
}

template <int D, int MODE>
cudaError_t launch(int ctas, int threads, size_t bytes, cudaStream_t stream,
                   const void* y, const void* emb, const void* sal,
                   const void* eigval, const void* eigvec, const void* weight,
                   const void* vec, const void* prec_or_scale,
                   const void* cnst, void* scatter, void* asum, void* res,
                   void* m2, void* slots, void* counters, int N, int K,
                   int T, int E, int bins_per_utt, int stages,
                   long long span, float spatial_weight,
                   float spectral_weight, float affiliation_eps) {
  cudaError_t err = prepare<D, MODE>(bytes);
  if (err != cudaSuccess) return err;
  integration_stats_kernel<D, MODE><<<ctas, threads, bytes, stream>>>(
      static_cast<const float2*>(y), static_cast<const float*>(emb),
      static_cast<const float*>(sal), static_cast<const float*>(eigval),
      static_cast<const float2*>(eigvec), static_cast<const float*>(weight),
      static_cast<const float*>(vec),
      static_cast<const float*>(prec_or_scale),
      static_cast<const float*>(cnst), static_cast<float2*>(scatter),
      static_cast<float*>(asum), static_cast<float*>(res),
      static_cast<float*>(m2), static_cast<float2*>(slots),
      static_cast<int*>(counters), N, K, T, E, bins_per_utt, stages, span,
      spatial_weight, spectral_weight, affiliation_eps);
  return cudaGetLastError();
}

// Calls CALL(D, MODE) for the runtime D in 1..16 and mode.
#define INTEGRATION_DISPATCH(CALL)                                         \
  if (mode != kVmf && mode != kGaussian) return cudaErrorInvalidValue;     \
  switch (D) {                                                             \
    case 1: return mode ? CALL(1, 1) : CALL(1, 0);                         \
    case 2: return mode ? CALL(2, 1) : CALL(2, 0);                         \
    case 3: return mode ? CALL(3, 1) : CALL(3, 0);                         \
    case 4: return mode ? CALL(4, 1) : CALL(4, 0);                         \
    case 5: return mode ? CALL(5, 1) : CALL(5, 0);                         \
    case 6: return mode ? CALL(6, 1) : CALL(6, 0);                         \
    case 7: return mode ? CALL(7, 1) : CALL(7, 0);                         \
    case 8: return mode ? CALL(8, 1) : CALL(8, 0);                         \
    case 9: return mode ? CALL(9, 1) : CALL(9, 0);                         \
    case 10: return mode ? CALL(10, 1) : CALL(10, 0);                      \
    case 11: return mode ? CALL(11, 1) : CALL(11, 0);                      \
    case 12: return mode ? CALL(12, 1) : CALL(12, 0);                      \
    case 13: return mode ? CALL(13, 1) : CALL(13, 0);                      \
    case 14: return mode ? CALL(14, 1) : CALL(14, 0);                      \
    case 15: return mode ? CALL(15, 1) : CALL(15, 0);                      \
    case 16: return mode ? CALL(16, 1) : CALL(16, 0);                      \
    default: return cudaErrorInvalidValue;                                 \
  }

cudaError_t resident_any(int D, int mode, int threads, size_t bytes,
                         int* blocks) {
#define CALL(DV, MV) resident<DV, MV>(threads, bytes, blocks)
  INTEGRATION_DISPATCH(CALL)
#undef CALL
}

cudaError_t launch_any(int D, int mode, int ctas, int threads, size_t bytes,
                       cudaStream_t s, const void* y, const void* emb,
                       const void* sal, const void* eigval,
                       const void* eigvec, const void* weight,
                       const void* vec, const void* prec_or_scale,
                       const void* cnst, void* scatter, void* asum,
                       void* res, void* m2, void* slots, void* counters,
                       int N, int K, int T, int E, int bins_per_utt,
                       int stages, long long span, float spatial_weight,
                       float spectral_weight, float affiliation_eps) {
#define CALL(DV, MV)                                                       \
  launch<DV, MV>(ctas, threads, bytes, s, y, emb, sal, eigval, eigvec,     \
                 weight, vec, prec_or_scale, cnst, scatter, asum, res, m2, \
                 slots,                                                    \
                 counters, N, K, T, E, bins_per_utt, stages, span,         \
                 spatial_weight, spectral_weight, affiliation_eps)
  INTEGRATION_DISPATCH(CALL)
#undef CALL
}

}  // namespace

// CTAs of one pass resident on the whole card at once for (D, K, E) in
// spectral mode `mode` with `stages` tiles in the ring and `threads`
// threads a CTA: blocks per SM from the occupancy query times the SMs.
// Returns a negative cudaError_t on failure.
extern "C" int integration_em_capacity(int D, int K, int E, int mode,
                                       int stages, int threads) {
  int blocks = 0, device = 0, sms = 0;
  cudaError_t err = resident_any(
      D, mode, threads, stats_smem_bytes(D, K, E, stages, threads), &blocks);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return -int(err);
  return blocks * sms;
}

// Launch one integration statistics pass on `stream`: `ctas` CTAs, each
// over `span` frames of the N bins of T frames laid end to end (utterance
// u = n / bins_per_utt), with `stages` (1 or 2) tiles of `threads` (128
// or 256) frames in the ring, a thread a frame of a tile. mode 0
// is the vMF, 1 the Gaussian (m2 written only there). sal may be null.
// slots holds (slots, N, K, D (D + 1) / 2 + 1 + E) complex partial sums of
// the bins split over CTAs, counters N ints that are 0 (and stay so).
// Returns a cudaError_t (0 on success; cudaErrorInvalidValue for an
// unknown mode or D); neither synchronizes nor allocates.
extern "C" int integration_stats_launch(
    const void* y, const void* emb, const void* sal, const void* eigval,
    const void* eigvec, const void* weight, const void* vec,
    const void* prec_or_scale, const void* cnst, void* scatter, void* asum,
    void* res, void* m2, void* slots, void* counters, int N, int D, int K,
    int T, int E, int bins_per_utt, int ctas, long long span, int stages,
    int threads, int mode, float spatial_weight, float spectral_weight,
    float affiliation_eps, void* stream) {
  if (stages < 1 || stages > 2 || (threads != 128 && threads != 256))
    return int(cudaErrorInvalidValue);
  return int(launch_any(
      D, mode, ctas, threads, stats_smem_bytes(D, K, E, stages, threads),
      static_cast<cudaStream_t>(stream), y, emb, sal, eigval, eigvec, weight,
      vec, prec_or_scale, cnst, scatter, asum, res, m2, slots, counters, N,
      K, T, E, bins_per_utt, stages, span, spatial_weight, spectral_weight,
      affiliation_eps));
}
