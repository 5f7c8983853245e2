// Complex cyclic Jacobi for small Hermitian matrices in shared memory,
// used by the whole-fit Bingham EM (cbmm_loop.cu), and the complex
// arithmetic every kernel uses.
//
// Replaces the rotation step of the JAX package's Pallas kernels
// (pb_bss_tpu/ops/pallas_em_loop.py: _jacobi_rounds and _warm_rotate).
// There the batch lay in the TPU's vector lanes and each rotation was a
// handful of lane-wide vector ops. Here ONE WARP owns one d x d matrix
// (d <= 16) held row-major in shared memory: lane i updates entry i of
// the two rows, then of the two columns, that a rotation touches, so a
// rotation is three short warp-synchronous steps. The rotation algebra
// (tau, t, c, s, the skip when the off-diagonal entry is zero) is the
// JAX package's exactly.
//
// Every lane of the warp must call these functions (they use
// __syncwarp with the full mask); lanes >= d only take part in the
// barriers.
#pragma once

#include <cfloat>
#include <cuda_runtime.h>

__device__ __forceinline__ float2 c_add(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 c_sub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ float2 c_mul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// a * conj(b)
__device__ __forceinline__ float2 c_mul_conj(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}

// conj(a) * b
__device__ __forceinline__ float2 c_conj_mul(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.x * b.y - a.y * b.x);
}

__device__ __forceinline__ float2 c_scale(float s, float2 a) {
  return make_float2(s * a.x, s * a.y);
}

__device__ __forceinline__ float2 c_conj(float2 a) {
  return make_float2(a.x, -a.y);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int offset = 16; offset > 0; offset >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

// V <- I (d x d, row-major).
__device__ __forceinline__ void warp_set_identity(float2* V, int d) {
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < d * d; i += 32)
    V[i] = make_float2((i / d == i % d) ? 1.f : 0.f, 0.f);
  __syncwarp();
}

// `sweeps` cyclic Jacobi sweeps on the Hermitian matrix A, accumulating
// the rotations into V (eigenvectors in columns: V[row * d + col]).
// Afterwards diag(A) holds the (unsorted) eigenvalues.
__device__ void warp_jacobi(float2* A, float2* V, int d, int sweeps) {
  const int lane = threadIdx.x & 31;
  for (int sweep = 0; sweep < sweeps; ++sweep) {
    for (int p = 0; p < d - 1; ++p) {
      for (int q = p + 1; q < d; ++q) {
        __syncwarp();
        const float2 apq = A[p * d + q];
        const float absa = sqrtf(apq.x * apq.x + apq.y * apq.y);
        const float app = A[p * d + p].x;
        const float aqq = A[q * d + q].x;
        const float safe = fmaxf(absa, FLT_MIN);
        const float tau = (aqq - app) / (2.f * safe);
        const float t = (tau == 0.f)
            ? 1.f
            : copysignf(1.f, tau) / (fabsf(tau) + sqrtf(1.f + tau * tau));
        float c = 1.f / sqrtf(1.f + t * t);
        const float sr = t * c;
        float2 s = make_float2(sr * apq.x / safe, sr * apq.y / safe);
        if (!(absa > 0.f)) {  // nothing to zero: identity rotation
          c = 1.f;
          s = make_float2(0.f, 0.f);
        }
        const float2 sc = c_conj(s);
        __syncwarp();
        // rows: A[p] = c A[p] - s A[q];  A[q] = conj(s) A[p] + c A[q]
        if (lane < d) {
          const float2 rp = A[p * d + lane];
          const float2 rq = A[q * d + lane];
          A[p * d + lane] = c_sub(c_scale(c, rp), c_mul(s, rq));
          A[q * d + lane] = c_add(c_mul(sc, rp), c_scale(c, rq));
        }
        __syncwarp();
        // columns: A[:,p] = c A[:,p] - conj(s) A[:,q];
        //          A[:,q] = s A[:,p] + c A[:,q]   (V the same)
        if (lane < d) {
          const float2 cp = A[lane * d + p];
          const float2 cq = A[lane * d + q];
          A[lane * d + p] = c_sub(c_scale(c, cp), c_mul(sc, cq));
          A[lane * d + q] = c_add(c_mul(s, cp), c_scale(c, cq));
          const float2 vp = V[lane * d + p];
          const float2 vq = V[lane * d + q];
          V[lane * d + p] = c_sub(c_scale(c, vp), c_mul(sc, vq));
          V[lane * d + q] = c_add(c_mul(s, vp), c_scale(c, vq));
        }
      }
    }
  }
  __syncwarp();
}

// A <- V^H A V: rotate a fresh Hermitian matrix into the previous
// eigenbasis V so that the Jacobi that follows starts near-diagonal
// (warm start). Written Hermitian from the upper triangle. C is d x d
// scratch.
__device__ void warp_warm_rotate(float2* A, const float2* V, float2* C,
                                 int d) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  if (lane < d) {  // C = A V, lane j owns column j
    const int j = lane;
    for (int a = 0; a < d; ++a) {
      float2 acc = make_float2(0.f, 0.f);
      for (int b = 0; b < d; ++b)
        acc = c_add(acc, c_mul(A[a * d + b], V[b * d + j]));
      C[a * d + j] = acc;
    }
  }
  __syncwarp();
  if (lane < d) {  // A = V^H C, lane j owns entries (i <= j, j)
    const int j = lane;
    for (int i = 0; i <= j; ++i) {
      float2 acc = make_float2(0.f, 0.f);
      for (int a = 0; a < d; ++a)
        acc = c_add(acc, c_conj_mul(V[a * d + i], C[a * d + j]));
      if (i == j) {
        A[j * d + j] = make_float2(acc.x, 0.f);
      } else {
        A[i * d + j] = acc;
        A[j * d + i] = c_conj(acc);
      }
    }
  }
  __syncwarp();
}
