// K2: B independent dense QPs  min 1/2 x'Px + q'x  s.t.  Cx <= d  by a
// fixed-iteration primal-dual interior point method, one QP per thread.
//
// Replaces the TPU kernel of the JAX package,
// models/contact/pallas_qp.py::_kernel (wrapper solve_qp_batched), and
// computes what models/contact/qp.py::_pdip_solve computes per problem:
// the cold start (x from the ridge-regularised unconstrained minimum,
// slacks shifted by 1 past the most violated row, lam = 1) or the warm
// start from (x0, lam0) (x0 zeroed if not finite, slacks shifted by
// delta = 1e-2, lam0 cleaned and clipped to [delta, 1e6]); then `iters`
// Newton steps on the central path with sigma-centring, mu floored at
// 3e-7, the scaling lam/s capped at 1e10, the normal-equation matrix
// H = P + C' diag(w) C + 1e-8 I solved by Gauss-Jordan without pivoting,
// the fraction-to-boundary rule at 0.995, and the last finite primal
// iterate kept.  Non-finite duals leave as 0.
//
// What bounds it on an H100: the arithmetic of the n x n eliminations and
// the m x n x n products of each iteration, per QP, with no reuse between
// QPs; the inputs are read once per iteration (C, P) and are small.  So
// the design is one thread per QP with the whole iterate (x, s, lam, the
// H tableau) in registers.  The layout is batch-last (entry (i, j) of all
// QPs side by side), so a warp's loads of one entry are one coalesced
// transaction, as in the TPU kernel's lane layout; the ragged last block
// is masked, not padded.  The planar-hand shape (n = 7, m = 10) is a
// template instance with every loop unrolled at compile time, so the
// iterate stays in registers; other shapes up to n = 16, m = 64 take a
// generic instance whose arrays live in local memory.  No fast-math: the
// divisions and the 1e10-scaled eliminations are where f32 fails first.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxN = 16;
constexpr int kMaxM = 64;

// NaN-propagating min / max, as jnp.minimum / jnp.maximum.
__device__ __forceinline__ float nmin(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fminf(a, b);
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fmaxf(a, b);
}

// Solve M[:, :n] y = M[:, n] in place by Gauss-Jordan without pivoting;
// y ends in M[:, n].
template <int NA>
__device__ __forceinline__ void gauss_solve(float (&M)[NA][NA + 1], int n) {
#pragma unroll
  for (int kk = 0; kk < n; ++kk) {
    const float piv = M[kk][kk];
#pragma unroll
    for (int j = 0; j <= n; ++j) {
      M[kk][j] = M[kk][j] / piv;
    }
#pragma unroll
    for (int i = 0; i < n; ++i) {
      if (i == kk) continue;
      const float f = M[i][kk];
#pragma unroll
      for (int j = 0; j <= n; ++j) {
        M[i][j] = M[i][j] - f * M[kk][j];
      }
    }
  }
}

// NT, MT > 0: the sizes are compile-time constants and every loop unrolls;
// 0: runtime n, m, with the arrays sized for the largest problem.
template <int NT, int MT>
__global__ void __launch_bounds__(kThreads)
pdip_kernel(const float* __restrict__ P,     // (n, n, B)
            const float* __restrict__ q,     // (n, B)
            const float* __restrict__ C,     // (m, n, B)
            const float* __restrict__ d,     // (m, B)
            const float* __restrict__ x0,    // (n, B) or null (cold)
            const float* __restrict__ lam0,  // (m, B) or null
            float* __restrict__ x_out,       // (n, B)
            float* __restrict__ lam_out,     // (m, B) or null
            int B, int n_rt, int m_rt, int iters, float sigma) {
  constexpr int NA = NT > 0 ? NT : kMaxN;
  constexpr int MA = MT > 0 ? MT : kMaxM;
  const int n = NT > 0 ? NT : n_rt;
  const int m = MT > 0 ? MT : m_rt;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

#define AT_P(i, j) P[((size_t)(i) * n + (j)) * B + b]
#define AT_C(k, j) C[((size_t)(k) * n + (j)) * B + b]

  float x[NA], s[MA], lam[MA], xk[NA];
  float M[NA][NA + 1];  // Gauss-Jordan tableau [H | rhs]

  float delta;
  if (x0 != nullptr) {
    bool ok = true;
#pragma unroll
    for (int i = 0; i < n; ++i) {
      x[i] = x0[(size_t)i * B + b];
      ok = ok && isfinite(x[i]);
    }
#pragma unroll
    for (int i = 0; i < n; ++i) {
      if (!ok) x[i] = 0.f;
    }
    delta = 1e-2f;
  } else {
#pragma unroll
    for (int i = 0; i < n; ++i) {
#pragma unroll
      for (int j = 0; j < n; ++j) {
        M[i][j] = AT_P(i, j) + (i == j ? 1e-8f : 0.f);
      }
      M[i][n] = -q[(size_t)i * B + b];
    }
    gauss_solve<NA>(M, n);
#pragma unroll
    for (int i = 0; i < n; ++i) {
      x[i] = M[i][n];
    }
    delta = 1.f;
  }
  float min_slack = INFINITY;
#pragma unroll
  for (int k = 0; k < m; ++k) {
    float acc = d[(size_t)k * B + b];
#pragma unroll
    for (int j = 0; j < n; ++j) {
      acc -= AT_C(k, j) * x[j];
    }
    s[k] = acc;
    min_slack = k == 0 ? acc : nmin(min_slack, acc);
  }
  const float shift = nmax(0.f, -min_slack) + delta;
#pragma unroll
  for (int k = 0; k < m; ++k) {
    s[k] += shift;
    if (lam0 != nullptr) {
      float l = lam0[(size_t)k * B + b];
      l = isfinite(l) ? l : 1.f;
      lam[k] = nmin(nmax(l, delta), 1e6f);
    } else {
      lam[k] = 1.f;
    }
  }
#pragma unroll
  for (int i = 0; i < n; ++i) {
    xk[i] = x[i];
  }

  for (int it = 0; it < iters; ++it) {
    float mu = 0.f;
#pragma unroll
    for (int k = 0; k < m; ++k) {
      mu += s[k] * lam[k];
    }
    mu = nmax(mu / (float)m, 3e-7f);

    // Per row: r_p, r_c, the scaling w and t = w r_p - r_c / s; kept in
    // s-sized scratch so the row loop runs once.
    float rp[MA], rc[MA], w[MA], ssafe[MA];
#pragma unroll
    for (int k = 0; k < m; ++k) {
      float cx = 0.f;
#pragma unroll
      for (int j = 0; j < n; ++j) {
        cx += AT_C(k, j) * x[j];
      }
      rp[k] = cx + s[k] - d[(size_t)k * B + b];
      rc[k] = lam[k] * s[k] - sigma * mu;
      ssafe[k] = nmax(s[k], 1e-7f);
      w[k] = nmin(lam[k] / ssafe[k], 1e10f);
    }
    // H = P + 1e-8 I + C' diag(w) C;  rhs = -(r_d + C'(w r_p - r_c/s)).
#pragma unroll
    for (int i = 0; i < n; ++i) {
      float rd = q[(size_t)i * B + b];
#pragma unroll
      for (int j = 0; j < n; ++j) {
        rd += AT_P(i, j) * x[j];
      }
      float acc_r = 0.f;
#pragma unroll
      for (int k = 0; k < m; ++k) {
        const float cki = AT_C(k, i);
        rd += cki * lam[k];
        acc_r += cki * (w[k] * rp[k] - rc[k] / ssafe[k]);
      }
      M[i][n] = -(rd + acc_r);
#pragma unroll
      for (int j = 0; j < n; ++j) {
        if (j < i) {
          M[i][j] = M[j][i];
          continue;
        }
        float acc = AT_P(i, j) + (i == j ? 1e-8f : 0.f);
#pragma unroll
        for (int k = 0; k < m; ++k) {
          acc += AT_C(k, i) * w[k] * AT_C(k, j);
        }
        M[i][j] = acc;
      }
    }
    gauss_solve<NA>(M, n);

    float alpha = 1.f;
    float ds[MA], dl[MA];
#pragma unroll
    for (int k = 0; k < m; ++k) {
      float cdx = 0.f;
#pragma unroll
      for (int j = 0; j < n; ++j) {
        cdx += AT_C(k, j) * M[j][n];
      }
      ds[k] = -rp[k] - cdx;
      dl[k] = (-rc[k] - lam[k] * ds[k]) / ssafe[k];
      const float ratio_s = ds[k] < 0.f ? -s[k] / ds[k] : INFINITY;
      const float ratio_l = dl[k] < 0.f ? -lam[k] / dl[k] : INFINITY;
      alpha = nmin(alpha, 0.995f * nmin(ratio_s, ratio_l));
    }
    bool ok = true;
#pragma unroll
    for (int i = 0; i < n; ++i) {
      x[i] = x[i] + alpha * M[i][n];
      ok = ok && isfinite(x[i]);
    }
#pragma unroll
    for (int i = 0; i < n; ++i) {
      if (ok) xk[i] = x[i];
    }
#pragma unroll
    for (int k = 0; k < m; ++k) {
      s[k] = s[k] + alpha * ds[k];
      lam[k] = lam[k] + alpha * dl[k];
    }
  }

#pragma unroll
  for (int i = 0; i < n; ++i) {
    x_out[(size_t)i * B + b] = xk[i];
  }
  if (lam_out != nullptr) {
#pragma unroll
    for (int k = 0; k < m; ++k) {
      lam_out[(size_t)k * B + b] = isfinite(lam[k]) ? lam[k] : 0.f;
    }
  }
#undef AT_P
#undef AT_C
}

}  // namespace

// Launches the solve of B QPs on `stream`; x0/lam0 null for a cold start,
// lam_out null when the duals are not wanted.  Returns cudaGetLastError()
// as an int (0 on success).  All pointers are device pointers to
// contiguous f32 arrays in the batch-last layout above.
extern "C" int pdip_solve_f32(const float* P, const float* q, const float* C,
                              const float* d, const float* x0,
                              const float* lam0, float* x_out, float* lam_out,
                              int B, int n, int m, int iters, float sigma,
                              int warm, int want_lam, void* stream) {
  if (B < 1 || n < 1 || n > kMaxN || m < 1 || m > kMaxM || iters < 0 ||
      (warm && (x0 == nullptr || lam0 == nullptr)) ||
      (want_lam && lam_out == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (!warm) x0 = lam0 = nullptr;
  if (!want_lam) lam_out = nullptr;
  const int blocks = (B + kThreads - 1) / kThreads;
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 7 && m == 10) {
    pdip_kernel<7, 10><<<blocks, kThreads, 0, s>>>(
        P, q, C, d, x0, lam0, x_out, lam_out, B, n, m, iters, sigma);
  } else {
    pdip_kernel<0, 0><<<blocks, kThreads, 0, s>>>(
        P, q, C, d, x0, lam0, x_out, lam_out, B, n, m, iters, sigma);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* pdip_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
