// K2: B independent dense QPs  min 1/2 x'Px + q'x  s.t.  Cx <= d  by a
// fixed-iteration primal-dual interior point method, a tile of G lanes per
// QP.
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
// What bounds it on an H100: latency.  A QP is `iters` dependent Newton
// steps on a system of at most 16 unknowns and 64 rows, a few hundred
// flops each; the main path's nominal call solves only 30-60 QPs, and its
// sample call a few thousand.  So the design spreads each QP over a tile
// of G = 8, 16 or 32 lanes of one warp, as K4 spreads its Newton step:
//   - rows over lanes (two a lane past 32 rows): each lane holds its rows'
//     C row, d, s, lam, r_p, r_c, w and the floored slack in registers;
//   - mu, the fraction-to-boundary step and the start's slack shift are
//     butterfly reductions over the tile (__shfl_xor_sync with the tile's
//     mask), NaN-propagating like jnp.minimum;
//   - the tableau [H | rhs] is built with one column a lane, in registers,
//     by one code path for every lane (H's product order (w C_kj) C_ki as
//     K4's), from the QP's C, P, w, r_p-terms and lam staged in shared
//     memory, and eliminated by K4's unrolled Gauss-Jordan without
//     pivoting, the pivot column broadcast by __shfl_sync over the tile;
//   - the iterate x (and its last finite value) is replicated in every
//     lane of the tile, so the finiteness rescue needs no reduction.
// The nominal call's QPs then fill as many warps, and the sample call's
// thousands fill the card.  Each (n, m) a bundled model hands K2 is a
// compile-time instance: planar hand (7, 10), box pushing (5, 2), box
// pivoting (5, 18), plate pickup (8, 16); every other shape up to n = 16,
// m = 64 takes a generic instance whose tableau is 16 columns wide, the
// columns past n an identity block that leaves the first n untouched, so
// that its loops and shuffles too sit at compile-time positions.  The
// layout is the caller's batch-first one (P (B,n,n), C (B,m,n), ...), read
// and written as it lies.  No fast-math: the divisions and the
// 1e10-scaled eliminations are where f32 fails first.

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

// The lanes of the warp that hold this lane's tile of G.
template <int G>
__device__ __forceinline__ unsigned tile_mask(int lane) {
  return G == 32 ? 0xffffffffu : (((1u << G) - 1u) << (lane & ~(G - 1)));
}

template <int G>
__device__ __forceinline__ float tile_sum(float v, unsigned mask) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    v += __shfl_xor_sync(mask, v, off, G);
  }
  return v;
}

template <int G>
__device__ __forceinline__ float tile_nmin(float v, unsigned mask) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    v = nmin(v, __shfl_xor_sync(mask, v, off, G));
  }
  return v;
}

// Gauss-Jordan without pivoting on the tableau held one column a lane
// (lane j of the tile: column j, lane NA: the right-hand side): pivot kk
// scales row kk of every column and takes its multiple off the other rows,
// the factors broadcast from lane kk.  Then every lane gets the solution.
template <int NA, int G>
__device__ __forceinline__ void gauss_jordan(float (&col)[NA],
                                             unsigned mask) {
#pragma unroll
  for (int kk = 0; kk < NA; ++kk) {
    const float rk = col[kk] / __shfl_sync(mask, col[kk], kk, G);
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      if (i != kk) col[i] = col[i] - __shfl_sync(mask, col[i], kk, G) * rk;
    }
    col[kk] = rk;
  }
#pragma unroll
  for (int i = 0; i < NA; ++i) col[i] = __shfl_sync(mask, col[i], NA, G);
}

// NA: the tableau's unknowns; MA: the rows a tile holds; G: the lanes of a
// QP.  FIXED: n == NA and m == MA (a model's instance); otherwise n <= NA,
// m <= MA at run time, columns past n an identity block, rows past m idle.
template <int NA, int MA, int G, bool FIXED>
__global__ void __launch_bounds__(kThreads)
pdip_kernel(const float* __restrict__ P,     // (B, n, n)
            const float* __restrict__ q,     // (B, n)
            const float* __restrict__ C,     // (B, m, n)
            const float* __restrict__ d,     // (B, m)
            const float* __restrict__ x0,    // (B, n) or null (cold)
            const float* __restrict__ lam0,  // (B, m) or null
            float* __restrict__ x_out,       // (B, n)
            float* __restrict__ lam_out,     // (B, m) or null
            int B, int n_rt, int m_rt, int iters, float sigma) {
  static_assert(G > NA, "a lane for every tableau column");
  constexpr int R = (MA + G - 1) / G;   // rows a lane
  constexpr int QPB = kThreads / G;     // QPs a block
  constexpr int LDC = NA | 1;
  const int n = FIXED ? NA : n_rt;
  const int m = FIXED ? MA : m_rt;
  __shared__ float sC[QPB][MA * LDC];   // C, zero past column n
  __shared__ float sP[QPB][NA * NA];    // P, zero past n
  __shared__ float sq[QPB][NA];
  __shared__ float sw[QPB][MA], stk[QPB][MA], slm[QPB][MA];

  const int lane = threadIdx.x & 31;
  const int tl = threadIdx.x % G;       // lane in the tile
  const int slot = threadIdx.x / G;
  const unsigned mask = tile_mask<G>(lane);
  const int qp = blockIdx.x * QPB + slot;
  // A tile past the batch runs on the last QP's data and writes nothing,
  // so that every lane of a warp takes the same shuffles.
  const bool live = qp < B;
  const size_t b = live ? qp : B - 1;
  float* Cs = sC[slot];
  float* Ps = sP[slot];
  float* qs = sq[slot];
  float* ws = sw[slot];
  float* tks = stk[slot];
  float* lms = slm[slot];

  // -- stage the QP's C, P and q --
  for (int e = tl; e < MA * NA; e += G) {
    const int k = e / NA, i = e % NA;
    Cs[k * LDC + i] = (k < m && i < n) ? C[(b * m + k) * n + i] : 0.f;
  }
  for (int e = tl; e < NA * NA; e += G) {
    const int i = e / NA, j = e % NA;
    Ps[e] = (i < n && j < n) ? P[(b * n + i) * n + j] : 0.f;
  }
  for (int i = tl; i < NA; i += G) qs[i] = i < n ? q[b * n + i] : 0.f;
  __syncwarp(mask);

  // Column `tl` of P (an identity column past n; zeros for the lanes of
  // the right-hand side and beyond).
  float pcol[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    pcol[i] = tl < n ? Ps[i * NA + (tl < NA ? tl : 0)]
                     : (i == tl ? 1.f : 0.f);
  }
  // This lane's rows k = tl + G r.
  float cr[R][NA], dr[R], s[R], lam[R];
  bool v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int k = tl + G * r;
    v[r] = k < m;
    const int kr = v[r] ? k : 0;
#pragma unroll
    for (int i = 0; i < NA; ++i) cr[r][i] = v[r] ? Cs[kr * LDC + i] : 0.f;
    dr[r] = v[r] ? d[b * m + kr] : 0.f;
  }

  float x[NA], xk[NA];
  float delta;
  if (x0 != nullptr) {
    bool ok = true;
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      x[i] = i < n ? x0[b * n + i] : 0.f;
      ok = ok && isfinite(x[i]);
    }
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      if (!ok) x[i] = 0.f;
    }
    delta = 1e-2f;
  } else {
    float col[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      col[i] = tl == NA ? -qs[i] : pcol[i] + (i == tl ? 1e-8f : 0.f);
    }
    gauss_jordan<NA, G>(col, mask);
#pragma unroll
    for (int i = 0; i < NA; ++i) x[i] = col[i];
    delta = 1.f;
  }
  {
    float mn = INFINITY;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float acc = dr[r];
#pragma unroll
      for (int j = 0; j < NA; ++j) acc -= cr[r][j] * x[j];
      s[r] = acc;
      if (v[r]) mn = nmin(mn, acc);
    }
    const float shift = nmax(0.f, -tile_nmin<G>(mn, mask)) + delta;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      s[r] += shift;
      if (lam0 != nullptr) {
        float l = v[r] ? lam0[b * m + tl + G * r] : 1.f;
        l = isfinite(l) ? l : 1.f;
        lam[r] = nmin(nmax(l, delta), 1e6f);
      } else {
        lam[r] = 1.f;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NA; ++i) xk[i] = x[i];

  for (int it = 0; it < iters; ++it) {
    // -- mu, and per row r_p, r_c, the floored slack and w --
    float acc = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) acc += v[r] ? s[r] * lam[r] : 0.f;
    const float mu = nmax(tile_sum<G>(acc, mask) / (float)m, 3e-7f);
    float rp[R], rc[R], ss[R];
    __syncwarp(mask);   // the previous step's tableau has read w, tk, lm
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float cx = 0.f;
#pragma unroll
      for (int j = 0; j < NA; ++j) cx += cr[r][j] * x[j];
      rp[r] = cx + s[r] - dr[r];
      rc[r] = lam[r] * s[r] - sigma * mu;
      ss[r] = nmax(s[r], 1e-7f);
      const float w = nmin(lam[r] / ss[r], 1e10f);
      if (v[r]) {
        const int k = tl + G * r;
        ws[k] = w;
        tks[k] = w * rp[r] - rc[r] / ss[r];
        lms[k] = lam[r];
      }
    }
    __syncwarp(mask);
    // -- the tableau [P + C'WC + 1e-8 I | -(Px + q + C'lam + C'tk)], one
    // column a lane: lane j < NA sums w_k C_kj C_k, lane NA sums lam_k C_k
    // and tk_k C_k (kept apart, as the plain version adds them) --
    float h1[NA], h2[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      h1[i] = 0.f;
      h2[i] = 0.f;
    }
    const int jc = tl < NA ? tl : 0;
#pragma unroll
    for (int k = 0; k < m; ++k) {   // a compile-time count when FIXED
      const float* Ck = Cs + k * LDC;
      const float f1 = tl < NA ? ws[k] * Ck[jc] : (tl == NA ? lms[k] : 0.f);
      const float f2 = tl == NA ? tks[k] : 0.f;
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        h1[i] += f1 * Ck[i];
        h2[i] += f2 * Ck[i];
      }
    }
    float col[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      float px = 0.f;
      if (tl == NA) {
#pragma unroll
        for (int j = 0; j < NA; ++j) px += Ps[i * NA + j] * x[j];
      }
      const float rd = (px + qs[i]) + h1[i];
      col[i] = tl == NA ? -(rd + h2[i])
                        : (pcol[i] + h1[i]) + (i == tl ? 1e-8f : 0.f);
    }
    gauss_jordan<NA, G>(col, mask);   // col = dx in every lane

    // -- the step: fraction to the boundary over the tile's rows --
    float ds[R], dl[R];
    float mstep = INFINITY;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float cdx = 0.f;
#pragma unroll
      for (int j = 0; j < NA; ++j) cdx += cr[r][j] * col[j];
      ds[r] = -rp[r] - cdx;
      dl[r] = (-rc[r] - lam[r] * ds[r]) / ss[r];
      const float ratio_s = ds[r] < 0.f ? -s[r] / ds[r] : INFINITY;
      const float ratio_l = dl[r] < 0.f ? -lam[r] / dl[r] : INFINITY;
      if (v[r]) mstep = nmin(mstep, nmin(ratio_s, ratio_l));
    }
    const float alpha = nmin(1.f, 0.995f * tile_nmin<G>(mstep, mask));
    bool fin = true;
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      x[i] = x[i] + alpha * col[i];
      fin = fin && isfinite(x[i]);
    }
    if (fin) {
#pragma unroll
      for (int i = 0; i < NA; ++i) xk[i] = x[i];
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      s[r] = s[r] + alpha * ds[r];
      lam[r] = lam[r] + alpha * dl[r];
    }
  }

  if (live) {
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      if (i == tl && i < n) x_out[b * n + i] = xk[i];
    }
    if (lam_out != nullptr) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (v[r]) {
          lam_out[b * m + tl + G * r] = isfinite(lam[r]) ? lam[r] : 0.f;
        }
      }
    }
  }
}

template <int NA, int MA, int G, bool FIXED>
int launch(const float* P, const float* q, const float* C, const float* d,
           const float* x0, const float* lam0, float* x_out, float* lam_out,
           int B, int n, int m, int iters, float sigma, void* stream) {
  constexpr int QPB = kThreads / G;
  const int blocks = (B + QPB - 1) / QPB;
  pdip_kernel<NA, MA, G, FIXED><<<blocks, kThreads, 0,
                                  (cudaStream_t)stream>>>(
      P, q, C, d, x0, lam0, x_out, lam_out, B, n, m, iters, sigma);
  return (int)cudaGetLastError();
}

}  // namespace

// The lanes of a QP's tile for an (n, m) problem: 8, 16 or 32 for a
// model's compile-time instance, 32 for the generic one, -1 past the
// limits.
extern "C" int pdip_lanes(int n, int m) {
  if (n < 1 || n > kMaxN || m < 1 || m > kMaxM) return -1;
  if (n == 7 && m == 10) return 16;
  if (n == 5 && m == 2) return 8;
  if (n == 5 && m == 18) return 32;
  if (n == 8 && m == 16) return 16;
  return 32;
}

// Launches the solve of B QPs on `stream`; x0/lam0 null for a cold start,
// lam_out null when the duals are not wanted.  Returns cudaGetLastError()
// as an int (0 on success).  All pointers are device pointers to
// contiguous f32 arrays in the batch-first layout above.
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
  if (n == 7 && m == 10) {
    return launch<7, 10, 16, true>(P, q, C, d, x0, lam0, x_out, lam_out, B,
                                   n, m, iters, sigma, stream);
  }
  if (n == 5 && m == 2) {
    return launch<5, 2, 8, true>(P, q, C, d, x0, lam0, x_out, lam_out, B, n,
                                 m, iters, sigma, stream);
  }
  if (n == 5 && m == 18) {
    return launch<5, 18, 32, true>(P, q, C, d, x0, lam0, x_out, lam_out, B,
                                   n, m, iters, sigma, stream);
  }
  if (n == 8 && m == 16) {
    return launch<8, 16, 16, true>(P, q, C, d, x0, lam0, x_out, lam_out, B,
                                   n, m, iters, sigma, stream);
  }
  return launch<kMaxN, kMaxM, 32, false>(P, q, C, d, x0, lam0, x_out,
                                         lam_out, B, n, m, iters, sigma,
                                         stream);
}

extern "C" const char* pdip_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
