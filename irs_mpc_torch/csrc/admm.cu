// K3: the whole boxed-ADMM loop of the trajectory QP in one launch.
//
// Replaces the TPU kernel of the JAX package,
// ops/pallas_admm.py::_make_kernel (wrapper solve_boxed_tvlqr_pallas), and
// computes what ops/admm.py::solve_boxed_tvlqr's factored sweep loop
// computes.  The box penalties change only the LINEAR cost terms between
// sweeps (every quadratic penalty is rho S'S for a constant selector), so:
//
// 1. one Riccati factorisation over the penalised quadratics (the host
//    wrapper adds them to Q, R, N, Qf), T steps in reverse from P = Qf:
//      H = R + B'PB,  G = N' + B'PA,  Hinv = H^{-1} (Gauss-Jordan on
//      [H | I], no pivoting),  K = Hinv G,  Pc = P c,
//      P <- sym(Q + A'PA - G'K),
//    and per knot the closed-loop operands of the sweeps:
//      M = A - B K,  HB = Hinv B',  qa = q + M'Pc;
// 2. `iters` sweeps, each
//      (a) the penalised linear terms of every knot at once, from the
//          previous sweep's z and y:  r~, q~ = r, q + the penalties of each
//          enabled kind,  w_t = qa_t + (q~_t - q_t) - K_t'r~_t,
//          k_t = Hinv_t r~_t;
//      (b) the affine backward pass in closed-loop form, one chain:
//          p_T = qf - rho [x-box z - y at T],  p_t = w_t + M_t'p_{t+1}
//          (since G'k = K'(r~ + B'v) with v = Pc + p, the recursion
//          p <- q~ + A'v - G'k of the plain loop is q~ - K'r~ + M'v);
//      (c) every knot at once: k_t += HB_t (Pc_t + p_{t+1}),
//          e_t = c_t - B_t k_t;
//      (d) the rollout in closed-loop form, one chain from x0:
//          x_{t+1} = M_t x_t + e_t  (= A x + B u + c with u = -(K x + k));
//      (e) every knot at once: u_t = -(K_t x_t + k_t), and the
//          over-relaxed consensus and dual updates of every enabled kind,
//            s_hat = a s + (1 - a) z,  z <- clip(s_hat + y, lb, ub),
//            y <- y + s_hat - z,
//          with s the stage value of the kind (x, u, x_{t+1} - x_t, or
//          u_t - w_t with w_t = x_t[n_phys:]).
// It writes x, u and k of the last sweep, K, and z and z_prev per kind.
//
// What bounds it on an H100: latency.  A sweep is two chains of T
// dependent n x n matrix-vector steps (n = 7 at box pushing, 50 at
// carrots) and a few steps in which every knot is independent; far too
// little work to fill an SM, so the time is the length of the chains.  The
// design shortens them: one block of 256 threads runs the factorisation
// and the knot-parallel phases (a, c, e) between __syncthreads(); the two
// chains (b, d) run on warp 0 alone, one matrix-vector product per knot,
// each lane owning one row (two when n > 32), the vector broadcast by
// __shfl_sync, with no barrier inside a knot.  The chains are compiled for
// a width NB of 8, 16, 32 or 64 (n rounded up) and unrolled to it, so that
// every load has a compile-time offset and issues before the FMAs need it,
// and nothing branches inside a knot; M is stored with leading dimension
// NB + 1 (odd), so that lanes reading a row (the rollout) or a column (the
// backward pass) hit distinct banks.  The per-knot operands the sweeps
// read (M, K, HB, B, Hinv, c, Pc, qa, r and the sweep's vectors, about
// n(NB + 1) + 3nm + m^2 + 5n + 3m + 64 floats a knot) are written to
// shared memory once, by the factorisation, when T knots of them fit
// beside its work area (box pushing ~51 KB, carrots ~197 KB); otherwise
// they go to a global scratch and each chain prefetches knot t -+ 1 into a
// two-slot ring in shared memory with cp.async while it computes knot t.
// All sums are f32; no fast-math.
//
// Limits: n <= 64, m <= 16.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxN = 64;
constexpr int kMaxM = 16;
constexpr unsigned kFull = 0xffffffffu;

enum { kX = 0, kU = 1, kDx = 2, kDu = 3, kKinds = 4 };

struct Bound {
  const float* lb;   // (Tk, dk)
  const float* ub;
  float* z;          // (Tk, dk), holds z0 on entry
  float* zp;         // (Tk, dk), z_prev
  float* y;          // (Tk, dk), holds y0 on entry
  int on;
};

struct Bounds {
  Bound b[kKinds];
};

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

// The chains' width: n rounded up to 8, 16, 32 or 64.  M is stored with
// leading dimension NB + 1 (odd), so that the chains' loads have
// compile-time offsets and lanes reading a row or a column of M hit
// distinct banks.
__host__ __device__ inline int chain_width(int n) {
  return n <= 8 ? 8 : n <= 16 ? 16 : n <= 32 ? 32 : 64;
}

// Offsets (floats) of one knot's operands; a knot takes `ks` floats, a
// multiple of 4, so that every knot starts 16-byte aligned.  The first
// `slot` floats (M and the chain's vector v) are what a chain reads.
struct Layout {
  int ld, slot, ks;
  int M, v, K, HB, B, Hi, c, Pc, qa, r, rt, kv, pn, xn;
};

__host__ __device__ inline Layout make_layout(int n, int m) {
  Layout L;
  L.ld = chain_width(n) + 1;
  L.M = 0;
  L.v = n * L.ld;                 // w_t in the backward pass, e_t forward
  L.slot = round4(L.v + n);
  L.K = L.slot;                   // m*n
  L.HB = L.K + m * n;             // m*n
  L.B = L.HB + m * n;             // n*m
  L.Hi = L.B + n * m;             // m*m
  L.c = L.Hi + m * m;             // n
  L.Pc = L.c + n;                 // n
  L.qa = L.Pc + n;                // n
  L.r = L.qa + n;                 // m
  L.rt = L.r + m;                 // m   penalised r~
  L.kv = L.rt + m;                // m   k of the sweep
  // p_{t+1} and x_{t+1}, written by the chains' lanes: 32 floats each (64
  // when the lanes hold two rows).
  const int lanes = L.ld > 33 ? 64 : 32;
  L.pn = L.kv + m;
  L.xn = L.pn + lanes;
  L.ks = round4(L.xn + lanes);
  return L;
}

// The factorisation's work area: P, PA (n*n each), PB (n*m), G (m*n),
// the tableau [H | I] (m*2m), and the pivot row and column (3m).
__host__ __device__ inline int work_floats(int n, int m) {
  return round4(2 * n * n + 2 * n * m + 2 * m * m + 3 * m);
}

__host__ __device__ inline size_t smem_bytes(int T, int n, int m,
                                             bool staged) {
  const Layout L = make_layout(n, m);
  const size_t ops = staged ? (size_t)T * L.ks : 2 * (size_t)L.slot;
  return (work_floats(n, m) + ops) * sizeof(float);
}

__device__ __forceinline__ float nmin(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fminf(a, b);
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fmaxf(a, b);
}

// One step of a chain on warp 0, for the rows i0 = lane and i1 = lane + 32
// (when NB = 64): out_i = v[i] + sum_j M(i, j) s_j with s_j in lane j % 32
// of s0 (j < 32) or s1.  M (row-major, leading dimension NB + 1) starts at
// sm[mo] and v at sm[vo], both in shared memory; BACK reads M' (a column of
// M per row).  The loop is unrolled to NB with predicated loads, so that
// every load and shuffle issues before the FMAs need them; lanes past n
// carry s = 0, which makes the padding columns add nothing.  Four partial
// sums a row shorten the dependent FMA chain.
template <int NB, bool BACK>
__device__ __forceinline__ void chain_step(const float* sm, int mo, int vo,
                                           int n, int lane, float& s0,
                                           float& s1) {
  constexpr int LD = NB + 1;
  constexpr bool TWO = NB > 32;
  const int i0 = lane < n ? lane : 0;
  const int i1 = lane + 32 < n ? lane + 32 : 0;
  const int r0 = mo + (BACK ? i0 : i0 * LD);
  const int r1 = mo + (BACK ? i1 : i1 * LD);
  float a0[4] = {sm[vo + i0], 0.f, 0.f, 0.f};
  float a1[4] = {TWO ? sm[vo + i1] : 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const float sj = __shfl_sync(kFull, j < 32 ? s0 : s1, j & 31);
    const int off = BACK ? j * LD : j;
    const float m0 = j < n ? sm[r0 + off] : 0.f;
    a0[j & 3] = fmaf(m0, sj, a0[j & 3]);
    if (TWO) {
      const float m1 = j < n ? sm[r1 + off] : 0.f;
      a1[j & 3] = fmaf(m1, sj, a1[j & 3]);
    }
  }
  s0 = lane < n ? (a0[0] + a0[1]) + (a0[2] + a0[3]) : 0.f;
  if (TWO) s1 = lane + 32 < n ? (a1[0] + a1[1]) + (a1[2] + a1[3]) : 0.f;
}

// Warp 0: copy a knot's first `floats` floats (a multiple of 4, 16-byte
// aligned) into a ring slot with cp.async, as one commit group.
__device__ __forceinline__ void fetch(float* dst, const float* src,
                                      int floats, int lane) {
  for (int q = lane; q < floats / 4; q += 32) {
    __pipeline_memcpy_async(dst + 4 * q, src + 4 * q, 16);
  }
  __pipeline_commit();
}

// Where knot t's [M | v] lies in shared memory (an offset into sm): in the
// staged operands at `base`, or in ring slot t & 1 at `base`, after its
// cp.async copy from the global scratch `ops` has landed.  `next` is the
// knot the chain reads after t (or -1), whose copy starts here.
template <bool STAGED>
__device__ __forceinline__ int knot_slot(float* sm, int base,
                                         const float* ops, const Layout& L,
                                         int t, int next, int lane) {
  if (STAGED) return base + t * L.ks;
  if (next >= 0) {
    fetch(sm + base + (next & 1) * L.slot, ops + (size_t)next * L.ks,
          L.slot, lane);
    __pipeline_wait_prior(1);
  } else {
    __pipeline_wait_prior(0);
  }
  __syncwarp();
  return base + (t & 1) * L.slot;
}

// The backward chain on warp 0: p_T in the lanes' p0/p1, then
// p_t = w_t + M_t'p_{t+1}, storing p_{t+1} in knot t's pn slot (every lane:
// the lanes past n store their zeros into the slot's padding).  `ops` is
// the knots' operands (shared memory when STAGED, else the global scratch).
template <int NB, bool STAGED>
__device__ __forceinline__ void backward_chain(float* sm, int base,
                                               float* ops, const Layout& L,
                                               int T, int n, int lane,
                                               float p0, float p1) {
  if (!STAGED) fetch(sm + base + ((T - 1) & 1) * L.slot,
                     ops + (size_t)(T - 1) * L.ks, L.slot, lane);
  for (int t = T - 1; t >= 0; --t) {
    const int kb = knot_slot<STAGED>(sm, base, ops, L, t, t - 1, lane);
    float* pt = (STAGED ? sm + base : ops) + (size_t)t * L.ks + L.pn;
    pt[lane] = p0;
    if (NB > 32) pt[lane + 32] = p1;
    chain_step<NB, true>(sm, kb + L.M, kb + L.v, n, lane, p0, p1);
    if (!STAGED) __syncwarp();   // the slot is refilled two knots on
  }
}

// The forward chain on warp 0: x_{t+1} = M_t x_t + e_t from x0, stored in
// knot t's xn slot (as pn above).
template <int NB, bool STAGED>
__device__ __forceinline__ void forward_chain(float* sm, int base,
                                              float* ops, const Layout& L,
                                              const float* x0, int T, int n,
                                              int lane) {
  float s0 = lane < n ? x0[lane] : 0.f;
  float s1 = lane + 32 < n ? x0[lane + 32] : 0.f;
  if (!STAGED) fetch(sm + base, ops, L.slot, lane);
  for (int t = 0; t < T; ++t) {
    const int kb = knot_slot<STAGED>(sm, base, ops, L, t,
                                     t + 1 < T ? t + 1 : -1, lane);
    chain_step<NB, false>(sm, kb + L.M, kb + L.v, n, lane, s0, s1);
    float* xt = (STAGED ? sm + base : ops) + (size_t)t * L.ks + L.xn;
    xt[lane] = s0;
    if (NB > 32) xt[lane + 32] = s1;
    if (!STAGED) __syncwarp();
  }
}

template <int NB>
__global__ void __launch_bounds__(kThreads)
admm_kernel(const float* __restrict__ A,    // (T,n,n)
            const float* __restrict__ B,    // (T,n,m)
            const float* __restrict__ c,    // (T,n)
            const float* __restrict__ Q,    // (T,n,n) penalised
            const float* __restrict__ R,    // (T,m,m) penalised
            const float* __restrict__ N,    // (T,n,m) penalised
            const float* __restrict__ q,    // (T,n)
            const float* __restrict__ r,    // (T,m)
            const float* __restrict__ Qf,   // (n,n) penalised
            const float* __restrict__ qf,   // (n,)
            const float* __restrict__ x0,   // (n,)
            float* __restrict__ ops_g,      // (T, ks) scratch, streamed only
            float* __restrict__ x_out,      // (T+1,n)
            float* __restrict__ u_out,      // (T,m)
            float* __restrict__ K_out,      // (T,m,n)
            float* __restrict__ k_out,      // (T,m)
            Bounds bd, int T, int n, int m, int n_phys, int iters, float rho,
            float a, int staged) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout L = make_layout(n, m);
  const int W = work_floats(n, m);
  const int w2 = 2 * m;
  float* P = smem;            // n*n
  float* PA = P + n * n;      // n*n
  float* PB = PA + n * n;     // n*m
  float* G = PB + n * m;      // m*n
  float* tab = G + m * n;     // m*2m  [H | I] -> [I | Hinv]
  float* fac = tab + m * w2;  // m     pivot column
  float* rowk = fac + m;      // m     scaled pivot row, H half
  float* rowk2 = rowk + m;    // m     scaled pivot row, identity half
  // The knots' operands: in shared memory after the work area when
  // staged, else in the global scratch, with the chains' two-slot ring in
  // shared memory there.
  float* ops = staged ? smem + W : ops_g;

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const bool warp0 = tid < 32;
  const Bound& bx = bd.b[kX];
  const Bound& bu = bd.b[kU];
  const Bound& bdx = bd.b[kDx];
  const Bound& bdu = bd.b[kDu];

  // ---- 1. factorisation and the closed-loop operands -------------------
  for (int e = tid; e < n * n; e += nt) P[e] = Qf[e];
  __syncthreads();
  for (int t = T - 1; t >= 0; --t) {
    const float* At = A + (size_t)t * n * n;
    const float* Bt = B + (size_t)t * n * m;
    const float* ct = c + (size_t)t * n;
    const float* Rt = R + (size_t)t * m * m;
    const float* Nt = N + (size_t)t * n * m;
    const float* Qt = Q + (size_t)t * n * n;
    float* kn = ops + (size_t)t * L.ks;
    for (int e = tid; e < n * n + n * m + n; e += nt) {
      float s = 0.f;
      if (e < n * n) {
        const int i = e / n, j = e % n;
        for (int l = 0; l < n; ++l) s += P[i * n + l] * At[l * n + j];
        PA[e] = s;
      } else if (e < n * n + n * m) {
        const int e2 = e - n * n, i = e2 / m, j = e2 % m;
        for (int l = 0; l < n; ++l) s += P[i * n + l] * Bt[l * m + j];
        PB[e2] = s;
      } else {
        const int i = e - n * n - n * m;
        for (int l = 0; l < n; ++l) s += P[i * n + l] * ct[l];
        kn[L.Pc + i] = s;
      }
    }
    __syncthreads();
    // Tableau [H | I] and G.
    for (int e = tid; e < m * w2 + m * n; e += nt) {
      if (e < m * w2) {
        const int i = e / w2, j = e % w2;
        float s;
        if (j < m) {
          s = Rt[i * m + j];
          for (int l = 0; l < n; ++l) s += Bt[l * m + i] * PB[l * m + j];
        } else {
          s = (j - m == i) ? 1.f : 0.f;
        }
        tab[e] = s;
      } else {
        const int e2 = e - m * w2, i = e2 / n, j = e2 % n;
        float s = Nt[j * m + i];
        for (int l = 0; l < n; ++l) s += Bt[l * m + i] * PA[l * n + j];
        G[e2] = s;
      }
    }
    __syncthreads();
    // Gauss-Jordan, no pivoting; the scaled pivot row and the pivot column
    // are copied first so the update reads nothing another thread writes.
    for (int kk = 0; kk < m; ++kk) {
      for (int e = tid; e < w2 + m; e += nt) {
        if (e < w2) {
          const float val = tab[kk * w2 + e] / tab[kk * w2 + kk];
          if (e < m) rowk[e] = val; else rowk2[e - m] = val;
        } else {
          fac[e - w2] = tab[(e - w2) * w2 + kk];
        }
      }
      __syncthreads();
      for (int e = tid; e < m * w2; e += nt) {
        const int i = e / w2, j = e % w2;
        const float rk = j < m ? rowk[j] : rowk2[j - m];
        tab[e] = (i == kk) ? rk : tab[e] - fac[i] * rk;
      }
      __syncthreads();
    }
    // Hinv, K = Hinv G, and the staged copies of B, c, r.
    for (int e = tid; e < m * m + m * n + n * m + n + m; e += nt) {
      if (e < m * m) {
        const int i = e / m, j = e % m;
        kn[L.Hi + e] = tab[i * w2 + m + j];
      } else if (e < m * m + m * n) {
        const int e2 = e - m * m, i = e2 / n, j = e2 % n;
        float s = 0.f;
        for (int l = 0; l < m; ++l) s += tab[i * w2 + m + l] * G[l * n + j];
        kn[L.K + e2] = s;
        K_out[(size_t)t * m * n + e2] = s;
      } else if (e < m * m + m * n + n * m) {
        const int e2 = e - m * m - m * n;
        kn[L.B + e2] = Bt[e2];
      } else if (e < m * m + m * n + n * m + n) {
        const int i = e - m * m - m * n - n * m;
        kn[L.c + i] = ct[i];
      } else {
        const int j = e - m * m - m * n - n * m - n;
        kn[L.r + j] = r[(size_t)t * m + j];
      }
    }
    __syncthreads();
    // P_t before symmetrising (into P: nothing reads P_{t+1} any more),
    // M = A - B K and HB = Hinv B'.
    for (int e = tid; e < n * n + n * n + m * n; e += nt) {
      if (e < n * n) {
        const int i = e / n, j = e % n;
        float s = 0.f;
        for (int l = 0; l < n; ++l) s += At[l * n + i] * PA[l * n + j];
        float gk = 0.f;
        for (int l = 0; l < m; ++l) gk += G[l * n + i] * kn[L.K + l * n + j];
        P[e] = Qt[e] + s - gk;
      } else if (e < 2 * n * n) {
        const int e2 = e - n * n, i = e2 / n, j = e2 % n;
        float s = At[i * n + j];
        for (int l = 0; l < m; ++l) s -= Bt[i * m + l] * kn[L.K + l * n + j];
        kn[L.M + i * L.ld + j] = s;
      } else {
        const int e2 = e - 2 * n * n, i = e2 / n, j = e2 % n;
        float s = 0.f;
        for (int l = 0; l < m; ++l) s += kn[L.Hi + i * m + l] * Bt[j * m + l];
        kn[L.HB + e2] = s;
      }
    }
    __syncthreads();
    // Symmetrise P in place (each pair i < j by one thread), and
    // qa = q + M'Pc.
    for (int e = tid; e < n * n + n; e += nt) {
      if (e < n * n) {
        const int i = e / n, j = e % n;
        if (i < j) {
          const float s = 0.5f * (P[i * n + j] + P[j * n + i]);
          P[i * n + j] = s;
          P[j * n + i] = s;
        }
      } else {
        const int i = e - n * n;
        float s = 0.f;
        for (int l = 0; l < n; ++l) {
          s += kn[L.M + l * L.ld + i] * kn[L.Pc + l];
        }
        kn[L.qa + i] = q[(size_t)t * n + i] + s;
      }
    }
    __syncthreads();
  }

  // z_prev starts at z0.
  for (int kind = 0; kind < kKinds; ++kind) {
    const Bound& bk = bd.b[kind];
    if (!bk.on) continue;
    const int len = (kind == kX ? (T + 1) * n_phys
                     : kind == kDx ? T * n_phys : T * m);
    for (int e = tid; e < len; e += nt) bk.zp[e] = bk.z[e];
  }
  __syncthreads();

  // ---- 2. the sweeps ----------------------------------------------------
  for (int sweep = 0; sweep < iters; ++sweep) {
    // (a) r~ of every knot ...
    for (int e = tid; e < T * m; e += nt) {
      const int t = e / m, j = e % m;
      const float* kn = ops + (size_t)t * L.ks;
      float s = kn[L.r + j];
      if (bu.on) s -= rho * (bu.z[e] - bu.y[e]);
      if (bdx.on) {
        // + rho B_t[:n_phys]' e,  e = c_t[:n_phys] - (z - y).
        float acc = 0.f;
        for (int l = 0; l < n_phys; ++l) {
          const size_t o = (size_t)t * n_phys + l;
          acc += kn[L.B + l * m + j] * (kn[L.c + l] - (bdx.z[o] - bdx.y[o]));
        }
        s += rho * acc;
      }
      if (bdu.on) s -= rho * (bdu.z[e] - bdu.y[e]);
      ops[(size_t)t * L.ks + L.rt + j] = s;
    }
    __syncthreads();
    // ... then w = qa + (q~ - q) - K'r~ and k = Hinv r~.
    for (int e = tid; e < T * (n + m); e += nt) {
      const int t = e / (n + m), i = e % (n + m);
      float* kn = ops + (size_t)t * L.ks;
      if (i < n) {
        float s = kn[L.qa + i];
        if (bx.on && i < n_phys) {
          const size_t o = (size_t)t * n_phys + i;
          s -= rho * (bx.z[o] - bx.y[o]);
        }
        if (bdx.on) {
          // + rho D_t' e,  D_t = A_t[:n_phys] - I[:n_phys].
          const float* At = A + (size_t)t * n * n;
          float acc = 0.f;
          for (int l = 0; l < n_phys; ++l) {
            const size_t o = (size_t)t * n_phys + l;
            const float el = kn[L.c + l] - (bdx.z[o] - bdx.y[o]);
            acc += (At[l * n + i] - (l == i ? 1.f : 0.f)) * el;
          }
          s += rho * acc;
        }
        if (bdu.on && i >= n_phys) {
          const size_t o = (size_t)t * m + (i - n_phys);
          s += rho * (bdu.z[o] - bdu.y[o]);
        }
        float kr = 0.f;
        for (int l = 0; l < m; ++l) kr += kn[L.K + l * n + i] * kn[L.rt + l];
        kn[L.v + i] = s - kr;
      } else {
        const int j = i - n;
        float s = 0.f;
        for (int l = 0; l < m; ++l) s += kn[L.Hi + j * m + l] * kn[L.rt + l];
        kn[L.kv + j] = s;
      }
    }
    __syncthreads();
    // (b) the backward chain on warp 0.
    if (warp0) {
      float p0 = 0.f, p1 = 0.f;
      for (int h = 0; h < 2; ++h) {
        const int i = lane + 32 * h;
        if (i >= n) continue;
        float s = qf[i];
        if (bx.on && i < n_phys) {
          const size_t o = (size_t)T * n_phys + i;
          s -= rho * (bx.z[o] - bx.y[o]);
        }
        if (h == 0) p0 = s; else p1 = s;
      }
      if (staged) {
        backward_chain<NB, true>(smem, W, ops, L, T, n, lane, p0, p1);
      } else {
        backward_chain<NB, false>(smem, W, ops, L, T, n, lane, p0, p1);
      }
    }
    __syncthreads();
    // (c) k += HB (Pc + p_{t+1}) ...
    for (int e = tid; e < T * m; e += nt) {
      const int t = e / m, j = e % m;
      float* kn = ops + (size_t)t * L.ks;
      const float* pt = kn + L.pn;
      float s = 0.f;
      for (int l = 0; l < n; ++l) {
        s += kn[L.HB + j * n + l] * (kn[L.Pc + l] + pt[l]);
      }
      s += kn[L.kv + j];
      kn[L.kv + j] = s;
      k_out[e] = s;
    }
    __syncthreads();
    // ... then e = c - B k.
    for (int e = tid; e < T * n; e += nt) {
      const int t = e / n, i = e % n;
      float* kn = ops + (size_t)t * L.ks;
      float s = 0.f;
      for (int l = 0; l < m; ++l) s += kn[L.B + i * m + l] * kn[L.kv + l];
      kn[L.v + i] = kn[L.c + i] - s;
    }
    __syncthreads();
    // (d) the rollout chain on warp 0.
    if (warp0) {
      if (staged) {
        forward_chain<NB, true>(smem, W, ops, L, x0, T, n, lane);
      } else {
        forward_chain<NB, false>(smem, W, ops, L, x0, T, n, lane);
      }
    }
    __syncthreads();
    // (e) u = -(K x + k), and x out of the knots' slots ...
    for (int e = tid; e < T * m + (T + 1) * n; e += nt) {
      if (e < T * m) {
        const int t = e / m, j = e % m;
        const float* kn = ops + (size_t)t * L.ks;
        const float* xt = t ? ops + (size_t)(t - 1) * L.ks + L.xn : x0;
        float s = 0.f;
        for (int l = 0; l < n; ++l) s += kn[L.K + j * n + l] * xt[l];
        u_out[e] = -(s + kn[L.kv + j]);
      } else {
        const int e2 = e - T * m, t = e2 / n, i = e2 % n;
        x_out[e2] = t ? ops[(size_t)(t - 1) * L.ks + L.xn + i] : x0[i];
      }
    }
    __syncthreads();
    // ... then the over-relaxed consensus and dual updates, entry by entry.
    for (int kind = 0; kind < kKinds; ++kind) {
      const Bound& bk = bd.b[kind];
      if (!bk.on) continue;
      const int dk = (kind == kX || kind == kDx) ? n_phys : m;
      const int len = (kind == kX ? T + 1 : T) * dk;
      for (int e = tid; e < len; e += nt) {
        const int t = e / dk, i = e % dk;
        float s;
        if (kind == kX) {
          s = x_out[(size_t)t * n + i];
        } else if (kind == kU) {
          s = u_out[(size_t)t * m + i];
        } else if (kind == kDx) {
          s = x_out[(size_t)(t + 1) * n + i] - x_out[(size_t)t * n + i];
        } else {
          s = u_out[(size_t)t * m + i] - x_out[(size_t)t * n + n_phys + i];
        }
        const float z_old = bk.z[e];
        bk.zp[e] = z_old;
        const float sh = a * s + (1.f - a) * z_old;
        const float z_new = nmin(nmax(sh + bk.y[e], bk.lb[e]), bk.ub[e]);
        bk.z[e] = z_new;
        bk.y[e] = bk.y[e] + sh - z_new;
      }
    }
    __syncthreads();
  }
}

// Opts in to `smem` bytes of dynamic shared memory where that is past the
// default 48 KB, launches the instance of width NB and returns a CUDA error
// code: the attribute call's, else cudaGetLastError() after the launch.
template <int NB>
int launch(size_t smem, void* stream, const float* A, const float* B,
           const float* c, const float* Q, const float* R, const float* N,
           const float* q, const float* r, const float* Qf, const float* qf,
           const float* x0, float* ops, float* x_out,
           float* u_out, float* K, float* k, const Bounds& bd, int T, int n,
           int m, int n_phys, int iters, float rho, float a, int staged) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        admm_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  admm_kernel<NB><<<1, kThreads, smem, (cudaStream_t)stream>>>(
      A, B, c, Q, R, N, q, r, Qf, qf, x0, ops, x_out, u_out, K, k, bd, T, n,
      m, n_phys, iters, rho, a, staged);
  return (int)cudaGetLastError();
}

bool valid(int T, int n, int m) {
  return T >= 1 && n >= 1 && n <= kMaxN && m >= 1 && m <= kMaxM;
}

// The largest dynamic shared memory a block of the current device may opt
// in to, or -1 on an error.
int max_smem_optin() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess) {
    return -1;
  }
  return bytes;
}

}  // namespace

// 1 if the knots' operands of a (T, n, m) problem fit in shared memory on
// the current device (the staged placement), 0 if they are streamed from
// the global scratch, -1 on invalid sizes or a failed device query.
extern "C" int admm_staged(int T, int n, int m) {
  if (!valid(T, n, m)) return -1;
  const int cap = max_smem_optin();
  if (cap < 0) return -1;
  return smem_bytes(T, n, m, true) <= (size_t)cap ? 1 : 0;
}

// Floats of the global scratch the streamed placement needs (T knots).
extern "C" int admm_ops_floats(int T, int n, int m) {
  return valid(T, n, m) ? T * make_layout(n, m).ks : -1;
}

// Launches the whole loop on `stream` and returns a CUDA error code as an
// int (0 on success): the attribute call's, when the launch needs more than
// 48 KB of shared memory (it fails where `staged` asks for more than the
// device has), else cudaGetLastError() after the launch.  `staged` is the
// placement of the knots' operands (admm_staged); `ops` (admm_ops_floats
// floats) may be null when it is 1.  lb/ub/z/zp/y of a disabled kind may
// be null; z and y of an enabled kind hold z0 and y0 on entry and are
// updated in place.
extern "C" int admm_boxed_f32(
    const float* A, const float* B, const float* c, const float* Q,
    const float* R, const float* N, const float* q, const float* r,
    const float* Qf, const float* qf, const float* x0, float* ops,
    float* x_out, float* u_out, float* K, float* k,
    const float* const* lb, const float* const* ub, float* const* z,
    float* const* zp, float* const* y, const int* on, int T, int n, int m,
    int n_phys, int iters, float rho, float a, int staged, void* stream) {
  if (!valid(T, n, m) || n_phys < 1 || n_phys > n || iters < 0 ||
      (on[kDu] && n - n_phys != m) || (staged != 0 && staged != 1) ||
      (!staged && ops == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  Bounds bd;
  for (int kind = 0; kind < kKinds; ++kind) {
    bd.b[kind] = Bound{lb[kind], ub[kind], z[kind], zp[kind], y[kind],
                       on[kind]};
  }
  const size_t smem = smem_bytes(T, n, m, staged == 1);
  switch (chain_width(n)) {
    case 8:
      return launch<8>(smem, stream, A, B, c, Q, R, N, q, r, Qf, qf, x0, ops,
                       x_out, u_out, K, k, bd, T, n, m, n_phys, iters,
                       rho, a, staged);
    case 16:
      return launch<16>(smem, stream, A, B, c, Q, R, N, q, r, Qf, qf, x0,
                        ops, x_out, u_out, K, k, bd, T, n, m, n_phys,
                        iters, rho, a, staged);
    case 32:
      return launch<32>(smem, stream, A, B, c, Q, R, N, q, r, Qf, qf, x0,
                        ops, x_out, u_out, K, k, bd, T, n, m, n_phys,
                        iters, rho, a, staged);
    default:
      return launch<64>(smem, stream, A, B, c, Q, R, N, q, r, Qf, qf, x0,
                        ops, x_out, u_out, K, k, bd, T, n, m, n_phys,
                        iters, rho, a, staged);
  }
}

extern "C" const char* admm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
