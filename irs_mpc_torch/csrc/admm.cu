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
//      P <- sym(Q + A'PA - G'K);
// 2. `iters` sweeps of
//      the affine backward pass, from p = qf - rho [x-box z - y at T]:
//        q~, r~ = q, r + the penalties of each enabled kind at t,
//        v = Pc_t + p,  k_t = Hinv_t (r~ + B'v),  p <- q~ + A'v - G_t'k_t;
//      the rollout x_{t+1} = A x + B u + c, u = -(K x + k), from x0;
//      the over-relaxed consensus and dual updates of every enabled kind,
//        s_hat = a s + (1 - a) z,  z <- clip(s_hat + y, lb, ub),
//        y <- y + s_hat - z,
//      with s the stage value of the kind (x, u, x_{t+1} - x_t, or
//      u_t - w_t with w_t = x_t[n_phys:]).
// It writes x, u and k of the last sweep, K, and z and z_prev per kind.
//
// What bounds it on an H100: latency.  Each sweep is 3T dependent small
// matrix-vector steps (n = 11, m = 4 on the planar hand), far too little
// work to fill one SM, so the time is the chain of dependent phases.  The
// design answers that with one launch of one block for the factorisation
// and every sweep: P, p, the current state and the per-step vectors live in
// shared memory, threads map over matrix and trajectory entries,
// __syncthreads() separates the phases, and nothing returns to the host
// between sweeps.  Hinv, G, Pc, y and the outputs live in global scratch
// the wrapper allocates (a few KB, L2-resident).  All sums are f32.
//
// Limits: n <= 32, m <= 16 (shared memory under 48 KB).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxN = 32;
constexpr int kMaxM = 16;

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

__host__ __device__ inline size_t smem_floats(int n, int m) {
  return 3 * (size_t)n * n + 2 * (size_t)n * m + 2 * (size_t)m * m
         + 4 * (size_t)n + 7 * (size_t)m;
}

__device__ __forceinline__ float nmin(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fminf(a, b);
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fmaxf(a, b);
}

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
            float* __restrict__ Hinv,       // (T,m,m) scratch
            float* __restrict__ Gs,         // (T,m,n) scratch
            float* __restrict__ Pcs,        // (T,n) scratch
            float* __restrict__ x_out,      // (T+1,n)
            float* __restrict__ u_out,      // (T,m)
            float* __restrict__ K,          // (T,m,n)
            float* __restrict__ k,          // (T,m)
            Bounds bd, int T, int n, int m, int n_phys, int iters, float rho,
            float a) {
  extern __shared__ float smem[];
  const int w2 = 2 * m;
  float* P = smem;            // n*n
  float* PA = P + n * n;      // n*n
  float* Pn = PA + n * n;     // n*n   P_t before symmetrising
  float* PB = Pn + n * n;     // n*m
  float* G = PB + n * m;      // m*n
  float* tab = G + m * n;     // m*2m  [H | I] -> [I | Hinv]
  float* p = tab + m * w2;    // n     value gradient
  float* xc = p + n;          // n     current state of the rollout
  float* qt = xc + n;         // n     penalised q_t
  float* v = qt + n;          // n     Pc_t + p
  float* rt = v + n;          // m     penalised r_t
  float* g = rt + m;          // m
  float* kv = g + m;          // m
  float* u = kv + m;          // m
  float* fac = u + m;         // m     pivot column
  float* rowk = fac + m;      // m     scaled pivot row, H half
  float* rowk2 = rowk + m;    // m     scaled pivot row, identity half

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const Bound& bx = bd.b[kX];
  const Bound& bu = bd.b[kU];
  const Bound& bdx = bd.b[kDx];
  const Bound& bdu = bd.b[kDu];

  // ---- 1. factorisation ----------------------------------------------
  for (int e = tid; e < n * n; e += nt) P[e] = Qf[e];
  __syncthreads();
  for (int t = T - 1; t >= 0; --t) {
    const float* At = A + (size_t)t * n * n;
    const float* Bt = B + (size_t)t * n * m;
    const float* ct = c + (size_t)t * n;
    const float* Rt = R + (size_t)t * m * m;
    const float* Nt = N + (size_t)t * n * m;
    const float* Qt = Q + (size_t)t * n * n;
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
        Pcs[(size_t)t * n + i] = s;
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
        Gs[(size_t)t * m * n + e2] = s;
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
    // Hinv, and K = Hinv G.
    float* Ht = Hinv + (size_t)t * m * m;
    float* Kt = K + (size_t)t * m * n;
    for (int e = tid; e < m * m + m * n; e += nt) {
      if (e < m * m) {
        const int i = e / m, j = e % m;
        Ht[e] = tab[i * w2 + m + j];
      } else {
        const int e2 = e - m * m, i = e2 / n, j = e2 % n;
        float s = 0.f;
        for (int l = 0; l < m; ++l) s += tab[i * w2 + m + l] * G[l * n + j];
        Kt[e2] = s;
      }
    }
    __syncthreads();
    // P_t = sym(Q + A'PA - G'K).  K_t is read back from global memory,
    // written by this block before the barrier above.
    for (int e = tid; e < n * n; e += nt) {
      const int i = e / n, j = e % n;
      float s = 0.f;
      for (int l = 0; l < n; ++l) s += At[l * n + i] * PA[l * n + j];
      float gk = 0.f;
      for (int l = 0; l < m; ++l) gk += G[l * n + i] * Kt[l * n + j];
      Pn[e] = Qt[e] + s - gk;
    }
    __syncthreads();
    for (int e = tid; e < n * n; e += nt) {
      const int i = e / n, j = e % n;
      P[e] = 0.5f * (Pn[i * n + j] + Pn[j * n + i]);
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
    for (int i = tid; i < n; i += nt) {
      float s = qf[i];
      if (bx.on && i < n_phys) {
        const size_t o = (size_t)T * n_phys + i;
        s -= rho * (bx.z[o] - bx.y[o]);
      }
      p[i] = s;
    }
    __syncthreads();
    for (int t = T - 1; t >= 0; --t) {
      const float* At = A + (size_t)t * n * n;
      const float* Bt = B + (size_t)t * n * m;
      const float* ct = c + (size_t)t * n;
      // Penalised linear terms of stage t, and v = Pc_t + p.
      for (int e = tid; e < n + m; e += nt) {
        if (e < n) {
          const int i = e;
          float s = q[(size_t)t * n + i];
          if (bx.on && i < n_phys) {
            const size_t o = (size_t)t * n_phys + i;
            s -= rho * (bx.z[o] - bx.y[o]);
          }
          if (bdx.on) {
            // + rho D_t' e,  D_t = A_t[:n_phys] - I[:n_phys],
            //   e = c_t[:n_phys] - (z - y).
            float acc = 0.f;
            for (int l = 0; l < n_phys; ++l) {
              const size_t o = (size_t)t * n_phys + l;
              const float el = ct[l] - (bdx.z[o] - bdx.y[o]);
              acc += (At[l * n + i] - (l == i ? 1.f : 0.f)) * el;
            }
            s += rho * acc;
          }
          if (bdu.on && i >= n_phys) {
            const size_t o = (size_t)t * m + (i - n_phys);
            s += rho * (bdu.z[o] - bdu.y[o]);
          }
          qt[i] = s;
          v[i] = Pcs[(size_t)t * n + i] + p[i];
        } else {
          const int j = e - n;
          float s = r[(size_t)t * m + j];
          if (bu.on) {
            const size_t o = (size_t)t * m + j;
            s -= rho * (bu.z[o] - bu.y[o]);
          }
          if (bdx.on) {
            float acc = 0.f;
            for (int l = 0; l < n_phys; ++l) {
              const size_t o = (size_t)t * n_phys + l;
              const float el = ct[l] - (bdx.z[o] - bdx.y[o]);
              acc += Bt[l * m + j] * el;
            }
            s += rho * acc;
          }
          if (bdu.on) {
            const size_t o = (size_t)t * m + j;
            s -= rho * (bdu.z[o] - bdu.y[o]);
          }
          rt[j] = s;
        }
      }
      __syncthreads();
      for (int j = tid; j < m; j += nt) {
        float s = rt[j];
        for (int l = 0; l < n; ++l) s += Bt[l * m + j] * v[l];
        g[j] = s;
      }
      __syncthreads();
      const float* Ht = Hinv + (size_t)t * m * m;
      for (int j = tid; j < m; j += nt) {
        float s = 0.f;
        for (int l = 0; l < m; ++l) s += Ht[j * m + l] * g[l];
        kv[j] = s;
        k[(size_t)t * m + j] = s;
      }
      __syncthreads();
      const float* Gt = Gs + (size_t)t * m * n;
      for (int i = tid; i < n; i += nt) {
        float s = 0.f;
        for (int l = 0; l < n; ++l) s += At[l * n + i] * v[l];
        float gk = 0.f;
        for (int l = 0; l < m; ++l) gk += Gt[l * n + i] * kv[l];
        p[i] = qt[i] + s - gk;
      }
      __syncthreads();
    }

    // Rollout under the fixed gains.
    for (int i = tid; i < n; i += nt) {
      xc[i] = x0[i];
      x_out[i] = x0[i];
    }
    __syncthreads();
    for (int t = 0; t < T; ++t) {
      const float* At = A + (size_t)t * n * n;
      const float* Bt = B + (size_t)t * n * m;
      const float* Kt = K + (size_t)t * m * n;
      for (int j = tid; j < m; j += nt) {
        float s = 0.f;
        for (int l = 0; l < n; ++l) s += Kt[j * n + l] * xc[l];
        u[j] = -(s + k[(size_t)t * m + j]);
        u_out[(size_t)t * m + j] = u[j];
      }
      __syncthreads();
      for (int i = tid; i < n; i += nt) {
        float s = 0.f;
        for (int l = 0; l < n; ++l) s += At[i * n + l] * xc[l];
        float su = 0.f;
        for (int l = 0; l < m; ++l) su += Bt[i * m + l] * u[l];
        x_out[(size_t)(t + 1) * n + i] = s + su + c[(size_t)t * n + i];
      }
      __syncthreads();
      for (int i = tid; i < n; i += nt) xc[i] = x_out[(size_t)(t + 1) * n + i];
      __syncthreads();
    }

    // Over-relaxed consensus and dual updates, entry by entry.
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

}  // namespace

// Launches the whole loop on `stream` and returns cudaGetLastError() as an
// int (0 on success).  lb/ub/z/zp/y of a disabled kind may be null; z and y
// of an enabled kind hold z0 and y0 on entry and are updated in place.
extern "C" int admm_boxed_f32(
    const float* A, const float* B, const float* c, const float* Q,
    const float* R, const float* N, const float* q, const float* r,
    const float* Qf, const float* qf, const float* x0, float* Hinv,
    float* G, float* Pc, float* x_out, float* u_out, float* K, float* k,
    const float* const* lb, const float* const* ub, float* const* z,
    float* const* zp, float* const* y, const int* on, int T, int n, int m,
    int n_phys, int iters, float rho, float a, void* stream) {
  if (T < 1 || n < 1 || n > kMaxN || m < 1 || m > kMaxM || n_phys < 1 ||
      n_phys > n || iters < 0 || (on[kDu] && n - n_phys != m)) {
    return (int)cudaErrorInvalidValue;
  }
  Bounds bd;
  for (int kind = 0; kind < kKinds; ++kind) {
    bd.b[kind] = Bound{lb[kind], ub[kind], z[kind], zp[kind], y[kind],
                       on[kind]};
  }
  const size_t smem = smem_floats(n, m) * sizeof(float);
  admm_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      A, B, c, Q, R, N, q, r, Qf, qf, x0, Hinv, G, Pc, x_out, u_out, K, k,
      bd, T, n, m, n_phys, iters, rho, a);
  return (int)cudaGetLastError();
}

extern "C" const char* admm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
