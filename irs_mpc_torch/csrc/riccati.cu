// K1: the whole time-varying LQR Riccati backward pass in one launch.
//
// Replaces the TPU kernel of the JAX package,
// ops/pallas_riccati.py::_riccati_kernel (with its solve helper
// _gauss_solve_rows and the wrapper riccati_backward_pallas).  It runs the
// T steps in reverse from P = Qf, p = qf:
//
//   H = R + B'PB,  G = N' + B'PA,  g = r + B'(Pc + p)
//   [K | k] = H^{-1} [G | g]           Gauss-Jordan, no pivoting
//   P <- (S + S')/2,  S = Q + A'PA - G'K
//   p <- q + A'(Pc + p) - G'k
//
// and writes K (T,m,n) and k (T,m).  P and p never leave shared memory.
//
// What bounds it on an H100: latency.  The recursion is T dependent steps of
// O(n^2 m + n^3) flops at n = 2..16, far too little work per step to fill
// even one SM, so the time is the chain of dependent phases.  The design
// answers that with one launch of one thread block for the whole pass: P, p
// and every per-step temporary live in shared memory, threads map over
// matrix entries, __syncthreads() separates the phases, and there is no
// device-memory round trip for P and no host synchronisation between steps.
// A, B, N and their transposes are read by index from the stage arrays (the
// TPU wrapper's transposed copies are not needed).  All sums are f32.
//
// Limits: n <= 64, m <= 16, which keeps the shared memory under the 48 KB a
// block gets without opting in.  The Python wrapper checks them too.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxN = 64;
constexpr int kMaxM = 16;

__host__ __device__ inline size_t smem_floats(int n, int m) {
  const int w = m + n + 1;  // tableau width [H | G | g]
  return 2 * (size_t)n * n + 2 * (size_t)n * m + (size_t)m * w + 2 * n + w + m;
}

__global__ void __launch_bounds__(kThreads)
riccati_backward_kernel(const float* __restrict__ A,   // (T,n,n)
                        const float* __restrict__ B,   // (T,n,m)
                        const float* __restrict__ c,   // (T,n)
                        const float* __restrict__ Q,   // (T,n,n)
                        const float* __restrict__ R,   // (T,m,m)
                        const float* __restrict__ N,   // (T,n,m)
                        const float* __restrict__ q,   // (T,n)
                        const float* __restrict__ r,   // (T,m)
                        const float* __restrict__ Qf,  // (n,n)
                        const float* __restrict__ qf,  // (n,)
                        float* __restrict__ K,         // (T,m,n)
                        float* __restrict__ k,         // (T,m)
                        int T, int n, int m) {
  extern __shared__ float smem[];
  const int w = m + n + 1;
  float* P = smem;          // n*n  value Hessian: P_{t+1}, then P_t
  float* PA = P + n * n;    // n*n  P A
  float* PB = PA + n * n;   // n*m  P B
  float* G = PB + n * m;    // m*n  G, kept for the P and p updates
  float* tab = G + m * n;   // m*w  elimination tableau [H | G | g]
  float* pcp = tab + m * w; // n    P c + p
  float* p = pcp + n;       // n    value gradient
  float* rowk = p + n;      // w    scaled pivot row
  float* fac = rowk + w;    // m    pivot column

  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  for (int e = tid; e < n * n; e += nt) P[e] = Qf[e];
  for (int e = tid; e < n; e += nt) p[e] = qf[e];
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    const float* At = A + (size_t)t * n * n;
    const float* Bt = B + (size_t)t * n * m;
    const float* ct = c + (size_t)t * n;
    const float* Qt = Q + (size_t)t * n * n;
    const float* Rt = R + (size_t)t * m * m;
    const float* Nt = N + (size_t)t * n * m;
    const float* qt = q + (size_t)t * n;
    const float* rt = r + (size_t)t * m;

    // Phase 1: PA = P A, PB = P B, pcp = P c + p.
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
        pcp[i] = s + p[i];
      }
    }
    __syncthreads();

    // Phase 2: tableau rows [H_i | G_i | g_i].
    for (int e = tid; e < m * w; e += nt) {
      const int i = e / w, j = e % w;
      float s;
      if (j < m) {
        s = Rt[i * m + j];
        for (int l = 0; l < n; ++l) s += Bt[l * m + i] * PB[l * m + j];
      } else if (j < m + n) {
        const int jj = j - m;
        s = Nt[jj * m + i];
        for (int l = 0; l < n; ++l) s += Bt[l * m + i] * PA[l * n + jj];
        G[i * n + jj] = s;
      } else {
        s = rt[i];
        for (int l = 0; l < n; ++l) s += Bt[l * m + i] * pcp[l];
      }
      tab[e] = s;
    }
    __syncthreads();

    // Phase 3: Gauss-Jordan on the tableau, no pivoting.  Each elimination
    // step first copies the scaled pivot row and the pivot column, so that
    // the update reads no entry another thread is writing.
    for (int kk = 0; kk < m; ++kk) {
      for (int e = tid; e < w + m; e += nt) {
        if (e < w) {
          rowk[e] = tab[kk * w + e] / tab[kk * w + kk];
        } else {
          fac[e - w] = tab[(e - w) * w + kk];
        }
      }
      __syncthreads();
      for (int e = tid; e < m * w; e += nt) {
        const int i = e / w, j = e % w;
        tab[e] = (i == kk) ? rowk[j] : tab[e] - fac[i] * rowk[j];
      }
      __syncthreads();
    }

    // Phase 4: write K_t, k_t; S = Q + A'PA - G'K into P; p_t into p.
    // P and p are not read in this phase, so they are overwritten in place.
    float* Kt = K + (size_t)t * m * n;
    float* kt = k + (size_t)t * m;
    for (int e = tid; e < n * n + n + m * n + m; e += nt) {
      if (e < n * n) {
        const int i = e / n, j = e % n;
        float s = 0.f;
        for (int l = 0; l < n; ++l) s += At[l * n + i] * PA[l * n + j];
        float gk = 0.f;
        for (int l = 0; l < m; ++l) gk += G[l * n + i] * tab[l * w + m + j];
        P[e] = Qt[e] + s - gk;
      } else if (e < n * n + n) {
        const int i = e - n * n;
        float s = 0.f;
        for (int l = 0; l < n; ++l) s += At[l * n + i] * pcp[l];
        float gk = 0.f;
        for (int l = 0; l < m; ++l) gk += G[l * n + i] * tab[l * w + m + n];
        p[i] = qt[i] + s - gk;
      } else if (e < n * n + n + m * n) {
        const int e2 = e - n * n - n, i = e2 / n, j = e2 % n;
        Kt[e2] = tab[i * w + m + j];
      } else {
        const int i = e - n * n - n - m * n;
        kt[i] = tab[i * w + m + n];
      }
    }
    __syncthreads();

    // Phase 5: symmetrise P in place, one thread per off-diagonal pair.
    for (int e = tid; e < n * n; e += nt) {
      const int i = e / n, j = e % n;
      if (i < j) {
        const float v = 0.5f * (P[i * n + j] + P[j * n + i]);
        P[i * n + j] = v;
        P[j * n + i] = v;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// Launches the pass on `stream` and returns cudaGetLastError() as an int
// (0 on success).  All pointers are device pointers to contiguous f32 arrays.
extern "C" int riccati_backward_f32(const float* A, const float* B,
                                    const float* c, const float* Q,
                                    const float* R, const float* N,
                                    const float* q, const float* r,
                                    const float* Qf, const float* qf,
                                    float* K, float* k, int T, int n, int m,
                                    void* stream) {
  if (T < 1 || n < 1 || n > kMaxN || m < 1 || m > kMaxM) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = smem_floats(n, m) * sizeof(float);
  riccati_backward_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      A, B, c, Q, R, N, q, r, Qf, qf, K, k, T, n, m);
  return (int)cudaGetLastError();
}

extern "C" const char* riccati_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
