// K1: the whole time-varying LQR Riccati backward pass in one launch, and
// the linear plan after it.
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
// Given x0 it then rolls the linear plan forward, as ops/lqr.py's
// lqr_rollout_linear does after the JAX kernel:
//
//   u_t = -(K_t x_t + k_t),  x_{t+1} = A_t x_t + B_t u_t + c_t
//
// and writes x (T+1,n) and u (T,m): lqr_solve in one launch.
//
// What bounds it on an H100: latency.  The recursion is T dependent steps of
// O(n^2 m + n^3) flops at n = 2..16 (50 at carrots), far too little work a
// step to fill even one SM, so the time is the length of the chain: the
// instructions one step issues and the latencies between them.  The design
// shortens it:
//   - the knots' operands A, B, c, Q, R, N, q, r do not depend on the
//     recursion, so they are copied into shared memory before the chain
//     starts (cp.async), with K and k beside them for the plan, where all T
//     knots fit under the device's opt-in (the pendulum, box pushing, the
//     planar hand); otherwise each knot is streamed into a two-slot ring
//     while the one before it computes (carrots, T = 200 at n = 16), and the
//     plan streams them again;
//   - the sizes are compile-time: n padded to NB in {2, 4, ..., 64} and m
//     to MB in {1, 2, ..., 16} (MB <= NB), every operand stored at those
//     widths with zeros past (n, m) and ones on R's padded diagonal, which
//     leaves the first n, m of every result as they are.  So every loop is
//     unrolled, every load has a compile-time offset, and no index is
//     divided at run time.  A, B and the products PA, PB are stored
//     transposed, so that every inner product of the backward pass reads
//     two rows, as float4, at a row stride of NB + 4 floats (lanes reading
//     different rows hit different banks);
//   - threads map over the entries of PA, the [H | G | g] tableau and P:
//     one warp up to NB = 4 (__syncwarp() between phases), past that as
//     many threads as make each phase about one round (64 at NB = 8, 128
//     at NB = 16, 256 past it), which measured faster on the card than one
//     warp (tools/probe_chains.py, PERF.md);
//   - a knot is 4 + MB barriers: PA, PB and Pc + p;
//     the tableau; one a pivot, the elimination reading one buffer and
//     writing the other (the scaled pivot row needs no copy); and the new
//     P, symmetrised on write (the thread of the pair i <= j computes S_ij
//     and S_ji and writes their mean to both), with p, K and k.
// All sums are f32, in the order of lqr.riccati_backward_plain's products
// up to the order of additions; no fast-math.
//
// Limits: n <= 64, m <= 16.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 64;
constexpr int kMaxM = 16;

__host__ __device__ constexpr int round4(int v) { return (v + 3) & ~3; }

__host__ __device__ constexpr int pow2_at_least(int v) {
  return v <= 1 ? 1 : v <= 2 ? 2 : v <= 4 ? 4 : v <= 8 ? 8 : v <= 16 ? 16
       : v <= 32 ? 32 : 64;
}

// The threads of the chain at width NB.
__host__ __device__ constexpr int chain_threads(int nb) {
  return nb <= 4 ? 32 : nb == 8 ? 64 : nb == 16 ? 128 : 256;
}

template <int NT>
__device__ __forceinline__ void barrier() {
  if (NT == 32) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// Offsets (floats) of one knot's padded operands (A, B and, for the plan,
// K as rows of stride ld; A and B transposed, so that every inner product
// of the backward pass reads two rows) and of the work area (P, (PA)',
// (PB)' at stride ld, G, the two tableau buffers, P c + p, p, the plan's
// two state buffers and its input, and the table of P's upper-triangle
// pairs).  Every offset is a multiple of 4 floats, so that rows are read as
// float4; ld = NB + 4 puts the rows that neighbouring lanes read on
// different banks.
struct ChainLayout {
  int ld, W, AT, BT, c, Q, R, N, q, r, K, k, ks;
  int P, PAT, PBT, G, T0, T1, pcp, p, xa, xb, u, pairs, work;
  __host__ __device__ constexpr ChainLayout(int nb, int mb)
      : ld(nb % 4 ? nb : nb + 4), W(mb + nb + 1), AT(0),
        BT(AT + round4(nb * ld)), c(BT + round4(mb * ld)), Q(c + round4(nb)),
        R(Q + round4(nb * nb)), N(R + round4(mb * mb)),
        q(N + round4(nb * mb)), r(q + round4(nb)), K(r + round4(mb)),
        k(K + round4(mb * ld)), ks(k + round4(mb)),
        P(0), PAT(P + round4(nb * ld)), PBT(PAT + round4(nb * ld)),
        G(PBT + round4(mb * ld)), T0(G + round4(mb * nb)),
        T1(T0 + round4(mb * W)), pcp(T1 + round4(mb * W)),
        p(pcp + round4(nb)), xa(p + round4(nb)), xb(xa + round4(nb)),
        u(xb + round4(nb)), pairs(u + round4(mb)),
        work(round4(pairs + nb * (nb + 1) / 2)) {}
};

// f(e) for every e < COUNT this thread owns (e = tid + r NT), unrolled.
template <int NT, int COUNT, class F>
__device__ __forceinline__ void each(int tid, F f) {
#pragma unroll
  for (int r = 0; r < (COUNT + NT - 1) / NT; ++r) {
    const int e = tid + r * NT;
    if (COUNT % NT == 0 || e < COUNT) f(e);
  }
}

// acc + a . b over NB entries of two rows in shared memory, read as float4
// (four partial sums) where NB is a multiple of 4.
template <int NB>
__device__ __forceinline__ float dotv(const float* a, const float* b,
                                      float acc) {
  if constexpr (NB % 4 == 0) {
    float4 s = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int l = 0; l < NB; l += 4) {
      const float4 x = *reinterpret_cast<const float4*>(a + l);
      const float4 y = *reinterpret_cast<const float4*>(b + l);
      s.x += x.x * y.x;
      s.y += x.y * y.y;
      s.z += x.z * y.z;
      s.w += x.w * y.w;
    }
    return acc + ((s.x + s.y) + (s.z + s.w));
  } else {
#pragma unroll
    for (int l = 0; l < NB; ++l) acc += a[l] * b[l];
    return acc;
  }
}

// Copy knots t0 .. t0+nk-1 of a (T, ., .) input into knot slots `ks`
// floats apart, as (RP, CP) blocks of row stride LD whose first (rows,
// cols) entries are the input's (its transpose with TR): 4 bytes a
// cp.async (the input's knots are not 16-byte aligned), `diag` on the
// padded diagonal and 0 elsewhere.
template <int NT, int RP, int CP, bool TR, int LD>
__device__ __forceinline__ void stage_pad(float* dst, int ks,
                                          const float* src, int rows,
                                          int cols, int t0, int nk, int tid,
                                          float diag = 0.f) {
  constexpr int S = RP * CP;
  for (int e = tid; e < nk * S; e += NT) {
    const int t = e / S, idx = e - t * S, i = idx / CP, j = idx - i * CP;
    float* d = dst + (size_t)t * ks + i * LD + j;
    if (i < rows && j < cols) {
      const size_t o = TR ? (size_t)j * rows + i : (size_t)i * cols + j;
      __pipeline_memcpy_async(d, src + (size_t)(t0 + t) * rows * cols + o,
                              4);
    } else {
      *d = i == j ? diag : 0.f;
    }
  }
}

template <int NT, int NB, int MB>
__device__ __forceinline__ void fetch_backward(
    float* dst, const float* A, const float* B, const float* c,
    const float* Q, const float* R, const float* N, const float* q,
    const float* r, int n, int m, int t0, int nk, int tid) {
  constexpr ChainLayout L(NB, MB);
  stage_pad<NT, NB, NB, true, L.ld>(dst + L.AT, L.ks, A, n, n, t0, nk, tid);
  stage_pad<NT, MB, NB, true, L.ld>(dst + L.BT, L.ks, B, m, n, t0, nk, tid);
  stage_pad<NT, NB, 1, false, 1>(dst + L.c, L.ks, c, n, 1, t0, nk, tid);
  stage_pad<NT, NB, NB, false, NB>(dst + L.Q, L.ks, Q, n, n, t0, nk, tid);
  stage_pad<NT, MB, MB, false, MB>(dst + L.R, L.ks, R, m, m, t0, nk, tid,
                                   1.f);
  stage_pad<NT, NB, MB, false, MB>(dst + L.N, L.ks, N, n, m, t0, nk, tid);
  stage_pad<NT, NB, 1, false, 1>(dst + L.q, L.ks, q, n, 1, t0, nk, tid);
  stage_pad<NT, MB, 1, false, 1>(dst + L.r, L.ks, r, m, 1, t0, nk, tid);
  __pipeline_commit();
}

template <int NT, int NB, int MB>
__device__ __forceinline__ void fetch_plan(float* dst, const float* A,
                                           const float* B, const float* c,
                                           const float* K, const float* k,
                                           int n, int m, int t, int tid) {
  constexpr ChainLayout L(NB, MB);
  stage_pad<NT, NB, NB, true, L.ld>(dst + L.AT, L.ks, A, n, n, t, 1, tid);
  stage_pad<NT, MB, NB, true, L.ld>(dst + L.BT, L.ks, B, m, n, t, 1, tid);
  stage_pad<NT, NB, 1, false, 1>(dst + L.c, L.ks, c, n, 1, t, 1, tid);
  stage_pad<NT, MB, NB, false, L.ld>(dst + L.K, L.ks, K, m, n, t, 1, tid);
  stage_pad<NT, MB, 1, false, 1>(dst + L.k, L.ks, k, m, 1, t, 1, tid);
  __pipeline_commit();
}

// n <= NB, m <= MB <= NB; chain_threads(NB) threads.  `staged`: every
// knot's operands in shared memory; else a two-slot ring.  x0 null: no
// plan.
template <int NB, int MB>
__global__ void __launch_bounds__(chain_threads(NB))
riccati_kernel(const float* __restrict__ A,    // (T,n,n)
               const float* __restrict__ B,    // (T,n,m)
               const float* __restrict__ c,    // (T,n)
               const float* __restrict__ Q,    // (T,n,n)
               const float* __restrict__ R,    // (T,m,m)
               const float* __restrict__ N,    // (T,n,m)
               const float* __restrict__ q,    // (T,n)
               const float* __restrict__ r,    // (T,m)
               const float* __restrict__ Qf,   // (n,n)
               const float* __restrict__ qf,   // (n,)
               const float* __restrict__ x0,   // (n,) or null
               float* __restrict__ K_out,      // (T,m,n)
               float* __restrict__ k_out,      // (T,m)
               float* __restrict__ x_out,      // (T+1,n) or null
               float* __restrict__ u_out,      // (T,m) or null
               int T, int n, int m, int staged) {
  constexpr int NT = chain_threads(NB);
  constexpr ChainLayout L(NB, MB);
  constexpr int W = L.W, LD = L.ld;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* P = smem + L.P;
  float* PAT = smem + L.PAT;        // (P A)', row j = column j of P A
  float* PBT = smem + L.PBT;        // (P B)'
  float* G = smem + L.G;
  float* pcp = smem + L.pcp;
  float* p = smem + L.p;
  float* uv = smem + L.u;
  int* pairs = reinterpret_cast<int*>(smem + L.pairs);
  float* ops = smem + L.work;       // T knots, or the two-slot ring
  const int tid = threadIdx.x;

  // ---- the backward pass ------------------------------------------------
  if (staged) {
    fetch_backward<NT, NB, MB>(ops, A, B, c, Q, R, N, q, r, n, m, 0, T, tid);
  } else {
    fetch_backward<NT, NB, MB>(ops + ((T - 1) & 1) * L.ks, A, B, c, Q, R, N,
                               q, r, n, m, T - 1, 1, tid);
  }
  each<NT, NB * NB>(tid, [&](int e) {
    const int i = e / NB, j = e % NB;
    P[i * LD + j] = (i < n && j < n) ? Qf[i * n + j] : 0.f;
    // The pairs i <= j of P, row by row.
    if (i <= j) pairs[i * NB - i * (i - 1) / 2 + (j - i)] = e;
  });
  each<NT, NB>(tid, [&](int i) { p[i] = i < n ? qf[i] : 0.f; });

  for (int t = T - 1; t >= 0; --t) {
    float* kn;
    if (staged) {
      if (t == T - 1) __pipeline_wait_prior(0);
      kn = ops + (size_t)t * L.ks;
    } else {
      // Knot t - 1 into the slot knot t + 1 left (read up to the last
      // barrier), then wait for knot t's copy.
      if (t > 0) {
        fetch_backward<NT, NB, MB>(ops + ((t - 1) & 1) * L.ks, A, B, c, Q, R,
                                   N, q, r, n, m, t - 1, 1, tid);
        __pipeline_wait_prior(1);
      } else {
        __pipeline_wait_prior(0);
      }
      kn = ops + (t & 1) * L.ks;
    }
    const float* AT = kn + L.AT;
    const float* BT = kn + L.BT;
    const float* ct = kn + L.c;
    const float* Qt = kn + L.Q;
    const float* Rt = kn + L.R;
    const float* Nt = kn + L.N;
    const float* qt = kn + L.q;
    const float* rt = kn + L.r;
    barrier<NT>();

    // Phase 1: PA = P A, PB = P B (both stored transposed), pcp = P c + p.
    each<NT, NB * NB>(tid, [&](int e) {
      const int j = e / NB, i = e % NB;
      PAT[j * LD + i] = dotv<NB>(P + i * LD, AT + j * LD, 0.f);
    });
    each<NT, MB * NB>(tid, [&](int e) {
      const int j = e / NB, i = e % NB;
      PBT[j * LD + i] = dotv<NB>(P + i * LD, BT + j * LD, 0.f);
    });
    each<NT, NB>(tid, [&](int i) {
      pcp[i] = dotv<NB>(P + i * LD, ct, 0.f) + p[i];
    });
    barrier<NT>();

    // Phase 2: tableau rows [H_i | G_i | g_i], and G.
    float* src = smem + L.T0;
    float* dst = smem + L.T1;
    each<NT, MB * MB>(tid, [&](int e) {
      const int i = e / MB, j = e % MB;
      src[i * W + j] = dotv<NB>(BT + i * LD, PBT + j * LD, Rt[e]);
    });
    each<NT, MB * NB>(tid, [&](int e) {
      const int i = e / NB, j = e % NB;
      const float s = dotv<NB>(BT + i * LD, PAT + j * LD, Nt[j * MB + i]);
      G[e] = s;
      src[i * W + MB + j] = s;
    });
    each<NT, MB>(tid, [&](int i) {
      src[i * W + MB + NB] = dotv<NB>(BT + i * LD, pcp, rt[i]);
    });
    barrier<NT>();

    // Phase 3: Gauss-Jordan on the tableau, no pivoting, each pivot reading
    // one buffer and writing the other.
#pragma unroll
    for (int kk = 0; kk < MB; ++kk) {
      each<NT, MB * W>(tid, [&](int e) {
        const int i = e / W, j = e % W;
        const float rk = src[kk * W + j] / src[kk * W + kk];
        dst[e] = (i == kk) ? rk : src[e] - src[i * W + kk] * rk;
      });
      barrier<NT>();
      float* tmp = src;
      src = dst;
      dst = tmp;
    }
    const float* X = src + MB;          // [K | k], row stride W

    // Phase 4: P_t = sym(Q + A'PA - G'K), symmetrised on write; p_t; K_t
    // and k_t out (and beside the knot's operands for the plan).  P and p
    // are not read in this phase.
    each<NT, NB*(NB + 1) / 2>(tid, [&](int e) {
      const int ij = pairs[e], i = ij / NB, j = ij % NB;
      const float sij = dotv<NB>(AT + i * LD, PAT + j * LD, Qt[i * NB + j]);
      const float sji = dotv<NB>(AT + j * LD, PAT + i * LD, Qt[j * NB + i]);
      float gij = 0.f, gji = 0.f;
#pragma unroll
      for (int l = 0; l < MB; ++l) {
        gij += G[l * NB + i] * X[l * W + j];
        gji += G[l * NB + j] * X[l * W + i];
      }
      const float v = 0.5f * ((sij - gij) + (sji - gji));
      P[i * LD + j] = v;
      P[j * LD + i] = v;
    });
    each<NT, NB>(tid, [&](int i) {
      float g = 0.f;
#pragma unroll
      for (int l = 0; l < MB; ++l) g += G[l * NB + i] * X[l * W + NB];
      p[i] = dotv<NB>(AT + i * LD, pcp, qt[i]) - g;
    });
    float* Kt = K_out + (size_t)t * m * n;
    float* kt = k_out + (size_t)t * m;
    each<NT, MB * NB>(tid, [&](int e) {
      const int i = e / NB, j = e % NB;
      const float v = X[i * W + j];
      if (staged) kn[L.K + i * LD + j] = v;
      if (i < m && j < n) Kt[i * n + j] = v;
    });
    each<NT, MB>(tid, [&](int i) {
      const float v = X[i * W + NB];
      if (staged) kn[L.k + i] = v;
      if (i < m) kt[i] = v;
    });
    barrier<NT>();
  }

  // ---- the linear plan --------------------------------------------------
  if (x0 == nullptr) return;
  float* xc = smem + L.xa;
  float* xn = smem + L.xb;
  each<NT, NB>(tid, [&](int i) {
    xc[i] = i < n ? x0[i] : 0.f;
    if (i < n) x_out[i] = x0[i];
  });
  // The gains written above are visible to the block after its last
  // barrier; the ring's slots are free.
  if (!staged) fetch_plan<NT, NB, MB>(ops, A, B, c, K_out, k_out, n, m, 0, tid);
  for (int t = 0; t < T; ++t) {
    const float* kn;
    barrier<NT>();   // x_t written; the slot of knot t - 1 read
    if (staged) {
      kn = ops + (size_t)t * L.ks;
    } else {
      if (t + 1 < T) {
        fetch_plan<NT, NB, MB>(ops + ((t + 1) & 1) * L.ks, A, B, c, K_out,
                               k_out, n, m, t + 1, tid);
        __pipeline_wait_prior(1);
      } else {
        __pipeline_wait_prior(0);
      }
      kn = ops + (t & 1) * L.ks;
      barrier<NT>();
    }
    each<NT, MB>(tid, [&](int i) {
      const float u = -(dotv<NB>(kn + L.K + i * LD, xc, 0.f) + kn[L.k + i]);
      uv[i] = u;
      if (i < m) u_out[(size_t)t * m + i] = u;
    });
    barrier<NT>();
    each<NT, NB>(tid, [&](int i) {
      // Row i of A and B: column i of the stored transposes.
      float ax = 0.f, bu = 0.f;
#pragma unroll
      for (int l = 0; l < NB; ++l) ax += kn[L.AT + l * LD + i] * xc[l];
#pragma unroll
      for (int l = 0; l < MB; ++l) bu += kn[L.BT + l * LD + i] * uv[l];
      const float v = (ax + bu) + kn[L.c + i];
      xn[i] = v;
      if (i < n) x_out[(size_t)(t + 1) * n + i] = v;
    });
    float* tmp = xc;
    xc = xn;
    xn = tmp;
  }
}

// The compile-time widths of an (n, m) problem: n padded to NB (at least
// m's MB, at least 2), m to MB (at least 4 past NB = 16, where fewer
// instances suffice).
struct Widths {
  int nb, mb;
};

Widths widths(int n, int m) {
  int nb = pow2_at_least(n > m ? n : m);
  nb = nb < 2 ? 2 : nb;
  int mb = pow2_at_least(m);
  if (nb > 16 && mb < 4) mb = 4;
  return {nb, mb};
}

size_t smem_bytes(int T, int n, int m, bool staged) {
  const Widths w = widths(n, m);
  const ChainLayout L(w.nb, w.mb);
  return (L.work + (staged ? (size_t)T : 2) * L.ks) * sizeof(float);
}

// Opts in to `smem` bytes of dynamic shared memory where that is past the
// default 48 KB, launches the instance and returns a CUDA error code: the
// attribute call's, else cudaGetLastError() after the launch.
template <int NB, int MB>
int launch(size_t smem, void* stream, const float* A, const float* B,
           const float* c, const float* Q, const float* R, const float* N,
           const float* q, const float* r, const float* Qf, const float* qf,
           const float* x0, float* K, float* k, float* x_out, float* u_out,
           int T, int n, int m, int staged) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        riccati_kernel<NB, MB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  riccati_kernel<NB, MB><<<1, chain_threads(NB), smem,
                           (cudaStream_t)stream>>>(
      A, B, c, Q, R, N, q, r, Qf, qf, x0, K, k, x_out, u_out, T, n, m,
      staged);
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
// the current device (the staged placement), 0 if they are streamed, -1 on
// invalid sizes or a failed device query.
extern "C" int riccati_staged(int T, int n, int m) {
  if (!valid(T, n, m)) return -1;
  const int cap = max_smem_optin();
  if (cap < 0) return -1;
  return smem_bytes(T, n, m, true) <= (size_t)cap ? 1 : 0;
}

// Launches the backward pass (and, with x0 not null, the plan into x_out
// and u_out) on `stream`; returns a CUDA error code as an int (0 on
// success): the attribute call's, when the launch needs more than 48 KB of
// shared memory (it fails where `staged` asks for more than the device
// has), else cudaGetLastError() after the launch.  All pointers are device
// pointers to contiguous f32 arrays.
extern "C" int riccati_solve_f32(const float* A, const float* B,
                                 const float* c, const float* Q,
                                 const float* R, const float* N,
                                 const float* q, const float* r,
                                 const float* Qf, const float* qf,
                                 const float* x0, float* K, float* k,
                                 float* x_out, float* u_out, int T, int n,
                                 int m, int staged, void* stream) {
  if (!valid(T, n, m) || (staged != 0 && staged != 1) ||
      (x0 != nullptr && (x_out == nullptr || u_out == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(T, n, m, staged == 1);
  const Widths w = widths(n, m);
#define K1_CASE(NB, MB)                                                      \
  if (w.nb == NB && w.mb == MB) {                                            \
    return launch<NB, MB>(smem, stream, A, B, c, Q, R, N, q, r, Qf, qf, x0, \
                          K, k, x_out, u_out, T, n, m, staged);             \
  }
  K1_CASE(2, 1) K1_CASE(2, 2)
  K1_CASE(4, 1) K1_CASE(4, 2) K1_CASE(4, 4)
  K1_CASE(8, 1) K1_CASE(8, 2) K1_CASE(8, 4) K1_CASE(8, 8)
  K1_CASE(16, 1) K1_CASE(16, 2) K1_CASE(16, 4) K1_CASE(16, 8) K1_CASE(16, 16)
  K1_CASE(32, 4) K1_CASE(32, 8) K1_CASE(32, 16)
  K1_CASE(64, 4) K1_CASE(64, 8) K1_CASE(64, 16)
#undef K1_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* riccati_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
