// K4: the whole line-searched contact rollout chain in one launch.
//
// Replaces the TPU kernel of the JAX package,
// models/contact/pallas_rollout.py::_rollout_kernel (with _assemble,
// _pdip_warm_dense and the wrapper linesearch_rollout_pallas), and computes
// what models/contact/rollout.py::linesearch_rollout_plain computes: for
// every line-search lane and every knot t,
//   u   = u_ref - K_t (z - z_ref),  z = [x; u_prev] (or x),
//   u   = clip(u, u_prev + rel_lb, u_prev + rel_ub)   (if rel bounds),
//   u   = clip(u, lb, ub),
//   b   = pq * x - KU u - tau,  (C, d) = the Anitescu contact rows at x,
//   dq  = a warm-started PDIP solve of min 1/2 dq'diag(pdiag)dq + b'dq
//         s.t. C dq <= d, from the previous knot's (dq, lam),
//         `iters` iterations, with the floors, caps and rescue of
//         qp._pdip_solve's warm branch,
//   lam = the solve's duals (non-finite -> 0), canonicalised per contact
//         (mean of its two rows) if the model asks for it,
//   x  <- x + dq.
//
// The model arrives as a table built on the host (rollout.make_consts):
// for every contact pair its first row and contact count, then one record
// per side naming its shape kind (circle, capsule, halfspace, box), its
// body kind (static, free body, Arm2D, prismatic finger) and that body's
// indices and parameters.  An arm's links (joint index and length) sit in
// a link table of their own, each arm once, and a side names its arm's
// first record: the TPU kernel unrolls any number of links at trace time,
// and this one walks them, so an arm of any length fits (up to 64 link
// records in all) without sizing any per-thread array by the longest arm.
// The narrow phase implements the JAX kernel's eleven pair kinds
// (rollout._PAIR_KINDS): capsule-circle, halfspace-circle, box-circle,
// capsule-box and halfspace-box, each either way round, and circle-circle,
// in geometry.shape_contact's contact order, normal signs and tie rules.  A capsule against a box gives two contacts
// (its ends), a box against a halfspace four (its corners, in the order
// (+,+), (-,+), (-,-), (+,-)); every contact has two rows, at its pair's
// first row + 2c.
//
// What bounds it on an H100: latency.  A lane is T x iters dependent
// Newton steps on a system of at most 16 unknowns and 64 rows, far too
// little work for an SM, and the lanes are independent.  The design is one
// warp per lane (a block of 32 threads), with no __syncthreads() at all:
//   - each thread owns two rows (C row in shared memory at an odd stride,
//     d, s, lam and the residuals in registers);
//   - mu, the fraction-to-boundary step and the warm start's shift are
//     butterfly reductions (__shfl_xor_sync), NaN-propagating like nmin;
//   - the Newton tableau [diag(pdiag) + C'WC | rhs] is built with one
//     column per thread, in registers, by one code path for every thread,
//     and eliminated by the same Gauss-Jordan without pivoting as qp's
//     solve_spd, unrolled (pivots and rows at compile-time positions), the
//     pivot column broadcast by __shfl_sync;
//   - the iterate dq (and its last finite value) is replicated in every
//     thread, so the finiteness rescue needs no reduction;
//   - the narrow phase maps threads over (pair, contact slot), looping past
//     32 slots;
//   - the lane's per-knot inputs (K, z_ref, u_ref, the bound rows) are
//     staged into shared memory with cp.async in chunks of knots (one chunk
//     at the main path's sizes), and the model's table and constants once.
// The kernel is instantiated for every nq from 1 to 16, so that every
// loop over the unknowns, and every shuffle, sits at a compile-time
// position with no guard (a guard around a shuffle costs a convergence
// barrier).  No fast-math: the divisions and the 1e10-scaled eliminations
// are where f32 fails first; the 1e10 cap, the 1e-7 and 3e-7
// floors, 0.995, the last-finite rescue of dq, non-finite lam -> 0 and the
// per-contact canonicalisation are those of the plain version.
//
// Limits: nq <= 16, m <= 16, nz <= 32, at most 64 rows (32 contacts),
// at most 64 arm links in the link table.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxNq = 16;
constexpr int kMaxM = 16;
constexpr int kMaxNz = 32;
constexpr int kMaxRows = 64;
constexpr int kMaxPairs = kMaxRows / 2;
constexpr int kLdc = kMaxNq + 1;
constexpr int kChunkFloats = 8192;   // 32 KB of staged knots
constexpr int kMaxLinkRecords = 64;
constexpr int kMaxContacts = 4;   // per pair: a box's four corners
// Table layout, as rollout.py: per side SIDE_INTS ints and SIDE_FLOATS
// floats; per pair the first row and the contact count, then 2 sides; mu
// first among the floats.  An arm side: i0 (si[2]) its link k, i3 (si[5])
// its first record in the link table.
constexpr int kSideInts = 6;
constexpr int kSideFloats = 7;
constexpr int kPairInts = 2 + 2 * kSideInts;
constexpr int kPairFloats = 1 + 2 * kSideFloats;
enum { kCircle = 0, kCapsule = 1, kHalfspace = 2, kBox = 3 };
enum { kStatic = 0, kFree = 1, kArm = 2, kFinger = 3 };

__device__ __forceinline__ float nmin(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fminf(a, b);
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fmaxf(a, b);
}
__device__ __forceinline__ float clip(float v, float lo, float hi) {
  return nmin(nmax(v, lo), hi);
}
// An input bound made finite as rollout.bound_rows makes it: +-inf ->
// +-1e9, and NaN -> side * 1e9 (no bound on that side).
__device__ __forceinline__ float finite_bound(float v, float side) {
  return isnan(v) ? side * 1e9f : fminf(fmaxf(v, -1e9f), 1e9f);
}

// World geometry of one side of a pair at configuration x.
struct Side {
  int shape, body;
  float cy, cz, r;          // circle or box centre; radius
  float a0y, a0z, a1y, a1z; // capsule segment
  float ny, nz, off;        // halfspace
  float hx, hy, ct, st;     // box half extents; body (base) rotation
  float oy, oz, ay, az;     // finger base and world slide axis
};

// The link table: joint index and length of every arm link.
struct Links {
  const int* joint;
  const float* length;
};

__device__ void side_geometry(const int* si, const float* sf, Links lk,
                              const float* x, Side& g) {
  g.shape = si[0];
  g.body = si[1];
  g.r = sf[0];
  if (g.shape == kHalfspace) {
    g.ny = sf[1];
    g.nz = sf[2];
    g.off = sf[3];
  } else if (g.body == kStatic) {
    g.cy = sf[1];
    g.cz = sf[2];
  } else if (g.body == kFree || g.body == kFinger) {
    const float y = x[si[2]], z = x[si[3]];
    const float th = si[4] >= 0 ? x[si[4]] : 0.f;
    g.ct = cosf(th);
    g.st = sinf(th);
    if (g.body == kFree) {      // centred circle or box
      g.cy = y;
      g.cz = z;
      g.hx = sf[1];
      g.hy = sf[2];
    } else {
      // tip = base + R(th) (offset + slide * axis); a capsule hangs from
      // the tip straight down in the base frame.
      const float slide = x[si[5]];
      const float ly = sf[4] + slide * sf[1], lz = sf[5] + slide * sf[2];
      g.oy = y;
      g.oz = z;
      g.ay = g.ct * sf[1] - g.st * sf[2];
      g.az = g.st * sf[1] + g.ct * sf[2];
      g.cy = y + (g.ct * ly - g.st * lz);
      g.cz = z + (g.st * ly + g.ct * lz);
      g.a0y = g.cy;
      g.a0z = g.cz;
      g.a1y = g.cy + g.st * sf[3];
      g.a1z = g.cz - g.ct * sf[3];
    }
  } else {  // Arm2D link k: walk joints 0..k+1 from the base
    const int k = si[2], l0 = si[5];
    float jy = sf[4], jz = sf[5], acc = 0.f;
    for (int j = 0; j <= k; ++j) {
      const float a = x[lk.joint[l0 + j]];
      acc = (j == 0) ? a : acc + a;
      const float ang = acc + sf[6];
      const float L = lk.length[l0 + j];
      if (j == k) {
        g.a0y = jy;
        g.a0z = jz;
      }
      jy = jy + sinf(ang) * L;
      jz = jz + (-cosf(ang)) * L;
    }
    g.a1y = jy;
    g.a1z = jz;
  }
}

// (ry, rz)[i] += (vy, vz) at the run-time column i, by a select at every
// compile-time column, so that the row terms stay in registers.
template <int NQ>
__device__ __forceinline__ void add_col(float (&ry)[NQ], float (&rz)[NQ],
                                        int i, float vy, float vz) {
#pragma unroll
  for (int c = 0; c < NQ; ++c) {
    if (c == i) {
      ry[c] += vy;
      rz[c] += vz;
    }
  }
}

// Adds sign x the point Jacobian (Jy, Jz) of p on one side to (ry, rz):
// the translation of a body (base), its rotation about its origin, a
// finger's slide along the turned axis, and for an arm link k the
// rotation about each joint 0..k, whose positions it walks again from the
// base.
template <int NQ>
__device__ void side_jacobian(const int* si, const float* sf, Links lk,
                              const float* x, const Side& g, float py,
                              float pz, float sign, float (&ry)[NQ],
                              float (&rz)[NQ]) {
  if (g.body == kFree || g.body == kFinger) {
    const float oy = g.body == kFree ? g.cy : g.oy;
    const float oz = g.body == kFree ? g.cz : g.oz;
    add_col(ry, rz, si[2], sign, 0.f);
    add_col(ry, rz, si[3], 0.f, sign);
    if (si[4] >= 0) add_col(ry, rz, si[4], sign * -(pz - oz), sign * (py - oy));
    if (g.body == kFinger) add_col(ry, rz, si[5], sign * g.ay, sign * g.az);
  } else if (g.body == kArm) {
    const int k = si[2], l0 = si[5];
    float jy = sf[4], jz = sf[5], acc = 0.f;
    for (int j = 0; j <= k; ++j) {
      const int i = lk.joint[l0 + j];
      add_col(ry, rz, i, sign * -(pz - jz), sign * (py - jy));
      if (j == k) break;
      acc = (j == 0) ? x[i] : acc + x[i];
      const float ang = acc + sf[6];
      const float L = lk.length[l0 + j];
      jy = jy + sinf(ang) * L;
      jz = jz + (-cosf(ang)) * L;
    }
  }
}

__device__ void circle_circle(float ay, float az, float ra, float by,
                              float bz, float rb, float& phi, float& py,
                              float& pz, float& ny, float& nz) {
  const float dy = by - ay, dz = bz - az;
  const float dist = sqrtf(dy * dy + dz * dz + 1e-12f);
  ny = dy / dist;
  nz = dz / dist;
  phi = dist - ra - rb;
  py = ay + ny * (ra + 0.5f * phi);
  pz = az + nz * (ra + 0.5f * phi);
}

__device__ void capsule_circle(const Side& cap, const Side& cir, float& phi,
                               float& py, float& pz, float& ny, float& nz) {
  const float aby = cap.a1y - cap.a0y, abz = cap.a1z - cap.a0z;
  float t = ((cir.cy - cap.a0y) * aby + (cir.cz - cap.a0z) * abz)
            / ((aby * aby + abz * abz) + 1e-12f);
  t = clip(t, 0.f, 1.f);
  circle_circle(cap.a0y + t * aby, cap.a0z + t * abz, cap.r, cir.cy, cir.cz,
                cir.r, phi, py, pz, ny, nz);
}

// A point p (radius r: the circle's surface) against the halfspace hs,
// n from the halfspace into the circle.
__device__ void circle_halfspace(float cy, float cz, float r, const Side& hs,
                                 float& phi, float& py, float& pz, float& ny,
                                 float& nz) {
  phi = (hs.ny * cy + hs.nz * cz) - hs.off - r;
  py = cy - hs.ny * r;
  pz = cz - hs.nz * r;
  ny = hs.ny;
  nz = hs.nz;
}

// Circle (cy, cz, r) against an oriented box, n from the box to the
// circle (geometry.circle_box): outside, the closest point; inside, the
// nearest face, ties to axis 0, sign(0) taken as +1.
__device__ void circle_box(float cy, float cz, float r, const Side& box,
                           float& phi, float& py, float& pz, float& ny,
                           float& nz) {
  const float ct = box.ct, st = box.st, hx = box.hx, hy = box.hy;
  const float dy = cy - box.cy, dz = cz - box.cz;
  const float ly = ct * dy + st * dz, lz = -st * dy + ct * dz;
  const float cly = clip(ly, -hx, hx), clz = clip(lz, -hy, hy);
  float nly, nlz, ply, plz;
  if (fabsf(ly) < hx && fabsf(lz) < hy) {
    const float fd0 = hx - fabsf(ly), fd1 = hy - fabsf(lz);
    const float s0 = ly >= 0.f ? 1.f : -1.f, s1 = lz >= 0.f ? 1.f : -1.f;
    if (fd0 <= fd1) {
      phi = -fd0 - r;
      nly = s0;
      nlz = 0.f;
      ply = ly + s0 * fd0;
      plz = lz;
    } else {
      phi = -fd1 - r;
      nly = 0.f;
      nlz = s1;
      ply = ly;
      plz = lz + s1 * fd1;
    }
  } else {
    const float dly = ly - cly, dlz = lz - clz;
    const float dist = sqrtf(dly * dly + dlz * dlz + 1e-12f);
    phi = dist - r;
    nly = dly / dist;
    nlz = dlz / dist;
    ply = cly;
    plz = clz;
  }
  ny = ct * nly - st * nlz;
  nz = st * nly + ct * nlz;
  py = box.cy + (ct * ply - st * plz);
  pz = box.cz + (st * ply + ct * plz);
}

// Contact c of the pair (a, b): (phi, p, n), n from a into b.
__device__ void pair_contact(const Side& a, const Side& b, int c, float& phi,
                             float& py, float& pz, float& ny, float& nz) {
  bool flip = false;
  if (a.shape == kCircle && b.shape == kCircle) {
    circle_circle(a.cy, a.cz, a.r, b.cy, b.cz, b.r, phi, py, pz, ny, nz);
  } else if (a.shape == kCapsule && b.shape == kCircle) {
    capsule_circle(a, b, phi, py, pz, ny, nz);
  } else if (a.shape == kCircle && b.shape == kCapsule) {
    capsule_circle(b, a, phi, py, pz, ny, nz);
    flip = true;
  } else if (a.shape == kHalfspace && b.shape == kCircle) {
    circle_halfspace(b.cy, b.cz, b.r, a, phi, py, pz, ny, nz);
  } else if (a.shape == kCircle && b.shape == kHalfspace) {
    circle_halfspace(a.cy, a.cz, a.r, b, phi, py, pz, ny, nz);
    flip = true;
  } else if (a.shape == kBox && b.shape == kCircle) {
    circle_box(b.cy, b.cz, b.r, a, phi, py, pz, ny, nz);
  } else if (a.shape == kCircle && b.shape == kBox) {
    circle_box(a.cy, a.cz, a.r, b, phi, py, pz, ny, nz);
    flip = true;
  } else if (a.shape == kCapsule && b.shape == kBox) {   // end c of a
    circle_box(c ? a.a1y : a.a0y, c ? a.a1z : a.a0z, a.r, b, phi, py, pz,
               ny, nz);
    flip = true;
  } else if (a.shape == kBox && b.shape == kCapsule) {   // end c of b
    circle_box(c ? b.a1y : b.a0y, c ? b.a1z : b.a0z, b.r, a, phi, py, pz,
               ny, nz);
  } else {  // box and halfspace, either way round: corner c of the box
    const Side& box = a.shape == kBox ? a : b;
    const Side& hs = a.shape == kBox ? b : a;
    const float ly = (c == 0 || c == 3) ? box.hx : -box.hx;
    const float lz = c < 2 ? box.hy : -box.hy;
    circle_halfspace(box.cy + (box.ct * ly - box.st * lz),
                     box.cz + (box.st * ly + box.ct * lz), 0.f, hs, phi, py,
                     pz, ny, nz);
    flip = a.shape == kBox;
  }
  if (flip) {
    ny = -ny;
    nz = -nz;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float warp_nmin(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v = nmin(v, __shfl_xor_sync(kFull, v, off));
  }
  return v;
}

// Copy `count` 4-byte words from global memory into shared memory with
// cp.async (4 bytes a copy: the knots' offsets are not 16-byte aligned).
template <class E>
__device__ __forceinline__ void stage(E* dst, const E* src, int count,
                                      int lane) {
  for (int e = lane; e < count; e += kThreads) {
    __pipeline_memcpy_async(dst + e, src + e, 4);
  }
}

// One knot-chunk of a lane's inputs in shared memory, `tc` knots of each.
struct Chunk {
  float *K, *zx, *zw, *ur, *lb, *ub, *rlb, *rub;
};

__host__ __device__ inline int knot_floats(int nq, int m, int nz) {
  return m * nz + nq + 6 * m;
}

__device__ inline Chunk chunk_layout(float* base, int tc, int nq, int m,
                                     int nz) {
  Chunk c;
  c.K = base;
  c.zx = c.K + tc * m * nz;
  c.zw = c.zx + tc * nq;
  c.ur = c.zw + tc * m;
  c.lb = c.ur + tc * m;
  c.ub = c.lb + tc * m;
  c.rlb = c.ub + tc * m;
  c.rub = c.rlb + tc * m;
  return c;
}

template <int NQ>
__global__ void __launch_bounds__(kThreads)
rollout_kernel(const float* __restrict__ K,     // (T, m, nz)
               const float* __restrict__ zrx,   // (A, T, nq)
               const float* __restrict__ zrw,   // (A, T, m) or null
               const float* __restrict__ ur,    // (A, T, m)
               const float* __restrict__ lb,    // (T, m)
               const float* __restrict__ ub,    // (T, m)
               const float* __restrict__ rlb,   // (T, m) or null
               const float* __restrict__ rub,   // (T, m) or null
               const float* __restrict__ x0,    // (nq,)
               const float* __restrict__ up0,   // (m,)
               const float* __restrict__ pdiag, // (nq,)
               const float* __restrict__ pq,    // (nq,)
               const float* __restrict__ KUT,   // (m, nq)
               const float* __restrict__ tau,   // (nq,)
               const int* __restrict__ pair_i,  // (pairs, kPairInts)
               const float* __restrict__ pair_f,// (pairs, kPairFloats)
               const int* __restrict__ link_i,  // (links,)
               const float* __restrict__ link_f,// (links,)
               float* __restrict__ xs,          // (A, T+1, nq)
               float* __restrict__ us,          // (A, T, m)
               int T, int tc, int m, int nz, int pairs, int links, int mr,
               int iters, int canon) {
  __shared__ float x[kMaxNq], b[kMaxNq], u[kMaxM], up[kMaxM];
  __shared__ float sp[kMaxNq], spq[kMaxNq], stau[kMaxNq];
  __shared__ float sKUT[kMaxM * kMaxNq];
  __shared__ float C[kMaxRows * kLdc], d[kMaxRows];
  __shared__ float w[kMaxRows], tk[kMaxRows], lm[kMaxRows];
  __shared__ int pi[kMaxPairs * kPairInts];
  __shared__ float pf[kMaxPairs * kPairFloats];
  __shared__ int li[kMaxLinkRecords];
  __shared__ float lf[kMaxLinkRecords];
  extern __shared__ float4 chunk4[];

  const int ln = blockIdx.x;
  const int lane = threadIdx.x;
  constexpr int nq = NQ;        // the model's unknowns
  constexpr int ldc = NQ | 1;
  const bool aug = zrw != nullptr, rel = rlb != nullptr;
  const Chunk ch = chunk_layout(reinterpret_cast<float*>(chunk4), tc, nq, m,
                                nz);
  const float* zrx_l = zrx + (size_t)ln * T * nq;
  const float* zrw_l = aug ? zrw + (size_t)ln * T * m : nullptr;
  const float* ur_l = ur + (size_t)ln * T * m;
  float* xs_l = xs + (size_t)ln * (T + 1) * nq;
  float* us_l = us + (size_t)ln * T * m;

  // The model's table and constants, the start state.
  stage(pi, pair_i, pairs * kPairInts, lane);
  stage(pf, pair_f, pairs * kPairFloats, lane);
  stage(li, link_i, links, lane);
  stage(lf, link_f, links, lane);
  stage(sKUT, KUT, m * nq, lane);
  __pipeline_commit();
  for (int i = lane; i < nq; i += kThreads) {
    sp[i] = pdiag[i];
    spq[i] = pq[i];
    stau[i] = tau[i];
    x[i] = x0[i];
    xs_l[i] = x0[i];
  }
  for (int j = lane; j < m; j += kThreads) up[j] = up0[j];
  __pipeline_wait_prior(0);
  __syncwarp();

  // Rows k0 = lane and k1 = lane + 32 of this thread; lam carried across
  // knots, dq (the last finite iterate) in every thread.
  const int k0 = lane, k1 = lane + 32;
  const bool v0 = k0 < mr, v1 = k1 < mr;
  float lam0 = 1.f, lam1 = 1.f;
  float xk[NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) xk[i] = 0.f;

  for (int t = 0; t < T; ++t) {
    const int c = t % tc;
    if (c == 0) {
      // Stage knots [t, t + tc) of this lane's inputs.
      const int n = T - t < tc ? T - t : tc;
      __syncwarp();
      stage(ch.K, K + (size_t)t * m * nz, n * m * nz, lane);
      stage(ch.zx, zrx_l + (size_t)t * nq, n * nq, lane);
      if (aug) stage(ch.zw, zrw_l + (size_t)t * m, n * m, lane);
      stage(ch.ur, ur_l + (size_t)t * m, n * m, lane);
      stage(ch.lb, lb + (size_t)t * m, n * m, lane);
      stage(ch.ub, ub + (size_t)t * m, n * m, lane);
      if (rel) {
        stage(ch.rlb, rlb + (size_t)t * m, n * m, lane);
        stage(ch.rub, rub + (size_t)t * m, n * m, lane);
      }
      __pipeline_commit();
      __pipeline_wait_prior(0);
      __syncwarp();
    }

    // -- feedback law and clips, one input per thread --
    if (lane < m) {
      const int j = lane;
      const float* Kj = ch.K + (size_t)(c * m + j) * nz;
      float fb = 0.f;
      for (int l = 0; l < nq; ++l) fb += (x[l] - ch.zx[c * nq + l]) * Kj[l];
      if (aug) {
        float fw = 0.f;
        for (int l = 0; l < m; ++l) {
          fw += (up[l] - ch.zw[c * m + l]) * Kj[nq + l];
        }
        fb += fw;
      }
      float v = ch.ur[c * m + j] - fb;
      if (rel) {
        v = clip(v, up[j] + finite_bound(ch.rlb[c * m + j], -1.f),
                 up[j] + finite_bound(ch.rub[c * m + j], 1.f));
      }
      u[j] = clip(v, finite_bound(ch.lb[c * m + j], -1.f),
                  finite_bound(ch.ub[c * m + j], 1.f));
    }
    __syncwarp();

    // -- assembly: b, and two Anitescu rows per contact --
    for (int i = lane; i < nq; i += kThreads) {
      float ku = 0.f;
      for (int j = 0; j < m; ++j) ku += u[j] * sKUT[j * nq + i];
      b[i] = spq[i] * x[i] - ku - stau[i];
    }
    for (int e = lane; e < pairs * kMaxContacts; e += kThreads) {
      const int pr = e / kMaxContacts, cc = e % kMaxContacts;
      const int* ip = pi + pr * kPairInts;
      if (cc >= ip[1]) continue;
      const int row = ip[0] + 2 * cc;
      const int* ia = ip + 2;
      const int* ib = ia + kSideInts;
      const float* fa = pf + pr * kPairFloats + 1;
      const float* fb = fa + kSideFloats;
      const float mu = pf[pr * kPairFloats];
      const Links lk{li, lf};
      Side ga, gb;
      side_geometry(ia, fa, lk, x, ga);
      side_geometry(ib, fb, lk, x, gb);
      float phi, py, pz, ny, nz_;
      pair_contact(ga, gb, cc, phi, py, pz, ny, nz_);
      // The relative point Jacobian J_b - J_a, column by column.
      float ry[NQ], rz[NQ];
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        ry[i] = 0.f;
        rz[i] = 0.f;
      }
      side_jacobian(ib, fb, lk, x, gb, py, pz, 1.f, ry, rz);
      side_jacobian(ia, fa, lk, x, ga, py, pz, -1.f, ry, rz);
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        const float jn = ny * ry[i] + nz_ * rz[i];
        const float jt = (-nz_) * ry[i] + ny * rz[i];
        C[row * ldc + i] = -(jn + mu * jt);
        C[(row + 1) * ldc + i] = -(jn - mu * jt);
      }
      d[row] = phi;
      d[row + 1] = phi;
    }
    __syncwarp();

    // -- warm start from the previous knot's (dq, lam) --
    bool ok = true;
#pragma unroll
    for (int i = 0; i < NQ; ++i) ok = ok && isfinite(xk[i]);
    float xw[NQ];
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      xw[i] = ok ? xk[i] : 0.f;
      xk[i] = xw[i];
    }
    const float* C0 = C + (v0 ? k0 : 0) * ldc;
    const float* C1 = C + (v1 ? k1 : 0) * ldc;
    const float d0 = v0 ? d[k0] : 0.f, d1 = v1 ? d[k1] : 0.f;
    float s0, s1;
    {
      float a0 = 0.f, a1 = 0.f;
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        a0 += C0[i] * xw[i];
        a1 += C1[i] * xw[i];
      }
      s0 = d0 - a0;
      s1 = d1 - a1;
      const float mn = warp_nmin(nmin(v0 ? s0 : INFINITY, v1 ? s1 : INFINITY));
      const float shift = nmax(0.f, -mn) + 1e-2f;
      s0 += shift;
      s1 += shift;
      lam0 = clip(isfinite(lam0) ? lam0 : 1.f, 1e-2f, 1e6f);
      lam1 = clip(isfinite(lam1) ? lam1 : 1.f, 1e-2f, 1e6f);
    }

    for (int it = 0; it < iters; ++it) {
      const float acc = warp_sum((v0 ? s0 * lam0 : 0.f) +
                                 (v1 ? s1 * lam1 : 0.f));
      const float mu = nmax(acc / (float)mr, 3e-7f);
      float cx0 = 0.f, cx1 = 0.f;
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        cx0 += C0[i] * xw[i];
        cx1 += C1[i] * xw[i];
      }
      const float rp0 = cx0 + s0 - d0, rp1 = cx1 + s1 - d1;
      const float rc0 = lam0 * s0 - 0.25f * mu, rc1 = lam1 * s1 - 0.25f * mu;
      const float ss0 = nmax(s0, 1e-7f), ss1 = nmax(s1, 1e-7f);
      const float w0 = nmin(lam0 / ss0, 1e10f), w1 = nmin(lam1 / ss1, 1e10f);
      __syncwarp();   // the previous step's tableau has read w, tk, lm
      if (v0) {
        w[k0] = w0;
        tk[k0] = w0 * rp0 - rc0 / ss0;
        lm[k0] = lam0;
      }
      if (v1) {
        w[k1] = w1;
        tk[k1] = w1 * rp1 - rc1 / ss1;
        lm[k1] = lam1;
      }
      __syncwarp();
      // The tableau [diag(pdiag) + C'WC | rhs], column `lane` in col, by
      // one code path for every thread: thread j < nq sums w_k C_kj C_k,
      // thread nq sums lam_k C_k and tk_k C_k (kept apart, as the plain
      // version adds them), the others sum zeros.
      float h1[NQ], h2[NQ];
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        h1[i] = 0.f;
        h2[i] = 0.f;
      }
      for (int k = 0; k < mr; ++k) {
        const float* Ck = C + k * ldc;
        const float cj = Ck[lane < nq ? lane : 0];
        const float f1 = lane < nq ? w[k] * cj : (lane == nq ? lm[k] : 0.f);
        const float f2 = lane == nq ? tk[k] : 0.f;
#pragma unroll
        for (int i = 0; i < NQ; ++i) {
          h1[i] += f1 * Ck[i];
          h2[i] += f2 * Ck[i];
        }
      }
      float col[NQ];
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        const float hv = (i == lane ? sp[i] + 1e-8f : 0.f) + h1[i];
        float rd = sp[i] * xw[i] + b[i];
        rd += h1[i];
        col[i] = lane == nq ? -(rd + h2[i]) : hv;
      }
      // Gauss-Jordan, no pivoting, unrolled: pivot kk scales row kk of
      // every column and takes its multiple off the other rows; thread kk
      // holds the pivot column.
#pragma unroll
      for (int kk = 0; kk < NQ; ++kk) {
        const float rk = col[kk] / __shfl_sync(kFull, col[kk], kk);
#pragma unroll
        for (int i = 0; i < NQ; ++i) {
          if (i != kk) col[i] = col[i] - __shfl_sync(kFull, col[i], kk) * rk;
        }
        col[kk] = rk;
      }
      // dx, the last column, into every thread.
#pragma unroll
      for (int i = 0; i < NQ; ++i) col[i] = __shfl_sync(kFull, col[i], nq);
      float cd0 = 0.f, cd1 = 0.f;
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        cd0 += C0[i] * col[i];
        cd1 += C1[i] * col[i];
      }
      const float ds0 = -rp0 - cd0, ds1 = -rp1 - cd1;
      const float dl0 = (-rc0 - lam0 * ds0) / ss0;
      const float dl1 = (-rc1 - lam1 * ds1) / ss1;
      const float rs0 = ds0 < 0.f ? -s0 / ds0 : INFINITY;
      const float rl0 = dl0 < 0.f ? -lam0 / dl0 : INFINITY;
      const float rs1 = ds1 < 0.f ? -s1 / ds1 : INFINITY;
      const float rl1 = dl1 < 0.f ? -lam1 / dl1 : INFINITY;
      const float mstep = warp_nmin(nmin(v0 ? nmin(rs0, rl0) : INFINITY,
                                         v1 ? nmin(rs1, rl1) : INFINITY));
      const float alpha = nmin(1.f, 0.995f * mstep);
      bool fin = true;
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        xw[i] = xw[i] + alpha * col[i];
        fin = fin && isfinite(xw[i]);
      }
      s0 = s0 + alpha * ds0;
      s1 = s1 + alpha * ds1;
      lam0 = lam0 + alpha * dl0;
      lam1 = lam1 + alpha * dl1;
      if (fin) {
#pragma unroll
        for (int i = 0; i < NQ; ++i) xk[i] = xw[i];
      }
    }

    // -- carry: dq, cleaned (and canonicalised) duals, next state --
    if (!isfinite(lam0)) lam0 = 0.f;
    if (!isfinite(lam1)) lam1 = 0.f;
    if (canon) {
      // Per contact: rows 2c and 2c+1, neighbouring threads
      // (QuasistaticModel.canon_duals).
      lam0 = (lam0 + __shfl_xor_sync(kFull, lam0, 1)) / 2.f;
      lam1 = (lam1 + __shfl_xor_sync(kFull, lam1, 1)) / 2.f;
    }
    __syncwarp();   // every thread is done with x, u and the rows
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      if (i == lane) {
        const float xn = x[i] + xk[i];
        x[i] = xn;
        xs_l[(size_t)(t + 1) * nq + i] = xn;
      }
    }
    if (lane < m) {
      us_l[(size_t)t * m + lane] = u[lane];
      up[lane] = u[lane];
    }
    __syncwarp();
  }
}

}  // namespace

// Launches one warp per lane on `stream`; zrw null without the prev-input
// block, rlb/rub null without relative bounds; `rows` is the table's row
// count, two for each contact; `links` the link table's records (at least
// one, unread without an arm).  Returns cudaGetLastError() as an int (0 on
// success).
extern "C" int rollout_chain_f32(
    const float* K, const float* zrx, const float* zrw, const float* ur,
    const float* lb, const float* ub, const float* rlb, const float* rub,
    const float* x0, const float* up0, const float* pdiag, const float* pq,
    const float* KUT, const float* tau, const int* pair_i,
    const float* pair_f, const int* link_i, const float* link_f, float* xs,
    float* us, int lanes, int T, int nq, int m, int nz, int pairs, int links,
    int rows, int iters, int canon, void* stream) {
  if (lanes < 1 || T < 1 || nq < 1 || nq > kMaxNq || m < 1 || m > kMaxM ||
      nz > kMaxNz || pairs < 1 || rows < 2 * pairs || rows > kMaxRows ||
      links < 1 || links > kMaxLinkRecords ||
      rows % 2 || iters < 0 ||
      (nz != nq && nz != nq + m) || (zrw == nullptr) != (nz == nq) ||
      (rlb == nullptr) != (rub == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int per = knot_floats(nq, m, nz);
  const int fit = kChunkFloats / per > 1 ? kChunkFloats / per : 1;
  const int tc = T < fit ? T : fit;
  const size_t smem = (size_t)tc * per * sizeof(float);
  switch (nq) {
#define K4_CASE(Q)                                                          \
    case Q:                                                                 \
      rollout_kernel<Q><<<lanes, kThreads, smem, (cudaStream_t)stream>>>(   \
          K, zrx, zrw, ur, lb, ub, rlb, rub, x0, up0, pdiag, pq, KUT, tau,  \
          pair_i, pair_f, link_i, link_f, xs, us, T, tc, m, nz, pairs,       \
          links, rows, iters, canon);                                       \
      break;
    K4_CASE(1) K4_CASE(2) K4_CASE(3) K4_CASE(4) K4_CASE(5) K4_CASE(6)
    K4_CASE(7) K4_CASE(8) K4_CASE(9) K4_CASE(10) K4_CASE(11) K4_CASE(12)
    K4_CASE(13) K4_CASE(14) K4_CASE(15) K4_CASE(16)
#undef K4_CASE
  }
  return (int)cudaGetLastError();
}

extern "C" const char* rollout_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
