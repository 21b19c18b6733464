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
//         pair (mean of its two rows) if the model asks for it,
//   x  <- x + dq.
//
// The model arrives as a table built on the host (rollout.make_consts):
// for every contact pair its first row and contact count, then one record
// per side naming its shape kind (circle, capsule, halfspace, box), its
// body kind (static, free body, Arm2D, prismatic finger) and that body's
// indices and parameters.  The narrow phase implements the JAX kernel's
// eleven pair kinds (rollout._PAIR_KINDS): capsule-circle,
// halfspace-circle, box-circle, capsule-box and halfspace-box, each either
// way round, and circle-circle, in geometry.shape_contact's contact order,
// normal signs and tie rules.  A capsule against a box gives two contacts
// (its ends), a box against a halfspace four (its corners, in the order
// (+,+), (-,+), (-,-), (+,-)); every contact has two rows, at its pair's
// first row + 2c.
//
// What bounds it on an H100: latency.  A lane is T x iters dependent
// Newton steps on a system of at most 16 unknowns and 64 rows, far too
// little work for an SM, and the lanes are independent.  The design is one
// block per lane, the lane's whole state and QP in shared memory, threads
// over contacts (four slots per pair), rows and H entries,
// __syncthreads() between phases, and no return to the host between
// knots.  Scalar reductions (mu, the step length, finiteness) are done by
// one thread over at most 64 rows.  No fast-math: the divisions and the
// 1e10-scaled eliminations are where f32 fails first.
//
// Limits: nq <= 16, m <= 16, nz <= 32, at most 64 rows (32 contacts).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxNq = 16;
constexpr int kMaxM = 16;
constexpr int kMaxRows = 64;
constexpr int kMaxLinks = 4;
constexpr int kMaxContacts = 4;   // per pair: a box's four corners
// Table layout, as rollout.py: per side SIDE_INTS ints and SIDE_FLOATS
// floats; per pair the first row and the contact count, then 2 sides; mu
// first among the floats.
constexpr int kSideInts = 5 + kMaxLinks;
constexpr int kSideFloats = 7 + kMaxLinks;
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

// World geometry of one side of a pair at configuration x.
struct Side {
  int shape, body;
  float cy, cz, r;          // circle or box centre; radius
  float a0y, a0z, a1y, a1z; // capsule segment
  float ny, nz, off;        // halfspace
  float hx, hy, ct, st;     // box half extents; body (base) rotation
  float oy, oz, ay, az;     // finger base and world slide axis
  float jy[kMaxLinks + 1], jz[kMaxLinks + 1];  // arm joints 0..k
};

__device__ void side_geometry(const int* si, const float* sf, const float* x,
                              Side& g) {
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
  } else {  // Arm2D link k
    const int k = si[2];
    g.jy[0] = sf[4];
    g.jz[0] = sf[5];
    float acc = 0.f;
    for (int j = 0; j <= k; ++j) {
      const float a = x[si[5 + j]];
      acc = (j == 0) ? a : acc + a;
      const float ang = acc + sf[6];
      const float L = sf[7 + j];
      g.jy[j + 1] = g.jy[j] + sinf(ang) * L;
      g.jz[j + 1] = g.jz[j] + (-cosf(ang)) * L;
    }
    g.a0y = g.jy[k];
    g.a0z = g.jz[k];
    g.a1y = g.jy[k + 1];
    g.a1z = g.jz[k + 1];
  }
}

// Column i of the point Jacobian (Jy, Jz) of p on one side.
__device__ void side_jacobian(const int* si, const Side& g, float py,
                              float pz, int i, float& Jy, float& Jz) {
  Jy = 0.f;
  Jz = 0.f;
  if (g.body == kFree || g.body == kFinger) {
    // Translation of the body (base); rotation about its origin; a
    // finger's slide along the turned axis.
    const float oy = g.body == kFree ? g.cy : g.oy;
    const float oz = g.body == kFree ? g.cz : g.oz;
    if (i == si[2]) Jy += 1.f;
    if (i == si[3]) Jz += 1.f;
    if (i == si[4]) {
      Jy += -(pz - oz);
      Jz += (py - oy);
    }
    if (g.body == kFinger && i == si[5]) {
      Jy += g.ay;
      Jz += g.az;
    }
  } else if (g.body == kArm) {
    for (int j = 0; j <= si[2]; ++j) {
      if (i == si[5 + j]) {
        Jy += -(pz - g.jz[j]);
        Jz += (py - g.jy[j]);
      }
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
               float* __restrict__ xs,          // (A, T+1, nq)
               float* __restrict__ us,          // (A, T, m)
               int T, int nq, int m, int nz, int pairs, int mr,
               int iters, int canon) {
  __shared__ float x[kMaxNq], xw[kMaxNq], xk[kMaxNq], dq[kMaxNq];
  __shared__ float b[kMaxNq], dx[kMaxNq];
  __shared__ float up[kMaxM], u[kMaxM];
  __shared__ float C[kMaxRows * kMaxNq], d[kMaxRows];
  __shared__ float s[kMaxRows], lam[kMaxRows], rp[kMaxRows], rc[kMaxRows];
  __shared__ float w[kMaxRows], ss[kMaxRows], tk[kMaxRows];
  __shared__ float ds[kMaxRows], dl[kMaxRows], rs[kMaxRows], rl[kMaxRows];
  __shared__ float tab[kMaxNq * (kMaxNq + 1)], rowk[kMaxNq + 1],
      fac[kMaxNq];
  __shared__ float scal[2];   // mu, then the step length alpha
  __shared__ int flag;

  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int w1 = nq + 1;
  const float* zrx_l = zrx + (size_t)lane * T * nq;
  const float* zrw_l = zrw ? zrw + (size_t)lane * T * m : nullptr;
  const float* ur_l = ur + (size_t)lane * T * m;
  float* xs_l = xs + (size_t)lane * (T + 1) * nq;
  float* us_l = us + (size_t)lane * T * m;

  for (int i = tid; i < nq; i += nt) {
    x[i] = x0[i];
    dq[i] = 0.f;
    xs_l[i] = x0[i];
  }
  for (int j = tid; j < m; j += nt) up[j] = up0[j];
  for (int k = tid; k < mr; k += nt) lam[k] = 1.f;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    // -- feedback law and clips --
    const float* Kt = K + (size_t)t * m * nz;
    for (int j = tid; j < m; j += nt) {
      float fb = 0.f;
      for (int l = 0; l < nq; ++l) {
        fb += (x[l] - zrx_l[(size_t)t * nq + l]) * Kt[j * nz + l];
      }
      if (zrw_l) {
        float fw = 0.f;
        for (int l = 0; l < m; ++l) {
          fw += (up[l] - zrw_l[(size_t)t * m + l]) * Kt[j * nz + nq + l];
        }
        fb += fw;
      }
      float v = ur_l[(size_t)t * m + j] - fb;
      if (rlb) {
        v = clip(v, up[j] + rlb[(size_t)t * m + j],
                 up[j] + rub[(size_t)t * m + j]);
      }
      u[j] = clip(v, lb[(size_t)t * m + j], ub[(size_t)t * m + j]);
    }
    __syncthreads();

    // -- assembly: b, and two Anitescu rows per contact --
    for (int i = tid; i < nq; i += nt) {
      float ku = 0.f;
      for (int j = 0; j < m; ++j) ku += u[j] * KUT[j * nq + i];
      b[i] = pq[i] * x[i] - ku - tau[i];
    }
    for (int e = tid; e < pairs * kMaxContacts; e += nt) {
      const int pr = e / kMaxContacts, c = e % kMaxContacts;
      const int* ip = pair_i + (size_t)pr * kPairInts;
      if (c >= ip[1]) continue;
      const int row = ip[0] + 2 * c;
      const int* ia = ip + 2;
      const int* ib = ia + kSideInts;
      const float* fa = pair_f + (size_t)pr * kPairFloats + 1;
      const float* fb = fa + kSideFloats;
      const float mu = pair_f[(size_t)pr * kPairFloats];
      Side ga, gb;
      side_geometry(ia, fa, x, ga);
      side_geometry(ib, fb, x, gb);
      float phi, py, pz, ny, nz_;
      pair_contact(ga, gb, c, phi, py, pz, ny, nz_);
      for (int i = 0; i < nq; ++i) {
        float jay, jaz, jby, jbz;
        side_jacobian(ia, ga, py, pz, i, jay, jaz);
        side_jacobian(ib, gb, py, pz, i, jby, jbz);
        const float ry = jby - jay, rz = jbz - jaz;
        const float jn = ny * ry + nz_ * rz;
        const float jt = (-nz_) * ry + ny * rz;
        C[row * nq + i] = -(jn + mu * jt);
        C[(row + 1) * nq + i] = -(jn - mu * jt);
      }
      d[row] = phi;
      d[row + 1] = phi;
    }
    if (tid == 0) {
      int ok = 1;
      for (int i = 0; i < nq; ++i) ok = ok && isfinite(dq[i]);
      flag = ok;
    }
    __syncthreads();

    // -- warm start from the previous knot's (dq, lam) --
    for (int i = tid; i < nq; i += nt) {
      xw[i] = flag ? dq[i] : 0.f;
      xk[i] = xw[i];
    }
    __syncthreads();
    for (int k = tid; k < mr; k += nt) {
      float acc = 0.f;
      for (int j = 0; j < nq; ++j) acc += C[k * nq + j] * xw[j];
      s[k] = d[k] - acc;
    }
    __syncthreads();
    if (tid == 0) {
      float mn = s[0];
      for (int k = 1; k < mr; ++k) mn = nmin(mn, s[k]);
      scal[0] = nmax(0.f, -mn) + 1e-2f;
    }
    __syncthreads();
    for (int k = tid; k < mr; k += nt) {
      s[k] += scal[0];
      const float l = isfinite(lam[k]) ? lam[k] : 1.f;
      lam[k] = clip(l, 1e-2f, 1e6f);
    }
    __syncthreads();

    for (int it = 0; it < iters; ++it) {
      if (tid == 0) {
        float acc = 0.f;
        for (int k = 0; k < mr; ++k) acc += s[k] * lam[k];
        scal[0] = nmax(acc / (float)mr, 3e-7f);
      }
      __syncthreads();
      const float mu = scal[0];
      for (int k = tid; k < mr; k += nt) {
        float cx = 0.f;
        for (int j = 0; j < nq; ++j) cx += C[k * nq + j] * xw[j];
        rp[k] = cx + s[k] - d[k];
        rc[k] = lam[k] * s[k] - 0.25f * mu;
        ss[k] = nmax(s[k], 1e-7f);
        w[k] = nmin(lam[k] / ss[k], 1e10f);
        tk[k] = w[k] * rp[k] - rc[k] / ss[k];
      }
      __syncthreads();
      for (int e = tid; e < nq * w1; e += nt) {
        const int i = e / w1, j = e % w1;
        if (j < nq) {
          float acc = 0.f;
          for (int k = 0; k < mr; ++k) {
            acc += w[k] * C[k * nq + i] * C[k * nq + j];
          }
          tab[e] = (i == j ? pdiag[i] + 1e-8f : 0.f) + acc;
        } else {
          float rd = pdiag[i] * xw[i] + b[i];
          float cl = 0.f, ct = 0.f;
          for (int k = 0; k < mr; ++k) {
            cl += C[k * nq + i] * lam[k];
            ct += C[k * nq + i] * tk[k];
          }
          rd += cl;
          tab[e] = -(rd + ct);
        }
      }
      __syncthreads();
      // Gauss-Jordan, no pivoting (as K1).
      for (int kk = 0; kk < nq; ++kk) {
        for (int e = tid; e < w1 + nq; e += nt) {
          if (e < w1) {
            rowk[e] = tab[kk * w1 + e] / tab[kk * w1 + kk];
          } else {
            fac[e - w1] = tab[(e - w1) * w1 + kk];
          }
        }
        __syncthreads();
        for (int e = tid; e < nq * w1; e += nt) {
          const int i = e / w1, j = e % w1;
          tab[e] = (i == kk) ? rowk[j] : tab[e] - fac[i] * rowk[j];
        }
        __syncthreads();
      }
      for (int i = tid; i < nq; i += nt) dx[i] = tab[i * w1 + nq];
      __syncthreads();
      for (int k = tid; k < mr; k += nt) {
        float cdx = 0.f;
        for (int j = 0; j < nq; ++j) cdx += C[k * nq + j] * dx[j];
        ds[k] = -rp[k] - cdx;
        dl[k] = (-rc[k] - lam[k] * ds[k]) / ss[k];
        rs[k] = ds[k] < 0.f ? -s[k] / ds[k] : INFINITY;
        rl[k] = dl[k] < 0.f ? -lam[k] / dl[k] : INFINITY;
      }
      __syncthreads();
      if (tid == 0) {
        float ms = rs[0], ml = rl[0];
        for (int k = 1; k < mr; ++k) {
          ms = nmin(ms, rs[k]);
          ml = nmin(ml, rl[k]);
        }
        scal[1] = nmin(1.f, 0.995f * nmin(ms, ml));
      }
      __syncthreads();
      const float alpha = scal[1];
      for (int i = tid; i < nq; i += nt) xw[i] = xw[i] + alpha * dx[i];
      for (int k = tid; k < mr; k += nt) {
        s[k] = s[k] + alpha * ds[k];
        lam[k] = lam[k] + alpha * dl[k];
      }
      __syncthreads();
      if (tid == 0) {
        int ok = 1;
        for (int i = 0; i < nq; ++i) ok = ok && isfinite(xw[i]);
        flag = ok;
      }
      __syncthreads();
      for (int i = tid; i < nq; i += nt) {
        if (flag) xk[i] = xw[i];
      }
      __syncthreads();
    }

    // -- carry: dq, cleaned (and canonicalised) duals, next state --
    for (int k = tid; k < mr; k += nt) {
      if (!isfinite(lam[k])) lam[k] = 0.f;
    }
    __syncthreads();
    if (canon) {
      // Per contact: rows 2c and 2c+1 (QuasistaticModel.canon_duals).
      for (int c = tid; c < mr / 2; c += nt) {
        const float mean = (lam[2 * c] + lam[2 * c + 1]) / 2.f;
        lam[2 * c] = mean;
        lam[2 * c + 1] = mean;
      }
    }
    for (int i = tid; i < nq; i += nt) {
      dq[i] = xk[i];
      x[i] = x[i] + xk[i];
      xs_l[(size_t)(t + 1) * nq + i] = x[i];
    }
    for (int j = tid; j < m; j += nt) {
      us_l[(size_t)t * m + j] = u[j];
      up[j] = u[j];
    }
    __syncthreads();
  }
}

}  // namespace

// Launches one block per lane on `stream`; zrw null without the
// prev-input block, rlb/rub null without relative bounds; `rows` is the
// table's row count, two for each contact.  Returns
// cudaGetLastError() as an int (0 on success).
extern "C" int rollout_chain_f32(
    const float* K, const float* zrx, const float* zrw, const float* ur,
    const float* lb, const float* ub, const float* rlb, const float* rub,
    const float* x0, const float* up0, const float* pdiag, const float* pq,
    const float* KUT, const float* tau, const int* pair_i,
    const float* pair_f, float* xs, float* us, int lanes, int T, int nq,
    int m, int nz, int pairs, int rows, int iters, int canon,
    void* stream) {
  if (lanes < 1 || T < 1 || nq < 1 || nq > kMaxNq || m < 1 || m > kMaxM ||
      pairs < 1 || rows < 2 * pairs || rows > kMaxRows || rows % 2 ||
      iters < 0 ||
      (nz != nq && nz != nq + m) || (zrw == nullptr) != (nz == nq) ||
      (rlb == nullptr) != (rub == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  rollout_kernel<<<lanes, kThreads, 0, (cudaStream_t)stream>>>(
      K, zrx, zrw, ur, lb, ub, rlb, rub, x0, up0, pdiag, pq, KUT, tau,
      pair_i, pair_f, xs, us, T, nq, m, nz, pairs, rows, iters, canon);
  return (int)cudaGetLastError();
}

extern "C" const char* rollout_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
