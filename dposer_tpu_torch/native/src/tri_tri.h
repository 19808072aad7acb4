// Triangle-triangle intersection (Möller 1997, "A Fast Triangle-Triangle
// Intersection Test") — used by the mesh self-intersection metric.
// Self-contained header, no external deps.
#pragma once

#include <cmath>

namespace dposer {

using Real = double;

struct V3 {
  Real x, y, z;
};

inline V3 sub(const V3 &a, const V3 &b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline V3 cross(const V3 &a, const V3 &b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
inline Real dot(const V3 &a, const V3 &b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

inline constexpr Real kEps = 1e-10;

// Project the triangle onto the intersection line and compute the scalar
// interval [isect0, isect1]. Returns false when the triangle degenerately
// fails the plane split (coplanar handled by the caller).
inline bool compute_intervals(Real vv0, Real vv1, Real vv2, Real d0, Real d1,
                              Real d2, Real d0d1, Real d0d2, Real *isect0,
                              Real *isect1) {
  auto isect = [](Real vva, Real vvb, Real da, Real db, Real *i) {
    *i = vva + (vvb - vva) * da / (da - db);
  };
  if (d0d1 > 0.0) {
    // d0, d1 same side, d2 on the other
    isect(vv2, vv0, d2, d0, isect0);
    isect(vv2, vv1, d2, d1, isect1);
  } else if (d0d2 > 0.0) {
    isect(vv1, vv0, d1, d0, isect0);
    isect(vv1, vv2, d1, d2, isect1);
  } else if (d1 * d2 > 0.0 || d0 != 0.0) {
    isect(vv0, vv1, d0, d1, isect0);
    isect(vv0, vv2, d0, d2, isect1);
  } else if (d1 != 0.0) {
    isect(vv1, vv0, d1, d0, isect0);
    isect(vv1, vv2, d1, d2, isect1);
  } else if (d2 != 0.0) {
    isect(vv2, vv0, d2, d0, isect0);
    isect(vv2, vv1, d2, d1, isect1);
  } else {
    return false;  // coplanar
  }
  return true;
}

// 2D helpers for the coplanar case.
inline bool edge_edge_test(const Real *v0, const Real *u0, const Real *u1,
                           Real ax, Real ay, int i0, int i1) {
  const Real bx = u0[i0] - u1[i0];
  const Real by = u0[i1] - u1[i1];
  const Real cx = v0[i0] - u0[i0];
  const Real cy = v0[i1] - u0[i1];
  const Real f = ay * bx - ax * by;
  const Real d = by * cx - bx * cy;
  if ((f > 0 && d >= 0 && d <= f) || (f < 0 && d <= 0 && d >= f)) {
    const Real e = ax * cy - ay * cx;
    if (f > 0) {
      if (e >= 0 && e <= f) return true;
    } else {
      if (e <= 0 && e >= f) return true;
    }
  }
  return false;
}

inline bool edge_against_tri_edges(const Real *v0, const Real *v1,
                                   const Real *u0, const Real *u1,
                                   const Real *u2, int i0, int i1) {
  const Real ax = v1[i0] - v0[i0];
  const Real ay = v1[i1] - v0[i1];
  return edge_edge_test(v0, u0, u1, ax, ay, i0, i1) ||
         edge_edge_test(v0, u1, u2, ax, ay, i0, i1) ||
         edge_edge_test(v0, u2, u0, ax, ay, i0, i1);
}

inline bool point_in_tri(const Real *v0, const Real *u0, const Real *u1,
                         const Real *u2, int i0, int i1) {
  Real a = u1[i1] - u0[i1];
  Real b = -(u1[i0] - u0[i0]);
  Real c = -a * u0[i0] - b * u0[i1];
  const Real d0 = a * v0[i0] + b * v0[i1] + c;

  a = u2[i1] - u1[i1];
  b = -(u2[i0] - u1[i0]);
  c = -a * u1[i0] - b * u1[i1];
  const Real d1 = a * v0[i0] + b * v0[i1] + c;

  a = u0[i1] - u2[i1];
  b = -(u0[i0] - u2[i0]);
  c = -a * u2[i0] - b * u2[i1];
  const Real d2 = a * v0[i0] + b * v0[i1] + c;

  return d0 * d1 > 0.0 && d0 * d2 > 0.0;
}

inline bool coplanar_tri_tri(const V3 &n, const V3 &v0, const V3 &v1,
                             const V3 &v2, const V3 &u0, const V3 &u1,
                             const V3 &u2) {
  const Real a[3] = {std::fabs(n.x), std::fabs(n.y), std::fabs(n.z)};
  int i0, i1;
  if (a[0] > a[1]) {
    if (a[0] > a[2]) { i0 = 1; i1 = 2; }
    else { i0 = 0; i1 = 1; }
  } else {
    if (a[2] > a[1]) { i0 = 0; i1 = 1; }
    else { i0 = 0; i1 = 2; }
  }
  const Real V0[3] = {v0.x, v0.y, v0.z}, V1[3] = {v1.x, v1.y, v1.z},
             V2[3] = {v2.x, v2.y, v2.z};
  const Real U0[3] = {u0.x, u0.y, u0.z}, U1[3] = {u1.x, u1.y, u1.z},
             U2[3] = {u2.x, u2.y, u2.z};
  return edge_against_tri_edges(V0, V1, U0, U1, U2, i0, i1) ||
         edge_against_tri_edges(V1, V2, U0, U1, U2, i0, i1) ||
         edge_against_tri_edges(V2, V0, U0, U1, U2, i0, i1) ||
         point_in_tri(V0, U0, U1, U2, i0, i1) ||
         point_in_tri(U0, V0, V1, V2, i0, i1);
}

// Möller's interval-overlap test with CALLER-SUPPLIED face planes
// (n = cross(e1, e2), d = -dot(n, v0)). The self-intersection metric tests
// each face against many partners, so computing every face's plane once per
// mesh (instead of twice per candidate pair) removes the two cross products
// and re-derivations from the pair hot path. Degenerate (eps-close) plane
// distances are snapped to zero like the reference algorithm with
// USE_EPSILON_TEST.
inline bool tri_tri_intersect_planes(const V3 &v0, const V3 &v1, const V3 &v2,
                                     const V3 &u0, const V3 &u1, const V3 &u2,
                                     const V3 &n1, Real d1, const V3 &n2,
                                     Real d2) {
  Real du0 = dot(n1, u0) + d1;
  Real du1 = dot(n1, u1) + d1;
  Real du2 = dot(n1, u2) + d1;
  if (std::fabs(du0) < kEps) du0 = 0.0;
  if (std::fabs(du1) < kEps) du1 = 0.0;
  if (std::fabs(du2) < kEps) du2 = 0.0;
  const Real du0du1 = du0 * du1, du0du2 = du0 * du2;
  if (du0du1 > 0.0 && du0du2 > 0.0) return false;

  Real dv0 = dot(n2, v0) + d2;
  Real dv1 = dot(n2, v1) + d2;
  Real dv2 = dot(n2, v2) + d2;
  if (std::fabs(dv0) < kEps) dv0 = 0.0;
  if (std::fabs(dv1) < kEps) dv1 = 0.0;
  if (std::fabs(dv2) < kEps) dv2 = 0.0;
  const Real dv0dv1 = dv0 * dv1, dv0dv2 = dv0 * dv2;
  if (dv0dv1 > 0.0 && dv0dv2 > 0.0) return false;

  const V3 dir = cross(n1, n2);
  const Real ax = std::fabs(dir.x), ay = std::fabs(dir.y), az = std::fabs(dir.z);
  Real vp0, vp1, vp2, up0, up1, up2;
  if (ax >= ay && ax >= az) {
    vp0 = v0.x; vp1 = v1.x; vp2 = v2.x;
    up0 = u0.x; up1 = u1.x; up2 = u2.x;
  } else if (ay >= az) {
    vp0 = v0.y; vp1 = v1.y; vp2 = v2.y;
    up0 = u0.y; up1 = u1.y; up2 = u2.y;
  } else {
    vp0 = v0.z; vp1 = v1.z; vp2 = v2.z;
    up0 = u0.z; up1 = u1.z; up2 = u2.z;
  }

  Real isect1[2], isect2[2];
  if (!compute_intervals(vp0, vp1, vp2, dv0, dv1, dv2, dv0dv1, dv0dv2,
                         &isect1[0], &isect1[1]))
    return coplanar_tri_tri(n1, v0, v1, v2, u0, u1, u2);
  if (!compute_intervals(up0, up1, up2, du0, du1, du2, du0du1, du0du2,
                         &isect2[0], &isect2[1]))
    return coplanar_tri_tri(n1, v0, v1, v2, u0, u1, u2);

  if (isect1[0] > isect1[1]) std::swap(isect1[0], isect1[1]);
  if (isect2[0] > isect2[1]) std::swap(isect2[0], isect2[1]);
  return !(isect1[1] < isect2[0] || isect2[1] < isect1[0]);
}

// Original self-contained form (computes both planes, then delegates):
// kept for the unit test C API and one-off callers.
inline bool tri_tri_intersect(const V3 &v0, const V3 &v1, const V3 &v2,
                              const V3 &u0, const V3 &u1, const V3 &u2) {
  const V3 n1 = cross(sub(v1, v0), sub(v2, v0));
  const Real d1 = -dot(n1, v0);
  const V3 n2 = cross(sub(u1, u0), sub(u2, u0));
  const Real d2 = -dot(n2, u0);
  return tri_tri_intersect_planes(v0, v1, v2, u0, u1, u2, n1, d1, n2, d2);
}

}  // namespace dposer
