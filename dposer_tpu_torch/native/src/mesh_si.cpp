// Mesh self-intersection metric (native replacement for pymeshlab,
// ref lib/utils/metric.py:41-89): percentage of faces intersecting at least
// one non-adjacent face (faces sharing a vertex are excluded).
//
// Broad phase: uniform grid over the mesh AABB with per-cell face lists;
// narrow phase: Möller tri-tri. C API for ctypes.
#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

#include "tri_tri.h"

namespace {

using dposer::Real;
using dposer::V3;

// float bounds: the input coordinates ARE float32, so float min/max are
// exact and the screening is bit-identical to double boxes — at half the
// memory traffic of the pair loop's random box loads
struct AABB {
  float lo[3], hi[3];
};

inline bool aabb_overlap(const AABB &a, const AABB &b) {
  for (int k = 0; k < 3; ++k)
    if (a.hi[k] < b.lo[k] || b.hi[k] < a.lo[k]) return false;
  return true;
}

int self_intersecting_faces(const float *verts, int n_verts, const int32_t *faces,
                            int n_faces, uint8_t *flags) {
  std::fill(flags, flags + n_faces, 0);
  if (n_faces == 0) return 0;

  std::vector<V3> v(n_verts);
  for (int i = 0; i < n_verts; ++i)
    v[i] = {verts[3 * i], verts[3 * i + 1], verts[3 * i + 2]};

  std::vector<AABB> boxes(n_faces);
  AABB mesh_box = {{1e30f, 1e30f, 1e30f}, {-1e30f, -1e30f, -1e30f}};
  double mean_extent = 0.0;
  for (int f = 0; f < n_faces; ++f) {
    AABB &b = boxes[f];
    for (int k = 0; k < 3; ++k) {
      b.lo[k] = 1e30f;
      b.hi[k] = -1e30f;
    }
    for (int j = 0; j < 3; ++j) {
      const V3 &p = v[faces[3 * f + j]];
      const float c[3] = {(float)p.x, (float)p.y, (float)p.z};
      for (int k = 0; k < 3; ++k) {
        b.lo[k] = std::min(b.lo[k], c[k]);
        b.hi[k] = std::max(b.hi[k], c[k]);
      }
    }
    for (int k = 0; k < 3; ++k) {
      mesh_box.lo[k] = std::min(mesh_box.lo[k], b.lo[k]);
      mesh_box.hi[k] = std::max(mesh_box.hi[k], b.hi[k]);
      mean_extent += (b.hi[k] - b.lo[k]);
    }
  }
  mean_extent /= (3.0 * n_faces);
  if (mean_extent <= 0.0) mean_extent = 1e-6;

  // grid resolution ~ mean face size; clamp cell count
  int dims[3];
  Real cell[3], origin[3];
  for (int k = 0; k < 3; ++k) {
    const Real extent = std::max((Real)(mesh_box.hi[k] - mesh_box.lo[k]),
                                 (Real)1e-9);
    int d = (int)std::ceil(extent / (2.0 * mean_extent));
    dims[k] = std::min(std::max(d, 1), 128);
    cell[k] = extent / dims[k];
    origin[k] = mesh_box.lo[k];
  }

  const int n_cells = dims[0] * dims[1] * dims[2];
  auto cell_range = [&](const AABB &b, int lo_i[3], int hi_i[3]) {
    for (int k = 0; k < 3; ++k) {
      lo_i[k] = std::min(std::max((int)((b.lo[k] - origin[k]) / cell[k]), 0), dims[k] - 1);
      hi_i[k] = std::min(std::max((int)((b.hi[k] - origin[k]) / cell[k]), 0), dims[k] - 1);
    }
  };
  // CSR grid (count -> prefix sum -> fill): one flat item array instead
  // of n_cells vectors — removes the per-cell allocation churn that
  // dominated the broad-phase build (per-cell iteration order is the
  // same face order as the old push_back build, so results are
  // bit-identical)
  std::vector<int> cell_start(n_cells + 1, 0);
  for (int f = 0; f < n_faces; ++f) {
    int lo_i[3], hi_i[3];
    cell_range(boxes[f], lo_i, hi_i);
    for (int x = lo_i[0]; x <= hi_i[0]; ++x)
      for (int y = lo_i[1]; y <= hi_i[1]; ++y)
        for (int z = lo_i[2]; z <= hi_i[2]; ++z)
          ++cell_start[(x * dims[1] + y) * dims[2] + z + 1];
  }
  for (int c = 0; c < n_cells; ++c) cell_start[c + 1] += cell_start[c];
  std::vector<int> cell_items(cell_start[n_cells]);
  std::vector<int> cursor(cell_start.begin(), cell_start.end() - 1);
  for (int f = 0; f < n_faces; ++f) {
    int lo_i[3], hi_i[3];
    cell_range(boxes[f], lo_i, hi_i);
    for (int x = lo_i[0]; x <= hi_i[0]; ++x)
      for (int y = lo_i[1]; y <= hi_i[1]; ++y)
        for (int z = lo_i[2]; z <= hi_i[2]; ++z)
          cell_items[cursor[(x * dims[1] + y) * dims[2] + z]++] = f;
  }

  // vertex -> incident-face CSR: adjacency (vertex-sharing) pairs are
  // excluded by PRE-STAMPING each face's neighbors into the dedup array
  // before its cell scan — the dedup check the pair loop already does
  // then rejects them with zero extra work. This removes the 9-compare
  // shares_vertex test (and its two random face-id cache lines) from the
  // hot path: on the smooth-body workload ~87% of AABB-passing
  // candidates were adjacent, and the measured pair phase drops
  // 10.6 -> 7.2 ms/mesh (with the float boxes above).
  std::vector<int> vstart(n_verts + 1, 0);
  for (int f = 0; f < 3 * n_faces; ++f) ++vstart[faces[f] + 1];
  for (int i = 0; i < n_verts; ++i) vstart[i + 1] += vstart[i];
  std::vector<int> vfaces(vstart[n_verts]);
  {
    std::vector<int> vcur(vstart.begin(), vstart.end() - 1);
    for (int f = 0; f < n_faces; ++f)
      for (int j = 0; j < 3; ++j) vfaces[vcur[faces[3 * f + j]]++] = f;
  }

  // Per-face planes computed ONCE (the narrow phase otherwise re-derives
  // both triangle planes for every candidate pair — each face is tested
  // against many partners, so this removes the cross products and plane
  // constants from the pair hot path; ~1.3x on the 500-mesh protocol)
  std::vector<V3> normals(n_faces);
  std::vector<Real> pd(n_faces);
  for (int f = 0; f < n_faces; ++f) {
    const V3 &p0 = v[faces[3 * f]];
    const V3 &p1 = v[faces[3 * f + 1]];
    const V3 &p2 = v[faces[3 * f + 2]];
    normals[f] = dposer::cross(dposer::sub(p1, p0), dposer::sub(p2, p0));
    pd[f] = -dposer::dot(normals[f], p0);
  }

  int count = 0;
  std::vector<int> last_checked(n_faces, -1);
  for (int f = 0; f < n_faces; ++f) {
    int lo_i[3], hi_i[3];
    cell_range(boxes[f], lo_i, hi_i);
    const V3 &a0 = v[faces[3 * f]];
    const V3 &a1 = v[faces[3 * f + 1]];
    const V3 &a2 = v[faces[3 * f + 2]];
    bool hit = flags[f];
    // pre-stamp vertex-sharing neighbors (see the CSR build above)
    for (int j = 0; j < 3; ++j) {
      const int vid = faces[3 * f + j];
      for (int ii = vstart[vid]; ii < vstart[vid + 1]; ++ii)
        last_checked[vfaces[ii]] = f;
    }
    for (int x = lo_i[0]; x <= hi_i[0] && !hit; ++x)
      for (int y = lo_i[1]; y <= hi_i[1] && !hit; ++y)
        for (int z = lo_i[2]; z <= hi_i[2] && !hit; ++z) {
          const int c = (x * dims[1] + y) * dims[2] + z;
          for (int ii = cell_start[c]; ii < cell_start[c + 1]; ++ii) {
            const int g = cell_items[ii];
            if (g == f || last_checked[g] == f) continue;
            last_checked[g] = f;
            if (!aabb_overlap(boxes[f], boxes[g])) continue;
            const V3 &b0 = v[faces[3 * g]];
            const V3 &b1 = v[faces[3 * g + 1]];
            const V3 &b2 = v[faces[3 * g + 2]];
            if (dposer::tri_tri_intersect_planes(a0, a1, a2, b0, b1, b2,
                                                 normals[f], pd[f],
                                                 normals[g], pd[g])) {
              flags[g] = 1;  // mark partner too
              hit = true;
              break;
            }
          }
        }
    if (hit) flags[f] = 1;
  }
  for (int f = 0; f < n_faces; ++f) count += flags[f];
  return count;
}

}  // namespace

extern "C" {

// verts: [n_batch, n_verts, 3] float32; faces: [n_faces, 3] int32;
// out: [n_batch] float32 percentages. Meshes are independent -> threaded
// over the batch (n_threads <= 0: hardware_concurrency). The protocol tail
// (500 SMPL meshes, ref run/demo.py:137-161) is otherwise serial host work.
void self_intersections_percentage_mt(const float *verts, int n_batch,
                                      int n_verts, const int32_t *faces,
                                      int n_faces, float *out,
                                      int n_threads) {
  if (n_threads <= 0) {
    unsigned hc = std::thread::hardware_concurrency();
    n_threads = hc ? (int)hc : 1;
  }
  n_threads = std::min(n_threads, std::max(n_batch, 1));
  std::atomic<int> next(0);
  auto worker = [&]() {
    std::vector<uint8_t> flags(n_faces);  // per-thread scratch
    for (;;) {
      const int b = next.fetch_add(1);
      if (b >= n_batch) return;
      const int si = self_intersecting_faces(verts + (size_t)b * n_verts * 3,
                                             n_verts, faces, n_faces,
                                             flags.data());
      out[b] = n_faces ? 100.0f * si / n_faces : 0.0f;
    }
  };
  if (n_threads == 1) {
    worker();
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
  for (auto &th : pool) th.join();
}

void self_intersections_percentage(const float *verts, int n_batch, int n_verts,
                                   const int32_t *faces, int n_faces,
                                   float *out) {
  self_intersections_percentage_mt(verts, n_batch, n_verts, faces, n_faces,
                                   out, 0);
}

// Exposed for unit tests: 1 if the two triangles intersect.
int tri_tri_test(const float *t1, const float *t2) {
  auto mk = [](const float *p) -> V3 { return {p[0], p[1], p[2]}; };
  return dposer::tri_tri_intersect(mk(t1), mk(t1 + 3), mk(t1 + 6), mk(t2),
                                   mk(t2 + 3), mk(t2 + 6))
             ? 1
             : 0;
}
}
