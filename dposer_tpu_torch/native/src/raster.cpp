// Flat-shaded z-buffer software rasterizer (native fast path for
// dposer_tpu.body_model.visual — this environment has no GL/EGL).
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// verts: [n_verts, 3] camera-space float32 (z > 0 forward);
// faces: [n_faces, 3] int32; rgb_out: [h, w, 3] float32; mask_out: [h, w] u8.
void rasterize(const float *verts, int n_verts, const int32_t *faces,
               int n_faces, int h, int w, float fx, float fy, float cx,
               float cy, const float *light_dir, const float *base_color,
               float *rgb_out, uint8_t *mask_out) {
  std::vector<float> xs(n_verts), ys(n_verts), zs(n_verts);
  for (int i = 0; i < n_verts; ++i) {
    const float z = std::max(verts[3 * i + 2], 1e-6f);
    xs[i] = verts[3 * i] * fx / z + cx;
    ys[i] = verts[3 * i + 1] * fy / z + cy;
    zs[i] = z;
  }

  std::vector<float> zbuf((size_t)h * w, 1e30f);
  std::fill(rgb_out, rgb_out + (size_t)h * w * 3, 0.0f);
  std::fill(mask_out, mask_out + (size_t)h * w, 0);

  float ld[3] = {light_dir[0], light_dir[1], light_dir[2]};
  const float ln = std::sqrt(ld[0] * ld[0] + ld[1] * ld[1] + ld[2] * ld[2]);
  for (float &c : ld) c /= (ln > 0 ? ln : 1.0f);

  for (int f = 0; f < n_faces; ++f) {
    const int i0 = faces[3 * f], i1 = faces[3 * f + 1], i2 = faces[3 * f + 2];
    // cull faces that touch the near plane: the z-clamped projection of a
    // behind-camera vertex lands at ~1e8 px and its z (1e-6) beats the
    // whole z-buffer, smearing one face across the frame
    if (verts[3 * i0 + 2] <= 1e-6f || verts[3 * i1 + 2] <= 1e-6f ||
        verts[3 * i2 + 2] <= 1e-6f)
      continue;
    // face normal in camera space
    float e0[3], e1[3];
    for (int k = 0; k < 3; ++k) {
      e0[k] = verts[3 * i1 + k] - verts[3 * i0 + k];
      e1[k] = verts[3 * i2 + k] - verts[3 * i0 + k];
    }
    float n[3] = {e0[1] * e1[2] - e0[2] * e1[1], e0[2] * e1[0] - e0[0] * e1[2],
                  e0[0] * e1[1] - e0[1] * e1[0]};
    const float nn = std::sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]);
    if (nn < 1e-12f) continue;
    float shade = std::fabs((n[0] * ld[0] + n[1] * ld[1] + n[2] * ld[2]) / nn);
    shade = std::min(std::max(shade, 0.15f), 1.0f);

    const float ax = xs[i0], ay = ys[i0], bx = xs[i1], by = ys[i1],
                cx2 = xs[i2], cy2 = ys[i2];
    const float den = (by - cy2) * (ax - cx2) + (cx2 - bx) * (ay - cy2);
    if (std::fabs(den) < 1e-12f) continue;

    int x0 = std::max((int)std::floor(std::min({ax, bx, cx2})), 0);
    int x1 = std::min((int)std::ceil(std::max({ax, bx, cx2})) + 1, w);
    int y0 = std::max((int)std::floor(std::min({ay, by, cy2})), 0);
    int y1 = std::min((int)std::ceil(std::max({ay, by, cy2})) + 1, h);

    for (int y = y0; y < y1; ++y) {
      for (int x = x0; x < x1; ++x) {
        const float px = x + 0.5f, py = y + 0.5f;
        const float w0 = ((by - cy2) * (px - cx2) + (cx2 - bx) * (py - cy2)) / den;
        const float w1 = ((cy2 - ay) * (px - cx2) + (ax - cx2) * (py - cy2)) / den;
        const float w2 = 1.0f - w0 - w1;
        if (w0 < 0 || w1 < 0 || w2 < 0) continue;
        const float z = w0 * zs[i0] + w1 * zs[i1] + w2 * zs[i2];
        const size_t idx = (size_t)y * w + x;
        if (z < zbuf[idx]) {
          zbuf[idx] = z;
          rgb_out[3 * idx] = base_color[0] * shade * 255.0f;
          rgb_out[3 * idx + 1] = base_color[1] * shade * 255.0f;
          rgb_out[3 * idx + 2] = base_color[2] * shade * 255.0f;
          mask_out[idx] = 1;
        }
      }
    }
  }
}
}
