// Native host-side rasterization data plane (the port's copy of the JAX
// package's native/rasterizer.cc; data/rasterize.py builds it with g++ into
// fsvid2vid_tpu_torch/build/ at first use).
//
// The reference's keypoint2img.py draws skeleton/face edges with Python loops
// over (2*bw)^2 stamp offsets per edge (keypoint2img.py:279-296) — the
// critical input path for the pose and face workloads (SURVEY hard part #6).
// This library implements the same stamping semantics in C++ (including the
// reference's quirk of averaging ALL selected pixels when ANY is already
// set — set_color, keypoint2img.py:267-276), exposed through a plain C
// interface that is loaded with ctypes.

#include <algorithm>
#include <cstdint>
#include <cstring>

namespace {

inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// set_color over a point set: if every addressed pixel is zero, assign the
// color; otherwise average every addressed pixel with the color.
void set_color_rgb(uint8_t* im, int h, int w, const int32_t* ys,
                   const int32_t* xs, int n, const uint8_t color[3]) {
  bool all_zero = true;
  for (int i = 0; i < n && all_zero; ++i) {
    const uint8_t* p = im + (static_cast<int64_t>(ys[i]) * w + xs[i]) * 3;
    all_zero = (p[0] | p[1] | p[2]) == 0;
  }
  if (all_zero) {
    for (int i = 0; i < n; ++i) {
      uint8_t* p = im + (static_cast<int64_t>(ys[i]) * w + xs[i]) * 3;
      p[0] = color[0];
      p[1] = color[1];
      p[2] = color[2];
    }
  } else {
    // numpy fancy indexing gathers originals before writing: duplicates do
    // not compound, so average against a snapshot (two passes).
    static thread_local uint8_t* orig = nullptr;
    static thread_local int ocap = 0;
    if (n * 3 > ocap) {
      delete[] orig;
      ocap = n * 6;
      orig = new uint8_t[ocap];
    }
    for (int i = 0; i < n; ++i) {
      const uint8_t* p = im + (static_cast<int64_t>(ys[i]) * w + xs[i]) * 3;
      std::memcpy(orig + i * 3, p, 3);
    }
    for (int i = 0; i < n; ++i) {
      uint8_t* p = im + (static_cast<int64_t>(ys[i]) * w + xs[i]) * 3;
      p[0] = static_cast<uint8_t>((static_cast<int>(orig[i * 3 + 0]) + color[0]) / 2);
      p[1] = static_cast<uint8_t>((static_cast<int>(orig[i * 3 + 1]) + color[1]) / 2);
      p[2] = static_cast<uint8_t>((static_cast<int>(orig[i * 3 + 2]) + color[2]) / 2);
    }
  }
}

void set_color_gray(uint8_t* im, int h, int w, const int32_t* ys,
                    const int32_t* xs, int n, uint8_t color) {
  for (int i = 0; i < n; ++i) {
    im[static_cast<int64_t>(ys[i]) * w + xs[i]] = color;
  }
}

}  // namespace

extern "C" {

// Draw a polyline (curve sample points) with thickness bw into an image.
// channels: 3 (RGB, averaged-overlap semantics) or 1 (grayscale overwrite).
// draw_end_points: additionally stamp discs of radius 2*bw at both ends.
void draw_edge(uint8_t* im, int h, int w, int channels, const int32_t* xs,
               const int32_t* ys, int n, int bw, const uint8_t* color,
               int draw_end_points) {
  if (n <= 0) return;
  // scratch clipped coordinates
  static thread_local int32_t* yy = nullptr;
  static thread_local int32_t* xx = nullptr;
  static thread_local int cap = 0;
  if (n > cap) {
    delete[] yy;
    delete[] xx;
    cap = n * 2;
    yy = new int32_t[cap];
    xx = new int32_t[cap];
  }
  for (int i = -bw; i < bw; ++i) {
    for (int j = -bw; j < bw; ++j) {
      for (int k = 0; k < n; ++k) {
        yy[k] = clampi(ys[k] + i, 0, h - 1);
        xx[k] = clampi(xs[k] + j, 0, w - 1);
      }
      if (channels == 3) {
        set_color_rgb(im, h, w, yy, xx, n, color);
      } else {
        set_color_gray(im, h, w, yy, xx, n, color[0]);
      }
    }
  }
  if (draw_end_points) {
    int32_t ey[2] = {ys[0], ys[n - 1]};
    int32_t ex[2] = {xs[0], xs[n - 1]};
    int32_t cy[2], cx[2];
    for (int i = -bw * 2; i < bw * 2; ++i) {
      for (int j = -bw * 2; j < bw * 2; ++j) {
        if (i * i + j * j < 4 * bw * bw) {
          for (int k = 0; k < 2; ++k) {
            cy[k] = clampi(ey[k] + i, 0, h - 1);
            cx[k] = clampi(ex[k] + j, 0, w - 1);
          }
          if (channels == 3) {
            set_color_rgb(im, h, w, cy, cx, 2, color);
          } else {
            set_color_gray(im, h, w, cy, cx, 2, color[0]);
          }
        }
      }
    }
  }
}

}  // extern "C"
