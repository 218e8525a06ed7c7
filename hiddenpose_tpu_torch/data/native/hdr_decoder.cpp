// Native measurement decoder: Radiance RGBE (.hdr) -> preprocessed transient.
//
// C++ equivalent of the reference's hottest host-side path
// (the reference's `utils/nlos_pose_dataloader.py:76-119`):
//   cv2.imread(.hdr) -> BGR2GRAY -> /max -> reshape (600,256,256)[:512]
//   -> temporal pair-average -> optional /2 on all axes
// fused into one pass with OpenMP over scanlines.  Exposed via ctypes
// (bound by `hiddenpose_tpu_torch/data/native_loader.py`; no fallback).
//
// HDR format: ASCII header to a blank line, resolution line "-Y H +X W",
// then H scanlines; new-style scanlines are RLE per component
// (0x02 0x02 hi lo), old-style are raw RGBE quadruples.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct Image {
  int width = 0;
  int height = 0;
  std::vector<uint8_t> rgbe;  // H*W*4
};

bool read_line(FILE* f, char* buf, int cap) {
  if (!std::fgets(buf, cap, f)) return false;
  return true;
}

// Decode one scanline of W RGBE pixels into out (W*4 bytes).
bool decode_scanline(FILE* f, uint8_t* out, int w) {
  uint8_t head[4];
  if (std::fread(head, 1, 4, f) != 4) return false;
  if (head[0] == 2 && head[1] == 2 && ((head[2] << 8) | head[3]) == w) {
    // New-style: 4 components, RLE.
    for (int c = 0; c < 4; ++c) {
      int x = 0;
      while (x < w) {
        int code = std::fgetc(f);
        if (code < 0) return false;
        if (code > 128) {  // run
          int count = code - 128;
          int v = std::fgetc(f);
          if (v < 0 || x + count > w) return false;
          for (int i = 0; i < count; ++i) out[4 * (x + i) + c] = (uint8_t)v;
          x += count;
        } else {  // literal
          int count = code;
          if (x + count > w) return false;
          for (int i = 0; i < count; ++i) {
            int v = std::fgetc(f);
            if (v < 0) return false;
            out[4 * (x + i) + c] = (uint8_t)v;
          }
          x += count;
        }
      }
    }
    return true;
  }
  // Old-style: head already holds pixel 0.
  std::memcpy(out, head, 4);
  int x = 1;
  int shift = 0;
  while (x < w) {
    uint8_t px[4];
    if (std::fread(px, 1, 4, f) != 4) return false;
    if (px[0] == 1 && px[1] == 1 && px[2] == 1) {  // old RLE
      int count = px[3] << shift;
      if (x == 0 || x + count > w) return false;
      for (int i = 0; i < count; ++i)
        std::memcpy(out + 4 * (x + i), out + 4 * (x - 1), 4);
      x += count;
      shift += 8;
    } else {
      std::memcpy(out + 4 * x, px, 4);
      ++x;
      shift = 0;
    }
  }
  return true;
}

bool load_hdr(const char* path, Image* img) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  char line[512];
  if (!read_line(f, line, sizeof line) ||
      (std::strncmp(line, "#?", 2) != 0)) {
    std::fclose(f);
    return false;
  }
  // header until blank line
  while (read_line(f, line, sizeof line)) {
    if (line[0] == '\n' || line[0] == '\r') break;
  }
  if (!read_line(f, line, sizeof line)) { std::fclose(f); return false; }
  int h = 0, w = 0;
  if (std::sscanf(line, "-Y %d +X %d", &h, &w) != 2) {
    std::fclose(f);
    return false;
  }
  img->width = w;
  img->height = h;
  img->rgbe.assign((size_t)w * h * 4, 0);
  for (int y = 0; y < h; ++y) {
    if (!decode_scanline(f, img->rgbe.data() + (size_t)y * w * 4, w)) {
      std::fclose(f);
      return false;
    }
  }
  std::fclose(f);
  return true;
}

inline float rgbe_component(uint8_t m, uint8_t e) {
  if (e == 0) return 0.0f;
  // Radiance convention: v = (m + 0.5) * 2^(e-136)  (matches cv2 within
  // the 0.5-ulp mantissa offset; both normalise by max afterwards).
  return std::ldexp((float)m + 0.5f, (int)e - 136);
}

}  // namespace

extern "C" {

// Decode + grayscale + /max.  out must hold height*width floats.
// Returns 0 on success; fills out_h/out_w.
int hdr_decode_gray(const char* path, float* out, int* out_h, int* out_w,
                    long out_capacity) {
  Image img;
  if (!load_hdr(path, &img)) return 1;
  long n = (long)img.width * img.height;
  if (n > out_capacity) return 2;
  *out_h = img.height;
  *out_w = img.width;

  float maxv = 0.0f;
#pragma omp parallel for reduction(max : maxv) schedule(static)
  for (long i = 0; i < n; ++i) {
    const uint8_t* p = &img.rgbe[4 * i];
    uint8_t e = p[3];
    float r = rgbe_component(p[0], e);
    float g = rgbe_component(p[1], e);
    float b = rgbe_component(p[2], e);
    if (r > maxv) maxv = r;
    if (g > maxv) maxv = g;
    if (b > maxv) maxv = b;
    out[i] = r;  // stash r; recompute gray below after max-normalising rgb
  }
  if (maxv <= 0.0f) return 3;

  // gray = 0.299 R + 0.587 G + 0.114 B on the /max-normalised image
  // (cv2 BGR2GRAY weights), then a second /max over the gray image
  // (nlos_pose_dataloader.py:85-87 normalises twice).
  float gmax = 0.0f;
#pragma omp parallel for reduction(max : gmax) schedule(static)
  for (long i = 0; i < n; ++i) {
    const uint8_t* p = &img.rgbe[4 * i];
    uint8_t e = p[3];
    float r = rgbe_component(p[0], e) / maxv;
    float g = rgbe_component(p[1], e) / maxv;
    float b = rgbe_component(p[2], e) / maxv;
    float gray = 0.299f * r + 0.587f * g + 0.114f * b;
    out[i] = gray;
    if (gray > gmax) gmax = gray;
  }
  if (gmax <= 0.0f) return 3;
  float inv = 1.0f / gmax;
#pragma omp parallel for schedule(static)
  for (long i = 0; i < n; ++i) out[i] *= inv;
  return 0;
}

// Full measurement preprocess: gray (t*h, w) frames -> (T_out, h>>ds, w>>ds)
// with temporal crop+pair-average and ds further halvings of all axes.
// gray: (t_frames*h, w); out: ((crop/2) >> ds) * (h >> ds) * (w >> ds).
int preprocess_meas(const float* gray, int t_frames, int h, int w, int crop,
                    int downsample_cnt, float* out) {
  int t1 = crop / 2;               // after pair-average
  int ds = downsample_cnt;
  int t_out = t1 >> ds, h_out = h >> ds, w_out = w >> ds;
  int block = 1 << ds;             // spatial/temporal block size per output
  if (t_out <= 0 || h_out <= 0 || w_out <= 0) return 1;

  float scale = 1.0f / (2.0f * block * block * block);
#pragma omp parallel for collapse(2) schedule(static)
  for (int to = 0; to < t_out; ++to) {
    for (int ho = 0; ho < h_out; ++ho) {
      for (int wo = 0; wo < w_out; ++wo) {
        float acc = 0.0f;
        // 2*block source time bins per output bin (pair-avg then ds halvings)
        for (int dt = 0; dt < 2 * block; ++dt) {
          long t_src = (long)to * 2 * block + dt;
          const float* frame = gray + (t_src * h) * (long)w;
          for (int dh = 0; dh < block; ++dh)
            for (int dw = 0; dw < block; ++dw)
              acc += frame[(long)(ho * block + dh) * w + (wo * block + dw)];
        }
        out[((long)to * h_out + ho) * w_out + wo] = acc * scale;
      }
    }
  }
  return 0;
}

int omp_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
