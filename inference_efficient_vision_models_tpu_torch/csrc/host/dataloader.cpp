// Host image decode and space-to-depth for the PyTorch port: a copy of the
// JAX package's native/dataloader.cpp with one entry added,
// ievm_decode_mem, which decodes an encoded image already in memory (an
// HTTP request body) without a temporary file.
//
// A BMP decoder (NEU-DET ships 200x200 BMPs: 8-bit paletted or 24-bit BGR),
// a bilinear resizer to the model's input size, a std::thread pool that
// decodes a whole file list into one resident uint8 NHWC buffer, and the
// batch space-to-depth(2) of the serving host preprocess. Python binds it
// with ctypes (inference_efficient_vision_models_tpu_torch/data/native_loader.py),
// which builds it at first use:
//
//   g++ -O3 -march=native -shared -fPIC -std=c++17 -o libievmloader.so dataloader.cpp -lpthread

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Image {
  int w = 0, h = 0;
  std::vector<uint8_t> rgb;  // H*W*3, row-major, top-down
};

uint16_t rd16(const uint8_t* p) { return p[0] | (p[1] << 8); }
uint32_t rd32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (uint32_t(p[3]) << 24);
}

// Minimal BMP decoder: BITMAPINFOHEADER, bpp 8 (palette) / 24 / 32,
// uncompressed, top-down or bottom-up.
bool decode_bmp(const uint8_t* buf, size_t len, Image& out) {
  if (len < 54 || buf[0] != 'B' || buf[1] != 'M') return false;
  uint32_t data_off = rd32(buf + 10);
  uint32_t hdr_size = rd32(buf + 14);
  if (hdr_size < 40) return false;
  int32_t w = (int32_t)rd32(buf + 18);
  int32_t h = (int32_t)rd32(buf + 22);
  uint16_t bpp = rd16(buf + 28);
  uint32_t compression = rd32(buf + 30);
  if (compression != 0 || w <= 0 || w > 1 << 15) return false;
  bool bottom_up = h > 0;
  int32_t ah = bottom_up ? h : -h;
  if (ah <= 0 || ah > 1 << 15) return false;

  const uint8_t* palette = buf + 14 + hdr_size;
  uint32_t palette_len = (bpp == 8) ? rd32(buf + 46) : 0;
  if (bpp == 8 && palette_len == 0) palette_len = 256;
  // The palette table must fit inside the buffer AND precede the pixel data;
  // a malformed/truncated 8-bpp file must not cause out-of-bounds reads.
  if (bpp == 8) {
    uint64_t palette_end = 14ull + hdr_size + (uint64_t)palette_len * 4;
    if (palette_len > 256 || palette_end > len || palette_end > data_off)
      return false;
  }

  size_t row_bytes = ((size_t)w * bpp / 8 + 3) & ~size_t(3);
  if (data_off + row_bytes * ah > len) return false;

  out.w = w;
  out.h = ah;
  out.rgb.resize((size_t)w * ah * 3);
  for (int32_t y = 0; y < ah; y++) {
    const uint8_t* row = buf + data_off + row_bytes * (bottom_up ? ah - 1 - y : y);
    uint8_t* dst = out.rgb.data() + (size_t)y * w * 3;
    if (bpp == 8) {
      for (int32_t x = 0; x < w; x++) {
        uint32_t idx = row[x];
        if (idx >= palette_len) idx = palette_len ? palette_len - 1 : 0;
        const uint8_t* c = palette + idx * 4;  // BGRA entries
        dst[x * 3 + 0] = c[2];
        dst[x * 3 + 1] = c[1];
        dst[x * 3 + 2] = c[0];
      }
    } else if (bpp == 24 || bpp == 32) {
      int step = bpp / 8;
      for (int32_t x = 0; x < w; x++) {
        dst[x * 3 + 0] = row[x * step + 2];  // BGR(A) -> RGB
        dst[x * 3 + 1] = row[x * step + 1];
        dst[x * 3 + 2] = row[x * step + 0];
      }
    } else {
      return false;
    }
  }
  return true;
}

// Bilinear resize (align-corners=false, the standard image convention).
void resize_bilinear(const Image& src, int ow, int oh, uint8_t* dst) {
  const float sx = (float)src.w / ow;
  const float sy = (float)src.h / oh;
  for (int y = 0; y < oh; y++) {
    float fy = (y + 0.5f) * sy - 0.5f;
    if (fy < 0) fy = 0;
    int y0 = (int)fy;
    int y1 = y0 + 1 < src.h ? y0 + 1 : src.h - 1;
    float wy = fy - y0;
    for (int x = 0; x < ow; x++) {
      float fx = (x + 0.5f) * sx - 0.5f;
      if (fx < 0) fx = 0;
      int x0 = (int)fx;
      int x1 = x0 + 1 < src.w ? x0 + 1 : src.w - 1;
      float wx = fx - x0;
      const uint8_t* p00 = &src.rgb[((size_t)y0 * src.w + x0) * 3];
      const uint8_t* p01 = &src.rgb[((size_t)y0 * src.w + x1) * 3];
      const uint8_t* p10 = &src.rgb[((size_t)y1 * src.w + x0) * 3];
      const uint8_t* p11 = &src.rgb[((size_t)y1 * src.w + x1) * 3];
      uint8_t* d = dst + ((size_t)y * ow + x) * 3;
      for (int c = 0; c < 3; c++) {
        float top = p00[c] + (p01[c] - p00[c]) * wx;
        float bot = p10[c] + (p11[c] - p10[c]) * wx;
        float v = top + (bot - top) * wy;
        d[c] = (uint8_t)(v + 0.5f);
      }
    }
  }
}

// Space-to-depth(2) repack: (oh, ow, 3) → (oh/2, ow/2, 12), channel order
// ((sy*2+sx)*3 + c) — the TPU-friendly stem input layout (see
// inference_efficient_vision_models_tpu_torch/ops/space_to_depth.py).
void s2d_repack(const uint8_t* src, int ow, int oh, uint8_t* dst) {
  const int hw = ow / 2, hh = oh / 2;
  for (int y = 0; y < hh; y++) {
    for (int x = 0; x < hw; x++) {
      uint8_t* d = dst + ((size_t)y * hw + x) * 12;
      for (int sy = 0; sy < 2; sy++) {
        const uint8_t* s = src + (((size_t)(2 * y + sy) * ow) + 2 * x) * 3;
        for (int sx = 0; sx < 2; sx++) {
          const int ch = (sy * 2 + sx) * 3;
          d[ch + 0] = s[sx * 3 + 0];
          d[ch + 1] = s[sx * 3 + 1];
          d[ch + 2] = s[sx * 3 + 2];
        }
      }
    }
  }
}

bool decode_to(const uint8_t* buf, size_t len, int ow, int oh, int s2d, uint8_t* dst) {
  Image img;
  if (!decode_bmp(buf, len, img)) return false;
  std::vector<uint8_t> tmp;
  uint8_t* rgb_dst = dst;
  if (s2d) {
    tmp.resize((size_t)ow * oh * 3);
    rgb_dst = tmp.data();
  }
  if (img.w == ow && img.h == oh) {
    memcpy(rgb_dst, img.rgb.data(), (size_t)ow * oh * 3);
  } else {
    resize_bilinear(img, ow, oh, rgb_dst);
  }
  if (s2d) s2d_repack(rgb_dst, ow, oh, dst);
  return true;
}

bool load_one(const char* path, int ow, int oh, int s2d, uint8_t* dst) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long len = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(len > 0 ? (size_t)len : 0);
  size_t got = len > 0 ? fread(buf.data(), 1, (size_t)len, f) : 0;
  fclose(f);
  if ((long)got != len) return false;
  return decode_to(buf.data(), buf.size(), ow, oh, s2d, dst);
}

}  // namespace

extern "C" {

// Decode + resize a batch of files into out (uint8, NHWC). With s2d != 0 the
// output layout per image is (oh/2, ow/2, 12) (space-to-depth, see above);
// otherwise (oh, ow, 3). paths: array of n C strings. status[i] = 1 on
// success, 0 on failure (the caller decodes those files another way). Returns #successes.
int ievm_decode_batch(const char** paths, int n, int ow, int oh, int s2d,
                      uint8_t* out, uint8_t* status, int num_threads) {
  if (num_threads < 1) num_threads = 1;
  std::atomic<int> next(0), ok(0);
  const size_t stride = (size_t)ow * oh * 3;  // same byte count either layout
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      bool good = load_one(paths[i], ow, oh, s2d, out + (size_t)i * stride);
      status[i] = good ? 1 : 0;
      if (good) ok.fetch_add(1);
    }
  };
  std::vector<std::thread> threads;
  int nt = num_threads < n ? num_threads : (n > 0 ? n : 1);
  for (int t = 0; t < nt; t++) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return ok.load();
}

// One encoded image in memory (len bytes at buf) -> out (oh, ow, 3) uint8,
// resized as the batch decoder resizes. Returns 1 on success, 0 when the
// bytes are not a BMP this decoder reads.
int ievm_decode_mem(const uint8_t* buf, long len, int ow, int oh, uint8_t* out) {
  if (len <= 0) return 0;
  return decode_to(buf, (size_t)len, ow, oh, 0, out) ? 1 : 0;
}

// Batch space-to-depth(2) on an in-memory uint8 NHWC array:
// (n, h, w, 3) → (n, h/2, w/2, 12), channel order ((sy*2+sx)*3 + c).
// The serving runtime's host preprocess: numpy's strided transpose runs at
// ~0.6 GB/s single-thread (65 ms per 256×224×224×3 batch — 10× the device
// forward), while this row-interleave is a straight-line 12-bytes-per-step
// copy loop that vectorizes, plus a std::thread fan-out over images for
// multi-core serving hosts. Each output row is the 6-byte-chunk interleave
// of two source rows: dst[j] = r0[6j..6j+6] ++ r1[6j..6j+6].
int ievm_s2d_batch(const uint8_t* src, int n, int h, int w, uint8_t* dst,
                   int num_threads) {
  if (h % 2 || w % 2) return 0;
  const size_t srow = (size_t)w * 3;
  const size_t in_stride = (size_t)h * srow;
  const int hw = w / 2, hh = h / 2;
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      const uint8_t* s = src + (size_t)i * in_stride;
      uint8_t* d = dst + (size_t)i * in_stride;  // same byte count
      for (int y = 0; y < hh; y++) {
        const uint8_t* r0 = s + (size_t)(2 * y) * srow;
        const uint8_t* r1 = r0 + srow;
        // Overlapping 8-byte copies: each stores 2 stray bytes past its
        // 6-byte chunk that the NEXT store (or the tail memcpy) overwrites.
        // The tail pixel uses exact-width copies so no write ever crosses
        // this image's output region (images are parceled across threads).
        uint64_t a, b;
        for (int x = 0; x < hw - 1; x++) {
          memcpy(&a, r0 + (size_t)x * 6, 8);
          memcpy(&b, r1 + (size_t)x * 6, 8);
          memcpy(d, &a, 8);
          memcpy(d + 6, &b, 8);
          d += 12;
        }
        memcpy(d, r0 + (size_t)(hw - 1) * 6, 6);
        memcpy(d + 6, r1 + (size_t)(hw - 1) * 6, 6);
        d += 12;
      }
    }
  };
  if (num_threads < 1) num_threads = 1;
  int nt = num_threads < n ? num_threads : (n > 0 ? n : 1);
  if (nt == 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    for (int t = 0; t < nt; t++) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
  }
  return n;
}
}
