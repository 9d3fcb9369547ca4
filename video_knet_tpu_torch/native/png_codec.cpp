// PNG scanline unfiltering for the port's PNG reader (png_codec.py).
//
// Python walks the chunks and inflates the IDAT stream with the standard
// library's zlib; this file undoes the per-scanline filters (None, Sub, Up,
// Average, Paeth), which run byte by byte along a row and are slow in
// Python. It needs no zlib header and no library: build with
// `g++ -O3 -shared -fPIC` (build.py). A ctypes call releases the GIL, so the
// loader's threads unfilter in parallel.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

inline int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

}  // namespace

extern "C" {

// raw: `height` rows of one filter byte and `stride` filtered bytes each;
// out: height * stride bytes; bpp: bytes a pixel (at least 1). Returns 0, or
// 1 for a size mismatch, 2 for an unknown filter type.
int vk_png_unfilter(const uint8_t* raw, int64_t raw_len, uint8_t* out, int64_t height,
                    int64_t stride, int64_t bpp) {
  if (height < 0 || stride < 0 || bpp < 1 || raw_len != (stride + 1) * height) return 1;
  std::vector<uint8_t> zero(size_t(stride), 0);
  const uint8_t* prev = zero.data();
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* src = raw + y * (stride + 1);
    const uint8_t filter = *src++;
    uint8_t* dst = out + y * stride;
    switch (filter) {
      case 0:
        memcpy(dst, src, size_t(stride));
        break;
      case 1:
        for (int64_t i = 0; i < stride; ++i)
          dst[i] = uint8_t(src[i] + (i >= bpp ? dst[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < stride; ++i) dst[i] = uint8_t(src[i] + prev[i]);
        break;
      case 3:
        for (int64_t i = 0; i < stride; ++i) {
          int left = i >= bpp ? dst[i - bpp] : 0;
          dst[i] = uint8_t(src[i] + ((left + prev[i]) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < stride; ++i) {
          int a = i >= bpp ? dst[i - bpp] : 0;
          int b = prev[i];
          int c = i >= bpp ? prev[i - bpp] : 0;
          dst[i] = uint8_t(src[i] + paeth(a, b, c));
        }
        break;
      default:
        return 2;
    }
    prev = dst;
  }
  return 0;
}

}  // extern "C"
