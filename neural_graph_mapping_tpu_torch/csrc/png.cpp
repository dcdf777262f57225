// PNG scanline unfiltering, bound with ctypes by utils/imageio.py.
//
// Undoes the five filter types of PNG's filter method 0 (None, Sub, Up,
// Average, Paeth) row by row in scanline order, as the PNG specification
// (section 9) and libpng do. Byte arithmetic is mod 256; "up" and "up-left"
// are zero on the first row, "left" and "up-left" zero for the first bpp
// bytes of a row. The caller inflates the data and checks its size; this
// file holds no state and touches no Python object, so ctypes runs it with
// the GIL released.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  return static_cast<uint8_t>(pb <= pc ? b : c);
}

}  // namespace

extern "C" {

// raw: height rows of (1 + width * bpp) bytes, each a filter type byte and
// the filtered row; out: height * width * bpp bytes. 0 on success, else 1
// with a message in err (a filter type above 4 names its row and type).
int ngm_png_unfilter(const uint8_t* raw, int height, int width, int bpp, uint8_t* out, char* err,
                     int err_len) {
  const size_t stride = static_cast<size_t>(width) * bpp;
  const size_t n = stride < static_cast<size_t>(bpp) ? stride : static_cast<size_t>(bpp);
  const uint8_t* prev = nullptr;  // the row above; none on the first row
  for (int r = 0; r < height; ++r) {
    const uint8_t* in = raw + static_cast<size_t>(r) * (stride + 1) + 1;
    const int type = in[-1];
    uint8_t* cur = out + static_cast<size_t>(r) * stride;
    // on the first row, Up is None, Average halves the left byte and Paeth
    // is Sub (the predictor of (a, 0, 0) is a)
    switch (type) {
      case 0:
        std::memcpy(cur, in, stride);
        break;
      case 2:
        if (prev == nullptr) {
          std::memcpy(cur, in, stride);
        } else {
          for (size_t i = 0; i < stride; ++i) cur[i] = in[i] + prev[i];
        }
        break;
      case 3:
        if (prev == nullptr) {
          for (size_t i = 0; i < n; ++i) cur[i] = in[i];
          for (size_t i = n; i < stride; ++i) cur[i] = in[i] + (cur[i - n] >> 1);
        } else {
          for (size_t i = 0; i < n; ++i) cur[i] = in[i] + (prev[i] >> 1);
          for (size_t i = n; i < stride; ++i) cur[i] = in[i] + ((cur[i - n] + prev[i]) >> 1);
        }
        break;
      case 1:
      case 4:
        if (type == 1 || prev == nullptr) {
          for (size_t i = 0; i < n; ++i) cur[i] = in[i];
          for (size_t i = n; i < stride; ++i) cur[i] = in[i] + cur[i - n];
        } else {
          // the predictor of (0, b, 0) is b
          for (size_t i = 0; i < n; ++i) cur[i] = in[i] + prev[i];
          for (size_t i = n; i < stride; ++i) cur[i] = in[i] + paeth(cur[i - n], prev[i], prev[i - n]);
        }
        break;
      default:
        std::snprintf(err, static_cast<size_t>(err_len), "unknown PNG filter type %d in row %d", type, r);
        return 1;
    }
    prev = cur;
  }
  return 0;
}

}  // extern "C"
