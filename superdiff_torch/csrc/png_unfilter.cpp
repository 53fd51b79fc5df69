// PNG row unfiltering for the host image decoder
// (superdiff_torch/data/image_io.py), whose numpy version is the plain
// version of this file.
//
// A PNG image's decompressed stream is `height` rows of one filter-type
// byte followed by `rowbytes` filtered bytes. Each row is reconstructed from
// its filtered bytes, the reconstructed byte `bpp` to the left (a), the
// reconstructed byte above (b) and the one above-left (c), all 0 outside
// the image (PNG specification, section 9.2):
//   0 None x = f;  1 Sub x = f + a;  2 Up x = f + b;
//   3 Average x = f + floor((a + b) / 2);  4 Paeth x = f + paeth(a, b, c),
// modulo 256. Average and Paeth are sequential along a row, which is why
// this is native code.
//
// C API (ctypes):
//   int superdiff_png_unfilter(const uint8_t* in, uint8_t* out,
//                              int64_t height, int64_t rowbytes, int bpp)
//     in: height * (rowbytes + 1) bytes; out: height * rowbytes bytes.
//     Returns 0, or 1 + the index of the first row with an unknown filter.
//
// Build: g++ -O2 -fPIC -std=c++17 -pthread -shared (superdiff_torch/ops/
// _build.py::build_host, into build/superdiff_torch/).

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

}  // namespace

extern "C" int superdiff_png_unfilter(const uint8_t* in, uint8_t* out,
                                      int64_t height, int64_t rowbytes,
                                      int bpp) {
  const uint8_t* prev = nullptr;
  for (int64_t r = 0; r < height; ++r) {
    const uint8_t* f = in + r * (rowbytes + 1);
    const uint8_t kind = *f++;
    uint8_t* x = out + r * rowbytes;
    switch (kind) {
      case 0:
        std::memcpy(x, f, rowbytes);
        break;
      case 1:
        for (int64_t i = 0; i < rowbytes; ++i)
          x[i] = static_cast<uint8_t>(f[i] + (i >= bpp ? x[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < rowbytes; ++i)
          x[i] = static_cast<uint8_t>(f[i] + (prev ? prev[i] : 0));
        break;
      case 3:
        for (int64_t i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? x[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          x[i] = static_cast<uint8_t>(f[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? x[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          x[i] = static_cast<uint8_t>(f[i] + paeth(a, b, c));
        }
        break;
      default:
        return static_cast<int>(r + 1);
    }
    prev = x;
  }
  return 0;
}
