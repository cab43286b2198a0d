// Native P3 PPM encoder (C ABI, loaded via ctypes by utils/color.py).
//
// The port's own copy of the JAX package's native/ppm_io.cpp (its
// rtx_encode_ppm_p3). The reference streams its image to a P3 ASCII file
// one pixel per line (ColorUtility.hpp:30-37, header written at
// StaticCamera.cpp:57); this formats the byte image's body in one pass.
// The vectorised numpy encoder in utils/color.py is its plain version and
// writes the same bytes.
//
// Build: utils/color.py compiles this file at first use with g++ into
// build/ppm/ (git-ignored; utils/native.py).

#include <cstdint>

extern "C" {

// Encode (n_pixels, 3) uint8 RGB rows as "r g b\n" lines into `out`.
// Returns bytes written, or -1 if out_cap is too small.
int64_t rtx_encode_ppm_p3(const uint8_t* rgb, int64_t n_pixels, char* out,
                          int64_t out_cap) {
  // worst case per pixel: "255 255 255\n" = 12 bytes
  if (out_cap < n_pixels * 12) return -1;
  char* p = out;
  for (int64_t i = 0; i < n_pixels; ++i) {
    const uint8_t* px = rgb + i * 3;
    for (int c = 0; c < 3; ++c) {
      unsigned v = px[c];
      if (v >= 100) {
        *p++ = '0' + v / 100;
        *p++ = '0' + (v / 10) % 10;
        *p++ = '0' + v % 10;
      } else if (v >= 10) {
        *p++ = '0' + v / 10;
        *p++ = '0' + v % 10;
      } else {
        *p++ = '0' + v;
      }
      *p++ = (c == 2) ? '\n' : ' ';
    }
  }
  return p - out;
}

}  // extern "C"
