// Native I/O codec for giga-voxel field output.
//
// The reference's output path is native C++ throughout (MPIIO.cc's
// collective MPI-IO writes); here the device does the compute and the host
// writes .vtu/.dat, whose cost at 512^3 is dominated by base64 encoding
// (~1.6 GB of Float32 per state field dump) and f64->f32 conversion.
// This translation unit provides those hot loops natively; Python loads
// it via ctypes (topopt_in_petsc_tpu.io.native) and falls back to numpy/
// stdlib implementations when the shared object is unavailable.
//
// Build: g++ -O3 -march=native -shared -fPIC vtu_codec.cpp -o vtu_codec.so

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

const char B64[] =
    "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/";

}  // namespace

extern "C" {

// Standard base64 encode; dst must hold 4 * ((n + 2) / 3) bytes.
// Returns the number of bytes written.
size_t b64_encode(const uint8_t* src, size_t n, uint8_t* dst) {
  size_t di = 0;
  size_t i = 0;
  // main loop: unrolled 3-byte groups
  for (; i + 2 < n; i += 3) {
    uint32_t v = (uint32_t(src[i]) << 16) | (uint32_t(src[i + 1]) << 8) |
                 uint32_t(src[i + 2]);
    dst[di++] = B64[(v >> 18) & 0x3F];
    dst[di++] = B64[(v >> 12) & 0x3F];
    dst[di++] = B64[(v >> 6) & 0x3F];
    dst[di++] = B64[v & 0x3F];
  }
  if (i < n) {
    uint32_t v = uint32_t(src[i]) << 16;
    if (i + 1 < n) v |= uint32_t(src[i + 1]) << 8;
    dst[di++] = B64[(v >> 18) & 0x3F];
    dst[di++] = B64[(v >> 12) & 0x3F];
    dst[di++] = (i + 1 < n) ? B64[(v >> 6) & 0x3F] : '=';
    dst[di++] = '=';
  }
  return di;
}

// f64 -> f32 narrowing (restart/field dumps when solver runs f64).
void f64_to_f32(const double* src, size_t n, float* dst) {
  for (size_t i = 0; i < n; ++i) dst[i] = static_cast<float>(src[i]);
}

// Fletcher-64 style checksum for checkpoint integrity verification
// (the reference relies on the A/B flip alone; we add content checks).
uint64_t checksum64(const uint8_t* src, size_t n) {
  uint64_t a = 1, b = 0;
  const uint64_t MOD = 0xFFFFFFFFULL;
  for (size_t i = 0; i < n; ++i) {
    a = (a + src[i]) % MOD;
    b = (b + a) % MOD;
  }
  return (b << 32) | a;
}

}  // extern "C"
