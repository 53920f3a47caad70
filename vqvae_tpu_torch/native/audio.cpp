// Native host-side audio decode for the PyTorch / CUDA port
// (vqvae_tpu_torch); the port's own copy of vqvae_tpu/native/audio.cpp,
// with the same C entry points and the same arithmetic, so the two
// packages decode a file to the same bits.
//
// RIFF/WAVE PCM parsing (8/16/24/32-bit int + 32/64-bit float), mono
// downmix in double, and mu-law companding for callers that want ids
// on the host.  The card does the signal math; this keeps the host side
// of the input pipeline native.
//
// Exposed as a plain C ABI consumed through ctypes
// (vqvae_tpu_torch/native/bindings.py): no pybind11, no PyTorch headers.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>

namespace {

struct Reader {
  const uint8_t* p;
  size_t n;
  size_t off = 0;
  bool read(void* dst, size_t k) {
    if (off + k > n) return false;
    std::memcpy(dst, p + off, k);
    off += k;
    return true;
  }
  bool skip(size_t k) {
    if (off + k > n) return false;
    off += k;
    return true;
  }
};

inline int32_t i24(const uint8_t* b) {
  int32_t v = (b[0]) | (b[1] << 8) | (b[2] << 16);
  if (v & 0x800000) v |= ~0xFFFFFF;  // sign-extend
  return v;
}

}  // namespace

extern "C" {

// Decode a wav file to mono float32 in [-1, 1].
// Returns 0 on success; *out is malloc'd (free with vqa_free).
int vqa_load_wav(const char* path, float** out, int64_t* n_samples,
                 int* sample_rate) {
  *out = nullptr;
  *n_samples = 0;
  *sample_rate = 0;

  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  std::fseek(f, 0, SEEK_END);
  long fsize = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (fsize < 44) { std::fclose(f); return 2; }
  std::vector<uint8_t> buf(static_cast<size_t>(fsize));
  if (std::fread(buf.data(), 1, buf.size(), f) != buf.size()) {
    std::fclose(f);
    return 3;
  }
  std::fclose(f);

  Reader r{buf.data(), buf.size()};
  char tag[4];
  uint32_t riff_size;
  if (!r.read(tag, 4) || std::memcmp(tag, "RIFF", 4)) return 4;
  if (!r.read(&riff_size, 4)) return 4;
  if (!r.read(tag, 4) || std::memcmp(tag, "WAVE", 4)) return 4;

  uint16_t fmt = 0, channels = 0, bits = 0;
  uint32_t sr = 0;
  const uint8_t* data = nullptr;
  uint32_t data_len = 0;

  while (r.off + 8 <= r.n) {
    uint32_t chunk_len;
    if (!r.read(tag, 4) || !r.read(&chunk_len, 4)) break;
    if (!std::memcmp(tag, "fmt ", 4)) {
      if (chunk_len < 16) return 5;
      size_t base = r.off;
      std::memcpy(&fmt, buf.data() + base, 2);
      std::memcpy(&channels, buf.data() + base + 2, 2);
      std::memcpy(&sr, buf.data() + base + 4, 4);
      std::memcpy(&bits, buf.data() + base + 14, 2);
      if (fmt == 0xFFFE && chunk_len >= 40) {  // WAVE_FORMAT_EXTENSIBLE
        uint16_t sub;
        std::memcpy(&sub, buf.data() + base + 24, 2);
        fmt = sub;
      }
      if (!r.skip(chunk_len + (chunk_len & 1))) break;
    } else if (!std::memcmp(tag, "data", 4)) {
      data = buf.data() + r.off;
      data_len = chunk_len;
      if (r.off + data_len > r.n) data_len = (uint32_t)(r.n - r.off);
      break;
    } else {
      if (!r.skip(chunk_len + (chunk_len & 1))) break;
    }
  }
  if (!data || !channels || !sr) return 6;

  const int bytes = bits / 8;
  if (bytes == 0) return 7;
  const int64_t frames = data_len / (bytes * channels);
  float* dst = static_cast<float*>(std::malloc(sizeof(float) * frames));
  if (!dst) return 8;
  const double inv_ch = 1.0 / channels;

  for (int64_t i = 0; i < frames; ++i) {
    double acc = 0.0;
    for (int c = 0; c < channels; ++c) {
      const uint8_t* s = data + (i * channels + c) * bytes;
      double v = 0.0;
      if (fmt == 1) {  // integer PCM
        switch (bits) {
          case 8:  v = (int(s[0]) - 128) / 128.0; break;
          case 16: { int16_t x; std::memcpy(&x, s, 2);
                     v = x / 32768.0; break; }
          case 24: v = i24(s) / 8388608.0; break;
          case 32: { int32_t x; std::memcpy(&x, s, 4);
                     v = x / 2147483648.0; break; }
          default: std::free(dst); return 9;
        }
      } else if (fmt == 3) {  // IEEE float
        if (bits == 32) { float x; std::memcpy(&x, s, 4); v = x; }
        else if (bits == 64) { double x; std::memcpy(&x, s, 8); v = x; }
        else { std::free(dst); return 9; }
      } else {
        std::free(dst);
        return 10;  // compressed formats unsupported
      }
      acc += v;
    }
    double m = acc * inv_ch;
    if (m > 1.0) m = 1.0;
    if (m < -1.0) m = -1.0;
    dst[i] = static_cast<float>(m);
  }

  *out = dst;
  *n_samples = frames;
  *sample_rate = static_cast<int>(sr);
  return 0;
}

void vqa_free(float* p) { std::free(p); }

// Host-side mu-law companding (matches audio/mu_law.py on the integer
// ids): float [-1,1] -> ids in [0, mu).
// mode 0 = "round" (TPU-native symmetric rounding, mu-1 constant),
// mode 1 = "chainer" (the reference's digitize-style binning:
// floor((y+1)*mu/2) with a mu companding constant — float32 math to
// mirror the jitted f32 path at bin edges).
void vqa_mulaw_encode_mode(const float* x, int64_t n, int mu, int mode,
                           int32_t* out) {
  if (mode == 1) {
    const float mf = static_cast<float>(mu);
    const float denom = std::log1p(mf);
    for (int64_t i = 0; i < n; ++i) {
      float v = x[i];
      if (v > 1.0f) v = 1.0f;
      if (v < -1.0f) v = -1.0f;
      float y = (v > 0 ? 1.0f : (v < 0 ? -1.0f : 0.0f)) *
                std::log1p(mf * std::fabs(v)) / denom;
      long id = static_cast<long>(std::floor((y + 1.0f) * (mf * 0.5f)));
      if (id < 0) id = 0;
      if (id > mu - 1) id = mu - 1;
      out[i] = static_cast<int32_t>(id);
    }
    return;
  }
  const double m = mu - 1;
  const double denom = std::log1p(m);
  for (int64_t i = 0; i < n; ++i) {
    double v = x[i];
    if (v > 1.0) v = 1.0;
    if (v < -1.0) v = -1.0;
    double y = (v > 0 ? 1.0 : (v < 0 ? -1.0 : 0.0)) *
               std::log1p(m * std::fabs(v)) / denom;
    long id = std::lround((y + 1.0) * 0.5 * m);
    if (id < 0) id = 0;
    if (id > (long)m) id = (long)m;
    out[i] = static_cast<int32_t>(id);
  }
}

void vqa_mulaw_encode(const float* x, int64_t n, int mu, int32_t* out) {
  vqa_mulaw_encode_mode(x, n, mu, /*mode=*/0, out);
}

}  // extern "C"
