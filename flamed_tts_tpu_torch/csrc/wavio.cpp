// Host-side WAV codec of the PyTorch/CUDA port: a RIFF/WAVE parser, PCM
// and float decode with mono mixdown, and a 16-bit PCM encoder, over a C
// ABI loaded with ctypes (flamed_tts_tpu_torch/utils/native_audio.py).  The
// same code as the JAX package's native/wavio.cpp, kept here so the port
// builds its own copy.  It runs on the host, not on the card; scipy is the
// fallback where it cannot be built.
//
// Build (done at first use by native_audio.py, into build/native/):
//   g++ -O3 -fPIC -shared -Wall wavio.cpp -o libwavio.so

#include <cstdint>
#include <cstdio>
#include <cstring>
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

struct Fmt {
  uint16_t format = 0;       // 1 = PCM, 3 = IEEE float
  uint16_t channels = 0;
  uint32_t sample_rate = 0;
  uint16_t bits = 0;
};

}  // namespace

extern "C" {

// Decode a WAV byte buffer to mono float32 in [-1, 1].
//
// Returns the number of mono samples written (capped at out_capacity),
// or a negative error code: -1 malformed header, -2 unsupported format,
// -3 no data chunk.  sample_rate_out receives the file's rate.
long wavio_decode(const uint8_t* bytes, long n_bytes, float* out,
                  long out_capacity, int* sample_rate_out) {
  Reader r{bytes, static_cast<size_t>(n_bytes)};

  char tag[4];
  uint32_t riff_size;
  if (!r.read(tag, 4) || std::memcmp(tag, "RIFF", 4) != 0) return -1;
  if (!r.read(&riff_size, 4)) return -1;
  if (!r.read(tag, 4) || std::memcmp(tag, "WAVE", 4) != 0) return -1;

  Fmt fmt;
  const uint8_t* data = nullptr;
  uint32_t data_len = 0;

  while (r.off + 8 <= r.n) {
    uint32_t chunk_len;
    if (!r.read(tag, 4) || !r.read(&chunk_len, 4)) break;
    if (std::memcmp(tag, "fmt ", 4) == 0) {
      if (chunk_len < 16) return -1;
      size_t start = r.off;
      r.read(&fmt.format, 2);
      r.read(&fmt.channels, 2);
      r.read(&fmt.sample_rate, 4);
      r.skip(6);  // byte rate + block align
      r.read(&fmt.bits, 2);
      r.off = start + chunk_len + (chunk_len & 1);
    } else if (std::memcmp(tag, "data", 4) == 0) {
      if (r.off + chunk_len > r.n) chunk_len = static_cast<uint32_t>(r.n - r.off);
      data = bytes + r.off;
      data_len = chunk_len;
      r.skip(chunk_len + (chunk_len & 1));
    } else {
      if (!r.skip(chunk_len + (chunk_len & 1))) break;
    }
  }

  if (fmt.channels == 0 || fmt.sample_rate == 0) return -1;
  if (data == nullptr) return -3;
  if (sample_rate_out) *sample_rate_out = static_cast<int>(fmt.sample_rate);

  const int ch = fmt.channels;
  long frames = 0;
  const float inv_ch = 1.0f / static_cast<float>(ch);

  if (fmt.format == 1 && fmt.bits == 16) {
    const int16_t* s = reinterpret_cast<const int16_t*>(data);
    frames = data_len / (2 * ch);
    if (frames > out_capacity) frames = out_capacity;
    constexpr float kScale = 1.0f / 32768.0f;
    for (long i = 0; i < frames; ++i) {
      float acc = 0.0f;
      for (int c = 0; c < ch; ++c) acc += static_cast<float>(s[i * ch + c]);
      out[i] = acc * inv_ch * kScale;
    }
  } else if (fmt.format == 1 && fmt.bits == 32) {
    const int32_t* s = reinterpret_cast<const int32_t*>(data);
    frames = data_len / (4 * ch);
    if (frames > out_capacity) frames = out_capacity;
    constexpr double kScale = 1.0 / 2147483648.0;
    for (long i = 0; i < frames; ++i) {
      double acc = 0.0;
      for (int c = 0; c < ch; ++c) acc += static_cast<double>(s[i * ch + c]);
      out[i] = static_cast<float>(acc * inv_ch * kScale);
    }
  } else if (fmt.format == 1 && fmt.bits == 24) {
    frames = data_len / (3 * ch);
    if (frames > out_capacity) frames = out_capacity;
    constexpr float kScale = 1.0f / 8388608.0f;
    for (long i = 0; i < frames; ++i) {
      float acc = 0.0f;
      for (int c = 0; c < ch; ++c) {
        const uint8_t* b = data + (i * ch + c) * 3;
        int32_t v = (b[0] | (b[1] << 8) | (b[2] << 16));
        if (v & 0x800000) v |= ~0xFFFFFF;  // sign extend
        acc += static_cast<float>(v);
      }
      out[i] = acc * inv_ch * kScale;
    }
  } else if (fmt.format == 3 && fmt.bits == 32) {
    const float* s = reinterpret_cast<const float*>(data);
    frames = data_len / (4 * ch);
    if (frames > out_capacity) frames = out_capacity;
    for (long i = 0; i < frames; ++i) {
      float acc = 0.0f;
      for (int c = 0; c < ch; ++c) acc += s[i * ch + c];
      out[i] = acc * inv_ch;
    }
  } else {
    return -2;
  }
  return frames;
}

// Encode mono float32 [-1, 1] to 16-bit PCM WAV bytes.  Returns bytes
// written or -1 if the buffer is too small (need 44 + 2 * n_samples).
long wavio_encode(const float* samples, long n_samples, int sample_rate,
                  uint8_t* out, long out_capacity) {
  const long need = 44 + 2 * n_samples;
  if (out_capacity < need) return -1;

  const uint32_t data_len = static_cast<uint32_t>(2 * n_samples);
  const uint32_t riff_len = 36 + data_len;
  uint8_t* p = out;
  auto put = [&p](const void* src, size_t k) { std::memcpy(p, src, k); p += k; };
  auto put32 = [&put](uint32_t v) { put(&v, 4); };
  auto put16 = [&put](uint16_t v) { put(&v, 2); };

  put("RIFF", 4); put32(riff_len); put("WAVE", 4);
  put("fmt ", 4); put32(16); put16(1); put16(1);
  put32(static_cast<uint32_t>(sample_rate));
  put32(static_cast<uint32_t>(sample_rate * 2));
  put16(2); put16(16);
  put("data", 4); put32(data_len);

  int16_t* d = reinterpret_cast<int16_t*>(p);
  for (long i = 0; i < n_samples; ++i) {
    float v = samples[i];
    if (v > 1.0f) v = 1.0f;
    if (v < -1.0f) v = -1.0f;
    d[i] = static_cast<int16_t>(v * 32767.0f);
  }
  return need;
}

}  // extern "C"
