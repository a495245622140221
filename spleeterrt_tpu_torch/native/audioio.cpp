// Native host-side audio runtime for spleeterrt_tpu_torch.
//
// The reference's C runtime pieces that live outside the accelerator
// compute path: audio file codec (reference vendors
// dr_wav, Executable/main.c:230-276,812-843), interleave/deinterleave
// (channel_splitFloat/channel_joinFloat, Executable/main.c:53-76) and the
// polyphase windowed-sinc resampler (Executable/libsamplerate/). Written
// from scratch in C++17 with a flat C ABI consumed via ctypes
// (spleeterrt_tpu_torch/native/__init__.py). No tensor types cross this
// boundary -- only float32 buffers. A copy of the reference package's
// spleeterrt_tpu/native/audioio.cpp, symbol for symbol.
//
// Build: lazily compiled by spleeterrt_tpu_torch/native/__init__.py
// (g++ -O3 -shared -fPIC) into build/native/, with a pure-Python fallback
// when there is no toolchain.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr uint16_t kFmtPcm = 0x0001;
constexpr uint16_t kFmtFloat = 0x0003;
constexpr uint16_t kFmtExtensible = 0xFFFE;

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

template <typename T>
T le(const uint8_t* p) {
  T v;
  std::memcpy(&v, p, sizeof(T));
  return v;  // build targets are little-endian
}

}  // namespace

extern "C" {

// Parse WAV header from a memory buffer. Returns 0 on success and fills
// channels/sample_rate/bits/format_tag/num_frames/data_offset.
int srt_wav_info(const uint8_t* buf, uint64_t len, int32_t* channels,
                 int32_t* sample_rate, int32_t* bits, int32_t* format_tag,
                 uint64_t* num_frames, uint64_t* data_offset,
                 uint64_t* data_len) {
  Reader r{buf, static_cast<size_t>(len)};
  uint8_t hdr[12];
  if (!r.read(hdr, 12)) return -1;
  if (std::memcmp(hdr, "RIFF", 4) != 0 || std::memcmp(hdr + 8, "WAVE", 4) != 0)
    return -2;
  bool have_fmt = false;
  uint16_t tag = 0, ch = 0, bps = 0;
  uint32_t rate = 0;
  while (r.off + 8 <= r.n) {
    uint8_t chdr[8];
    r.read(chdr, 8);
    uint32_t csize = le<uint32_t>(chdr + 4);
    if (std::memcmp(chdr, "fmt ", 4) == 0) {
      std::vector<uint8_t> fmt(csize);
      if (!r.read(fmt.data(), csize)) return -3;
      tag = le<uint16_t>(fmt.data());
      ch = le<uint16_t>(fmt.data() + 2);
      rate = le<uint32_t>(fmt.data() + 4);
      bps = le<uint16_t>(fmt.data() + 14);
      if (tag == kFmtExtensible && csize >= 26)
        tag = le<uint16_t>(fmt.data() + 24);
      have_fmt = true;
    } else if (std::memcmp(chdr, "data", 4) == 0) {
      if (!have_fmt || ch == 0 || bps == 0) return -4;
      uint64_t dlen = csize;
      if (r.off + dlen > r.n) dlen = r.n - r.off;  // tolerate short files
      *channels = ch;
      *sample_rate = static_cast<int32_t>(rate);
      *bits = bps;
      *format_tag = tag;
      *data_offset = r.off;
      *data_len = dlen;
      *num_frames = dlen / (static_cast<uint64_t>(ch) * (bps / 8));
      return 0;
    } else {
      if (!r.skip(csize)) return -5;
    }
    if (csize % 2) r.skip(1);
  }
  return -6;
}

// Decode interleaved PCM payload -> planar float32 (channels x frames).
int srt_wav_decode(const uint8_t* data, uint64_t data_len, int32_t channels,
                   int32_t bits, int32_t format_tag, float* out_planar,
                   uint64_t num_frames) {
  const uint64_t total = num_frames * channels;
  if (format_tag == kFmtFloat && bits == 32) {
    const float* src = reinterpret_cast<const float*>(data);
    for (uint64_t i = 0; i < total; ++i)
      out_planar[(i % channels) * num_frames + i / channels] = src[i];
    return 0;
  }
  if (format_tag == kFmtFloat && bits == 64) {
    const double* src = reinterpret_cast<const double*>(data);
    for (uint64_t i = 0; i < total; ++i)
      out_planar[(i % channels) * num_frames + i / channels] =
          static_cast<float>(src[i]);
    return 0;
  }
  if (format_tag != kFmtPcm) return -1;
  switch (bits) {
    case 16: {
      const int16_t* src = reinterpret_cast<const int16_t*>(data);
      constexpr float k = 1.0f / 32768.0f;
      for (uint64_t i = 0; i < total; ++i)
        out_planar[(i % channels) * num_frames + i / channels] = src[i] * k;
      return 0;
    }
    case 32: {
      const int32_t* src = reinterpret_cast<const int32_t*>(data);
      constexpr float k = 1.0f / 2147483648.0f;
      for (uint64_t i = 0; i < total; ++i)
        out_planar[(i % channels) * num_frames + i / channels] = src[i] * k;
      return 0;
    }
    case 24: {
      constexpr float k = 1.0f / 8388608.0f;
      for (uint64_t i = 0; i < total; ++i) {
        const uint8_t* s = data + 3 * i;
        int32_t v = (s[0] | (s[1] << 8) | (s[2] << 16));
        v = (v << 8) >> 8;  // sign extend
        out_planar[(i % channels) * num_frames + i / channels] = v * k;
      }
      return 0;
    }
    case 8: {
      constexpr float k = 1.0f / 128.0f;
      for (uint64_t i = 0; i < total; ++i)
        out_planar[(i % channels) * num_frames + i / channels] =
            (static_cast<int32_t>(data[i]) - 128) * k;
      return 0;
    }
  }
  return -2;
}

// Encode planar float32 -> interleaved payload (float32 or pcm16).
int srt_wav_encode(const float* planar, int32_t channels, uint64_t num_frames,
                   int32_t as_pcm16, uint8_t* out) {
  const uint64_t total = num_frames * channels;
  if (!as_pcm16) {
    float* dst = reinterpret_cast<float*>(out);
    for (uint64_t i = 0; i < total; ++i)
      dst[i] = planar[(i % channels) * num_frames + i / channels];
    return 0;
  }
  int16_t* dst = reinterpret_cast<int16_t*>(out);
  for (uint64_t i = 0; i < total; ++i) {
    float v = planar[(i % channels) * num_frames + i / channels] * 32768.0f;
    if (v > 32767.0f) v = 32767.0f;
    if (v < -32768.0f) v = -32768.0f;
    dst[i] = static_cast<int16_t>(std::lrintf(v));
  }
  return 0;
}

// Polyphase rational resampler: y[m] = sum_j h[phase_m + j*p] x[idx_m - j].
// h has sum == p (unity passband gain); matches io/resample.py exactly.
int srt_resample(const float* x, uint64_t n_in, int32_t batch,
                 const double* h, int32_t h_len, int32_t p, int32_t q,
                 float* y, uint64_t n_out) {
  const int32_t half = (h_len - 1) / 2;
  const int32_t taps_per_phase = (h_len + p - 1) / p;
  for (int32_t b = 0; b < batch; ++b) {
    const float* xb = x + b * n_in;
    float* yb = y + b * n_out;
    for (uint64_t m = 0; m < n_out; ++m) {
      const uint64_t up = m * q + half;
      const int32_t phase = static_cast<int32_t>(up % p);
      int64_t base = static_cast<int64_t>(up / p);
      double acc = 0.0;
      for (int32_t j = 0; j < taps_per_phase; ++j) {
        const int64_t xi = base - j;
        const int32_t hi = phase + j * p;
        if (xi < 0 || xi >= static_cast<int64_t>(n_in) || hi >= h_len) continue;
        acc += h[hi] * xb[xi];
      }
      yb[m] = static_cast<float>(acc);
    }
  }
  return 0;
}

// channel_splitFloat equivalent (Executable/main.c:71-76): interleaved ->
// planar with a leading preshift of zeros per channel.
void srt_split_channels(const float* interleaved, int32_t channels,
                        uint64_t num_frames, uint64_t preshift,
                        uint64_t out_len, float* out_planar) {
  for (int32_t c = 0; c < channels; ++c) {
    float* dst = out_planar + c * out_len;
    std::memset(dst, 0, out_len * sizeof(float));
    const uint64_t take =
        num_frames < out_len - preshift ? num_frames : out_len - preshift;
    for (uint64_t i = 0; i < take; ++i)
      dst[preshift + i] = interleaved[i * channels + c];
  }
}

// channel_joinFloat equivalent (Executable/main.c:53-58).
void srt_join_channels(const float* planar, int32_t channels,
                       uint64_t plane_len, uint64_t preshift,
                       uint64_t num_frames, float* interleaved) {
  for (uint64_t i = 0; i < num_frames; ++i)
    for (int32_t c = 0; c < channels; ++c)
      interleaved[i * channels + c] =
          (preshift + i < plane_len) ? planar[c * plane_len + preshift + i]
                                     : 0.0f;
}

const char* srt_version() { return "spleeterrt-tpu-native 0.1.0"; }

}  // extern "C"
