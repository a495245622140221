// Native FLAC decoder: C++17 port of spleeterrt_tpu_torch/io/flac.py (a copy
// of the reference package's spleeterrt_tpu/native/flacdec.cpp).
//
// Same spec subset (STREAMINFO, CONSTANT/VERBATIM/FIXED/LPC subframes,
// 4/5-bit Rice partitions with escapes, wasted bits, L/S R/S M/S stereo),
// parity-tested against the Python decoder. Decodes into int32 planar PCM;
// scaling to float happens on the Python side.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct BitReader {
  const uint8_t* data;
  uint64_t nbits;
  uint64_t pos = 0;
  bool ok = true;

  uint32_t read(int n) {
    if (pos + n > nbits) {
      ok = false;
      return 0;
    }
    uint32_t v = 0;
    for (int i = 0; i < n; ++i) {
      v = (v << 1) | ((data[(pos + i) >> 3] >> (7 - ((pos + i) & 7))) & 1);
    }
    pos += n;
    return v;
  }

  int64_t read_signed(int n) {
    int64_t v = read(n);
    if (v >= (int64_t(1) << (n - 1))) v -= int64_t(1) << n;
    return v;
  }

  uint32_t read_unary() {
    uint32_t q = 0;
    while (pos < nbits &&
           !((data[pos >> 3] >> (7 - (pos & 7))) & 1)) {
      ++pos;
      ++q;
    }
    if (pos >= nbits) {
      ok = false;
      return 0;
    }
    ++pos;
    return q;
  }

  uint64_t read_utf8() {
    uint32_t first = read(8);
    if (first < 0x80) return first;
    int extra = 0;
    uint32_t mask = 0x40;
    while (first & mask) {
      ++extra;
      mask >>= 1;
    }
    uint64_t val = first & (mask - 1);
    for (int i = 0; i < extra; ++i) val = (val << 6) | (read(8) & 0x3F);
    return val;
  }

  void align() { pos = (pos + 7) / 8 * 8; }
};

const int kFixedCoeffs[5][4] = {
    {}, {1}, {2, -1}, {3, -3, 1}, {4, -6, 4, -1}};

bool decode_residual(BitReader& br, int block_size, int order,
                     std::vector<int64_t>& res) {
  int method = br.read(2);
  if (method > 1) return false;
  int k_bits = method == 0 ? 4 : 5;
  uint32_t escape = (1u << k_bits) - 1;
  int part_order = br.read(4);
  int n_parts = 1 << part_order;
  int part_len = block_size >> part_order;
  res.resize(block_size - order);
  int pos = 0;
  for (int p = 0; p < n_parts; ++p) {
    int count = part_len - (p == 0 ? order : 0);
    uint32_t k = br.read(k_bits);
    if (k == escape) {
      int raw = br.read(5);
      for (int i = 0; i < count; ++i)
        res[pos++] = raw ? br.read_signed(raw) : 0;
    } else {
      for (int i = 0; i < count; ++i) {
        uint64_t q = br.read_unary();
        uint64_t u = (q << k) | (k ? br.read(k) : 0);
        res[pos++] = (int64_t)(u >> 1) ^ -(int64_t)(u & 1);
      }
    }
    if (!br.ok) return false;
  }
  return true;
}

bool decode_subframe(BitReader& br, int block_size, int bps,
                     std::vector<int64_t>& out) {
  if (br.read(1)) return false;
  int type = br.read(6);
  int wasted = 0;
  if (br.read(1)) wasted = br.read_unary() + 1;
  bps -= wasted;
  out.resize(block_size);

  if (type == 0) {
    int64_t v = br.read_signed(bps);
    for (int i = 0; i < block_size; ++i) out[i] = v;
  } else if (type == 1) {
    for (int i = 0; i < block_size; ++i) out[i] = br.read_signed(bps);
  } else if (type >= 8 && type <= 12) {
    int order = type - 8;
    for (int i = 0; i < order; ++i) out[i] = br.read_signed(bps);
    std::vector<int64_t> res;
    if (!decode_residual(br, block_size, order, res)) return false;
    for (int i = order; i < block_size; ++i) {
      int64_t pred = 0;
      for (int j = 0; j < order; ++j)
        pred += (int64_t)kFixedCoeffs[order][j] * out[i - 1 - j];
      out[i] = res[i - order] + pred;
    }
  } else if (type >= 32) {
    int order = (type & 0x1F) + 1;
    for (int i = 0; i < order; ++i) out[i] = br.read_signed(bps);
    int precision = br.read(4) + 1;
    if (precision == 16) return false;
    int shift = (int)br.read_signed(5);
    std::vector<int64_t> coef(order);
    for (int i = 0; i < order; ++i) coef[i] = br.read_signed(precision);
    std::vector<int64_t> res;
    if (!decode_residual(br, block_size, order, res)) return false;
    for (int i = order; i < block_size; ++i) {
      int64_t pred = 0;
      for (int j = 0; j < order; ++j) pred += coef[j] * out[i - 1 - j];
      out[i] = res[i - order] + (pred >> shift);
    }
  } else {
    return false;
  }
  if (wasted)
    for (auto& v : out) v <<= wasted;
  return br.ok;
}

const int kBlockSizes[16] = {0, 192, 576, 1152, 2304, 4608, -1, -2,
                             256, 512, 1024, 2048, 4096, 8192, 16384, 32768};
const int kSampleSizes[8] = {0, 8, 12, 0, 16, 20, 24, 32};

}  // namespace

extern "C" {

// Parse STREAMINFO. Returns 0 on success.
int srt_flac_info(const uint8_t* data, uint64_t len, int32_t* channels,
                  int32_t* sample_rate, int32_t* bps, uint64_t* total,
                  uint64_t* frames_offset) {
  if (len < 8 || std::memcmp(data, "fLaC", 4) != 0) return -1;
  uint64_t pos = 4;
  bool have_info = false;
  while (pos + 4 <= len) {
    int last = data[pos] & 0x80;
    int btype = data[pos] & 0x7F;
    uint32_t size =
        (data[pos + 1] << 16) | (data[pos + 2] << 8) | data[pos + 3];
    if (btype == 0 && size >= 34) {
      const uint8_t* p = data + pos + 4;
      uint64_t rest = 0;
      for (int i = 10; i < 18; ++i) rest = (rest << 8) | p[i];
      *sample_rate = (int32_t)(rest >> 44);
      *channels = (int32_t)((rest >> 41) & 0x7) + 1;
      *bps = (int32_t)((rest >> 36) & 0x1F) + 1;
      *total = rest & ((1ull << 36) - 1);
      have_info = true;
    }
    pos += 4 + size;
    if (last) break;
  }
  if (!have_info || pos > len) return -2;
  *frames_offset = pos;
  return 0;
}

// Decode all frames into planar int32 (channels x total). Returns number of
// samples decoded per channel, or negative on error.
int64_t srt_flac_decode(const uint8_t* data, uint64_t len,
                        uint64_t frames_offset, int32_t channels,
                        int32_t stream_bps, uint64_t total, int32_t* out) {
  BitReader br{data + frames_offset, (len - frames_offset) * 8};
  std::vector<std::vector<int64_t>> subs(channels);
  uint64_t done = 0;
  while (br.pos + 16 <= br.nbits && (!total || done < total)) {
    if (br.read(14) != 0x3FFE) return -3;
    br.read(2);
    int bs_code = br.read(4);
    int sr_code = br.read(4);
    int ch_code = br.read(4);
    int ss_code = br.read(3);
    br.read(1);
    br.read_utf8();
    int block_size;
    if (bs_code == 6)
      block_size = br.read(8) + 1;
    else if (bs_code == 7)
      block_size = br.read(16) + 1;
    else
      block_size = kBlockSizes[bs_code];
    if (sr_code == 12)
      br.read(8);
    else if (sr_code == 13 || sr_code == 14)
      br.read(16);
    int bps = kSampleSizes[ss_code] ? kSampleSizes[ss_code] : stream_bps;
    br.read(8);  // crc8

    if (ch_code < 8) {
      for (int c = 0; c < ch_code + 1; ++c)
        if (!decode_subframe(br, block_size, bps, subs[c])) return -4;
    } else if (ch_code == 8) {
      if (!decode_subframe(br, block_size, bps, subs[0])) return -4;
      std::vector<int64_t> side;
      if (!decode_subframe(br, block_size, bps + 1, side)) return -4;
      subs[1].resize(block_size);
      for (int i = 0; i < block_size; ++i)
        subs[1][i] = subs[0][i] - side[i];
    } else if (ch_code == 9) {
      std::vector<int64_t> side;
      if (!decode_subframe(br, block_size, bps + 1, side)) return -4;
      if (!decode_subframe(br, block_size, bps, subs[1])) return -4;
      subs[0].resize(block_size);
      for (int i = 0; i < block_size; ++i)
        subs[0][i] = subs[1][i] + side[i];
    } else if (ch_code == 10) {
      std::vector<int64_t> mid, side;
      if (!decode_subframe(br, block_size, bps, mid)) return -4;
      if (!decode_subframe(br, block_size, bps + 1, side)) return -4;
      subs[0].resize(block_size);
      subs[1].resize(block_size);
      for (int i = 0; i < block_size; ++i) {
        int64_t m = (mid[i] << 1) | (side[i] & 1);
        subs[0][i] = (m + side[i]) >> 1;
        subs[1][i] = (m - side[i]) >> 1;
      }
    } else {
      return -5;
    }
    br.align();
    br.read(16);  // crc16

    uint64_t take = block_size;
    if (total && done + take > total) take = total - done;
    for (int c = 0; c < channels; ++c)
      for (uint64_t i = 0; i < take; ++i)
        out[(uint64_t)c * total + done + i] = (int32_t)subs[c][i];
    done += take;
    if (!br.ok) return -6;
  }
  return (int64_t)done;
}

}  // extern "C"
