"""From-scratch FLAC codec in NumPy: decoder and fixed-predictor encoder.

The reference decodes FLAC through its vendored dr_flac
(Executable/dr_flac.h, used at Executable/main.c:237-238). This is the
reference package's codec (spleeterrt_tpu/io/flac.py), kept as the port's
own copy: a spec-complete subset decoder (STREAMINFO, frame headers with
UTF-8 coded numbers, CONSTANT / VERBATIM / FIXED / LPC subframes, 4- and
5-bit Rice partitions with escape codes, wasted bits, and every stereo
decorrelation mode) with a vectorized Rice scanner, and an encoder (fixed
predictors, one Rice partition) that writes the reference package's
streams byte for byte. The encoder builds each frame as one NumPy bit
array, so a track of minutes encodes in seconds; the reference package's
writes a bit at a time. Frame numbers past 2047 are written as the
specification's longer UTF-8 forms.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

FIXED_COEFFS = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}


def _crc_table(poly: int, width: int) -> list[int]:
    top, mask = 1 << (width - 1), (1 << width) - 1
    table = []
    for i in range(256):
        c = i << (width - 8)
        for _ in range(8):
            c = ((c << 1) ^ poly) & mask if c & top else (c << 1) & mask
        table.append(c)
    return table


_CRC8_TABLE = _crc_table(0x07, 8)
_CRC16_TABLE = _crc_table(0x8005, 16)


def _crc8(data: bytes) -> int:
    c = 0
    for b in data:
        c = _CRC8_TABLE[c ^ b]
    return c


def _crc16(data: bytes) -> int:
    c = 0
    for b in data:
        c = ((c << 8) & 0xFFFF) ^ _CRC16_TABLE[((c >> 8) ^ b) & 0xFF]
    return c


class BitReader:
    """MSB-first bit reader over a bytes buffer (NumPy-backed)."""

    def __init__(self, data: bytes):
        self.bits = np.unpackbits(np.frombuffer(data, dtype=np.uint8))
        self.pos = 0

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        chunk = self.bits[self.pos : self.pos + n]
        if chunk.size < n:
            raise EOFError("FLAC bitstream truncated")
        self.pos += n
        val = 0
        for b in chunk:
            val = (val << 1) | int(b)
        return val

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        return v - (1 << n) if v >= (1 << (n - 1)) else v

    def read_unary(self) -> int:
        # distance to the next 1-bit
        nz = np.flatnonzero(self.bits[self.pos :])
        if nz.size == 0:
            raise EOFError("FLAC bitstream truncated in unary code")
        q = int(nz[0])
        self.pos += q + 1
        return q

    def read_utf8_coded(self) -> int:
        first = self.read(8)
        if first < 0x80:
            return first
        n_extra = 0
        mask = 0x40
        while first & mask:
            n_extra += 1
            mask >>= 1
        val = first & (mask - 1)
        for _ in range(n_extra):
            val = (val << 6) | (self.read(8) & 0x3F)
        return val

    def align_byte(self):
        self.pos = (self.pos + 7) // 8 * 8

    def rice_block(self, k: int, count: int) -> np.ndarray:
        """Decode `count` Rice(k) codes, vectorized over the 1-bit positions.

        The stop bit of code i is the first 1-bit at or after the code's
        start; the next code starts k+1 bits later (the remainder may itself
        contain 1-bits, so stop bits are found by pointer-chasing through
        the sorted 1-bit positions). The chase is vectorized with jump-table
        doubling: O(L log count) NumPy work instead of a per-sample loop.
        """
        if count == 0:
            return np.empty(0, dtype=np.int64)
        bits = self.bits
        pos = self.pos
        step = 1 + k
        # Window sized for typical Rice streams; grown geometrically if the
        # quotients turn out large.
        window = count * (k + 3) + 64
        while True:
            ones = np.flatnonzero(bits[pos : pos + window])
            L = ones.size
            if L >= count:
                # table[j] = index of the first 1-bit at/after ones[j]+step;
                # sentinel index L maps to itself (ran off the window).
                table = np.searchsorted(ones, ones + step)
                table = np.append(table, L)
                # Jump-table doubling: X holds stop-bit indices x_0..x_{n-1};
                # applying the power-n composed table yields x_n..x_{2n-1}.
                x = np.zeros(1, dtype=np.int64)  # x_0 = first 1-bit
                comp = table
                while x.size < count:
                    x = np.concatenate([x, comp[x]])
                    if x.size < count:
                        comp = comp[comp]
                x = x[:count]
                if x[-1] < L and pos + ones[x[-1]] + step <= bits.size:
                    break  # window covered every code incl. trailing bits
            if pos + window >= bits.size:
                raise EOFError("FLAC bitstream truncated in Rice block")
            window *= 4
        stops = ones[x]  # relative to pos
        starts = np.empty(count, dtype=np.int64)
        starts[0] = 0
        starts[1:] = stops[:-1] + step
        q = stops - starts
        if k:
            ridx = pos + stops[:, None] + 1 + np.arange(k, dtype=np.int64)
            weights = np.int64(1) << np.arange(k - 1, -1, -1, dtype=np.int64)
            r = (bits[ridx].astype(np.int64) * weights).sum(axis=1)
            u = (q << k) | r
        else:
            u = q
        self.pos = pos + int(stops[-1]) + step
        return (u >> 1) ^ -(u & 1)  # zigzag -> signed


@dataclass
class FlacStreamInfo:
    min_block: int
    max_block: int
    sample_rate: int
    channels: int
    bits_per_sample: int
    total_samples: int


_BLOCK_SIZES = {
    1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
    8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096, 13: 8192, 14: 16384, 15: 32768,
}
_SAMPLE_SIZES = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}
# The encoder's sample-size codes (any other depth is written as code 4).
_SAMPLE_SIZE_CODES = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6}


def _parse_streaminfo(payload: bytes) -> FlacStreamInfo:
    min_block, max_block = struct.unpack(">HH", payload[0:4])
    rest = int.from_bytes(payload[10:18], "big")
    sample_rate = rest >> 44
    channels = ((rest >> 41) & 0x7) + 1
    bps = ((rest >> 36) & 0x1F) + 1
    total = rest & ((1 << 36) - 1)
    return FlacStreamInfo(min_block, max_block, sample_rate, channels, bps, total)


def _decode_subframe(br: BitReader, block_size: int, bps: int) -> np.ndarray:
    if br.read(1):
        raise ValueError("invalid subframe padding bit")
    sf_type = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = br.read_unary() + 1
    bps -= wasted

    if sf_type == 0:  # CONSTANT
        v = br.read_signed(bps)
        out = np.full(block_size, v, dtype=np.int64)
    elif sf_type == 1:  # VERBATIM
        out = np.array([br.read_signed(bps) for _ in range(block_size)], np.int64)
    elif 8 <= sf_type <= 12:  # FIXED
        order = sf_type - 8
        out = _decode_predicted(
            br, block_size, bps, order,
            coeffs=np.array(FIXED_COEFFS[order], np.int64), shift=0,
            fixed=True,
        )
    elif sf_type >= 32:  # LPC
        order = (sf_type & 0x1F) + 1
        warmup = [br.read_signed(bps) for _ in range(order)]
        precision = br.read(4) + 1
        if precision == 16:
            raise ValueError("invalid LPC precision escape")
        shift = br.read_signed(5)
        coeffs = np.array(
            [br.read_signed(precision) for _ in range(order)], np.int64
        )
        out = _decode_predicted(
            br, block_size, bps, order, coeffs, shift, warmup=warmup
        )
    else:
        raise ValueError(f"reserved subframe type {sf_type}")
    return out << wasted


def _decode_residual(br: BitReader, block_size: int, order: int) -> np.ndarray:
    method = br.read(2)
    if method > 1:
        raise ValueError("reserved residual coding method")
    k_bits = 4 if method == 0 else 5
    escape = (1 << k_bits) - 1
    part_order = br.read(4)
    n_parts = 1 << part_order
    part_len = block_size >> part_order
    res = np.empty(block_size - order, dtype=np.int64)
    pos = 0
    for p in range(n_parts):
        count = part_len - (order if p == 0 else 0)
        k = br.read(k_bits)
        if k == escape:
            raw_bits = br.read(5)
            vals = np.array(
                [br.read_signed(raw_bits) if raw_bits else 0 for _ in range(count)],
                np.int64,
            )
        else:
            vals = br.rice_block(k, count)
        res[pos : pos + count] = vals
        pos += count
    return res


def _decode_predicted(
    br: BitReader, block_size: int, bps: int, order: int,
    coeffs: np.ndarray, shift: int, warmup=None, fixed: bool = False,
) -> np.ndarray:
    if warmup is None:
        warmup = [br.read_signed(bps) for _ in range(order)]
    res = _decode_residual(br, block_size, order)
    if fixed:
        # Order-o fixed prediction is the o-th finite difference; invert it
        # with o exact int64 cumsums seeded by the warmup's difference tails.
        diffs = [np.asarray(warmup, dtype=np.int64)]
        for _ in range(1, order):
            diffs.append(np.diff(diffs[-1]))
        seq = res
        for j in range(order - 1, -1, -1):
            seq = diffs[j][-1] + np.cumsum(seq)
        return np.concatenate([diffs[0], seq])
    out = np.empty(block_size, dtype=np.int64)
    out[:order] = warmup
    c = coeffs  # c[0] multiplies the most recent sample
    for i in range(order, block_size):
        pred = 0
        for j in range(order):
            pred += c[j] * out[i - 1 - j]
        out[i] = res[i - order] + (pred >> shift)
    return out


def decode_flac(data: bytes) -> tuple[np.ndarray, int]:
    """FLAC bytes -> (float32 planar (channels, n), sample_rate)."""
    if data[:4] != b"fLaC":
        raise ValueError("not a FLAC stream")
    pos = 4
    info = None
    while True:
        hdr = data[pos : pos + 4]
        if len(hdr) < 4:
            raise ValueError("FLAC metadata truncated")
        last = hdr[0] & 0x80
        btype = hdr[0] & 0x7F
        size = int.from_bytes(hdr[1:4], "big")
        payload = data[pos + 4 : pos + 4 + size]
        if btype == 0:
            info = _parse_streaminfo(payload)
        pos += 4 + size
        if last:
            break
    if info is None:
        raise ValueError("missing STREAMINFO")

    br = BitReader(data[pos:])
    total = info.total_samples
    chans = info.channels
    out = np.zeros((chans, total if total else 0), dtype=np.int64)
    collected = []
    n_done = 0
    while True:
        # EOF detection: aligned and fewer than 16 bits left
        if br.pos + 16 > br.bits.size:
            break
        sync = br.read(14)
        if sync != 0x3FFE:
            raise ValueError(f"bad frame sync 0x{sync:x}")
        br.read(1)  # reserved
        br.read(1)  # blocking strategy
        bs_code = br.read(4)
        sr_code = br.read(4)
        ch_code = br.read(4)
        ss_code = br.read(3)
        br.read(1)  # reserved
        br.read_utf8_coded()  # frame/sample number
        if bs_code == 6:
            block_size = br.read(8) + 1
        elif bs_code == 7:
            block_size = br.read(16) + 1
        else:
            block_size = _BLOCK_SIZES[bs_code]
        if sr_code == 12:
            br.read(8)
        elif sr_code in (13, 14):
            br.read(16)
        bps = _SAMPLE_SIZES.get(ss_code, info.bits_per_sample)
        br.read(8)  # CRC-8 (validated implicitly by successful parse)

        if ch_code < 8:
            n_ch = ch_code + 1
            subs = [_decode_subframe(br, block_size, bps) for _ in range(n_ch)]
        elif ch_code == 8:  # left/side
            left = _decode_subframe(br, block_size, bps)
            side = _decode_subframe(br, block_size, bps + 1)
            subs = [left, left - side]
        elif ch_code == 9:  # right/side
            side = _decode_subframe(br, block_size, bps + 1)
            right = _decode_subframe(br, block_size, bps)
            subs = [right + side, right]
        elif ch_code == 10:  # mid/side
            mid = _decode_subframe(br, block_size, bps)
            side = _decode_subframe(br, block_size, bps + 1)
            mid = (mid << 1) | (side & 1)
            subs = [(mid + side) >> 1, (mid - side) >> 1]
        else:
            raise ValueError(f"reserved channel assignment {ch_code}")

        br.align_byte()
        br.read(16)  # frame CRC-16
        collected.append(np.stack(subs))
        n_done += block_size
        if total and n_done >= total:
            break

    pcm = np.concatenate(collected, axis=1) if collected else out
    if total:
        pcm = pcm[:, :total]
    scale = float(1 << (info.bits_per_sample - 1))
    return (pcm.astype(np.float32) / scale, info.sample_rate)


# ---------------------------------------------------------------------------
# Encoder: fixed predictors + Rice residuals (subset, always correct).
# ---------------------------------------------------------------------------


def _bits(val: int, n: int) -> np.ndarray:
    """The low n bits of val, MSB first, as a uint8 0/1 array."""
    shifts = np.arange(n - 1, -1, -1, dtype=np.uint64)
    return ((np.uint64(val & ((1 << n) - 1)) >> shifts) & np.uint64(1)).astype(np.uint8)


def _utf8_coded(n: int) -> bytes:
    """A frame number in FLAC's extended UTF-8 code (up to 36 bits)."""
    if n < 0x80:
        return bytes([n])
    for extra in range(1, 7):
        if n < 1 << (5 * extra + 6):
            lead = ((0xFF << (7 - extra)) & 0xFF) | (n >> (6 * extra))
            tail = [0x80 | ((n >> (6 * i)) & 0x3F) for i in range(extra - 1, -1, -1)]
            return bytes([lead, *tail])
    raise ValueError(f"frame number {n} needs more than 36 bits")


def _best_rice_k(res: np.ndarray) -> int:
    if res.size == 0:
        return 0
    zig = (np.abs(res.astype(np.int64)) << 1).astype(np.float64)
    mean = max(zig.mean(), 1.0)
    return min(14, max(0, int(np.log2(mean))))


def _rice_bits(res: np.ndarray, k: int) -> np.ndarray:
    """Rice(k) codes of the signed residuals as one bit array: per code,
    u >> k zeros, a one, then u's low k bits, u the zigzag of the value."""
    v = res.astype(np.int64)
    u = (np.abs(v) << 1) - (v < 0)
    q = u >> k
    lengths = q + 1 + k
    starts = np.zeros(v.size, dtype=np.int64)
    np.cumsum(lengths[:-1], out=starts[1:])
    out = np.zeros(int(lengths.sum()), dtype=np.uint8)
    stops = starts + q
    out[stops] = 1
    for j in range(k):
        out[stops + 1 + j] = (u >> (k - 1 - j)) & 1
    return out


def _subframe_bits(x: np.ndarray, bps: int) -> list[np.ndarray]:
    """A FIXED subframe of the order that minimizes the residual's |sum|."""
    best_order, best_res, best_cost = 0, x, None
    for order in FIXED_COEFFS:
        if order > x.size:
            break
        res = x.astype(np.int64)
        for _ in range(order):
            res = np.diff(res)
        cost = np.abs(res).sum()
        if best_cost is None or cost < best_cost:
            best_order, best_res, best_cost = order, res, cost
    k = _best_rice_k(best_res)
    return [
        _bits((8 + best_order) << 1, 8),  # padding bit, FIXED type, no wasted bits
        *(_bits(int(v), bps) for v in x[:best_order]),
        _bits(k, 10),  # 4-bit Rice, partition order 0, the parameter
        _rice_bits(best_res, k),
    ]


def encode_flac(
    samples: np.ndarray, sample_rate: int = 44100, bps: int = 16,
    block_size: int = 4096,
) -> bytes:
    """float32 (channels, n) in [-1,1] -> FLAC bytes (fixed predictors)."""
    x = np.asarray(samples)
    if x.ndim == 1:
        x = x[None]
    chans, n = x.shape
    scale = 1 << (bps - 1)
    pcm = np.clip(np.round(x * scale), -scale, scale - 1).astype(np.int64)

    out = bytearray(b"fLaC")
    # STREAMINFO (last metadata block)
    si = bytearray()
    si += struct.pack(">HH", block_size, block_size)
    si += b"\x00\x00\x00" * 2  # min/max frame size unknown
    packed = (sample_rate << 44) | ((chans - 1) << 41) | ((bps - 1) << 36) | n
    si += packed.to_bytes(8, "big")
    si += b"\x00" * 16  # md5 unset
    out += bytes([0x80]) + len(si).to_bytes(3, "big") + bytes(si)

    for frame_idx, start in enumerate(range(0, n, block_size)):
        blk = pcm[:, start : start + block_size]
        bsize = blk.shape[1]
        # Sync, fixed blocking, a 16-bit block size follows, the rate (44.1
        # kHz or from STREAMINFO), independent channels, the sample size.
        hdr = (
            (0x3FFE << 18) | (7 << 12) | ((9 if sample_rate == 44100 else 0) << 8)
            | ((chans - 1) << 4) | (_SAMPLE_SIZE_CODES.get(bps, 4) << 1)
        ).to_bytes(4, "big") + _utf8_coded(frame_idx) + (bsize - 1).to_bytes(2, "big")
        bits = [np.unpackbits(np.frombuffer(hdr + bytes([_crc8(hdr)]), np.uint8))]
        for c in range(chans):
            bits += _subframe_bits(blk[c], bps)
        body = np.packbits(np.concatenate(bits)).tobytes()  # zero-pads to a byte
        out += body + struct.pack(">H", _crc16(body))
    return bytes(out)
