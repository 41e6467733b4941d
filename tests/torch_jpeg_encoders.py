"""JPEG encoders for the tests of the port's decoder: numpy and Python
only, no imaging library.

Pillow is the oracle (``tests/test_torch_jpeg_forms.py``,
``scripts/make_jpeg_forms_fixture.py``): each stream written here is
decoded by Pillow (libjpeg-turbo) and by the port's ``io/jpeg.decode``,
and the two results are compared, so a stream has to be valid, not equal
to what libjpeg's encoder would write.  They write the forms that Pillow's
own encoder cannot:

- ``dct_stream``: DCT streams of 1, 3 or 4 components with any sampling
  factors 1-4 and any Adobe APP14 transform (CMYK, YCCK), interleaved or
  one scan per component, with restart intervals.  Huffman-coded
  sequential (tables fitted to the data as jchuff.c's
  ``jpeg_gen_optimal_table`` fits them), or arithmetic-coded after
  jcarith.c, sequential (SOF9) or progressive (SOF10) with any scan
  script, refinement scans or none, and a DAC segment of its own
  conditioning;
- ``lossless_stream``: lossless (SOF3) Huffman streams of any predictor
  1-7, point transform, restart interval and sampling, interleaved or
  not, of 16-bit sample values (the decoder keeps samples modulo 2^16:
  category 16 included).

``rewrite_sof`` relabels a stream's frame for the refusal tests.
"""

from __future__ import annotations

import struct

import numpy as np

# zigzag index -> natural (row-major) index, jutils.c jpeg_natural_order
NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# ITU T.81 Annex K.1, natural order
LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
CHROMA_Q = np.full(64, 99)
CHROMA_Q[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = \
    [17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]

# jcparam.c jpeg_simple_progression for a colour image: (components or
# None for all, Ss, Se, Ah, Al)
FULL_PROGRESSION = ((None, 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1),
                    ((1,), 1, 63, 0, 1), ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
                    (None, 0, 0, 1, 0), ((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0),
                    ((0,), 1, 63, 1, 0))
# the same first scans, no refinement: zigzag 1-9 left at bit 1 or 2
UNREFINED_PROGRESSION = FULL_PROGRESSION[:5]


def rgb_to_ycc(rgb: np.ndarray) -> np.ndarray:
    """JFIF's RGB -> YCbCr (jccolor.c's coefficients), rounded to uint8."""
    r, g, b = (rgb[..., i].astype(np.float64) for i in range(3))
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128
    return np.clip(np.round(np.stack([y, cb, cr], -1)), 0, 255).astype(np.uint8)


def quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """jcparam.c jpeg_quality_scaling / jpeg_add_quant_table (baseline)."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255).astype(np.int64)


def marker(m: int, payload: bytes = b"") -> bytes:
    return bytes([0xFF, m]) + struct.pack(">H", len(payload) + 2) + payload


JFIF = marker(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")


def adobe(transform: int) -> bytes:
    return marker(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([transform]))


# ---------------------------------------------------------------------- #
# Huffman coding
# ---------------------------------------------------------------------- #
def optimal_table(freq: dict) -> tuple[list, list]:
    """jchuff.c jpeg_gen_optimal_table: (bits[1..16], values) for symbol
    frequencies, code lengths limited to 16 and the all-ones code left
    unused."""
    f = [0] * 257
    for s, n in freq.items():
        f[s] = n
    f[256] = 1
    size = [0] * 257
    others = [-1] * 257
    while True:
        live = [i for i in range(257) if f[i]]
        if len(live) < 2:
            break
        # smallest frequency, ties to the larger symbol; then the next
        c1 = min(live, key=lambda i: (f[i], -i))
        c2 = min((i for i in live if i != c1), key=lambda i: (f[i], -i))
        f[c1] += f[c2]
        f[c2] = 0
        size[c1] += 1
        while others[c1] >= 0:
            c1 = others[c1]
            size[c1] += 1
        others[c1] = c2
        size[c2] += 1
        while others[c2] >= 0:
            c2 = others[c2]
            size[c2] += 1
    bits = [0] * 33
    for i in range(257):
        if size[i]:
            bits[size[i]] += 1
    for i in range(32, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1
    values = [s for length in range(1, 33) for s in range(256) if size[s] == length]
    return bits[1:17], values


def _codes(bits, values) -> dict:
    codes, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes[values[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


def _dht(tc: int, th: int, bits, values) -> bytes:
    return bytes([(tc << 4) | th]) + bytes(bits) + bytes(values)


class _Bits:
    """Entropy-coded bytes of a Huffman scan: 0xFF stuffed, padded with 1s."""

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, code: int, length: int):
        self.acc = (self.acc << length) | code
        self.n += length
        while self.n >= 8:
            self.n -= 8
            b = (self.acc >> self.n) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _category(v: int) -> tuple[int, int]:
    """(size, extra bits) of a difference or coefficient (F.1.2.1)."""
    a = abs(v)
    s = a.bit_length()
    return s, (v if v >= 0 else v + (1 << s) - 1)


def _huffman_scan(events, tables) -> tuple[bytes, bytes]:
    """Codes a scan's events: ("sym", (class, table), symbol, extra, n) or
    ("rst", n).  Returns (DHT payload, entropy-coded bytes)."""
    freq = {}
    for e in events:
        if e[0] == "sym":
            freq.setdefault(e[1], {}).setdefault(e[2], 0)
            freq[e[1]][e[2]] += 1
    for key in tables:
        freq.setdefault(key, {0: 1})
    dht, codes = b"", {}
    for key in sorted(freq):
        bits, values = optimal_table(freq[key])
        dht += _dht(key[0], key[1], bits, values)
        codes[key] = _codes(bits, values)
    w = _Bits()
    for e in events:
        if e[0] == "rst":
            w.flush()
            w.out += bytes([0xFF, 0xD0 + e[1]])
            continue
        code, length = codes[e[1]][e[2]]
        w.put(code, length)
        if e[4]:
            w.put(e[3], e[4])
    w.flush()
    return dht, bytes(w.out)


# ---------------------------------------------------------------------- #
# arithmetic coding (jcarith.c, jaricom.c)
# ---------------------------------------------------------------------- #
# T.81 Table D.2: (Qe, next index after LPS, next index after MPS, switch
# MPS); index 113 is the fixed 0.5 estimate of T.851 (jaricom.c)
QE_TABLE = (
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080b, 18, 4, 0),
    (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0), (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0),
    (0x0036, 30, 9, 0), (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1), (0x3f25, 36, 16, 0),
    (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0), (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0cef, 43, 21, 0), (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01b1, 54, 28, 0),
    (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0), (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0),
    (0x0068, 62, 33, 0), (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0), (0x2ef1, 67, 40, 0),
    (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0), (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0),
    (0x1177, 73, 45, 0), (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0), (0x04de, 50, 52, 0),
    (0x040f, 50, 53, 0), (0x0363, 51, 54, 0), (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0),
    (0x01f8, 54, 57, 0), (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0), (0x008f, 61, 32, 0),
    (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0), (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0),
    (0x2fe8, 83, 69, 0), (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0), (0x119c, 74, 76, 0),
    (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0), (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0), (0x2516, 86, 71, 0),
    (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0), (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0),
    (0x3824, 99, 93, 0), (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0), (0x3c3d, 104, 100, 0),
    (0x375e, 99, 93, 0), (0x5231, 105, 102, 0), (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0),
    (0x415e, 103, 99, 0), (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1), (0x5522, 112, 109, 0),
    (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0))
FIXED = 113


class ArithEncoder:
    """The QM coder of one scan or restart interval (T.81 Annex D, the
    decisions as jcarith.c codes them).  The code register is kept exact:
    a byte is written once no later decision can change it but by a carry,
    which is added into the bytes already written."""

    def __init__(self):
        self.out = bytearray()
        self.low = 0        # code value below the written bytes, in units of a
        self.a = 0x10000
        self.k = 16         # bits of ``low`` below the written bytes

    def encode(self, stats, i: int, val: int):
        sv = stats[i]
        qe, nlps, nmps, switch = QE_TABLE[sv & 0x7F]
        mps = sv >> 7
        self.a -= qe
        if val != mps:
            if self.a >= qe:
                self.low += self.a
                self.a = qe
            stats[i] = ((mps ^ switch) << 7) | nlps
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.low += self.a
                self.a = qe
            stats[i] = (mps << 7) | nmps
        while self.a < 0x8000:
            self.a <<= 1
            self.low <<= 1
            self.k += 1
        if self.k >= 40:
            self._carry()
            while self.k >= 32:
                self.k -= 8
                self.out.append(self.low >> self.k)
                self.low &= (1 << self.k) - 1

    def _carry(self):
        c = self.low >> self.k
        if c:
            self.low -= c << self.k
            i = len(self.out) - 1
            while c:
                v = self.out[i] + c
                self.out[i] = v & 0xFF
                c = v >> 8
                i -= 1

    def finish(self) -> bytes:
        """jcarith.c finish_pass: the value in the final interval with the
        most trailing zero bits; trailing zero bytes dropped (the decoder
        reads zeros at the marker); 0xFF stuffed."""
        v = (self.a - 1 + self.low) & ~0xFFFF
        self.low = v + 0x8000 if v < self.low else v
        self._carry()
        n = (self.k + 7) // 8
        self.out += (self.low << (8 * n - self.k)).to_bytes(n, "big")
        out = bytes(self.out).rstrip(b"\x00")
        return out.replace(b"\xff", b"\xff\x00")


class _ArithScan:
    """jcarith.c's statistics and the four progressive encoders plus the
    sequential one, for one scan."""

    def __init__(self, comps, ss, se, ah, al, dc_lu, ac_k):
        self.comps, self.ss, self.se, self.ah, self.al = comps, ss, se, ah, al
        self.dc_lu, self.ac_k = dc_lu, ac_k
        self.data = bytearray()
        self.reset()

    def reset(self):
        self.enc = ArithEncoder()
        self.dc_stats = {c["td"]: bytearray(64) for c in self.comps}
        self.ac_stats = {c["ta"]: bytearray(256) for c in self.comps}
        self.fixed = bytearray([FIXED])
        self.last_dc = [0] * len(self.comps)
        self.dc_ctx = [0] * len(self.comps)

    def restart(self, n: int):
        self.data += self.enc.finish() + bytes([0xFF, 0xD0 + n])
        self.reset()

    def finish(self) -> bytes:
        return bytes(self.data + self.enc.finish())

    def dc(self, ci: int, value: int):
        """F.1.4.1 (decode_mcu's DC part, DC first): ``value`` shifted by Al."""
        c = self.comps[ci]
        st = self.dc_stats[c["td"]]
        i = self.dc_ctx[ci]
        v = value - self.last_dc[ci]
        e = self.enc
        if v == 0:
            e.encode(st, i, 0)
            self.dc_ctx[ci] = 0
            return
        self.last_dc[ci] = value
        e.encode(st, i, 1)
        if v > 0:
            e.encode(st, i + 1, 0)
            i += 2
            self.dc_ctx[ci] = 4
        else:
            v = -v
            e.encode(st, i + 1, 1)
            i += 3
            self.dc_ctx[ci] = 8
        # the category and the bits, with the category bins of F.1.4.4.1
        m = 0
        v -= 1
        if v:
            e.encode(st, i, 1)
            m = 1
            v2 = v
            i = 20
            while v2 >> 1:
                v2 >>= 1
                e.encode(st, i, 1)
                m <<= 1
                i += 1
        e.encode(st, i, 0)
        lo, up = self.dc_lu[c["td"]]
        if m < (1 << lo) >> 1:
            self.dc_ctx[ci] = 0
        elif m > (1 << up) >> 1:
            self.dc_ctx[ci] += 8
        i += 14
        while m >> 1:
            m >>= 1
            e.encode(st, i, 1 if m & v else 0)

    def ac(self, ci: int, blk: np.ndarray, ss: int, se: int, al: int):
        """F.1.4.2 / G.1.3.2 (AC first): zigzag ``ss``-``se`` of ``blk``
        (natural order), point transform ``al``."""
        c = self.comps[ci]
        st = self.ac_stats[c["ta"]]
        e = self.enc
        zz = [int(blk[NATURAL[k]]) for k in range(64)]
        vals = [(abs(v) >> al) * (1 if v >= 0 else -1) for v in zz]
        ke = se
        while ke >= ss and vals[ke] == 0:
            ke -= 1
        k = ss
        while k <= ke:
            i = 3 * (k - 1)
            e.encode(st, i, 0)
            while vals[k] == 0:
                e.encode(st, i + 1, 0)
                i += 3
                k += 1
            e.encode(st, i + 1, 1)
            e.encode(self.fixed, 0, 1 if vals[k] < 0 else 0)
            i += 2
            v = abs(vals[k])
            m = 0
            v -= 1
            if v:
                e.encode(st, i, 1)
                m = 1
                v2 = v >> 1
                if v2:
                    e.encode(st, i, 1)
                    m <<= 1
                    i = 189 if k <= self.ac_k[c["ta"]] else 217
                    while v2 >> 1:
                        v2 >>= 1
                        e.encode(st, i, 1)
                        m <<= 1
                        i += 1
            e.encode(st, i, 0)
            i += 14
            while m >> 1:
                m >>= 1
                e.encode(st, i, 1 if m & v else 0)
            k += 1
        if k <= se:
            e.encode(st, 3 * (k - 1), 1)

    def dc_refine(self, value: int):
        self.enc.encode(self.fixed, 0, (value >> self.al) & 1)

    def ac_refine(self, ci: int, blk: np.ndarray):
        """G.1.3.3 (jcarith.c encode_mcu_AC_refine)."""
        c = self.comps[ci]
        st = self.ac_stats[c["ta"]]
        e = self.enc
        ss, se, ah, al = self.ss, self.se, self.ah, self.al
        zz = [int(blk[NATURAL[k]]) for k in range(64)]
        ke = se
        while ke > 0 and (abs(zz[ke]) >> al) == 0:
            ke -= 1
        kex = ke
        while kex > 0 and (abs(zz[kex]) >> ah) == 0:
            kex -= 1
        k = ss
        while k <= ke:
            i = 3 * (k - 1)
            if k > kex:
                e.encode(st, i, 0)
            while True:
                v = abs(zz[k]) >> al
                if v:
                    if v >> 1:
                        e.encode(st, i + 2, v & 1)
                    else:
                        e.encode(st, i + 1, 1)
                        e.encode(self.fixed, 0, 1 if zz[k] < 0 else 0)
                    break
                e.encode(st, i + 1, 0)
                i += 3
                k += 1
            k += 1
        if k <= se:
            e.encode(st, 3 * (k - 1), 1)


# ---------------------------------------------------------------------- #
# DCT streams
# ---------------------------------------------------------------------- #
_C = np.array([[(np.sqrt(0.125) if u == 0 else 0.5) * np.cos((2 * x + 1) * u * np.pi / 16)
                for x in range(8)] for u in range(8)])


def component_plane(plane: np.ndarray, c: dict, max_h: int, max_v: int) -> np.ndarray:
    """A full-resolution plane at a component's resolution (its dw x dh
    samples, each the image sample at its top-left corner; any samples
    make a valid stream)."""
    ys = np.arange(c["dh"]) * max_v // c["v"]
    xs = np.arange(c["dw"]) * max_h // c["h"]
    return plane[ys][:, xs].astype(np.float64)


def _blocks(plane: np.ndarray, bw: int, bh: int, q: np.ndarray) -> np.ndarray:
    """(bh, bw, 64) quantised coefficients, natural order, of a plane
    padded by edge replication to bw x bh blocks."""
    h, w = plane.shape
    p = np.pad(plane, ((0, bh * 8 - h), (0, bw * 8 - w)), mode="edge") - 128.0
    b = p.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
    f = np.einsum("ux,abxy,vy->abuv", _C, b, _C)
    return np.round(f.reshape(bh, bw, 64) / q).astype(np.int64)


def _layout(width, height, sampling):
    max_h = max(h for h, _ in sampling)
    max_v = max(v for _, v in sampling)
    mx, my = -(-width // (8 * max_h)), -(-height // (8 * max_v))
    comps = []
    for h, v in sampling:
        dw, dh = -(-width * h // max_h), -(-height * v // max_v)
        comps.append(dict(h=h, v=v, dw=dw, dh=dh, bw=mx * h, bh=my * v))
    return max_h, max_v, mx, my, comps


def _each_block(comps, scan_comps, mx, my, restart):
    """(event, ...) in the stream's order: ("rst", n) between restart
    intervals, ("block", component index, bx, by) for every block;
    ``restart`` counts MCUs (blocks in a one-component scan)."""
    if len(scan_comps) == 1:
        c = comps[scan_comps[0]]
        cols, rows = -(-c["dw"] // 8), -(-c["dh"] // 8)
    else:
        cols, rows = mx, my
    n = 0
    for m in range(cols * rows):
        if restart and m and m % restart == 0:
            yield ("rst", n)
            n = (n + 1) & 7
        x, y = m % cols, m // cols
        if len(scan_comps) == 1:
            yield ("block", scan_comps[0], x, y)
            continue
        for ci in scan_comps:
            c = comps[ci]
            for by in range(c["v"]):
                for bx in range(c["h"]):
                    yield ("block", ci, x * c["h"] + bx, y * c["v"] + by)


def dct_stream(planes: np.ndarray, sampling=None, quality=75, *, arithmetic=False,
               script=None, interleave=True, restart=0, transform=None, dac=None) -> bytes:
    """A DCT stream of ``planes`` ((H, W) or (H, W, n), n in 1, 3, 4; the
    component values as the stream holds them: Y Cb Cr, C M Y K or Y Cb Cr
    K, as given).

    ``sampling``: per component (h, v), default 1x1; ``script``: the
    progressive scans as ``FULL_PROGRESSION`` writes them (arithmetic only);
    ``interleave``: one sequential scan of all components or one per
    component; ``restart``: the restart interval in MCUs; ``transform``:
    an Adobe APP14 marker with this transform (else a JFIF marker when
    there are 3 components); ``dac``: {(class, table): value} conditioning
    (class 0: DC, value U << 4 | L; class 1: AC, value Kx).  The first
    component takes quantisation and entropy tables 0, the others 1."""
    planes = np.asarray(planes)
    if planes.ndim == 2:
        planes = planes[..., None]
    height, width, n = planes.shape
    sampling = sampling or [(1, 1)] * n
    max_h, max_v, mx, my, comps = _layout(width, height, sampling)
    qts = {}
    for ci, c in enumerate(comps):
        tq = min(ci, 1)
        qts.setdefault(tq, quant_table(LUMA_Q if tq == 0 else CHROMA_Q, quality))
        c.update(id=ci + 1, tq=tq, td=tq, ta=tq)
        c["coef"] = _blocks(component_plane(planes[..., ci], c, max_h, max_v), c["bw"], c["bh"],
                            qts[tq])
    out = b"\xff\xd8" + (JFIF if transform is None and n == 3 else adobe(transform)
                          if transform is not None else b"")
    dqt = b"".join(bytes([tq]) + bytes(int(x) for x in q[NATURAL]) for tq, q in sorted(qts.items()))
    out += marker(0xDB, dqt)
    progressive = script is not None
    sof = (0xCA if progressive else 0xC9) if arithmetic else 0xC1
    out += marker(sof, struct.pack(">BHHB", 8, height, width, n) + b"".join(
        bytes([c["id"], (c["h"] << 4) | c["v"], c["tq"]]) for c in comps))
    dc_lu = {t: (0, 1) for t in range(16)}
    ac_k = {t: 5 for t in range(16)}
    if dac:
        for (tc, tb), val in dac.items():
            if tc == 0:
                dc_lu[tb] = (val & 15, val >> 4)
            else:
                ac_k[tb] = val
        out += marker(0xCC, b"".join(bytes([(tc << 4) | tb, val])
                                     for (tc, tb), val in sorted(dac.items())))
    if restart:
        out += marker(0xDD, struct.pack(">H", restart))
    if progressive:
        scans = [(tuple(range(n)) if cs is None else cs, ss, se, ah, al)
                 for cs, ss, se, ah, al in script]
    elif interleave:
        scans = [(tuple(range(n)), 0, 63, 0, 0)]
    else:
        scans = [((ci,), 0, 63, 0, 0) for ci in range(n)]
    for scan_comps, ss, se, ah, al in scans:
        sos = marker(0xDA, bytes([len(scan_comps)]) + b"".join(
            bytes([comps[ci]["id"], (comps[ci]["td"] << 4) | comps[ci]["ta"]])
            for ci in scan_comps) + bytes([ss, se, (ah << 4) | al]))
        if arithmetic:
            out += sos + _arith_scan(comps, scan_comps, mx, my, restart, ss, se, ah, al,
                                     progressive, dc_lu, ac_k)
        else:
            dht, data = _huffman_sequential(comps, scan_comps, mx, my, restart)
            out += marker(0xC4, dht) + sos + data
    return out + b"\xff\xd9"


def _huffman_sequential(comps, scan_comps, mx, my, restart):
    events, pred = [], {ci: 0 for ci in scan_comps}
    for ev in _each_block(comps, scan_comps, mx, my, restart):
        if ev[0] == "rst":
            events.append(ev)
            pred = {ci: 0 for ci in scan_comps}
            continue
        _, ci, bx, by = ev
        c = comps[ci]
        blk = c["coef"][by, bx]
        zz = blk[NATURAL]
        s, extra = _category(int(zz[0]) - pred[ci])
        pred[ci] = int(zz[0])
        events.append(("sym", (0, c["td"]), s, extra, s))
        run = 0
        last = max([k for k in range(1, 64) if zz[k]], default=0)
        for k in range(1, last + 1):
            if zz[k] == 0:
                run += 1
                continue
            while run > 15:
                events.append(("sym", (1, c["ta"]), 0xF0, 0, 0))
                run -= 16
            s, extra = _category(int(zz[k]))
            events.append(("sym", (1, c["ta"]), (run << 4) | s, extra, s))
            run = 0
        if last < 63:
            events.append(("sym", (1, c["ta"]), 0x00, 0, 0))
    keys = {(0, comps[ci]["td"]) for ci in scan_comps} | {(1, comps[ci]["ta"]) for ci in scan_comps}
    return _huffman_scan(events, keys)


def _arith_scan(comps, scan_comps, mx, my, restart, ss, se, ah, al, progressive, dc_lu,
                ac_k) -> bytes:
    sc = _ArithScan([comps[ci] for ci in scan_comps], ss, se, ah, al, dc_lu, ac_k)
    local = {ci: i for i, ci in enumerate(scan_comps)}
    for ev in _each_block(comps, scan_comps, mx, my, restart):
        if ev[0] == "rst":
            sc.restart(ev[1])
            continue
        _, ci, bx, by = ev
        blk = comps[ci]["coef"][by, bx]
        i = local[ci]
        if not progressive:
            sc.dc(i, int(blk[0]))
            sc.ac(i, blk, 1, 63, 0)
        elif ss == 0 and ah == 0:
            sc.dc(i, int(blk[0]) >> al)
        elif ss == 0:
            sc.dc_refine(int(blk[0]))
        elif ah == 0:
            sc.ac(i, blk, ss, se, al)
        else:
            sc.ac_refine(i, blk)
    return sc.finish()


# ---------------------------------------------------------------------- #
# lossless streams
# ---------------------------------------------------------------------- #
def _predict(p: np.ndarray, psv: int, first_rows: set, precision: int, pt: int) -> np.ndarray:
    """jdlossls.c's predictions of every sample of a plane (int64 values
    modulo 2^16): row 0 and each row after a restart take 2^(P-Pt-1) in
    column 0 and the left sample after it; other rows the sample above in
    column 0 and predictor ``psv`` after it."""
    h, w = p.shape
    ra = np.zeros_like(p)
    rb = np.zeros_like(p)
    rc = np.zeros_like(p)
    ra[:, 1:] = p[:, :-1]
    rb[1:] = p[:-1]
    rc[1:, 1:] = p[:-1, :-1]
    pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
            6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[psv].copy()
    pred[:, 0] = rb[:, 0]
    for r in first_rows:
        if r < h:
            pred[r, 1:] = p[r, :-1]
            pred[r, 0] = 1 << (precision - pt - 1)
    return pred


def component_size(width: int, height: int, sampling, ci: int) -> tuple[int, int]:
    """(rows, columns) of component ``ci``: jdinput.c's downsampled size."""
    max_h = max(h for h, _ in sampling)
    max_v = max(v for _, v in sampling)
    h, v = sampling[ci]
    return -(-height * v // max_v), -(-width * h // max_h)


def lossless_stream(samples, width: int, height: int, sampling=None, psv=1, pt=0, *,
                    restart_rows=0, interleave=True, transform=None, jfif=None, ids=None,
                    precision=8, sof=0xC3) -> bytes:
    """A lossless (SOF3) Huffman stream of ``samples``: one 2-D array per
    component of ``component_size`` samples, values modulo 2^16 (the
    decoder writes (value << pt) & 0xFF).  ``restart_rows``: a restart
    marker every that many MCU rows; ``psv``: the predictor, or one per
    scan; ``precision``, ``sof``: the frame header's precision and marker,
    for refusal tests."""
    samples = [np.asarray(s, np.int64) & 0xFFFF for s in samples]
    n = len(samples)
    sampling = sampling or [(1, 1)] * n
    ids = ids or list(range(1, n + 1))
    max_h = max(h for h, _ in sampling)
    max_v = max(v for _, v in sampling)
    comps = []
    for ci, ((h, v), s) in enumerate(zip(sampling, samples)):
        assert s.shape == component_size(width, height, sampling, ci), (s.shape, ci)
        comps.append(dict(id=ids[ci], h=h, v=v, dh=s.shape[0], dw=s.shape[1], plane=s))
    if interleave and n > 1:
        scans = [tuple(range(n))]
    else:
        scans = [(ci,) for ci in range(n)]
    out = b"\xff\xd8"
    if jfif or (jfif is None and transform is None and n == 3):
        out += JFIF
    if transform is not None:
        out += adobe(transform)
    out += marker(sof, struct.pack(">BHHB", precision, height, width, n) + b"".join(
        bytes([c["id"], (c["h"] << 4) | c["v"], 0]) for c in comps))
    psvs = list(psv) if isinstance(psv, (list, tuple)) else [psv] * len(scans)
    for scan, psv in zip(scans, psvs):
        if len(scan) == 1:
            c = comps[scan[0]]
            cols, rows, mcu_h = c["dw"], c["dh"], {scan[0]: (1, 1)}
        else:
            cols, rows = -(-width // max_h), -(-height // max_v)
            mcu_h = {ci: (comps[ci]["h"], comps[ci]["v"]) for ci in scan}
        interval = restart_rows * cols
        diffs = {}
        for ci in scan:
            c = comps[ci]
            fh, fv = mcu_h[ci]
            first = {r * fv for r in range(rows)
                     if r == 0 or (restart_rows and r % restart_rows == 0)}
            d = (c["plane"] - _predict(c["plane"], psv, first, precision, pt)) & 0xFFFF
            d = np.where(d >= 0x8000, d - 0x10000, d)
            # padding samples of whole MCUs: differences of 0
            diffs[ci] = np.pad(d, ((0, rows * fv - c["dh"]), (0, cols * fh - c["dw"])))
        events = []
        for m in range(cols * rows):
            if interval and m and m % interval == 0:
                events.append(("rst", (m // interval - 1) & 7))
            x, y = m % cols, m // cols
            for ci in scan:
                fh, fv = mcu_h[ci]
                for by in range(fv):
                    for bx in range(fh):
                        v = int(diffs[ci][y * fv + by, x * fh + bx])
                        s, extra = (16, 0) if v == -0x8000 else _category(v)
                        events.append(("sym", (0, ci), s, extra, 0 if s == 16 else s))
        if interval:
            out += marker(0xDD, struct.pack(">H", interval))
        dht, data = _huffman_scan(events, {(0, ci) for ci in scan})
        out += marker(0xC4, dht) + marker(0xDA, bytes([len(scan)]) + b"".join(
            bytes([comps[ci]["id"], ci << 4]) for ci in scan) + bytes([psv, 0, pt])) + data
    return out + b"\xff\xd9"


def rewrite_sof(data: bytes, marker: int) -> bytes:
    """The stream with its frame header's SOF marker replaced."""
    data = bytearray(data)
    i = next(i for i in range(2, len(data) - 1)
             if data[i] == 0xFF and data[i + 1] in (0xC0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA, 0xCB))
    data[i + 1] = marker
    return bytes(data)
