"""A numpy TIFF writer for the port's TIFF decoder tests: what Pillow cannot
write (predictor 2 or 3, big-endian files, old-style LZW, strips of a few
rows, tiles, planar configuration 2, samples of 1, 2 or 4 bits, fill order
2, extra samples, the forms the decoder refuses; BigTIFF, YCbCr data units
and JPEG-in-TIFF).

``encode(img, ...)`` writes one image: (H, W) grey or (H, W, S) of S
samples a pixel, of dtype uint8, uint16, int16, uint32, int32 or float32,
in byte order ``"II"`` or ``"MM"``, compression 1 (none), 5 (LZW,
new-style or ``old_lzw``), 8 / 32946 (deflate) or 32773 (PackBits),
predictor 1, 2 (horizontal differencing of each sample, with the samples
of a pixel as its stride) or 3 (floating point: byte planes, most
significant first, then byte differencing), ``rows_per_strip`` rows a
strip, or ``tile=(width, length)`` tiles (edge tiles padded with zeros);
``planar=2`` stores each sample as a plane of its own (its strips or tiles
after the previous plane's); ``bits`` below 8 packs uint8 samples that
many bits each, most significant first, each row padded to a byte;
``fill_order=2`` reverses the bits of every byte written (after
compression); ``colormap`` writes ColorMap (tag 320: the 16-bit reds, then
greens, then blues) and ``extra_samples`` ExtraSamples (tag 338).
``extra`` adds or replaces tags ({tag: (type, values)}), which is how the
refused forms are made.

It also writes the compressions Pillow reads through libtiff's other
codecs: 50000 (Zstandard, by the ``zstandard`` package, imported where it
is used), 34925 (LZMA: an ``.xz`` stream of Python's ``lzma``), the CCITT
codes of uint8 0 / 1 samples at ``bits=1`` (``fax``: 2, Modified Huffman
rows byte-aligned; 3, T.4 with an EOL before each row, 1D or 2D by
Group3Options bit 0 and byte-aligned EOLs by bit 2; 4, T.6 with its end of
block; 32771, Modified Huffman rows word-aligned), and 32809 (ThunderScan,
``thunderscan``, of 4-bit samples); ``compressor`` (raw strip bytes ->
compressed bytes) replaces the default of any compression."""

from __future__ import annotations

import lzma
import struct
import zlib

import numpy as np

SHORT, LONG, RATIONAL, UNDEFINED, LONG8 = 3, 4, 5, 7, 16
LZMA, ZSTD = 34925, 50000
_SAMPLE_FORMAT = {"u": 1, "i": 2, "f": 3}


def packbits(row: bytes) -> bytes:
    """PackBits of one row: runs of 3+ equal bytes as repeats, the rest as
    literals of at most 128 bytes."""
    out = bytearray()
    i, n = 0, len(row)
    while i < n:
        j = i
        while j + 1 < n and row[j + 1] == row[i] and j - i < 127:
            j += 1
        if j - i >= 2:
            out += bytes([(257 - (j - i + 1)) & 0xFF, row[i]])
            i = j + 1
            continue
        start = i
        while i < n and i - start < 128:
            if i + 2 < n and row[i] == row[i + 1] == row[i + 2]:
                break
            i += 1
        out += bytes([i - start - 1]) + row[start:i]
    return bytes(out)


def lzw(data: bytes, old_style: bool = False) -> bytes:
    """TIFF LZW: 9-12 bit codes, Clear 256 first and whenever the table is
    full, EOI 257 last.  New-style codes are packed most significant bit
    first and widen one code early (libtiff's encoder: once its next free
    code passes 511, 1023, 2047); old-style (``old_style``) least
    significant bit first and one code later."""
    codes, widths = [], []
    late = 1 if old_style else 0

    table = {bytes([b]): b for b in range(256)}
    nxt, nbits = 258, 9
    codes.append(256)
    widths.append(nbits)
    w = b""
    for b in data:
        wc = w + bytes([b])
        if wc in table:
            w = wc
            continue
        codes.append(table[w])
        widths.append(nbits)
        table[wc] = nxt
        nxt += 1
        if nxt >= (1 << nbits) + late and nbits < 12:
            nbits += 1
        if nxt >= 4094:
            codes.append(256)
            widths.append(nbits)
            table = {bytes([c]): c for c in range(256)}
            nxt, nbits = 258, 9
        w = bytes([b])
    if w:
        codes.append(table[w])
        widths.append(nbits)
        # the decoder adds an entry for this code too, and widens on it
        nxt += 1
        if nxt >= (1 << nbits) + late and nbits < 12:
            nbits += 1
    codes.append(257)
    widths.append(nbits)
    acc, nacc, out = 0, 0, bytearray()
    for c, wd in zip(codes, widths):
        if old_style:
            acc |= c << nacc
            nacc += wd
            while nacc >= 8:
                out.append(acc & 0xFF)
                acc >>= 8
                nacc -= 8
        else:
            acc = (acc << wd) | c
            nacc += wd
            while nacc >= 8:
                out.append((acc >> (nacc - 8)) & 0xFF)
                nacc -= 8
            acc &= (1 << nacc) - 1
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF if not old_style else acc & 0xFF)
    return bytes(out)


_REVERSED = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))


def _chunk_bytes(block: np.ndarray, predictor: int, order: str, bits: int) -> bytes:
    """One strip or tile ((rows, W, S) samples) after the predictor, as
    file bytes."""
    r, w, spp = block.shape
    if bits < 8:
        packed = np.packbits(np.unpackbits(block.reshape(r, w * spp, 1), axis=2)[..., 8 - bits:]
                             .reshape(r, w * spp * bits), axis=1)
        return packed.tobytes()
    dt = block.dtype.newbyteorder("<" if order == "II" else ">")
    if predictor == 1:
        return block.astype(dt).tobytes()
    if predictor == 2:
        u = block.view(np.dtype(f"u{block.dtype.itemsize}"))
        d = u.copy()
        d[:, 1:] = u[:, 1:] - u[:, :-1]
        return d.astype(d.dtype.newbyteorder("<" if order == "II" else ">")).tobytes()
    if predictor == 3:
        if spp != 1:
            raise ValueError("predictor 3 is written for one sample a pixel")
        rows = block[..., 0]
        b = rows.astype(rows.dtype.newbyteorder(">")).view(np.uint8)
        k = rows.dtype.itemsize
        planes = b.reshape(r, w, k).transpose(0, 2, 1).reshape(r, w * k)
        d = planes.copy()
        d[:, 1:] = planes[:, 1:] - planes[:, :-1]
        return d.tobytes()
    raise ValueError(predictor)


# ITU-T T.4 code words, most significant bit first: terminating codes of
# runs 0-63, make-up codes of 64-1728 and the extended ones of 1792-2560
WHITE_TERM = (
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 001000 000011 "
    "110100 110101 101010 101011 0100111 0001100 0001000 0010111 0000011 0000100 0101000 "
    "0101011 0010011 0100100 0011000 00000010 00000011 00011010 00011011 00010010 00010011 "
    "00010100 00010101 00010110 00010111 00101000 00101001 00101010 00101011 00101100 "
    "00101101 00000100 00000101 00001010 00001011 01010010 01010011 01010100 01010101 "
    "00100100 00100101 01011000 01011001 01011010 01011011 01001010 01001011 00110010 "
    "00110011 00110100").split()
WHITE_MAKEUP = (
    "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 01101000 01100111 "
    "011001100 011001101 011010010 011010011 011010100 011010101 011010110 011010111 "
    "011011000 011011001 011011010 011011011 010011000 010011001 010011010 011000 "
    "010011011").split()
BLACK_TERM = (
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 0000101 0000111 "
    "00000100 00000111 000011000 0000010111 0000011000 0000001000 00001100111 00001101000 "
    "00001101100 00000110111 00000101000 00000010111 00000011000 000011001010 000011001011 "
    "000011001100 000011001101 000001101000 000001101001 000001101010 000001101011 "
    "000011010010 000011010011 000011010100 000011010101 000011010110 000011010111 "
    "000001101100 000001101101 000011011010 000011011011 000001010100 000001010101 "
    "000001010110 000001010111 000001100100 000001100101 000001010010 000001010011 "
    "000000100100 000000110111 000000111000 000000100111 000000101000 000001011000 "
    "000001011001 000000101011 000000101100 000001011010 000001100110 000001100111").split()
BLACK_MAKEUP = (
    "0000001111 000011001000 000011001001 000001011011 000000110011 000000110100 "
    "000000110101 0000001101100 0000001101101 0000001001010 0000001001011 0000001001100 "
    "0000001001101 0000001110010 0000001110011 0000001110100 0000001110101 0000001110110 "
    "0000001110111 0000001010010 0000001010011 0000001010100 0000001010101 0000001011010 "
    "0000001011011 0000001100100 0000001100101").split()
EXT_MAKEUP = ("00000001000 00000001100 00000001101 000000010010 000000010011 000000010100 "
              "000000010101 000000010110 000000010111 000000011100 000000011101 000000011110 "
              "000000011111").split()
EOL = "000000000001"
_PASS, _HORIZ = "0001", "001"
_VERTICAL = {0: "1", 1: "011", 2: "000011", 3: "0000011", -1: "010", -2: "000010",
             -3: "0000010"}


def _span_codes(n: int, black: bool) -> list:
    """A run of ``n`` pixels as libtiff's putspan writes it: 2560 make-ups
    while 2624 or more remain, a make-up of the rest's multiple of 64, then
    the terminating code (a list of code words)."""
    term, makeup = (BLACK_TERM, BLACK_MAKEUP) if black else (WHITE_TERM, WHITE_MAKEUP)
    out = []
    while n >= 2624:
        out.append(EXT_MAKEUP[-1])
        n -= 2560
    if n >= 64:
        k = n >> 6
        out.append(makeup[k - 1] if k <= 27 else EXT_MAKEUP[k - 28])
        n -= 64 * k
    return out + [term[n]]


def _span(n: int, black: bool) -> str:
    return "".join(_span_codes(n, black))


def _changes(line: np.ndarray) -> list:
    """The changing elements of a line (a pixel of another colour than the
    one before it; white before the first), then the width twice."""
    w = len(line)
    prev = np.concatenate([[False], line[:-1]])
    return np.flatnonzero(line != prev).tolist() + [w, w]


def _row_1d_codes(line: np.ndarray) -> list:
    """A row's Modified Huffman code words, each with the lookup width of
    libtiff's table for it (white 12 bits, black 13)."""
    edges = [0] + _changes(line)[:-2] + [len(line)]
    if edges[1] == 0:
        edges = edges[1:]
        out = [(c, 12) for c in _span_codes(0, False)]
        black = True
    else:
        out, black = [], False
    for a, b in zip(edges[:-1], edges[1:]):
        out += [(c, 13 if black else 12) for c in _span_codes(b - a, black)]
        black = not black
    return out


def mh_row(line: np.ndarray) -> str:
    return "".join(c for c, _ in _row_1d_codes(line))


def _libtiff_word_resume(codes: list, cp: int, avail: int, odd: bool) -> tuple[int, int]:
    """Where libtiff's Fax3DecodeRLE goes on after a word-aligned row: its
    bit buffer loads a byte (two for a 13-bit lookup) while it holds fewer
    bits than a lookup's width, then drops its bits but a multiple of 16,
    and a byte more when it is empty at an odd address (``odd``: the strip
    starts at an odd file offset).  (bytes loaded, bits held) after the
    row."""
    for code, width in codes:
        for _ in range(2):
            if avail < width:
                cp, avail = cp + 1, avail + 8
        avail -= len(code)
    avail &= ~15
    if avail == 0 and (cp + odd) & 1:
        cp += 1
    return cp, avail


def _row_2d(line: np.ndarray, ref: np.ndarray) -> str:
    """T.4 two-dimensional coding of ``line`` against ``ref``: pass,
    vertical and horizontal modes."""
    w = len(line)
    cc, rc = _changes(line), _changes(ref)
    a0, black, out = -1, False, ""
    while True:
        a1 = next(p for p in cc if p > a0)
        b1 = next(p for p in rc if p > a0 and (p >= w or bool(ref[p]) != black))
        b2 = next((p for p in rc if p > b1), w)
        if b2 < a1:
            out += _PASS
            a0 = b2
        elif abs(a1 - b1) <= 3:
            out += _VERTICAL[a1 - b1]
            a0, black = a1, not black
        else:
            a2 = next((p for p in cc if p > a1), w)
            out += _HORIZ + _span(a1 - max(a0, 0), black) + _span(a2 - a1, not black)
            a0 = a2
        if a0 >= w:
            return out


def pack_bits(bits: str) -> bytes:
    bits += "0" * (-len(bits) % 8)
    return int(bits, 2).to_bytes(len(bits) // 8, "big") if bits else b""


def fax(block: np.ndarray, compression: int, options: int = 0, k: int = 2,
        rtc: bool = True, rlew: str = "libtiff", odd: bool = False) -> bytes:
    """(rows, W) 0 / 1 samples (1 black) in CCITT ``compression`` 2, 3, 4 or
    32771.  For 3, ``options`` is Group3Options (bit 0 2D, every ``k``-th
    row from the first 1D; bit 2 fill bits before each EOL so that it ends
    on a byte) and ``rtc`` ends the strip with six EOLs; 4 ends with its
    end of block (two EOLs).  32771 pads each row to where libtiff's
    decoder reads the next (``rlew="libtiff"``, ``_libtiff_word_resume``;
    ``odd`` for a strip at an odd file offset) or to 16 bits from the
    strip's start (``"words"``, which libtiff misreads where its bit
    buffer holds a byte past the row)."""
    rows = np.asarray(block) != 0
    out = ""
    ref = np.zeros(rows.shape[1], bool)
    cp = avail = 0
    for i, line in enumerate(rows):
        two_d = compression == 4 or (compression == 3 and options & 1 and i % k)
        if compression == 32771 and rlew == "libtiff":
            codes = _row_1d_codes(line)
            out += "".join(c for c, _ in codes)
            cp, avail = _libtiff_word_resume(codes, cp, avail, odd)
            out += "0" * (8 * cp - avail - len(out))
            ref = line
            continue
        code = _row_2d(line, ref) if two_d else mh_row(line)
        if compression == 3:
            if options & 4:
                out += "0" * (-(len(out) + 12) % 8)
            out += EOL + ("" if not options & 1 else "0" if two_d else "1")
        out += code
        if compression == 2:
            out += "0" * (-len(out) % 8)
        elif compression == 32771:
            out += "0" * (-len(out) % 16)
        ref = line
    if compression == 3 and rtc:
        out += (EOL + ("1" if options & 1 else "")) * 6
    elif compression == 4:
        out += EOL * 2
    return pack_bits(out)


def thunderscan(block: np.ndarray) -> bytes:
    """(rows, W) 4-bit samples as ThunderScan codes, each row on its own
    (its last pixel 0 before it): runs of the last pixel, three 2-bit or
    two 3-bit deltas (with skips), raw values, chosen by a seeded draw
    among those that fit."""
    rng = np.random.default_rng(0)
    two = {0: 0, 1: 1, 15: 3}
    three = {0: 0, 1: 1, 2: 2, 3: 3, 13: 5, 14: 6, 15: 7}
    out = bytearray()
    for row in np.asarray(block, np.uint8):
        w, i, last = len(row), 0, 0
        while i < w:
            n = 0
            while i + n < w and row[i + n] == last and n < 63:
                n += 1
            options = ["raw"]
            if n > 0:
                options.append("run")
            if (int(row[i]) - last) % 16 in two:
                options.append("two")
            if (int(row[i]) - last) % 16 in three:
                options.append("three")
            pick = options[rng.integers(len(options))]
            if pick == "run":
                out.append(n)
                i += n
            elif pick == "raw":
                out.append(0xC0 | int(row[i]))
                last = int(row[i])
                i += 1
            else:
                table, bits, count, skip = ((two, 2, 3, 2) if pick == "two" else (three, 3, 2, 4))
                codes = []
                while len(codes) < count and i < w and (int(row[i]) - last) % 16 in table:
                    if rng.random() < 0.15:
                        codes.append(skip)
                        continue
                    codes.append(table[(int(row[i]) - last) % 16])
                    last = int(row[i])
                    i += 1
                codes += [skip] * (count - len(codes))
                tag = 0x40 if pick == "two" else 0x80
                out.append(tag | sum(c << (bits * (count - 1 - j)) for j, c in enumerate(codes)))
    return bytes(out)


def _compress(raw: bytes, compression: int, row_bytes: int, old_lzw: bool,
              block: np.ndarray | None = None, fax_options: int = 0) -> bytes:
    if compression == 1:
        return raw
    if compression == 50000:
        import zstandard

        return zstandard.ZstdCompressor(level=3).compress(raw)
    if compression == 34925:
        return lzma.compress(raw, format=lzma.FORMAT_XZ)
    if compression in (2, 3, 4, 32771):
        return fax(block[..., 0], compression, fax_options)
    if compression == 32809:
        return thunderscan(block[..., 0])
    if compression == 5:
        return lzw(raw, old_lzw)
    if compression in (8, 32946):
        return zlib.compress(raw, 6)
    if compression == 32773:
        return b"".join(packbits(raw[i:i + row_bytes]) for i in range(0, len(raw), row_bytes))
    raise ValueError(compression)


def _units(block: np.ndarray, sub: tuple[int, int]) -> bytes:
    """A strip or tile of full-resolution (rows, W, 3) YCbCr as TIFF's
    subsampled data units: for each block of ``sub`` = (h, v) pixels, its
    h x v luma samples row by row, then the chroma of its top-left pixel;
    the blocks left to right, then down (edge blocks padded by repeating
    the last row and column)."""
    hs, vs = sub
    r, w, _ = block.shape
    pr, pw = -(-r // vs) * vs, -(-w // hs) * hs
    full = np.pad(block, ((0, pr - r), (0, pw - w), (0, 0)), mode="edge")
    y = full[..., 0].reshape(pr // vs, vs, pw // hs, hs).transpose(0, 2, 1, 3)
    y = y.reshape(pr // vs, pw // hs, vs * hs)
    c = full[::vs, ::hs, 1:]
    return np.concatenate([y, c], axis=2).astype(np.uint8).tobytes()


def encode(img: np.ndarray, order: str = "II", compression: int = 1, predictor: int = 1,
           rows_per_strip: int | None = None, old_lzw: bool = False, photometric: int = 1,
           extra: dict | None = None, tile: tuple[int, int] | None = None, planar: int = 1,
           bits: int | None = None, fill_order: int = 1, colormap=None,
           extra_samples=None, bigtiff: bool = False, subsampling=None,
           chunks: list | None = None, compressor=None, fax_options: int = 0) -> bytes:
    """``subsampling`` = (h, v) writes (H, W, 3) uint8 YCbCr as subsampled
    data units (photometric 6; tag 530 only if ``extra`` gives it);
    ``chunks`` gives the strips or tiles' bytes as they are (JPEG streams:
    ``img`` then only gives the shape and dtype); ``bigtiff`` writes a
    BigTIFF (``II+\\0`` / ``MM\\0+``, 8-byte counts and offsets, the
    strip or tile offsets as LONG8)."""
    img = np.asarray(img)
    samples = img[..., None] if img.ndim == 2 else img
    h, w, spp = samples.shape
    bits = 8 * img.dtype.itemsize if bits is None else bits
    planes = [samples[..., i:i + 1] for i in range(spp)] if planar == 2 else [samples]
    given = chunks
    chunks = []
    for plane in [] if given is not None else planes:
        if tile is None:
            rps = h if rows_per_strip is None else rows_per_strip
            blocks = [plane[y:y + rps] for y in range(0, h, rps)]
        else:
            tw, tl = tile
            blocks = []
            for y in range(0, h, tl):
                for x in range(0, w, tw):
                    b = np.zeros((tl, tw, plane.shape[2]), plane.dtype)
                    part = plane[y:y + tl, x:x + tw]
                    b[:part.shape[0], :part.shape[1]] = part
                    blocks.append(b)
        for b in blocks:
            if subsampling is not None:
                raw = _units(b, subsampling)
                row_bytes = len(raw) // -(-len(b) // subsampling[1])
            else:
                raw = _chunk_bytes(b, predictor, order, bits)
                row_bytes = len(raw) // len(b)
            data = (compressor(raw) if compressor is not None
                    else _compress(raw, compression, row_bytes, old_lzw, b, fax_options))
            chunks.append(data.translate(_REVERSED) if fill_order == 2 else data)
    if given is not None:
        chunks = list(given)
    tags = {256: (LONG, [w]), 257: (LONG, [h]), 258: (SHORT, [bits] * spp),
            259: (SHORT, [compression]), 262: (SHORT, [photometric]), 277: (SHORT, [spp]),
            284: (SHORT, [planar]),
            339: (SHORT, [_SAMPLE_FORMAT[img.dtype.kind]] * spp)}
    if tile is None:
        tags[278] = (LONG, [h if rows_per_strip is None else rows_per_strip])
        tags[279] = (LONG, [len(c) for c in chunks])
    else:
        tags[322] = (SHORT, [tile[0]])
        tags[323] = (SHORT, [tile[1]])
        tags[325] = (LONG, [len(c) for c in chunks])
    if predictor != 1:
        tags[317] = (SHORT, [predictor])
    if fill_order != 1:
        tags[266] = (SHORT, [fill_order])
    if compression == 3 and fax_options:
        tags[292] = (LONG, [fax_options])
    if colormap is not None:
        tags[320] = (SHORT, [int(v) for v in np.asarray(colormap).T.ravel()])
    if extra_samples is not None:
        tags[338] = (SHORT, list(extra_samples))
    tags.update(extra or {})
    return write(tags, chunks, 273 if tile is None else 324, order, bigtiff)


# the field types written: their struct formats
_FORMATS = {SHORT: "H", LONG: "I", RATIONAL: "II", UNDEFINED: "s", LONG8: "Q"}


def _field(e: str, typ: int, vals) -> bytes:
    if typ == UNDEFINED:
        return bytes(vals)
    if typ == RATIONAL:
        return b"".join(struct.pack(e + "II", *v) for v in vals)
    return struct.pack(e + _FORMATS[typ] * len(vals), *vals)


def write(tags: dict, chunks: list, offsets_tag: int = 273, order: str = "II",
          bigtiff: bool = False) -> bytes:
    """A TIFF of one image: ``tags`` ({tag: (type, values)}; RATIONAL values
    as (numerator, denominator) pairs, UNDEFINED as bytes), the
    ``chunks`` after the header, their offsets written as ``offsets_tag``
    (LONG, or LONG8 in a BigTIFF)."""
    e = "<" if order == "II" else ">"
    if bigtiff:
        head = (b"II+\x00" if order == "II" else b"MM\x00+") + struct.pack(e + "HH", 8, 0)
        head += b"\0" * 8
        inline, entry, count_fmt, off_fmt = 8, "HHQ", "Q", "Q"
    else:
        head = (b"II*\x00" if order == "II" else b"MM\x00*") + b"\0" * 4
        inline, entry, count_fmt, off_fmt = 4, "HHI", "H", "I"
    data = bytearray(head)
    offsets = []
    for c in chunks:
        offsets.append(len(data))
        data += c
        if len(data) % 2:
            data += b"\0"
    tags = dict(tags)
    tags[offsets_tag] = (LONG8 if bigtiff else LONG, offsets)
    # out-of-line values, then the IFD
    fields = {tag: _field(e, typ, vals) for tag, (typ, vals) in tags.items()}
    blobs = {}
    for tag in sorted(tags):
        if len(fields[tag]) > inline:
            blobs[tag] = len(data)
            data += fields[tag]
            if len(data) % 2:
                data += b"\0"
    ifd = len(data)
    data[len(head) - struct.calcsize(off_fmt):len(head)] = struct.pack(e + off_fmt, ifd)
    data += struct.pack(e + count_fmt, len(tags))
    for tag, (typ, vals) in sorted(tags.items()):
        field = (struct.pack(e + off_fmt, blobs[tag]) if tag in blobs
                 else fields[tag].ljust(inline, b"\0"))
        data += struct.pack(e + entry, tag, typ, len(vals)) + field
    data += b"\0" * struct.calcsize(off_fmt)
    return bytes(data)


def jpeg_tables(stream: bytes) -> tuple[bytes, bytes]:
    """(a tables-only stream of ``stream``'s DQT and DHT segments, the
    abbreviated stream left without them): the JPEGTables (tag 347) and
    strip or tile of a JPEG-in-TIFF file."""
    i, tables, rest = 2, b"\xff\xd8", b"\xff\xd8"
    while stream[i + 1] != 0xDA:
        n = (stream[i + 2] << 8) | stream[i + 3]
        if stream[i + 1] in (0xDB, 0xC4):
            tables += stream[i:i + 2 + n]
        else:
            rest += stream[i:i + 2 + n]
        i += 2 + n
    return tables + b"\xff\xd9", rest + stream[i:]

