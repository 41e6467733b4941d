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
refused forms are made."""

from __future__ import annotations

import struct
import zlib

import numpy as np

SHORT, LONG, RATIONAL, UNDEFINED, LONG8 = 3, 4, 5, 7, 16
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


def _compress(raw: bytes, compression: int, row_bytes: int, old_lzw: bool) -> bytes:
    if compression == 1:
        return raw
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
           chunks: list | None = None) -> bytes:
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
            data = _compress(raw, compression, row_bytes, old_lzw)
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

