// The TIFF strip codecs that live in files of their own, called by
// tiff_decode.cpp's one dispatch (``tiff_decompress``).  Each fills ``dst``
// with exactly ``dst_len`` bytes, as libtiff's codec fills a strip or
// tile, or returns false with the reason in ``err``.
#pragma once

#include <cstddef>
#include <cstdint>
#include <string>

namespace hrbf_tiff {

// Zstandard (compression 50000; zstd_decode.cpp): the strip's first frame,
// as libtiff's tif_zstd.c reads it through ZSTD_decompressStream.
bool zstd(const uint8_t* src, size_t n, uint8_t* dst, size_t dst_len, std::string* err);

// CCITT bilevel codes (fax_decode.cpp), as libtiff's tif_fax3.c decodes
// them: Modified Huffman rows byte-aligned (2) or word-aligned (32771,
// RLEW; ``odd`` when the strip starts at an odd file offset, since libtiff
// aligns the raw pointer), T.4 (3; ``options`` is Group3Options, bit 0 2D)
// and T.6 (4).  ``width`` pixels a row; rows of (width + 7) / 8 bytes,
// black 1.
bool fax(const uint8_t* src, size_t n, int compression, int64_t width, uint32_t options, bool odd,
         uint8_t* dst, size_t dst_len, std::string* err);

// ThunderScan 4-bit (32809; fax_decode.cpp), as tif_thunder.c decodes it.
bool thunderscan(const uint8_t* src, size_t n, int64_t width, uint8_t* dst, size_t dst_len,
                 std::string* err);

}  // namespace hrbf_tiff
