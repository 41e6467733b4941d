// JPEG decoder with no library: the colour of .klg logs and of TUM-layout
// sequences.
//
// Decodes what libjpeg-turbo decodes for Pillow, bit for bit: 8-bit
// streams, Huffman- or arithmetic-coded, sequential (SOF0 / SOF1 / SOF9),
// progressive (SOF2 / SOF10; left unrefined too, smoothed as libjpeg-turbo
// smooths) or lossless (SOF3), of 1, 3 or 4 components (greyscale, RGB,
// YCbCr, CMYK, YCCK), sampling factors 1-4 in integer ratios, restart
// intervals, non-interleaved scans.  Refuses what Pillow refuses
// (hierarchical, arithmetic lossless, 12-bit and other precisions,
// fractional sampling, lossless YCbCr or YCCK) and truncated or corrupt
// data, with a message that names the reason; no partial image is ever
// returned.
#pragma once

#include <cstddef>
#include <cstdint>
#include <string>
#include <vector>

namespace hrbf_jpeg {

// Decodes ``data`` into ``rgb`` ((height, width, 3) bytes, rows top to
// bottom; a greyscale stream is replicated to its three channels).  Returns
// false, with the reason in ``err``, on a stream it refuses.
bool decode_rgb(const uint8_t* data, size_t n, int* width, int* height,
                std::vector<uint8_t>* rgb, std::string* err);

}  // namespace hrbf_jpeg

extern "C" {

// C interface for ctypes.  ``tables`` (``ntables`` bytes; none when 0) is a
// tables-only stream read before ``data``, as libtiff hands libjpeg a
// TIFF's JPEGTables.  ``form``: 0 gives RGB, what Pillow's
// ``convert("RGB")`` gives (greyscale replicated); 1 the components as
// stored, interleaved (no upsampling or colour conversion: every component
// at full resolution); 2 RGB from samples taken as YCbCr whatever the
// markers say.  With ``out == NULL`` it writes the width, height and
// component count to ``info[0..2]`` and each component's sampling factors
// to ``info[3 + 2c]``, ``info[4 + 2c]`` (11 ints); else it decodes into
// ``out``, which holds info[1] * info[0] * (form 1 ? info[2] : 3) bytes
// of the size the first call returned.  Returns 0 on success; -1 with a
// NUL-terminated message in ``err`` (at most ``err_len`` bytes) on a stream
// it refuses.
int jpeg_decode(const uint8_t* tables, size_t ntables, const uint8_t* data, size_t n,
                int form, int* info, uint8_t* out, char* err, int err_len);

}  // extern "C"
