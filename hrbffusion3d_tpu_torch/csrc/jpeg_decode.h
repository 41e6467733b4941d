// JPEG decoder with no library: the colour of .klg logs and of TUM-layout
// sequences.
//
// Decodes what libjpeg-turbo decodes for Pillow, bit for bit: Huffman-coded
// 8-bit streams, sequential (SOF0 / SOF1) or progressive (SOF2), of 1 or 3
// components, sampling factors up to 2x2, restart intervals, non-interleaved
// scans.  Refuses arithmetic-coded, lossless, hierarchical, 12-bit and
// 4-component streams, a progressive stream whose first AC coefficients are
// not fully refined (libjpeg-turbo smooths those), and truncated or corrupt
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

// C interface for ctypes.  With ``rgb_out == NULL`` it writes the size to
// ``*w`` and ``*h``; else it decodes into ``rgb_out``, which holds
// (*h) * (*w) * 3 bytes of the size the first call returned.  Returns 0 on
// success; -1 with a NUL-terminated message in ``err`` (at most
// ``err_len`` bytes) on a stream it refuses.
int jpeg_decode(const uint8_t* data, size_t n, int* w, int* h, uint8_t* rgb_out,
                char* err, int err_len);

}  // extern "C"
