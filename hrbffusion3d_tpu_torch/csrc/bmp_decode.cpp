// BMP run-length decoding with no library: the RLE8 and RLE4 colour of
// TUM-layout sequences and .klg logs, which the JAX package opens with
// Pillow.  io/bmp.py reads the headers and the palette; this file only
// expands the runs, a byte-serial loop that would cost tens of milliseconds
// a frame in Python.
//
// It is Pillow 12's BmpRleDecoder (BmpImagePlugin.py) statement for
// statement, quirks included:
//   - an encoded run is cut at the row's end; an absolute run is not (its
//     pixels run on into the next row);
//   - end of line pads the pixels so far to a whole number of rows (none
//     when they already are one); end of bitmap stops;
//   - a delta escape reads two bytes and then two more, and moves by the
//     second pair: right + up * width pixels of index 0;
//   - an RLE4 absolute run of n pixels reads n / 2 bytes (rounded down) and
//     gives two pixels a byte;
//   - after an absolute run the read position moves to an even offset of
//     the file (not of the pixel data);
//   - a pair or run cut short by the end of the file stops decoding.
// The caller sees how many pixels Pillow's loop produced; fewer than the
// image holds is Pillow's "not enough image data".

#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <string>
#include <vector>

extern "C" {

// Expands the runs of ``file`` (``n`` bytes) from offset ``start``: RLE4
// when ``rle4`` is 1, else RLE8, for an image ``width`` x ``height``.  The
// first width * height indices go to ``out`` (rows bottom to top, as
// stored) and their count before truncation to ``*produced``.  Returns 0;
// or -1 with a NUL-terminated message in ``err`` (at most ``err_len``
// bytes) where Pillow's decoder raises.
int bmp_rle_decode(const uint8_t* file, size_t n, size_t start, int rle4, int64_t width,
                   int64_t height, uint8_t* out, int64_t* produced, char* err, int err_len) {
  const int64_t dest = width * height;
  std::vector<uint8_t> data;
  data.reserve(static_cast<size_t>(dest));
  size_t pos = start;
  int64_t x = 0;
  // Python's fd.read(k): at most k bytes, fewer at the end of the file
  auto read = [&](size_t k, std::vector<uint8_t>* got) {
    got->clear();
    for (size_t i = 0; i < k && pos < n; ++i) got->push_back(file[pos++]);
  };
  std::vector<uint8_t> got;
  std::string why;
  while (static_cast<int64_t>(data.size()) < dest) {
    if (pos >= n) break;
    const int num_pixels_raw = file[pos++];
    if (pos >= n) break;
    const int byte = file[pos++];
    int64_t num_pixels = num_pixels_raw;
    if (num_pixels) {
      if (x + num_pixels > width) num_pixels = width - x > 0 ? width - x : 0;
      if (rle4) {
        const uint8_t first = static_cast<uint8_t>(byte >> 4), second = byte & 0x0F;
        for (int64_t i = 0; i < num_pixels; ++i) data.push_back(i % 2 == 0 ? first : second);
      } else {
        data.insert(data.end(), static_cast<size_t>(num_pixels), static_cast<uint8_t>(byte));
      }
      x += num_pixels;
    } else if (byte == 0) {  // end of line
      while (static_cast<int64_t>(data.size()) % width != 0) data.push_back(0);
      x = 0;
    } else if (byte == 1) {  // end of bitmap
      break;
    } else if (byte == 2) {  // delta: two bytes read, then the two used
      read(2, &got);
      if (got.size() < 2) break;
      read(2, &got);
      if (got.size() < 2) {
        why = "a delta escape ends with the file";
        break;
      }
      data.insert(data.end(), static_cast<size_t>(got[0] + got[1] * width), 0);
      x = static_cast<int64_t>(data.size()) % width;
    } else {  // absolute run
      const size_t byte_count = rle4 ? byte / 2 : byte;
      read(byte_count, &got);
      if (rle4) {
        for (uint8_t b : got) {
          data.push_back(b >> 4);
          data.push_back(b & 0x0F);
        }
      } else {
        data.insert(data.end(), got.begin(), got.end());
      }
      if (got.size() < byte_count) break;
      x += byte;
      if (pos % 2 != 0) ++pos;
    }
  }
  if (!why.empty()) {
    if (err && err_len > 0) snprintf(err, static_cast<size_t>(err_len), "%s", why.c_str());
    return -1;
  }
  const size_t keep = data.size() < static_cast<size_t>(dest) ? data.size()
                                                               : static_cast<size_t>(dest);
  for (size_t i = 0; i < keep; ++i) out[i] = data[i];
  *produced = static_cast<int64_t>(data.size());
  return 0;
}

}  // extern "C"
