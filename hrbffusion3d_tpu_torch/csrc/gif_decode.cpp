// GIF LZW decoding with no library: the first frame of the GIF colour (and
// depth) files that the JAX package opens with Pillow.  io/gif.py reads the
// screen, the palettes, the extensions and the image descriptor; this file
// expands the frame's LZW data, a code-serial loop that would cost tens of
// milliseconds a frame in Python.
//
// It is Pillow 12's ImagingGifDecode (src/libImaging/GifDecode.c)
// statement for statement, as Pillow runs it on a first frame (no
// transparent index skipped):
//   - codes of 1 + the minimum code size bits (0-12 accepted, a larger
//     size a configuration error), least significant bit first, from
//     sub-blocks of 1-255 bytes that are taken whole;
//   - clear and end codes; a first code after a clear above the clear code
//     is an error, a clear right after a clear does nothing;
//   - a code above the next free entry is an error, the next free entry
//     itself the previous string and its first byte;
//   - the code size grows when the entry just added is the size's last,
//     up to 12 bits; once the table holds 4096 entries nothing is added and
//     the size stays (a deferred clear);
//   - rows in order, or in the four interlace passes (every 8th row from
//     0, from 4, every 4th from 2, every 2nd from 1);
//   - decoding stops when the last pixel is written: what follows is not
//     read.
// Pillow stops on an end code, or at the end of the file, before the frame
// is full and then fails ("image file is truncated") when the file has no
// more data: both raise here, naming the pixel.

#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <string>

namespace {

constexpr int kGifBits = 12;
constexpr int kGifTable = 1 << kGifBits;
constexpr int kGifBuffer = 1 << kGifBits;

struct Error {
  std::string why;
};

}  // namespace

extern "C" {

// Expands the LZW data of a frame ``width`` x ``height`` that starts at
// ``start`` of ``file`` (``n`` bytes; the byte after the minimum code size
// ``bits``), rows in interlace order when ``interlace`` is 1, into ``out``
// (``height`` x ``width`` indices).  Returns 0; or -1 with a
// NUL-terminated message in ``err`` (at most ``err_len`` bytes).
int gif_lzw_decode(const uint8_t* file, size_t n, size_t start, int bits, int interlace,
                   int64_t width, int64_t height, uint8_t* out, char* err, int err_len) {
  try {
    if (bits < 0 || bits > kGifBits)
      throw Error{"LZW minimum code size " + std::to_string(bits) +
                  ": Pillow's codec configuration error (0-12 are read)"};
    if (width <= 0 || height <= 0) throw Error{"frame of zero size"};
    uint8_t data[kGifTable], buffer[kGifBuffer], single = 0;
    uint16_t link[kGifTable];
    const int clear = 1 << bits, end = clear + 1;
    int step = 1, pass = 0;
    if (interlace) {
      pass = 1;
      step = 8;
    }
    int64_t x = 0, y = 0;
    int next = 0, codesize = 0, codemask = 0, bufferindex = kGifBuffer;
    int lastdata = 0, lastcode = 0, blocksize = 0, bitcount = 0;
    uint32_t bitbuffer = 0;
    int state = 1;
    size_t pos = start;
    auto pixel_at = [&] { return std::to_string(y * width + x); };
    // the next row; false when the frame is full
    auto newline = [&]() -> bool {
      x = 0;
      y += step;
      while (y >= height) {
        switch (pass) {
          case 1: y = 4; pass = 2; break;
          case 2: step = 4; y = 2; pass = 3; break;
          case 3: step = 2; y = 1; pass = 0; break;
          default: return false;
        }
      }
      return true;
    };
    for (;;) {
      if (state == 1) {
        next = clear + 2;
        codesize = bits + 1;
        codemask = (1 << codesize) - 1;
        bufferindex = kGifBuffer;
        state = 2;
      }
      const uint8_t* p;
      int len;
      if (bufferindex < kGifBuffer) {  // the rest of the last string
        len = kGifBuffer - bufferindex;
        p = &buffer[bufferindex];
        bufferindex = kGifBuffer;
      } else {
        while (bitcount < codesize) {
          if (blocksize > 0) {
            bitbuffer |= static_cast<uint32_t>(file[pos++]) << bitcount;
            bitcount += 8;
            --blocksize;
          } else {  // a new sub-block, taken only whole
            if (pos >= n || n - pos < static_cast<size_t>(file[pos]) + 1)
              throw Error{"LZW data ends at pixel " + pixel_at() + " of " +
                          std::to_string(width * height) +
                          " (Pillow: image file is truncated)"};
            blocksize = file[pos++];
          }
        }
        int c = static_cast<int>(bitbuffer & static_cast<uint32_t>(codemask));
        bitbuffer >>= codesize;
        bitcount -= codesize;
        if (c == clear) {
          if (state != 2) state = 1;
          continue;
        }
        if (c == end)
          throw Error{"LZW end code at pixel " + pixel_at() + " of " +
                      std::to_string(width * height) + " (Pillow: image file is truncated)"};
        len = 1;
        p = &single;
        if (state == 2) {  // the first code after a clear: as is
          if (c > clear)
            throw Error{"LZW code " + std::to_string(c) + " after a clear code (Pillow: broken "
                        "data stream)"};
          lastdata = lastcode = c;
          state = 3;
        } else {
          const int thiscode = c;
          if (c > next)
            throw Error{"LZW code " + std::to_string(c) + " beyond the table's " +
                        std::to_string(next) + " entries (Pillow: broken data stream)"};
          if (c == next) {  // the previous string and its first byte
            if (bufferindex <= 0) throw Error{"LZW string too long (Pillow: broken data stream)"};
            buffer[--bufferindex] = static_cast<uint8_t>(lastdata);
            c = lastcode;
          }
          while (c >= clear) {  // the string, from its end
            if (bufferindex <= 0 || c >= kGifTable)
              throw Error{"LZW string too long (Pillow: broken data stream)"};
            buffer[--bufferindex] = data[c];
            c = link[c];
          }
          lastdata = c;
          if (next < kGifTable) {
            data[next] = static_cast<uint8_t>(c);
            link[next] = static_cast<uint16_t>(lastcode);
            if (next == codemask && codesize < kGifBits) {
              ++codesize;
              codemask = (1 << codesize) - 1;
            }
            ++next;
          }
          lastcode = thiscode;
        }
        single = static_cast<uint8_t>(lastdata);
      }
      for (int i = 0; i < len; ++i) {
        out[y * width + x] = p[i];
        if (++x >= width && !newline()) return 0;
      }
    }
  } catch (const Error& e) {
    if (err && err_len > 0) snprintf(err, static_cast<size_t>(err_len), "%s", e.why.c_str());
    return -1;
  }
}

}  // extern "C"
