// WebP lossless (VP8L, RFC 9649) and WebP alpha (ALPH) decoding with no
// library: the lossless colour and the alpha planes of WebP files, which the
// JAX package opens with Pillow (libwebp).  io/webp.py reads the RIFF
// container and hands this file a "VP8L" chunk's payload or an "ALPH"
// chunk's.
//
// VP8L, as libwebp's vp8l_dec.c reads it:
//   - the bit reader, least significant bit first; reading past the end of
//     the data is an error;
//   - prefix codes: the simple code (one or two symbols of 1 or 8 bits) and
//     the normal code (code-length code lengths in the order 17, 18, 0, 1,
//     2, 3, 4, 5, 16, 6, ..., 15; an optional count of lengths to read;
//     repeat codes 16, 17, 18 with 2, 3 and 7 extra bits), canonical codes
//     decoded through two-level tables; a code of one symbol takes no bits;
//     any other code must be complete (libwebp's BuildHuffmanTable);
//   - the entropy image: the meta prefix image of 2-9 bits a tile, its
//     group index in red and green, five codes a group (green with the
//     lengths and the colour cache, red, blue, alpha, distance);
//   - the colour cache of 1-11 bits, hashed by 0x1e35a7bd, every decoded
//     pixel inserted in order;
//   - LZ77 backward references: lengths and distances in prefix codes with
//     extra bits, the first 120 distance codes through the distance map
//     (a neighbourhood of (dx, dy) offsets, at least 1);
//   - the four transforms, each at most once, undone in the reverse of
//     their order: the predictor (14 modes per tile, its first row left and
//     first column top, the top-right of the last column the row's own
//     first pixel, Select's comparison, the clamped add-subtract full and
//     half with C's truncating division; modes 14 and 15 black), the
//     cross-colour transform (signed 3.5 multipliers, red to blue on the new
//     red), subtract-green, and colour indexing (the palette delta-coded,
//     entries past its size transparent black, 2, 4 and 16 colours bundled
//     8, 4 and 2 pixels a byte, least significant first).
//
// ALPH: the header byte (compression 0 raw or 1 VP8L, the filter, the
// pre-processing bits, reserved bits 0), a headerless VP8L stream of the
// frame's size whose green is the alpha, and the unfiltering of libwebp's
// dsp/filters.c: none, horizontal, vertical and gradient, row 0 predicted
// from the left (its first pixel from 0), column 0 from above, the
// gradient clipped to 0-255.  Pre-processing (level reduction) needs no
// decoding.

#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace hrbf_vp8l {
namespace {

constexpr int kNumLiteralCodes = 256;
constexpr int kNumLengthCodes = 24;
constexpr int kNumDistanceCodes = 40;
constexpr int kMaxCacheBits = 11;
constexpr int kRootBits = 8;
constexpr int kNumCodeLengthCodes = 19;
constexpr uint8_t kCodeLengthCodeOrder[kNumCodeLengthCodes] = {17, 18, 0, 1,  2,  3,  4,  5,  16, 6,
                                                               7,  8,  9, 10, 11, 12, 13, 14, 15};
// the distance map of RFC 9649 section 4.2.2: (dy << 4) | (8 - dx)
constexpr uint8_t kCodeToPlane[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a, 0x38, 0x05, 0x37,
    0x39, 0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04, 0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b,
    0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45, 0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56,
    0x5a, 0x23, 0x2d, 0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e, 0x78, 0x01, 0x77,
    0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e, 0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b,
    0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e, 0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e,
    0x30, 0x73, 0x7d, 0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70};

enum { GREEN = 0, RED, BLUE, ALPHA, DIST };
enum { PREDICTOR = 0, CROSS_COLOR, SUBTRACT_GREEN, COLOR_INDEXING };

struct Error {
  std::string why;
};

// least significant bit first; past the end of the data it reads zeros and
// ``eos()`` turns true
struct BitReader {
  const uint8_t* buf = nullptr;
  size_t len = 0, next = 0;
  uint64_t val = 0, consumed = 0;
  int nbits = 0;

  void init(const uint8_t* data, size_t n) {
    buf = data;
    len = n;
    next = 0;
    val = 0;
    consumed = 0;
    nbits = 0;
  }
  void fill() {
    while (nbits <= 56) {
      const uint64_t b = next < len ? buf[next] : 0;
      ++next;
      val |= b << nbits;
      nbits += 8;
    }
  }
  uint32_t peek(int n) {
    if (nbits < n) fill();
    return static_cast<uint32_t>(val & ((uint64_t{1} << n) - 1));
  }
  void skip(int n) {
    val >>= n;
    nbits -= n;
    consumed += static_cast<uint64_t>(n);
  }
  uint32_t read(int n) {
    if (n == 0) return 0;
    const uint32_t v = peek(n);
    skip(n);
    return v;
  }
  bool eos() const { return consumed > 8 * static_cast<uint64_t>(len); }
};

// A canonical prefix code as two-level tables: ``table[start + low 8
// bits]`` is a symbol and its length, or a pointer to a second-level table.
struct Codes {
  std::vector<uint32_t> table;  // bits 0-15 value, 16-23 length, bit 31 a second level
  int add(const int* lengths, int n);  // the code's start in ``table``; -1 when invalid
  static int decode(const std::vector<uint32_t>& table, int start, BitReader& br) {
    const uint32_t bits = br.peek(15);
    uint32_t e = table[start + (bits & ((1u << kRootBits) - 1))];
    if (e >> 31) {
      const int sub_bits = (e >> 16) & 0xff;
      const int offset = e & 0xffff;
      e = table[start + offset + ((bits >> kRootBits) & ((1u << sub_bits) - 1))];
    }
    br.skip((e >> 16) & 0xff);
    return e & 0xffff;
  }
};

int Codes::add(const int* lengths, int n) {
  int count[16] = {0};
  int n_symbols = 0, last = -1;
  for (int s = 0; s < n; ++s) {
    if (lengths[s] > 15) return -1;
    if (lengths[s] > 0) {
      ++count[lengths[s]];
      ++n_symbols;
      last = s;
    }
  }
  if (n_symbols == 0) return -1;
  const int start = static_cast<int>(table.size());
  if (n_symbols == 1) {  // one symbol: no bits
    table.insert(table.end(), 1u << kRootBits, static_cast<uint32_t>(last));
    return start;
  }
  // complete and not over-subscribed
  int left = 1;
  for (int len = 1; len <= 15; ++len) {
    left = 2 * left - count[len];
    if (left < 0) return -1;
  }
  if (left != 0) return -1;
  int next_code[16];
  next_code[1] = 0;
  for (int len = 1; len < 15; ++len) next_code[len + 1] = (next_code[len] + count[len]) << 1;
  // the reversed codes, and per root prefix the longest length under it
  std::vector<int> key(n, 0);
  int sub_len[1 << kRootBits] = {0};
  for (int s = 0; s < n; ++s) {
    const int len = lengths[s];
    if (!len) continue;
    int code = next_code[len]++, rev = 0;
    for (int i = 0; i < len; ++i) rev |= ((code >> (len - 1 - i)) & 1) << i;
    key[s] = rev;
    if (len > kRootBits) {
      int& m = sub_len[rev & ((1 << kRootBits) - 1)];
      if (len - kRootBits > m) m = len - kRootBits;
    }
  }
  table.resize(start + (1u << kRootBits), 0);
  int offset = 1 << kRootBits;
  for (int p = 0; p < (1 << kRootBits); ++p) {
    if (!sub_len[p]) continue;
    table[start + p] = (1u << 31) | (static_cast<uint32_t>(sub_len[p]) << 16) |
                       static_cast<uint32_t>(offset);
    offset += 1 << sub_len[p];
  }
  table.resize(start + offset, 0);
  for (int s = 0; s < n; ++s) {
    const int len = lengths[s];
    if (!len) continue;
    const uint32_t leaf = (static_cast<uint32_t>(len) << 16) | static_cast<uint32_t>(s);
    if (len <= kRootBits) {
      for (int k = key[s]; k < (1 << kRootBits); k += 1 << len) table[start + k] = leaf;
    } else {
      const uint32_t head = table[start + (key[s] & ((1 << kRootBits) - 1))];
      const int sub_bits = (head >> 16) & 0xff, sub = head & 0xffff;
      const int rest = key[s] >> kRootBits, rest_len = len - kRootBits;
      for (int k = rest; k < (1 << sub_bits); k += 1 << rest_len) table[start + sub + k] = leaf;
    }
  }
  return start;
}

int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

struct Transform {
  int type = 0, bits = 0, xsize = 0, ysize = 0;
  std::vector<uint32_t> data;
};

struct Decoder {
  BitReader br;
  Transform transforms[4];
  int n_transforms = 0;
  unsigned seen = 0;
  // statistics of the main image, for the tests: backward references and
  // colour cache hits
  int64_t n_copies = 0, n_cache = 0;
  int main_cache_bits = 0, main_meta_bits = 0;

  void fail(const std::string& why) { throw Error{why}; }

  int read_code(int alphabet, Codes& codes) {
    std::vector<int> lengths(alphabet > 256 ? alphabet : 256, 0);
    if (br.read(1)) {  // simple code
      const int n_symbols = br.read(1) + 1;
      const int first_bits = br.read(1) ? 8 : 1;
      lengths[br.read(first_bits)] = 1;
      if (n_symbols == 2) lengths[br.read(8)] = 1;
    } else {
      int cl_lengths[kNumCodeLengthCodes] = {0};
      const int n_codes = br.read(4) + 4;
      for (int i = 0; i < n_codes; ++i) cl_lengths[kCodeLengthCodeOrder[i]] = br.read(3);
      Codes cl;
      const int cl_start = cl.add(cl_lengths, kNumCodeLengthCodes);
      if (cl_start < 0) fail("invalid code-length code");
      int max_symbol = alphabet;
      if (br.read(1)) {
        const int length_bits = 2 + 2 * br.read(3);
        max_symbol = 2 + br.read(length_bits);
        if (max_symbol > alphabet) fail("code-length count past the alphabet");
      }
      int symbol = 0, prev = 8;
      while (symbol < alphabet) {
        if (max_symbol-- == 0) break;
        const int len = Codes::decode(cl.table, cl_start, br);
        if (len < 16) {
          lengths[symbol++] = len;
          if (len) prev = len;
        } else {
          static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
          int repeat = br.read(kExtra[len - 16]) + kOffset[len - 16];
          if (symbol + repeat > alphabet) fail("code-length repeat past the alphabet");
          const int value = len == 16 ? prev : 0;
          while (repeat-- > 0) lengths[symbol++] = value;
        }
      }
    }
    if (br.eos()) fail("the data ends inside a prefix code");
    const int start = codes.add(lengths.data(), alphabet);
    if (start < 0) fail("invalid prefix code (empty, incomplete or over-subscribed)");
    return start;
  }

  // one image of ``xsize`` x ``ysize``: its colour cache, its codes (with a
  // meta prefix image at ``level0``) and its pixels, before transforms
  std::vector<uint32_t> image_stream(int xsize, int ysize, bool level0) {
    int cache_bits = 0;
    if (br.read(1)) {
      cache_bits = br.read(4);
      if (cache_bits < 1 || cache_bits > kMaxCacheBits)
        fail("colour cache of " + std::to_string(cache_bits) + " bits (1-11 are read)");
    }
    int meta_bits = 0, meta_xsize = 0;
    std::vector<uint32_t> meta;
    int n_groups = 1;
    if (level0 && br.read(1)) {
      meta_bits = br.read(3) + 2;
      meta_xsize = subsample(xsize, meta_bits);
      meta = image_stream(meta_xsize, subsample(ysize, meta_bits), false);
      for (uint32_t& m : meta) {
        m = (m >> 8) & 0xffff;
        if (static_cast<int>(m) >= n_groups) n_groups = static_cast<int>(m) + 1;
      }
    }
    Codes codes;
    std::vector<int> starts(5 * static_cast<size_t>(n_groups));
    const int alphabets[5] = {kNumLiteralCodes + kNumLengthCodes +
                                  (cache_bits ? 1 << cache_bits : 0),
                              kNumLiteralCodes, kNumLiteralCodes, kNumLiteralCodes,
                              kNumDistanceCodes};
    for (int g = 0; g < n_groups; ++g)
      for (int j = 0; j < 5; ++j) starts[5 * g + j] = read_code(alphabets[j], codes);
    if (level0) {
      main_cache_bits = cache_bits;
      main_meta_bits = meta_bits;
    }
    return pixels(xsize, ysize, cache_bits, meta_bits, meta_xsize, meta, codes, starts, level0);
  }

  std::vector<uint32_t> pixels(int xsize, int ysize, int cache_bits, int meta_bits, int meta_xsize,
                               const std::vector<uint32_t>& meta, const Codes& codes,
                               const std::vector<int>& starts, bool level0) {
    const int64_t total = static_cast<int64_t>(xsize) * ysize;
    std::vector<uint32_t> data(static_cast<size_t>(total));
    std::vector<uint32_t> cache(cache_bits ? size_t{1} << cache_bits : 0, 0);
    const int shift = 32 - cache_bits;
    int64_t pos = 0, cached = 0;
    auto insert_up_to = [&](int64_t end) {
      for (; cached < end; ++cached) cache[(0x1e35a7bdu * data[cached]) >> shift] = data[cached];
    };
    const std::vector<uint32_t>& t = codes.table;
    while (pos < total) {
      int g = 0;
      if (meta_bits) {
        const int x = static_cast<int>(pos % xsize), y = static_cast<int>(pos / xsize);
        g = static_cast<int>(meta[(y >> meta_bits) * meta_xsize + (x >> meta_bits)]);
      }
      const int* s = &starts[5 * static_cast<size_t>(g)];
      const int code = Codes::decode(t, s[GREEN], br);
      if (code < kNumLiteralCodes) {
        const int red = Codes::decode(t, s[RED], br);
        const int blue = Codes::decode(t, s[BLUE], br);
        const int alpha = Codes::decode(t, s[ALPHA], br);
        data[pos++] = (static_cast<uint32_t>(alpha) << 24) | (red << 16) | (code << 8) | blue;
      } else if (code < kNumLiteralCodes + kNumLengthCodes) {
        const int length = copy_value(code - kNumLiteralCodes);
        const int dist_symbol = Codes::decode(t, s[DIST], br);
        const int dist_code = copy_value(dist_symbol);
        int64_t dist;
        if (dist_code > 120) {
          dist = dist_code - 120;
        } else {
          const int d = kCodeToPlane[dist_code - 1];
          dist = static_cast<int64_t>(d >> 4) * xsize + (8 - (d & 0xf));
          if (dist < 1) dist = 1;
        }
        if (br.eos()) break;
        if (pos < dist || total - pos < length)
          fail("backward reference of distance " + std::to_string(dist) + " and length " +
               std::to_string(length) + " at pixel " + std::to_string(pos) + " of " +
               std::to_string(total));
        for (int i = 0; i < length; ++i, ++pos) data[pos] = data[pos - dist];
        if (level0) ++n_copies;
      } else {
        const int key = code - (kNumLiteralCodes + kNumLengthCodes);
        if (key >= static_cast<int>(cache.size())) fail("colour cache code without a cache");
        insert_up_to(pos);
        data[pos++] = cache[key];
        if (level0) ++n_cache;
      }
      if (br.eos()) break;
      if (cache_bits) insert_up_to(pos);
    }
    if (br.eos())
      fail("the data ends at pixel " + std::to_string(pos) + " of " + std::to_string(total) +
           " of a " + std::to_string(xsize) + "x" + std::to_string(ysize) + " image");
    return data;
  }

  int copy_value(int symbol) {
    if (symbol < 4) return symbol + 1;
    const int extra = (symbol - 2) >> 1;
    const int offset = (2 + (symbol & 1)) << extra;
    return offset + static_cast<int>(br.read(extra)) + 1;
  }

  // the transforms and the main image of a stream whose size is known
  std::vector<uint32_t> decode(int width, int height) {
    int xsize = width;
    while (br.read(1)) {
      const int type = br.read(2);
      if (seen & (1u << type)) fail("transform " + std::to_string(type) + " appears twice");
      seen |= 1u << type;
      Transform& tr = transforms[n_transforms++];
      tr.type = type;
      tr.xsize = xsize;
      tr.ysize = height;
      if (type == PREDICTOR || type == CROSS_COLOR) {
        tr.bits = br.read(3) + 2;
        tr.data = image_stream(subsample(xsize, tr.bits), subsample(height, tr.bits), false);
      } else if (type == COLOR_INDEXING) {
        const int n_colors = br.read(8) + 1;
        tr.bits = n_colors > 16 ? 0 : n_colors > 4 ? 1 : n_colors > 2 ? 2 : 3;
        xsize = subsample(tr.xsize, tr.bits);
        std::vector<uint32_t> palette = image_stream(n_colors, 1, false);
        // delta-coded, byte for byte; the rest transparent black
        tr.data.assign(size_t{1} << (8 >> tr.bits), 0);
        tr.data[0] = palette[0];
        for (int i = 1; i < n_colors; ++i) {
          const uint32_t a = palette[i], b = tr.data[i - 1];
          tr.data[i] = (((a & 0xff00ff00u) + (b & 0xff00ff00u)) & 0xff00ff00u) |
                       (((a & 0x00ff00ffu) + (b & 0x00ff00ffu)) & 0x00ff00ffu);
        }
      }
    }
    if (br.eos()) fail("the data ends inside the transforms");
    std::vector<uint32_t> img = image_stream(xsize, height, true);
    for (int n = n_transforms - 1; n >= 0; --n) img = inverse(transforms[n], img);
    return img;
  }

  static std::vector<uint32_t> inverse(const Transform& tr, const std::vector<uint32_t>& in);
};

uint32_t add_pixels(uint32_t a, uint32_t b) {
  return (((a & 0xff00ff00u) + (b & 0xff00ff00u)) & 0xff00ff00u) |
         (((a & 0x00ff00ffu) + (b & 0x00ff00ffu)) & 0x00ff00ffu);
}
uint32_t average2(uint32_t a, uint32_t b) { return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b); }
uint32_t clip255(uint32_t a) { return a < 256 ? a : ~a >> 24; }
int sub3(int a, int b, int c) {
  const int pb = b - c, pa = a - c;
  return (pb < 0 ? -pb : pb) - (pa < 0 ? -pa : pa);
}
uint32_t select(uint32_t a, uint32_t b, uint32_t c) {  // a top, b left, c top-left
  const int pa_minus_pb = sub3(a >> 24, b >> 24, c >> 24) +
                          sub3((a >> 16) & 0xff, (b >> 16) & 0xff, (c >> 16) & 0xff) +
                          sub3((a >> 8) & 0xff, (b >> 8) & 0xff, (c >> 8) & 0xff) +
                          sub3(a & 0xff, b & 0xff, c & 0xff);
  return pa_minus_pb <= 0 ? a : b;
}
uint32_t clamped_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int v = static_cast<int>((c0 >> s) & 0xff) + static_cast<int>((c1 >> s) & 0xff) -
                  static_cast<int>((c2 >> s) & 0xff);
    out |= clip255(static_cast<uint32_t>(v)) << s;
  }
  return out;
}
uint32_t clamped_half(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t ave = average2(c0, c1);
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = (ave >> s) & 0xff, b = (c2 >> s) & 0xff;
    out |= clip255(static_cast<uint32_t>(a + (a - b) / 2)) << s;
  }
  return out;
}

uint32_t predict(int mode, const uint32_t* out, int x, int width) {
  const uint32_t L = out[x - 1];
  const uint32_t* top = out + x - width;
  switch (mode) {
    case 1: return L;
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return average2(average2(L, top[1]), top[0]);
    case 6: return average2(L, top[-1]);
    case 7: return average2(L, top[0]);
    case 8: return average2(top[-1], top[0]);
    case 9: return average2(top[0], top[1]);
    case 10: return average2(average2(L, top[-1]), average2(top[0], top[1]));
    case 11: return select(top[0], L, top[-1]);
    case 12: return clamped_full(L, top[0], top[-1]);
    case 13: return clamped_half(L, top[0], top[-1]);
    default: return 0xff000000u;  // 0, and 14 and 15
  }
}

std::vector<uint32_t> Decoder::inverse(const Transform& tr, const std::vector<uint32_t>& in) {
  const int width = tr.xsize, height = tr.ysize;
  std::vector<uint32_t> out(static_cast<size_t>(width) * height);
  if (tr.type == PREDICTOR) {
    const int tiles = subsample(width, tr.bits);
    for (int y = 0; y < height; ++y) {
      uint32_t* o = &out[static_cast<size_t>(y) * width];
      const uint32_t* i = &in[static_cast<size_t>(y) * width];
      for (int x = 0; x < width; ++x) {
        uint32_t pred;
        if (y == 0)
          pred = x == 0 ? 0xff000000u : o[x - 1];
        else if (x == 0)
          pred = o[x - width];
        else
          pred = predict((tr.data[(y >> tr.bits) * tiles + (x >> tr.bits)] >> 8) & 0xf, o, x,
                         width);
        o[x] = add_pixels(i[x], pred);
      }
    }
  } else if (tr.type == CROSS_COLOR) {
    const int tiles = subsample(width, tr.bits);
    for (int y = 0; y < height; ++y) {
      for (int x = 0; x < width; ++x) {
        const size_t k = static_cast<size_t>(y) * width + x;
        const uint32_t code = tr.data[(y >> tr.bits) * tiles + (x >> tr.bits)];
        const int8_t g2r = static_cast<int8_t>(code & 0xff);
        const int8_t g2b = static_cast<int8_t>((code >> 8) & 0xff);
        const int8_t r2b = static_cast<int8_t>((code >> 16) & 0xff);
        const uint32_t argb = in[k];
        const int8_t green = static_cast<int8_t>(argb >> 8);
        int new_red = (argb >> 16) & 0xff;
        int new_blue = argb & 0xff;
        new_red += (static_cast<int>(g2r) * green) >> 5;
        new_red &= 0xff;
        new_blue += (static_cast<int>(g2b) * green) >> 5;
        new_blue += (static_cast<int>(r2b) * static_cast<int8_t>(new_red)) >> 5;
        new_blue &= 0xff;
        out[k] = (argb & 0xff00ff00u) | (static_cast<uint32_t>(new_red) << 16) |
                 static_cast<uint32_t>(new_blue);
      }
    }
  } else if (tr.type == SUBTRACT_GREEN) {
    for (size_t k = 0; k < out.size(); ++k) {
      const uint32_t argb = in[k], green = (argb >> 8) & 0xff;
      uint32_t rb = argb & 0x00ff00ffu;
      rb += (green << 16) | green;
      out[k] = (argb & 0xff00ff00u) | (rb & 0x00ff00ffu);
    }
  } else {  // colour indexing
    const int bits_per_pixel = 8 >> tr.bits;
    const int per_byte = 1 << tr.bits;
    const int packed_width = subsample(width, tr.bits);
    const uint32_t mask = (1u << bits_per_pixel) - 1;
    for (int y = 0; y < height; ++y) {
      const uint32_t* src = &in[static_cast<size_t>(y) * packed_width];
      uint32_t* dst = &out[static_cast<size_t>(y) * width];
      uint32_t packed = 0;
      for (int x = 0; x < width; ++x) {
        if ((x & (per_byte - 1)) == 0) packed = (*src++ >> 8) & 0xff;
        dst[x] = tr.data[packed & mask];
        packed >>= bits_per_pixel;
      }
    }
  }
  return out;
}

void report(char* err, int err_len, const std::string& why) {
  if (err && err_len > 0) snprintf(err, static_cast<size_t>(err_len), "%s", why.c_str());
}

}  // namespace
}  // namespace hrbf_vp8l

extern "C" {

// Decodes the VP8L stream ``data`` (``n`` bytes: a "VP8L" chunk's payload
// from its 0x2f signature, and what follows it in its frame) of an image
// ``width`` x ``height`` (its header's) into ``rgba`` (R, G, B, A bytes a
// pixel).  ``stats`` (5 ints, or null) gets the transforms present (a
// bit each: predictor 1, cross-colour 2, subtract-green 4, colour indexing
// 8), the colour cache bits, the meta prefix bits, the backward references
// and the colour cache hits of the main image.  Returns 0; or -1 with a
// NUL-terminated message in ``err`` (at most ``err_len`` bytes).
int vp8l_decode(const uint8_t* data, size_t n, int width, int height, uint8_t* rgba, int* stats,
                char* err, int err_len) {
  using namespace hrbf_vp8l;
  try {
    Decoder dec;
    dec.br.init(data, n);
    if (n < 5 || dec.br.read(8) != 0x2f) throw Error{"VP8L signature 0x2f missing"};
    const int w = dec.br.read(14) + 1, h = dec.br.read(14) + 1;
    dec.br.read(1);  // alpha is used: a hint only
    const int version = dec.br.read(3);
    if (version != 0) throw Error{"VP8L version " + std::to_string(version) + " (0 is defined)"};
    if (w != width || h != height)
      throw Error{"VP8L image is " + std::to_string(w) + "x" + std::to_string(h) +
                  ", the caller expected " + std::to_string(width) + "x" + std::to_string(height)};
    const std::vector<uint32_t> img = dec.decode(width, height);
    for (size_t k = 0; k < img.size(); ++k) {
      const uint32_t argb = img[k];
      rgba[4 * k] = static_cast<uint8_t>(argb >> 16);
      rgba[4 * k + 1] = static_cast<uint8_t>(argb >> 8);
      rgba[4 * k + 2] = static_cast<uint8_t>(argb);
      rgba[4 * k + 3] = static_cast<uint8_t>(argb >> 24);
    }
    if (stats) {
      stats[0] = static_cast<int>(dec.seen);
      stats[1] = dec.main_cache_bits;
      stats[2] = dec.main_meta_bits;
      stats[3] = static_cast<int>(dec.n_copies);
      stats[4] = static_cast<int>(dec.n_cache);
    }
    return 0;
  } catch (const Error& e) {
    report(err, err_len, "VP8L: " + e.why);
    return -1;
  }
}

// Decodes the ALPH chunk payload ``data`` (``n`` bytes) of a frame
// ``width`` x ``height`` into ``alpha`` (one byte a pixel).  Returns 0; or
// -1 with a message in ``err``.
int webp_alpha_decode(const uint8_t* data, size_t n, int width, int height, uint8_t* alpha,
                      char* err, int err_len) {
  using namespace hrbf_vp8l;
  try {
    if (n <= 1) throw Error{"ALPH chunk of " + std::to_string(n) + " bytes: no data"};
    const int method = data[0] & 3, filter = (data[0] >> 2) & 3;
    const int pre = (data[0] >> 4) & 3, reserved = data[0] >> 6;
    if (method > 1 || pre > 1 || reserved != 0)
    {
      char why[96];
      snprintf(why, sizeof(why),
               "header byte 0x%02x: compression %d, pre-processing %d, reserved %d",
               data[0], method, pre, reserved);
      throw Error{why};
    }
    const size_t total = static_cast<size_t>(width) * height;
    if (method == 0) {
      if (n - 1 < total)
        throw Error{"ALPH raw data of " + std::to_string(n - 1) + " bytes, the frame needs " +
                    std::to_string(total)};
      memcpy(alpha, data + 1, total);
    } else {
      Decoder dec;
      dec.br.init(data + 1, n - 1);
      const std::vector<uint32_t> img = dec.decode(width, height);
      for (size_t k = 0; k < total; ++k) alpha[k] = static_cast<uint8_t>(img[k] >> 8);
    }
    // libwebp's unfilters, row by row in place
    if (filter != 0) {
      for (int y = 0; y < height; ++y) {
        uint8_t* out = alpha + static_cast<size_t>(y) * width;
        const uint8_t* prev = y ? out - width : nullptr;
        if (!prev || filter == 1) {
          uint8_t pred = prev ? prev[0] : 0;
          for (int x = 0; x < width; ++x) pred = out[x] = static_cast<uint8_t>(pred + out[x]);
        } else if (filter == 2) {
          for (int x = 0; x < width; ++x) out[x] = static_cast<uint8_t>(prev[x] + out[x]);
        } else {
          uint8_t top = prev[0], top_left = top, left = top;
          for (int x = 0; x < width; ++x) {
            top = prev[x];
            const int g = left + top - top_left;
            left = static_cast<uint8_t>(out[x] + ((g & ~0xff) == 0 ? g : g < 0 ? 0 : 255));
            top_left = top;
            out[x] = left;
          }
        }
      }
    }
    return 0;
  } catch (const Error& e) {
    report(err, err_len, "ALPH: " + e.why);
    return -1;
  }
}

}  // extern "C"
