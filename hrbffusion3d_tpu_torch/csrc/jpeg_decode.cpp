// JPEG decoder with no library (see jpeg_decode.h).
//
// The numbers follow libjpeg-turbo's C code, which is what Pillow decodes
// with (its SIMD paths give the same bytes):
//   - Huffman decoding (jdhuff.c): canonical codes, a lookahead table of
//     kLook bits and the maxcode / valoffset search for longer codes; the
//     DC prediction per component, reset at each scan and restart marker;
//   - progressive scans (jdphuff.c): DC first and refinement, AC first with
//     end-of-band runs, AC refinement with its correction bits, into a
//     whole-image coefficient buffer per component (jdcoefct.c), each
//     component's quantisation table latched at its first scan (jdinput.c
//     latch_quant_tables); the IDCT runs after the last scan;
//   - dequantisation and the ISLOW integer IDCT (jidctint.c: CONST_BITS 13,
//     PASS1_BITS 2), whose outputs index the range-limit table of
//     jdmaster.c's prepare_range_limit_table (values beyond +-512 of the
//     centre wrap rather than clamp, as there);
//   - "fancy" chroma upsampling (jdsample.c: h2v1, h1v2, h2v2 triangular
//     filters; box replication where the chroma plane is 2 samples wide or
//     less, as there), the plane's last row and column replicated past the
//     image's edge as jdmainct.c's context rows do;
//   - YCbCr -> RGB with jdcolor.c's fixed-point tables (SCALEBITS 16,
//     ONE_HALF rounding) and the colour-space rules of jdapimin.c: JFIF
//     means YCbCr, an Adobe APP14 marker's transform flag is honoured, else
//     the component ids decide.
// libjpeg-turbo warns and goes on where a stream is corrupt (a bad Huffman
// code, data that ends early, bytes before a marker, a progression that
// skips or repeats a bit); this decoder refuses each of those, so it never
// returns a partial or guessed image.  It also refuses a progressive image
// whose first AC coefficients are not fully refined after its last scan:
// libjpeg-turbo smooths such blocks (jdcoefct.c decompress_smooth_data),
// which this decoder does not reproduce.

#include "jpeg_decode.h"

#include <algorithm>
#include <cstdarg>
#include <cstdio>
#include <cstring>
#include <stdexcept>

namespace hrbf_jpeg {
namespace {

struct Refused : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] __attribute__((format(printf, 1, 2))) void refuse(const char* fmt, ...) {
  char buf[256];
  va_list args;
  va_start(args, fmt);
  vsnprintf(buf, sizeof buf, fmt, args);
  va_end(args);
  throw Refused(buf);
}

// jutils.c: jpeg_natural_order, zigzag index -> row-major index
constexpr int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

constexpr int kLook = 9;               // lookahead bits of the Huffman tables
constexpr size_t kMaxPixels = 1u << 28;

struct Huffman {
  bool defined = false;
  int n_symbols = 0;
  uint8_t vals[256] = {};
  int32_t maxcode[18] = {};
  int32_t valoffset[18] = {};
  uint8_t look_len[1 << kLook] = {};   // 0: the code is longer than kLook
  uint8_t look_sym[1 << kLook] = {};

  // jdhuff.c jpeg_make_d_derived_tbl
  void build(const uint8_t counts[17], const uint8_t* symbols, int n) {
    int size[257], code_of[257];
    int p = 0;
    for (int l = 1; l <= 16; ++l)
      for (int i = 0; i < counts[l]; ++i) size[p++] = l;
    size[p] = 0;
    n_symbols = n;
    int code = 0, si = size[0];
    p = 0;
    while (size[p]) {
      while (size[p] == si) code_of[p++] = code++;
      if (code >= (1 << si)) refuse("corrupt JPEG data: bad Huffman table");
      code <<= 1;
      ++si;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
      if (counts[l]) {
        valoffset[l] = p - code_of[p];
        p += counts[l];
        maxcode[l] = code_of[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    maxcode[17] = 0xFFFFF;
    memcpy(vals, symbols, n);
    memset(look_len, 0, sizeof look_len);
    p = 0;
    for (int l = 1; l <= kLook; ++l) {
      for (int i = 0; i < counts[l]; ++i, ++p) {
        int first = code_of[p] << (kLook - l);
        for (int c = 0; c < (1 << (kLook - l)); ++c) {
          look_len[first + c] = (uint8_t)l;
          look_sym[first + c] = symbols[p];
        }
      }
    }
    defined = true;
  }
};

// The entropy-coded bytes of one scan, most significant bit first.  Byte
// stuffing (0xFF 0x00) is undone and fill bytes (0xFF 0xFF ... 0x00) read as
// one 0xFF, as in jdhuff.c's jpeg_fill_bit_buffer.  At a marker, or at the
// end of the data, the buffer is topped up with zero bits that a lookahead
// may see but no code may consume: consuming one means the data ended
// before the scan did.
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int bits = 0;          // valid bits at the top of buf
  int fake = 0;          // how many of them are zero fill
  bool stopped = false;  // at a marker (p on its first 0xFF) or the end
  int scan = 0;

  BitReader(const uint8_t* begin, const uint8_t* stop, int scan_index)
      : p(begin), end(stop), scan(scan_index) {}

  void fill() {
    while (bits <= 56) {
      int c = 0;
      if (!stopped) {
        if (p >= end) {
          stopped = true;
        } else if (*p != 0xFF) {
          c = *p++;
        } else {
          const uint8_t* q = p + 1;
          while (q < end && *q == 0xFF) ++q;
          if (q < end && *q == 0) {
            c = 0xFF;
            p = q + 1;
          } else {
            stopped = true;
          }
        }
      }
      if (stopped) fake += 8;
      buf |= (uint64_t)c << (56 - bits);
      bits += 8;
    }
  }

  [[noreturn]] void ran_out() const {
    if (p >= end)
      refuse("truncated JPEG: the data ends inside the entropy-coded data of scan %d", scan);
    const uint8_t* q = p;
    while (q < end && *q == 0xFF) ++q;
    refuse("corrupt JPEG data: marker 0xFF%02X inside the entropy-coded data of scan %d, "
           "before its last MCU", q < end ? *q : 0, scan);
  }

  void skip(int n) {
    buf <<= n;
    bits -= n;
    if (bits < fake) ran_out();
  }

  int get(int n) {  // 1 <= n <= 16
    if (bits < n) fill();
    int v = (int)(buf >> (64 - n));
    skip(n);
    return v;
  }

  int decode(const Huffman& t) {
    if (bits < 16) fill();
    uint32_t look = (uint32_t)(buf >> (64 - kLook));
    int len = t.look_len[look];
    if (len) {
      int sym = t.look_sym[look];
      skip(len);
      return sym;
    }
    uint32_t code16 = (uint32_t)(buf >> 48);
    for (int l = kLook + 1; l <= 16; ++l) {
      int32_t code = (int32_t)(code16 >> (16 - l));
      if (code <= t.maxcode[l]) {
        skip(l);
        return t.vals[code + t.valoffset[l]];
      }
    }
    refuse("corrupt JPEG data: bad Huffman code in scan %d", scan);
  }

  // End of a restart interval or of the scan: the rest of the current byte
  // is padding; a whole byte left over, or any byte before the marker, is
  // data the scan did not account for.  Leaves p on the marker's first 0xFF.
  void align(const char* before) {
    int real = bits - fake;
    if (!stopped && real < 8) {
      // bytes not yet read up to the marker
      while (p < end && *p != 0xFF) {
        ++p;
        real += 8;
      }
    }
    if (real >= 8)
      refuse("corrupt JPEG data: %d extraneous bytes before %s in scan %d", real / 8, before,
             scan);
    if (p >= end) refuse("truncated JPEG: the data ends after scan %d's entropy-coded data", scan);
    buf = 0;
    bits = fake = 0;
    stopped = false;
  }

  // After align(): read RSTn and go on with the next interval.
  void restart(int n) {
    char name[16];
    snprintf(name, sizeof name, "RST%d", n);
    align(name);
    while (p < end && *p == 0xFF) ++p;
    if (p >= end) refuse("truncated JPEG: the data ends at a restart marker of scan %d", scan);
    if (*p != 0xD0 + n)
      refuse("corrupt JPEG data: marker 0xFF%02X where scan %d expects RST%d", *p, scan, n);
    ++p;
  }
};

// jdmaster.c prepare_range_limit_table: kSample[x] for x in [-256, 639]
// clamps to [0, 255]; kIdct[x & 1023] takes an IDCT output centred on 0.
struct RangeLimit {
  uint8_t table[5 * 256 + 128];
  const uint8_t* sample;
  const uint8_t* idct;
  RangeLimit() {
    uint8_t* t = table + 256;
    memset(table, 0, 256);
    for (int i = 0; i < 256; ++i) t[i] = (uint8_t)i;
    uint8_t* post = t + 128;
    for (int i = 128; i < 512; ++i) post[i] = 255;
    memset(post + 512, 0, 512 - 128);
    memcpy(post + 1024 - 128, t, 128);
    sample = t;
    idct = post;
  }
};

const RangeLimit& range_limit() {
  static const RangeLimit r;
  return r;
}

// jidctint.c jpeg_idct_islow
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
                  FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
                  FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + ((int64_t)1 << (n - 1))) >> n; }

void idct_islow(const int16_t* coef, const int32_t* quant, uint8_t* out, int stride) {
  const uint8_t* limit = range_limit().idct;
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const int32_t* q = quant + c;
    int* w = ws + c;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 && in[40] == 0 &&
        in[48] == 0 && in[56] == 0) {
      int dc = (int)((int64_t)in[0] * q[0] * (1 << kPass1Bits));
      for (int r = 0; r < 8; ++r) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = (int64_t)in[16] * q[16], z3 = (int64_t)in[48] * q[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = (int64_t)in[0] * q[0];
    z3 = (int64_t)in[32] * q[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

    tmp0 = (int64_t)in[56] * q[56];
    tmp1 = (int64_t)in[40] * q[40];
    tmp2 = (int64_t)in[24] * q[24];
    tmp3 = (int64_t)in[8] * q[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;

    constexpr int s = kConstBits - kPass1Bits;
    w[0] = (int)descale(tmp10 + tmp3, s);
    w[56] = (int)descale(tmp10 - tmp3, s);
    w[8] = (int)descale(tmp11 + tmp2, s);
    w[48] = (int)descale(tmp11 - tmp2, s);
    w[16] = (int)descale(tmp12 + tmp1, s);
    w[40] = (int)descale(tmp12 - tmp1, s);
    w[24] = (int)descale(tmp13 + tmp0, s);
    w[32] = (int)descale(tmp13 - tmp0, s);
  }

  constexpr int s = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + (size_t)r * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 && w[6] == 0 &&
        w[7] == 0) {
      uint8_t dc = limit[(int)descale(w[0], kPass1Bits + 3) & 1023];
      for (int i = 0; i < 8; ++i) o[i] = dc;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = ((int64_t)w[0] + w[4]) * (1 << kConstBits);
    int64_t tmp1 = ((int64_t)w[0] - w[4]) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;

    o[0] = limit[(int)descale(tmp10 + tmp3, s) & 1023];
    o[7] = limit[(int)descale(tmp10 - tmp3, s) & 1023];
    o[1] = limit[(int)descale(tmp11 + tmp2, s) & 1023];
    o[6] = limit[(int)descale(tmp11 - tmp2, s) & 1023];
    o[2] = limit[(int)descale(tmp12 + tmp1, s) & 1023];
    o[5] = limit[(int)descale(tmp12 - tmp1, s) & 1023];
    o[3] = limit[(int)descale(tmp13 + tmp0, s) & 1023];
    o[4] = limit[(int)descale(tmp13 - tmp0, s) & 1023];
  }
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;  // blocks of the plane: whole MCUs
  int dw = 0, dh = 0;  // its samples inside the image (downsampled_width / height)
  int td = 0, ta = 0, pred = 0;
  bool scanned = false, latched = false;
  int32_t quant[64] = {};  // natural order, latched when its first scan starts
  std::vector<uint8_t> plane;
  // progressive frames: bw x bh blocks of 64 coefficients in natural order,
  // and per zigzag position the Al of the last scan that coded it (-1: none)
  std::vector<int16_t> coef;
  int coef_bits[64];
  int16_t* block(int bx, int by) { return coef.data() + ((size_t)by * bw + bx) * 64; }
  int stride() const { return bw * 8; }
  const uint8_t* row(int r) const {  // rows past the edge replicate it
    r = r < 0 ? 0 : (r >= dh ? dh - 1 : r);
    return plane.data() + (size_t)r * stride();
  }
};

inline int ceil_div(long a, long b) { return (int)((a + b - 1) / b); }

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t n) : pos_(data), end_(data + n) {}

  // Parses the stream; with ``size_only`` it stops after the frame header.
  void run(bool size_only) {
    if (end_ - pos_ < 2 || pos_[0] != 0xFF || pos_[1] != 0xD8)
      refuse("not a JPEG stream (no SOI marker)");
    pos_ += 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) break;                                // EOI
      if (m >= 0xD0 && m <= 0xD7) continue;                // RSTn outside a scan
      if (m == 0x01) continue;                             // TEM
      if (m == 0xD8) refuse("corrupt JPEG data: a second SOI marker");
      const uint8_t* seg = segment(m);
      size_t len = segment_len_;
      switch (m) {
        case 0xC0:
        case 0xC1:
        case 0xC2:
          progressive_ = m == 0xC2;
          frame_header(seg, len);
          if (size_only) return;
          break;
        case 0xC3:
          refuse("lossless JPEG (SOF3) is not supported");
        case 0xC5:
        case 0xC6:
        case 0xC7:
          refuse("hierarchical JPEG (SOF%d) is not supported", m - 0xC0);
        case 0xC9:
        case 0xCA:
        case 0xCB:
        case 0xCD:
        case 0xCE:
        case 0xCF:
          refuse("arithmetic-coded JPEG (SOF%d%s) is not supported", m - 0xC0,
                 m == 0xCA || m == 0xCE ? ", progressive"
                 : m == 0xCB || m == 0xCF ? ", lossless" : "");
        case 0xC4:
          huffman_tables(seg, len);
          break;
        case 0xDB:
          quant_tables(seg, len);
          break;
        case 0xDD:
          if (len != 2) refuse("corrupt JPEG data: DRI segment of %zu bytes", len);
          restart_interval_ = (seg[0] << 8) | seg[1];
          break;
        case 0xDA:
          if (!frame_) refuse("corrupt JPEG data: a scan before the frame header");
          if (size_only) return;
          scan(seg, len);
          break;
        case 0xE0:
          if (len >= 14 && !memcmp(seg, "JFIF\0", 5)) jfif_ = true;
          break;
        case 0xEE:
          if (len >= 12 && !memcmp(seg, "Adobe", 5)) {
            adobe_ = true;
            adobe_transform_ = seg[11];
          }
          break;
        case 0xDC:
          refuse("JPEG with a DNL marker (height given after the scan) is not supported");
        case 0xCC:  // DAC: arithmetic conditioning, unused by Huffman scans
          break;
        default:
          if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE) break;  // APPn, COM
          refuse("unsupported JPEG marker 0xFF%02X", m);
      }
    }
    if (!frame_) refuse("corrupt JPEG data: EOI before any frame header");
    if (size_only) return;
    for (int c = 0; c < ncomp_; ++c)
      if (!comp_[c].scanned)
        refuse("truncated JPEG: component %d has no scan before EOI", comp_[c].id);
    if (progressive_) finish_progressive();
  }

  int width() const { return width_; }
  int height() const { return height_; }

  void to_rgb(uint8_t* out) const {
    const size_t n = (size_t)width_ * height_;
    if (ncomp_ == 1) {
      const Component& c = comp_[0];
      for (int y = 0; y < height_; ++y) {
        const uint8_t* in = c.row(y);
        uint8_t* o = out + (size_t)y * width_ * 3;
        for (int x = 0; x < width_; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = in[x];
      }
      return;
    }
    std::vector<uint8_t> full[3];
    for (int c = 0; c < 3; ++c) full[c] = upsample(comp_[c]);
    const uint8_t* y = full[0].data();
    const uint8_t* cb = full[1].data();
    const uint8_t* cr = full[2].data();
    if (!ycc()) {
      for (size_t i = 0; i < n; ++i) {
        out[3 * i] = y[i];
        out[3 * i + 1] = cb[i];
        out[3 * i + 2] = cr[i];
      }
      return;
    }
    // jdcolor.c build_ycc_rgb_table / ycc_rgb_convert
    constexpr int kScale = 16;
    constexpr int64_t kHalf = (int64_t)1 << (kScale - 1);
    auto fix = [](double x) { return (int64_t)(x * (1L << kScale) + 0.5); };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = (int)((fix(1.40200) * x + kHalf) >> kScale);
      cb_b[i] = (int)((fix(1.77200) * x + kHalf) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kHalf;
    }
    const uint8_t* limit = range_limit().sample;
    for (size_t i = 0; i < n; ++i) {
      int yy = y[i], b = cb[i], r = cr[i];
      out[3 * i] = limit[yy + cr_r[r]];
      out[3 * i + 1] = limit[yy + (int)((cb_g[b] + cr_g[r]) >> kScale)];
      out[3 * i + 2] = limit[yy + cb_b[b]];
    }
  }

 private:
  const uint8_t* pos_;
  const uint8_t* end_;
  size_t segment_len_ = 0;
  bool frame_ = false, jfif_ = false, adobe_ = false, progressive_ = false;
  int adobe_transform_ = 0;
  int width_ = 0, height_ = 0, ncomp_ = 0, max_h_ = 1, max_v_ = 1, mcus_x_ = 0, mcus_y_ = 0;
  int restart_interval_ = 0, scans_ = 0;
  int eobrun_ = 0;  // blocks left in the current end-of-band run
  Component comp_[3];
  int32_t quant_[4][64] = {};
  bool quant_defined_[4] = {};
  Huffman dc_[4], ac_[4];

  int next_marker() {
    if (pos_ >= end_) refuse("truncated JPEG: the data ends before its EOI marker");
    if (*pos_ != 0xFF)
      refuse("corrupt JPEG data: byte 0x%02X where a marker was expected", *pos_);
    while (pos_ < end_ && *pos_ == 0xFF) ++pos_;
    if (pos_ >= end_) refuse("truncated JPEG: the data ends inside a marker");
    int m = *pos_++;
    if (m == 0) refuse("corrupt JPEG data: a stuffed byte where a marker was expected");
    return m;
  }

  const uint8_t* segment(int m) {
    if (end_ - pos_ < 2) refuse("truncated JPEG: the data ends inside marker 0xFF%02X", m);
    size_t len = (pos_[0] << 8) | pos_[1];
    if (len < 2) refuse("corrupt JPEG data: marker 0xFF%02X has length %zu", m, len);
    if ((size_t)(end_ - pos_) < len)
      refuse("truncated JPEG: the data ends inside the segment of marker 0xFF%02X", m);
    const uint8_t* seg = pos_ + 2;
    pos_ += len;
    segment_len_ = len - 2;
    return seg;
  }

  bool ycc() const {
    if (jfif_) return true;
    if (adobe_) return adobe_transform_ != 0;
    const int a = comp_[0].id, b = comp_[1].id, c = comp_[2].id;
    return !(a == 'R' && b == 'G' && c == 'B');
  }

  void frame_header(const uint8_t* s, size_t len) {
    if (frame_) refuse("corrupt JPEG data: a second frame header");
    if (len < 6) refuse("corrupt JPEG data: SOF segment of %zu bytes", len);
    int precision = s[0];
    height_ = (s[1] << 8) | s[2];
    width_ = (s[3] << 8) | s[4];
    ncomp_ = s[5];
    if (precision == 12) refuse("12-bit JPEG is not supported");
    if (precision != 8) refuse("%d-bit JPEG is not supported", precision);
    if (ncomp_ == 4) refuse("4-component (CMYK or YCCK) JPEG is not supported");
    if (ncomp_ != 1 && ncomp_ != 3) refuse("JPEG of %d components is not supported", ncomp_);
    if (len != 6 + 3 * (size_t)ncomp_)
      refuse("corrupt JPEG data: SOF segment of %zu bytes for %d components", len, ncomp_);
    if (height_ == 0)
      refuse("JPEG with a DNL marker (height given after the scan) is not supported");
    if (width_ == 0) refuse("corrupt JPEG data: width 0");
    if ((size_t)width_ * height_ > kMaxPixels)
      refuse("JPEG of %dx%d is larger than 2^28 pixels", width_, height_);
    for (int c = 0; c < ncomp_; ++c) {
      Component& k = comp_[c];
      k.id = s[6 + 3 * c];
      k.h = s[7 + 3 * c] >> 4;
      k.v = s[7 + 3 * c] & 15;
      k.tq = s[8 + 3 * c];
      if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4 || k.tq > 3)
        refuse("corrupt JPEG data: component %d has sampling %dx%d, table %d", k.id, k.h, k.v,
               k.tq);
      if (k.h > 2 || k.v > 2)
        refuse("JPEG sampling factors %dx%d are not supported (at most 2x2)", k.h, k.v);
      for (int o = 0; o < c; ++o)
        if (comp_[o].id == k.id) refuse("corrupt JPEG data: component id %d twice", k.id);
      max_h_ = std::max(max_h_, k.h);
      max_v_ = std::max(max_v_, k.v);
    }
    mcus_x_ = ceil_div(width_, 8 * max_h_);
    mcus_y_ = ceil_div(height_, 8 * max_v_);
    for (int c = 0; c < ncomp_; ++c) {
      Component& k = comp_[c];
      k.bw = mcus_x_ * k.h;
      k.bh = mcus_y_ * k.v;
      k.dw = ceil_div((long)width_ * k.h, max_h_);
      k.dh = ceil_div((long)height_ * k.v, max_v_);
      if (progressive_) {
        k.coef.assign((size_t)k.bw * k.bh * 64, 0);
        std::fill(k.coef_bits, k.coef_bits + 64, -1);
      }
    }
    frame_ = true;
  }

  void quant_tables(const uint8_t* s, size_t len) {
    size_t i = 0;
    while (i < len) {
      int pq = s[i] >> 4, tq = s[i] & 15;
      ++i;
      if (tq > 3 || pq > 1) refuse("corrupt JPEG data: DQT table %d of precision %d", tq, pq);
      size_t need = pq ? 128 : 64;
      if (len - i < need) refuse("corrupt JPEG data: DQT segment too short");
      for (int k = 0; k < 64; ++k)
        quant_[tq][kNatural[k]] = pq ? (s[i + 2 * k] << 8) | s[i + 2 * k + 1] : s[i + k];
      quant_defined_[tq] = true;
      i += need;
    }
  }

  void huffman_tables(const uint8_t* s, size_t len) {
    size_t i = 0;
    while (i < len) {
      if (len - i < 17) refuse("corrupt JPEG data: DHT segment too short");
      int tc = s[i] >> 4, th = s[i] & 15;
      if (tc > 1 || th > 3) refuse("corrupt JPEG data: DHT table class %d, index %d", tc, th);
      uint8_t counts[17] = {0};
      int n = 0;
      for (int l = 1; l <= 16; ++l) n += counts[l] = s[i + l];
      i += 17;
      if (n > 256 || len - i < (size_t)n)
        refuse("corrupt JPEG data: DHT table of %d symbols", n);
      (tc ? ac_ : dc_)[th].build(counts, s + i, n);
      i += n;
    }
  }

  void scan(const uint8_t* s, size_t len) {
    int ns = s[0];
    if (ns < 1 || ns > ncomp_ || len != 4 + 2 * (size_t)ns)
      refuse("corrupt JPEG data: SOS segment of %zu bytes for %d components", len, ns);
    const uint8_t* p = s + 1 + 2 * ns;
    const int ss = p[0], se = p[1], ah = p[2] >> 4, al = p[2] & 15;
    if (!progressive_ && (ss != 0 || se != 63 || ah != 0 || al != 0))
      refuse("corrupt JPEG data: a sequential scan with Ss=%d Se=%d Ah=%d Al=%d", ss, se, ah,
             al);
    const bool dc = ss == 0;
    // jdphuff.c start_pass_phuff_decoder's checks of the scan's parameters
    if (progressive_ && ((dc && se != 0) || (!dc && (ss > se || se > 63 || ns != 1)) ||
                         (ah != 0 && al != ah - 1) || al > 13))
      refuse("corrupt JPEG data: a progressive scan of %d components with Ss=%d Se=%d Ah=%d "
             "Al=%d", ns, ss, se, ah, al);
    // the Huffman tables the scan decodes with
    const bool need_dc = !progressive_ || (dc && ah == 0);
    const bool need_ac = !progressive_ || !dc;
    Component* in_scan[3];
    int blocks = 0;
    for (int i = 0; i < ns; ++i) {
      int id = s[1 + 2 * i], tables = s[2 + 2 * i];
      Component* k = nullptr;
      for (int c = 0; c < ncomp_; ++c)
        if (comp_[c].id == id) k = &comp_[c];
      if (!k) refuse("corrupt JPEG data: scan names component %d, not in the frame", id);
      for (int j = 0; j < i; ++j)
        if (in_scan[j] == k) refuse("corrupt JPEG data: component %d twice in a scan", id);
      if (!progressive_ && k->scanned) refuse("corrupt JPEG data: component %d in two scans", id);
      k->td = tables >> 4;
      k->ta = tables & 15;
      if (k->td > 3 || k->ta > 3 || (need_dc && !dc_[k->td].defined) ||
          (need_ac && !ac_[k->ta].defined))
        refuse("corrupt JPEG data: scan uses Huffman tables %d/%d, not defined", k->td, k->ta);
      if (need_dc)
        for (int j = 0; j < dc_[k->td].n_symbols; ++j)
          if (dc_[k->td].vals[j] > 15) refuse("corrupt JPEG data: bad DC Huffman table");
      if (!k->latched) {
        if (!quant_defined_[k->tq])
          refuse("corrupt JPEG data: quantisation table %d not defined", k->tq);
        memcpy(k->quant, quant_[k->tq], sizeof k->quant);
        k->latched = true;
      }
      if (progressive_) {
        if (!dc && k->coef_bits[0] < 0)
          refuse("corrupt JPEG data: an AC scan of component %d before its DC scan", id);
        for (int c = ss; c <= se; ++c) {
          if (ah != std::max(k->coef_bits[c], 0))
            refuse("corrupt JPEG data: scan %d refines coefficient %d of component %d from bit "
                   "%d, where the scans before left it at bit %d", scans_, c, id, ah,
                   std::max(k->coef_bits[c], 0));
          k->coef_bits[c] = al;
        }
      } else {
        k->plane.assign((size_t)k->bw * 8 * k->bh * 8, 0);
      }
      k->pred = 0;
      in_scan[i] = k;
      blocks += k->h * k->v;
    }
    if (ns > 1 && blocks > 10) refuse("corrupt JPEG data: %d blocks in an MCU", blocks);

    BitReader br(pos_, end_, scans_++);
    eobrun_ = 0;
    if (!progressive_) {
      int16_t coef[64];
      each_block(br, in_scan, ns, [&](Component& k, int bx, int by) {
        memset(coef, 0, sizeof coef);
        sequential_block(br, k, coef);
        idct_islow(coef, k.quant, k.plane.data() + (size_t)by * 8 * k.stride() + bx * 8,
                   k.stride());
      });
    } else if (dc && ah == 0) {
      each_block(br, in_scan, ns, [&](Component& k, int bx, int by) {
        k.pred += dc_diff(br, dc_[k.td]);
        k.block(bx, by)[0] = shifted(k.pred, al);
      });
    } else if (dc) {
      each_block(br, in_scan, ns, [&](Component& k, int bx, int by) {
        if (br.get(1)) k.block(bx, by)[0] |= (int16_t)(1 << al);
      });
    } else {
      const Huffman& ac = ac_[in_scan[0]->ta];
      each_block(br, in_scan, ns, [&](Component& k, int bx, int by) {
        if (ah == 0)
          ac_first(br, ac, k.block(bx, by), ss, se, al);
        else
          ac_refine(br, ac, k.block(bx, by), ss, se, al);
      });
    }
    br.align("the marker after the scan");
    pos_ = br.p;
    for (int i = 0; i < ns; ++i) in_scan[i]->scanned = true;
  }

  // Calls block(component, bx, by) for every block of the scan in the
  // stream's order, reading a restart marker between intervals (which
  // resets the DC predictions and the end-of-band run).  A scan of one
  // component covers its ceil(dw / 8) x ceil(dh / 8) blocks; an interleaved
  // scan covers whole MCUs, padding blocks included.
  template <class Block>
  void each_block(BitReader& br, Component* const* in_scan, int ns, Block&& block) {
    long mcus;
    int cols;
    if (ns == 1) {
      cols = ceil_div(in_scan[0]->dw, 8);
      mcus = (long)cols * ceil_div(in_scan[0]->dh, 8);
    } else {
      cols = mcus_x_;
      mcus = (long)mcus_x_ * mcus_y_;
    }
    int to_go = restart_interval_, next_rst = 0;
    for (long m = 0; m < mcus; ++m) {
      if (restart_interval_) {
        if (to_go == 0) {
          br.restart(next_rst);
          next_rst = (next_rst + 1) & 7;
          for (int i = 0; i < ns; ++i) in_scan[i]->pred = 0;
          eobrun_ = 0;
          to_go = restart_interval_;
        }
        --to_go;
      }
      int mx = (int)(m % cols), my = (int)(m / cols);
      if (ns == 1) {
        block(*in_scan[0], mx, my);
        continue;
      }
      for (int i = 0; i < ns; ++i) {
        Component& k = *in_scan[i];
        for (int by = 0; by < k.v; ++by)
          for (int bx = 0; bx < k.h; ++bx) block(k, mx * k.h + bx, my * k.v + by);
      }
    }
  }

  // jdhuff.c decode_mcu: one block of a sequential scan into ``coef``
  // (zeroed by the caller)
  void sequential_block(BitReader& br, Component& k, int16_t* coef) {
    k.pred += dc_diff(br, dc_[k.td]);
    coef[0] = (int16_t)k.pred;
    const Huffman& ac = ac_[k.ta];
    for (int i = 1; i < 64; ++i) {
      int rs = br.decode(ac);
      int run = rs >> 4, size = rs & 15;
      if (size) {
        i += run;
        if (i > 63) refuse("corrupt JPEG data: a coefficient past the 64th in scan %d", br.scan);
        coef[kNatural[i]] = (int16_t)extend(br.get(size), size);
      } else {
        if (run != 15) break;
        i += 15;
      }
    }
  }

  // the DC difference of one block (F.2.2.1)
  static int dc_diff(BitReader& br, const Huffman& t) {
    int size = br.decode(t);
    return size ? extend(br.get(size), size) : 0;
  }

  // jdphuff.c LEFT_SHIFT into a JCOEF
  static int16_t shifted(int v, int al) { return (int16_t)(uint32_t)((uint32_t)v << al); }

  // An end-of-band run of 2^r blocks plus r more bits, this block's included.
  void read_eobrun(BitReader& br, int r) { eobrun_ = (1 << r) + (r ? br.get(r) : 0); }

  // jdphuff.c decode_mcu_AC_first
  void ac_first(BitReader& br, const Huffman& ac, int16_t* blk, int ss, int se, int al) {
    if (eobrun_ > 0) {
      --eobrun_;
      return;
    }
    for (int i = ss; i <= se; ++i) {
      int rs = br.decode(ac);
      int r = rs >> 4, size = rs & 15;
      if (size) {
        i += r;
        if (i > se)
          refuse("corrupt JPEG data: a coefficient past the end of the band in scan %d", br.scan);
        blk[kNatural[i]] = shifted(extend(br.get(size), size), al);
      } else if (r == 15) {
        i += 15;
      } else {
        read_eobrun(br, r);
        --eobrun_;
        return;
      }
    }
  }

  // jdphuff.c decode_mcu_AC_refine: a correction bit for each coefficient
  // already nonzero, in band order, the new +-1 coefficients between them
  void ac_refine(BitReader& br, const Huffman& ac, int16_t* blk, int ss, int se, int al) {
    const int p1 = 1 << al, m1 = -p1;
    auto correct = [&](int16_t& c) {
      if (br.get(1) && (c & p1) == 0) c = (int16_t)(c + (c >= 0 ? p1 : m1));
    };
    int i = ss;
    if (eobrun_ == 0) {
      for (; i <= se; ++i) {
        int rs = br.decode(ac);
        int r = rs >> 4, size = rs & 15, value = 0;
        if (size) {
          if (size != 1)
            refuse("corrupt JPEG data: a refined coefficient of %d bits in scan %d", size,
                   br.scan);
          value = br.get(1) ? p1 : m1;
        } else if (r != 15) {
          read_eobrun(br, r);
          break;
        }
        // skip r zero coefficients (16 for ZRL), correcting the nonzero ones
        for (; i <= se; ++i) {
          int16_t& c = blk[kNatural[i]];
          if (c != 0)
            correct(c);
          else if (--r < 0)
            break;
        }
        if (value) {
          if (i > se)
            refuse("corrupt JPEG data: a coefficient past the end of the band in scan %d",
                   br.scan);
          blk[kNatural[i]] = (int16_t)value;
        }
      }
    }
    if (eobrun_ > 0) {
      for (; i <= se; ++i)
        if (blk[kNatural[i]] != 0) correct(blk[kNatural[i]]);
      --eobrun_;
    }
  }

  // After the last scan of a progressive frame: the IDCT of every block
  // inside each component's samples.  libjpeg-turbo smooths the blocks
  // (jdcoefct.c smoothing_ok) when any of the zigzag coefficients 1-9 of a
  // component is coarser than its last bit; that is refused here.
  void finish_progressive() {
    for (int c = 0; c < ncomp_; ++c) {
      Component& k = comp_[c];
      if (k.coef_bits[0] < 0)
        refuse("corrupt JPEG data: progressive JPEG with no DC scan of component %d", k.id);
      for (int z = 1; z < 10; ++z)
        if (k.coef_bits[z] != 0)
          refuse("progressive JPEG with coefficients not fully refined (component %d, "
                 "coefficient %d %s): libjpeg-turbo would smooth its blocks", k.id, z,
                 k.coef_bits[z] < 0 ? "never coded" : "coarse");
    }
    for (int c = 0; c < ncomp_; ++c) {
      Component& k = comp_[c];
      k.plane.assign((size_t)k.bw * 8 * k.bh * 8, 0);
      const int wb = ceil_div(k.dw, 8), hb = ceil_div(k.dh, 8);
      for (int by = 0; by < hb; ++by)
        for (int bx = 0; bx < wb; ++bx)
          idct_islow(k.block(bx, by), k.quant,
                     k.plane.data() + (size_t)by * 8 * k.stride() + bx * 8, k.stride());
      std::vector<int16_t>().swap(k.coef);
    }
  }

  // jdhuff.c HUFF_EXTEND
  static int extend(int x, int s) { return x < (1 << (s - 1)) ? x + (-(1 << s) + 1) : x; }

  // The component at the image's full resolution, width_ x height_
  // (jdsample.c: fullsize, h2v1 / h1v2 / h2v2 fancy, h2v1 / h2v2 box).
  std::vector<uint8_t> upsample(const Component& k) const {
    std::vector<uint8_t> out((size_t)width_ * height_);
    const int hx = max_h_ / k.h, vy = max_v_ / k.v;
    std::vector<uint8_t> row(2 * (size_t)k.dw + 2);
    std::vector<int> sum(k.dw);
    for (int y = 0; y < height_; ++y) {
      uint8_t* o = out.data() + (size_t)y * width_;
      if (hx == 1 && vy == 1) {
        memcpy(o, k.row(y), width_);
        continue;
      }
      if (vy == 1) {  // h2v1
        const uint8_t* in = k.row(y);
        if (k.dw > 2) {
          row[0] = in[0];
          row[1] = (uint8_t)((in[0] * 3 + in[1] + 2) >> 2);
          for (int i = 1; i < k.dw - 1; ++i) {
            int v = in[i] * 3;
            row[2 * i] = (uint8_t)((v + in[i - 1] + 1) >> 2);
            row[2 * i + 1] = (uint8_t)((v + in[i + 1] + 2) >> 2);
          }
          int last = k.dw - 1;
          row[2 * last] = (uint8_t)((in[last] * 3 + in[last - 1] + 1) >> 2);
          row[2 * last + 1] = in[last];
        } else {
          for (int i = 0; i < k.dw; ++i) row[2 * i] = row[2 * i + 1] = in[i];
        }
        memcpy(o, row.data(), width_);
        continue;
      }
      const int r = y / 2;
      const bool below = y & 1;
      const uint8_t* near = k.row(r);
      if (hx == 1) {  // h1v2
        const uint8_t* far = k.row(below ? r + 1 : r - 1);
        const int bias = below ? 2 : 1;
        for (int x = 0; x < width_; ++x) o[x] = (uint8_t)((near[x] * 3 + far[x] + bias) >> 2);
        continue;
      }
      if (k.dw <= 2) {  // h2v2 box
        for (int i = 0; i < k.dw; ++i) row[2 * i] = row[2 * i + 1] = near[i];
        memcpy(o, row.data(), width_);
        continue;
      }
      const uint8_t* far = k.row(below ? r + 1 : r - 1);  // h2v2 fancy
      for (int i = 0; i < k.dw; ++i) sum[i] = near[i] * 3 + far[i];
      row[0] = (uint8_t)((sum[0] * 4 + 8) >> 4);
      row[1] = (uint8_t)((sum[0] * 3 + sum[1] + 7) >> 4);
      for (int i = 1; i < k.dw - 1; ++i) {
        row[2 * i] = (uint8_t)((sum[i] * 3 + sum[i - 1] + 8) >> 4);
        row[2 * i + 1] = (uint8_t)((sum[i] * 3 + sum[i + 1] + 7) >> 4);
      }
      int last = k.dw - 1;
      row[2 * last] = (uint8_t)((sum[last] * 3 + sum[last - 1] + 8) >> 4);
      row[2 * last + 1] = (uint8_t)((sum[last] * 4 + 7) >> 4);
      memcpy(o, row.data(), width_);
    }
    return out;
  }
};

// The frame's size only (the markers up to SOF are parsed and checked).
bool read_size(const uint8_t* data, size_t n, int* width, int* height, std::string* err) {
  try {
    Decoder d(data, n);
    d.run(true);
    *width = d.width();
    *height = d.height();
    return true;
  } catch (const Refused& e) {
    *err = e.what();
  } catch (const std::bad_alloc&) {
    *err = "out of memory decoding a JPEG";
  }
  return false;
}

}  // namespace

bool decode_rgb(const uint8_t* data, size_t n, int* width, int* height,
                std::vector<uint8_t>* rgb, std::string* err) {
  try {
    Decoder d(data, n);
    d.run(false);
    rgb->resize((size_t)d.width() * d.height() * 3);
    d.to_rgb(rgb->data());
    *width = d.width();
    *height = d.height();
    return true;
  } catch (const Refused& e) {
    *err = e.what();
  } catch (const std::bad_alloc&) {
    *err = "out of memory decoding a JPEG";
  }
  return false;
}

}  // namespace hrbf_jpeg

extern "C" int jpeg_decode(const uint8_t* data, size_t n, int* w, int* h, uint8_t* rgb_out,
                           char* err, int err_len) {
  std::string msg;
  int width = 0, height = 0;
  if (!rgb_out) {
    if (hrbf_jpeg::read_size(data, n, &width, &height, &msg)) {
      *w = width;
      *h = height;
      return 0;
    }
  } else {
    std::vector<uint8_t> rgb;
    if (hrbf_jpeg::decode_rgb(data, n, &width, &height, &rgb, &msg)) {
      if (width == *w && height == *h) {
        memcpy(rgb_out, rgb.data(), rgb.size());
        return 0;
      }
      msg = "the JPEG stream's size changed between the two calls";
    }
  }
  if (err && err_len > 0) snprintf(err, (size_t)err_len, "%s", msg.c_str());
  return -1;
}
