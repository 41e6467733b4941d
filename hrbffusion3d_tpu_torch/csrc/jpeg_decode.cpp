// JPEG decoder with no library (see jpeg_decode.h).
//
// The numbers follow libjpeg-turbo 3's C code, which is what Pillow decodes
// with (its SIMD paths give the same bytes):
//   - Huffman decoding (jdhuff.c): canonical codes, a lookahead table of
//     kLook bits and the maxcode / valoffset search for longer codes; the
//     DC prediction per component, reset at each scan and restart marker;
//   - progressive scans (jdphuff.c): DC first and refinement, AC first with
//     end-of-band runs, AC refinement with its correction bits, into a
//     whole-image coefficient buffer per component (jdcoefct.c), each
//     component's quantisation table latched at its first scan (jdinput.c
//     latch_quant_tables); the IDCT runs after the last scan;
//   - arithmetic coding (jdarith.c, jaricom.c), sequential and progressive:
//     the QM decoder and its state table, DC statistics conditioned by the
//     DAC segment's L / U (default 0 / 1), AC statistics split at its Kx
//     (default 5), statistics reset at each scan and restart marker;
//   - lossless (SOF3; jdlhuff.c, jddiffct.c, jdlossls.c): Huffman-coded
//     differences of categories 0-16, predictors 1-7 over samples modulo
//     2^16, the first row's predictor 2^(P-Pt-1) at the scan's start and
//     after each restart, the point transform;
//   - block smoothing of a progressive image whose zigzag coefficients 1-9
//     are not all known to their last bit (jdcoefct.c smoothing_ok and
//     decompress_smooth_data, libjpeg-turbo 2.1+'s 5x5 form);
//   - dequantisation and the ISLOW integer IDCT (jidctint.c: CONST_BITS 13,
//     PASS1_BITS 2), whose outputs index the range-limit table of
//     jdmaster.c's prepare_range_limit_table (values beyond +-512 of the
//     centre wrap rather than clamp, as there);
//   - upsampling as jdsample.c's jinit_upsampler picks it per component:
//     "fancy" h2v1, h1v2 and h2v2 triangular filters for a ratio of 2 (box
//     replication where the plane is 2 samples wide or less), replication
//     for any other integer ratio and for every ratio of a lossless frame
//     (no DCT scaling, so no fancy filter); the plane's last row and column
//     replicated past the image's edge as jdmainct.c's context rows do;
//   - colour (jdapimin.c default_decompress_parms; jdcolor.c): greyscale,
//     RGB, YCbCr -> RGB with fixed-point tables (SCALEBITS 16, ONE_HALF
//     rounding), CMYK and YCCK -> CMYK (ycck_cmyk_convert), then what
//     Pillow does with 4 channels: "CMYK;I" (inverted) and Convert.c's
//     cmyk2rgb.  JFIF means YCbCr, an Adobe APP14 marker's transform is
//     honoured, else the component ids decide (RGB by default when
//     lossless).
// It refuses what Pillow or libjpeg-turbo refuse: 12-bit and other
// precisions (lossless too), hierarchical frames (SOF5-7, SOF13-15),
// arithmetic-coded lossless (SOF11), fractional sampling ratios, more than
// 10 blocks in an MCU, a lossless restart interval that is not whole MCU
// rows, and lossless samples in YCbCr or YCCK (libjpeg-turbo converts no
// colour of lossless samples).  libjpeg-turbo warns and goes on where a
// stream is corrupt (a bad Huffman or arithmetic code, data that ends
// early, bytes before a marker, a progression that skips or repeats a
// bit); this decoder refuses each of those, so it never returns a partial
// or guessed image.

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

// jaricom.c jpeg_aritab: T.81 Table D.2 (Qe, the next index after an LPS
// and after an MPS, whether an LPS switches the MPS); index 113 is the
// fixed 0.5 estimate of T.851 (Table 5 of section 10.3)
struct QeEntry {
  uint16_t qe;
  uint8_t nlps, nmps, sw;
};
constexpr QeEntry kQe[114] = {
    {0x5a1d, 1, 1, 1},     {0x2586, 14, 2, 0},    {0x1114, 16, 3, 0},    {0x080b, 18, 4, 0},
    {0x03d8, 20, 5, 0},    {0x01da, 23, 6, 0},    {0x00e5, 25, 7, 0},    {0x006f, 28, 8, 0},
    {0x0036, 30, 9, 0},    {0x001a, 33, 10, 0},   {0x000d, 35, 11, 0},   {0x0006, 9, 12, 0},
    {0x0003, 10, 13, 0},   {0x0001, 12, 13, 0},   {0x5a7f, 15, 15, 1},   {0x3f25, 36, 16, 0},
    {0x2cf2, 38, 17, 0},   {0x207c, 39, 18, 0},   {0x17b9, 40, 19, 0},   {0x1182, 42, 20, 0},
    {0x0cef, 43, 21, 0},   {0x09a1, 45, 22, 0},   {0x072f, 46, 23, 0},   {0x055c, 48, 24, 0},
    {0x0406, 49, 25, 0},   {0x0303, 51, 26, 0},   {0x0240, 52, 27, 0},   {0x01b1, 54, 28, 0},
    {0x0144, 56, 29, 0},   {0x00f5, 57, 30, 0},   {0x00b7, 59, 31, 0},   {0x008a, 60, 32, 0},
    {0x0068, 62, 33, 0},   {0x004e, 63, 34, 0},   {0x003b, 32, 35, 0},   {0x002c, 33, 9, 0},
    {0x5ae1, 37, 37, 1},   {0x484c, 64, 38, 0},   {0x3a0d, 65, 39, 0},   {0x2ef1, 67, 40, 0},
    {0x261f, 68, 41, 0},   {0x1f33, 69, 42, 0},   {0x19a8, 70, 43, 0},   {0x1518, 72, 44, 0},
    {0x1177, 73, 45, 0},   {0x0e74, 74, 46, 0},   {0x0bfb, 75, 47, 0},   {0x09f8, 77, 48, 0},
    {0x0861, 78, 49, 0},   {0x0706, 79, 50, 0},   {0x05cd, 48, 51, 0},   {0x04de, 50, 52, 0},
    {0x040f, 50, 53, 0},   {0x0363, 51, 54, 0},   {0x02d4, 52, 55, 0},   {0x025c, 53, 56, 0},
    {0x01f8, 54, 57, 0},   {0x01a4, 55, 58, 0},   {0x0160, 56, 59, 0},   {0x0125, 57, 60, 0},
    {0x00f6, 58, 61, 0},   {0x00cb, 59, 62, 0},   {0x00ab, 61, 63, 0},   {0x008f, 61, 32, 0},
    {0x5b12, 65, 65, 1},   {0x4d04, 80, 66, 0},   {0x412c, 81, 67, 0},   {0x37d8, 82, 68, 0},
    {0x2fe8, 83, 69, 0},   {0x293c, 84, 70, 0},   {0x2379, 86, 71, 0},   {0x1edf, 87, 72, 0},
    {0x1aa9, 87, 73, 0},   {0x174e, 72, 74, 0},   {0x1424, 72, 75, 0},   {0x119c, 74, 76, 0},
    {0x0f6b, 74, 77, 0},   {0x0d51, 75, 78, 0},   {0x0bb6, 77, 79, 0},   {0x0a40, 77, 48, 0},
    {0x5832, 80, 81, 1},   {0x4d1c, 88, 82, 0},   {0x438e, 89, 83, 0},   {0x3bdd, 90, 84, 0},
    {0x34ee, 91, 85, 0},   {0x2eae, 92, 86, 0},   {0x299a, 93, 87, 0},   {0x2516, 86, 71, 0},
    {0x5570, 88, 89, 1},   {0x4ca9, 95, 90, 0},   {0x44d9, 96, 91, 0},   {0x3e22, 97, 92, 0},
    {0x3824, 99, 93, 0},   {0x32b4, 99, 94, 0},   {0x2e17, 93, 86, 0},   {0x56a8, 95, 96, 1},
    {0x4f46, 101, 97, 0},  {0x47e5, 102, 98, 0},  {0x41cf, 103, 99, 0},  {0x3c3d, 104, 100, 0},
    {0x375e, 99, 93, 0},   {0x5231, 105, 102, 0}, {0x4c0f, 106, 103, 0}, {0x4639, 107, 104, 0},
    {0x415e, 103, 99, 0},  {0x5627, 105, 106, 1}, {0x50e7, 108, 107, 0}, {0x4b85, 109, 103, 0},
    {0x5597, 110, 109, 0}, {0x504f, 111, 107, 0}, {0x5a10, 110, 111, 1}, {0x5522, 112, 109, 0},
    {0x59eb, 112, 111, 1}, {0x5a1d, 113, 113, 0}};

// The entropy-coded bytes of one arithmetic-coded scan or restart
// interval, decoded as jdarith.c's arith_decode does: byte stuffing undone,
// and once a marker is met the decoder reads zeros, which is legal there
// (the encoder drops trailing zero bytes).  Data that ends with no marker
// is refused.
struct ArithReader {
  const uint8_t* p;
  const uint8_t* end;
  const uint8_t* marker = nullptr;  // the first 0xFF of the marker met
  int64_t c = 0, a = 0;
  int ct = -16;  // reads 2 bytes before the first decision
  int scan;

  ArithReader(const uint8_t* begin, const uint8_t* stop, int scan_index)
      : p(begin), end(stop), scan(scan_index) {}

  int byte() {
    if (p >= end)
      refuse("truncated JPEG: the data ends inside the entropy-coded data of scan %d", scan);
    return *p++;
  }

  // jdarith.c arith_decode: one binary decision with the statistics bin
  // ``st`` (the MPS in bit 7, the Qe index below it)
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        int data = 0;
        if (!marker) {
          const uint8_t* at = p;
          data = byte();
          if (data == 0xFF) {
            do data = byte();
            while (data == 0xFF);
            if (data == 0) {
              data = 0xFF;
            } else {
              marker = at;
              data = 0;
            }
          }
        }
        c = (c << 8) | data;
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;  // the 2 initial bytes read
      }
      a <<= 1;
    }
    int sv = *st;
    const QeEntry& e = kQe[sv & 0x7F];
    const int64_t qe = e.qe;
    const int nl = e.nlps | (e.sw << 7), nm = e.nmps;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {  // conditional LPS exchange
        a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {  // conditional MPS exchange
      if (a < qe) {
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = (uint8_t)((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }

  // After the interval's last MCU: the marker that ends it.  Bytes the
  // decoder did not read before it are data libjpeg-turbo discards with a
  // warning (next_marker); fill bytes (0xFF ... ) are not.
  const uint8_t* finish(const char* before) const {
    if (marker) return marker;
    const uint8_t* q = p;
    int extra = 0;
    for (;;) {
      if (q >= end) refuse("truncated JPEG: the data ends after scan %d's entropy-coded data", scan);
      if (*q != 0xFF) {
        ++extra;
        ++q;
        continue;
      }
      const uint8_t* m = q;
      while (q < end && *q == 0xFF) ++q;
      if (q >= end) refuse("truncated JPEG: the data ends inside a marker after scan %d", scan);
      if (*q == 0) {
        extra += 2;
        ++q;
        continue;
      }
      if (extra)
        refuse("corrupt JPEG data: %d extraneous bytes before %s in scan %d", extra, before, scan);
      return m;
    }
  }
};

// jdcolor.c build_ycc_rgb_table: SCALEBITS 16, ONE_HALF rounding
struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    constexpr int kScale = 16;
    constexpr int64_t kHalf = (int64_t)1 << (kScale - 1);
    auto fix = [](double x) { return (int64_t)(x * (1L << kScale) + 0.5); };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = (int)((fix(1.40200) * x + kHalf) >> kScale);
      cb_b[i] = (int)((fix(1.77200) * x + kHalf) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kHalf;
    }
  }
  int green(int cb, int cr) const { return (int)((cb_g[cb] + cr_g[cr]) >> 16); }
};

const YccTables& ycc_tables() {
  static const YccTables t;
  return t;
}

// Pillow's CMYK -> RGB (src/libImaging/Convert.c cmyk2rgb) of what it
// stores of a CMYK JPEG: libjpeg's samples inverted ("CMYK;I", Adobe's
// polarity), so its 255 - K is libjpeg's K
inline uint8_t pillow_cmyk(int x, int k) {
  int tmp = (255 - x) * k + 128;
  int v = k - (((tmp >> 8) + tmp) >> 8);
  return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

enum class Space { kGray, kRGB, kYCbCr, kCMYK, kYCCK };

const char* space_name(Space s) {
  switch (s) {
    case Space::kGray: return "greyscale";
    case Space::kRGB: return "RGB";
    case Space::kYCbCr: return "YCbCr";
    case Space::kCMYK: return "CMYK";
    case Space::kYCCK: return "YCCK";
  }
  return "?";
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int unit = 8;        // samples per block side: 8, or 1 in a lossless frame
  int bw = 0, bh = 0;  // blocks of the plane: whole MCUs
  int dw = 0, dh = 0;  // its samples inside the image (downsampled_width / height)
  int td = 0, ta = 0, pred = 0, dc_context = 0;
  bool scanned = false, latched = false;
  int32_t quant[64] = {};  // natural order, latched when its first scan starts
  std::vector<uint8_t> plane;
  // progressive frames: bw x bh blocks of 64 coefficients in natural order,
  // and per zigzag position the Al of the last scan that coded it (-1: none)
  std::vector<int16_t> coef;
  int coef_bits[64];
  // lossless frames: the scan's differences (bw x bh) and the rows that
  // start the scan or a restart interval (predicted as a first row)
  std::vector<int32_t> diff;
  std::vector<uint8_t> first_row;
  int16_t* block(int bx, int by) { return coef.data() + ((size_t)by * bw + bx) * 64; }
  int16_t dc(int bx, int by) const { return coef[((size_t)by * bw + bx) * 64]; }
  int stride() const { return bw * unit; }
  const uint8_t* row(int r) const {  // rows past the edge replicate it
    r = r < 0 ? 0 : (r >= dh ? dh - 1 : r);
    return plane.data() + (size_t)r * stride();
  }
};

inline int ceil_div(long a, long b) { return (int)((a + b - 1) / b); }

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t n) : pos_(data), end_(data + n) {
    for (int t = 0; t < 16; ++t) {  // jdmarker.c get_soi: the default conditioning
      dc_l_[t] = 0;
      dc_u_[t] = 1;
      ac_k_[t] = 5;
    }
  }

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
        case 0xC3:
        case 0xC9:
        case 0xCA:
          progressive_ = m == 0xC2 || m == 0xCA;
          lossless_ = m == 0xC3;
          arith_ = m >= 0xC9;
          frame_header(seg, len);
          if (size_only) return;
          break;
        case 0xCB:
          refuse("arithmetic-coded lossless JPEG (SOF11) is not supported: libjpeg-turbo "
                 "decodes lossless JPEG with Huffman coding only");
        case 0xC5:
        case 0xC6:
        case 0xC7:
          refuse("hierarchical JPEG (SOF%d) is not supported", m - 0xC0);
        case 0xCD:
        case 0xCE:
        case 0xCF:
          refuse("hierarchical arithmetic-coded JPEG (SOF%d) is not supported", m - 0xC0);
        case 0xC4:
          huffman_tables(seg, len);
          break;
        case 0xCC:
          conditioning(seg, len);
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

  // Reads a tables-only stream (a TIFF's JPEGTables, tag 347) before the
  // image's: SOI, table and application segments, EOI.  Its quantisation
  // and Huffman tables stay defined for the image's stream, as in libjpeg
  // (tables-only jpeg_read_header); what the image's SOI resets is reset
  // (jdmarker.c get_soi: the restart interval, the arithmetic
  // conditioning, the JFIF and Adobe markers).
  void read_tables(const uint8_t* data, size_t n) {
    const uint8_t* const pos = pos_;
    const uint8_t* const end = end_;
    pos_ = data;
    end_ = data + n;
    if (n < 2 || data[0] != 0xFF || data[1] != 0xD8)
      refuse("JPEGTables: not a JPEG stream (no SOI marker)");
    pos_ += 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) break;
      if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
      const uint8_t* seg = segment(m);
      size_t len = segment_len_;
      if (m == 0xC4)
        huffman_tables(seg, len);
      else if (m == 0xDB)
        quant_tables(seg, len);
      else if (m == 0xCC)
        conditioning(seg, len);
      else if (m != 0xDD && !((m >= 0xE0 && m <= 0xEF) || m == 0xFE))
        refuse("JPEGTables: marker 0xFF%02X in a tables-only stream", m);
    }
    pos_ = pos;
    end_ = end;
    restart_interval_ = 0;
    jfif_ = adobe_ = false;
    adobe_transform_ = 0;
    for (int t = 0; t < 16; ++t) {
      dc_l_[t] = 0;
      dc_u_[t] = 1;
      ac_k_[t] = 5;
    }
  }

  // Takes the samples as YCbCr whatever the markers say (libtiff's
  // JPEGCOLORMODE_RGB sets jpeg_color_space to JCS_YCbCr).
  void force_ycbcr() { force_ycbcr_ = true; }

  int width() const { return width_; }
  int height() const { return height_; }
  int components() const { return ncomp_; }
  int h_factor(int c) const { return comp_[c].h; }
  int v_factor(int c) const { return comp_[c].v; }

  // The components as stored, interleaved, with no upsampling or colour
  // conversion (libjpeg's JCS_UNKNOWN output, as libtiff asks for it);
  // every component must be at full resolution.
  void to_components(uint8_t* out) const {
    for (int c = 0; c < ncomp_; ++c)
      if (comp_[c].dw != width_ || comp_[c].dh != height_)
        refuse("component %d is subsampled (%dx%d of %dx%d): its samples are not given as "
               "stored", comp_[c].id, comp_[c].dw, comp_[c].dh, width_, height_);
    for (int y = 0; y < height_; ++y) {
      uint8_t* o = out + (size_t)y * width_ * ncomp_;
      for (int c = 0; c < ncomp_; ++c) {
        const uint8_t* in = comp_[c].row(y);
        for (int x = 0; x < width_; ++x) o[(size_t)x * ncomp_ + c] = in[x];
      }
    }
  }

  void to_rgb(uint8_t* out) const {
    const size_t n = (size_t)width_ * height_;
    if (space_ == Space::kGray) {
      const Component& c = comp_[0];
      for (int y = 0; y < height_; ++y) {
        const uint8_t* in = c.row(y);
        uint8_t* o = out + (size_t)y * width_ * 3;
        for (int x = 0; x < width_; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = in[x];
      }
      return;
    }
    std::vector<uint8_t> full[4];
    for (int c = 0; c < ncomp_; ++c) full[c] = upsample(comp_[c]);
    const uint8_t* a = full[0].data();
    const uint8_t* b = full[1].data();
    const uint8_t* c = full[2].data();
    const uint8_t* limit = range_limit().sample;
    const YccTables& t = ycc_tables();
    switch (space_) {
      case Space::kRGB:
        for (size_t i = 0; i < n; ++i) {
          out[3 * i] = a[i];
          out[3 * i + 1] = b[i];
          out[3 * i + 2] = c[i];
        }
        return;
      case Space::kYCbCr:  // jdcolor.c ycc_rgb_convert
        for (size_t i = 0; i < n; ++i) {
          int y = a[i], cb = b[i], cr = c[i];
          out[3 * i] = limit[y + t.cr_r[cr]];
          out[3 * i + 1] = limit[y + t.green(cb, cr)];
          out[3 * i + 2] = limit[y + t.cb_b[cb]];
        }
        return;
      case Space::kCMYK:
        for (size_t i = 0; i < n; ++i) {
          int k = full[3][i];
          out[3 * i] = pillow_cmyk(a[i], k);
          out[3 * i + 1] = pillow_cmyk(b[i], k);
          out[3 * i + 2] = pillow_cmyk(c[i], k);
        }
        return;
      case Space::kYCCK:  // jdcolor.c ycck_cmyk_convert, then as CMYK
        for (size_t i = 0; i < n; ++i) {
          int y = a[i], cb = b[i], cr = c[i], k = full[3][i];
          out[3 * i] = pillow_cmyk(limit[255 - (y + t.cr_r[cr])], k);
          out[3 * i + 1] = pillow_cmyk(limit[255 - (y + t.green(cb, cr))], k);
          out[3 * i + 2] = pillow_cmyk(limit[255 - (y + t.cb_b[cb])], k);
        }
        return;
      case Space::kGray:
        return;
    }
  }

 private:
  const uint8_t* pos_;
  const uint8_t* end_;
  size_t segment_len_ = 0;
  bool frame_ = false, jfif_ = false, adobe_ = false;
  bool progressive_ = false, lossless_ = false, arith_ = false, force_ycbcr_ = false;
  int adobe_transform_ = 0;
  Space space_ = Space::kGray;
  int width_ = 0, height_ = 0, ncomp_ = 0, max_h_ = 1, max_v_ = 1, mcus_x_ = 0, mcus_y_ = 0;
  int restart_interval_ = 0, scans_ = 0;
  int eobrun_ = 0;  // blocks left in the current end-of-band run
  Component comp_[4];
  int32_t quant_[4][64] = {};
  bool quant_defined_[4] = {};
  Huffman dc_[4], ac_[4];
  // arithmetic coding (jdarith.c): the DAC conditioning and the statistics
  // bins of each table, and the bin of the fixed 0.5 estimate
  int dc_l_[16], dc_u_[16], ac_k_[16];
  uint8_t dc_stats_[16][64], ac_stats_[16][256];
  uint8_t fixed_bin_ = 113;

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

  // jdapimin.c default_decompress_parms, read when the first scan starts
  Space colour_space() const {
    if (ncomp_ == 1) return Space::kGray;
    if (ncomp_ == 4) {
      if (adobe_) return adobe_transform_ == 0 ? Space::kCMYK : Space::kYCCK;
      return Space::kCMYK;
    }
    if (jfif_) return Space::kYCbCr;
    if (adobe_) return adobe_transform_ == 0 ? Space::kRGB : Space::kYCbCr;
    const int a = comp_[0].id, b = comp_[1].id, c = comp_[2].id;
    if (a == 'R' && b == 'G' && c == 'B') return Space::kRGB;
    return lossless_ ? Space::kRGB : Space::kYCbCr;  // ids 1, 2, 3 or unknown
  }

  void frame_header(const uint8_t* s, size_t len) {
    if (frame_) refuse("corrupt JPEG data: a second frame header");
    if (len < 6) refuse("corrupt JPEG data: SOF segment of %zu bytes", len);
    int precision = s[0];
    height_ = (s[1] << 8) | s[2];
    width_ = (s[3] << 8) | s[4];
    ncomp_ = s[5];
    if (lossless_ && precision != 8)
      refuse("lossless JPEG of %d-bit samples is not supported (Pillow reads 8-bit JPEG only)",
             precision);
    if (precision == 12) refuse("12-bit JPEG is not supported");
    if (precision != 8) refuse("%d-bit JPEG is not supported", precision);
    if (ncomp_ != 1 && ncomp_ != 3 && ncomp_ != 4)
      refuse("JPEG of %d components is not supported", ncomp_);
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
      for (int o = 0; o < c; ++o)
        if (comp_[o].id == k.id) refuse("corrupt JPEG data: component id %d twice", k.id);
      max_h_ = std::max(max_h_, k.h);
      max_v_ = std::max(max_v_, k.v);
    }
    // jdsample.c jinit_upsampler: each component's factors divide the
    // largest ones, or libjpeg-turbo raises JERR_FRACT_SAMPLE_NOTIMPL
    for (int c = 0; c < ncomp_; ++c) {
      const Component& k = comp_[c];
      if (max_h_ % k.h || max_v_ % k.v)
        refuse("JPEG with fractional sampling is not supported (component %d sampled %dx%d in "
               "a frame of %dx%d)", k.id, k.h, k.v, max_h_, max_v_);
    }
    const int unit = lossless_ ? 1 : 8;
    mcus_x_ = ceil_div(width_, unit * max_h_);
    mcus_y_ = ceil_div(height_, unit * max_v_);
    for (int c = 0; c < ncomp_; ++c) {
      Component& k = comp_[c];
      k.unit = unit;
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

  // jdmarker.c get_dac: per table, DC bounds L and U or the AC Kx
  void conditioning(const uint8_t* s, size_t len) {
    if (len % 2) refuse("corrupt JPEG data: DAC segment of %zu bytes", len);
    for (size_t i = 0; i < len; i += 2) {
      int index = s[i], val = s[i + 1];
      if (index >= 32) refuse("corrupt JPEG data: DAC table index %d", index);
      if (index >= 16) {
        ac_k_[index - 16] = val;
      } else {
        dc_l_[index] = val & 15;
        dc_u_[index] = val >> 4;
        if (dc_l_[index] > dc_u_[index])
          refuse("corrupt JPEG data: DAC conditioning 0x%02X of DC table %d", val, index);
      }
    }
  }

  void scan(const uint8_t* s, size_t len) {
    int ns = s[0];
    if (ns < 1 || ns > ncomp_ || len != 4 + 2 * (size_t)ns)
      refuse("corrupt JPEG data: SOS segment of %zu bytes for %d components", len, ns);
    if (scans_ == 0) {
      if (force_ycbcr_ && ncomp_ != 3)
        refuse("YCbCr of %d components: three are converted", ncomp_);
      space_ = force_ycbcr_ ? Space::kYCbCr : colour_space();
      // jdcolor.c: no colour conversion of lossless samples
      if (lossless_ && (space_ == Space::kYCbCr || space_ == Space::kYCCK))
        refuse("lossless JPEG in %s colour is not supported: libjpeg-turbo converts no colour "
               "of lossless samples", space_name(space_));
    }
    const uint8_t* p = s + 1 + 2 * ns;
    const int ss = p[0], se = p[1], ah = p[2] >> 4, al = p[2] & 15;
    const bool dc = ss == 0;
    if (lossless_) {  // jdlossls.c start_pass_lossless: Ss the predictor, Al the transform
      if (ss < 1 || ss > 7 || se != 0 || ah != 0 || al > 7)
        refuse("corrupt JPEG data: a lossless scan with predictor %d, Se=%d Ah=%d Pt=%d", ss, se,
               ah, al);
    } else if (!progressive_) {
      if (ss != 0 || se != 63 || ah != 0 || al != 0)
        refuse("corrupt JPEG data: a sequential scan with Ss=%d Se=%d Ah=%d Al=%d", ss, se, ah,
               al);
    } else if ((dc && se != 0) || (!dc && (ss > se || se > 63 || ns != 1)) ||
               (ah != 0 && al != ah - 1) || al > 13) {
      // jdphuff.c / jdarith.c start_pass's checks of the scan's parameters
      refuse("corrupt JPEG data: a progressive scan of %d components with Ss=%d Se=%d Ah=%d "
             "Al=%d", ns, ss, se, ah, al);
    }
    // the Huffman tables the scan decodes with (arithmetic coding has 16
    // conditioning tables, each defined by default)
    const bool need_dc = !progressive_ || (dc && ah == 0);
    const bool need_ac = !lossless_ && (!progressive_ || !dc);
    Component* in_scan[4];
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
      if (!arith_) {
        if (k->td > 3 || k->ta > 3 || (need_dc && !dc_[k->td].defined) ||
            (need_ac && !ac_[k->ta].defined))
          refuse("corrupt JPEG data: scan uses Huffman tables %d/%d, not defined", k->td, k->ta);
        if (need_dc)  // jdhuff.c jpeg_make_d_derived_tbl: categories 0-15 (16 lossless)
          for (int j = 0; j < dc_[k->td].n_symbols; ++j)
            if (dc_[k->td].vals[j] > (lossless_ ? 16 : 15))
              refuse("corrupt JPEG data: bad DC Huffman table");
      }
      if (!k->latched && !lossless_) {
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
        k->plane.assign((size_t)k->stride() * k->bh * k->unit, 0);
      }
      k->pred = 0;
      k->dc_context = 0;
      in_scan[i] = k;
      blocks += k->h * k->v;
    }
    if (ns > 1 && blocks > 10) refuse("corrupt JPEG data: %d blocks in an MCU", blocks);

    if (lossless_)
      lossless_scan(in_scan, ns, ss, al);
    else if (arith_)
      arith_scan(in_scan, ns, ss, se, ah, al);
    else
      huffman_scan(in_scan, ns, ss, se, ah, al);
    for (int i = 0; i < ns; ++i) in_scan[i]->scanned = true;
  }

  void huffman_scan(Component* const* in_scan, int ns, int ss, int se, int ah, int al) {
    const bool dc = ss == 0;
    BitReader br(pos_, end_, scans_++);
    eobrun_ = 0;
    auto restart = [&](int n, long) {
      br.restart(n);
      for (int i = 0; i < ns; ++i) in_scan[i]->pred = 0;
      eobrun_ = 0;
    };
    if (!progressive_) {
      int16_t coef[64];
      each_block(in_scan, ns, restart, [&](Component& k, int bx, int by) {
        memset(coef, 0, sizeof coef);
        sequential_block(br, k, coef);
        idct_islow(coef, k.quant, k.plane.data() + (size_t)by * 8 * k.stride() + bx * 8,
                   k.stride());
      });
    } else if (dc && ah == 0) {
      each_block(in_scan, ns, restart, [&](Component& k, int bx, int by) {
        k.pred += dc_diff(br, dc_[k.td]);
        k.block(bx, by)[0] = shifted(k.pred, al);
      });
    } else if (dc) {
      each_block(in_scan, ns, restart, [&](Component& k, int bx, int by) {
        if (br.get(1)) k.block(bx, by)[0] |= (int16_t)(1 << al);
      });
    } else {
      const Huffman& ac = ac_[in_scan[0]->ta];
      each_block(in_scan, ns, restart, [&](Component& k, int bx, int by) {
        if (ah == 0)
          ac_first(br, ac, k.block(bx, by), ss, se, al);
        else
          ac_refine(br, ac, k.block(bx, by), ss, se, al);
      });
    }
    br.align("the marker after the scan");
    pos_ = br.p;
  }

  // Calls restart(n, mcu) before each restart interval but the first and
  // block(component, bx, by) for every block (sample, in a lossless frame)
  // of the scan in the stream's order.  A scan of one component covers its
  // ceil(dw / unit) x ceil(dh / unit) blocks; an interleaved scan covers
  // whole MCUs, padding blocks included.
  template <class Restart, class Block>
  void each_block(Component* const* in_scan, int ns, Restart&& restart, Block&& block) {
    int cols, rows;
    scan_mcus(in_scan, ns, &cols, &rows);
    const long mcus = (long)cols * rows;
    int to_go = restart_interval_, next_rst = 0;
    for (long m = 0; m < mcus; ++m) {
      if (restart_interval_) {
        if (to_go == 0) {
          restart(next_rst, m);
          next_rst = (next_rst + 1) & 7;
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

  void scan_mcus(Component* const* in_scan, int ns, int* cols, int* rows) const {
    if (ns == 1) {
      *cols = ceil_div(in_scan[0]->dw, in_scan[0]->unit);
      *rows = ceil_div(in_scan[0]->dh, in_scan[0]->unit);
    } else {
      *cols = mcus_x_;
      *rows = mcus_y_;
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

  // jdhuff.c HUFF_EXTEND
  static int extend(int x, int s) { return x < (1 << (s - 1)) ? x + (-(1 << s) + 1) : x; }

  // ---- arithmetic coding (jdarith.c) ----

  [[noreturn]] static void bad_code(const ArithReader& ar, const char* what) {
    refuse("corrupt JPEG data: bad arithmetic code in scan %d (%s)", ar.scan, what);
  }

  // start_pass / process_restart: the statistics of the scan's tables and
  // its DC predictions start over
  void reset_statistics(Component* const* in_scan, int ns, int ss, int ah) {
    for (int i = 0; i < ns; ++i) {
      Component& k = *in_scan[i];
      if (!progressive_ || (ss == 0 && ah == 0)) {
        memset(dc_stats_[k.td], 0, sizeof dc_stats_[k.td]);
        k.pred = 0;
        k.dc_context = 0;
      }
      if (!progressive_ || ss) memset(ac_stats_[k.ta], 0, sizeof ac_stats_[k.ta]);
    }
  }

  // F.2.4.1 (decode_mcu's DC part, decode_mcu_DC_first): the DC difference,
  // its conditioning by the previous one, the value shifted by ``al``
  void arith_dc(ArithReader& ar, Component& k, int16_t* blk, int al) {
    uint8_t* stats = dc_stats_[k.td];
    uint8_t* st = stats + k.dc_context;
    if (ar.decode(st) == 0) {
      k.dc_context = 0;
    } else {
      const int sign = ar.decode(st + 1);
      st += 2 + sign;
      int m = ar.decode(st);
      if (m) {
        st = stats + 20;
        while (ar.decode(st)) {
          if ((m <<= 1) == 0x8000) bad_code(ar, "DC magnitude overflow");
          st += 1;
        }
      }
      if (m < (1 << dc_l_[k.td]) >> 1)
        k.dc_context = 0;
      else if (m > (1 << dc_u_[k.td]) >> 1)
        k.dc_context = 12 + sign * 4;
      else
        k.dc_context = 4 + sign * 4;
      int v = m;
      st += 14;
      while (m >>= 1)
        if (ar.decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      k.pred = (k.pred + v) & 0xFFFF;
    }
    blk[0] = shifted(k.pred, al);
  }

  // F.2.4.2 / G.1.3.2 (decode_mcu's AC part, decode_mcu_AC_first)
  void arith_ac_first(ArithReader& ar, Component& k, int16_t* blk, int ss, int se, int al) {
    uint8_t* stats = ac_stats_[k.ta];
    for (int i = ss; i <= se; ++i) {
      uint8_t* st = stats + 3 * (i - 1);
      if (ar.decode(st)) break;  // end of block
      while (ar.decode(st + 1) == 0) {
        st += 3;
        if (++i > se) bad_code(ar, "spectral overflow");
      }
      const int sign = ar.decode(&fixed_bin_);
      st += 2;
      int m = ar.decode(st);
      if (m && ar.decode(st)) {
        m <<= 1;
        st = stats + (i <= ac_k_[k.ta] ? 189 : 217);
        while (ar.decode(st)) {
          if ((m <<= 1) == 0x8000) bad_code(ar, "AC magnitude overflow");
          st += 1;
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (ar.decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      blk[kNatural[i]] = shifted(v, al);
    }
  }

  // G.1.3.3 (decode_mcu_AC_refine)
  void arith_ac_refine(ArithReader& ar, Component& k, int16_t* blk, int ss, int se, int al) {
    uint8_t* stats = ac_stats_[k.ta];
    const int p1 = 1 << al, m1 = -(1 << al);
    int kex = se;  // the previous stage's end of block
    for (; kex > 0; --kex)
      if (blk[kNatural[kex]]) break;
    for (int i = ss; i <= se; ++i) {
      uint8_t* st = stats + 3 * (i - 1);
      if (i > kex && ar.decode(st)) break;  // end of block
      for (;;) {
        int16_t& c = blk[kNatural[i]];
        if (c) {  // previously nonzero: a correction bit
          if (ar.decode(st + 2)) c = (int16_t)(c + (c < 0 ? m1 : p1));
          break;
        }
        if (ar.decode(st + 1)) {  // newly nonzero
          c = (int16_t)(ar.decode(&fixed_bin_) ? m1 : p1);
          break;
        }
        st += 3;
        if (++i > se) bad_code(ar, "spectral overflow");
      }
    }
  }

  void arith_scan(Component* const* in_scan, int ns, int ss, int se, int ah, int al) {
    const bool dc = ss == 0;
    ArithReader ar(pos_, end_, scans_++);
    reset_statistics(in_scan, ns, ss, ah);
    fixed_bin_ = 113;
    auto restart = [&](int n, long) {
      char name[16];
      snprintf(name, sizeof name, "RST%d", n);
      const uint8_t* q = ar.finish(name);
      while (q < end_ && *q == 0xFF) ++q;
      if (q >= end_)
        refuse("truncated JPEG: the data ends at a restart marker of scan %d", ar.scan);
      if (*q != 0xD0 + n)
        refuse("corrupt JPEG data: marker 0xFF%02X where scan %d expects RST%d", *q, ar.scan, n);
      ar = ArithReader(q + 1, end_, ar.scan);
      reset_statistics(in_scan, ns, ss, ah);
    };
    if (!progressive_) {
      int16_t coef[64];
      each_block(in_scan, ns, restart, [&](Component& k, int bx, int by) {
        memset(coef, 0, sizeof coef);
        arith_dc(ar, k, coef, 0);
        arith_ac_first(ar, k, coef, 1, 63, 0);
        idct_islow(coef, k.quant, k.plane.data() + (size_t)by * 8 * k.stride() + bx * 8,
                   k.stride());
      });
    } else if (dc && ah == 0) {
      each_block(in_scan, ns, restart,
                 [&](Component& k, int bx, int by) { arith_dc(ar, k, k.block(bx, by), al); });
    } else if (dc) {
      each_block(in_scan, ns, restart, [&](Component& k, int bx, int by) {
        if (ar.decode(&fixed_bin_)) k.block(bx, by)[0] |= (int16_t)(1 << al);
      });
    } else {
      each_block(in_scan, ns, restart, [&](Component& k, int bx, int by) {
        if (ah == 0)
          arith_ac_first(ar, k, k.block(bx, by), ss, se, al);
        else
          arith_ac_refine(ar, k, k.block(bx, by), ss, se, al);
      });
    }
    pos_ = ar.finish("the marker after the scan");
  }

  // ---- lossless (jdlhuff.c, jddiffct.c, jdlossls.c) ----

  // One scan's sample differences: Huffman-coded categories 0-16 (16:
  // 32768, no extra bits).  A restart makes the next row undifferenced a
  // first row: jddiffct.c decodes a whole iMCU row (one MCU row of an
  // interleaved scan, v rows of a component's own scan) before it
  // undifferences it, so a restart inside an iMCU row restarts the
  // prediction at that iMCU row's first row, as here.  The scan's samples
  // are then reconstructed.
  void lossless_scan(Component* const* in_scan, int ns, int psv, int pt) {
    int cols, rows;
    scan_mcus(in_scan, ns, &cols, &rows);
    if (restart_interval_ % cols)
      refuse("lossless JPEG with a restart interval of %d MCUs, not a multiple of the %d MCUs "
             "of a row, is not supported (libjpeg-turbo refuses it)", restart_interval_, cols);
    for (int i = 0; i < ns; ++i) {
      Component& k = *in_scan[i];
      k.diff.assign((size_t)k.bw * k.bh, 0);
      k.first_row.assign(k.bh, 0);
      k.first_row[0] = 1;
    }
    BitReader br(pos_, end_, scans_++);
    auto restart = [&](int n, long m) {
      br.restart(n);
      const int my = (int)(m / cols);
      for (int i = 0; i < ns; ++i) {
        Component& k = *in_scan[i];
        k.first_row[ns > 1 ? my * k.v : my / k.v * k.v] = 1;
      }
    };
    each_block(in_scan, ns, restart, [&](Component& k, int x, int y) {
      const int s = br.decode(dc_[k.td]);
      k.diff[(size_t)y * k.bw + x] = s == 16 ? 32768 : (s ? extend(br.get(s), s) : 0);
    });
    br.align("the marker after the scan");
    pos_ = br.p;
    for (int i = 0; i < ns; ++i) undifference(*in_scan[i], psv, pt);
  }

  // jdlossls.c: the predictors over samples modulo 2^16 (row 0 and each
  // row after a restart: 2^(P-Pt-1) then the left sample; other rows: the
  // sample above, then predictor ``psv``), and the point transform's
  // (sample << Pt) into 8 bits
  void undifference(Component& k, int psv, int pt) {
    std::vector<int32_t> prev(k.dw), cur(k.dw);
    k.plane.assign((size_t)k.stride() * k.bh, 0);
    for (int y = 0; y < k.dh; ++y) {
      const int32_t* d = k.diff.data() + (size_t)y * k.bw;
      int ra;
      if (k.first_row[y]) {
        ra = (d[0] + (1 << (8 - pt - 1))) & 0xFFFF;
        cur[0] = ra;
        for (int x = 1; x < k.dw; ++x) cur[x] = ra = (d[x] + ra) & 0xFFFF;
      } else {
        int rb = prev[0];
        cur[0] = ra = (d[0] + rb) & 0xFFFF;
        for (int x = 1; x < k.dw; ++x) {
          const int rc = rb;
          rb = prev[x];
          int pred;
          switch (psv) {
            case 1: pred = ra; break;
            case 2: pred = rb; break;
            case 3: pred = rc; break;
            case 4: pred = ra + rb - rc; break;
            case 5: pred = ra + ((rb - rc) >> 1); break;
            case 6: pred = rb + ((ra - rc) >> 1); break;
            default: pred = (ra + rb) >> 1; break;
          }
          cur[x] = ra = (d[x] + pred) & 0xFFFF;
        }
      }
      uint8_t* o = k.plane.data() + (size_t)y * k.stride();
      for (int x = 0; x < k.dw; ++x) o[x] = (uint8_t)(cur[x] << pt);
      std::swap(prev, cur);
    }
    std::vector<int32_t>().swap(k.diff);
  }

  // ---- after the last scan of a progressive frame ----

  // The IDCT of every block inside each component's samples.  Where any of
  // the zigzag coefficients 1-9 of a component is coarser than its last
  // bit, libjpeg-turbo smooths the blocks (jdcoefct.c smoothing_ok,
  // decompress_smooth_data), and so does this.
  void finish_progressive() {
    bool smooth = false, quant_ok = true;
    for (int c = 0; c < ncomp_; ++c) {
      Component& k = comp_[c];
      if (k.coef_bits[0] < 0)
        refuse("corrupt JPEG data: progressive JPEG with no DC scan of component %d", k.id);
      for (int z = 0; z < 10; ++z)
        if (k.quant[kNatural[z]] == 0) quant_ok = false;
      for (int z = 1; z < 10; ++z)
        if (k.coef_bits[z] != 0) smooth = true;
    }
    for (int c = 0; c < ncomp_; ++c) {
      Component& k = comp_[c];
      k.plane.assign((size_t)k.bw * 8 * k.bh * 8, 0);
      if (smooth && quant_ok) {
        smoothed_idct(k);
      } else {
        const int wb = ceil_div(k.dw, 8), hb = ceil_div(k.dh, 8);
        for (int by = 0; by < hb; ++by)
          for (int bx = 0; bx < wb; ++bx)
            idct_islow(k.block(bx, by), k.quant,
                       k.plane.data() + (size_t)by * 8 * k.stride() + bx * 8, k.stride());
      }
      std::vector<int16_t>().swap(k.coef);
    }
  }

  // jdcoefct.c decompress_smooth_data (libjpeg-turbo 2.1+): the zigzag
  // coefficients 1-9 of a block that are still zero and not known to their
  // last bit are estimated from the DC values of the block and its 24
  // neighbours, and where no AC coefficient was coded at all the DC too.
  // The rows are walked per iMCU row with the neighbours chosen as there.
  void smoothed_idct(Component& k) {
    const int* bits = k.coef_bits;
    bool change_dc = true;
    for (int z = 1; z < 10; ++z)
      if (bits[z] != -1) change_dc = false;
    const int64_t q00 = k.quant[0], q01 = k.quant[1], q10 = k.quant[8], q20 = k.quant[16],
                  q11 = k.quant[9], q02 = k.quant[2], q03 = k.quant[3], q12 = k.quant[10],
                  q21 = k.quant[17], q30 = k.quant[24];
    // a coefficient's estimate: num / (q << 8) rounded, limited to its
    // unknown bits (Al > 0)
    auto estimate = [](int64_t num, int64_t q, int al) {
      int pred;
      if (num >= 0) {
        pred = (int)(((q << 7) + num) / (q << 8));
        if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      } else {
        pred = (int)(((q << 7) - num) / (q << 8));
        if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
        pred = -pred;
      }
      return (int16_t)pred;
    };
    const int wb = ceil_div(k.dw, 8), hb = ceil_div(k.dh, 8), last_col = wb - 1;
    const int total = mcus_y_;
    int16_t ws[64];
    for (int r = 0; r < total; ++r) {
      int block_rows = k.v;
      if (r == total - 1 && hb % k.v) block_rows = hb % k.v;
      const int image_rows = block_rows * total;
      for (int br = 0; br < block_rows; ++br) {
        const int ibr = r * block_rows + br, cur = r * k.v + br;
        const int prev = ibr > 0 ? cur - 1 : cur;
        const int pprev = ibr > 1 ? cur - 2 : prev;
        const int next = ibr < image_rows - 1 ? cur + 1 : cur;
        const int nnext = ibr < image_rows - 2 ? cur + 2 : next;
        const int rows[5] = {pprev, prev, cur, next, nnext};
        for (int bx = 0; bx < wb; ++bx) {
          // DC[row][col]: rows 2 above to 2 below, columns 2 left to 2 right
          int D[5][5];
          for (int i = 0; i < 5; ++i)
            for (int j = 0; j < 5; ++j) {
              int x = bx + j - 2;
              x = x < 0 ? 0 : (x > last_col ? last_col : x);
              D[i][j] = k.dc(x, rows[i]);
            }
          const int DC01 = D[0][0], DC02 = D[0][1], DC03 = D[0][2], DC04 = D[0][3],
                    DC05 = D[0][4], DC06 = D[1][0], DC07 = D[1][1], DC08 = D[1][2],
                    DC09 = D[1][3], DC10 = D[1][4], DC11 = D[2][0], DC12 = D[2][1],
                    DC13 = D[2][2], DC14 = D[2][3], DC15 = D[2][4], DC16 = D[3][0],
                    DC17 = D[3][1], DC18 = D[3][2], DC19 = D[3][3], DC20 = D[3][4],
                    DC21 = D[4][0], DC22 = D[4][1], DC23 = D[4][2], DC24 = D[4][3],
                    DC25 = D[4][4];
          memcpy(ws, k.block(bx, cur), sizeof ws);
          int al;
          if ((al = bits[1]) != 0 && ws[1] == 0) {  // AC01
            int64_t num = q00 * (change_dc
                ? (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 - 13 * DC09 + 3 * DC10 -
                   3 * DC11 + 38 * DC12 - 38 * DC14 + 3 * DC15 - 3 * DC16 + 13 * DC17 -
                   13 * DC19 + 3 * DC20 - DC21 - DC22 + DC24 + DC25)
                : (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15));
            ws[1] = estimate(num, q01, al);
          }
          if ((al = bits[2]) != 0 && ws[8] == 0) {  // AC10
            int64_t num = q00 * (change_dc
                ? (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 + 13 * DC07 +
                   38 * DC08 + 13 * DC09 - DC10 + DC16 - 13 * DC17 - 38 * DC18 - 13 * DC19 +
                   DC20 + DC21 + 3 * DC22 + 3 * DC23 + 3 * DC24 + DC25)
                : (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23));
            ws[8] = estimate(num, q10, al);
          }
          if ((al = bits[3]) != 0 && ws[16] == 0) {  // AC20
            int64_t num = q00 * (change_dc
                ? (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 - 14 * DC13 - 5 * DC14 +
                   2 * DC17 + 7 * DC18 + 2 * DC19 + DC23)
                : (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23));
            ws[16] = estimate(num, q20, al);
          }
          if ((al = bits[4]) != 0 && ws[9] == 0) {  // AC11
            int64_t num = q00 * (change_dc
                ? (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 + DC21 - DC25)
                : (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 - DC24 + DC04 -
                   DC06 + 10 * DC07 - 10 * DC09));
            ws[9] = estimate(num, q11, al);
          }
          if ((al = bits[5]) != 0 && ws[2] == 0) {  // AC02
            int64_t num = q00 * (change_dc
                ? (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 - 14 * DC13 + 7 * DC14 +
                   DC15 + 2 * DC17 - 5 * DC18 + 2 * DC19)
                : (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15));
            ws[2] = estimate(num, q02, al);
          }
          if (change_dc) {
            if ((al = bits[6]) != 0 && ws[3] == 0)  // AC03
              ws[3] = estimate(q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19), q03, al);
            if ((al = bits[7]) != 0 && ws[10] == 0)  // AC12
              ws[10] = estimate(q00 * (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19), q12,
                                al);
            if ((al = bits[8]) != 0 && ws[17] == 0)  // AC21
              ws[17] = estimate(q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19), q21,
                                al);
            if ((al = bits[9]) != 0 && ws[24] == 0)  // AC30
              ws[24] = estimate(q00 * (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19), q30,
                                al);
            // the DC itself: a 5x5 kernel of weights summing to 256
            ws[0] = estimate(q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 -
                                    6 * DC06 + 6 * DC07 + 42 * DC08 + 6 * DC09 - 6 * DC10 -
                                    8 * DC11 + 42 * DC12 + 152 * DC13 + 42 * DC14 - 8 * DC15 -
                                    6 * DC16 + 6 * DC17 + 42 * DC18 + 6 * DC19 - 6 * DC20 -
                                    2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25),
                             q00, 0);
          }
          idct_islow(ws, k.quant, k.plane.data() + (size_t)cur * 8 * k.stride() + bx * 8,
                     k.stride());
        }
      }
    }
  }

  // The component at the image's full resolution, width_ x height_, as
  // jdsample.c jinit_upsampler picks per ratio: fullsize; h2v1 and h2v2
  // "fancy" filters (box replication where the plane is 2 samples wide or
  // less), h1v2 fancy; any other integer ratio replicated (int_upsample).
  // A lossless frame has no DCT scaling and so no fancy filter.
  std::vector<uint8_t> upsample(const Component& k) const {
    std::vector<uint8_t> out((size_t)width_ * height_);
    const int hx = max_h_ / k.h, vy = max_v_ / k.v;
    const bool fancy = !lossless_;
    enum { kFull, kH2V1, kH1V2, kH2V2, kReplicate } method = kReplicate;
    if (hx == 1 && vy == 1)
      method = kFull;
    else if (hx == 2 && vy == 1 && fancy && k.dw > 2)
      method = kH2V1;
    else if (hx == 1 && vy == 2 && fancy)
      method = kH1V2;
    else if (hx == 2 && vy == 2 && fancy && k.dw > 2)
      method = kH2V2;
    std::vector<uint8_t> row(2 * (size_t)k.dw + 2);
    std::vector<int> sum(k.dw);
    for (int y = 0; y < height_; ++y) {
      uint8_t* o = out.data() + (size_t)y * width_;
      switch (method) {
        case kFull:
          memcpy(o, k.row(y), width_);
          break;
        case kReplicate: {
          const uint8_t* in = k.row(y / vy);
          for (int x = 0; x < width_; ++x) o[x] = in[x / hx];
          break;
        }
        case kH2V1: {
          const uint8_t* in = k.row(y);
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
          memcpy(o, row.data(), width_);
          break;
        }
        case kH1V2: {
          const int r = y / 2;
          const bool below = y & 1;
          const uint8_t* near = k.row(r);
          const uint8_t* far = k.row(below ? r + 1 : r - 1);
          const int bias = below ? 2 : 1;
          for (int x = 0; x < width_; ++x) o[x] = (uint8_t)((near[x] * 3 + far[x] + bias) >> 2);
          break;
        }
        case kH2V2: {
          const int r = y / 2;
          const bool below = y & 1;
          const uint8_t* near = k.row(r);
          const uint8_t* far = k.row(below ? r + 1 : r - 1);
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
          break;
        }
      }
    }
    return out;
  }
};

// Parses ``data`` after ``tables`` (when ``ntables`` > 0); with
// ``size_only`` it stops after the frame header.
void parse(Decoder& d, const uint8_t* tables, size_t ntables, bool size_only) {
  if (ntables) d.read_tables(tables, ntables);
  d.run(size_only);
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

extern "C" int jpeg_decode(const uint8_t* tables, size_t ntables, const uint8_t* data,
                           size_t n, int form, int* info, uint8_t* out, char* err,
                           int err_len) {
  std::string msg;
  try {
    hrbf_jpeg::Decoder d(data, n);
    if (form == 2) d.force_ycbcr();
    hrbf_jpeg::parse(d, tables, ntables, out == nullptr);
    if (!out) {
      info[0] = d.width();
      info[1] = d.height();
      info[2] = d.components();
      for (int c = 0; c < 4; ++c) {
        info[3 + 2 * c] = c < d.components() ? d.h_factor(c) : 0;
        info[4 + 2 * c] = c < d.components() ? d.v_factor(c) : 0;
      }
      return 0;
    }
    if (d.width() != info[0] || d.height() != info[1] || d.components() != info[2]) {
      msg = "the JPEG stream's size changed between the two calls";
    } else if (form == 1) {
      d.to_components(out);
      return 0;
    } else {
      d.to_rgb(out);
      return 0;
    }
  } catch (const hrbf_jpeg::Refused& e) {
    msg = e.what();
  } catch (const std::bad_alloc&) {
    msg = "out of memory decoding a JPEG";
  }
  if (err && err_len > 0) snprintf(err, (size_t)err_len, "%s", msg.c_str());
  return -1;
}
