// VP8 keyframe decoding with no library: the lossy colour of WebP files,
// which the JAX package opens with Pillow (libwebp).  io/webp.py reads the
// RIFF container; this file decodes a "VP8 " chunk's payload into its Y, U
// and V planes (RFC 6386, which fixes every sample of them), and then, as a
// separate stage, turns the planes into RGB as libwebp does.
//
// The planes: the frame header (colour space and clamping bits, read and
// ignored as libwebp ignores them; segmentation with its quantiser and
// filter values and its map probabilities; the simple or normal loop filter
// with its level, sharpness and reference and mode deltas; 1, 2, 4 or 8
// token partitions; the quantiser indices and their five deltas), the
// coefficient probability updates, the skip probability; per macroblock the
// segment, the skip flag, the 16x16 or 4x4 intra modes with their contexts
// and the chroma mode; the tokens with their band and neighbour contexts;
// dequantisation (the Y2 rules: DC doubled, AC times 155 / 100 and at least
// 8); the Walsh-Hadamard transform and the inverse DCT; the predictors on
// unfiltered samples with libwebp's edges (127 above the frame, 129 left of
// it, the above-right samples of a macroblock's last column repeated down
// its 4x4 rows, and of the frame's last macroblock the above row's last
// sample); then the loop filter over the whole frame in macroblock order
// (left edge, inner vertical edges, top edge, inner horizontal edges; the
// simple filter on luma only; inner edges skipped for a macroblock with no
// coefficient and a 16x16 mode) and the crop from the macroblock grid.  The
// bit reader fails as libwebp's does: reading past the end of a partition
// is an error.  Coefficients are held in 16 bits as libwebp holds them.
//
// RGB: libwebp's "fancy" upsampling of U and V (the pair of rows around
// each chroma row, each output sample rounded twice: a diagonal
// (a + b + c + d + 2 (b + c) + 8) >> 3, then its mean with the nearest
// sample; the first and an even width's last column (3 a + b + 2) >> 2;
// the first row, and an even height's last row, paired with themselves),
// then its 14-bit fixed-point VP8YUVToR / G / B (dsp/yuv.h), statement for
// statement.

#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include "vp8_tables.h"

namespace hrbf_vp8 {
namespace {

// sub-block modes in the RFC's order; the 16x16 and chroma modes share the
// first four
enum { B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_LD_PRED, B_RD_PRED, B_VR_PRED,
       B_VL_PRED, B_HD_PRED, B_HU_PRED };
enum { DC_PRED = B_DC_PRED, TM_PRED = B_TM_PRED, V_PRED = B_VE_PRED, H_PRED = B_HE_PRED };
// the DC predictors at the frame's edges
enum { DC_NOTOP = 10, DC_NOLEFT, DC_NOTOPLEFT };

constexpr int BPS = 32;  // the work buffers' stride

// The boolean decoder (RFC 6386 section 7), loading a byte when the window
// runs short; past the end it shifts in zeros and raises ``eof``.
struct BoolReader {
  const uint8_t* p = nullptr;
  const uint8_t* end = nullptr;
  uint64_t value = 0;
  int bits = -8;
  uint32_t range = 255;
  bool eof = false;

  void init(const uint8_t* data, size_t n) {
    p = data;
    end = data + n;
    value = 0;
    bits = -8;
    range = 255;
    eof = false;
    load();
  }
  void load() {
    if (p < end) {
      value = (value << 8) | *p++;
      bits += 8;
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;
    }
  }
  int bit(int prob) {
    if (bits < 0) load();
    const uint32_t split = ((range - 1) * static_cast<uint32_t>(prob)) >> 8;
    const uint32_t v = static_cast<uint32_t>(value >> bits);
    int b;
    if (v > split) {
      range -= split + 1;
      value -= static_cast<uint64_t>(split + 1) << bits;
      b = 1;
    } else {
      range = split + 1;
      b = 0;
    }
    const int shift = __builtin_clz(range) - 24;  // renormalise to 128-255
    range <<= shift;
    bits -= shift;
    return b;
  }
  int literal(int n) {  // n bits, most significant first
    int v = 0;
    while (n-- > 0) v |= bit(0x80) << n;
    return v;
  }
  int signed_literal(int n) {
    const int v = literal(n);
    return literal(1) ? -v : v;
  }
};

struct FilterInfo {
  int limit = 0, ilevel = 0, hev_thresh = 0;
};

struct Quant {
  int y1[2], y2[2], uv[2];
};

int clip(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }
uint8_t clip8(int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }

// ------------------------------------------------------------ transforms

// libwebp's MUL1 / MUL2, in 64 bits: the horizontal pass's inputs of a
// corrupt stream reach 2^17, whose products overflow an int
int mul1(int a) { return static_cast<int>((int64_t{a} * 20091) >> 16) + a; }
int mul2(int a) { return static_cast<int>((int64_t{a} * 35468) >> 16); }

// the inverse DCT of one 4x4 block, added to the prediction at dst
void idct_add(const int16_t* in, uint8_t* dst) {
  int c[16];
  int* tmp = c;
  for (int i = 0; i < 4; ++i) {  // vertical pass
    const int a = in[0] + in[8];
    const int b = in[0] - in[8];
    const int cc = mul2(in[4]) - mul1(in[12]);
    const int d = mul1(in[4]) + mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + cc;
    tmp[2] = b - cc;
    tmp[3] = a - d;
    tmp += 4;
    ++in;
  }
  tmp = c;
  for (int i = 0; i < 4; ++i) {  // horizontal pass
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8];
    const int b = dc - tmp[8];
    const int cc = mul2(tmp[4]) - mul1(tmp[12]);
    const int d = mul1(tmp[4]) + mul2(tmp[12]);
    dst[0] = clip8(dst[0] + ((a + d) >> 3));
    dst[1] = clip8(dst[1] + ((b + cc) >> 3));
    dst[2] = clip8(dst[2] + ((b - cc) >> 3));
    dst[3] = clip8(dst[3] + ((a - d) >> 3));
    ++tmp;
    dst += BPS;
  }
}

// the inverse Walsh-Hadamard transform of the Y2 block into the 16 Y
// blocks' DC coefficients (out[16 k])
void iwht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = static_cast<int16_t>((a0 + a1) >> 3);
    out[16] = static_cast<int16_t>((a3 + a2) >> 3);
    out[32] = static_cast<int16_t>((a0 - a1) >> 3);
    out[48] = static_cast<int16_t>((a3 - a2) >> 3);
    out += 64;
  }
}

// ------------------------------------------------------------ predictors

uint8_t avg3(int a, int b, int c) { return static_cast<uint8_t>((a + 2 * b + c + 2) >> 2); }
uint8_t avg2(int a, int b) { return static_cast<uint8_t>((a + b + 1) >> 1); }

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  for (int y = 0; y < size; ++y) {
    for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + dst[-1] - top[-1]);
    dst += BPS;
  }
}

void fill(uint8_t* dst, int size, int v) {
  for (int y = 0; y < size; ++y) memset(dst + y * BPS, v, size);
}

// 16x16 luma (size 16) or 8x8 chroma (size 8)
void predict_block(uint8_t* dst, int size, int mode) {
  const int shift = size == 16 ? 4 : 3;
  switch (mode) {
    case DC_PRED: {
      int dc = size;
      for (int j = 0; j < size; ++j) dc += dst[j - BPS] + dst[-1 + j * BPS];
      fill(dst, size, dc >> (shift + 1));
      break;
    }
    case DC_NOTOP: {
      int dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
      fill(dst, size, dc >> shift);
      break;
    }
    case DC_NOLEFT: {
      int dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[j - BPS];
      fill(dst, size, dc >> shift);
      break;
    }
    case DC_NOTOPLEFT:
      fill(dst, size, 0x80);
      break;
    case TM_PRED:
      true_motion(dst, size);
      break;
    case V_PRED:
      for (int j = 0; j < size; ++j) memcpy(dst + j * BPS, dst - BPS, size);
      break;
    case H_PRED:
      for (int j = 0; j < size; ++j) memset(dst + j * BPS, dst[j * BPS - 1], size);
      break;
  }
}

#define DST(x, y) dst[(x) + (y) * BPS]

void predict4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - BPS;
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3];
  const int E = top[4], F = top[5], G = top[6], H = top[7];
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
  switch (mode) {
    case B_DC_PRED: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += top[i] + dst[-1 + i * BPS];
      for (int i = 0; i < 4; ++i) memset(dst + i * BPS, dc >> 3, 4);
      break;
    }
    case B_TM_PRED:
      true_motion(dst, 4);
      break;
    case B_VE_PRED: {
      const uint8_t vals[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D), avg3(C, D, E)};
      for (int i = 0; i < 4; ++i) memcpy(dst + i * BPS, vals, 4);
      break;
    }
    case B_HE_PRED:
      memset(dst + 0 * BPS, avg3(X, I, J), 4);
      memset(dst + 1 * BPS, avg3(I, J, K), 4);
      memset(dst + 2 * BPS, avg3(J, K, L), 4);
      memset(dst + 3 * BPS, avg3(K, L, L), 4);
      break;
    case B_RD_PRED:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case B_LD_PRED:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case B_VR_PRED:
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case B_VL_PRED:
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case B_HD_PRED:
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    case B_HU_PRED:
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) =
          static_cast<uint8_t>(L);
      break;
  }
}

#undef DST

// ------------------------------------------------------------ loop filter

int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }  // [-1020, 1020]
int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }      // [-112, 112]
int iabs(int v) { return v < 0 ? -v : v; }

void filter2(uint8_t* p, int step) {  // 4 pixels in, 2 out
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

void filter4(uint8_t* p, int step) {  // 4 pixels in, 4 out
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

void filter6(uint8_t* p, int step) {  // 6 pixels in, 6 out
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return iabs(p1 - p0) > thresh || iabs(q1 - q0) > thresh;
}

bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * iabs(p0 - q0) + iabs(p1 - q1) <= t;
}

bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * iabs(p0 - q0) + iabs(p1 - q1) > t) return false;
  return iabs(p3 - p2) <= it && iabs(p2 - p1) <= it && iabs(p1 - p0) <= it &&
         iabs(q3 - q2) <= it && iabs(q2 - q1) <= it && iabs(q1 - q0) <= it;
}

// the simple filter across one edge of 16 pixels: ``step`` across it,
// ``along`` along it
void simple_edge(uint8_t* p, int step, int along, int thresh) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i)
    if (needs_filter(p + i * along, step, thresh2)) filter2(p + i * along, step);
}

// the normal filter across one edge of ``size`` pixels: the macroblock
// edge form (6 pixels changed) or the inner edge form (4)
void normal_edge(uint8_t* p, int step, int along, int size, int thresh, int ithresh,
                 int hev_thresh, bool mb_edge) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += along) {
    if (!needs_filter2(p, step, thresh2, ithresh)) continue;
    if (hev(p, step, hev_thresh))
      filter2(p, step);
    else if (mb_edge)
      filter6(p, step);
    else
      filter4(p, step);
  }
}

// ------------------------------------------------------------ the decoder

struct Decoder {
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  std::vector<uint8_t> Y, U, V;  // the macroblock grid, unfiltered until filter()
  int ys = 0, uvs = 0;

  bool use_segment = false, update_map = false, absolute_delta = true;
  int quantizer[4] = {0, 0, 0, 0}, filter_strength[4] = {0, 0, 0, 0};
  int seg_probs[3] = {255, 255, 255};
  bool simple = false;
  int level = 0, sharpness = 0;
  bool use_lf_delta = false;
  int ref_lf_delta[4] = {0, 0, 0, 0}, mode_lf_delta[4] = {0, 0, 0, 0};
  int filter_type = 0;  // 0 none, 1 simple, 2 normal
  int num_parts = 1;
  BoolReader br;
  BoolReader parts[8];
  uint8_t proba[4][8][3][11];
  bool use_skip = false;
  int skip_p = 0;
  Quant dqm[4];
  FilterInfo fstrengths[4][2];

  // per macroblock: for the loop filter
  std::vector<uint8_t> mb_segment, mb_i4x4, mb_inner;
  // contexts
  std::vector<uint8_t> intra_t;     // 4 sub-block modes per column
  uint8_t intra_l[4];
  std::vector<uint8_t> nz_top;      // per column: 4 Y, 2 U, 2 V, 1 Y2
  uint8_t nz_left[9];

  std::string error;

  bool fail(const std::string& why) {
    if (error.empty()) error = why;
    return false;
  }

  bool parse_headers(const uint8_t* buf, size_t size);
  void parse_quant();
  void parse_proba();
  void precompute_filter_strengths();
  int coeffs(BoolReader& tbr, int type, int ctx, const int* dq, int n, int16_t* out);
  bool decode_mb(int mb_x, int mb_y, BoolReader& tbr);
  void filter_mb(int mb_x, int mb_y);
};

bool Decoder::parse_headers(const uint8_t* buf, size_t size) {
  if (size < 4) return fail("VP8 frame header truncated");
  const uint32_t bits = buf[0] | (buf[1] << 8) | (buf[2] << 16);
  const bool key_frame = !(bits & 1);
  const int profile = (bits >> 1) & 7;
  const bool show = (bits >> 4) & 1;
  const uint32_t partition_length = bits >> 5;
  if (profile > 3) return fail("VP8 profile " + std::to_string(profile) + " (0-3 are defined)");
  if (!show) return fail("VP8 frame not displayable");
  buf += 3;
  size -= 3;
  if (!key_frame) return fail("VP8 frame is not a key frame");
  if (size < 7) return fail("VP8 picture header truncated");
  if (buf[0] != 0x9d || buf[1] != 0x01 || buf[2] != 0x2a)
    return fail("VP8 start code missing (9d 01 2a)");
  width = ((buf[4] << 8) | buf[3]) & 0x3fff;
  height = ((buf[6] << 8) | buf[5]) & 0x3fff;
  if (width == 0 || height == 0) return fail("VP8 frame of zero size");
  buf += 7;
  size -= 7;
  mb_w = (width + 15) >> 4;
  mb_h = (height + 15) >> 4;
  if (partition_length > size)
    return fail("VP8 first partition of " + std::to_string(partition_length) + " bytes, " +
                std::to_string(size) + " left in the chunk");
  br.init(buf, partition_length);
  buf += partition_length;
  size -= partition_length;

  br.literal(1);  // colour space
  br.literal(1);  // clamping type
  use_segment = br.literal(1);
  if (use_segment) {
    update_map = br.literal(1);
    if (br.literal(1)) {  // update the segments' data
      absolute_delta = br.literal(1);
      for (int s = 0; s < 4; ++s) quantizer[s] = br.literal(1) ? br.signed_literal(7) : 0;
      for (int s = 0; s < 4; ++s) filter_strength[s] = br.literal(1) ? br.signed_literal(6) : 0;
    }
    if (update_map)
      for (int s = 0; s < 3; ++s) seg_probs[s] = br.literal(1) ? br.literal(8) : 255;
  } else {
    update_map = false;
  }
  if (br.eof) return fail("VP8 segment header runs past the first partition");
  simple = br.literal(1);
  level = br.literal(6);
  sharpness = br.literal(3);
  use_lf_delta = br.literal(1);
  if (use_lf_delta && br.literal(1)) {  // update the deltas
    for (int i = 0; i < 4; ++i)
      if (br.literal(1)) ref_lf_delta[i] = br.signed_literal(6);
    for (int i = 0; i < 4; ++i)
      if (br.literal(1)) mode_lf_delta[i] = br.signed_literal(6);
  }
  filter_type = level == 0 ? 0 : simple ? 1 : 2;
  if (br.eof) return fail("VP8 filter header runs past the first partition");

  // token partitions: the sizes of all but the last, 3 bytes each
  num_parts = 1 << br.literal(2);
  const size_t last = static_cast<size_t>(num_parts - 1);
  if (size < 3 * last) return fail("VP8 token partition sizes truncated");
  const uint8_t* sz = buf;
  const uint8_t* part = buf + 3 * last;
  size_t left = size - 3 * last;
  for (size_t p = 0; p < last; ++p, sz += 3) {
    size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
    if (psize > left) psize = left;
    parts[p].init(part, psize);
    part += psize;
    left -= psize;
  }
  parts[last].init(part, left);
  if (left == 0) return fail("VP8 last token partition is empty: the chunk is truncated");

  parse_quant();
  br.literal(1);  // refresh entropy probs: ignored (one frame)
  parse_proba();
  return true;
}

void Decoder::parse_quant() {
  const int base_q0 = br.literal(7);
  const int dqy1_dc = br.literal(1) ? br.signed_literal(4) : 0;
  const int dqy2_dc = br.literal(1) ? br.signed_literal(4) : 0;
  const int dqy2_ac = br.literal(1) ? br.signed_literal(4) : 0;
  const int dquv_dc = br.literal(1) ? br.signed_literal(4) : 0;
  const int dquv_ac = br.literal(1) ? br.signed_literal(4) : 0;
  for (int i = 0; i < 4; ++i) {
    int q;
    if (use_segment) {
      q = quantizer[i];
      if (!absolute_delta) q += base_q0;
    } else {
      if (i > 0) {
        dqm[i] = dqm[0];
        continue;
      }
      q = base_q0;
    }
    Quant& m = dqm[i];
    m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
    m.y1[1] = kAcTable[clip(q, 127)];
    m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
    // x * 155 / 100 == (x * 101581) >> 16 for every x of the table
    m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
    if (m.y2[1] < 8) m.y2[1] = 8;
    m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
    m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
  }
}

void Decoder::parse_proba() {
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p)
          proba[t][b][c][p] = static_cast<uint8_t>(
              br.bit(kCoeffsUpdateProba[t][b][c][p]) ? br.literal(8) : kCoeffsProba0[t][b][c][p]);
  use_skip = br.literal(1);
  if (use_skip) skip_p = br.literal(8);
}

void Decoder::precompute_filter_strengths() {
  if (filter_type == 0) return;
  for (int s = 0; s < 4; ++s) {
    int base_level;
    if (use_segment) {
      base_level = filter_strength[s];
      if (!absolute_delta) base_level += level;
    } else {
      base_level = level;
    }
    for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
      FilterInfo& info = fstrengths[s][i4x4];
      int lvl = base_level;
      if (use_lf_delta) {
        lvl += ref_lf_delta[0];  // intra frame
        if (i4x4) lvl += mode_lf_delta[0];
      }
      lvl = lvl < 0 ? 0 : lvl > 63 ? 63 : lvl;
      if (lvl > 0) {
        int ilevel = lvl;
        if (sharpness > 0) {
          ilevel >>= sharpness > 4 ? 2 : 1;
          if (ilevel > 9 - sharpness) ilevel = 9 - sharpness;
        }
        if (ilevel < 1) ilevel = 1;
        info.ilevel = ilevel;
        info.limit = 2 * lvl + ilevel;
        info.hev_thresh = lvl >= 40 ? 2 : lvl >= 15 ? 1 : 0;
      } else {
        info.limit = 0;  // no filtering
      }
    }
  }
}

// the tokens of one 4x4 block from coefficient ``n`` on (RFC 6386 section
// 13); returns the index after the last non-zero coefficient (16 when the
// block runs to its end)
int Decoder::coeffs(BoolReader& tbr, int type, int ctx, const int* dq, int n, int16_t* out) {
  const uint8_t* p = proba[type][kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!tbr.bit(p[0])) return n;  // end of block
    while (!tbr.bit(p[1])) {       // a zero
      if (++n == 16) return 16;
      p = proba[type][kBands[n]][0];
    }
    int v;
    const uint8_t* next = proba[type][kBands[n + 1]][0];
    if (!tbr.bit(p[2])) {
      v = 1;
      next = proba[type][kBands[n + 1]][1];
    } else {
      if (!tbr.bit(p[3])) {
        if (!tbr.bit(p[4]))
          v = 2;
        else
          v = 3 + tbr.bit(p[5]);
      } else if (!tbr.bit(p[6])) {
        if (!tbr.bit(p[7])) {
          v = 5 + tbr.bit(159);
        } else {
          v = 7 + 2 * tbr.bit(165);
          v += tbr.bit(145);
        }
      } else {
        static const uint8_t kCat3[] = {173, 148, 140, 0};
        static const uint8_t kCat4[] = {176, 155, 140, 135, 0};
        static const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
        static const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
        static const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};
        const int bit1 = tbr.bit(p[8]);
        const int bit0 = tbr.bit(p[9 + bit1]);
        const int cat = 2 * bit1 + bit0;
        v = 0;
        for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + tbr.bit(*tab);
        v += 3 + (8 << cat);
      }
      next = proba[type][kBands[n + 1]][2];
    }
    const int sign = tbr.bit(0x80);
    out[kZigzag[n]] = static_cast<int16_t>((sign ? -v : v) * dq[n > 0]);
    p = next;
  }
  return 16;
}

uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
  nz_coeffs <<= 2;
  nz_coeffs |= (nz > 3) ? 3 : (nz > 1) ? 2 : dc_nz;
  return nz_coeffs;
}

// one macroblock: its modes from the first partition, its tokens, its
// prediction and residuals into the (unfiltered) planes
bool Decoder::decode_mb(int mb_x, int mb_y, BoolReader& tbr) {
  // modes
  int segment = 0;
  if (update_map)
    segment = !br.bit(seg_probs[0]) ? br.bit(seg_probs[1]) : br.bit(seg_probs[2]) + 2;
  const bool skip_flag = use_skip ? br.bit(skip_p) : false;
  const bool is_i4x4 = !br.bit(145);
  uint8_t* top = &intra_t[4 * mb_x];
  uint8_t modes[16];
  if (!is_i4x4) {
    const int ymode = br.bit(156) ? (br.bit(128) ? TM_PRED : H_PRED)
                                  : (br.bit(163) ? V_PRED : DC_PRED);
    modes[0] = static_cast<uint8_t>(ymode);
    memset(top, ymode, 4);
    memset(intra_l, ymode, 4);
  } else {
    for (int y = 0; y < 4; ++y) {
      int ymode = intra_l[y];
      for (int x = 0; x < 4; ++x) {
        const uint8_t* prob = kBModesProba[top[x]][ymode];
        // the sub-block mode tree of RFC 6386 section 11.2
        if (!br.bit(prob[0]))
          ymode = B_DC_PRED;
        else if (!br.bit(prob[1]))
          ymode = B_TM_PRED;
        else if (!br.bit(prob[2]))
          ymode = B_VE_PRED;
        else if (!br.bit(prob[3]))
          ymode = !br.bit(prob[4]) ? B_HE_PRED : !br.bit(prob[5]) ? B_RD_PRED : B_VR_PRED;
        else
          ymode = !br.bit(prob[6])   ? B_LD_PRED
                  : !br.bit(prob[7]) ? B_VL_PRED
                  : !br.bit(prob[8]) ? B_HD_PRED
                                     : B_HU_PRED;
        top[x] = static_cast<uint8_t>(ymode);
      }
      memcpy(modes + 4 * y, top, 4);
      intra_l[y] = static_cast<uint8_t>(ymode);
    }
  }
  const int uvmode = !br.bit(142)   ? DC_PRED
                     : !br.bit(114) ? V_PRED
                     : br.bit(183)  ? TM_PRED
                                    : H_PRED;

  // residuals
  int16_t coeff[384];
  memset(coeff, 0, sizeof(coeff));
  bool has[24] = {false};  // a block with a coefficient: its inverse DCT changes the prediction
  uint8_t* tnz = &nz_top[9 * mb_x];
  bool skip = skip_flag;
  if (!skip_flag) {
    const Quant& q = dqm[segment];
    uint32_t non_zero_y = 0, non_zero_uv = 0;
    int first;
    int ytype;
    if (!is_i4x4) {
      int16_t dc[16] = {0};
      const int ctx = tnz[8] + nz_left[8];
      const int nz = coeffs(tbr, 1, ctx, q.y2, 0, dc);
      tnz[8] = nz_left[8] = nz > 0;
      iwht(dc, coeff);
      first = 1;
      ytype = 0;
    } else {
      first = 0;
      ytype = 3;
    }
    for (int y = 0; y < 4; ++y) {
      uint32_t nz_coeffs = 0;
      for (int x = 0; x < 4; ++x) {
        int16_t* dst = coeff + 16 * (4 * y + x);
        const int ctx = nz_left[y] + tnz[x];
        const int nz = coeffs(tbr, ytype, ctx, q.y1, first, dst);
        nz_left[y] = tnz[x] = nz > first;
        nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
        has[4 * y + x] = nz > first || dst[0] != 0;
      }
      non_zero_y = (non_zero_y << 8) | nz_coeffs;
    }
    for (int ch = 0; ch < 2; ++ch) {
      uint32_t nz_coeffs = 0;
      for (int y = 0; y < 2; ++y) {
        for (int x = 0; x < 2; ++x) {
          int16_t* dst = coeff + 256 + 64 * ch + 16 * (2 * y + x);
          const int ctx = nz_left[4 + 2 * ch + y] + tnz[4 + 2 * ch + x];
          const int nz = coeffs(tbr, 2, ctx, q.uv, 0, dst);
          nz_left[4 + 2 * ch + y] = tnz[4 + 2 * ch + x] = nz > 0;
          nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
          has[16 + 4 * ch + 2 * y + x] = nz > 0;
        }
      }
      non_zero_uv |= nz_coeffs << (8 * ch);
    }
    skip = !(non_zero_y | non_zero_uv);
  } else {
    memset(tnz, 0, 8);
    memset(nz_left, 0, 8);
    if (!is_i4x4) tnz[8] = nz_left[8] = 0;
  }
  const int mb = mb_y * mb_w + mb_x;
  mb_segment[mb] = static_cast<uint8_t>(segment);
  mb_i4x4[mb] = is_i4x4;
  mb_inner[mb] = is_i4x4 || !skip;

  // prediction, into work buffers holding the edge samples
  uint8_t ybuf[17 * BPS], ubuf[9 * BPS], vbuf[9 * BPS];
  uint8_t* const y_dst = ybuf + BPS + 8;
  uint8_t* const u_dst = ubuf + BPS + 8;
  uint8_t* const v_dst = vbuf + BPS + 8;
  const int x0 = 16 * mb_x, y0 = 16 * mb_y;
  const int cx0 = 8 * mb_x, cy0 = 8 * mb_y;
  // above: 127 above the frame; above-right of the last column the above
  // row's last sample
  if (mb_y == 0) {
    memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
    memset(u_dst - BPS - 1, 127, 8 + 1);
    memset(v_dst - BPS - 1, 127, 8 + 1);
  } else {
    const uint8_t* above = &Y[(y0 - 1) * ys];
    memcpy(y_dst - BPS, above + x0, 16);
    if (mb_x < mb_w - 1)
      memcpy(y_dst - BPS + 16, above + x0 + 16, 4);
    else
      memset(y_dst - BPS + 16, above[x0 + 15], 4);
    memcpy(u_dst - BPS, &U[(cy0 - 1) * uvs + cx0], 8);
    memcpy(v_dst - BPS, &V[(cy0 - 1) * uvs + cx0], 8);
    if (mb_x == 0) {
      y_dst[-BPS - 1] = u_dst[-BPS - 1] = v_dst[-BPS - 1] = 129;
    } else {
      y_dst[-BPS - 1] = above[x0 - 1];
      u_dst[-BPS - 1] = U[(cy0 - 1) * uvs + cx0 - 1];
      v_dst[-BPS - 1] = V[(cy0 - 1) * uvs + cx0 - 1];
    }
  }
  // left: 129 left of the frame
  for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = mb_x ? Y[(y0 + j) * ys + x0 - 1] : 129;
  for (int j = 0; j < 8; ++j) {
    u_dst[j * BPS - 1] = mb_x ? U[(cy0 + j) * uvs + cx0 - 1] : 129;
    v_dst[j * BPS - 1] = mb_x ? V[(cy0 + j) * uvs + cx0 - 1] : 129;
  }
  auto check_mode = [&](int mode) {
    if (mode != DC_PRED) return mode;
    if (mb_x == 0) return mb_y == 0 ? static_cast<int>(DC_NOTOPLEFT) : static_cast<int>(DC_NOLEFT);
    return mb_y == 0 ? static_cast<int>(DC_NOTOP) : static_cast<int>(DC_PRED);
  };
  if (is_i4x4) {
    // the above-right samples repeated for the 4x4 rows below the first
    uint8_t* const top_right = y_dst - BPS + 16;
    for (int r = 1; r < 4; ++r) memcpy(top_right + 4 * r * BPS, top_right, 4);
    for (int n = 0; n < 16; ++n) {
      uint8_t* const dst = y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
      predict4(dst, modes[n]);
      if (has[n]) idct_add(coeff + 16 * n, dst);
    }
  } else {
    predict_block(y_dst, 16, check_mode(modes[0]));
    for (int n = 0; n < 16; ++n)
      if (has[n]) idct_add(coeff + 16 * n, y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS);
  }
  const int cmode = check_mode(uvmode);
  predict_block(u_dst, 8, cmode);
  predict_block(v_dst, 8, cmode);
  for (int n = 0; n < 4; ++n) {
    if (has[16 + n]) idct_add(coeff + 256 + 16 * n, u_dst + (n & 1) * 4 + (n >> 1) * 4 * BPS);
    if (has[20 + n]) idct_add(coeff + 320 + 16 * n, v_dst + (n & 1) * 4 + (n >> 1) * 4 * BPS);
  }
  for (int j = 0; j < 16; ++j) memcpy(&Y[(y0 + j) * ys + x0], y_dst + j * BPS, 16);
  for (int j = 0; j < 8; ++j) {
    memcpy(&U[(cy0 + j) * uvs + cx0], u_dst + j * BPS, 8);
    memcpy(&V[(cy0 + j) * uvs + cx0], v_dst + j * BPS, 8);
  }
  return true;
}

void Decoder::filter_mb(int mb_x, int mb_y) {
  const int mb = mb_y * mb_w + mb_x;
  const FilterInfo& f = fstrengths[mb_segment[mb]][mb_i4x4[mb]];
  const bool inner = mb_inner[mb];
  const int limit = f.limit;
  if (limit == 0) return;
  uint8_t* const y_dst = &Y[16 * mb_y * ys + 16 * mb_x];
  if (filter_type == 1) {  // simple: luma only
    if (mb_x > 0) simple_edge(y_dst, 1, ys, limit + 4);
    if (inner)
      for (int k = 1; k < 4; ++k) simple_edge(y_dst + 4 * k, 1, ys, limit);
    if (mb_y > 0) simple_edge(y_dst, ys, 1, limit + 4);
    if (inner)
      for (int k = 1; k < 4; ++k) simple_edge(y_dst + 4 * k * ys, ys, 1, limit);
    return;
  }
  uint8_t* const u_dst = &U[8 * mb_y * uvs + 8 * mb_x];
  uint8_t* const v_dst = &V[8 * mb_y * uvs + 8 * mb_x];
  const int il = f.ilevel, hev_t = f.hev_thresh;
  if (mb_x > 0) {
    normal_edge(y_dst, 1, ys, 16, limit + 4, il, hev_t, true);
    normal_edge(u_dst, 1, uvs, 8, limit + 4, il, hev_t, true);
    normal_edge(v_dst, 1, uvs, 8, limit + 4, il, hev_t, true);
  }
  if (inner) {
    for (int k = 1; k < 4; ++k) normal_edge(y_dst + 4 * k, 1, ys, 16, limit, il, hev_t, false);
    normal_edge(u_dst + 4, 1, uvs, 8, limit, il, hev_t, false);
    normal_edge(v_dst + 4, 1, uvs, 8, limit, il, hev_t, false);
  }
  if (mb_y > 0) {
    normal_edge(y_dst, ys, 1, 16, limit + 4, il, hev_t, true);
    normal_edge(u_dst, uvs, 1, 8, limit + 4, il, hev_t, true);
    normal_edge(v_dst, uvs, 1, 8, limit + 4, il, hev_t, true);
  }
  if (inner) {
    for (int k = 1; k < 4; ++k)
      normal_edge(y_dst + 4 * k * ys, ys, 1, 16, limit, il, hev_t, false);
    normal_edge(u_dst + 4 * uvs, uvs, 1, 8, limit, il, hev_t, false);
    normal_edge(v_dst + 4 * uvs, uvs, 1, 8, limit, il, hev_t, false);
  }
}

// ------------------------------------------------------------ YUV -> RGB

// libwebp's dsp/yuv.h, 14-bit fixed point
int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
uint8_t yuv_clip8(int v) {
  return static_cast<uint8_t>((v & ~16383) == 0 ? (v >> 6) : (v < 0) ? 0 : 255);
}
void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
  rgb[0] = yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  rgb[1] = yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  rgb[2] = yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

// libwebp's UpsampleRgbLinePair: the luma rows ``top_y`` and ``bottom_y``
// (null for a row paired with itself) between the chroma rows ``top_u`` /
// ``top_v`` (nearer the top row) and ``cur_u`` / ``cur_v``
void upsample_pair(const uint8_t* top_y, const uint8_t* bottom_y, const uint8_t* top_u,
                   const uint8_t* top_v, const uint8_t* cur_u, const uint8_t* cur_v,
                   uint8_t* top_dst, uint8_t* bottom_dst, int len) {
  const int last_pixel_pair = (len - 1) >> 1;
  int tl_u = top_u[0], tl_v = top_v[0];  // top-left
  int l_u = cur_u[0], l_v = cur_v[0];    // left
  yuv_to_rgb(top_y[0], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2, top_dst);
  if (bottom_y)
    yuv_to_rgb(bottom_y[0], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2, bottom_dst);
  for (int x = 1; x <= last_pixel_pair; ++x) {
    const int t_u = top_u[x], t_v = top_v[x];  // top
    const int c_u = cur_u[x], c_v = cur_v[x];  // current
    const int avg_u = tl_u + t_u + l_u + c_u + 8, avg_v = tl_v + t_v + l_v + c_v + 8;
    const int diag_12_u = (avg_u + 2 * (t_u + l_u)) >> 3;
    const int diag_12_v = (avg_v + 2 * (t_v + l_v)) >> 3;
    const int diag_03_u = (avg_u + 2 * (tl_u + c_u)) >> 3;
    const int diag_03_v = (avg_v + 2 * (tl_v + c_v)) >> 3;
    yuv_to_rgb(top_y[2 * x - 1], (diag_12_u + tl_u) >> 1, (diag_12_v + tl_v) >> 1,
               top_dst + 3 * (2 * x - 1));
    yuv_to_rgb(top_y[2 * x], (diag_03_u + t_u) >> 1, (diag_03_v + t_v) >> 1,
               top_dst + 3 * (2 * x));
    if (bottom_y) {
      yuv_to_rgb(bottom_y[2 * x - 1], (diag_03_u + l_u) >> 1, (diag_03_v + l_v) >> 1,
                 bottom_dst + 3 * (2 * x - 1));
      yuv_to_rgb(bottom_y[2 * x], (diag_12_u + c_u) >> 1, (diag_12_v + c_v) >> 1,
                 bottom_dst + 3 * (2 * x));
    }
    tl_u = t_u;
    tl_v = t_v;
    l_u = c_u;
    l_v = c_v;
  }
  if (!(len & 1)) {
    yuv_to_rgb(top_y[len - 1], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2,
               top_dst + 3 * (len - 1));
    if (bottom_y)
      yuv_to_rgb(bottom_y[len - 1], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2,
                 bottom_dst + 3 * (len - 1));
  }
}

void report(char* err, int err_len, const std::string& why) {
  if (err && err_len > 0) snprintf(err, static_cast<size_t>(err_len), "%s", why.c_str());
}

}  // namespace
}  // namespace hrbf_vp8

extern "C" {

// Decodes the VP8 key frame ``data`` (``n`` bytes: a "VP8 " chunk's payload
// and what follows it in its frame) into the planes ``y`` (``width`` x
// ``height``), ``u`` and ``v`` (((width + 1) / 2) x ((height + 1) / 2)),
// ``width`` and ``height`` being the frame header's.  Returns 0; or -1 with
// a NUL-terminated message in ``err`` (at most ``err_len`` bytes).
int vp8_decode_yuv(const uint8_t* data, size_t n, int width, int height, uint8_t* y,
                   uint8_t* u, uint8_t* v, char* err, int err_len) {
  using namespace hrbf_vp8;
  Decoder dec;
  if (!dec.parse_headers(data, n)) {
    report(err, err_len, dec.error);
    return -1;
  }
  if (dec.width != width || dec.height != height) {
    report(err, err_len, "VP8 frame is " + std::to_string(dec.width) + "x" +
                             std::to_string(dec.height) + ", the caller expected " +
                             std::to_string(width) + "x" + std::to_string(height));
    return -1;
  }
  dec.ys = 16 * dec.mb_w;
  dec.uvs = 8 * dec.mb_w;
  dec.Y.assign(static_cast<size_t>(dec.ys) * 16 * dec.mb_h, 0);
  dec.U.assign(static_cast<size_t>(dec.uvs) * 8 * dec.mb_h, 0);
  dec.V.assign(static_cast<size_t>(dec.uvs) * 8 * dec.mb_h, 0);
  const size_t n_mb = static_cast<size_t>(dec.mb_w) * dec.mb_h;
  dec.mb_segment.assign(n_mb, 0);
  dec.mb_i4x4.assign(n_mb, 0);
  dec.mb_inner.assign(n_mb, 0);
  dec.intra_t.assign(4 * static_cast<size_t>(dec.mb_w), B_DC_PRED);
  dec.nz_top.assign(9 * static_cast<size_t>(dec.mb_w), 0);
  dec.precompute_filter_strengths();
  for (int mb_y = 0; mb_y < dec.mb_h; ++mb_y) {
    memset(dec.intra_l, B_DC_PRED, sizeof(dec.intra_l));
    memset(dec.nz_left, 0, sizeof(dec.nz_left));
    BoolReader& tbr = dec.parts[mb_y & (dec.num_parts - 1)];
    for (int mb_x = 0; mb_x < dec.mb_w; ++mb_x) {
      dec.decode_mb(mb_x, mb_y, tbr);
      if (tbr.eof) {
        report(err, err_len, "VP8 token partition " + std::to_string(mb_y & (dec.num_parts - 1)) +
                                 " ends before macroblock (" + std::to_string(mb_x) + ", " +
                                 std::to_string(mb_y) + "): the data is truncated or corrupt");
        return -1;
      }
    }
    if (dec.br.eof) {
      report(err, err_len, "VP8 first partition ends before macroblock row " +
                               std::to_string(mb_y) + ": the data is truncated or corrupt");
      return -1;
    }
  }
  if (dec.filter_type > 0)
    for (int mb_y = 0; mb_y < dec.mb_h; ++mb_y)
      for (int mb_x = 0; mb_x < dec.mb_w; ++mb_x) dec.filter_mb(mb_x, mb_y);
  const int uv_w = (width + 1) / 2, uv_h = (height + 1) / 2;
  for (int j = 0; j < height; ++j)
    memcpy(y + static_cast<size_t>(j) * width, &dec.Y[j * dec.ys], width);
  for (int j = 0; j < uv_h; ++j) {
    memcpy(u + static_cast<size_t>(j) * uv_w, &dec.U[j * dec.uvs], uv_w);
    memcpy(v + static_cast<size_t>(j) * uv_w, &dec.V[j * dec.uvs], uv_w);
  }
  return 0;
}

// The frame header's settings, for the tests and the fixture script to name
// a file's form: ``info`` gets width, height, filter type (0 none, 1
// simple, 2 normal), filter level, sharpness, token partitions, segments
// on, segment map updated, skip probability on.  Returns 0, or -1 with
// a message in ``err``.
int vp8_frame_info(const uint8_t* data, size_t n, int* info, char* err, int err_len) {
  using namespace hrbf_vp8;
  Decoder dec;
  if (!dec.parse_headers(data, n)) {
    report(err, err_len, dec.error);
    return -1;
  }
  const int values[] = {dec.width, dec.height, dec.filter_type, dec.level, dec.sharpness,
                        dec.num_parts, dec.use_segment, dec.update_map, dec.use_skip};
  for (size_t i = 0; i < sizeof(values) / sizeof(values[0]); ++i) info[i] = values[i];
  return 0;
}

// libwebp's conversion of decoded planes to RGB (its fancy upsampler and
// VP8YUVToR / G / B): ``y`` ``width`` x ``height``, ``u`` and ``v``
// ((width + 1) / 2) x ((height + 1) / 2), into ``rgb`` (``height`` x
// ``width`` x 3).
void vp8_yuv_to_rgb(const uint8_t* y, const uint8_t* u, const uint8_t* v, int width, int height,
                    uint8_t* rgb) {
  using namespace hrbf_vp8;
  const size_t uv_w = static_cast<size_t>((width + 1) / 2);
  const size_t row = 3 * static_cast<size_t>(width);
  // the first row paired with itself
  upsample_pair(y, nullptr, u, v, u, v, rgb, nullptr, width);
  // rows 2k - 1 and 2k between chroma rows k - 1 and k
  int r = 1;
  for (; r + 1 < height; r += 2) {
    const size_t k = static_cast<size_t>((r + 1) / 2);
    upsample_pair(y + r * static_cast<size_t>(width), y + (r + 1) * static_cast<size_t>(width),
                  u + (k - 1) * uv_w, v + (k - 1) * uv_w, u + k * uv_w, v + k * uv_w,
                  rgb + r * row, rgb + (r + 1) * row, width);
  }
  // an even height's last row paired with itself
  if (r < height) {
    const size_t k = static_cast<size_t>(r / 2);
    upsample_pair(y + r * static_cast<size_t>(width), nullptr, u + k * uv_w, v + k * uv_w,
                  u + k * uv_w, v + k * uv_w, rgb + r * row, nullptr, width);
  }
}

}  // extern "C"
