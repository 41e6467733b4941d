// CCITT bilevel and ThunderScan decoding with no library: the TIFF strips
// of compression 2 (Modified Huffman), 3 (T.4), 4 (T.6), 32771 (Modified
// Huffman, word-aligned: libtiff's CCITT RLE/W) and 32809 (ThunderScan),
// which Pillow reads through libtiff (tif_fax3.c, tif_thunder.c).
//
// The fax decoders follow tif_fax3.c step for step, so that whatever
// libtiff reads cleanly comes out the same: its bit reader (the bytes of a
// fill-order-1 strip read most significant bit first, a lookup near the
// end padded with zeros), its code tables (a run of 11 zero bits is an EOL
// in the white and black tables), its search for a T.4 row's EOL (any bits
// before 11 zeros skipped, then zero bytes, then zeros to the 1), its run
// arrays and its changing elements b1 on the reference line (white at a
// strip's start), and its row alignment for compression 2 (a byte) and
// 32771 (16 bits of its bit buffer, then the raw pointer's parity).
// Where libtiff warns and pads a row (a bad code word, a row of the wrong
// length, an EOL inside a row, data that ends early, a T.6 end of block
// before the strip's last row, which leaves libtiff's rows after it
// unwritten) or fails, this file returns an error naming the row.
//
// ThunderScan follows tif_thunder.c: 4-bit pixels in runs, 2- and 3-bit
// deltas and raw values, each row on its own; a row with too few or too
// many pixels is an error, as in libtiff.

#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

#include "tiff_codecs.h"

namespace {

[[noreturn]] void fail(const std::string& why) { throw std::runtime_error(why); }

enum State : uint8_t {
  kInvalid, kPass, kHoriz, kV0, kVR, kVL, kExt, kTermW, kTermB, kMakeUpW, kMakeUpB, kMakeUp, kEOL
};

struct Entry {
  uint8_t state = kInvalid, width = 0;
  uint16_t param = 0;
};

struct Code {
  const char* bits;  // most significant bit first, as T.4 lists it
  uint16_t param;
};

// ITU-T T.4 tables 2 and 3: terminating codes 0-63, make-up codes 64-1728
const Code kWhiteTerm[] = {
    {"00110101", 0},  {"000111", 1},    {"0111", 2},      {"1000", 3},      {"1011", 4},
    {"1100", 5},      {"1110", 6},      {"1111", 7},      {"10011", 8},     {"10100", 9},
    {"00111", 10},    {"01000", 11},    {"001000", 12},   {"000011", 13},   {"110100", 14},
    {"110101", 15},   {"101010", 16},   {"101011", 17},   {"0100111", 18},  {"0001100", 19},
    {"0001000", 20},  {"0010111", 21},  {"0000011", 22},  {"0000100", 23},  {"0101000", 24},
    {"0101011", 25},  {"0010011", 26},  {"0100100", 27},  {"0011000", 28},  {"00000010", 29},
    {"00000011", 30}, {"00011010", 31}, {"00011011", 32}, {"00010010", 33}, {"00010011", 34},
    {"00010100", 35}, {"00010101", 36}, {"00010110", 37}, {"00010111", 38}, {"00101000", 39},
    {"00101001", 40}, {"00101010", 41}, {"00101011", 42}, {"00101100", 43}, {"00101101", 44},
    {"00000100", 45}, {"00000101", 46}, {"00001010", 47}, {"00001011", 48}, {"01010010", 49},
    {"01010011", 50}, {"01010100", 51}, {"01010101", 52}, {"00100100", 53}, {"00100101", 54},
    {"01011000", 55}, {"01011001", 56}, {"01011010", 57}, {"01011011", 58}, {"01001010", 59},
    {"01001011", 60}, {"00110010", 61}, {"00110011", 62}, {"00110100", 63}};
const Code kWhiteMakeUp[] = {
    {"11011", 64},      {"10010", 128},     {"010111", 192},    {"0110111", 256},
    {"00110110", 320},  {"00110111", 384},  {"01100100", 448},  {"01100101", 512},
    {"01101000", 576},  {"01100111", 640},  {"011001100", 704}, {"011001101", 768},
    {"011010010", 832}, {"011010011", 896}, {"011010100", 960}, {"011010101", 1024},
    {"011010110", 1088}, {"011010111", 1152}, {"011011000", 1216}, {"011011001", 1280},
    {"011011010", 1344}, {"011011011", 1408}, {"010011000", 1472}, {"010011001", 1536},
    {"010011010", 1600}, {"011000", 1664},   {"010011011", 1728}};
const Code kBlackTerm[] = {
    {"0000110111", 0},    {"010", 1},           {"11", 2},            {"10", 3},
    {"011", 4},           {"0011", 5},          {"0010", 6},          {"00011", 7},
    {"000101", 8},        {"000100", 9},        {"0000100", 10},      {"0000101", 11},
    {"0000111", 12},      {"00000100", 13},     {"00000111", 14},     {"000011000", 15},
    {"0000010111", 16},   {"0000011000", 17},   {"0000001000", 18},   {"00001100111", 19},
    {"00001101000", 20},  {"00001101100", 21},  {"00000110111", 22},  {"00000101000", 23},
    {"00000010111", 24},  {"00000011000", 25},  {"000011001010", 26}, {"000011001011", 27},
    {"000011001100", 28}, {"000011001101", 29}, {"000001101000", 30}, {"000001101001", 31},
    {"000001101010", 32}, {"000001101011", 33}, {"000011010010", 34}, {"000011010011", 35},
    {"000011010100", 36}, {"000011010101", 37}, {"000011010110", 38}, {"000011010111", 39},
    {"000001101100", 40}, {"000001101101", 41}, {"000011011010", 42}, {"000011011011", 43},
    {"000001010100", 44}, {"000001010101", 45}, {"000001010110", 46}, {"000001010111", 47},
    {"000001100100", 48}, {"000001100101", 49}, {"000001010010", 50}, {"000001010011", 51},
    {"000000100100", 52}, {"000000110111", 53}, {"000000111000", 54}, {"000000100111", 55},
    {"000000101000", 56}, {"000001011000", 57}, {"000001011001", 58}, {"000000101011", 59},
    {"000000101100", 60}, {"000001011010", 61}, {"000001100110", 62}, {"000001100111", 63}};
const Code kBlackMakeUp[] = {
    {"0000001111", 64},     {"000011001000", 128},  {"000011001001", 192},
    {"000001011011", 256},  {"000000110011", 320},  {"000000110100", 384},
    {"000000110101", 448},  {"0000001101100", 512}, {"0000001101101", 576},
    {"0000001001010", 640}, {"0000001001011", 704}, {"0000001001100", 768},
    {"0000001001101", 832}, {"0000001110010", 896}, {"0000001110011", 960},
    {"0000001110100", 1024}, {"0000001110101", 1088}, {"0000001110110", 1152},
    {"0000001110111", 1216}, {"0000001010010", 1280}, {"0000001010011", 1344},
    {"0000001010100", 1408}, {"0000001010101", 1472}, {"0000001011010", 1536},
    {"0000001011011", 1600}, {"0000001100100", 1664}, {"0000001100101", 1728}};
// T.4 table 3/T.4 (extended make-up codes, both colours)
const Code kExtMakeUp[] = {
    {"00000001000", 1792},  {"00000001100", 1856},  {"00000001101", 1920},
    {"000000010010", 1984}, {"000000010011", 2048}, {"000000010100", 2112},
    {"000000010101", 2176}, {"000000010110", 2240}, {"000000010111", 2304},
    {"000000011100", 2368}, {"000000011101", 2432}, {"000000011110", 2496},
    {"000000011111", 2560}};

// A lookup table of ``width`` bits: index bit k is the k-th bit of the
// stream (libtiff's bit buffer is least significant bit first).
struct Table {
  int width;
  std::vector<Entry> e;
  explicit Table(int w) : width(w), e(size_t{1} << w) {}
  void add(const char* bits, State state, uint16_t param) {
    const int len = static_cast<int>(strlen(bits));
    uint32_t v = 0;
    for (int k = 0; k < len; ++k)
      if (bits[k] == '1') v |= 1u << k;
    for (uint32_t hi = 0; hi < (1u << (width - len)); ++hi) {
      Entry& x = e[v | (hi << len)];
      x.state = state;
      x.width = static_cast<uint8_t>(len);
      x.param = param;
    }
  }
  template <size_t N>
  void add(const Code (&codes)[N], State state) {
    for (const Code& c : codes) add(c.bits, state, c.param);
  }
};

struct Tables {
  Table main{7}, white{12}, black{13};
  Tables() {
    main.add("0001", kPass, 0);
    main.add("001", kHoriz, 0);
    main.add("1", kV0, 0);
    main.add("011", kVR, 1);
    main.add("000011", kVR, 2);
    main.add("0000011", kVR, 3);
    main.add("010", kVL, 1);
    main.add("000010", kVL, 2);
    main.add("0000010", kVL, 3);
    main.add("0000001", kExt, 0);
    main.add("0000000", kEOL, 0);
    white.add(kWhiteTerm, kTermW);
    white.add(kWhiteMakeUp, kMakeUpW);
    white.add(kExtMakeUp, kMakeUp);
    white.add("00000000000", kEOL, 0);
    black.add(kBlackTerm, kTermB);
    black.add(kBlackMakeUp, kMakeUpB);
    black.add(kExtMakeUp, kMakeUp);
    black.add("00000000000", kEOL, 0);
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

uint8_t reversed(uint8_t b) {
  b = static_cast<uint8_t>((b & 0xF0) >> 4 | (b & 0x0F) << 4);
  b = static_cast<uint8_t>((b & 0xCC) >> 2 | (b & 0x33) << 2);
  return static_cast<uint8_t>((b & 0xAA) >> 1 | (b & 0x55) << 1);
}

struct Eof {};  // the data ran out where libtiff's decoder takes its EOF label

class Fax {
 public:
  Fax(const uint8_t* src, size_t n, int compression, int64_t width, uint32_t options, bool odd)
      : src_(src), n_(n), compression_(compression), lastx_(width), odd_(odd),
        t_(tables()) {
    for (int i = 0; i < 256; ++i) rev_[i] = reversed(static_cast<uint8_t>(i));
    two_d_ = compression == 4 || (compression == 3 && (options & 1));
    nruns_ = static_cast<size_t>((width + 1 + 31) / 32 * 32) * (two_d_ ? 2 : 1);
    cur_.assign(nruns_ + 4, 0);
    ref_.assign(nruns_ + 4, 0);
    ref_[0] = static_cast<uint32_t>(width);  // the reference line: all white
    ref_[1] = 0;
  }

  void decode(uint8_t* dst, size_t dst_len) {
    const size_t rowbytes = static_cast<size_t>((lastx_ + 7) / 8);
    if (rowbytes == 0 || dst_len % rowbytes) fail("a strip of fractional rows");
    memset(dst, 0, dst_len);
    for (size_t row = 0; row * rowbytes < dst_len; ++row) {
      line_ = static_cast<int64_t>(row);
      try {
        decode_row();
      } catch (const Eof&) {
        fail(where() + "the data ends (libtiff: premature EOF)");
      }
      fill(dst + row * rowbytes);
      if (two_d_) {
        if (compression_ == 4 || pa_ < thisrun_ + nruns_) setvalue(0);
        cur_.swap(ref_);
      }
    }
  }

 private:
  std::string where() const { return "row " + std::to_string(line_) + ": "; }
  [[noreturn]] void unexpected(const char* table) const {
    fail(where() + "a bad code word in the " + table + " table at x " + std::to_string(a0_) +
         " (libtiff pads the row)");
  }

  // libtiff's NeedBits8 / NeedBits16: false where it goes to its EOF label
  bool need8(int k) {
    if (avail_ < k) {
      if (cp_ >= n_) {
        if (avail_ == 0) return false;
        avail_ = k;  // padded with zeros
      } else {
        acc_ |= uint32_t{rev_[src_[cp_++]]} << avail_;
        avail_ += 8;
      }
    }
    return true;
  }
  bool need16(int k) {
    if (avail_ < k) {
      if (cp_ >= n_) {
        if (avail_ == 0) return false;
        avail_ = k;
      } else {
        acc_ |= uint32_t{rev_[src_[cp_++]]} << avail_;
        if ((avail_ += 8) < k) {
          if (cp_ >= n_) {
            avail_ = k;
          } else {
            acc_ |= uint32_t{rev_[src_[cp_++]]} << avail_;
            avail_ += 8;
          }
        }
      }
    }
    return true;
  }
  uint32_t get(int k) const { return acc_ & ((1u << k) - 1); }
  void clr(int k) {
    avail_ -= k;
    acc_ >>= k;
  }
  const Entry& lookup(const Table& t, bool sixteen) {
    if (!(sixteen ? need16(t.width) : need8(t.width))) throw Eof{};
    const Entry& e = t.e[get(t.width)];
    clr(e.width);
    return e;
  }

  void setvalue(int64_t x) {
    if (pa_ >= thisrun_ + nruns_ + 2) fail(where() + "more runs than the row holds");
    *pa_++ = static_cast<uint32_t>(run_ + x);
    a0_ += x;
    run_ = 0;
  }

  // libtiff's CLEANUP_RUNS, whose repairs are refused
  void cleanup() {
    if (run_) setvalue(0);
    if (a0_ != lastx_)
      fail(where() + "runs of " + std::to_string(a0_) + " pixels for a row of " +
           std::to_string(lastx_) + " (libtiff pads the row)");
  }

  // SYNC_EOL: to the bit after the next EOL
  void sync_eol() {
    if (eolcnt_ == 0) {
      for (;;) {
        if (!need16(11)) throw Eof{};
        if (get(11) == 0) break;
        clr(1);
      }
    }
    for (;;) {
      if (!need8(8)) throw Eof{};
      if (get(8)) break;
      clr(8);
    }
    while (get(1) == 0) clr(1);
    clr(1);
    eolcnt_ = 0;
  }

  // EXPAND1D: a row of white and black runs
  void expand1d() {
    for (;;) {
      for (;;) {
        const Entry& e = lookup(t_.white, true);
        if (e.state == kEOL) {
          eolcnt_ = 1;
          cleanup();
          return;
        }
        if (e.state == kTermW) {
          setvalue(e.param);
          break;
        }
        if (e.state != kMakeUpW && e.state != kMakeUp) unexpected("white");
        a0_ += e.param;
        run_ += e.param;
      }
      if (a0_ >= lastx_) break;
      for (;;) {
        const Entry& e = lookup(t_.black, true);
        if (e.state == kEOL) {
          eolcnt_ = 1;
          cleanup();
          return;
        }
        if (e.state == kTermB) {
          setvalue(e.param);
          break;
        }
        if (e.state != kMakeUpB && e.state != kMakeUp) unexpected("black");
        a0_ += e.param;
        run_ += e.param;
      }
      if (a0_ >= lastx_) break;
      if (pa_[-1] == 0 && pa_[-2] == 0) pa_ -= 2;
    }
    cleanup();
  }

  void check_b1() {
    if (pa_ != thisrun_) {
      while (b1_ <= a0_ && b1_ < lastx_) {
        if (pb_ + 1 >= ref_.data() + nruns_) fail(where() + "a reference line overflow");
        b1_ += pb_[0] + pb_[1];
        pb_ += 2;
      }
    }
  }

  // the two runs of horizontal mode, of ``first`` then the other colour
  void horizontal(const Table& first, State term, State makeup, const Table& second,
                  State term2, State makeup2) {
    for (;;) {
      const Entry& e = lookup(first, true);
      if (e.state == term) {
        setvalue(e.param);
        break;
      }
      if (e.state != makeup && e.state != kMakeUp)
        unexpected(term == kTermW ? "white" : "black");
      a0_ += e.param;
      run_ += e.param;
    }
    for (;;) {
      const Entry& e = lookup(second, true);
      if (e.state == term2) {
        setvalue(e.param);
        break;
      }
      if (e.state != makeup2 && e.state != kMakeUp)
        unexpected(term2 == kTermW ? "white" : "black");
      a0_ += e.param;
      run_ += e.param;
    }
  }

  // EXPAND2D: a row coded against the reference line
  void expand2d() {
    uint32_t* const ref_end = ref_.data() + nruns_;
    while (a0_ < lastx_) {
      if (pa_ >= thisrun_ + nruns_) fail(where() + "a run buffer overflow");
      const Entry& e = lookup(t_.main, false);
      switch (e.state) {
        case kPass:
          check_b1();
          if (pb_ + 1 >= ref_end) fail(where() + "a reference line overflow");
          b1_ += *pb_++;
          run_ += b1_ - a0_;
          a0_ = b1_;
          b1_ += *pb_++;
          break;
        case kHoriz:
          if ((pa_ - thisrun_) & 1)
            horizontal(t_.black, kTermB, kMakeUpB, t_.white, kTermW, kMakeUpW);
          else
            horizontal(t_.white, kTermW, kMakeUpW, t_.black, kTermB, kMakeUpB);
          check_b1();
          break;
        case kV0:
        case kVR:
          check_b1();
          setvalue(b1_ - a0_ + (e.state == kVR ? e.param : 0));
          if (pb_ >= ref_end) fail(where() + "a reference line overflow");
          b1_ += *pb_++;
          break;
        case kVL:
          check_b1();
          if (b1_ < a0_ + e.param) unexpected("VL");
          setvalue(b1_ - a0_ - e.param);
          if (pb_ <= ref_.data()) fail(where() + "a reference line underflow");
          b1_ -= *--pb_;
          break;
        case kExt:
          fail(where() + "an extension code (uncompressed mode, which libtiff does not read)");
        case kEOL:
          if (compression_ == 4) {
            fail(where() + "an end of block before the strip's last row (libtiff leaves the "
                           "rows after it unwritten)");
          }
          fail(where() + "an EOL inside the row (libtiff pads the row)");
        default:
          unexpected("mode");
      }
    }
    if (run_) {
      if (run_ + a0_ < lastx_) {  // never taken: a0 >= lastx here, as in libtiff
        if (!need8(1)) throw Eof{};
        if (!get(1)) unexpected("mode");
        clr(1);
      }
      setvalue(0);
    }
    cleanup();
  }

  void decode_row() {
    a0_ = 0;
    run_ = 0;
    thisrun_ = pa_ = cur_.data();
    switch (compression_) {
      case 2:
      case 32771:
        expand1d();
        if (compression_ == 2) {
          clr(avail_ - (avail_ & ~7));
        } else {
          clr(avail_ - (avail_ & ~15));
          if (avail_ == 0 && ((cp_ + (odd_ ? 1 : 0)) & 1)) ++cp_;
        }
        break;
      case 3:
        sync_eol();
        if (two_d_) {
          if (!need8(1)) throw Eof{};
          const bool one_d = get(1);
          clr(1);
          pb_ = ref_.data();
          b1_ = *pb_++;
          if (one_d)
            expand1d();
          else
            expand2d();
        } else {
          expand1d();
        }
        break;
      default:  // 4
        pb_ = ref_.data();
        b1_ = *pb_++;
        expand2d();
    }
  }

  // libtiff's _TIFFFax3fillruns: white runs 0, black runs 1, most
  // significant bit first
  void fill(uint8_t* row) const {
    int64_t x = 0;
    bool black = false;
    for (const uint32_t* r = thisrun_; r < pa_; ++r, black = !black) {
      const int64_t end = x + *r;
      if (black)
        for (int64_t i = x; i < end; ++i) row[i >> 3] |= static_cast<uint8_t>(0x80 >> (i & 7));
      x = end;
    }
  }

  const uint8_t* src_;
  size_t n_, cp_ = 0;
  int compression_;
  int64_t lastx_;
  bool odd_, two_d_;
  const Tables& t_;
  uint8_t rev_[256];
  uint32_t acc_ = 0;
  int avail_ = 0, eolcnt_ = 0;
  size_t nruns_;
  std::vector<uint32_t> cur_, ref_;
  uint32_t *thisrun_ = nullptr, *pa_ = nullptr, *pb_ = nullptr;
  int64_t a0_ = 0, b1_ = 0, run_ = 0, line_ = 0;
};

// tif_thunder.c's ThunderDecode of one row of ``width`` pixels from
// ``src[*at..n)``
void thunder_row(const uint8_t* src, size_t n, size_t* at, int64_t width, uint8_t* row,
                 int64_t line) {
  static const int two[4] = {0, 1, 0, -1};
  static const int three[8] = {0, 1, 2, 3, 0, -3, -2, -1};
  const std::string where = "row " + std::to_string(line) + ": ";
  uint8_t* op = row;
  unsigned last = 0;
  int64_t npixels = 0;
  auto set = [&](unsigned v) {
    last = v & 0xf;
    if (npixels < width) {
      if (npixels++ & 1)
        *op++ |= static_cast<uint8_t>(last);
      else
        op[0] = static_cast<uint8_t>(last << 4);
    }
  };
  while (*at < n && npixels < width) {
    int c = src[(*at)++];
    switch (c & 0xc0) {
      case 0x00: {  // a run of the last pixel, c & 0x3f times
        int k = c & 0x3f;
        if (npixels & 1) {
          op[0] |= static_cast<uint8_t>(last);
          last = *op++;
          ++npixels;
          --k;
        } else {
          last |= last << 4;
        }
        npixels += k;
        if (npixels <= width) {
          for (; k > 0; k -= 2) *op++ = static_cast<uint8_t>(last);
        }
        if (k == -1) *--op &= 0xf0;
        last &= 0xf;
        break;
      }
      case 0x40: {  // three 2-bit deltas, 2 skips
        int d;
        if ((d = (c >> 4) & 3) != 2) set(last + two[d]);
        if ((d = (c >> 2) & 3) != 2) set(last + two[d]);
        if ((d = c & 3) != 2) set(last + two[d]);
        break;
      }
      case 0x80: {  // two 3-bit deltas, 4 skips
        int d;
        if ((d = (c >> 3) & 7) != 4) set(last + three[d]);
        if ((d = c & 7) != 4) set(last + three[d]);
        break;
      }
      default:  // raw
        set(static_cast<unsigned>(c));
    }
  }
  if (npixels != width)
    fail(where + (npixels < width ? "not enough" : "too much") + " data (" +
         std::to_string(npixels) + " of " + std::to_string(width) + " pixels)");
}

}  // namespace

namespace hrbf_tiff {

bool fax(const uint8_t* src, size_t n, int compression, int64_t width, uint32_t options, bool odd,
         uint8_t* dst, size_t dst_len, std::string* err) {
  const char* name = compression == 2 ? "CCITT 1D" : compression == 3 ? "CCITT group 3"
                     : compression == 4 ? "CCITT group 4" : "CCITT RLE/W";
  try {
    if (width < 1) fail("a row of no pixels");
    Fax(src, n, compression, width, options, odd).decode(dst, dst_len);
    return true;
  } catch (const std::exception& e) {
    *err = std::string(name) + ": " + e.what();
    return false;
  }
}

bool thunderscan(const uint8_t* src, size_t n, int64_t width, uint8_t* dst, size_t dst_len,
                 std::string* err) {
  try {
    const size_t rowbytes = static_cast<size_t>((width * 4 + 7) / 8);
    if (width < 1 || dst_len % rowbytes) fail("a strip of fractional rows");
    size_t at = 0;
    for (size_t row = 0; row * rowbytes < dst_len; ++row)
      thunder_row(src, n, &at, width, dst + row * rowbytes, static_cast<int64_t>(row));
    return true;
  } catch (const std::exception& e) {
    *err = std::string("ThunderScan: ") + e.what();
    return false;
  }
}

}  // namespace hrbf_tiff
