// Zstandard decompression (RFC 8878) with no library: the TIFF strips of
// compression 50000, which Pillow reads through libtiff's tif_zstd.c and
// libzstd.
//
// libtiff hands a strip to ZSTD_decompressStream until the strip is full,
// the input is spent or the call returns 0, which it does at the end of a
// frame.  So what it reads of a strip, and what this file reads, is:
//   - the first frame only: a second frame, or a skippable frame first,
//     leaves a strip that the first frame did not fill short, an error;
//     bytes after a frame that filled the strip are ignored;
//   - frame headers with the window descriptor, single segment and
//     content size; a dictionary ID other than 0 is refused (no
//     dictionary is loaded, libzstd's "dictionary mismatch"), as is a
//     reserved bit set, a window above 2^31 bytes and, where libzstd
//     streams (the content size unknown or above the strip), one above
//     its default limit of 2^27 + 1 bytes;
//   - raw, RLE and compressed blocks of at most min(window, 128 KiB);
//     literals raw, RLE, Huffman in 1 or 4 streams and treeless (the last
//     table); sequences predefined, RLE, FSE or repeat, the three repeat
//     offsets, matches back to the frame's start;
//   - blocks until the strip is full (and one block more when it fills at
//     a block's end, as libzstd decodes it before it finds no room); at the
//     frame's last block the content size is held to the frame header's
//     and the checksum (XXH64's low 32 bits), when present in the input,
//     to the content.
// A corrupt or short stream is an error with the reason.

#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

#include "tiff_codecs.h"

namespace {

[[noreturn]] void fail(const std::string& why) { throw std::runtime_error(why); }

constexpr uint32_t kMagic = 0xFD2FB528u;
constexpr size_t kBlockMax = 128 * 1024;
constexpr uint64_t kStreamWindowMax = (uint64_t{1} << 27) + 1;

inline int highbit(uint64_t v) { return 63 - __builtin_clzll(v); }

uint32_t le32(const uint8_t* p) {
  return p[0] | (uint32_t{p[1]} << 8) | (uint32_t{p[2]} << 16) | (uint32_t{p[3]} << 24);
}

uint64_t le64(const uint8_t* p) { return le32(p) | (uint64_t{le32(p + 4)} << 32); }

// ------------------------------------------------------------------ XXH64

constexpr uint64_t P1 = 11400714785074694791ull, P2 = 14029467366897019727ull,
                   P3 = 1609587929392839161ull, P4 = 9650029242287828579ull,
                   P5 = 2870177450012600261ull;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; }
inline uint64_t xmerge(uint64_t acc, uint64_t v) { return (acc ^ xround(0, v)) * P1 + P4; }

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    for (; p + 32 <= end; p += 32) {
      v1 = xround(v1, le64(p));
      v2 = xround(v2, le64(p + 8));
      v3 = xround(v3, le64(p + 16));
      v4 = xround(v4, le64(p + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(xmerge(xmerge(xmerge(h, v1), v2), v3), v4);
  } else {
    h = P5;
  }
  h += n;
  for (; p + 8 <= end; p += 8) h = rotl(h ^ xround(0, le64(p)), 27) * P1 + P4;
  if (p + 4 <= end) {
    h = rotl(h ^ (le32(p) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ (*p * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  return h ^ (h >> 32);
}

// ------------------------------------------------------------- bitstreams

// A backward bitstream: read from the end, the highest set bit of the last
// byte its start marker; bits below the stream's first are zeros.
struct BackBits {
  const uint8_t* p;
  size_t n;
  int64_t pos;  // the bits below ``pos`` are unread

  BackBits(const uint8_t* src, size_t len, const char* what) : p(src), n(len) {
    if (len == 0) fail(std::string(what) + ": an empty bitstream");
    if (src[len - 1] == 0) fail(std::string(what) + ": the bitstream's last byte is 0");
    pos = 8 * static_cast<int64_t>(len - 1) + highbit(src[len - 1]);
  }
  // bits [at, at + k) as an integer, the bit at + k - 1 its highest (k <= 32)
  uint64_t get(int64_t at, int k) const {
    if (k == 0 || at + k <= 0) return 0;
    int shift = 0;
    if (at < 0) {
      shift = static_cast<int>(-at);
      k -= shift;
      at = 0;
    }
    const size_t byte = static_cast<size_t>(at) >> 3;
    uint64_t w = 0;
    if (byte + 8 <= n) {
      memcpy(&w, p + byte, 8);  // little-endian host
    } else {
      for (size_t i = 0; byte + i < n; ++i) w |= uint64_t{p[byte + i]} << (8 * i);
    }
    w = (w >> (at & 7)) & ((uint64_t{1} << k) - 1);
    return w << shift;
  }
  uint64_t read(int k) {
    pos -= k;
    return get(pos, k);
  }
  uint64_t peek(int k) const { return get(pos - k, k); }
};

// ------------------------------------------------------------------- FSE

struct FseEntry {
  uint16_t symbol;
  uint8_t bits;
  uint16_t base;
};

struct Fse {
  int log = 0;
  std::vector<FseEntry> table;
};

// the decoding table of normalized counts (-1: "less than 1")
void build_fse(Fse* t, const int16_t* norm, int nsym, int log) {
  const int size = 1 << log;
  t->log = log;
  t->table.assign(size, FseEntry{0, 0, 0});
  std::vector<uint16_t> next(nsym);
  int high = size - 1;
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] == -1) {
      t->table[high--].symbol = static_cast<uint16_t>(s);
      next[s] = 1;
    } else {
      next[s] = static_cast<uint16_t>(norm[s]);
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  int pos = 0;
  for (int s = 0; s < nsym; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      t->table[pos].symbol = static_cast<uint16_t>(s);
      do pos = (pos + step) & mask;
      while (pos > high);
    }
  }
  if (pos != 0) fail("an FSE table's counts do not spread");
  for (int u = 0; u < size; ++u) {
    FseEntry& e = t->table[u];
    const int x = next[e.symbol]++;
    e.bits = static_cast<uint8_t>(log - highbit(x));
    e.base = static_cast<uint16_t>((x << e.bits) - size);
  }
}

// An FSE table description (RFC 8878 4.1.1) at ``src``: returns its bytes.
size_t read_fse(Fse* t, const uint8_t* src, size_t n, int max_log, int max_sym,
                const char* what) {
  size_t bit = 0;
  auto take = [&](int k) -> uint32_t {  // k <= 16 bits, little-endian
    uint32_t v = 0;
    for (int i = 0; i < k; ++i, ++bit)
      if ((bit >> 3) < n && ((src[bit >> 3] >> (bit & 7)) & 1)) v |= 1u << i;
    return v;
  };
  auto look = [&](int k) {
    const size_t at = bit;
    const uint32_t v = take(k);
    bit = at;
    return v;
  };
  const int log = static_cast<int>(take(4)) + 5;
  if (log > max_log)
    fail(std::string(what) + ": an FSE accuracy log of " + std::to_string(log) + " (at most " +
         std::to_string(max_log) + ")");
  int16_t norm[256] = {};
  int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1, sym = 0;
  while (remaining > 1) {
    if (sym > max_sym) fail(std::string(what) + ": an FSE table of too many symbols");
    const int max = (2 * threshold - 1) - remaining;
    int value;
    if (static_cast<int>(look(nbits - 1)) < max) {
      value = static_cast<int>(take(nbits - 1));
    } else {
      value = static_cast<int>(take(nbits));
      if (value >= threshold) value -= max;
    }
    const int count = value - 1;
    remaining -= count < 0 ? -count : count;
    norm[sym++] = static_cast<int16_t>(count);
    if (count == 0) {
      for (;;) {
        const int rep = static_cast<int>(take(2));
        sym += rep;
        if (rep != 3) break;
      }
      if (sym > max_sym + 1) fail(std::string(what) + ": an FSE table of too many symbols");
    }
    while (remaining < threshold && threshold > 1) {
      --nbits;
      threshold >>= 1;
    }
    if (remaining < 1) break;
  }
  if (remaining != 1) fail(std::string(what) + ": an FSE table's counts do not add up");
  const size_t used = (bit + 7) >> 3;
  if (used > n) fail(std::string(what) + ": an FSE table description runs past its section");
  build_fse(t, norm, sym, log);
  return used;
}

void rle_fse(Fse* t, int symbol) {
  t->log = 0;
  t->table.assign(1, FseEntry{static_cast<uint16_t>(symbol), 0, 0});
}

// ----------------------------------------------------------------- Huffman

struct Huffman {
  int log = 0;
  std::vector<uint8_t> symbol, bits;  // indexed by the next ``log`` bits
};

// A Huffman tree description (RFC 8878 4.2.1): returns its bytes.
size_t read_huffman(Huffman* h, const uint8_t* src, size_t n) {
  if (n < 1) fail("literals: the Huffman tree description is missing");
  uint8_t weights[256] = {};
  int count;
  size_t used;
  const int head = src[0];
  if (head < 128) {
    used = 1 + static_cast<size_t>(head);
    if (used > n) fail("literals: the Huffman weights run past the section");
    Fse t;
    const size_t desc = read_fse(&t, src + 1, head, 6, 255, "Huffman weights");
    BackBits b(src + 1 + desc, head - desc, "Huffman weights");
    uint32_t s1 = static_cast<uint32_t>(b.read(t.log)), s2 = static_cast<uint32_t>(b.read(t.log));
    count = 0;
    auto emit = [&](uint32_t* s) {
      if (count >= 255) fail("Huffman weights: more than 255");
      const FseEntry& e = t.table[*s];
      weights[count++] = static_cast<uint8_t>(e.symbol);
      *s = e.base + static_cast<uint32_t>(b.read(e.bits));
    };
    for (;;) {
      emit(&s1);
      if (b.pos < 0) {
        if (count >= 255) fail("Huffman weights: more than 255");
        weights[count++] = static_cast<uint8_t>(t.table[s2].symbol);
        break;
      }
      emit(&s2);
      if (b.pos < 0) {
        if (count >= 255) fail("Huffman weights: more than 255");
        weights[count++] = static_cast<uint8_t>(t.table[s1].symbol);
        break;
      }
    }
  } else {
    count = head - 127;
    used = 1 + static_cast<size_t>((count + 1) / 2);
    if (used > n) fail("literals: the Huffman weights run past the section");
    for (int i = 0; i < count; ++i)
      weights[i] = static_cast<uint8_t>(i & 1 ? src[1 + i / 2] & 15 : src[1 + i / 2] >> 4);
  }
  uint64_t total = 0;
  int rank[16] = {};
  for (int i = 0; i < count; ++i) {
    if (weights[i] > 12) fail("Huffman weights: a weight above 12");
    if (weights[i]) total += uint64_t{1} << (weights[i] - 1);
    ++rank[weights[i]];
  }
  if (total == 0) fail("Huffman weights: all zero");
  const int log = highbit(total) + 1;
  if (log > 11) fail("Huffman weights: a code longer than 11 bits");
  const uint64_t rest = (uint64_t{1} << log) - total;
  if (rest & (rest - 1)) fail("Huffman weights: the last weight is not a power of two");
  const int last = highbit(rest) + 1;
  weights[count] = static_cast<uint8_t>(last);
  ++rank[last];
  ++count;
  if (rank[1] < 2 || (rank[1] & 1)) fail("Huffman weights: an odd number of weight 1");
  h->log = log;
  h->symbol.assign(size_t{1} << log, 0);
  h->bits.assign(size_t{1} << log, 0);
  uint32_t start[16] = {};
  for (int w = 1, at = 0; w <= log; ++w) {
    start[w] = static_cast<uint32_t>(at);
    at += rank[w] << (w - 1);
  }
  for (int s = 0; s < count; ++s) {
    const int w = weights[s];
    if (!w) continue;
    const uint32_t len = 1u << (w - 1);
    for (uint32_t i = 0; i < len; ++i) {
      h->symbol[start[w] + i] = static_cast<uint8_t>(s);
      h->bits[start[w] + i] = static_cast<uint8_t>(log + 1 - w);
    }
    start[w] += len;
  }
  return used;
}

void huffman_stream(const Huffman& h, const uint8_t* src, size_t n, uint8_t* out, size_t count) {
  BackBits b(src, n, "literals");
  for (size_t i = 0; i < count; ++i) {
    const uint32_t v = static_cast<uint32_t>(b.peek(h.log));
    out[i] = h.symbol[v];
    b.pos -= h.bits[v];
  }
  if (b.pos != 0) fail("literals: a Huffman stream does not end where its symbols do");
}

// ------------------------------------------------------------- sequences

const uint32_t kLLBase[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
                              12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,   10,  11,  12,   13,   14,   15,   16,
                              17, 18, 19, 20, 21, 22, 23,  24,  25,  26,   27,   28,   29,   30,
                              31, 32, 33, 34, 35, 37, 39,  41,  43,  47,   51,   59,   67,   83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

struct Frame {
  std::vector<uint8_t>* out;
  size_t block_max = kBlockMax;
  Huffman huffman;
  bool have_huffman = false;
  Fse ll, of, ml;
  bool have_ll = false, have_of = false, have_ml = false;
  uint64_t rep[3] = {1, 4, 8};
  std::vector<uint8_t> literals;
};

// Symbol compression mode ``mode`` of one sequence code: returns its bytes.
size_t table(Fse* t, bool* have, int mode, const int16_t* def, int ndef, int def_log,
             int max_log, int max_sym, const uint8_t* src, size_t n, const char* what) {
  switch (mode) {
    case 0:
      build_fse(t, def, ndef, def_log);
      *have = true;
      return 0;
    case 1:
      if (n < 1) fail(std::string(what) + ": the RLE symbol is missing");
      if (src[0] > max_sym) fail(std::string(what) + ": an RLE symbol out of range");
      rle_fse(t, src[0]);
      *have = true;
      return 1;
    case 2: {
      const size_t used = read_fse(t, src, n, max_log, max_sym, what);
      *have = true;
      return used;
    }
    default:
      if (!*have) fail(std::string(what) + ": repeat mode with no table before it");
      return 0;
  }
}

size_t literals_section(Frame* f, const uint8_t* src, size_t n) {
  if (n < 1) fail("a compressed block without its literals section");
  const int type = src[0] & 3, form = (src[0] >> 2) & 3;
  size_t regen, head;
  std::vector<uint8_t>& lit = f->literals;
  if (type < 2) {
    if (form == 0 || form == 2) {
      head = 1;
      regen = src[0] >> 3;
    } else if (form == 1) {
      head = 2;
      if (n < 2) fail("literals: a header cut short");
      regen = (src[0] >> 4) + (size_t{src[1]} << 4);
    } else {
      head = 3;
      if (n < 3) fail("literals: a header cut short");
      regen = (src[0] >> 4) + (size_t{src[1]} << 4) + (size_t{src[2]} << 12);
    }
    if (regen > f->block_max) fail("literals: more than a block holds");
    if (type == 0) {
      if (head + regen > n) fail("literals: raw literals run past the block");
      lit.assign(src + head, src + head + regen);
      return head + regen;
    }
    if (head + 1 > n) fail("literals: the RLE byte is missing");
    lit.assign(regen, src[head]);
    return head + 1;
  }
  const int bits = form < 2 ? 10 : (form == 2 ? 14 : 18);
  head = form < 2 ? 3 : (form == 2 ? 4 : 5);
  if (n < head) fail("literals: a header cut short");
  uint64_t v = 0;
  for (size_t i = 0; i < head; ++i) v |= uint64_t{src[i]} << (8 * i);
  regen = static_cast<size_t>((v >> 4) & ((1u << bits) - 1));
  const size_t comp = static_cast<size_t>((v >> (4 + bits)) & ((1u << bits) - 1));
  const bool one = form == 0;
  if (regen > f->block_max) fail("literals: more than a block holds");
  if (head + comp > n) fail("literals: Huffman literals run past the block");
  if (!one && regen < 6) fail("literals: 4 streams for fewer than 6 literals");
  const uint8_t* p = src + head;
  size_t left = comp;
  if (type == 2) {
    const size_t used = read_huffman(&f->huffman, p, left);
    f->have_huffman = true;
    p += used;
    left -= used;
  } else if (!f->have_huffman) {
    fail("literals: treeless literals with no Huffman table before them");
  }
  lit.resize(regen);
  if (one) {
    huffman_stream(f->huffman, p, left, lit.data(), regen);
  } else {
    if (left < 10) fail("literals: a 4-stream section of fewer than 10 bytes");
    const size_t s1 = p[0] | (size_t{p[1]} << 8), s2 = p[2] | (size_t{p[3]} << 8),
                 s3 = p[4] | (size_t{p[5]} << 8);
    if (6 + s1 + s2 + s3 > left) fail("literals: the jump table points past the section");
    const size_t s4 = left - 6 - s1 - s2 - s3, seg = (regen + 3) / 4;
    if (3 * seg > regen) fail("literals: 4 streams for too few literals");
    const uint8_t* q = p + 6;
    huffman_stream(f->huffman, q, s1, lit.data(), seg);
    huffman_stream(f->huffman, q + s1, s2, lit.data() + seg, seg);
    huffman_stream(f->huffman, q + s1 + s2, s3, lit.data() + 2 * seg, seg);
    huffman_stream(f->huffman, q + s1 + s2 + s3, s4, lit.data() + 3 * seg, regen - 3 * seg);
  }
  return head + comp;
}

void compressed_block(Frame* f, const uint8_t* src, size_t n) {
  std::vector<uint8_t>& out = *f->out;
  const size_t block_start = out.size();
  const size_t lit_bytes = literals_section(f, src, n);
  const uint8_t* p = src + lit_bytes;
  size_t left = n - lit_bytes;
  if (left < 1) fail("sequences: the section is missing");
  size_t nseq = p[0];
  size_t head = 1;
  if (nseq >= 128) {
    if (nseq < 255) {
      if (left < 2) fail("sequences: a header cut short");
      nseq = ((nseq - 128) << 8) + p[1];
      head = 2;
    } else {
      if (left < 3) fail("sequences: a header cut short");
      nseq = p[1] + (size_t{p[2]} << 8) + 0x7F00;
      head = 3;
    }
  }
  const std::vector<uint8_t>& lit = f->literals;
  if (nseq == 0) {
    if (head != left) fail("sequences: bytes after a section of no sequences");
    out.insert(out.end(), lit.begin(), lit.end());
    return;
  }
  if (left < head + 1) fail("sequences: the compression modes are missing");
  const uint8_t modes = p[head];
  if (modes & 3) fail("sequences: the reserved bits of the compression modes are set");
  size_t at = head + 1;
  at += table(&f->ll, &f->have_ll, modes >> 6, kLLDefault, 36, 6, 9, 35, p + at, left - at,
              "literal lengths");
  at += table(&f->of, &f->have_of, (modes >> 4) & 3, kOFDefault, 29, 5, 8, 31, p + at,
              left - at, "offsets");
  at += table(&f->ml, &f->have_ml, (modes >> 2) & 3, kMLDefault, 53, 6, 9, 52, p + at,
              left - at, "match lengths");
  if (at > left) fail("sequences: the tables run past the block");
  BackBits b(p + at, left - at, "sequences");
  uint32_t sll = static_cast<uint32_t>(b.read(f->ll.log));
  uint32_t sof = static_cast<uint32_t>(b.read(f->of.log));
  uint32_t sml = static_cast<uint32_t>(b.read(f->ml.log));
  size_t li = 0;
  uint64_t* rep = f->rep;
  for (size_t i = 0; i < nseq; ++i) {
    const FseEntry &ell = f->ll.table[sll], &eof = f->of.table[sof], &eml = f->ml.table[sml];
    const int ofc = eof.symbol;
    if (ofc > 31) fail("sequences: an offset code above 31");
    const uint64_t ofval = (uint64_t{1} << ofc) + b.read(ofc);
    const uint64_t ml = kMLBase[eml.symbol] + b.read(kMLBits[eml.symbol]);
    const uint64_t ll = kLLBase[ell.symbol] + b.read(kLLBits[ell.symbol]);
    uint64_t offset;
    if (ofval > 3) {
      offset = ofval - 3;
      rep[2] = rep[1];
      rep[1] = rep[0];
      rep[0] = offset;
    } else {
      const int idx = static_cast<int>(ofval - 1) + (ll == 0);
      if (idx == 0) {
        offset = rep[0];
      } else if (idx == 1) {
        offset = rep[1];
        rep[1] = rep[0];
        rep[0] = offset;
      } else if (idx == 2) {
        offset = rep[2];
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = offset;
      } else {
        offset = rep[0] - 1;
        if (offset == 0) fail("sequences: a repeat offset of 0");
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = offset;
      }
    }
    if (ll > lit.size() - li) fail("sequences: more literals than the section holds");
    if (out.size() - block_start + ll + ml > f->block_max)
      fail("sequences: a block decodes to more than its maximum size");
    out.insert(out.end(), lit.begin() + static_cast<std::ptrdiff_t>(li),
               lit.begin() + static_cast<std::ptrdiff_t>(li + ll));
    li += ll;
    if (offset > out.size()) fail("sequences: a match reaches before the frame's start");
    size_t from = out.size() - offset;
    for (uint64_t k = 0; k < ml; ++k) out.push_back(out[from++]);
    if (i + 1 < nseq) {
      sll = ell.base + static_cast<uint32_t>(b.read(ell.bits));
      sml = eml.base + static_cast<uint32_t>(b.read(eml.bits));
      sof = eof.base + static_cast<uint32_t>(b.read(eof.bits));
    }
  }
  if (b.pos != 0) fail("sequences: the bitstream does not end where the sequences do");
  if (out.size() - block_start + (lit.size() - li) > f->block_max)
    fail("sequences: a block decodes to more than its maximum size");
  out.insert(out.end(), lit.begin() + static_cast<std::ptrdiff_t>(li), lit.end());
}

std::string short_by(size_t got, size_t want) {
  return "the stream ends after " + std::to_string(got) + " of the strip's " +
         std::to_string(want) + " bytes";
}

void decode(const uint8_t* src, size_t n, uint8_t* dst, size_t dst_len) {
  if (n < 4) fail(short_by(0, dst_len));
  const uint32_t magic = le32(src);
  if ((magic & 0xFFFFFFF0u) == 0x184D2A50u)
    fail("a skippable frame first: libtiff's codec stops after it, " + short_by(0, dst_len));
  if (magic != kMagic) fail("not a Zstandard frame (it starts with a magic of " +
                            std::to_string(magic) + ")");
  if (n < 5) fail(short_by(0, dst_len));
  const uint8_t fhd = src[4];
  const int fcs_flag = fhd >> 6, dict_flag = fhd & 3;
  const bool single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1;
  if (fhd & 8) fail("the frame header's reserved bit is set");
  size_t at = 5;
  uint64_t window = 0;
  const size_t dict_bytes = dict_flag == 3 ? 4 : dict_flag;
  const size_t fcs_bytes = fcs_flag == 0 ? (single ? 1 : 0) : (size_t{1} << fcs_flag);
  if (at + !single + dict_bytes + fcs_bytes > n) fail(short_by(0, dst_len));
  if (!single) {
    const int exponent = src[at] >> 3, mantissa = src[at] & 7;
    const uint64_t base = uint64_t{1} << (10 + exponent);
    window = base + (base >> 3) * mantissa;
    if (10 + exponent > 31) fail("a window of 2^" + std::to_string(10 + exponent) + " bytes");
    ++at;
  }
  uint64_t dict = 0;
  for (size_t i = 0; i < dict_bytes; ++i) dict |= uint64_t{src[at + i]} << (8 * i);
  at += dict_bytes;
  if (dict != 0)
    fail("the frame names dictionary " + std::to_string(dict) + ", and none is loaded");
  bool fcs_known = fcs_bytes > 0;
  uint64_t fcs = 0;
  for (size_t i = 0; i < fcs_bytes; ++i) fcs |= uint64_t{src[at + i]} << (8 * i);
  if (fcs_bytes == 2) fcs += 256;
  at += fcs_bytes;
  if (single) window = fcs;
  if (!(fcs_known && fcs <= dst_len) && window > kStreamWindowMax)
    fail("a window of " + std::to_string(window) + " bytes: above libzstd's streaming limit of " +
         std::to_string(kStreamWindowMax));

  std::vector<uint8_t> out;
  out.reserve(dst_len + kBlockMax);
  Frame f;
  f.out = &out;
  f.block_max = static_cast<size_t>(window < kBlockMax ? window : kBlockMax);
  bool extra = false;
  for (;;) {
    if (out.size() > dst_len) break;
    if (out.size() == dst_len) {
      if (extra) break;
      extra = true;
    }
    if (at + 3 > n) break;
    const uint32_t bh = src[at] | (uint32_t{src[at + 1]} << 8) | (uint32_t{src[at + 2]} << 16);
    at += 3;
    const bool last = bh & 1;
    const int type = (bh >> 1) & 3;
    const size_t size = bh >> 3;
    if (type == 3) fail("a block of the reserved type 3");
    if (size > f.block_max) fail("a block of " + std::to_string(size) + " bytes (at most " +
                                 std::to_string(f.block_max) + ")");
    const size_t in = type == 1 ? 1 : size;
    if (at + in > n) break;
    if (type == 0)
      out.insert(out.end(), src + at, src + at + size);
    else if (type == 1)
      out.insert(out.end(), size, src[at]);
    else
      compressed_block(&f, src + at, size);
    at += in;
    if (last) {
      if (fcs_known && out.size() != fcs)
        fail("the frame decodes to " + std::to_string(out.size()) + " bytes, its header says " +
             std::to_string(fcs));
      if (checksum && at + 4 <= n &&
          static_cast<uint32_t>(xxh64(out.data(), out.size())) != le32(src + at))
        fail("the content checksum does not match");
      break;
    }
  }
  if (out.size() < dst_len) fail(short_by(out.size(), dst_len));
  memcpy(dst, out.data(), dst_len);
}

}  // namespace

namespace hrbf_tiff {

bool zstd(const uint8_t* src, size_t n, uint8_t* dst, size_t dst_len, std::string* err) {
  try {
    decode(src, n, dst, dst_len);
    return true;
  } catch (const std::exception& e) {
    *err = std::string("ZSTD: ") + e.what();
    return false;
  }
}

}  // namespace hrbf_tiff
