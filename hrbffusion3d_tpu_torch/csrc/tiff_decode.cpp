// TIFF strip decompression with no library but zlib: the depth files of
// TUM-layout sequences, which the JAX package opens with Pillow (through
// libtiff).  io/tiff.py reads the container and applies the predictor;
// this file only inflates a strip, byte-serial work that would cost tens of
// milliseconds a frame in Python.
//
// Each codec fills ``dst`` with exactly ``dst_len`` bytes, as libtiff's
// codecs fill a strip:
//   - LZW (compression 5): new-style codes, most significant bit first, the
//     code width growing one code early; and the old-style form (least
//     significant bit first, no early change) that libtiff still reads,
//     told apart by the stream's first two bytes as libtiff tells them;
//   - deflate (8 and 32946): a zlib stream;
//   - PackBits (32773).
// Input left once the strip is full is ignored, as libtiff ignores it; a
// stream that ends before the strip is full, or that is corrupt, is an
// error with the reason.

#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>

#include <zlib.h>

namespace {

constexpr int kClear = 256, kEoi = 257, kFirst = 258, kMaxBits = 12, kTable = 1 << kMaxBits;

std::string short_by(size_t got, size_t want) {
  return "the stream ends after " + std::to_string(got) + " of the strip's " +
         std::to_string(want) + " bytes";
}

bool lzw(const uint8_t* src, size_t n, uint8_t* dst, size_t dst_len, std::string* err) {
  const bool old_style = n >= 2 && src[0] == 0 && (src[1] & 1);
  uint16_t prefix[kTable];
  uint16_t length[kTable];
  uint8_t suffix[kTable], first[kTable];
  for (int i = 0; i < 256; ++i) {
    prefix[i] = 0;
    length[i] = 1;
    suffix[i] = first[i] = static_cast<uint8_t>(i);
  }
  uint64_t acc = 0;
  int nacc = 0, nbits = 9, next = kFirst, prev = -1;
  size_t pos = 0, out = 0;
  while (out < dst_len) {
    while (nacc < nbits && pos < n) {
      if (old_style)
        acc |= static_cast<uint64_t>(src[pos++]) << nacc;
      else
        acc = (acc << 8) | src[pos++];
      nacc += 8;
    }
    if (nacc < nbits) {
      *err = "LZW: " + short_by(out, dst_len);
      return false;
    }
    int code;
    if (old_style) {
      code = static_cast<int>(acc & ((1u << nbits) - 1));
      acc >>= nbits;
    } else {
      code = static_cast<int>((acc >> (nacc - nbits)) & ((1u << nbits) - 1));
    }
    nacc -= nbits;
    if (!old_style) acc &= (nacc ? ((uint64_t{1} << nacc) - 1) : 0);
    if (code == kEoi) break;
    if (code == kClear) {
      nbits = 9;
      next = kFirst;
      prev = -1;
      continue;
    }
    if (prev < 0) {
      if (code > 255) {
        *err = "LZW: code " + std::to_string(code) + " right after a clear code";
        return false;
      }
      dst[out++] = static_cast<uint8_t>(code);
      prev = code;
      continue;
    }
    uint8_t head;
    int emit;
    if (code < next) {
      head = first[code];
      emit = code;
    } else if (code == next) {
      head = first[prev];
      emit = -1;  // the string of prev, then its first byte
    } else {
      *err = "LZW: code " + std::to_string(code) + " beyond the table's " + std::to_string(next);
      return false;
    }
    if (next >= kTable) {
      *err = "LZW: the code table overflows (no clear code)";
      return false;
    }
    prefix[next] = static_cast<uint16_t>(prev);
    suffix[next] = head;
    first[next] = first[prev];
    length[next] = static_cast<uint16_t>(length[prev] + 1);
    if (emit < 0) emit = next;
    ++next;
    // the string of ``emit``, written back to front; bytes past the strip's
    // end are dropped
    const size_t len = length[emit];
    size_t at = out + len;
    for (int c = emit;; c = prefix[c]) {
      --at;
      if (at < dst_len) dst[at] = suffix[c];
      if (length[c] == 1) break;
    }
    out = out + len < dst_len ? out + len : dst_len;
    prev = code;
    if (nbits < kMaxBits && next >= (1 << nbits) - (old_style ? 0 : 1)) ++nbits;
  }
  if (out < dst_len) {
    *err = "LZW: " + short_by(out, dst_len) + " (end-of-information code)";
    return false;
  }
  return true;
}

bool packbits(const uint8_t* src, size_t n, uint8_t* dst, size_t dst_len, std::string* err) {
  size_t pos = 0, out = 0;
  while (out < dst_len) {
    if (pos >= n) {
      *err = "PackBits: " + short_by(out, dst_len);
      return false;
    }
    const int c = static_cast<int8_t>(src[pos++]);
    if (c == -128) continue;
    if (c >= 0) {
      size_t k = static_cast<size_t>(c) + 1;
      if (pos + k > n) {
        *err = "PackBits: a literal run of " + std::to_string(k) + " bytes is cut short";
        return false;
      }
      const size_t take = k < dst_len - out ? k : dst_len - out;
      memcpy(dst + out, src + pos, take);
      pos += k;
      out += take;
    } else {
      if (pos >= n) {
        *err = "PackBits: a repeat run has no byte";
        return false;
      }
      const size_t k = static_cast<size_t>(1 - c);
      const size_t take = k < dst_len - out ? k : dst_len - out;
      memset(dst + out, src[pos++], take);
      out += take;
    }
  }
  return true;
}

bool deflate(const uint8_t* src, size_t n, uint8_t* dst, size_t dst_len, std::string* err) {
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) {
    *err = "deflate: inflateInit failed";
    return false;
  }
  zs.next_in = const_cast<Bytef*>(src);
  zs.next_out = dst;
  int rc = Z_OK;
  size_t in_left = n, out_left = dst_len;
  // avail_in / avail_out are 32-bit: feed in pieces
  while (out_left > 0 && rc == Z_OK) {
    const uInt in_piece = static_cast<uInt>(in_left < (1u << 30) ? in_left : (1u << 30));
    const uInt out_piece = static_cast<uInt>(out_left < (1u << 30) ? out_left : (1u << 30));
    zs.avail_in = in_piece;
    zs.avail_out = out_piece;
    rc = inflate(&zs, Z_NO_FLUSH);
    in_left -= in_piece - zs.avail_in;
    out_left -= out_piece - zs.avail_out;
    if (rc == Z_BUF_ERROR && in_left == 0) break;
  }
  inflateEnd(&zs);
  if (out_left > 0) {
    if (rc == Z_DATA_ERROR || rc == Z_STREAM_ERROR || rc == Z_MEM_ERROR || rc == Z_NEED_DICT)
      *err = std::string("deflate: zlib error ") + std::to_string(rc) +
             (zs.msg ? std::string(" (") + zs.msg + ")" : std::string());
    else
      *err = "deflate: " + short_by(dst_len - out_left, dst_len);
    return false;
  }
  return true;
}

}  // namespace

extern "C" {

// Decompresses one strip: ``src`` (``n`` bytes) in ``compression`` (5, 8,
// 32946 or 32773) into exactly ``dst_len`` bytes of ``dst``.  Returns 0;
// or -1 with a NUL-terminated message in ``err`` (at most ``err_len``
// bytes).
int tiff_decompress(const uint8_t* src, size_t n, int compression, uint8_t* dst,
                    size_t dst_len, char* err, int err_len) {
  std::string why;
  bool ok;
  switch (compression) {
    case 5:
      ok = lzw(src, n, dst, dst_len, &why);
      break;
    case 8:
    case 32946:
      ok = deflate(src, n, dst, dst_len, &why);
      break;
    case 32773:
      ok = packbits(src, n, dst, dst_len, &why);
      break;
    default:
      ok = false;
      why = "compression " + std::to_string(compression) + " has no decompressor here";
  }
  if (ok) return 0;
  if (err && err_len > 0) snprintf(err, static_cast<size_t>(err_len), "%s", why.c_str());
  return -1;
}

}  // extern "C"
