// Native .klg loader with background prefetch: the port's own copy of
// native/dataloader.cpp.
//
// The same C interface (klg_open, klg_num_frames, klg_next, klg_close) and
// the same design: a worker thread decodes frames ahead of the consumer
// into a ring of kRing frames, so the card never waits on host-side
// decompression (the reference decodes synchronously on the GUI thread,
// GUI/src/HRBF_fusion.cpp:216).  It differs from that file in three ways:
//   - JPEG colour goes through the port's own decoder (jpeg_decode.cpp,
//     linked into the same library), not libjpeg; like that file it reads
//     no other colour payload, and a PNG, BMP, netpbm, TIFF, GIF or WebP
//     one is an error that names its form;
//   - a frame that fails to decode is an error, not the end of the stream:
//     klg_next returns -1 once the frames before it are consumed, and
//     klg_error names the frame index and the cause (zlib's return code,
//     the JPEG decoder's reason, a size that differs from width x height);
//   - a payload shorter than its header says is an error too.  A header cut
//     short at the end of the file stays the end of the stream, as in
//     io/klg.py.
//
// Format (GUI/src/Tools/RawLogReader.cpp):
//   int32 numFrames
//   per frame: int64 timestamp, int32 depthSize, int32 imageSize,
//              depth payload (zlib u16 or raw), rgb payload (jpeg or raw)

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

#include "jpeg_decode.h"

namespace {

struct Frame {
  int64_t timestamp = 0;
  std::vector<float> depth;  // meters
  std::vector<float> rgb;    // [0,1] interleaved
};

enum class Next { kFrame, kEnd, kError };

struct Loader {
  FILE* f = nullptr;
  int width = 0, height = 0;
  float depth_scale = 1.0f / 1000.0f;
  int32_t num_frames = 0;
  int32_t read_cursor = 0;

  static constexpr int kRing = 4;
  Frame ring[kRing];
  int produced = 0, consumed = 0;
  bool eof = false, failed = false, stop = false;
  std::string error;  // set with failed, read once the worker has stopped
  std::mutex mu;
  std::condition_variable cv_produce, cv_consume;
  std::thread worker;

  std::vector<uint8_t> dbuf, ibuf, rgb8;
  std::vector<uint16_t> depth_u16;

  Next decode_next(Frame& out, std::string& err);
  void run();
};

Next Loader::decode_next(Frame& out, std::string& err) {
  if (read_cursor >= num_frames) return Next::kEnd;
  const int index = read_cursor;
  auto fail = [&](const std::string& why) {
    err = "frame " + std::to_string(index) + ": " + why;
    return Next::kError;
  };
  int64_t ts;
  int32_t dsize, isize;
  if (fread(&ts, 8, 1, f) != 1 || fread(&dsize, 4, 1, f) != 1 || fread(&isize, 4, 1, f) != 1)
    return Next::kEnd;
  if (dsize < 0 || isize < 0)
    return fail("negative payload size (depth " + std::to_string(dsize) + ", colour " +
                std::to_string(isize) + ")");
  dbuf.resize(dsize);
  ibuf.resize(isize);
  size_t got = dsize ? fread(dbuf.data(), 1, dsize, f) : 0;
  if (got != (size_t)dsize)
    return fail("depth payload truncated: " + std::to_string(got) + " of " +
                std::to_string(dsize) + " bytes");
  got = isize ? fread(ibuf.data(), 1, isize, f) : 0;
  if (got != (size_t)isize)
    return fail("colour payload truncated: " + std::to_string(got) + " of " +
                std::to_string(isize) + " bytes");
  ++read_cursor;

  const size_t raw_depth = (size_t)width * height * 2;
  const size_t raw_rgb = (size_t)width * height * 3;
  out.timestamp = ts;
  out.depth.resize((size_t)width * height);
  out.rgb.assign(raw_rgb, 0.0f);
  depth_u16.resize((size_t)width * height);

  if ((size_t)dsize == raw_depth) {
    memcpy(depth_u16.data(), dbuf.data(), raw_depth);
  } else {
    uLongf dest_len = raw_depth;
    int rc = uncompress(reinterpret_cast<Bytef*>(depth_u16.data()), &dest_len, dbuf.data(),
                        dsize);
    if (rc != Z_OK)
      return fail("zlib uncompress of the depth payload returned " + std::to_string(rc) +
                  (rc == Z_BUF_ERROR ? " (Z_BUF_ERROR: it inflates to more than " +
                                           std::to_string(raw_depth) + " bytes)"
                   : rc == Z_DATA_ERROR ? " (Z_DATA_ERROR: corrupt or incomplete data)" : ""));
    if (dest_len != raw_depth)
      return fail("depth inflates to " + std::to_string(dest_len) + " bytes, " +
                  std::to_string(width) + "x" + std::to_string(height) + " needs " +
                  std::to_string(raw_depth));
  }
  for (size_t i = 0; i < out.depth.size(); ++i) out.depth[i] = depth_u16[i] * depth_scale;

  if ((size_t)isize == raw_rgb) {
    for (size_t i = 0; i < raw_rgb; ++i) out.rgb[i] = ibuf[i] * (1.0f / 255.0f);
  } else if (isize > 0) {
    // a payload in another form that io/image reads: named, not decoded here
    static const uint8_t kPng[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};
    const uint8_t* p = ibuf.data();
    const char* form = nullptr;
    if (isize >= 8 && memcmp(p, kPng, 8) == 0)
      form = "PNG";
    else if (isize >= 2 && p[0] == 'B' && p[1] == 'M')
      form = "BMP";
    else if (isize >= 2 && p[0] == 'P' && strchr("123456f", p[1]) && p[1])
      form = "netpbm";
    else if (isize >= 4 && (memcmp(p, "II*\0", 4) == 0 || memcmp(p, "MM\0*", 4) == 0))
      form = "TIFF";
    else if (isize >= 6 && (memcmp(p, "GIF87a", 6) == 0 || memcmp(p, "GIF89a", 6) == 0))
      form = "GIF";
    else if (isize >= 16 && memcmp(p, "RIFF", 4) == 0 && memcmp(p + 8, "WEBP", 4) == 0 &&
             (memcmp(p + 12, "VP8 ", 4) == 0 || memcmp(p + 12, "VP8L", 4) == 0 ||
              memcmp(p + 12, "VP8X", 4) == 0))
      form = "WebP";
    if (form)
      return fail(std::string(form) + " colour payload: this loader decodes JPEG colour only "
                  "(io/klg.frames reads " + form + " colour)");
    int w = 0, h = 0;
    std::string why;
    if (!hrbf_jpeg::decode_rgb(ibuf.data(), isize, &w, &h, &rgb8, &why))
      return fail("JPEG colour payload: " + why);
    if (w != width || h != height)
      return fail("JPEG colour payload is " + std::to_string(w) + "x" + std::to_string(h) +
                  ", expected " + std::to_string(width) + "x" + std::to_string(height));
    for (size_t i = 0; i < raw_rgb; ++i) out.rgb[i] = rgb8[i] * (1.0f / 255.0f);
  }
  return Next::kFrame;
}

void Loader::run() {
  for (;;) {
    Frame local;
    std::string err;
    Next next = decode_next(local, err);
    std::unique_lock<std::mutex> lk(mu);
    if (next != Next::kFrame) {
      if (next == Next::kError) {
        error = err;
        failed = true;
      }
      eof = true;
      cv_consume.notify_all();
      return;
    }
    cv_produce.wait(lk, [&] { return stop || produced - consumed < kRing; });
    if (stop) return;
    ring[produced % kRing] = std::move(local);
    ++produced;
    cv_consume.notify_all();
  }
}

}  // namespace

extern "C" {

void* klg_open(const char* path, int width, int height, float depth_scale) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* l = new Loader();
  l->f = f;
  l->width = width;
  l->height = height;
  l->depth_scale = depth_scale;
  if (fread(&l->num_frames, 4, 1, f) != 1) {
    fclose(f);
    delete l;
    return nullptr;
  }
  l->worker = std::thread([l] { l->run(); });
  return l;
}

int klg_num_frames(void* h) { return static_cast<Loader*>(h)->num_frames; }

// Returns 1 for a frame, 0 at the end of the stream, -1 on an error (the
// frames decoded before it are returned first; klg_error says what failed).
int klg_next(void* h, float* depth_out, float* rgb_out, int64_t* ts_out) {
  auto* l = static_cast<Loader*>(h);
  std::unique_lock<std::mutex> lk(l->mu);
  l->cv_consume.wait(lk, [&] { return l->eof || l->produced > l->consumed; });
  if (l->produced == l->consumed) return l->failed ? -1 : 0;
  Frame& fr = l->ring[l->consumed % Loader::kRing];
  memcpy(depth_out, fr.depth.data(), fr.depth.size() * sizeof(float));
  memcpy(rgb_out, fr.rgb.data(), fr.rgb.size() * sizeof(float));
  *ts_out = fr.timestamp;
  ++l->consumed;
  l->cv_produce.notify_all();
  return 1;
}

// The message of the error klg_next reported ("" before one); valid until
// klg_close.
const char* klg_error(void* h) {
  auto* l = static_cast<Loader*>(h);
  std::lock_guard<std::mutex> lk(l->mu);
  return l->failed ? l->error.c_str() : "";
}

void klg_close(void* h) {
  auto* l = static_cast<Loader*>(h);
  {
    std::lock_guard<std::mutex> lk(l->mu);
    l->stop = true;
  }
  l->cv_produce.notify_all();
  if (l->worker.joinable()) l->worker.join();
  fclose(l->f);
  delete l;
}

}  // extern "C"
