// Native video decoder: libavformat/libavcodec demux+decode with frame
// threading, libswscale resize straight to RGB24 at the target size.
//
// The reference decodes with a serial Python cv2 loop
// (loader_data.py:152-166); SURVEY.md §7 hard-part 4 flags host decode as
// the real bottleneck of the 500 clips/s pipeline. This decoder removes the
// per-frame Python round trip: one vd_read() call fills a caller buffer
// with up to max_frames resized RGB frames, the GIL released the whole time
// (ctypes binding in vct_torch/data/videodec.py).
//
// C API (all exported with C linkage):
//   vd_open(path, out_w, out_h) -> handle | NULL   (0x0 = source size)
//   vd_dims(handle, int64[2]) -> {out_h, out_w}
//   vd_read(handle, out, max_frames) -> frames written (0 = EOF, <0 = error)
//   vd_close(handle)
//
// Build: g++ -O2 -shared -fPIC videodec.cpp -lavformat -lavcodec -lavutil
//        -lswscale -o libvideodec.so

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/display.h>
#include <libavutil/imgutils.h>
#include <libswscale/swscale.h>
}

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Decoder {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* codec = nullptr;
  SwsContext* sws = nullptr;
  AVPacket* pkt = nullptr;
  AVFrame* frame = nullptr;
  int stream_idx = -1;
  int out_w = 0, out_h = 0;
  // Display-matrix rotation, degrees CLOCKWISE to apply after decode
  // (OpenCV's auto-orientation convention); out_w/out_h are post-rotation.
  int rot = 0;
  std::vector<uint8_t> rot_buf;  // pre-rotation scaled frame when rot != 0
  // geometry the current SwsContext was built for (streams can change
  // resolution/pixel format mid-file; the scaler must follow)
  int sws_w = 0, sws_h = 0, sws_fmt = -1;
  bool eof_sent = false;   // drain packet delivered to the codec
  bool finished = false;   // codec fully drained
  bool pkt_pending = false;  // pkt held after a send-EAGAIN, resend next
};

void destroy(Decoder* d) {
  if (!d) return;
  if (d->sws) sws_freeContext(d->sws);
  if (d->frame) av_frame_free(&d->frame);
  if (d->pkt) av_packet_free(&d->pkt);
  if (d->codec) avcodec_free_context(&d->codec);
  if (d->fmt) avformat_close_input(&d->fmt);
  delete d;
}

// 90-degree-step rotation of an RGB24 image. src is sh rows x sw cols;
// dst gets (sw x sh) for 90/270 and (sh x sw) for 180.
void rotate_rgb24(const uint8_t* src, int sw, int sh, int rot, uint8_t* dst) {
  if (rot == 90) {  // clockwise: dst[y][x] = src[sh-1-x][y]
    for (int y = 0; y < sw; ++y)
      for (int x = 0; x < sh; ++x)
        std::memcpy(dst + (size_t)(y * sh + x) * 3,
                    src + (size_t)((sh - 1 - x) * sw + y) * 3, 3);
  } else if (rot == 180) {
    for (int y = 0; y < sh; ++y)
      for (int x = 0; x < sw; ++x)
        std::memcpy(dst + (size_t)(y * sw + x) * 3,
                    src + (size_t)((sh - 1 - y) * sw + (sw - 1 - x)) * 3, 3);
  } else {  // 270: counterclockwise: dst[y][x] = src[x][sw-1-y]
    for (int y = 0; y < sw; ++y)
      for (int x = 0; x < sh; ++x)
        std::memcpy(dst + (size_t)(y * sh + x) * 3,
                    src + (size_t)(x * sw + (sw - 1 - y)) * 3, 3);
  }
}

// Scale/convert the decoded frame into out (RGB24, out_h x out_w,
// display-matrix rotation applied).
bool emit(Decoder* d, uint8_t* out) {
  // Pre-rotation scale target: rotation then maps it onto (out_h, out_w).
  // A 90-degree-step rotation is a lossless pixel permutation, so in
  // source-size mode (bit-exact contract) this stays pure format conversion
  // and the rotation matches cv2's cv::rotate exactly.
  const bool swap = d->rot == 90 || d->rot == 270;
  const int sw = swap ? d->out_h : d->out_w;
  const int sh = swap ? d->out_w : d->out_h;
  if (!d->sws || d->frame->width != d->sws_w || d->frame->height != d->sws_h ||
      d->frame->format != d->sws_fmt) {
    if (d->sws) sws_freeContext(d->sws);
    d->sws = sws_getContext(
        d->frame->width, d->frame->height, (AVPixelFormat)d->frame->format,
        sw, sh, AV_PIX_FMT_RGB24, SWS_BILINEAR, nullptr, nullptr,
        nullptr);
    if (!d->sws) return false;
    d->sws_w = d->frame->width;
    d->sws_h = d->frame->height;
    d->sws_fmt = d->frame->format;
  }
  uint8_t* target = out;
  if (d->rot != 0) {
    d->rot_buf.resize((size_t)sw * sh * 3);
    target = d->rot_buf.data();
  }
  uint8_t* dst[4] = {target, nullptr, nullptr, nullptr};
  int dst_stride[4] = {sw * 3, 0, 0, 0};
  sws_scale(d->sws, d->frame->data, d->frame->linesize, 0, d->frame->height,
            dst, dst_stride);
  if (d->rot != 0) rotate_rgb24(target, sw, sh, d->rot, out);
  return true;
}

}  // namespace

extern "C" {

void* vd_open(const char* path, int out_w, int out_h) {
  auto* d = new Decoder();
  d->out_w = out_w;
  d->out_h = out_h;
  if (avformat_open_input(&d->fmt, path, nullptr, nullptr) < 0) {
    destroy(d);
    return nullptr;
  }
  if (avformat_find_stream_info(d->fmt, nullptr) < 0) {
    destroy(d);
    return nullptr;
  }
  const AVCodec* dec = nullptr;
  d->stream_idx =
      av_find_best_stream(d->fmt, AVMEDIA_TYPE_VIDEO, -1, -1, &dec, 0);
  if (d->stream_idx < 0 || !dec) {
    destroy(d);
    return nullptr;
  }
  d->codec = avcodec_alloc_context3(dec);
  if (!d->codec ||
      avcodec_parameters_to_context(
          d->codec, d->fmt->streams[d->stream_idx]->codecpar) < 0) {
    destroy(d);
    return nullptr;
  }
  d->codec->thread_count = 0;  // auto frame/slice threading
  if (avcodec_open2(d->codec, dec, nullptr) < 0) {
    destroy(d);
    return nullptr;
  }
  // Display-matrix rotation metadata (portrait phone/TikTok videos).
  // OpenCV's convention (cap_ffmpeg_impl.hpp): negate av_display_rotation_get
  // and normalize to [0, 360); the result is degrees to rotate CLOCKWISE,
  // applied automatically by cv2.VideoCapture — mirror it for parity.
  if (const uint8_t* sd = av_stream_get_side_data(
          d->fmt->streams[d->stream_idx], AV_PKT_DATA_DISPLAYMATRIX,
          nullptr)) {
    double theta = -av_display_rotation_get((const int32_t*)sd);
    theta -= 360 * std::floor(theta / 360 + 0.9 / 360);
    int r = ((int)std::lround(theta)) % 360;
    if (r == 90 || r == 180 || r == 270) d->rot = r;
  }
  if (d->out_w <= 0 || d->out_h <= 0) {
    // Decode at source size: swscale then only converts the pixel format,
    // which is bit-identical to cv2's decode (the caller resizes).
    // Post-rotation, a 90/270 source swaps width and height.
    const bool swap = d->rot == 90 || d->rot == 270;
    d->out_w = swap ? d->codec->height : d->codec->width;
    d->out_h = swap ? d->codec->width : d->codec->height;
  }
  d->pkt = av_packet_alloc();
  d->frame = av_frame_alloc();
  if (!d->pkt || !d->frame || d->out_w <= 0 || d->out_h <= 0) {
    destroy(d);
    return nullptr;
  }
  return d;
}

void vd_dims(void* handle, int64_t* out) {  // {out_h, out_w}
  auto* d = (Decoder*)handle;
  out[0] = d->out_h;
  out[1] = d->out_w;
}

// Fills `out` with up to max_frames RGB24 frames (out_h*out_w*3 bytes each,
// consecutive). Returns frames written; 0 at end of stream; -1 on error.
int64_t vd_read(void* handle, uint8_t* out, int64_t max_frames) {
  auto* d = (Decoder*)handle;
  if (!d || d->finished) return d && d->finished ? 0 : -1;
  const size_t frame_bytes = (size_t)d->out_w * d->out_h * 3;
  int64_t n = 0;
  while (n < max_frames) {
    int rc = avcodec_receive_frame(d->codec, d->frame);
    if (rc == 0) {
      if (!emit(d, out + n * frame_bytes)) return -1;
      av_frame_unref(d->frame);
      ++n;
      continue;
    }
    if (rc == AVERROR_EOF) {
      d->finished = true;
      break;
    }
    if (rc != AVERROR(EAGAIN)) return -1;
    // Codec wants input: feed the pending packet if one is held from a
    // previous send-EAGAIN, else the next video packet (or drain packet).
    if (d->eof_sent) continue;  // still draining
    while (true) {
      if (!d->pkt_pending) {
        int prc = av_read_frame(d->fmt, d->pkt);
        if (prc < 0) {
          avcodec_send_packet(d->codec, nullptr);  // start drain
          d->eof_sent = true;
          break;
        }
        if (d->pkt->stream_index != d->stream_idx) {
          av_packet_unref(d->pkt);
          continue;
        }
      }
      int src = avcodec_send_packet(d->codec, d->pkt);
      if (src == AVERROR(EAGAIN)) {
        // Codec wants frames drained first; KEEP the packet (unref would
        // drop its compressed frames) and resend after the next receive.
        d->pkt_pending = true;
        break;
      }
      d->pkt_pending = false;
      av_packet_unref(d->pkt);
      if (src < 0) return -1;
      break;
    }
  }
  return n;
}

void vd_close(void* handle) { destroy((Decoder*)handle); }

}  // extern "C"
