// Native libav video decode/encode with a C API for Python (ctypes).
//
// Replaces the reference's libav reader/writer
// (/root/reference/src/io/image_sequence_reader.cc: demux + decode + RGB
// conversion with 0/90/180/270 rotation-metadata handling and delayed-frame
// drain; image_sequence_writer.cc: lazy-initialized H.264 sink, 4 Mbps,
// GOP 12, yuv420p, flush on close) on the modern send/receive libav API
// (ffmpeg 5.x).
//
// Build: native/CMakeLists.txt -> libpgvideo.so; Python binding:
// pilotguru/video/native.py.

#include <cstdint>
#include <cstring>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/display.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libswscale/swscale.h>
}

namespace {

int NormalizedRotation(AVStream *stream) {
  // Display-matrix side data -> rotation in {0, 90, 180, 270} (counter-
  // rotation to apply so the image displays upright).
  const uint8_t *data =
      av_stream_get_side_data(stream, AV_PKT_DATA_DISPLAYMATRIX, nullptr);
  if (data == nullptr) return 0;
  const double angle =
      av_display_rotation_get(reinterpret_cast<const int32_t *>(data));
  int rotation = static_cast<int>(-angle) % 360;
  if (rotation < 0) rotation += 360;
  rotation = ((rotation + 45) / 90 * 90) % 360;
  return rotation;
}

void RotateRgb(const uint8_t *src, int w, int h, int rotation,
               int vertical_flip, int horizontal_flip, uint8_t *dst) {
  // Output dims: (w, h) for 0/180, (h, w) for 90/270.
  if (rotation == 0) {
    std::memcpy(dst, src, static_cast<size_t>(w) * h * 3);
  } else if (rotation == 180) {
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x)
        std::memcpy(dst + ((h - 1 - y) * w + (w - 1 - x)) * 3,
                    src + (y * w + x) * 3, 3);
  } else if (rotation == 90) {
    // 90 deg clockwise: dst has shape (w rows, h cols);
    // dst[x][h-1-y] = src[y][x]
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x)
        std::memcpy(dst + (x * h + (h - 1 - y)) * 3, src + (y * w + x) * 3, 3);
  } else {  // 270: dst[w-1-x][y] = src[y][x]
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x)
        std::memcpy(dst + ((w - 1 - x) * h + y) * 3, src + (y * w + x) * 3, 3);
  }
  const int fw = (rotation % 180 == 0) ? w : h;
  const int fh = (rotation % 180 == 0) ? h : w;
  if (vertical_flip) {
    for (int y = 0; y < fh / 2; ++y)
      for (int x = 0; x < fw * 3; ++x)
        std::swap(dst[y * fw * 3 + x], dst[(fh - 1 - y) * fw * 3 + x]);
  }
  if (horizontal_flip) {
    for (int y = 0; y < fh; ++y)
      for (int x = 0; x < fw / 2; ++x)
        for (int c = 0; c < 3; ++c)
          std::swap(dst[(y * fw + x) * 3 + c],
                    dst[(y * fw + (fw - 1 - x)) * 3 + c]);
  }
}

}  // namespace

extern "C" {

struct PgVideoReader {
  AVFormatContext *format = nullptr;
  AVCodecContext *codec = nullptr;
  SwsContext *sws = nullptr;
  AVFrame *frame = nullptr;
  AVPacket *packet = nullptr;
  uint8_t *rgb_buffer = nullptr;  // pre-rotation RGB
  int stream_index = -1;
  int src_width = 0, src_height = 0;
  int rotation = 0;
  int vertical_flip = 0, horizontal_flip = 0;
  int64_t frame_count = 0;
  bool draining = false;
};

PgVideoReader *pg_video_reader_open(const char *path, int vertical_flip,
                                    int horizontal_flip) {
  auto *reader = new PgVideoReader();
  reader->vertical_flip = vertical_flip;
  reader->horizontal_flip = horizontal_flip;
  if (avformat_open_input(&reader->format, path, nullptr, nullptr) < 0 ||
      avformat_find_stream_info(reader->format, nullptr) < 0) {
    delete reader;
    return nullptr;
  }
  const AVCodec *decoder = nullptr;
  reader->stream_index = av_find_best_stream(
      reader->format, AVMEDIA_TYPE_VIDEO, -1, -1, &decoder, 0);
  if (reader->stream_index < 0) {
    avformat_close_input(&reader->format);
    delete reader;
    return nullptr;
  }
  AVStream *stream = reader->format->streams[reader->stream_index];
  reader->codec = avcodec_alloc_context3(decoder);
  avcodec_parameters_to_context(reader->codec, stream->codecpar);
  if (avcodec_open2(reader->codec, decoder, nullptr) < 0) {
    avcodec_free_context(&reader->codec);
    avformat_close_input(&reader->format);
    delete reader;
    return nullptr;
  }
  reader->src_width = reader->codec->width;
  reader->src_height = reader->codec->height;
  reader->rotation = NormalizedRotation(stream);
  reader->sws = sws_getContext(
      reader->src_width, reader->src_height, reader->codec->pix_fmt,
      reader->src_width, reader->src_height, AV_PIX_FMT_RGB24, SWS_BILINEAR,
      nullptr, nullptr, nullptr);
  reader->frame = av_frame_alloc();
  reader->packet = av_packet_alloc();
  reader->rgb_buffer = new uint8_t[static_cast<size_t>(reader->src_width) *
                                   reader->src_height * 3];
  return reader;
}

int pg_video_reader_width(PgVideoReader *reader) {
  return reader->rotation % 180 == 0 ? reader->src_width : reader->src_height;
}

int pg_video_reader_height(PgVideoReader *reader) {
  return reader->rotation % 180 == 0 ? reader->src_height : reader->src_width;
}

int pg_video_reader_rotation(PgVideoReader *reader) { return reader->rotation; }

// 1 = frame produced, 0 = end of stream, -1 = error.
int pg_video_reader_next(PgVideoReader *reader, uint8_t *rgb_out,
                         int64_t *pts_usec) {
  AVStream *stream = reader->format->streams[reader->stream_index];
  while (true) {
    const int receive = avcodec_receive_frame(reader->codec, reader->frame);
    if (receive == 0) {
      uint8_t *dst[1] = {reader->rgb_buffer};
      int dst_linesize[1] = {reader->src_width * 3};
      sws_scale(reader->sws, reader->frame->data, reader->frame->linesize, 0,
                reader->src_height, dst, dst_linesize);
      RotateRgb(reader->rgb_buffer, reader->src_width, reader->src_height,
                reader->rotation, reader->vertical_flip,
                reader->horizontal_flip, rgb_out);
      if (pts_usec != nullptr) {
        const int64_t pts = reader->frame->best_effort_timestamp;
        *pts_usec =
            pts == AV_NOPTS_VALUE
                ? reader->frame_count * 33333
                : av_rescale_q(pts, stream->time_base, AVRational{1, 1000000});
      }
      ++reader->frame_count;
      av_frame_unref(reader->frame);
      return 1;
    }
    if (receive == AVERROR_EOF) return 0;
    if (receive != AVERROR(EAGAIN)) return -1;
    if (reader->draining) return 0;

    // Feed the next packet (or enter drain mode at container EOF, matching
    // the reference's delayed-frame drain, image_sequence_reader.cc:147-208).
    while (true) {
      const int read = av_read_frame(reader->format, reader->packet);
      if (read < 0) {
        reader->draining = true;
        avcodec_send_packet(reader->codec, nullptr);
        break;
      }
      if (reader->packet->stream_index == reader->stream_index) {
        avcodec_send_packet(reader->codec, reader->packet);
        av_packet_unref(reader->packet);
        break;
      }
      av_packet_unref(reader->packet);
    }
  }
}

void pg_video_reader_close(PgVideoReader *reader) {
  if (reader == nullptr) return;
  if (reader->sws != nullptr) sws_freeContext(reader->sws);
  if (reader->frame != nullptr) av_frame_free(&reader->frame);
  if (reader->packet != nullptr) av_packet_free(&reader->packet);
  if (reader->codec != nullptr) avcodec_free_context(&reader->codec);
  if (reader->format != nullptr) avformat_close_input(&reader->format);
  delete[] reader->rgb_buffer;
  delete reader;
}

struct PgVideoWriter {
  AVFormatContext *format = nullptr;
  AVCodecContext *codec = nullptr;
  AVStream *stream = nullptr;
  SwsContext *sws = nullptr;
  AVFrame *frame = nullptr;
  AVPacket *packet = nullptr;
  int width = 0, height = 0;
  int64_t next_pts = 0;
};

static int WriterDrain(PgVideoWriter *writer) {
  while (true) {
    const int receive = avcodec_receive_packet(writer->codec, writer->packet);
    if (receive == AVERROR(EAGAIN) || receive == AVERROR_EOF) return 0;
    if (receive < 0) return -1;
    av_packet_rescale_ts(writer->packet, writer->codec->time_base,
                         writer->stream->time_base);
    writer->packet->stream_index = writer->stream->index;
    if (av_interleaved_write_frame(writer->format, writer->packet) < 0)
      return -1;
  }
}

PgVideoWriter *pg_video_writer_open(const char *path, int width, int height,
                                    double fps, int64_t bit_rate) {
  auto *writer = new PgVideoWriter();
  writer->width = width;
  writer->height = height;
  if (avformat_alloc_output_context2(&writer->format, nullptr, nullptr, path) <
      0) {
    delete writer;
    return nullptr;
  }
  const AVCodec *encoder = avcodec_find_encoder(AV_CODEC_ID_H264);
  if (encoder == nullptr)
    encoder = avcodec_find_encoder(AV_CODEC_ID_MPEG4);
  if (encoder == nullptr) {
    avformat_free_context(writer->format);
    delete writer;
    return nullptr;
  }
  writer->stream = avformat_new_stream(writer->format, nullptr);
  writer->codec = avcodec_alloc_context3(encoder);
  writer->codec->width = width;
  writer->codec->height = height;
  // Reference sink parameters (image_sequence_writer.cc:26-87).
  writer->codec->bit_rate = bit_rate > 0 ? bit_rate : 4 * 1024 * 1024;
  writer->codec->gop_size = 12;
  // No B-frames: avoids decoder-side reorder edge cases at end of stream
  // (observed: the final delayed B-frame is muxed but dropped by decoders)
  // and suits the realtime logging use.
  writer->codec->max_b_frames = 0;
  writer->codec->pix_fmt = AV_PIX_FMT_YUV420P;
  const AVRational frame_rate = av_d2q(fps, 100000);
  writer->codec->time_base = av_inv_q(frame_rate);
  writer->codec->framerate = frame_rate;
  if (writer->format->oformat->flags & AVFMT_GLOBALHEADER)
    writer->codec->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  writer->stream->time_base = writer->codec->time_base;
  writer->stream->avg_frame_rate = frame_rate;
  if (avcodec_open2(writer->codec, encoder, nullptr) < 0 ||
      avcodec_parameters_from_context(writer->stream->codecpar,
                                      writer->codec) < 0) {
    avcodec_free_context(&writer->codec);
    avformat_free_context(writer->format);
    delete writer;
    return nullptr;
  }
  if (!(writer->format->oformat->flags & AVFMT_NOFILE) &&
      avio_open(&writer->format->pb, path, AVIO_FLAG_WRITE) < 0) {
    avcodec_free_context(&writer->codec);
    avformat_free_context(writer->format);
    delete writer;
    return nullptr;
  }
  if (avformat_write_header(writer->format, nullptr) < 0) {
    avcodec_free_context(&writer->codec);
    avformat_free_context(writer->format);
    delete writer;
    return nullptr;
  }
  writer->sws = sws_getContext(width, height, AV_PIX_FMT_RGB24, width, height,
                               AV_PIX_FMT_YUV420P, SWS_BILINEAR, nullptr,
                               nullptr, nullptr);
  writer->frame = av_frame_alloc();
  writer->frame->format = AV_PIX_FMT_YUV420P;
  writer->frame->width = width;
  writer->frame->height = height;
  av_frame_get_buffer(writer->frame, 0);
  writer->packet = av_packet_alloc();
  return writer;
}

int pg_video_writer_write(PgVideoWriter *writer, const uint8_t *rgb) {
  av_frame_make_writable(writer->frame);
  const uint8_t *src[1] = {rgb};
  int src_linesize[1] = {writer->width * 3};
  sws_scale(writer->sws, src, src_linesize, 0, writer->height,
            writer->frame->data, writer->frame->linesize);
  writer->frame->pts = writer->next_pts++;
  if (avcodec_send_frame(writer->codec, writer->frame) < 0) return -1;
  return WriterDrain(writer);
}

int pg_video_writer_close(PgVideoWriter *writer) {
  if (writer == nullptr) return 0;
  int status = 0;
  if (writer->codec != nullptr) {
    avcodec_send_frame(writer->codec, nullptr);  // flush
    status = WriterDrain(writer);
    av_write_trailer(writer->format);
  }
  if (writer->sws != nullptr) sws_freeContext(writer->sws);
  if (writer->frame != nullptr) av_frame_free(&writer->frame);
  if (writer->packet != nullptr) av_packet_free(&writer->packet);
  if (writer->codec != nullptr) avcodec_free_context(&writer->codec);
  if (writer->format != nullptr) {
    if (!(writer->format->oformat->flags & AVFMT_NOFILE))
      avio_closep(&writer->format->pb);
    avformat_free_context(writer->format);
  }
  delete writer;
  return status;
}

}  // extern "C"
