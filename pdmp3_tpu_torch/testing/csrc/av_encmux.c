/* Encode-and-mux: raw f32 PCM -> libmp3lame -> libavformat mp3 muxer,
 * in one process, so the muxer sees the live encoder context and
 * writes a GENUINE Xing/LAME tag — real encoder delay/padding, VBR
 * method, TOC, music CRC — exactly the bytes a production
 * `ffmpeg -c:a libmp3lame out.mp3` run produces.
 *
 * Usage: av_encmux <in.f32raw> <out.mp3> <rate> <channels> <bitrate>
 *                  [mode]          mode: cbr (default) | abr | vbr:<q>
 *
 * Test tooling only: av_remux.c (remux path) can't recover encoder
 * delay/padding from an elementary stream, so the gapless fields come
 * out zero there; this tool is the anchor for decode_file_gapless /
 * decode_file_seek over real LAME streams.
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/channel_layout.h>
#include <libavutil/opt.h>

static void die(const char *msg) {
  fprintf(stderr, "av_encmux: %s\n", msg);
  exit(1);
}

int main(int argc, char **argv) {
  if (argc < 6)
    die("usage: av_encmux <in.f32raw> <out.mp3> <rate> <ch> <bitrate> [mode]");
  int rate = atoi(argv[3]), channels = atoi(argv[4]), bitrate = atoi(argv[5]);
  const char *mode = argc > 6 ? argv[6] : "cbr";

  const AVCodec *codec = avcodec_find_encoder_by_name("libmp3lame");
  if (!codec) die("no libmp3lame");
  AVCodecContext *ctx = avcodec_alloc_context3(codec);
  if (!ctx) die("alloc failed");
  ctx->sample_rate = rate;
  ctx->bit_rate = bitrate;
  ctx->sample_fmt = AV_SAMPLE_FMT_FLTP;
  ctx->time_base = (AVRational){1, rate};
  if (strncmp(mode, "vbr", 3) == 0) {
    int q = (mode[3] == ':') ? atoi(mode + 4) : 4;
    ctx->flags |= AV_CODEC_FLAG_QSCALE;
    ctx->global_quality = q * FF_QP2LAMBDA;
  } else if (strcmp(mode, "abr") == 0) {
    av_opt_set(ctx->priv_data, "abr", "1", 0);
  }
  av_channel_layout_default(&ctx->ch_layout, channels);

  AVFormatContext *oc = NULL;
  if (avformat_alloc_output_context2(&oc, NULL, "mp3", argv[2]) < 0)
    die("alloc output");
  if (oc->oformat->flags & AVFMT_GLOBALHEADER)
    ctx->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  if (avcodec_open2(ctx, codec, NULL) < 0) die("open codec");

  AVStream *st = avformat_new_stream(oc, NULL);
  if (!st) die("new stream");
  st->time_base = ctx->time_base;
  /* after open: copies initial_padding (the real LAME delay) into
   * codecpar, which mp3enc.c uses for the Xing gapless fields */
  if (avcodec_parameters_from_context(st->codecpar, ctx) < 0)
    die("params");

  if (avio_open(&oc->pb, argv[2], AVIO_FLAG_WRITE) < 0) die("avio open");
  AVDictionary *opts = NULL;
  av_dict_set(&opts, "id3v2_version", "0", 0); /* keep Xing frame first */
  if (avformat_write_header(oc, &opts) < 0) die("write header");
  av_dict_free(&opts);

  FILE *fin = fopen(argv[1], "rb");
  if (!fin) die("cannot open input");

  AVPacket *pkt = av_packet_alloc();
  AVFrame *frame = av_frame_alloc();
  frame->nb_samples = ctx->frame_size;
  frame->format = ctx->sample_fmt;
  av_channel_layout_copy(&frame->ch_layout, &ctx->ch_layout);
  if (av_frame_get_buffer(frame, 0) < 0) die("frame buffer");

  size_t insamp = (size_t)frame->nb_samples * channels;
  float *buf = malloc(insamp * sizeof(float));
  int64_t pts = 0;
  int eof = 0;
  while (!eof) {
    size_t n = fread(buf, sizeof(float), insamp, fin);
    if (n < insamp) {
      eof = 1;
      if (n == 0) break;
      memset(buf + n, 0, (insamp - n) * sizeof(float));
      frame->nb_samples = (int)((n + channels - 1) / channels);
    }
    if (av_frame_make_writable(frame) < 0) die("make writable");
    for (int i = 0; i < frame->nb_samples; i++)
      for (int c = 0; c < channels; c++)
        ((float *)frame->extended_data[c])[i] = buf[(size_t)i * channels + c];
    frame->pts = pts;
    pts += frame->nb_samples;
    if (avcodec_send_frame(ctx, frame) < 0) die("send failed");
    while (avcodec_receive_packet(ctx, pkt) == 0) {
      av_packet_rescale_ts(pkt, ctx->time_base, st->time_base);
      pkt->stream_index = st->index;
      if (av_interleaved_write_frame(oc, pkt) < 0) die("write frame");
    }
  }
  avcodec_send_frame(ctx, NULL);
  while (avcodec_receive_packet(ctx, pkt) == 0) {
    av_packet_rescale_ts(pkt, ctx->time_base, st->time_base);
    pkt->stream_index = st->index;
    if (av_interleaved_write_frame(oc, pkt) < 0) die("write frame");
  }
  if (av_write_trailer(oc) < 0) die("write trailer");
  avio_closep(&oc->pb);

  fclose(fin);
  free(buf);
  avcodec_free_context(&ctx);
  av_packet_free(&pkt);
  av_frame_free(&frame);
  avformat_free_context(oc);
  return 0;
}
