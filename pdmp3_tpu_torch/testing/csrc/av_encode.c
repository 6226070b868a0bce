/* Test-tooling companion to av_oracle.c: encode raw PCM to MPEG audio
 * via the system libavcodec's native encoders (mp2).
 *
 * Usage: av_encode <in.f32raw> <out.bin> <codec> <rate> <channels>
 *                  <bitrate> [mode] [key=value ...]
 *
 * mode: "cbr" (default), "abr", or "vbr:<q>" (libmp3lame quality 0-9).
 * key=value extras (libmp3lame preset axes, round-5 soak diversity):
 *   q=N        algorithmic quality (LAME -q 0..9, compression_level)
 *   cutoff=HZ  lowpass frequency (LAME --lowpass, AVCodecContext.cutoff)
 *   js=0|1     joint stereo on/off (priv option joint_stereo)
 *   reservoir=0|1  bit-reservoir on/off (priv option)
 *
 * Exists to produce ground-truth streams from production encoders
 * (mp2, libshine, libmp3lame), so the decoder is validated against
 * real encoder output, not just our own generator (which shares table
 * provenance with our decoder and would hide shared misreadings).
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <libavcodec/avcodec.h>
#include <libavutil/channel_layout.h>
#include <libavutil/opt.h>

static void die(const char *msg) {
  fprintf(stderr, "av_encode: %s\n", msg);
  exit(1);
}

int main(int argc, char **argv) {
  if (argc < 7)
    die("usage: av_encode <in.f32raw> <out> <codec> <rate> <ch> <bitrate>");
  const char *codec_name = argv[3];
  int rate = atoi(argv[4]), channels = atoi(argv[5]), bitrate = atoi(argv[6]);

  const AVCodec *codec = avcodec_find_encoder_by_name(codec_name);
  if (!codec) die("no encoder");
  AVCodecContext *ctx = avcodec_alloc_context3(codec);
  if (!ctx) die("alloc failed");
  ctx->sample_rate = rate;
  ctx->bit_rate = bitrate;
  if (argc > 7 && strncmp(argv[7], "vbr", 3) == 0) {
    /* libmp3lame true VBR: quality via AV_CODEC_FLAG_QSCALE. */
    int q = (argv[7][3] == ':') ? atoi(argv[7] + 4) : 4;
    ctx->flags |= AV_CODEC_FLAG_QSCALE;
    ctx->global_quality = q * FF_QP2LAMBDA;
  } else if (argc > 7 && strcmp(argv[7], "abr") == 0) {
    av_opt_set(ctx->priv_data, "abr", "1", 0);
  }
  for (int a = 8; a < argc; a++) {        /* key=value preset extras */
    if (strncmp(argv[a], "q=", 2) == 0) {
      ctx->compression_level = atoi(argv[a] + 2);
    } else if (strncmp(argv[a], "cutoff=", 7) == 0) {
      ctx->cutoff = atoi(argv[a] + 7);
    } else if (strncmp(argv[a], "js=", 3) == 0) {
      av_opt_set(ctx->priv_data, "joint_stereo", argv[a] + 3, 0);
    } else if (strncmp(argv[a], "reservoir=", 10) == 0) {
      av_opt_set(ctx->priv_data, "reservoir", argv[a] + 10, 0);
    } else {
      die("unknown key=value extra");
    }
  }
  av_channel_layout_default(&ctx->ch_layout, channels);
  /* Prefer float planar when the encoder offers it (libmp3lame lists
   * s32p first, whose extra headroom we don't need); else take the
   * encoder's first choice. */
  ctx->sample_fmt = AV_SAMPLE_FMT_NONE;
  if (codec->sample_fmts) {
    for (const enum AVSampleFormat *f = codec->sample_fmts;
         *f != AV_SAMPLE_FMT_NONE; f++)
      if (*f == AV_SAMPLE_FMT_FLTP) ctx->sample_fmt = *f;
    if (ctx->sample_fmt == AV_SAMPLE_FMT_NONE)
      ctx->sample_fmt = codec->sample_fmts[0];
  } else {
    ctx->sample_fmt = AV_SAMPLE_FMT_S16;
  }
  if (avcodec_open2(ctx, codec, NULL) < 0) die("open failed");

  FILE *fin = fopen(argv[1], "rb");
  if (!fin) die("cannot open input");
  FILE *fout = fopen(argv[2], "wb");
  if (!fout) die("cannot open output");

  AVPacket *pkt = av_packet_alloc();
  AVFrame *frame = av_frame_alloc();
  frame->nb_samples = ctx->frame_size;
  frame->format = ctx->sample_fmt;
  av_channel_layout_copy(&frame->ch_layout, &ctx->ch_layout);
  if (av_frame_get_buffer(frame, 0) < 0) die("frame buffer");

  size_t insamp = (size_t)frame->nb_samples * channels;
  float *buf = malloc(insamp * sizeof(float));
  int eof = 0;
  while (!eof) {
    size_t n = fread(buf, sizeof(float), insamp, fin);
    if (n < insamp) {
      eof = 1;
      if (n == 0) break;
      memset(buf + n, 0, (insamp - n) * sizeof(float));
    }
    if (av_frame_make_writable(frame) < 0) die("make writable");
    for (int i = 0; i < frame->nb_samples; i++)
      for (int c = 0; c < channels; c++) {
        float v = buf[(size_t)i * channels + c];
        if (frame->format == AV_SAMPLE_FMT_S16) {
          int s = (int)(v * 32767.0f);
          if (s > 32767) s = 32767;
          if (s < -32768) s = -32768;
          ((int16_t *)frame->data[0])[(size_t)i * channels + c] = (int16_t)s;
        } else if (frame->format == AV_SAMPLE_FMT_S16P) {
          int s = (int)(v * 32767.0f);
          if (s > 32767) s = 32767;
          if (s < -32768) s = -32768;
          ((int16_t *)frame->extended_data[c])[i] = (int16_t)s;
        } else if (frame->format == AV_SAMPLE_FMT_S32P) {
          double s = (double)v * 2147483647.0;
          if (s > 2147483647.0) s = 2147483647.0;
          if (s < -2147483648.0) s = -2147483648.0;
          ((int32_t *)frame->extended_data[c])[i] = (int32_t)s;
        } else if (frame->format == AV_SAMPLE_FMT_FLTP) {
          ((float *)frame->extended_data[c])[i] = v;
        } else if (frame->format == AV_SAMPLE_FMT_FLT) {
          ((float *)frame->data[0])[(size_t)i * channels + c] = v;
        } else {
          die("unexpected sample format");
        }
      }
    if (avcodec_send_frame(ctx, frame) < 0) die("send failed");
    AVPacket *p = pkt;
    while (avcodec_receive_packet(ctx, p) == 0) {
      fwrite(p->data, 1, p->size, fout);
      av_packet_unref(p);
    }
  }
  avcodec_send_frame(ctx, NULL);
  while (avcodec_receive_packet(ctx, pkt) == 0) {
    fwrite(pkt->data, 1, pkt->size, fout);
    av_packet_unref(pkt);
  }
  fclose(fin);
  fclose(fout);
  free(buf);
  avcodec_free_context(&ctx);
  av_packet_free(&pkt);
  av_frame_free(&frame);
  return 0;
}
