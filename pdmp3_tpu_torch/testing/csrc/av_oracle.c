/* External golden oracle: decode an MPEG audio file (Layer I/II/III,
 * MPEG-1/2/2.5) to raw PCM via the system libavcodec.
 *
 * Usage: av_oracle <in.mp3> <out.raw> [mp1|mp2|mp3] [crccheck]
 * Writes interleaved float32 PCM; prints "rate channels layer nframes"
 * on stdout.  The optional 4th arg enables AV_EF_CRCCHECK|AV_EF_EXPLODE
 * so frames failing the ISO CRC-16 are dropped — the external anchor
 * for the framework's PDMP3_PROFILE_CRC verification law.
 *
 * This is test tooling only (it links the distro's libavcodec 59); the
 * decoder framework itself has no FFmpeg dependency.  It exists because
 * the reference binary rejects everything but MPEG-1 Layer III
 * (/root/reference/pdmp3.c:1240,1295) so the Layer I/II and LSF
 * capability extensions need an independent production decoder to
 * validate against (tolerance-based: libavcodec's float DSP is not our
 * bit-exact target, agreement within quantization noise is).
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <libavcodec/avcodec.h>

static void die(const char *msg) {
  fprintf(stderr, "av_oracle: %s\n", msg);
  exit(1);
}

int main(int argc, char **argv) {
  if (argc < 3) die("usage: av_oracle <in> <out.raw> [mp1|mp2|mp3]");
  const char *codec_name = argc > 3 ? argv[3] : "mp3";

  enum AVCodecID cid = AV_CODEC_ID_MP3;
  if (!strcmp(codec_name, "mp1")) cid = AV_CODEC_ID_MP1;
  else if (!strcmp(codec_name, "mp2")) cid = AV_CODEC_ID_MP2;

  /* prefer the float decoders (mp1float/mp2float/mp3float) */
  char fname[16];
  snprintf(fname, sizeof fname, "%sfloat", codec_name);
  const AVCodec *codec = avcodec_find_decoder_by_name(fname);
  if (!codec) codec = avcodec_find_decoder(cid);
  if (!codec) die("no decoder");

  AVCodecParserContext *parser = av_parser_init(codec->id);
  if (!parser) die("no parser");
  AVCodecContext *ctx = avcodec_alloc_context3(codec);
  if (!ctx) die("alloc failed");
  if (argc > 4 && !strcmp(argv[4], "crccheck"))
    ctx->err_recognition = AV_EF_CRCCHECK | AV_EF_EXPLODE;
  if (avcodec_open2(ctx, codec, NULL) < 0) die("open failed");

  FILE *fin = fopen(argv[1], "rb");
  if (!fin) die("cannot open input");
  FILE *fout = fopen(argv[2], "wb");
  if (!fout) die("cannot open output");

  AVPacket *pkt = av_packet_alloc();
  AVFrame *frame = av_frame_alloc();
  uint8_t inbuf[4096 + AV_INPUT_BUFFER_PADDING_SIZE];
  memset(inbuf + 4096, 0, AV_INPUT_BUFFER_PADDING_SIZE);

  long nframes = 0;
  int rate = 0, channels = 0;
  int eof = 0;
  while (!eof) {
    size_t n = fread(inbuf, 1, 4096, fin);
    eof = n == 0;
    const uint8_t *data = inbuf;
    size_t left = n;
    do {
      uint8_t *obuf; int osize;
      int used = av_parser_parse2(parser, ctx, &obuf, &osize, data,
                                  (int)left, AV_NOPTS_VALUE, AV_NOPTS_VALUE,
                                  0);
      if (used < 0) die("parse error");
      data += used; left -= (size_t)used;
      if (osize == 0) continue;
      pkt->data = obuf; pkt->size = osize;
      if (avcodec_send_packet(ctx, pkt) < 0) continue; /* skip bad frame */
      while (avcodec_receive_frame(ctx, frame) == 0) {
        rate = ctx->sample_rate;
        channels = ctx->ch_layout.nb_channels;
        nframes++;
        /* interleave planar float (fltp) or pass through packed */
        if (frame->format == AV_SAMPLE_FMT_FLTP) {
          for (int i = 0; i < frame->nb_samples; i++)
            for (int c = 0; c < channels; c++)
              fwrite(frame->extended_data[c] + 4 * i, 4, 1, fout);
        } else if (frame->format == AV_SAMPLE_FMT_FLT) {
          fwrite(frame->data[0], 4,
                 (size_t)frame->nb_samples * channels, fout);
        } else if (frame->format == AV_SAMPLE_FMT_S16P) {
          for (int i = 0; i < frame->nb_samples; i++)
            for (int c = 0; c < channels; c++) {
              int16_t s;
              memcpy(&s, frame->extended_data[c] + 2 * i, 2);
              float f = (float)s / 32768.0f;
              fwrite(&f, 4, 1, fout);
            }
        } else if (frame->format == AV_SAMPLE_FMT_S16) {
          const int16_t *s16 = (const int16_t *)frame->data[0];
          for (int i = 0; i < frame->nb_samples * channels; i++) {
            float f = (float)s16[i] / 32768.0f;
            fwrite(&f, 4, 1, fout);
          }
        } else {
          die("unexpected sample format");
        }
      }
    } while (left > 0);
  }
  printf("%d %d %s %ld\n", rate, channels, codec_name, nframes);
  fclose(fin); fclose(fout);
  av_parser_close(parser);
  avcodec_free_context(&ctx);
  av_packet_free(&pkt);
  av_frame_free(&frame);
  return 0;
}
