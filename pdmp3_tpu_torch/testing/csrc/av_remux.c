/* External tag-writer oracle: remux an MP3 elementary stream through
 * libavformat's mp3 muxer, which prepends a production Xing/Info
 * metadata frame (frame count, byte count, 100-entry TOC, "Lavf"
 * encoder string, tag CRC — ffmpeg libavformat/mp3enc.c).
 *
 * Usage: av_remux <in.mp3> <out.mp3> [--id3v2 0|3|4] [--id3v1]
 *                 [key=value ...]
 *
 * key=value pairs become container metadata (title=..., artist=...),
 * written as ID3v2.<ver> text frames (and an ID3v1 trailer with
 * --id3v1) by libavformat's production tag writer — the external
 * anchor for pdmp3_tpu.metadata's ID3 parsers.
 *
 * Test tooling only: pdmp3_tpu/metadata.py's Xing/LAME parser is
 * validated against this independent production writer (the reference
 * binary has no VBR-header support at all, and this image has no LAME
 * binary), in addition to the in-tree mp3gen writer.
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <libavformat/avformat.h>
#include <libavutil/opt.h>

static void die(const char *msg) {
  fprintf(stderr, "av_remux: %s\n", msg);
  exit(1);
}

int main(int argc, char **argv) {
  if (argc < 3)
    die("usage: av_remux <in.mp3> <out.mp3> [--id3v2 V] [--id3v1] [k=v ...]");
  long id3v2_version = 0; /* 0 = no ID3v2 prologue (keep Xing first) */
  int write_id3v1 = 0;

  AVFormatContext *in = NULL;
  if (avformat_open_input(&in, argv[1], NULL, NULL) < 0)
    die("open input");
  if (avformat_find_stream_info(in, NULL) < 0) die("stream info");
  int si = -1;
  for (unsigned i = 0; i < in->nb_streams; i++)
    if (in->streams[i]->codecpar->codec_type == AVMEDIA_TYPE_AUDIO) {
      si = (int)i;
      break;
    }
  if (si < 0) die("no audio stream");

  AVFormatContext *out = NULL;
  if (avformat_alloc_output_context2(&out, NULL, "mp3", argv[2]) < 0)
    die("alloc output");
  AVStream *ost = avformat_new_stream(out, NULL);
  if (!ost) die("new stream");
  if (avcodec_parameters_copy(ost->codecpar, in->streams[si]->codecpar) < 0)
    die("copy params");
  ost->time_base = in->streams[si]->time_base;
  for (int i = 3; i < argc; i++) {
    if (!strcmp(argv[i], "--id3v2") && i + 1 < argc) {
      id3v2_version = strtol(argv[++i], NULL, 10);
    } else if (!strcmp(argv[i], "--id3v1")) {
      write_id3v1 = 1;
    } else {
      char *eq = strchr(argv[i], '=');
      if (!eq) die("metadata arg must be key=value");
      *eq = '\0';
      if (av_dict_set(&out->metadata, argv[i], eq + 1, 0) < 0)
        die("set metadata");
    }
  }
  if (av_opt_set_int(out->priv_data, "id3v2_version", id3v2_version, 0) < 0)
    die("set id3v2_version");
  if (av_opt_set_int(out->priv_data, "write_id3v1", write_id3v1, 0) < 0)
    die("set write_id3v1");
  if (av_opt_set_int(out->priv_data, "write_xing", 1, 0) < 0)
    die("set write_xing");

  if (avio_open(&out->pb, argv[2], AVIO_FLAG_WRITE) < 0) die("open output");
  if (avformat_write_header(out, NULL) < 0) die("write header");

  AVPacket *pkt = av_packet_alloc();
  while (av_read_frame(in, pkt) >= 0) {
    if (pkt->stream_index == si) {
      pkt->stream_index = 0;
      av_packet_rescale_ts(pkt, in->streams[si]->time_base, ost->time_base);
      if (av_interleaved_write_frame(out, pkt) < 0) die("write frame");
    }
    av_packet_unref(pkt);
  }
  av_packet_free(&pkt);
  if (av_write_trailer(out) < 0) die("trailer");
  avio_closep(&out->pb);
  avformat_free_context(out);
  avformat_close_input(&in);
  return 0;
}
