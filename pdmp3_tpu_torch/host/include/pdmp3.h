/* pdmp3_tpu native host library — public C ABI.
 *
 * Drop-in replacement for the reference decoder's libmpg123-subset
 * streaming API (technosaurus/PDMP3, pdmp3.c:150-159): same functions,
 * same return-code protocol, bit-exact 16-bit PCM.  Additionally exposes
 * the batch frontend used by the TPU pipeline: it runs the control-flow-
 * heavy bitstream stages (sync, side info, bit reservoir, scalefactors,
 * Huffman) natively and emits dense per-granule tensors for the JAX/Pallas
 * DSP backend.
 */
#ifndef PDMP3_TPU_HOST_H_
#define PDMP3_TPU_HOST_H_

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* --- status codes (libmpg123 subset, cf. pdmp3.c:114-121) --- */
#define PDMP3_OK 0
#define PDMP3_ERR (-1)
#define PDMP3_NEED_MORE (-10)
#define PDMP3_NEW_FORMAT (-11)
#define PDMP3_NO_SPACE 7
#define PDMP3_ENC_SIGNED_16 (0x080 | 0x040 | 0x10)

typedef struct pdmp3_handle pdmp3_handle;

/* --- streaming API (protocol-identical to the reference) --- */
pdmp3_handle *pdmp3_new(const char *decoder, int *error);
void pdmp3_delete(pdmp3_handle *id);
int pdmp3_open_feed(pdmp3_handle *id);
int pdmp3_feed(pdmp3_handle *id, const unsigned char *in, size_t size);
int pdmp3_read(pdmp3_handle *id, unsigned char *outmemory, size_t outsize,
               size_t *done);
int pdmp3_decode(pdmp3_handle *id, const unsigned char *in, size_t insize,
                 unsigned char *out, size_t outsize, size_t *done);
int pdmp3_getformat(pdmp3_handle *id, long *rate, int *channels,
                    int *encoding);

/* CLI player: NULL-terminated file list; optional leading "/dev/dsp*"
 * selects the audio device (cf. pdmp3.c:2540-2589).  Writes <file>.raw
 * when built for raw output. */
void pdmp3(char *const *mp3s);

/* --- batch frontend for the TPU pipeline ---
 *
 * Parses one frame from the handle's input buffer and fills dense granule
 * tensors (one frame = 2 granules x 2 channels).  Layouts match
 * pdmp3_tpu.models.decoder.GranuleBatch; mono streams leave channel 1
 * zeroed and set nch=1.
 *
 * Returns PDMP3_OK (frame parsed; out structs filled), PDMP3_NEED_MORE
 * (insufficient input or reservoir underflow; input cursor rolled back
 * for resume), or PDMP3_ERR.
 */
typedef struct pdmp3_granules {
  int16_t ix[2][2][576];      /* Huffman-decoded frequency lines */
  uint8_t scf_l[2][2][22];    /* long scalefactors (+sfb21 policy slot) */
  uint8_t scf_s[2][2][13][3]; /* short scalefactors (+band-12 policy) */
  int32_t layout[2][2];       /* sfreq*3 + {0 long,1 short,2 mixed} */
  int32_t block_type[2][2];
  int32_t win_switch[2][2];
  int32_t mixed[2][2];
  int32_t global_gain[2][2];
  int32_t scalefac_scale[2][2];
  int32_t preflag[2][2];
  int32_t subblock_gain[2][2][3];
  int32_t count1[2][2];
  int32_t ms_flag;            /* joint stereo + mode_ext bit 1 */
  int32_t is_flag;            /* joint stereo + mode_ext bit 0 */
  int32_t nch;
  int32_t sample_rate;
  /* MPEG-2/2.5 LSF extension (PDMP3_PROFILE_LSF; 13818-3).  family 0 =
   * MPEG-1 (fields below unused); 1 = MPEG-2; 2 = MPEG-2.5.  LSF frames
   * carry ONE granule: granule-1 rows of the arrays above stay zeroed.
   * is_pos_*: ch1's transmitted intensity positions with the
   * per-partition all-ones illegal value mapped to 63 (the "skip band"
   * sentinel); iscale = intensity_scale bit of ch1's scalefac_compress. */
  int32_t family;
  int32_t iscale;
  int16_t is_pos_l[22];
  int16_t is_pos_s[13][3];
  int16_t is_pos_pad;         /* keep the struct 4-byte aligned */
  /* Layer I/II (PDMP3_PROFILE_L12; beyond-reference — the reference
   * hard-errors on layer != 3, pdmp3.c:1240/1312).  layer == 3 leaves
   * sb_samples untouched (possibly stale); layer 1/2 frames carry
   * frontend-requantized subband samples instead of the fields above:
   * nparts synthesis steps (12 = Layer I, 36 = Layer II) x 32 subbands,
   * and the DSP is the polyphase filterbank alone. */
  int32_t layer;
  int32_t nparts;
  float sb_samples[2][36][32];
} pdmp3_granules;

int pdmp3_parse_frame(pdmp3_handle *id, pdmp3_granules *out);

/* SoA variant for the batched pipeline: writes this frame's two granules
 * directly into slot `slot` of caller-provided step tensors laid out as
 *   ix    [2][n_slots][2][576] int16
 *   scf_l [2][n_slots][2][22]  uint8
 *   scf_s [2][n_slots][2][39]  uint8
 *   meta  [2][n_slots][32]     int32   (see PDMP3_META_* indices)
 * Rolls the input cursor back and leaves the slot untouched on non-OK.
 *
 * The ix section is LINE-ORDERED: the short-block reorder
 * (pdmp3.c:1786-1823) is applied during the copy, so the device DSP
 * consumes post-reorder spectra directly (pdmp3_granules.ix itself stays
 * in bitstream order for the scalar native DSP).  Applies to every wire
 * packer below (wire16 dense and sparse) as well.
 */
#define PDMP3_META_LAYOUT 0   /* +ch (2) */
#define PDMP3_META_BLOCK_TYPE 2
#define PDMP3_META_WIN_SWITCH 4
#define PDMP3_META_MIXED 6
#define PDMP3_META_GLOBAL_GAIN 8
#define PDMP3_META_SCALEFAC_SCALE 10
#define PDMP3_META_PREFLAG 12
#define PDMP3_META_COUNT1 14
#define PDMP3_META_SUBBLOCK_GAIN 16 /* +ch*3+w (6) */
#define PDMP3_META_MS 22
#define PDMP3_META_IS 23
#define PDMP3_META_NCH 24
#define PDMP3_META_SAMPLE_RATE 25
#define PDMP3_META_FAMILY 26 /* LSF pools only (wire16_lsf) */
#define PDMP3_META_ISCALE 27
#define PDMP3_META_WORDS 32
int pdmp3_parse_frame_soa(pdmp3_handle *id, size_t slot, size_t n_slots,
                          int16_t *ix, uint8_t *scf_l, uint8_t *scf_s,
                          int32_t *meta);

/* Whole-step variant: parse one frame from each of n_slots handles into
 * the step tensors; active[slot] = 1 on success, 0 on starvation/error
 * (cursor rolled back).  Returns the number of active slots.  This is the
 * host half of the serving pipeline's inner loop (one call per step). */
int pdmp3_parse_step(pdmp3_handle *const *ids, size_t n_slots, int16_t *ix,
                     uint8_t *scf_l, uint8_t *scf_s, int32_t *meta,
                     int32_t *active);

/* Multithreaded variant: fan the per-slot parses over n_threads host
 * cores (0 = hardware concurrency).  Slots are independent streams, so
 * this scales the host Huffman frontend linearly with cores. */
int pdmp3_parse_step_mt(pdmp3_handle *const *ids, size_t n_slots,
                        int n_threads, int16_t *ix, uint8_t *scf_l,
                        uint8_t *scf_s, int32_t *meta, int32_t *active);

/* Multi-frame variant: parse up to frames_per_step sequential frames per
 * slot into tensors laid out [F][2][n_slots][...]; active is [F][n_slots]
 * (a slot's later frames stay inactive after its first failure).  Lets
 * the device decode F frames per dispatch, amortizing per-call latency. */
int pdmp3_parse_step_multi(pdmp3_handle *const *ids, size_t n_slots,
                           int n_threads, size_t frames_per_step,
                           int16_t *ix, uint8_t *scf_l, uint8_t *scf_s,
                           int32_t *meta, int32_t *active);

/* All-int16 wire variant (scalefacs/meta/active widened to int16): the
 * serving pipeline's single uploaded buffer is consumed on the device by
 * pure slicing, no byte recombination.  Section layouts as
 * pdmp3_parse_step_multi; meta SAMPLE_RATE is stored divided by 25 to
 * fit int16. */
int pdmp3_parse_step_wire16(pdmp3_handle *const *ids, size_t n_slots,
                            int n_threads, size_t frames_per_step,
                            int16_t *ix, int16_t *scf_l, int16_t *scf_s,
                            int16_t *meta, int16_t *active);

/* LSF pool variant of pdmp3_parse_step_wire16 (PDMP3_PROFILE_LSF
 * handles; all slots of a pool share one family — the serving layer
 * routes streams to per-family pools).  LSF frames carry ONE granule, so
 * sections drop the granule axis:
 *   ix     [F][n_slots][2][576] int16 (line-ordered, family band edges)
 *   scf_l  [F][n_slots][2][22]  int16
 *   scf_s  [F][n_slots][2][39]  int16
 *   meta   [F][n_slots][32]     int16 (incl. META_FAMILY / META_ISCALE)
 *   is_pos [F][n_slots][64]     int16 (intensity sidecar: [0..21] long,
 *                               [22..60] short flat, illegal = 63)
 *   active [F][n_slots]         int16
 * Returns the number of active slot-frames. */
int pdmp3_parse_step_wire16_lsf(pdmp3_handle *const *ids, size_t n_slots,
                                int n_threads, size_t frames_per_step,
                                int16_t *ix, int16_t *scf_l,
                                int16_t *scf_s, int16_t *meta,
                                int16_t *is_pos, int16_t *active);

/* Layer I/II pool wire (PDMP3_PROFILE_L12 handles; all slots of a pool
 * share one layer — the serving layer routes streams to per-layer
 * pools, like the LSF family pools).  S = 12 (layer 1) or 36 (layer 2)
 * synthesis steps per frame:
 *   sb     [F][n_slots][2][S][32] float (requantized subband samples)
 *   meta   [F][n_slots][4]        int16 {nch, sample_rate/25, layer,
 *                                        family}
 *   active [F][n_slots]           int16
 * A stray frame of the WRONG layer (or Layer III) is consumed and
 * skipped; the slot's frame rows stay inactive for the rest of the
 * step.  Returns the number of active slot-frames. */
int pdmp3_parse_step_wire_l12(pdmp3_handle *const *ids, size_t n_slots,
                              int n_threads, size_t frames_per_step,
                              int layer, float *sb, int16_t *meta,
                              int16_t *active);

/* Sparse count1-bounded wire: every granule's frequency lines are zero
 * from count1 up (rzero, pdmp3.c:2108-2111), so the spectra ship as
 * 128-line blocks covering only the nonzero prefix — typically 2-4x
 * fewer wire bytes than the dense int16 wire.  Blocks are allocated
 * contiguously from a shared cursor into ix_flat[cap_blocks][128]
 * (thread-safe; placement varies across thread counts, the block table
 * makes the device result deterministic).  Per (frame, gr, slot, ch) the
 * table entry blk[4] is {start_lo, start_hi, n_blocks, 0} (start split
 * into int16 halves; n_blocks = ceil(bound/128) <= 5 where bound rounds
 * clamp(count1,0,576) up to the containing scalefactor band's end for
 * short-block layouts — the line-ordered wire's nonzero prefix,
 * kPermBound — and 0 for inactive slots and ch >= nch).  Other sections
 * as
 * pdmp3_parse_step_wire16.  cap_blocks must cover the worst case
 * (frames_per_step*2*n_slots*2*5); *blocks_used returns the cursor so
 * the caller uploads only the used prefix.  If cap_blocks is too small,
 * overflowing channels get n_blocks=0 (decode as silence) and
 * *blocks_used > cap_blocks signals the truncation.  Returns active
 * slot count. */
int pdmp3_parse_step_wire16_sparse(pdmp3_handle *const *ids,
                                   size_t n_slots, int n_threads,
                                   size_t frames_per_step,
                                   int16_t *ix_flat, size_t cap_blocks,
                                   int16_t *blk, int16_t *scf_l,
                                   int16_t *scf_s, int16_t *meta,
                                   int16_t *active,
                                   long long *blocks_used);

/* Sparse LSF pool wire: the count1-bounded block scheme of
 * pdmp3_parse_step_wire16_sparse over the one-granule LSF layout —
 * blk [F][n_slots][2][4], other fixed sections as
 * pdmp3_parse_step_wire16_lsf, spectra as 128-line blocks in
 * ix_flat[cap_blocks][128] (worst case frames_per_step*n_slots*2*5). */
int pdmp3_parse_step_wire16_lsf_sparse(
    pdmp3_handle *const *ids, size_t n_slots, int n_threads,
    size_t frames_per_step, int16_t *ix_flat, size_t cap_blocks,
    int16_t *blk, int16_t *scf_l, int16_t *scf_s, int16_t *meta,
    int16_t *is_pos, int16_t *active, long long *blocks_used);

/* Offline whole-stream parse: feed `data` and parse every frame natively
 * (no per-frame FFI round trips).  Tensors are laid out with n_slots =
 * max_frames and slot = frame index, i.e. [2][max_frames][...].  Returns
 * the number of frames parsed (<= max_frames). */
long pdmp3_parse_stream(pdmp3_handle *id, const unsigned char *data,
                        size_t size, size_t max_frames, int16_t *ix,
                        uint8_t *scf_l, uint8_t *scf_s, int32_t *meta);

/* Bytes buffered / free in the 16 KiB input ring. */
unsigned pdmp3_inbuf_filled(pdmp3_handle *id);
unsigned pdmp3_inbuf_free(pdmp3_handle *id);

/* Serving feeder: top up every slot's ring from its looping source
 * buffer (pos[i] wraps to 0 at src_len[i]) in one call.  Returns total
 * bytes fed.  One FFI round trip per step instead of 2·n_slots. */
long long pdmp3_feed_loop(pdmp3_handle *const *ids, size_t n,
                          const unsigned char *const *srcs,
                          const size_t *src_len, size_t *pos);

/* Checkpoint/resume: the handle is a trivially-copyable state blob
 * (ring buffer, reservoir, header/side-info, DSP carries, drain offset) —
 * cf. SURVEY.md §5.  save/restore round-trips a decoding session. */
size_t pdmp3_state_size(void);
void pdmp3_state_save(const pdmp3_handle *id, void *buf);
void pdmp3_state_restore(pdmp3_handle *id, const void *buf);

/* Decode one parsed frame with the native scalar DSP (bit-exact vs the
 * reference) into packed PCM words hi=left/lo=right (pdmp3.c:129). */
void pdmp3_dsp_frame(pdmp3_handle *id, const pdmp3_granules *g,
                     uint32_t out_words[2][576]);

/* Decode-profile flags (default 0 = bit-exact reference-bug emulation):
 *   PDMP3_PROFILE_COUNT1B_SPEC   decode count1table_select=1 quads with
 *     the real ISO table B tree (4-bit code c -> quad 15-c) instead of
 *     the reference's stale-pointer (0,0,±1,±1) bug (pdmp3.c:569,
 *     1627-1635).
 *   PDMP3_PROFILE_SPEC_INTENSITY spec-correct short-block intensity
 *     panning (ratio tables, mirroring the long-block form) instead of
 *     the reference's unsigned-assignment transcription bug
 *     (pdmp3.c:2212-2213).
 *   PDMP3_PROFILE_LSF            also accept MPEG-2 / MPEG-2.5
 *     (13818-3 low-sampling-frequency) streams: 11-bit sync scan,
 *     9/17-byte one-granule side info, the 9-bit scalefac_compress
 *     partition derivation, LSF intensity stereo.  A capability the
 *     reference lacks (it rejects id==0, pdmp3.c:1295).  Default OFF:
 *     accepting the shorter sync word changes resync behavior on
 *     hostile MPEG-1 streams, breaking bit-parity differentials.
 * The profile is part of the checkpoint blob. */
#define PDMP3_PROFILE_COUNT1B_SPEC 1u
#define PDMP3_PROFILE_SPEC_INTENSITY 2u
#define PDMP3_PROFILE_LSF 4u
/* PDMP3_PROFILE_FREE_FORMAT: accept bitrate_index == 0 (ISO 11172-3
 * free format; the reference rejects it, pdmp3.c:1299) and deduce the
 * constant frame size from the sync spacing (chain-verified against a
 * third header to screen false syncs inside main data). */
#define PDMP3_PROFILE_FREE_FORMAT 8u
/* PDMP3_PROFILE_ID3: skip ID3v2 tags explicitly.  The reference's
 * sync scan absorbs tags that fit the buffered input window, but a tag
 * larger than the 16 KiB ring (typical with embedded cover art) starves
 * the scan and Search_Header's bounded retry kills the stream
 * (pdmp3.c:1322-1340).  Incremental: oversized tags drain across
 * NEED_MORE round trips. */
#define PDMP3_PROFILE_ID3 16u
/* PDMP3_PROFILE_L12: also decode Layer I/II frames (the reference
 * rejects layer != 3, pdmp3.c:1240/1312).  Requantized subband samples
 * land in pdmp3_granules.sb_samples; the scalar DSP and pdmp3_read
 * synthesize them through the shared polyphase filterbank.  Default
 * OFF: accepting more layers changes resync behavior on hostile
 * streams, breaking bit-parity differentials. */
#define PDMP3_PROFILE_L12 32u
/* PDMP3_PROFILE_CRC: verify the ISO 11172-3 §2.4.3.1 CRC-16 of
 * protected Layer III frames (poly 0x8005 MSB-first, init 0xFFFF, over
 * header bits 16-31 + the side info; law validated against libavcodec's
 * AV_EF_CRCCHECK).  A failing frame is skipped whole — its main data
 * never enters the bit reservoir.  The reference reads and DISCARDS the
 * CRC bytes unchecked (pdmp3.c:1206-1210); default OFF for bit-parity.
 * Layer I/II frames (different protected-bit extent) stay discard-only. */
#define PDMP3_PROFILE_CRC 64u
void pdmp3_set_profile(pdmp3_handle *id, unsigned flags);
unsigned pdmp3_get_profile(const pdmp3_handle *id);

#ifdef __cplusplus
}
#endif
#endif /* PDMP3_TPU_HOST_H_ */
