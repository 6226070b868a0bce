"""Multi-stream serving over the native frontend and the PyTorch backend.

Counterpart of ``pdmp3_tpu/runtime/scheduler.py`` (``LoopFeeder``,
``StreamDecoder``, ``SlotJoin``, ``SparseStreamDecoder``,
``L12StreamDecoder``, ``decode_files_batched``) for MPEG-1 pools, the
per-family LSF pools (MPEG-2, MPEG-2.5) and the per-layer Layer I/II
pools, in fast or exact precision.  N streams are pinned to slots; one
native call parses F frames per slot into a packed wire buffer (dense,
or count1-bounded sparse), one upload moves it to the device, and the
frames' steps decode every slot in lockstep.
Starved, finished or malformed streams leave their slot inactive for
the step: its state stays frozen and its PCM is silence, so one bad
stream never perturbs its neighbours.
"""
from __future__ import annotations

import ctypes as C

import numpy as np
import torch

from .. import tables as T
from ..host import (PROFILE_L12, PROFILE_LSF, PROFILE_SPEC_INTENSITY,
                    NativePDMP3, lib)
from ..models import decoder as M
from ..models import l12 as L
from ..ops.dsp import M_NCH
from ..utils.trace import span


class LoopFeeder:
    """Tops up every slot's input ring from a looping per-slot source
    stream in ONE native pdmp3_feed_loop call per step."""

    def __init__(self, dec: "_Pool", streams: list[bytes]):
        self.dec = dec
        # keep the bytes objects alive: the pointer array borrows them
        self.streams = [streams[i % len(streams)] for i in range(dec.n)]
        self._fn = lib().pdmp3_feed_loop
        self._fn.argtypes = [C.c_void_p, C.c_size_t, C.c_void_p,
                             C.c_void_p, C.c_void_p]
        self._fn.restype = C.c_longlong
        self._srcs = (C.c_char_p * dec.n)(*self.streams)
        self._lens = (C.c_size_t * dec.n)(*[len(s) for s in self.streams])
        self._pos = (C.c_size_t * dec.n)()

    def step(self) -> int:
        """Fill every ring to capacity; returns total bytes fed."""
        return int(self._fn(self.dec._handle_arr, self.dec.n, self._srcs,
                            self._lens, self._pos))

    def release(self, slot: int) -> None:
        """Stop feeding ``slot`` (e.g. once it serves a join): the native
        call skips a source of length 0."""
        self._lens[slot] = 0


class _Pool:
    """What the serving pools share: one native handle per slot, the
    pinned double-buffered wire with an upload fence per buffer, the step
    (upload, decode, buffer swap) and the pipelined PCM drain.  A pool
    sets the wire's layout and views (``_bind_views``), the native
    packer (``_fn``, ``_packer_args``) and the device decode
    (``_decode``)."""

    def _open(self, n_slots: int, profile: int, parse_threads: int,
              frames_per_step: int, device, nbytes: int, dtype) -> None:
        if frames_per_step < 1:
            raise ValueError(f"frames_per_step must be >= 1, got "
                             f"{frames_per_step!r}")
        self.n = n_slots
        self.F = frames_per_step
        self.parse_threads = parse_threads
        self.device = torch.device(device)
        self.handles = [NativePDMP3() for _ in range(n_slots)]
        for h in self.handles:
            if profile:
                h.set_profile(profile)
            h.open_feed()
        self._handle_arr = (C.c_void_p * self.n)(
            *[h._h for h in self.handles])
        # double-buffered wire: the upload of step t may still be in
        # flight while the host parses step t+1 into the other buffer.
        # On CUDA both buffers are pinned (the non_blocking upload is a
        # true async DMA that reads the buffer when the stream reaches
        # it) and an event per buffer fences every host write to it.
        cuda = self.device.type == "cuda"
        self._wires_t = [torch.zeros(nbytes, dtype=dtype, pin_memory=cuda)
                         for _ in range(2)]
        self._uploaded = [None, None]
        self._cur = 0
        self._bind_views()
        # the pipelined drain: the previous step's PCM copy in flight
        self._pending = None
        self._drain_stream = None
        self._resampler = None

    def _upload_len(self) -> int:
        """Elements of the wire that the next step uploads."""
        return self._wires_t[0].shape[0]

    def wire_bytes(self) -> int:
        """Bytes the next decode_step uploads."""
        return self._wires_t[0].element_size() * self._upload_len()

    def _reclaim(self):
        """Wait until the current buffer's last upload has read it; only
        then may the host write to it."""
        done = self._uploaded[self._cur]
        if done is not None:
            with span("pool.wait_upload"):
                done.synchronize()
            self._uploaded[self._cur] = None

    # ---- host side ----

    def feed(self, slot: int, data: bytes) -> int:
        return self.handles[slot].feed(data)

    def inbuf_free(self, slot: int) -> int:
        return self.handles[slot].inbuf_free()

    def parse_step(self) -> int:
        """Parse F frames per slot into the current wire buffer (one
        native call for the whole batch).  Returns the number of active
        slot-frames."""
        self._reclaim()
        with span("pool.parse"):
            return self._fn(self._handle_arr, self.n, self.parse_threads,
                            self.F, *self._packer_args())

    # ---- device side ----

    def decode_step(self, fetch: bool = True):
        """Decode the parsed frames.  Returns the step's PCM (see the
        pool's class), zeros for inactive slot-frames, as numpy, or as a
        device tensor with fetch=False (no host sync); None when no slot
        was active."""
        if not self.active.any():
            return None
        pcm = self.advance(self.upload())
        return pcm.cpu().numpy() if fetch else pcm

    def upload(self):
        """A step's first part: the current buffer's parsed wire on the
        pool's device (on CUDA an asynchronous copy, fenced so the host
        writes that buffer again only once the copy has read it)."""
        with span("pool.upload"):
            host = self._wires_t[self._cur][:self._upload_len()]
            if self.device.type != "cuda":
                return host
            wire = host.to(self.device, non_blocking=True)
            # the fence goes on the stream the upload went to (the pool's
            # device, which need not be the current one)
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._uploaded[self._cur] = ev
            return wire

    def advance(self, wire):
        """A step's second part: decode `wire` (``upload``'s) and move
        the pool to the next step; the step's PCM as a device tensor."""
        with span("pool.advance"):
            with span("pool.decode"):
                pcm, self.state = self._decode(wire)
            # swap to the other wire buffer for the next parse; carry
            # this step's active/meta over so post-decode queries keep
            # working.  The other buffer's upload (the previous step's)
            # may still be queued behind the device's work: reclaim it
            # before writing.
            with span("pool.carry"):
                act, meta = self.active.copy(), self.meta.copy()
                self._cur ^= 1
                self._bind_views()
                self._reclaim()
                self.active[:] = act
                self.meta[:] = meta
            if self._resampler is not None:
                pcm = self._resampler(pcm)
            return pcm

    def decode_step_pipelined(self):
        """decode_step with an asynchronous PCM drain: decodes this step,
        starts the copy of its PCM to the host without waiting for it, and
        returns the PREVIOUS step's PCM as numpy (None on the first call
        or after an idle step).  The result belongs to the previous step's
        active mask, so a caller consuming it one step late snapshots
        active/meta alongside.  On CUDA the copy runs on a side stream
        into pinned host memory, so it overlaps the next step's parse,
        upload and decode."""
        pcm = self.decode_step(fetch=False)
        prev = self._pending
        self._pending = None if pcm is None else self._drain(pcm)
        return self._fetch(prev)

    def drain_pending(self):
        """The last pipelined step's PCM (the flush at the end of the
        streams), or None."""
        prev, self._pending = self._pending, None
        return self._fetch(prev)

    def _drain(self, pcm):
        """Start the copy of a step's PCM to the host: (host tensor, event
        that marks the copy done, or None on the CPU)."""
        with span("pool.drain"):
            if pcm.device.type != "cuda":
                return pcm, None
            if self._drain_stream is None:
                self._drain_stream = torch.cuda.Stream(self.device)
            computed = torch.cuda.Event()
            computed.record(torch.cuda.current_stream(pcm.device))
            host = torch.empty(pcm.shape, dtype=pcm.dtype, pin_memory=True)
            self._drain_stream.wait_event(computed)
            with torch.cuda.stream(self._drain_stream):
                host.copy_(pcm, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
            # the allocator must not hand pcm's memory out before the copy
            pcm.record_stream(self._drain_stream)
            return host, done

    @staticmethod
    def _fetch(pending):
        if pending is None:
            return None
        host, done = pending
        if done is not None:
            with span("pool.wait_pcm"):
                done.synchronize()
        return host.numpy()


class StreamDecoder(_Pool):
    """N-slot batched decoder over the native frontend + PyTorch backend.

    device (required) selects where the DSP runs: CUDA launches the
    hand-written kernels (MPEG-1: K2 when exact, else K1, or K5, one per
    frame, with ``models.decoder._FRAME_FUSED`` set; LSF: K3; float PCM:
    K1 / K2's float instances), the CPU runs their plain PyTorch
    versions.
    exact=True decodes bit-exact with the reference decoder.
    frames_per_step=F parses and decodes F frames per slot and step.
    family 1 / 2 makes an MPEG-2 / MPEG-2.5 LSF pool: the handles get
    PROFILE_LSF, the wire carries one granule per frame plus the
    intensity sidecar, and decode_step returns [B, F*576, 2].

    Serving options beyond the reference: float_pcm=True (MPEG-1 pools)
    returns f32 PCM in [-1, 1] (``ops.dsp.float_pack``) instead of S16;
    resample_to=rate resamples every step's S16 PCM on the device to that
    rate (``ops.resample.StreamResampler``) for a pool whose streams all
    run at sample_rate, which it requires.

    decode_step returns interleaved PCM int16 [B, F*1152, 2] ([B, F*576,
    2] for LSF pools; f32 with float_pcm; [B, n_out, 2] resampled);
    a step decodes two granule steps per MPEG-1 frame (or one frame
    step), one per LSF frame."""

    def __init__(self, n_slots: int, exact: bool = False,
                 bug_compat: bool = True, parse_threads: int = 1,
                 frames_per_step: int = 1, profile: int = 0,
                 float_pcm: bool = False, family: int = 0,
                 resample_to: int | None = None,
                 sample_rate: int | None = None, *, device):
        if family not in (0, 1, 2):
            raise ValueError(f"family must be 0, 1 or 2, got {family!r}")
        if float_pcm and family:
            raise ValueError("LSF pools emit S16 PCM (float_pcm needs "
                             "family 0)")
        if resample_to is not None and not sample_rate:
            raise ValueError("resample_to requires sample_rate")
        if resample_to is not None and float_pcm:
            raise ValueError("resample_to resamples S16 PCM: no float_pcm")
        self.exact = exact
        self.family = family
        self.float_pcm = float_pcm
        if family:
            profile |= PROFILE_LSF
        self.profile = profile
        # the native PROFILE_SPEC_INTENSITY flag selects spec intensity
        # stereo on the device too
        self.bug_compat = bug_compat and not (profile
                                              & PROFILE_SPEC_INTENSITY)
        self.n, self.F = n_slots, frames_per_step
        self._lay = self._layout()
        self._open(n_slots, profile, parse_threads, frames_per_step, device,
                   self._lay["total"], torch.int16)
        self.state = M.init_state(n_slots, self.device)
        self._fn, self._sections = self._packer()
        if resample_to is not None:
            from ..ops.resample import StreamResampler
            self._resampler = StreamResampler(sample_rate, resample_to,
                                              n_slots, 2,
                                              device=self.device)

    # ---- the wire (SparseStreamDecoder overrides these) ----

    def _layout(self) -> dict:
        return (M.soa_layout_lsf if self.family else M.soa_layout)(self.n,
                                                                    self.F)

    def _views(self, buf) -> dict:
        return (M.wire_sections_lsf if self.family else M.wire_sections)(
            buf, self.n, self.F)

    def _packer(self):
        """The native packer, its argtypes set, and the wire sections it
        fills, in its argument order."""
        sections = ["ix", "scf_l", "scf_s", "meta", "active"]
        if self.family:
            sections.insert(4, "is_pos")
            fn = lib().pdmp3_parse_step_wire16_lsf
        else:
            fn = lib().pdmp3_parse_step_wire16
        fn.argtypes = ([C.c_void_p, C.c_size_t, C.c_int, C.c_size_t]
                       + [C.c_void_p] * len(sections))
        return fn, sections

    def _packer_args(self) -> list:
        return [getattr(self, name).ctypes.data_as(C.c_void_p)
                for name in self._sections]

    def _upload_len(self) -> int:
        """int16 elements of the wire that the next step uploads."""
        return self._lay["total"]

    def _decode(self, wire):
        if self.family:
            return M.decode_frame_packed_lsf(
                wire, self.state, B=self.n, family=self.family, F=self.F,
                bug_compat=self.bug_compat, exact=self.exact)
        return M.decode_frame_packed(wire, self.state, B=self.n, F=self.F,
                                     bug_compat=self.bug_compat,
                                     exact=self.exact,
                                     float_pcm=self.float_pcm)

    def _bind_views(self):
        """numpy views of the current wire buffer, by section: [F*2,B,...]
        per granule for MPEG-1, [F,B,...] for LSF, active [B] for F = 1,
        else [F,B]."""
        host = self._wires_t[self._cur]
        self.wire = host.numpy()
        for name, t in self._views(host).items():
            setattr(self, name, t.numpy())

    def nch(self, slot: int) -> int:
        return max(int(self.meta[0, slot, M_NCH]), 1)

    # ---- mid-stream join (a seek inside the serving pool) ----

    def join(self, slot: int, data: bytes, start_s: float,
             duration_s: float | None = None, *, index=None):
        """Point ``slot`` at time ``start_s`` of a NEW stream.

        The slot's handle is reset and a :class:`SlotJoin` cursor is
        returned whose payload (silent primer frames and a preroll slice
        that covers the bit reservoir, metadata.plan_seek) the caller
        pumps into the slot's ring as space allows.  The slot's first
        ``drop_samples`` PCM samples per channel are warm-up; what
        follows is bit for bit the same window of a full decode of the
        stream (exact mode).  The device state is not reset, even when
        the slot served another stream: the recurrent carries (overlap
        store, synthesis FIFO, band-12 prev_lines) are rewritten within
        the dropped warm-up.  Returns None when the window is empty;
        ValueError for a stream of another layer or family than the
        pool's."""
        from ..metadata import build_frame_index, plan_seek
        if index is None:
            index = build_frame_index(data)
        plan = plan_seek(data, start_s, duration_s, index=index)
        if plan is None:
            return None
        if plan.info.layer != 3:
            raise ValueError(f"Layer {plan.info.layer} stream: pools "
                             "decode Layer III (L12StreamDecoder for I/II)")
        if plan.info.family != self.family:
            raise ValueError(f"stream family {plan.info.family} != pool "
                             f"family {self.family}")
        self.handles[slot].open_feed()
        return SlotJoin(self, slot, plan)

    # ---- checkpoint/resume: host state blobs + device recurrent state,
    # in the canonical layout the JAX package also writes ----

    def save_checkpoint(self) -> dict:
        s = self.state
        return {
            "handles": [h.save_state() for h in self.handles],
            "store": s.store.cpu().numpy(),
            "v_blocks": s.v_blocks.cpu().numpy(),
            "prev_lines": s.prev_lines.cpu().numpy(),
        }

    def restore_checkpoint(self, ckpt: dict) -> None:
        if len(ckpt["handles"]) != self.n:
            raise ValueError(f"checkpoint has {len(ckpt['handles'])} "
                             f"slots, decoder {self.n}")
        for h, blob in zip(self.handles, ckpt["handles"]):
            h.restore_state(blob)
        prev = ckpt.get("prev_lines")
        if prev is None:
            prev = np.zeros((self.n, 3), np.float32)
        self.state = M.state_from_jax(ckpt["store"], ckpt["v_blocks"], prev,
                                      self.device)


class SlotJoin:
    """Feed cursor of a slot serving a mid-stream join
    (:meth:`StreamDecoder.join`).  ``pump()`` each scheduling round;
    consume the slot's PCM from its first active step: drop the first
    ``drop_samples`` samples per channel, keep up to ``take_samples``."""

    def __init__(self, dec: StreamDecoder, slot: int, plan):
        self.dec, self.slot, self.plan = dec, slot, plan
        self.pos = 0
        self.drop_samples = plan.drop_samples
        self.take_samples = plan.take_samples

    @property
    def exhausted(self) -> bool:
        return self.pos >= len(self.plan.payload)

    def pump(self) -> int:
        """Feed as much of the remaining payload as the slot's ring
        takes; returns the bytes fed (0 once exhausted)."""
        free = self.dec.inbuf_free(self.slot)
        chunk = self.plan.payload[self.pos:self.pos + free]
        if not chunk:
            return 0
        rc = self.dec.feed(self.slot, chunk)
        if rc != T.OK:
            raise RuntimeError(f"slot {self.slot}: feed returned {rc}")
        self.pos += len(chunk)
        return len(chunk)


class SparseStreamDecoder(StreamDecoder):
    """StreamDecoder over the count1-bounded sparse wire: the spectra ship
    as 128-line blocks covering only each channel's nonzero prefix (the
    lines from count1 up are zero, pdmp3.c:2108-2111) plus a block table,
    and the device re-densifies them; PCM and state are bit for bit the
    dense wire's.  A step uploads the fixed sections and the blocks'
    prefix of the flat region (``wire_bytes``)."""

    def _layout(self) -> dict:
        lay = (M.sparse_layout_lsf if self.family else M.sparse_layout)(
            self.n, self.F)
        self._cap_full = lay["cap_blocks"]
        self._used = C.c_longlong(0)
        self._bucket_sticky = 0
        return lay

    def _views(self, buf) -> dict:
        return (M.sparse_sections_lsf if self.family else M.sparse_sections)(
            buf, self.n, self.F)

    def _packer(self):
        sections = ["blk", "scf_l", "scf_s", "meta", "active"]
        if self.family:
            sections.insert(4, "is_pos")
            fn = lib().pdmp3_parse_step_wire16_lsf_sparse
        else:
            fn = lib().pdmp3_parse_step_wire16_sparse
        fn.argtypes = ([C.c_void_p, C.c_size_t, C.c_int, C.c_size_t,
                        C.c_void_p, C.c_size_t]
                       + [C.c_void_p] * len(sections)
                       + [C.POINTER(C.c_longlong)])
        return fn, sections

    def _packer_args(self) -> list:
        return [self.ix_flat.ctypes.data_as(C.c_void_p), self._cap_full,
                *super()._packer_args(), C.byref(self._used)]

    def _bucket_blocks(self) -> int:
        """The step's blocks rounded up to 1/8ths of the worst case, and
        sticky upward, as the JAX package buckets them: a dip in
        occupancy never shrinks the upload."""
        used = max(int(self._used.value), 1)
        gran = max(64, -(-self._cap_full // 8))
        b = min(-(-used // gran) * gran, self._cap_full)
        self._bucket_sticky = max(b, self._bucket_sticky)
        return self._bucket_sticky

    def _upload_len(self) -> int:
        return self._lay["fixed"] + self._bucket_blocks() * M.SPARSE_BLOCK

    def _decode(self, wire):
        cap = (wire.shape[0] - self._lay["fixed"]) // M.SPARSE_BLOCK
        if self.family:
            return M.decode_frame_lsf_sparse(
                wire, self.state, B=self.n, family=self.family, F=self.F,
                cap_blocks=cap, bug_compat=self.bug_compat, exact=self.exact)
        return M.decode_frame_sparse(wire, self.state, B=self.n, F=self.F,
                                     cap_blocks=cap,
                                     bug_compat=self.bug_compat,
                                     exact=self.exact,
                                     float_pcm=self.float_pcm)


class L12StreamDecoder(_Pool):
    """N-slot batched Layer I/II decoder (beyond the reference, which
    rejects layer != 3, pdmp3.c:1240/1312).

    One layer per pool, as one family per LSF pool: the handles get
    PROFILE_L12, the native frontend parses and requantizes (a Layer
    I/II bitstream has no Huffman stage or reservoir), and the wire
    carries f32 subband samples [F,B,2,S,32] (S = 12 Layer I, 36 Layer
    II), meta int16 [F,B,4] and active, packed into one pinned byte
    buffer per step (``models.l12.l12_layout``) and decoded by the
    batched synthesis (``models.l12.decode_l12_wire``: K7, one launch
    a frame, on CUDA).
    The surface is StreamDecoder's (feed, parse_step, decode_step, the
    pipelined drain, checkpoints); decode_step returns PCM int16
    [B, F*S*32, 2] (f32 with float_pcm).  The per-slot device state is
    the synthesis FIFO alone.  device is required."""

    def __init__(self, n_slots: int, layer: int = 2, exact: bool = False,
                 parse_threads: int = 1, frames_per_step: int = 1,
                 profile: int = 0, float_pcm: bool = False, *, device):
        self.layer = layer
        self.S = L.l12_steps(layer)
        self.exact = exact
        self.float_pcm = float_pcm
        self.profile = profile | PROFILE_L12
        self.n, self.F = n_slots, frames_per_step
        self._lay = L.l12_layout(n_slots, layer, frames_per_step)
        self._open(n_slots, self.profile, parse_threads, frames_per_step,
                   device, self._lay["total"], torch.uint8)
        self.state = L.init_l12_state(n_slots, self.device)
        self._fn = lib().pdmp3_parse_step_wire_l12
        self._fn.argtypes = [C.c_void_p, C.c_size_t, C.c_int, C.c_size_t,
                             C.c_int, C.c_void_p, C.c_void_p, C.c_void_p]

    def _bind_views(self):
        host = self._wires_t[self._cur]
        for name, t in L.l12_sections(host, self.n, self.layer,
                                      self.F).items():
            setattr(self, name, t.numpy())

    def _packer_args(self) -> list:
        return [self.layer] + [getattr(self, name).ctypes.data_as(C.c_void_p)
                               for name in ("sb", "meta", "active")]

    def _decode(self, wire):
        return L.decode_l12_wire(wire, self.state, self.n, self.layer,
                                 self.F, self.exact, self.float_pcm)

    def nch(self, slot: int) -> int:
        return max(int(self.meta[0, slot, 0]), 1)

    # ---- checkpoint/resume, in the JAX package's layout ----

    def save_checkpoint(self) -> dict:
        return {"handles": [h.save_state() for h in self.handles],
                "v_blocks": self.state.v_blocks.cpu().numpy()}

    def restore_checkpoint(self, ckpt: dict) -> None:
        if len(ckpt["handles"]) != self.n:
            raise ValueError(f"checkpoint has {len(ckpt['handles'])} "
                             f"slots, decoder {self.n}")
        for h, blob in zip(self.handles, ckpt["handles"]):
            h.restore_state(blob)
        self.state = L.l12_state_from_jax(ckpt["v_blocks"], self.device)


def _trimmed_payloads(files: list[bytes], gapless: bool, window):
    """Per file, the bytes to decode and (drop, take, bytes per sample
    frame): for window=(start_s, duration_s) the plan_seek payload of
    that window, for gapless the audio from the first frame with a
    primer tail that flushes the last frame, and the LAME trim."""
    from ..metadata import (_primer_frames, build_frame_index,
                            gapless_bounds, parse_header, plan_seek)
    trims, payloads = [], []
    for data in files:
        data = bytes(data)
        idx = build_frame_index(data)
        info = idx.info
        if window is not None:
            plan = plan_seek(data, window[0],
                             None if len(window) < 2 else window[1],
                             index=idx)
            if plan is None:
                payloads.append(b"")
                trims.append((0, 0, 2 * info.channels))
                continue
            payloads.append(plan.payload)
            trims.append((plan.drop_samples, plan.take_samples,
                          2 * info.channels))
        else:
            skip, keep = gapless_bounds(info)
            tail = b""
            if keep is not None:
                h0 = parse_header(data, info.first_audio_offset)
                if h0 is not None:
                    tail = _primer_frames(h0)[0]
                    while len(tail) < 2 * 1152:
                        tail += tail
            payloads.append(data[info.first_audio_offset:] + tail)
            trims.append((skip, keep, 2 * info.channels))
    return payloads, trims


def decode_files_batched(files: list[bytes], n_slots: int | None = None,
                         exact: bool = False, chunk: int = 4096,
                         family: int = 0, layer: int = 3,
                         gapless: bool = False,
                         window: tuple | None = None, *,
                         device) -> list[bytes]:
    """Offline batched decode (BASELINE.json configs[3]): the files go
    round-robin over n_slots slots (default: one each), and every group
    steps in lockstep on ``device``.  family 1/2 decodes an MPEG-2 /
    MPEG-2.5 (LSF) corpus through the family's pool; layer 1/2 a Layer
    I/II corpus through L12StreamDecoder.  Returns each file's PCM bytes
    (S16LE, mono files one channel), as the native decoder gives them.

    gapless=True applies each file's LAME delay/padding trim (the exact
    track length, metadata.decode_file_gapless); window=(start_s,
    duration_s) decodes that window of every file, bit for bit the same
    window of its full decode (exact mode; a plan_seek preroll per
    file).  Both are Layer III options."""
    trims = None
    if gapless or window is not None:
        if layer != 3:
            raise ValueError("gapless and window are Layer III options")
        if gapless and window is not None:
            raise ValueError("pick one of gapless and window")
        files, trims = _trimmed_payloads(files, gapless, window)
    if layer in (1, 2) and family:
        raise ValueError("Layer I/II pools select by layer, not family")
    n = n_slots or len(files)
    out: list[list[bytes]] = [[] for _ in files]
    for base in range(0, len(files), n):
        group = files[base:base + n]
        if layer in (1, 2):
            dec = L12StreamDecoder(len(group), layer=layer, exact=exact,
                                   device=device)
        else:
            dec = StreamDecoder(len(group), exact=exact, family=family,
                                device=device)
        pos = [0] * len(group)
        while True:
            # keep the input rings topped up
            for s, data in enumerate(group):
                while pos[s] < len(data):
                    if dec.inbuf_free(s) < chunk:
                        break
                    n_feed = min(chunk, len(data) - pos[s])
                    dec.feed(s, data[pos[s]:pos[s] + n_feed])
                    pos[s] += n_feed
            if dec.parse_step() == 0:
                break
            pcm = dec.decode_step()
            for s in range(len(group)):
                if dec.active[s]:
                    p = pcm[s]   # [1152, 2] (LSF [576, 2], Layer I [384, 2])
                    out[base + s].append(p[:, 0].tobytes()
                                         if dec.nch(s) == 1
                                         else p.tobytes())
    pcms = [b"".join(chunks) for chunks in out]
    if trims is not None:
        for i, (drop, take, fb) in enumerate(trims):
            pcm = pcms[i][drop * fb:]
            if take is not None:
                pcm = pcm[:take * fb]
            pcms[i] = pcm
    return pcms
