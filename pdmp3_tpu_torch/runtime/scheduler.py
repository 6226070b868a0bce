"""Multi-stream serving over the native frontend and the PyTorch backend.

Counterpart of ``pdmp3_tpu/runtime/scheduler.py`` (``LoopFeeder``,
``StreamDecoder``, ``SparseStreamDecoder``) for MPEG-1 pools and the
per-family LSF pools (MPEG-2, MPEG-2.5), in fast or exact precision.  N
streams are pinned to slots; one native call parses F frames per slot
into a packed int16 wire buffer (dense, or count1-bounded sparse), one
upload moves it to the device, and the frames' steps decode every slot
in lockstep.
Starved, finished or malformed streams leave their slot inactive for
the step: its state stays frozen and its PCM is silence, so one bad
stream never perturbs its neighbours.
"""
from __future__ import annotations

import ctypes as C

import numpy as np
import torch

from ..host import PROFILE_LSF, PROFILE_SPEC_INTENSITY, NativePDMP3, lib
from ..models import decoder as M
from ..ops.dsp import M_NCH


class LoopFeeder:
    """Tops up every slot's input ring from a looping per-slot source
    stream in ONE native pdmp3_feed_loop call per step."""

    def __init__(self, dec: "StreamDecoder", streams: list[bytes]):
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


class StreamDecoder:
    """N-slot batched decoder over the native frontend + PyTorch backend.

    device (required) selects where the DSP runs: CUDA launches the
    hand-written kernels (MPEG-1: K2 when exact, else K1, or K5, one per
    frame, with ``models.decoder._FRAME_FUSED`` set; LSF: K3), the CPU
    runs their plain PyTorch versions.  exact=True decodes bit-exact with
    the reference decoder.  frames_per_step=F parses and decodes F frames
    per slot and step.  family 1 / 2 makes an MPEG-2 / MPEG-2.5 LSF pool:
    the handles get PROFILE_LSF, the wire carries one granule per frame
    plus the intensity sidecar, and decode_step returns [B, F*576, 2].
    Options of the JAX StreamDecoder that this package does not implement
    yet raise NotImplementedError."""

    def __init__(self, n_slots: int, exact: bool = False,
                 bug_compat: bool = True, parse_threads: int = 1,
                 frames_per_step: int = 1, profile: int = 0,
                 float_pcm: bool = False, family: int = 0,
                 resample_to: int | None = None, *, device):
        if family not in (0, 1, 2):
            raise ValueError(f"family must be 0, 1 or 2, got {family!r}")
        if frames_per_step < 1:
            raise ValueError(f"frames_per_step must be >= 1, got "
                             f"{frames_per_step!r}")
        for name, unsupported in (
                ("float_pcm=True", float_pcm),
                ("resample_to", resample_to is not None)):
            if unsupported:
                raise NotImplementedError(
                    f"{name}: not ported to the PyTorch backend yet")
        self.n = n_slots
        self.F = frames_per_step
        self.exact = exact
        self.family = family
        if family:
            profile |= PROFILE_LSF
        self.device = torch.device(device)
        # the native PROFILE_SPEC_INTENSITY flag selects spec intensity
        # stereo on the device too
        self.bug_compat = bug_compat and not (profile
                                              & PROFILE_SPEC_INTENSITY)
        self.parse_threads = parse_threads
        self.handles = [NativePDMP3() for _ in range(n_slots)]
        for h in self.handles:
            if profile:
                h.set_profile(profile)
            h.open_feed()
        self.state = M.init_state(n_slots, self.device)
        self._lay = self._layout()
        # double-buffered wire: the upload of step t may still be in
        # flight while the host parses step t+1 into the other buffer.
        # On CUDA both buffers are pinned (the non_blocking upload is a
        # true async DMA that reads the buffer when the stream reaches
        # it) and an event per buffer fences every host write to it.
        cuda = self.device.type == "cuda"
        self._wires_t = [torch.zeros(self._lay["total"], dtype=torch.int16,
                                     pin_memory=cuda) for _ in range(2)]
        self._uploaded = [None, None]
        self._cur = 0
        self._bind_views()
        self._fn, self._sections = self._packer()
        self._handle_arr = (C.c_void_p * self.n)(
            *[h._h for h in self.handles])
        # the pipelined drain: the previous step's PCM copy in flight
        self._pending = None
        self._drain_stream = None

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
                                     exact=self.exact)

    def _bind_views(self):
        """numpy views of the current wire buffer, by section: [F*2,B,...]
        per granule for MPEG-1, [F,B,...] for LSF, active [B] for F = 1,
        else [F,B]."""
        host = self._wires_t[self._cur]
        self.wire = host.numpy()
        for name, t in self._views(host).items():
            setattr(self, name, t.numpy())

    def _reclaim(self):
        """Wait until the current buffer's last upload has read it; only
        then may the host write to it."""
        done = self._uploaded[self._cur]
        if done is not None:
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
        return self._fn(self._handle_arr, self.n, self.parse_threads, self.F,
                        *self._packer_args())

    # ---- device side ----

    def decode_step(self, fetch: bool = True):
        """Decode the parsed frames (two granule steps per MPEG-1 frame,
        or one frame step; one granule step per LSF frame).  Returns
        interleaved PCM int16 [B, F*1152, 2] ([B, F*576, 2] for LSF
        pools), zeros for inactive slot-frames, as numpy, or as a device
        tensor with fetch=False (no host sync); None when no slot was
        active."""
        if not self.active.any():
            return None
        host = self._wires_t[self._cur][:self._upload_len()]
        if self.device.type == "cuda":
            wire = host.to(self.device, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            self._uploaded[self._cur] = ev
        else:
            wire = host
        pcm, self.state = self._decode(wire)
        # swap to the other wire buffer for the next parse; carry this
        # step's active/meta over so post-decode queries keep working.
        # The other buffer's upload (the previous step's) may still be
        # queued behind the device's work: reclaim it before writing.
        act, meta = self.active.copy(), self.meta.copy()
        self._cur ^= 1
        self._bind_views()
        self._reclaim()
        self.active[:] = act
        self.meta[:] = meta
        return pcm.cpu().numpy() if fetch else pcm

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
        if pcm.device.type != "cuda":
            return pcm, None
        if self._drain_stream is None:
            self._drain_stream = torch.cuda.Stream(self.device)
        computed = torch.cuda.Event()
        computed.record()
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
            done.synchronize()
        return host.numpy()

    def nch(self, slot: int) -> int:
        return max(int(self.meta[0, slot, M_NCH]), 1)

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

    def wire_bytes(self) -> int:
        """Bytes the next decode_step uploads."""
        return 2 * self._upload_len()

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
                                     exact=self.exact)
