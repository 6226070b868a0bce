"""Multi-stream serving over the native frontend and the PyTorch backend.

Counterpart of ``pdmp3_tpu/runtime/scheduler.py`` (``LoopFeeder``,
``StreamDecoder``) for MPEG-1 pools and the per-family LSF pools
(MPEG-2, MPEG-2.5), in fast or exact precision.  N streams are pinned to
slots; one native call parses a frame per slot into a packed int16 wire
buffer, one upload moves it to the device, and the frame's granule
steps (two for MPEG-1, one for LSF) decode every slot in lockstep.
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
    hand-written granule kernel (MPEG-1: K2 when exact, else K1; LSF:
    K3), the CPU runs its plain PyTorch version.  exact=True decodes
    bit-exact with the reference decoder.  family 1 / 2 makes an MPEG-2 /
    MPEG-2.5 LSF pool: the handles get PROFILE_LSF, the wire carries one
    granule per frame plus the intensity sidecar, and decode_step
    returns [B, 576, 2].  Options of the JAX StreamDecoder that this
    package does not implement yet raise NotImplementedError."""

    def __init__(self, n_slots: int, exact: bool = False,
                 bug_compat: bool = True, parse_threads: int = 1,
                 frames_per_step: int = 1, profile: int = 0,
                 float_pcm: bool = False, family: int = 0,
                 resample_to: int | None = None, *, device):
        if family not in (0, 1, 2):
            raise ValueError(f"family must be 0, 1 or 2, got {family!r}")
        for name, unsupported in (
                ("float_pcm=True", float_pcm),
                ("resample_to", resample_to is not None),
                ("frames_per_step > 1", frames_per_step != 1)):
            if unsupported:
                raise NotImplementedError(
                    f"{name}: not ported to the PyTorch backend yet")
        self.n = n_slots
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
        self._lay = (M.soa_layout_lsf if family else M.soa_layout)(n_slots)
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
        # the wire's sections, in the packer's argument order
        self._sections = ["ix", "scf_l", "scf_s", "meta", "active"]
        if family:
            self._sections.insert(4, "is_pos")
            self._fn = lib().pdmp3_parse_step_wire16_lsf
        else:
            self._fn = lib().pdmp3_parse_step_wire16
        self._fn.argtypes = ([C.c_void_p, C.c_size_t, C.c_int, C.c_size_t]
                             + [C.c_void_p] * len(self._sections))
        self._handle_arr = (C.c_void_p * self.n)(
            *[h._h for h in self.handles])

    def _bind_views(self):
        """numpy views of the current wire buffer, by section."""
        host = self._wires_t[self._cur]
        self.wire = host.numpy()
        sections = M.wire_sections_lsf if self.family else M.wire_sections
        for name, t in sections(host, self.n).items():
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
        """Parse one frame per slot into the current wire buffer (one
        native call for the whole batch).  Returns the number of active
        slots."""
        self._reclaim()
        return self._fn(self._handle_arr, self.n, self.parse_threads, 1,
                        *[getattr(self, name).ctypes.data_as(C.c_void_p)
                          for name in self._sections])

    # ---- device side ----

    def decode_step(self, fetch: bool = True):
        """Decode the parsed frame (two granule steps; one for LSF
        pools).  Returns interleaved PCM int16 [B, 1152, 2] ([B, 576, 2]
        for LSF pools), zeros for inactive slots, as numpy, or as a
        device tensor with fetch=False (no host sync); None when no slot
        was active."""
        if not self.active.any():
            return None
        host = self._wires_t[self._cur]
        if self.device.type == "cuda":
            wire = host.to(self.device, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            self._uploaded[self._cur] = ev
        else:
            wire = host
        if self.family:
            pcm, self.state = M.decode_frame_packed_lsf(
                wire, self.state, B=self.n, family=self.family,
                bug_compat=self.bug_compat, exact=self.exact)
        else:
            pcm, self.state = M.decode_frame_packed(
                wire, self.state, B=self.n, bug_compat=self.bug_compat,
                exact=self.exact)
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

    def nch(self, slot: int) -> int:
        meta = self.meta if self.family else self.meta[0]
        return max(int(meta[slot, M_NCH]), 1)

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
