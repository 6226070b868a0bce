"""backend: a card fed by remote parse hosts, as ``BASELINE.json``
configs[4]'s double-buffered backend.

Set-up runs the pool for two periods of the streams (feed,
``parse_step``, ``StreamDecoder.upload``, ``advance``) and keeps each
step's wire of the second in a pinned host ring; the window replays the ring in order,
continuing the pool's own state.  Each step's wire goes up on a copy
stream into one of two device buffers while the previous step decodes;
the model step is the pool's own ``advance`` on the compute stream, once
its wire is there; its PCM goes down on a third stream into pinned host
memory and is delivered ``DEPTH`` steps later.  The upload and the
drain are the harness's own, a fixed cost.
"""
import torch

from benchmark.drive import Record, now

# steps of PCM a replayed window keeps in flight before it delivers one
DEPTH = 3


def _record_ring(pool, feeder, steps: int, watch, rec: Record):
    """Two periods of `steps` steps of the pool, the wires of the second
    kept in a pinned host ring [steps, wire] (on CUDA) with their active
    slot-frames and the watched slots' active flags; the watched PCM of
    both goes to rec.  A frame's wire can depend on what the parser read
    before it (the reference decoder's count1 table B keeps a pointer from
    an earlier granule), so the first period, parsed from a fresh state,
    is not recorded, and the next step's wire has to equal the ring's
    first (RuntimeError if not): the window's replay is the looped
    streams' own continuation."""
    cuda = pool.device.type == "cuda"
    rows = torch.as_tensor(watch, device=pool.device)
    ring = None
    counts, acts = [], []
    for k in range(2 * steps + 1):
        feeder.step()
        n = pool.parse_step()
        wire = pool.upload()
        if k == 2 * steps:
            if not torch.equal(wire.cpu(), ring[0]):
                raise RuntimeError(f"the pool's wire does not repeat after "
                                   f"{steps} steps")
            break
        act = pool.active[watch] != 0
        if k >= steps:
            if ring is None:
                ring = torch.empty((steps,) + wire.shape, dtype=wire.dtype,
                                   pin_memory=cuda)
            ring[k - steps].copy_(wire)
            counts.append(n)
            acts.append(act)
        pcm = pool.advance(wire)
        rec.watched.append((pcm[rows].cpu().numpy(), act))
    return ring, counts, acts


def run(pool, corpus, traffic, seconds: float, spans, window) -> Record:
    """Record a period of the pool's wire (``_record_ring``), replay it
    for `warmup_steps` and then until `seconds` have passed (between
    window.start() and window.end())."""
    from pdmp3_tpu_torch import LoopFeeder

    rec = Record()
    watch = corpus.watch
    ring, counts, acts = _record_ring(pool, LoopFeeder(pool, corpus.feeds),
                                      corpus.period, watch, rec)
    dev = pool.device
    cuda = dev.type == "cuda"
    wires = [torch.empty(ring.shape[1:], dtype=ring.dtype, device=dev)
             for _ in range(2)]
    host = [None] * DEPTH
    inflight = [None] * DEPTH   # (copy done, ring step, in window)
    if cuda:
        compute = torch.cuda.current_stream(dev)
        up, down = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
    uploaded = [None, None]     # wire i is on the card
    read = [None, None]         # the model step has read wire i
    t = 0

    def upload(u):
        """Start step u's upload into wire u % 2 once the step before
        has read that buffer."""
        i, k = u % 2, u % ring.shape[0]
        if not cuda:
            wires[i].copy_(ring[k])
            return
        with torch.cuda.stream(up):
            if read[i] is not None:
                up.wait_event(read[i])
            wires[i].copy_(ring[k], non_blocking=True)
            uploaded[i] = torch.cuda.Event()
            uploaded[i].record(up)

    def deliver(slot):
        done, k, counted = inflight[slot]
        inflight[slot] = None
        if done is not None:
            with spans("wait"):
                done.synchronize()
        with spans("deliver"):
            rec.watched.append((host[slot].numpy()[watch], acts[k]))
            if counted:
                rec.slot_frames += counts[k]
                rec.t_last = now()

    def step(counted: bool):
        nonlocal t
        if counted:
            rec.step_starts.append(now())
        slot, i, k = t % DEPTH, t % 2, t % ring.shape[0]
        if inflight[slot] is not None:
            deliver(slot)
        with spans("upload"):
            upload(t + 1)
        if cuda:
            compute.wait_event(uploaded[i])
        with spans("decode"):
            pcm = pool.advance(wires[i])
        with spans("drain"):
            if host[slot] is None:
                host[slot] = torch.empty(pcm.shape, dtype=pcm.dtype,
                                         pin_memory=cuda)
            done = None
            if cuda:
                read[i] = torch.cuda.Event()
                read[i].record(compute)
                down.wait_event(read[i])
                with torch.cuda.stream(down):
                    host[slot].copy_(pcm, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record(down)
                pcm.record_stream(down)
            else:
                host[slot].copy_(pcm)
        inflight[slot] = (done, k, counted)
        if counted:
            rec.steps += 1
            rec.attempted += pool.n * pool.F
            rec.window_active.append(counts[k])
        t += 1

    def flush():
        for j in range(DEPTH):
            slot = (t + j) % DEPTH
            if inflight[slot] is not None:
                deliver(slot)

    upload(0)
    for _ in range(traffic["warmup_steps"]):
        step(False)
    flush()
    window.start()
    rec.t_start = now()
    while True:
        step(True)
        # a window delivers at least one of its own steps
        if now() - rec.t_start >= seconds and rec.steps > DEPTH:
            break
    window.end()
    for j in range(DEPTH):
        # after the window's close: checked, not counted
        slot = (t + j) % DEPTH
        if inflight[slot] is not None:
            inflight[slot] = inflight[slot][:2] + (False,)
    flush()
    if cuda:
        up.synchronize()
    return rec
