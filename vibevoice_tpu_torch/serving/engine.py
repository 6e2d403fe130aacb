"""Continuous-batching TTS serving engine (port of vibevoice_tpu/serving/engine.py).

The engine keeps one batched ``DecodeCarry`` of ``max_batch`` slots on the
parameters' device and:

* prefills each arriving request into a batch-1 carry on a worker thread
  (``inference.prefill_request``: the prompt, the voice features, both CFG
  streams), so host work and prefill never stall the active streams between
  their windows;
* joins a finished prefill into a free slot between windows
  (``join_slot``: the slot's rows of the batched carry are overwritten in
  place; the per-sample cache lengths make slots independent);
* steps every slot together, K frames a window, through its own compiled
  step function (``inference.StepFn``: a CUDA graph replayed on the card),
  routing each slot's audio frames to its request;
* frees slots at EOS, at the request's frame cap, on cancel and at its
  deadline.

On the card the engine owns its step function's capture: after the first
window ``self.carry`` is the capture's static carry, a join edits its rows
in place, and the next replay copies nothing (``StepFn`` docstring). If the
capture is evicted (``inference.MAX_CAPTURES``), the next window captures
again from the engine's tensors. The decode loop enqueues on the device's
default stream; the prefill worker on a stream of its own, of high
priority, so that a prefill runs beside the windows instead of in turns
with them (on one stream an eager prefill's many small launches wait
behind every window enqueued meanwhile). The kernels' persistent
workspaces are kept per stream (``ops/_cuda.workspace_key``); the prefill
thread waits for its own work before it hands the carry over, and a join
marks the prefilled tensors as read by the decode stream
(``record_stream``), so their memory is not reused under the copy. Each
window's frame noise is drawn on the card from one engine generator before
the window; its outputs are copied to pinned host memory before the next
replay overwrites them.

The decode thread owns the carry and the slots; the prefill thread touches
only its own batch-1 carries. Submissions and consumers are thread-safe.

Tensor-parallel serving (``mesh=``, a DeviceMesh with a "tp" dimension;
dense LM weights only, as in the JAX package): one process per rank, each
holding its shards of the LM (``parallel.mesh.model_param_shardings``) and
the KV cache of its own KV heads; the rest is replicated. The engine is
SPMD. Rank 0 of the group owns the queue and the slots: at each window
boundary it broadcasts its decision (stop, the requests to join and their
slots, the window's ext-finish rows) over a gloo side group, and every rank
then prefills the same requests into the same slots and runs the same
window, drawing the same frame noise from an identically seeded generator,
so every rank chooses the same tokens (``token_log`` keeps each window's).
Under TP the prefill runs in the decode loop, between windows, so the
ranks issue their collectives in one order. The other ranks' engines take
no submissions; their ``shutdown`` waits for rank 0's. A gloo "tp" group
needs ``eager_windows=True`` (its collectives cannot be captured in a CUDA
graph); an NCCL group's are captured with the window.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import queue
import threading
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..configs import VibeVoiceConfig
from ..models import inference as inf
from ..models import qwen2
from ..models import tokenizer as tok


def join_slot(carry: inf.DecodeCarry, single: inf.DecodeCarry, slot: int,
              batch: int) -> inf.DecodeCarry:
    """Write a prefilled batch-1 carry (positive row 0, negative row 1 of its
    cache) into ``slot`` of the batched ``carry`` in place: the positive row
    at ``slot``, the negative row at ``batch + slot``, the int8 row scales
    where the cache has them, the conv states, the hidden states, the
    lengths, ``finished`` cleared and ``n_diff`` zeroed. Builds no tensor;
    returns ``carry`` itself."""
    if (carry.cache.quantized, carry.cache.max_len) != (single.cache.quantized,
                                                        single.cache.max_len):
        raise ValueError("the prefilled carry's cache does not match the engine's (slots, int8)")

    def rows(dst_bufs, src_bufs):
        for dst, src in zip(dst_bufs, src_bufs):
            dst[slot].copy_(src[0])
            dst[batch + slot].copy_(src[1])

    cache = carry.cache
    rows(cache.k, single.cache.k)
    rows(cache.v, single.cache.v)
    if cache.quantized:
        rows(cache.k_scale, single.cache.k_scale)
        rows(cache.v_scale, single.cache.v_scale)
    rows((cache.length,), (single.cache.length,))
    for state, new in ((carry.dec_state, single.dec_state), (carry.sem_state, single.sem_state)):
        for name, buf in state.items():
            buf[slot].copy_(new[name][0])
    carry.h_pos[slot].copy_(single.h_pos[0])
    carry.h_neg[slot].copy_(single.h_neg[0])
    carry.finished[slot] = False
    carry.n_diff[slot] = 0
    return carry


@dataclass
class Request:
    input_ids: np.ndarray  # (1, T), right-padded
    valid_mask: np.ndarray
    speech_tensors: Optional[np.ndarray] = None
    speech_frame_valid: Optional[np.ndarray] = None
    speech_input_mask: Optional[np.ndarray] = None
    # Seeds the voice prompt's VAE noise as inference.generate(seed=...)
    # does (the first draw of a generator seeded with it), so the prefilled
    # carry is the one generate() makes. Frame noise comes from the engine's
    # generator (unrelated requests share a window); deterministic audio
    # needs the offline API.
    seed: int = 0
    max_length_times: float = 2.0
    # wall-clock budget from submit(); an expired request is finished like a
    # cancel (audio already produced stays available) and counts as
    # `deadline_expired` in EngineStats
    deadline_s: Optional[float] = None
    # latency lane: a priority request jumps the prefill queue and may take
    # any free slot, the engine's `reserved_slots` included, which bulk
    # requests never occupy
    priority: bool = False


@dataclass
class EngineStats:
    """Point-in-time engine observability snapshot (engine.stats())."""

    submitted: int
    completed: int
    failed: int
    cancelled: int
    deadline_expired: int
    active: int  # slots decoding right now
    queued: int  # waiting for prefill or a free slot
    frames_emitted: int
    audio_seconds_emitted: float
    ttfa_p50_ms: Optional[float]  # over the last 256 requests with a first frame
    ttfa_p95_ms: Optional[float]
    uptime_s: float
    priority_ttfa_p50_ms: Optional[float] = None  # None until priority traffic had audio
    priority_submitted: int = 0


class RequestHandle:
    _END = object()

    def __init__(self, request: Request):
        self.request = request
        self.chunks: "queue.Queue" = queue.Queue()
        self._audio: List[np.ndarray] = []
        self.tokens: List[int] = []  # the token of each frame, the finishing frame's included
        self._done = threading.Event()
        self.error: Optional[BaseException] = None
        self.cancelled = threading.Event()
        self.submit_time = time.monotonic()
        self.first_audio_time: Optional[float] = None  # set on the first frame
        self.deadline_expired = False
        # the scalar record the engine keeps after this handle is gone
        # (stats() must not hold request audio in host memory)
        self.rec = {"submit": self.submit_time, "ttfa_ms": None, "outcome": None,
                    "priority": request.priority}

    def _deadline_exceeded(self) -> bool:
        d = self.request.deadline_s
        return d is not None and (time.monotonic() - self.submit_time) > d

    def cancel(self):
        """Stop this request: a pending request is finished at admission, an
        active one through the next window's ext-finish row. Audio already
        produced stays available from result()/stream()."""
        self.cancelled.set()

    def stream(self):
        """Iterate audio frames (each `hop` samples) as they are produced."""
        while True:
            c = self.chunks.get()
            if c is self._END:
                return
            yield c

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block until generation finishes; returns the whole waveform."""
        if not self._done.wait(timeout):
            raise TimeoutError("generation not finished")
        if self.error is not None:
            raise self.error
        return np.concatenate(self._audio) if self._audio else np.zeros(0, np.float32)

    # engine side
    def _push(self, audio: np.ndarray):
        if self.first_audio_time is None:
            self.first_audio_time = time.monotonic()
            self.rec["ttfa_ms"] = (self.first_audio_time - self.submit_time) * 1e3
        self._audio.append(audio)
        self.chunks.put(audio)

    def _finish(self, err: Optional[BaseException] = None):
        self.error = err
        if self.deadline_expired:
            self.rec["outcome"] = "deadline_expired"
        elif self.cancelled.is_set():
            self.rec["outcome"] = "cancelled"
        elif err is not None:
            self.rec["outcome"] = "failed"
        else:
            self.rec["outcome"] = "completed"
        self.chunks.put(self._END)
        self._done.set()


class ServingEngine:
    """Continuous batching of ``max_batch`` requests over one compiled step
    of ``frames_per_dispatch`` frames (module docstring). ``pipeline`` keeps
    one window in flight: the card computes window N + 1 while the host
    delivers window N. ``reserved_slots`` express slots are taken only by
    ``Request(priority=True)``. ``mesh`` serves tensor-parallel (module
    docstring); ``eager_windows`` runs each window launch by launch
    instead of replaying its CUDA graph."""

    def __init__(
        self,
        cfg: VibeVoiceConfig,
        params,
        *,
        tokens: inf.SpecialTokens = inf.SpecialTokens(),
        opts: inf.GenerateOptions = inf.GenerateOptions(),
        max_batch: int = 4,
        max_len: int = 4096,
        idle_sleep: float = 0.002,
        frames_per_dispatch: Optional[int] = None,  # None -> opts.frames_per_dispatch
        pipeline: bool = True,
        mesh=None,
        reserved_slots: int = 0,
        eager_windows: bool = False,
    ):
        if not (0 <= reserved_slots < max_batch):
            raise ValueError(f"reserved_slots must be in [0, max_batch); got {reserved_slots}")
        self.mesh = mesh
        self.tp_group = None
        self.leader = True
        if mesh is not None:
            params = self._shard(cfg, params, mesh)
        self.eager_windows = eager_windows
        self.cfg = cfg
        self.params = params
        self.tokens = tokens
        # kv_int8=None resolves against THIS engine's cache length
        # (opts.max_length is the per-request cap only)
        self.opts = opts = inf.resolve_kv_int8(opts, max_len)
        self.max_batch = max_batch
        self.max_len = max_len
        self.idle_sleep = idle_sleep
        if frames_per_dispatch is None:
            frames_per_dispatch = max(1, opts.frames_per_dispatch)
        self.frames_per_dispatch = frames_per_dispatch
        self.pipeline = pipeline
        self.reserved_slots = reserved_slots
        # the engine's own step function (not the memoized one generate()
        # takes): its capture's static carry is the engine's carry
        self.step_fn = inf.StepFn(cfg, tokens, inf._trace_opts(opts), frames_per_dispatch,
                                  stacked=frames_per_dispatch > 1, tp_group=self.tp_group)

        embed = params["lm"]["embed"]
        dtype, self.device = embed.dtype, embed.device
        if (self.tp_group is not None and self.device.type == "cuda" and not eager_windows
                and dist.get_backend(self.tp_group) != "nccl"):
            raise ValueError(
                f"a {dist.get_backend(self.tp_group)!r} tensor-parallel group's collectives cannot "
                "be captured in the windows' CUDA graphs (only NCCL's): pass eager_windows=True")
        b, hidden = max_batch, cfg.decoder_config.hidden_size
        self.carry = inf.DecodeCarry(
            cache=qwen2.make_cache(cfg.decoder_config, 2 * b, max_len, dtype,
                                   quantized=bool(opts.kv_int8), device=self.device,
                                   kv_heads=qwen2.local_kv_heads(cfg.decoder_config,
                                                                 self.tp_group)),
            dec_state=tok.init_decoder_state(cfg.acoustic_tokenizer_config, b, dtype, self.device),
            sem_state=tok.init_encoder_state(cfg.semantic_tokenizer_config, b, dtype, self.device),
            h_pos=torch.zeros(b, hidden, dtype=dtype, device=self.device),
            h_neg=torch.zeros(b, hidden, dtype=dtype, device=self.device),
            finished=torch.ones(b, dtype=torch.bool, device=self.device),  # every slot idle
            n_diff=torch.zeros(b, dtype=torch.int64, device=self.device),
        )
        # the prefill worker's stream (module docstring); under TP the
        # prefill runs in the decode loop, on its stream
        self._prefill_stream = (torch.cuda.Stream(self.device, priority=-1)
                                if self.device.type == "cuda" and mesh is None else None)
        # the frame noise of one window, redrawn in place before each
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(0)
        self._noise = inf._empty_noise(cfg, opts, b, frames_per_dispatch, False, self.device)

        self.slots: List[Optional[RequestHandle]] = [None] * b
        self.slot_steps = np.zeros(b, np.int64)
        self.slot_max_steps = np.zeros(b, np.int64)
        # handles freed from their slot at dispatch (predicted cap or cancel
        # finish) whose last window is still in flight: _drain fails these
        # too on a device fault, or their consumers hang
        self._retiring: List[RequestHandle] = []
        # priority requests drain before bulk ones (FIFO within each class);
        # entries are (0|1, seq, handle): handles are not orderable
        self._submit_seq = itertools.count()
        self.pending: "queue.PriorityQueue" = queue.PriorityQueue()
        # prefilled requests not yet joined; bounded, so the prefill worker
        # cannot pile batch-2 x max_len caches up on the card
        self.ready: "queue.Queue" = queue.Queue(maxsize=2)
        # decode-thread staging of prefilled entries: _admit drains `ready`
        # into it every call, so a request cancelled while no slot is free
        # finishes promptly and frees its `ready` place
        self._ready_local: List = []
        # stats(): a bounded registry of per-request scalar records (never
        # the handles, which hold request audio); submit() appends from
        # handler threads while stats() reads
        self._recs: "collections.deque" = collections.deque(maxlen=4096)
        self._recs_lock = threading.Lock()
        self._frames_emitted = 0
        self._start_time = time.monotonic()
        self._hop = cfg.acoustic_tokenizer_config.hop_length
        self._stop = threading.Event()
        self._draining = threading.Event()
        # notified after every visible state transition (submit, prefill
        # staged, slot joined or freed, audio pushed, drain): tests and
        # monitors wait on it (wait_for_state) instead of polling
        self.state_cv = threading.Condition()
        # a graceful drain is idle when Queue.unfinished_tasks is 0: the
        # workers call task_done() only once an item is settled (finished,
        # staged or in a slot), so an item in a worker's hands keeps it busy
        # each window's tokens (K, max_batch), kept under TP to compare ranks
        self.token_log: "collections.deque" = collections.deque(maxlen=4096)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._prefill_thread = threading.Thread(
            target=self._prefill_loop if mesh is None else lambda: None, daemon=True)
        self._thread.start()
        self._prefill_thread.start()

    def _shard(self, cfg: VibeVoiceConfig, params, mesh):
        """This rank's tree under TP, with the group and the control group."""
        from ..parallel import mesh as pmesh

        if any("w8" in lp["attn"].get("q", {}) or "qkv" in lp["attn"]
               for lp in params["lm"]["layers"]):
            raise ValueError(
                "TP serving shards dense ('w') params; int8-quantized params are the "
                "single-device memory configuration (int8 LM + int8 KV) - use one or the other")
        if pmesh.axis_size(mesh, "dp") > 1 or "tp" not in mesh.mesh_dim_names:
            raise ValueError(f"TP serving takes a mesh of one 'tp' dimension (dp 1); got "
                             f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}")
        params = pmesh.shard_params(
            params, pmesh.model_param_shardings(params, mesh, cfg.decoder_config.head_dim), mesh)
        self.tp_group = mesh.get_group("tp")
        ranks = dist.get_process_group_ranks(self.tp_group)
        self._leader_rank = ranks[0]
        self.leader = dist.get_rank() == ranks[0]
        # the decisions travel on the host: a gloo group beside the tp group
        self._ctl = dist.new_group(ranks, backend="gloo")
        return params

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def _notify_state(self) -> None:
        with self.state_cv:
            self.state_cv.notify_all()

    def wait_for_state(self, predicate, timeout: float = 60.0) -> bool:
        """Block until `predicate()` (evaluated under the state lock) is true,
        re-checking on every engine state transition. False on timeout."""
        with self.state_cv:
            return self.state_cv.wait_for(predicate, timeout)

    def submit(self, request: Request) -> RequestHandle:
        if not self.leader:
            raise RuntimeError("this rank follows rank 0 of the tensor-parallel group, which owns "
                               "the queue: submit there")
        handle = RequestHandle(request)
        with self._recs_lock:
            self._recs.append(handle.rec)
        if self._stop.is_set() or self._draining.is_set():
            # nothing would consume the request: fail it now
            handle._finish(RuntimeError(
                "engine is draining" if self._draining.is_set() else "engine is stopped"))
            return handle
        self.pending.put((0 if request.priority else 1, next(self._submit_seq), handle))
        self._notify_state()
        if self._stop.is_set():
            # raced a shutdown or a worker's crash drain, which may have swept
            # `pending` before this put: fail what is still queued and this
            # handle (a second _finish only adds an unread end marker)
            while True:
                try:
                    h = self.pending.get_nowait()[2]
                    if not h._done.is_set():
                        h._finish(RuntimeError("engine is stopped"))
                    self.pending.task_done()
                except queue.Empty:
                    break
            if not handle._done.is_set():
                handle._finish(RuntimeError("engine is stopped"))
        return handle

    def warmup(self, prompt_tokens: int = 64, voice_samples: int = 0,
               timeout: float = 600.0) -> float:
        """Run one synthetic request (about one window of frames) through
        prefill, join and decode before traffic: it builds the kernels, lets
        cuDNN choose its algorithms and captures the step's CUDA graph while
        no prefill runs beside it, so the first real request streams at
        steady-state latency. ``voice_samples`` > 0 adds a voice prompt of
        that many samples. Its audio is dropped and its record left out of
        stats() (its frames count in frames_emitted). Returns wall seconds."""
        t0 = time.monotonic()
        n = max(2, min(prompt_tokens, self.max_len // 2))
        ids = np.zeros((1, n), np.int64)
        ids[0, -1] = self.tokens.speech_start
        kw = {}
        if voice_samples > 0:
            frames = -(-voice_samples // self._hop)
            kw = dict(speech_tensors=np.zeros((1, voice_samples), np.float32),
                      speech_frame_valid=np.zeros((1, frames), bool),
                      speech_input_mask=np.zeros((1, n), bool))
        h = self.submit(Request(input_ids=ids, valid_mask=np.ones((1, n), bool),
                                max_length_times=max(self.frames_per_dispatch, 1) / n, **kw))
        try:
            h.result(timeout=timeout)
        except BaseException:
            h.cancel()  # free its slot rather than hold it
            raise
        finally:
            with self._recs_lock:
                try:
                    self._recs.remove(h.rec)
                except ValueError:
                    pass
        return time.monotonic() - t0

    def stats(self) -> EngineStats:
        """Observability snapshot; cheap, safe from any thread."""
        with self._recs_lock:
            recs = list(self._recs)
        submitted = len(recs)
        outcome = lambda o: sum(r["outcome"] == o for r in recs)
        completed, failed = outcome("completed"), outcome("failed")
        cancelled, expired = outcome("cancelled"), outcome("deadline_expired")
        # retiring handles (slot freed at dispatch, last window still
        # delivering) are active; the list is only changed on the decode thread
        active = sum(h is not None for h in self.slots) + len(list(self._retiring))
        queued = submitted - completed - failed - cancelled - expired - active
        ttfa = sorted([r["ttfa_ms"] for r in recs if r["ttfa_ms"] is not None][-256:])
        pct = lambda q: ttfa[min(len(ttfa) - 1, int(q * len(ttfa)))] if ttfa else None
        pri = sorted(r["ttfa_ms"] for r in recs
                     if r.get("priority") and r["ttfa_ms"] is not None)[-256:]
        return EngineStats(
            submitted=submitted, completed=completed, failed=failed, cancelled=cancelled,
            deadline_expired=expired, active=active, queued=max(queued, 0),
            frames_emitted=self._frames_emitted,
            audio_seconds_emitted=self._frames_emitted * self._hop / 24_000.0,
            ttfa_p50_ms=pct(0.50), ttfa_p95_ms=pct(0.95),
            uptime_s=time.monotonic() - self._start_time,
            priority_ttfa_p50_ms=pri[len(pri) // 2] if pri else None,
            priority_submitted=sum(bool(r.get("priority")) for r in recs),
        )

    def _idle(self) -> bool:
        return (self.pending.unfinished_tasks == 0 and self.ready.unfinished_tasks == 0
                and not self._ready_local and all(h is None for h in self.slots))

    def shutdown(self, timeout: float = 30.0, drain: bool = False):
        """Stop the engine. With ``drain=True`` (a graceful rollout), first
        refuse new submissions ("engine is draining") and let accepted
        requests run to their end, up to `timeout` seconds; what is still
        unfinished then is failed by the normal drain. Under TP a following
        rank waits (without a bound) for rank 0's shutdown."""
        if not self.leader:
            self._thread.join()
            return
        if drain and not self._stop.is_set():
            self._draining.set()
            deadline = time.monotonic() + timeout
            # the state lock's notifications wake this at most 50 ms late for
            # transitions that notify nothing (a queue's task_done)
            while time.monotonic() < deadline and not self.wait_for_state(
                    self._idle, max(0.0, min(0.05, deadline - time.monotonic()))):
                pass
        self._stop.set()
        self._thread.join(timeout)
        self._prefill_thread.join(timeout)

    # ------------------------------------------------------------------
    # prefill worker (never blocks the decode loop)
    # ------------------------------------------------------------------

    def _prefill_loop(self):
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            self._prefill_loop_inner()
        except BaseException as e:
            # a worker-level fault (a request's own error is finished in
            # _prefill_one): stop the engine, whose decode thread drains the
            # slots and `ready` on its way out, and fail the queue that only
            # this thread consumes
            self._stop.set()
            while True:
                try:
                    self.pending.get_nowait()[2]._finish(e)
                    self.pending.task_done()
                except queue.Empty:
                    break
            raise

    def _prefill_loop_inner(self):
        while not self._stop.is_set():
            try:
                handle = self.pending.get(timeout=0.02)[2]
            except queue.Empty:
                continue
            # task_done only once the request is settled (finished, or put on
            # `ready`, which counted it first): a graceful drain never sees
            # a gap while it is in this worker's hands
            try:
                try:
                    self._prefill_one(handle)
                except BaseException as e:
                    handle._finish(e)  # in no queue any more: nothing else would
                    raise
            finally:
                self.pending.task_done()

    def _prefill_one(self, handle: RequestHandle):
        """One request's prefill."""
        if handle.cancelled.is_set():
            handle._finish()
            return
        if handle._deadline_exceeded():
            handle.deadline_expired = True
            handle._finish()
            return
        try:
            single, max_steps = self._prefill(handle.request)
        except BaseException as e:  # a bad request fails its own handle
            handle._finish(e)
            return
        if handle.cancelled.is_set():
            handle._finish()
            return
        placed = False
        while not self._stop.is_set():
            try:
                self.ready.put((handle, single, max_steps), timeout=0.1)
                placed = True
                self._notify_state()
                break
            except queue.Full:
                continue
        if not placed:
            handle._finish(RuntimeError("engine is stopped"))
        elif self._stop.is_set():
            # placed, but the decode thread may have run its final drain:
            # sweep what is still queued
            while True:
                try:
                    self.ready.get_nowait()[0]._finish(RuntimeError("engine is stopped"))
                    self.ready.task_done()
                except queue.Empty:
                    break

    def _prefill(self, r: Request):
        """(batch-1 carry, frame cap) of one request, on the prefill thread
        (under TP, on the decode thread of every rank)."""
        generator = torch.Generator(device=self.device)
        generator.manual_seed(r.seed)
        stream = self._prefill_stream
        with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
            single = inf.prefill_request(
                self.cfg, self.params, np.asarray(r.input_ids), np.asarray(r.valid_mask),
                r.speech_tensors, r.speech_frame_valid, r.speech_input_mask, self.max_len,
                self.tokens, self.opts, generator, tp_group=self.tp_group)
        if stream is not None:
            # the carry is complete before it is handed over: a join reads it
            # on the decode stream without waiting for this one
            stream.synchronize()
        return single, self._frame_cap(r)

    def _frame_cap(self, r: Request) -> int:
        n = int(np.asarray(r.valid_mask).sum())
        return min(self.max_len - n, int(r.max_length_times * n))

    # ------------------------------------------------------------------
    # decode worker
    # ------------------------------------------------------------------

    def _admit(self):
        """Join finished prefills into free slots, between windows."""
        # Drain `ready`, but bound the staging: each entry holds a batch-2 x
        # max_len cache on the card. Cancelled or expired entries are always
        # swept; live ones stage up to max_batch, so the prefilled carries
        # number at most max_batch + ready.maxsize + 1.
        while True:
            if len(self._ready_local) >= self.max_batch:
                requeue = []
                try:
                    while True:
                        item = self.ready.get_nowait()
                        h = item[0]
                        if h._deadline_exceeded() and not h.cancelled.is_set():
                            h.deadline_expired = True
                            h.cancel()
                        if h.cancelled.is_set():
                            h._finish()
                            self.ready.task_done()
                        elif h.request.priority and sum(
                                1 for it in self._ready_local if it[0].request.priority
                        ) < max(1, self.reserved_slots):
                            # a priority entry reaches the express slot even
                            # when staging is full of bulk carries, up to the
                            # express-slot count
                            self._ready_local.append(item)
                            self.ready.task_done()
                        else:
                            requeue.append(item)
                except queue.Empty:
                    pass
                for item in requeue:
                    try:
                        self.ready.put_nowait(item)  # before task_done: never idle meanwhile
                    except queue.Full:  # the prefill thread refilled it
                        self._ready_local.append(item)
                    self.ready.task_done()
                break
            try:
                self._ready_local.append(self.ready.get_nowait())
                self.ready.task_done()
            except queue.Empty:
                break
        keep: List = []
        free = [i for i, h in enumerate(self.slots) if h is None]
        # priority entries place first; bulk never takes an express slot
        staged = sorted(self._ready_local, key=lambda it: not it[0].request.priority)
        for handle, single, max_steps in staged:
            if handle._deadline_exceeded() and not handle.cancelled.is_set():
                handle.deadline_expired = True
                handle.cancel()
            if handle.cancelled.is_set():
                handle._finish()
                continue
            slot = self._place(free, handle.request.priority)
            if slot is None:
                keep.append((handle, single, max_steps))
                continue
            free.remove(slot)
            join_slot(self.carry, single, slot, self.max_batch)
            if self._prefill_stream is not None:  # allocated on the prefill stream
                stream = torch.cuda.current_stream(self.device)
                inf._tree_map(lambda t: t.record_stream(stream), single)
            self.slot_steps[slot] = 0
            self.slot_max_steps[slot] = max_steps
            self.slots[slot] = handle
        self._ready_local = keep
        self._notify_state()

    def _place(self, free: List[int], priority: bool) -> Optional[int]:
        """The free slot a request takes, or None: a priority request an
        express slot first, else any; a bulk request never an express slot."""
        if priority:
            return next((i for i in free if i < self.reserved_slots), free[0] if free else None)
        return next((i for i in free if i >= self.reserved_slots), None)

    def _draw_noise(self) -> inf.FrameNoise:
        """The next window's frame noise (K frames x max_batch rows), drawn
        on the card from the engine's generator, frame by frame."""
        return inf._fill_noise(self._noise, self._generator)

    def _loop(self):
        try:
            if self.device.type == "cuda":  # a new thread starts on device 0
                torch.cuda.set_device(self.device)
            if self.leader:
                self._loop_inner()
            else:
                self._follow()
        except BaseException as e:  # a dead decode loop must not strand callers
            self._stop.set()
            self._drain(e)
            raise

    def _drain(self, error=None):
        """Fail or finish every slot and queued request. Active slots are cut
        off, so they get an error too (a caller can tell a partial waveform
        from a whole one)."""
        leftover = error or RuntimeError("engine shut down")
        for i, h in enumerate(self.slots):
            if h is not None:
                h._finish(leftover)
                self.slots[i] = None
        for h in self._retiring:
            if not h._done.is_set():
                h._finish(leftover)
        self._retiring = []
        for item in self._ready_local:
            item[0]._finish(leftover)
        self._ready_local = []
        for q_, at in ((self.ready, 0), (self.pending, 2)):
            while True:
                try:
                    q_.get_nowait()[at]._finish(leftover)
                    q_.task_done()
                except queue.Empty:
                    break
        self._notify_state()

    def _dispatch(self, ext: np.ndarray):
        """Enqueue one window over the engine's carry and the copy of its
        outputs to pinned host memory; returns the copy's wait."""
        noise = self._draw_noise()
        ext_t = inf._to_device(ext, self.device)
        step = self.step_fn.eager if self.eager_windows else self.step_fn
        if self.frames_per_dispatch == 1:  # make_step_fn's form: no K axis
            self.carry, out = step(self.params, self.carry, inf._frame_of(noise, 0), ext_t[0])
            out = inf._tree_map(lambda t: t[None], out)
        else:
            self.carry, out = step(self.params, self.carry, noise, ext_t)
        return inf._fetch(out)

    def _process(self, fetched, snap):
        """Deliver one window by its dispatch-time snapshot of the slots: the
        window's row i belongs to snap[i] even if that slot was freed and
        joined again since. Frames after a finish are masked on the card."""
        toks, amask, audio, fin = fetched()
        if self.mesh is not None:
            self.token_log.append(toks)
        for f in range(amask.shape[0]):
            for i, h in enumerate(snap):
                if h is None:
                    continue
                if not h._done.is_set():
                    h.tokens.append(int(toks[f, i]))
                if amask[f, i]:
                    h._push(audio[f, i, :, 0])
                    self._frames_emitted += 1
                if fin[f, i] and not h._done.is_set():
                    h._finish()
                if fin[f, i] and self.slots[i] is h:
                    self.slots[i] = None
        if self._retiring:
            self._retiring = [h for h in self._retiring if not h._done.is_set()]
        self._notify_state()

    def _loop_inner(self):
        # One window in flight: window N + 1 is enqueued before N's outputs
        # are read. Steps advance at dispatch. Cap and cancel finishes are
        # known to the host (the ext row forces them), so those slots are
        # freed at dispatch and can take a request in the very next window;
        # EOS finishes are found when the window is read, one window late.
        # Under TP (rank 0), _take_joins stands in for _admit, and each
        # boundary's decision goes to every rank before the joins' prefills
        # and the window (_follow runs it there); an idle rank 0 still sends
        # one every HEARTBEAT_S.
        inflight = None
        k = self.frames_per_dispatch
        last = time.monotonic()
        while True:
            stop = self._stop.is_set()
            joins = []
            if self.mesh is None:
                if stop:
                    break
                self._admit()
            elif not stop:
                joins = self._take_joins()
            active = [i for i, h in enumerate(self.slots) if h is not None]
            ext = None
            if active and not stop:
                for h in self.slots:  # deadlines finish through the cancel path
                    if h is not None and not h.cancelled.is_set() and h._deadline_exceeded():
                        h.deadline_expired = True
                        h.cancel()
                cancelled = np.array([h is not None and h.cancelled.is_set() for h in self.slots])
                ext = ((self.slot_steps[None, :] + np.arange(k)[:, None] >= self.slot_max_steps)
                       | cancelled[None, :])
            if self.mesh is not None and (stop or joins or ext is not None
                                          or time.monotonic() - last >= self.HEARTBEAT_S):
                last = time.monotonic()
                self._decide((stop, joins, ext))
                if stop:
                    break
                for slot, e in self._join_all(joins):
                    self.slots[slot]._finish(e)
                    self.slots[slot] = None
                self._notify_state()
            if ext is None:
                if inflight is not None:
                    self._process(*inflight)
                    inflight = None
                    continue
                time.sleep(self.idle_sleep)
                continue
            fetched = self._dispatch(ext)
            snap = list(self.slots)
            for i in active:
                self.slot_steps[i] += k
                # Predicted finish: the ext row forced this slot's last frame
                # inside the window just dispatched (frame f was forced iff
                # steps_before + f >= cap, so the window holds one iff
                # steps_after - 1 >= cap); `cancelled[i]` is what ext was
                # built from (a cancel() landing now waits a window).
                h = self.slots[i]
                if h is not None and (cancelled[i]
                                      or self.slot_steps[i] - 1 >= self.slot_max_steps[i]):
                    self._retiring.append(h)
                    self.slots[i] = None
            if self.pipeline:
                prev, inflight = inflight, (fetched, snap)
                if prev is not None:
                    self._process(*prev)
            else:
                self._process(fetched, snap)
        if inflight is not None:  # deliver the last window before draining
            self._process(*inflight)
        self._drain()

    # ------------------------------------------------------------------
    # tensor parallelism: rank 0 decides, every rank runs (module docstring)
    # ------------------------------------------------------------------

    HEARTBEAT_S = 1.0  # an idle rank 0 still broadcasts this often (gloo timeouts)

    def _decide(self, decision):
        """Rank 0's decision for this window boundary, on every rank."""
        box = [decision]
        dist.broadcast_object_list(box, src=self._leader_rank, group=self._ctl)
        return box[0]

    def _join_all(self, joins) -> List[tuple]:
        """Prefill and join (slot, request) entries, in order, on every rank;
        returns (slot, error) for those whose prefill raised."""
        failed = []
        for slot, request in joins:
            try:
                single, _ = self._prefill(request)
            except Exception as e:  # the same request fails alike on every rank
                failed.append((slot, e))
                continue
            join_slot(self.carry, single, slot, self.max_batch)
        return failed

    def _take_joins(self) -> List[tuple]:
        """Rank 0, in place of _admit: pending requests placed into free
        slots (_place), as (slot, request) to broadcast and join; cancelled
        or expired ones finish here. Each item is settled (in its slot,
        finished, or back in the queue) before its task_done, so a graceful
        drain never finds the engine idle while it holds one."""
        joins, keep = [], []
        free = [i for i, h in enumerate(self.slots) if h is None]
        while free:
            try:
                item = self.pending.get_nowait()
            except queue.Empty:
                break
            h = item[2]
            if h._deadline_exceeded() and not h.cancelled.is_set():
                h.deadline_expired = True
                h.cancel()
            if h.cancelled.is_set():
                h._finish()
            else:
                slot = self._place(free, h.request.priority)
                if slot is None:  # a bulk request waiting for a bulk slot
                    keep.append(item)
                    continue
                free.remove(slot)
                self.slot_steps[slot] = 0
                self.slot_max_steps[slot] = self._frame_cap(h.request)
                self.slots[slot] = h
                joins.append((slot, h.request))
            self.pending.task_done()
        for item in keep:
            self.pending.put(item)
            self.pending.task_done()
        return joins

    def _follow(self):
        """Another rank's decode loop: run what rank 0 decides."""
        while True:
            stop, joins, ext = self._decide(None)
            if stop:
                break
            self._join_all(joins)
            if ext is not None:
                self.token_log.append(self._dispatch(ext)()[0])
