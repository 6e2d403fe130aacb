"""Multi-session real-time streaming engine for the 0.5B model (port of
vibevoice_tpu/serving/streaming_sessions.py).

The reference streams at batch 1. This engine batches N independent
sessions into one set of window functions (``models.streaming.StreamFns``,
CUDA graphs replayed on the card): the windowed loop (5 text tokens, 6
speech frames) is state over per-row lengths, so concurrent sessions are
rows of one batch:

* each slot carries its own voice preset (spliced in by
  ``streaming.admit_session``, in place on the caches), its own script
  position and its own EOS and capacity bookkeeping;
* rows without text this window feed all-invalid text windows (no-ops);
* free, parked and finished rows still compute but commit nothing (the
  session window's ``active`` gate), and the host drops their outputs;
* sessions join between quanta: admission is one in-place splice.

Corrected against the JAX engine: a live session that resumes after a park
has its ``finished`` flag cleared on the card (``streaming.clear_finished``),
so its frames commit again; ``steps`` counts the frames a row committed
(through its EOS frame on an EOS quantum), not the whole quantum; and
``frames(timeout)`` bounds only the wait of a speaking session, so a
parked live session waits for its text as long as it takes.

The engine owns its window functions (a ``StreamFns`` of its own), so its
static state is its alone; the quantum's outputs are read back with one
synchronisation.
"""

from __future__ import annotations

import collections
import itertools
import queue
import threading
import time
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from ..models import inference as inf
from ..models import streaming as st

HOP_FRAMES = st.TTS_SPEECH_WINDOW_SIZE  # 6 speech frames a window
TEXT_W = st.TTS_TEXT_WINDOW_SIZE  # 5 text tokens a window


class StreamSessionHandle:
    """One session: frames arrive on a queue as the engine's loop produces
    them; `frames()` iterates them, `result()` concatenates."""

    def __init__(self, text_ids: np.ndarray, admit_kwargs: Dict, *, noise_bank=None,
                 max_new_frames: Optional[int] = None, live: bool = False):
        self.text_ids = np.asarray(text_ids, np.int64).reshape(-1)
        self.admit_kwargs = admit_kwargs
        self.noise_bank = noise_bank
        self.max_new_frames = max_new_frames
        # live session (LLM -> TTS): the text stream stays open, append_text()
        # adds tokens while audio streams out. At a model EOS with the stream
        # still open the slot PARKS (keeps its caches, stops stepping) and
        # resumes on the next append; end_text() closes the stream, so the
        # next EOS (or one already parked on) ends the session.
        self.live = live
        self.text_open = live
        self.parked = threading.Event()  # EOS hit, awaiting text
        self._text_lock = threading.Lock()
        self._engine = None  # set by submit: append wakes the loop
        self.q: "queue.Queue" = queue.Queue()
        self.done = threading.Event()
        self.cancelled = threading.Event()
        self.error: Optional[BaseException] = None
        self.reach_max_step = False
        self.submitted_t = time.monotonic()
        self.first_audio_t: Optional[float] = None
        self.n_frames = 0
        self.priority = False
        # the scalar record the engine keeps after the handle is gone
        self.rec = {"ttfa_ms": None, "frames": 0, "outcome": None}

    # -- consumer side ------------------------------------------------------

    def frames(self, timeout: Optional[float] = None) -> Iterator[np.ndarray]:
        """Yield float32 hop-sized audio frames until the session ends.
        `timeout` bounds the wait for a frame while the session speaks; a
        live session parked awaiting text waits for it without a bound."""
        while True:
            try:
                item = self.q.get(timeout=timeout)
            except queue.Empty:
                if self.done.is_set() and self.q.empty():
                    break
                if self.parked.is_set():
                    continue
                raise TimeoutError("no frame within timeout")
            if item is None:
                break
            yield item
        if self.error is not None:
            raise self.error

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        chunks = list(self.frames(timeout=timeout))
        return np.concatenate(chunks) if chunks else np.zeros(0, np.float32)

    def cancel(self) -> None:
        self.cancelled.set()

    def _wake(self) -> None:
        eng = self._engine
        if eng is not None:  # wake a loop idling on parked slots
            with eng._cv:
                eng._cv.notify_all()

    def append_text(self, ids: np.ndarray) -> None:
        """Live sessions only: append tokens to the open text stream, fed at
        the slot's next 5-token text window; a parked session resumes.
        Raises on a session that is not live, closed or ended."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        with self._text_lock:
            if not self.live:
                raise RuntimeError("append_text on a non-live session (submit with live=True)")
            if not self.text_open:
                raise RuntimeError("append_text after end_text")
            if self.done.is_set():
                raise RuntimeError("session has already ended")
            self.text_ids = np.concatenate([self.text_ids, ids])
        self._wake()

    def end_text(self) -> None:
        """Close a live session's text stream: it ends at its next model EOS
        (at once if it is parked)."""
        with self._text_lock:
            self.text_open = False
        self._wake()

    @property
    def ttfa_ms(self) -> Optional[float]:
        if self.first_audio_t is None:
            return None
        return (self.first_audio_t - self.submitted_t) * 1000.0

    # -- engine side --------------------------------------------------------

    def _push(self, frame: np.ndarray) -> None:
        if self.first_audio_t is None:
            self.first_audio_t = time.monotonic()
            self.rec["ttfa_ms"] = self.ttfa_ms
        self.n_frames += 1
        self.rec["frames"] = self.n_frames
        self.q.put(frame)

    def _finish(self, error: Optional[BaseException] = None) -> None:
        self.error = error
        self.rec["outcome"] = ("failed" if error is not None
                               else "cancelled" if self.cancelled.is_set() else "completed")
        self.done.set()
        self.q.put(None)


@dataclass
class _Slot:
    handle: StreamSessionHandle
    text_pos: int = 0
    steps: int = 0  # cache positions committed past the preset
    max_steps: int = 0
    frame_counter: int = 0  # noise-bank rows consumed (inject mode)
    cycle_pos: int = 0  # frames into the current 6-frame speech window
    parked: bool = False  # live session: EOS hit with the text stream open


class StreamingSessionEngine:
    """Batch N concurrent 0.5B streaming sessions onto one set of windows.

    Args:
      cfg/params: the streaming model (on the card unless built on the CPU).
      n_slots: the batch of the windows; sessions beyond it queue and join
        as slots free.
      max_len: per-slot cache slots; the window cadence stops a session
        before its caches would be written past them, as
        streaming.generate does.
      opts: GenerateOptions (cfg_scale, ddpm_steps, sde); kv_int8 None
        resolves against max_len (int8 halves the caches' bytes).
      default_preset: the voice when submit() gets none.
      inject: test mode: every submit carries a noise_bank ({"init": (E, 1,
        D)[, "sde": (E, S, 1, D)]}, as streaming.generate takes it) whose
        rows each slot consumes in order, so a batched session is
        comparable to its batch-1 run. Otherwise each quantum's noise is
        drawn on the card from one generator seeded with `seed`.
      ignore_eos: benches on random weights: a row's EOS neither parks nor
        ends its session; its frames after the EOS frame in that quantum
        are dropped and the row goes on from the EOS frame.
      quantum: frames a dispatch (a divisor of 6); each slot keeps the
        5-text/6-speech cadence of its own, so the quantum changes when a
        joiner can start, not what a row computes.
      reserved_slots: express slots only priority sessions take.
    """

    _PRESET_CACHE_MAX = 32

    def __init__(self, cfg, params, *, n_slots: int = 4, max_len: int = 2048,
                 opts: Optional[inf.GenerateOptions] = None, default_preset=None, processor=None,
                 inject: bool = False, seed: int = 0, preset_bucket: int = 128,
                 idle_poll_s: float = 0.05, ignore_eos: bool = False, quantum: int = 3,
                 reserved_slots: int = 0):
        if HOP_FRAMES % quantum != 0:
            raise ValueError(f"quantum must divide {HOP_FRAMES}, got {quantum}")
        if not (0 <= reserved_slots < n_slots):
            raise ValueError(f"reserved_slots must be in [0, n_slots); got {reserved_slots}")
        self.cfg = cfg
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        self.opts = opts = inf.resolve_kv_int8(
            opts or inf.GenerateOptions(cfg_scale=1.5, ddpm_steps=5), max_len)
        self.inject = inject
        self.processor = processor
        self.default_preset = default_preset
        self.preset_bucket = preset_bucket
        self._idle_poll_s = idle_poll_s
        self.quantum = quantum
        self.reserved_slots = reserved_slots
        self.ignore_eos = ignore_eos

        self.fns = st.StreamFns(cfg, inf._trace_opts(opts))  # this engine's own captures
        self._text_fn, self._speech_fn = self.fns.text, self.fns.session(quantum)
        self._state = st.init_session_state(cfg, params, n_slots, max_len,
                                            kv_int8=bool(opts.kv_int8))
        self.device = self._state.tts_h.device
        self._head_dim = cfg.decoder_config.head_dim
        d = cfg.acoustic_vae_dim
        f32 = dict(dtype=torch.float32, device=self.device)
        steps = self.fns.coeffs.num_steps
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)
        self._noise = inf.FrameNoise(torch.empty(quantum, n_slots, d, **f32),
                                     torch.empty(quantum, steps, n_slots, d, **f32)
                                     if opts.sde else None, None)
        # device-resident admit arrays per voice (sessions reuse a handful
        # of voices); strong preset refs keep id() stable; FIFO-evicted
        self._preset_cache: Dict[int, tuple] = {}

        self.slots: List[Optional[_Slot]] = [None] * n_slots
        # (0|1, seq, handle): priority sessions admit first, FIFO in a class
        self._submit_seq = itertools.count()
        self.pending: "queue.PriorityQueue" = queue.PriorityQueue()
        self._cv = threading.Condition()
        self._running = True
        self._draining = False
        self.windows_run = 0
        self.last_window_s: Optional[float] = None
        self.window_times: List[float] = []  # recent quantum wall times
        self._recs: "collections.deque" = collections.deque(maxlen=2048)
        self._recs_lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------
    # Submission
    # ------------------------------------------------------------------

    def submit(self, text_ids: np.ndarray, preset=None, *, noise_bank=None,
               max_new_frames: Optional[int] = None, priority: bool = False,
               live: bool = False) -> StreamSessionHandle:
        if self._draining or not self._running:
            raise RuntimeError("engine is draining")
        preset = preset or self.default_preset
        if preset is None:
            raise ValueError("no preset given and no default_preset configured")
        if self.inject and noise_bank is None:
            raise ValueError("inject engine: every submit needs a noise_bank")
        admit_kwargs, tts_len = self._device_preset(preset)
        h = StreamSessionHandle(text_ids, admit_kwargs, noise_bank=noise_bank,
                                max_new_frames=max_new_frames, live=live)
        h._engine = self
        h.priority = priority
        with self._recs_lock:
            self._recs.append(h.rec)
        h._max_steps = self.max_len - tts_len  # as streaming.generate's capacity
        self.pending.put((0 if priority else 1, next(self._submit_seq), h))
        with self._cv:
            self._cv.notify_all()
        return h

    def _device_preset(self, preset):
        """(admit kwargs with the float arrays on the engine's device, the
        preset's TTS length), cached per preset object."""
        ent = self._preset_cache.get(id(preset))
        if ent is not None:
            return ent[1], ent[2]
        host = st.preset_admit_arrays(preset, self._head_dim, self.preset_bucket,
                                      max_len=self.max_len)
        dev = {k: (torch.tensor(v, device=self.device) if np.asarray(v).dtype == np.float32
                   else v) for k, v in host.items()}
        tts_len = int(host["tts_len"])
        if len(self._preset_cache) >= self._PRESET_CACHE_MAX:
            self._preset_cache.pop(next(iter(self._preset_cache)))
        self._preset_cache[id(preset)] = (preset, dev, tts_len)
        return dev, tts_len

    def warmup(self, frames: int = 6, timeout: float = 600.0) -> float:
        """One short session of the default preset before traffic: it builds
        the kernels and captures the text and session windows, so the first
        listener's first audio is steady state. Its record is left out of
        stats(). Returns wall seconds."""
        t0 = time.monotonic()
        bank = None
        if self.inject:  # zero draws
            rows, d = frames + self.quantum, self.cfg.acoustic_vae_dim
            bank = {"init": np.zeros((rows, 1, d), np.float32)}
            if self.opts.sde:
                bank["sde"] = np.zeros((rows, self.fns.coeffs.num_steps, 1, d), np.float32)
        h = self.submit(np.full(TEXT_W, 10, np.int64), noise_bank=bank, max_new_frames=frames)
        try:
            h.result(timeout=timeout)
        finally:
            with self._recs_lock:
                try:
                    self._recs.remove(h.rec)
                except ValueError:
                    pass
        return time.monotonic() - t0

    def submit_text(self, text: str, preset=None, **kw) -> StreamSessionHandle:
        if self.processor is None:
            raise RuntimeError("engine built without a processor")
        preset = preset or self.default_preset
        out = self.processor.process_input_with_cached_prompt(text, preset)
        return self.submit(out.tts_text_ids, preset, **kw)

    # ------------------------------------------------------------------
    # Loop
    # ------------------------------------------------------------------

    def _admit_pending(self) -> None:
        free = [b for b in range(self.n_slots) if self.slots[b] is None]
        while free:
            try:
                cls, seq, h = self.pending.get_nowait()
            except queue.Empty:
                return
            if h.cancelled.is_set():
                h._finish()
                continue
            if cls == 0:  # priority: an express slot if one is free, else any
                b = next((x for x in free if x < self.reserved_slots), free[0])
            else:
                # bulk never takes an express slot; a bulk head of the queue
                # means no priority session waits behind it
                b = next((x for x in free if x >= self.reserved_slots), None)
                if b is None:
                    self.pending.put((cls, seq, h))
                    return
            free.remove(b)
            try:
                self._state = st.admit_session(self._state, b, **h.admit_kwargs)
            except BaseException as e:  # a bad preset fails its own session only
                h._finish(e)
                free.append(b)
                continue
            self.slots[b] = _Slot(handle=h, max_steps=h._max_steps)

    def _retire(self, b: int, *, reach_max_step: bool = False) -> None:
        slot = self.slots[b]
        self.slots[b] = None
        if slot is not None:
            slot.handle.reach_max_step = reach_max_step
            slot.handle._finish()
        with self._cv:
            self._cv.notify_all()

    def _idle_wait(self) -> None:
        with self._cv:
            if self.pending.empty():
                self._cv.wait(timeout=self._idle_poll_s)

    def _loop(self) -> None:
        try:
            while self._running:
                self._admit_pending()
                occupied = [b for b in range(self.n_slots) if self.slots[b] is not None]
                if not occupied:
                    self._idle_wait()
                    if self._draining and self.pending.empty():
                        break
                    continue
                if not self._quantum(occupied):
                    self._idle_wait()  # parked sessions: append/end_text notify
            # drain epilogue: what is queued is refused, and a session still
            # resident (a parked live one) is failed rather than left waiting
            self._fail_all(RuntimeError("engine shut down while the session was live"),
                           RuntimeError("engine shut down before the session started"))
        except BaseException as e:  # deliver the failure to every waiter
            self._fail_all(e, e)
            if self._running:
                raise

    def _fail_all(self, resident: BaseException, queued: BaseException) -> None:
        for b in range(self.n_slots):
            if self.slots[b] is not None:
                self.slots[b].handle._finish(resident)
                self.slots[b] = None
        while True:
            try:
                self.pending.get_nowait()[2]._finish(queued)
            except queue.Empty:
                break
        with self._cv:
            self._cv.notify_all()

    def _quantum(self, occupied: List[int]) -> bool:
        """One quantum over the occupied slots; False when nothing was
        dispatched (every resident session parked, or none left)."""
        t0 = time.monotonic()
        # cancellation and frame caps every quantum; the capacity gate only
        # at a window boundary, as the solo loop checks it
        for b in occupied:
            slot = self.slots[b]
            if slot.handle.cancelled.is_set():
                self._retire(b)
            elif slot.cycle_pos == 0 and slot.steps + TEXT_W + HOP_FRAMES > slot.max_steps:
                self._retire(b, reach_max_step=True)
            elif (slot.handle.max_new_frames is not None
                  and slot.handle.n_frames >= slot.handle.max_new_frames):
                self._retire(b, reach_max_step=True)
        # live sessions: a parked slot whose text grew resumes (its finished
        # flag cleared on the card, so its frames commit again) with a fresh
        # text window below; one whose stream closed while parked retires
        for b in range(self.n_slots):
            slot = self.slots[b]
            if slot is None or not slot.parked:
                continue
            with slot.handle._text_lock:
                has_text = slot.text_pos < slot.handle.text_ids.size
                open_ = slot.handle.text_open
            if has_text:
                slot.parked = False
                slot.handle.parked.clear()
                self._state = st.clear_finished(self._state, b)
            elif not open_:
                self._retire(b)
        stepping = [b for b in range(self.n_slots)
                    if self.slots[b] is not None and not self.slots[b].parked]
        if not stepping:
            return False

        # text window: only slots starting a 5-text/6-speech window (cycle_pos
        # 0); other rows are all-invalid no-ops, so each slot keeps its solo
        # cadence whenever it joined
        ids = np.zeros((self.n_slots, TEXT_W), np.int64)
        valid = np.zeros((self.n_slots, TEXT_W), bool)
        for b in stepping:
            slot = self.slots[b]
            if slot.cycle_pos != 0:
                continue
            with slot.handle._text_lock:  # live appends grow text_ids
                rem = slot.handle.text_ids[slot.text_pos: slot.text_pos + TEXT_W]
            ids[b, : rem.size] = rem
            valid[b, : rem.size] = True
            slot.text_pos += rem.size
            slot.steps += rem.size
        if valid.any():
            self._state = self._text_fn(self.params, self._state, inf._to_device(ids, self.device),
                                        inf._to_device(valid, self.device))

        # speech quantum (parked rows stay inactive: caches hold, their
        # noise-bank cursor stays)
        active = np.zeros(self.n_slots, bool)
        active[stepping] = True
        noise = self._gather_noise(stepping) if self.inject else inf._fill_noise(
            self._noise, self._generator)
        self._state, audio, eos = self._speech_fn(self.params, self._state,
                                                  inf._to_device(active, self.device), noise)
        for b in stepping:
            slot = self.slots[b]
            slot.frame_counter += self.quantum
            slot.cycle_pos = (slot.cycle_pos + self.quantum) % HOP_FRAMES
        # a joiner arriving now is spliced in behind the quantum on the card
        self._admit_pending()
        audio_np, eos_np = audio.float().cpu().numpy(), eos.float().cpu().numpy()
        self.windows_run += 1
        self.last_window_s = time.monotonic() - t0
        self.window_times.append(self.last_window_s)
        if len(self.window_times) > 2048:
            del self.window_times[:1024]

        # route frames and EOS per slot; a row commits frames through its
        # first EOS frame (finished after it), so that is what it delivers
        # and what its steps count
        for b in stepping:
            slot = self.slots[b]
            if slot is None or slot.handle.cancelled.is_set():
                continue
            hit = np.nonzero(eos_np[:, b] > 0.5)[0]
            keep = int(hit[0]) + 1 if hit.size else self.quantum
            slot.steps += keep
            for f in range(keep):
                slot.handle._push(audio_np[f, b, :, 0])
            if not hit.size:
                continue
            h = slot.handle
            with h._text_lock:
                live_open = h.live and h.text_open
            if self.ignore_eos:
                self._state = st.clear_finished(self._state, b)
            elif live_open:
                # EOS with the text stream open: park (keep the slot and
                # caches, stop stepping) until append_text or end_text
                slot.parked = True
                slot.cycle_pos = 0
                h.parked.set()
            else:
                self._retire(b)
        return True

    def _gather_noise(self, stepping) -> inf.FrameNoise:
        """Inject mode: each stepping slot's next `quantum` noise-bank rows."""
        q, d = self.quantum, self.cfg.acoustic_vae_dim
        init = np.zeros((q, self.n_slots, d), np.float32)
        sde = (np.zeros((q, self.fns.coeffs.num_steps, self.n_slots, d), np.float32)
               if self.opts.sde else None)
        for b in stepping:
            slot = self.slots[b]
            bank, c = slot.handle.noise_bank, slot.frame_counter
            rows = np.asarray(bank["init"][c: c + q])
            if rows.shape[0] < q:
                raise ValueError(f"noise_bank['init'] exhausted at frame {c} (slot {b}); "
                                 "enlarge the bank")
            init[:, b] = rows[:, 0]
            if sde is not None:
                sde[:, :, b] = np.asarray(bank["sde"][c: c + q])[:, :, 0]
        return inf.FrameNoise(inf._to_device(init, self.device),
                              None if sde is None else inf._to_device(sde, self.device), None)

    # ------------------------------------------------------------------
    # Lifecycle / introspection
    # ------------------------------------------------------------------

    def active_sessions(self) -> int:
        return sum(s is not None for s in self.slots)

    def stats(self) -> Dict:
        """Observability snapshot (JSON-ready): session outcomes, join-TTFA
        percentiles and recent quantum wall times against the real-time
        budget of a quantum's audio."""
        with self._recs_lock:
            recs = list(self._recs)
        ttfa = sorted(r["ttfa_ms"] for r in recs if r["ttfa_ms"] is not None)[-256:]
        wt = sorted(self.window_times[-512:])
        pct = lambda xs, q: xs[min(len(xs) - 1, int(q * len(xs)))] if xs else None
        return {
            "n_slots": self.n_slots,
            "quantum_frames": self.quantum,
            "active": self.active_sessions(),
            "parked": sum(1 for s in self.slots if s is not None and s.parked),
            "queued": self.pending.qsize(),
            "submitted": len(recs),
            "completed": sum(r["outcome"] == "completed" for r in recs),
            "failed": sum(r["outcome"] == "failed" for r in recs),
            "cancelled": sum(r["outcome"] == "cancelled" for r in recs),
            "windows_run": self.windows_run,
            "window_p50_ms": round(pct(wt, 0.50) * 1e3, 1) if wt else None,
            "window_p95_ms": round(pct(wt, 0.95) * 1e3, 1) if wt else None,
            "window_budget_ms": round(self.quantum * 3200 / 24.0, 1),
            "ttfa_p50_ms": round(pct(ttfa, 0.50), 1) if ttfa else None,
            "ttfa_p95_ms": round(pct(ttfa, 0.95), 1) if ttfa else None,
            "frames_emitted": sum(r["frames"] for r in recs),
        }

    def shutdown(self, drain: bool = True, timeout: float = 120.0) -> None:
        self._draining = True
        if drain:
            # a live session's text stream is closed, so a parked slot
            # retires now and a speaking one at its next EOS
            for s in list(self.slots):
                if s is not None and s.handle.live:
                    s.handle.end_text()
            with self._cv:
                self._cv.wait_for(lambda: self.active_sessions() == 0 and self.pending.empty(),
                                  timeout)
        self._running = False
        with self._cv:
            self._cv.notify_all()
        self._thread.join(timeout=timeout)
