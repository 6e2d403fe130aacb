"""One run of one cell: the program under open-loop traffic, measured and
then checked against the plain reference.

The program is ``vibevoice_tpu_torch``'s serving engine. From it the run
takes the system under test (``ServingEngine``, its ``Request`` and
``RequestHandle``, and the set-up calls a deployment makes) and hooks on
the engine's own methods (``Recorder``): each window's noise draw and
slots, whose draws the reference replays; the latents each window's frames
decoded from, read from the engine's carry, which the reference is
teacher-forced by; each prefill, timed as a span; and, in a traced run, a
gate that pauses the engine's calls while a profile starts and stops.
Everything it measures, it computes itself.
"""

from __future__ import annotations

import contextlib
import importlib.util
import math
import sys
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import spec, stats, trace_read, traffic
from .reference import Reference

FORBIDDEN = ("jax", "jaxlib", "flax", "vibevoice_tpu")
POLL_S = 0.001
OCCUPANCY_EVERY_S = 0.005


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, taken whole, is one the port
    must not load (JAX or the JAX package)."""
    return sorted({n for n in list(sys.modules) if n.split(".")[0] in FORBIDDEN})


@dataclass
class Served:
    """One request as the client saw it."""

    req: traffic.Request
    due: float  # host monotonic time it was due
    handle: object = None
    submitted: float = 0.0
    chunk_times: List[float] = field(default_factory=list)
    done: bool = False

    @property
    def first_audio(self) -> Optional[float]:
        return self.handle.first_audio_time if self.handle is not None else None


@dataclass
class Run:
    """What a run measured, for the metric readers (``metrics/<name>.py``)."""

    m: spec.Model
    window: tuple  # (t0, t1) host monotonic; a traced run's ends where the profile starts
    give_up: float  # when the run stopped waiting for the window's requests
    served: List[Served]
    setup_s: float
    frames_per_dispatch: int
    max_batch: int
    prefills: List[tuple]  # (start, end, prompt tokens, voice frames)
    occupancy: List[int]  # EngineStats.active, sampled in the traced window
    trace: Optional[trace_read.Trace] = None
    trace_span: tuple = (0.0, 0.0)  # host monotonic span of the profile


def load_reader(root: Path, name: str) -> Callable:
    path = root / "bench_port" / "metrics" / f"{name}.py"
    s = importlib.util.spec_from_file_location(f"bench_port_metric_{name}", path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod.read


class Pause:
    """A gate that engine calls pass together and that ``hold()`` closes:
    it waits for the calls in flight and keeps new ones out until it
    ends (a profile starts and stops with nothing launching on the card)."""

    def __init__(self):
        self.cond = threading.Condition()
        self.active = 0
        self.paused = False

    @contextlib.contextmanager
    def call(self):
        with self.cond:
            self.cond.wait_for(lambda: not self.paused)
            self.active += 1
        try:
            yield
        finally:
            with self.cond:
                self.active -= 1
                self.cond.notify_all()

    @contextlib.contextmanager
    def hold(self):
        with self.cond:
            self.paused = True
            self.cond.wait_for(lambda: self.active == 0)
        try:
            yield
        finally:
            with self.cond:
                self.paused = False
                self.cond.notify_all()


class Recorder:
    """The engine's hooks: each window's slots and initial noise (the
    reference replays them); after each window, the latents that the
    window's frames decoded from (the last frames of the acoustic
    decoder's input context in the engine's carry, read before the next
    joins overwrite a slot); each prefill's span. With ``gate``, every
    engine call that launches work on the card holds it, so that a
    profile starts and stops while none is in flight."""

    HOOKED = ("_draw_noise", "_prefill", "_admit", "_dispatch", "_process")

    def __init__(self, engine, latent: int, gate=None):
        self.windows: List[list] = []  # [slots at dispatch, init noise (K, B, D), latents (B, C, D)]
        self.prefills: List[tuple] = []
        self.engine, self.gate = engine, gate
        self._expect(engine, latent)
        self.orig = {n: getattr(engine, n) for n in self.HOOKED}
        engine._draw_noise = self._draw
        engine._prefill = self._prefill
        engine._admit = self._admit
        if gate is not None:
            engine._dispatch = self._gated("_dispatch")
            engine._process = self._gated("_process")

    @staticmethod
    def _expect(engine, latent: int):
        """The engine's internals that the hooks and the check read, as the
        benchmark knows them; anything else stops the run, rather than let
        the check read the wrong rows."""
        k, b = engine.frames_per_dispatch, engine.max_batch
        wrong = [n for n in Recorder.HOOKED
                 if getattr(getattr(engine, n, None), "__self__", None) is not engine]
        if not isinstance(getattr(engine, "_retiring", None), list):
            wrong.append("_retiring (a list)")
        if not (isinstance(getattr(engine, "slots", None), list) and len(engine.slots) == b):
            wrong.append(f"slots (a list of {b})")
        dec = getattr(getattr(engine, "carry", None), "dec_state", None)
        up0 = dec.get("up0") if isinstance(dec, dict) else None
        if not (isinstance(up0, torch.Tensor) and up0.dim() == 3 and up0.shape[0] == b
                and up0.shape[1] >= k and up0.shape[2] == latent):
            wrong.append(f"carry.dec_state['up0'] (max_batch {b} x >= K {k} frames x latent "
                         f"{latent}), found {None if up0 is None else tuple(up0.shape)}")
        if wrong:
            raise RuntimeError("the engine no longer has what the benchmark's hooks read: "
                               + "; ".join(wrong))

    def _gated(self, name):
        call = self.orig[name]

        def gated(*a):
            with self.gate.call():
                return call(*a)
        return gated

    def _draw(self):
        noise = self.orig["_draw_noise"]()
        e = self.engine
        init = getattr(noise, "init", None)
        if not (isinstance(init, torch.Tensor)
                and tuple(init.shape[:2]) == (e.frames_per_dispatch, e.max_batch)):
            raise RuntimeError("the engine's window noise is no longer (K, max_batch, D) "
                               f"under .init: {type(noise).__name__}")
        self.windows.append([list(e.slots), init.clone(), None])
        return noise

    def _admit(self):
        with self.gate.call() if self.gate else contextlib.nullcontext():
            if self.windows and self.windows[-1][2] is None:
                self.windows[-1][2] = self.engine.carry.dec_state["up0"].clone()
            return self.orig["_admit"]()

    def _prefill(self, r):
        with self.gate.call() if self.gate else contextlib.nullcontext():
            t0 = time.monotonic()
            out = self.orig["_prefill"](r)
            self.prefills.append((t0, time.monotonic(), int(r.input_ids.shape[1]),
                                  int(np.asarray(r.speech_frame_valid).sum())))
        return out

    def release(self):
        """Drop the engine, so that its memory is freed before the check."""
        self.engine = self.orig = None

    def frames_of(self, handle, k: int, n: int):
        """The initial noise (n, D) and the decoder inputs (n, D) of the
        first ``n`` frames that ``handle`` decoded, in order; the latents
        are None if a window's context was not read."""
        total = len(handle._audio)  # every frame with audio decoded one
        noise, lats, seen = [], [], 0
        for slots, init, ctx in self.windows:
            for i, h in enumerate(slots):
                if h is not handle or seen >= n:
                    continue
                made = min(k, total - seen)  # the window's frames of this request
                f = min(made, n - seen)
                noise += [init[j, i] for j in range(f)]
                if ctx is None or lats is None:
                    lats = None
                else:
                    lats += [ctx[i, ctx.shape[1] - made + j] for j in range(f)]
                seen += f
        return torch.stack(noise), None if lats is None else torch.stack(lats).float()


def _engine_request(ServingRequest, r: traffic.Request, hop: int):
    n = len(r.input_ids)
    width = max(len(v) for v in r.voices)
    wav = np.zeros((len(r.voices), width), np.float32)
    valid = np.zeros((len(r.voices), math.ceil(width / hop)), bool)
    for i, v in enumerate(r.voices):
        wav[i, : len(v)] = v
        valid[i, : math.ceil(len(v) / hop)] = True
    return ServingRequest(input_ids=r.input_ids[None], valid_mask=np.ones((1, n), bool),
                          speech_tensors=wav, speech_frame_valid=valid,
                          speech_input_mask=r.speech_mask[None], seed=r.seed,
                          max_length_times=(r.frames + 0.5) / n)


def build_program(m: spec.Model, raw: Dict, device):
    """The program as a deployment sets it up from the weights: int8 LM and
    LM head, the fused int8 serving packs, the engine with a bf16 KV cache."""
    from vibevoice_tpu_torch.configs import VibeVoiceConfig
    from vibevoice_tpu_torch.models import inference as inf
    from vibevoice_tpu_torch.models import vibevoice as vv
    from vibevoice_tpu_torch.serving.engine import ServingEngine

    cfg = VibeVoiceConfig.from_dict(m.raw)
    b = m.bench
    params = vv.fuse_for_serving(vv.quantize_for_inference(raw, ("lm", "lm_head")), cfg,
                                 quantize=True)
    opts = inf.GenerateOptions(cfg_scale=b["cfg_scale"], ddpm_steps=b["ddpm_steps"],
                               kv_int8=False)
    return ServingEngine(cfg, params, opts=opts, max_batch=b["max_batch"], max_len=b["max_len"],
                         frames_per_dispatch=b["frames_per_dispatch"])


def _drain(s: Served, now: float) -> None:
    h = s.handle
    while True:
        try:
            c = h.chunks.get_nowait()
        except Exception:  # queue.Empty
            return
        if c is h._END:
            s.done = True
            return
        s.chunk_times.append(now)


def serve(engine, sched: List[traffic.Request], hop: int, warm_s: float, seconds: float,
          tail_s: float, trace_s: float, gate: Optional[Pause] = None):
    """Send the schedule open loop and watch the streams. Returns (served,
    window, give_up, occupancy, profile, trace span)."""
    from vibevoice_tpu_torch.serving.engine import Request as ServingRequest

    start = time.monotonic()
    w0, w1 = start + warm_s, start + warm_s + seconds
    served = [Served(r, start + r.due) for r in sched]
    nxt, live, occupancy = 0, [], []
    prof, span = None, (0.0, 0.0)
    # early in the window: stopping the profile pauses the engine (``Pause``)
    # for seconds, and a traced run's host readings end where it starts
    t_prof = w0 + min(5.0, 0.4 * seconds)
    last_occ = 0.0
    deadline = w1 + tail_s
    while True:
        now = time.monotonic()
        while nxt < len(served) and served[nxt].due <= now:
            s = served[nxt]
            s.handle = engine.submit(_engine_request(ServingRequest, s.req, hop))
            s.submitted = time.monotonic()
            live.append(s)
            nxt += 1
        now = time.monotonic()
        for s in live:
            _drain(s, now)
        live = [s for s in live if not s.done]
        if trace_s > 0:
            if prof is None and now >= t_prof:
                with gate.hold():
                    prof = trace_read.Profile()
                span = (time.monotonic(), 0.0)
            elif prof is not None and span[1] == 0.0 and now >= span[0] + trace_s:
                span = (span[0], time.monotonic())
                with gate.hold():
                    prof.stop()
            if prof is not None and span[1] == 0.0 and now - last_occ >= OCCUPANCY_EVERY_S:
                occupancy.append(sum(h is not None for h in engine.slots) + len(engine._retiring))
                last_occ = now
        if now >= w1:
            window_due = [s for s in served if w0 <= s.due < w1]
            settled = all(s.first_audio is not None or (s.handle is not None and s.done)
                          for s in window_due)
            if (settled and (prof is None or span[1] > 0)) or now >= deadline:
                return served, (w0, w1), now, occupancy, prof, span
        wait = POLL_S if nxt >= len(served) else min(POLL_S, max(0.0, served[nxt].due - now))
        time.sleep(wait)


def window_gaps_ms(run: Run) -> List[float]:
    """Every request's intervals between consecutive windows of its audio
    that arrived inside the window: a window's K chunks arrive together, so
    the intervals between them are not gaps a listener hears."""
    w0, w1 = run.window
    k = run.frames_per_dispatch
    return [g * 1e3 for s in run.served
            for g in stats.gaps(stats.in_window(stats.window_arrivals(s.chunk_times, k), w0, w1))]


def e2e(run: Run) -> Dict[str, float]:
    """The end-to-end numbers every cell reports (host clock)."""
    w0, w1 = run.window
    frame_s = run.m.frame_seconds
    chunks = sum(len(stats.in_window(s.chunk_times, w0, w1)) for s in run.served)
    ttfa = []
    for s in run.served:
        if not (w0 <= s.due < w1):
            continue
        fa = s.first_audio
        ttfa.append(math.inf if fa is None else (fa - s.due) * 1e3)
    p95 = stats.percentile(ttfa, 95)
    if p95 == math.inf:  # a missing request: above every measured value
        p95 = (run.give_up - w0) * 1e3
    gaps = window_gaps_ms(run)
    return {"audio_s_per_s": stats.rate(chunks * frame_s, w0, w1),
            "ttfa_p95_ms": p95,
            "gap_p99_ms": stats.percentile(gaps, 99) if gaps else (w1 - w0) * 1e3,
            "setup_s": run.setup_s}


def load_report(run: Run) -> str:
    """How the window kept up with its load: the criteria of the knee sweep
    (TTFA within 1,000 ms, gaps within a frame window's audio, the backlog
    of requests waiting for first audio at the window's start and end)."""
    w0, w1 = run.window
    due = [s for s in run.served if w0 <= s.due < w1]
    ttfa = sorted(math.inf if s.first_audio is None else (s.first_audio - s.due) * 1e3
                  for s in due)
    gaps = window_gaps_ms(run)
    limit = run.frames_per_dispatch * run.m.frame_seconds * 1e3

    def backlog(t):
        return sum(1 for s in run.served if s.submitted and s.submitted <= t
                   and (s.first_audio is None or s.first_audio > t))

    def ttfa_p50(lo, hi):  # of the requests due in that share of the window
        p = stats.percentile([math.inf if s.first_audio is None else (s.first_audio - s.due) * 1e3
                              for s in due if lo <= (s.due - w0) / (w1 - w0) < hi], 50)
        return math.nan if p is None else p

    # the prefill worker's busy share of the window (it runs one at a time)
    busy = sum(max(0.0, min(b, w1) - max(a, w0)) for a, b, *_ in run.prefills) / (w1 - w0)
    return (f"load: {len(due)} requests due in {w1 - w0:.0f} s, TTFA p50 "
            f"{stats.percentile(ttfa, 50):.0f} ms p95 {stats.percentile(ttfa, 95):.0f} ms, "
            f"{sum(t <= 1000 for t in ttfa) / max(1, len(ttfa)):.3f} within 1000 ms, "
            f"{sum(g <= limit for g in gaps) / max(1, len(gaps)):.4f} of gaps within "
            f"{limit:.0f} ms, backlog {backlog(w0)} -> {backlog(w1)}, TTFA p50 of the first "
            f"and last quarter's requests {ttfa_p50(0, 0.25):.0f} -> {ttfa_p50(0.75, 1.01):.0f} ms, "
            f"prefill worker busy {busy:.3f}")


def check(m: spec.Model, rec: Recorder, run: Run, seed: int, device, k: int,
          control: Optional[str] = None) -> Dict:
    """The comparison with the plain reference, teacher-forced by what was
    served (``Reference.follow``), over requests finished in the window,
    drawn from the seed, the longest first: every frame of a sample of
    ``check_frames`` frames or more, and the first K + 1 frames (a window
    and the first frame of the next) of ``check_requests`` requests in all.

    - ``latent_rel_err_req_max``: each frame's L2 error of its latent (the
      CFG solve's output, from the prefill and the LM steps over the served
      history) against the reference's, over the request's RMS frame; the
      median frame of each request, and the largest of those over the
      requests: one request, one slot or a request's first window gone
      wrong fails it (a frame's own largest is a heavy tail of bf16 drift
      that the control does not clear by three times: PERF.md);
    - ``latent_rel_err_head_max``: the same over each request's first K + 1
      frames alone (the prefill, the join and the first LM steps, before the
      drift of a long history);
    - ``latent_rel_err_median``: the median of every sampled frame's error;
    - ``latent_rel_err_first``: the median, over the requests, of the first
      frame's error (the prefill and one CFG solve, no served history);
    - ``audio_rel_err_max``: the largest frame's error of its audio against
      the reference's decoder over the served latents, over the request's
      RMS frame;
    - ``token_gap_max``: the largest gap of a served token's logit below
      the reference's best candidate (exact: 0).

    With ``control`` (a lower precision of ``reference.PRECISIONS``) the
    reference in that precision decodes the same requests from the same
    noise in the program's place, and its numbers are returned; the
    program's own, over the same requests, under ``"program"``."""
    from . import weights

    w0, w1 = run.window
    done = [s for s in run.served if s.handle is not None and s.done
            and s.handle.error is None and s.first_audio is not None and s.first_audio < w1
            and s.handle._audio]
    if not done:
        return {"requests": 0, "frames": 0}
    b = m.bench
    rng = np.random.default_rng([seed, 7])
    done.sort(key=lambda s: -len(s.handle._audio))
    order = done[:1] + [done[1:][i] for i in rng.permutation(len(done) - 1)]
    whole, frames = [], 0
    for s in order:
        if frames >= b["check_frames"]:
            break
        whole.append(s)
        frames += len(s.handle._audio)
    heads = order[len(whole): max(len(whole), int(b["check_requests"]))]
    picks = [(s, len(s.handle._audio)) for s in whole] + [
        (s, min(k + 1, len(s.handle._audio))) for s in heads]
    picks = [(s, n, *rec.frames_of(s.handle, k, n)) for s, n in picks]
    picks = [p for p in picks if p[3] is not None]
    if not picks:
        return {"requests": 0, "frames": 0}
    # the long requests and the short heads decode as two batches
    groups = [g for g in (slice(0, len(whole)), slice(len(whole), len(picks))) if picks[g]]
    req = lambda s: dict(input_ids=s.req.input_ids, speech_mask=s.req.speech_mask,
                         voices=s.req.voices, seed=s.req.seed)
    raw = weights.make(m, seed, device)
    program = [(lat, torch.from_numpy(np.concatenate(s.handle._audio[:n])).float())
               for s, n, _, lat in picks]
    tokens = [s.handle.tokens[:n] for s, n, _, _ in picks]
    if control is not None:
        ctl = Reference(m, raw, device, control)
        controlled = []
        for g in groups:
            controlled += ctl.generate([req(s) for s, *_ in picks[g]],
                                       [noise for _, _, noise, _ in picks[g]])
        del ctl
    ref = Reference(m, raw, device)
    del raw

    def compare(served, tokens):
        per_req, aud_err, gap = [], [], 0.0
        for g in groups:
            sel, got = picks[g], served[g]
            outs = ref.follow([req(s) for s, *_ in sel], [noise for _, _, noise, _ in sel],
                              [x[0] for x in got], [x[1] for x in got],
                              None if tokens is None else tokens[g])
            for (lat, aud, gaps), (plat, paud) in zip(outs, got):
                plat = plat.to(lat.device).double()
                paud = paud.to(aud.device).view(aud.shape).double()
                lat, aud = lat.double(), aud.double()
                # each frame's error over the request's RMS frame: a quiet
                # frame is not held to its own small norm
                rms = lambda x: x.norm(dim=1).pow(2).mean().sqrt().clamp_min(1e-30)
                per_req.append(((plat - lat).norm(dim=1) / rms(lat)).tolist())
                aud_err += ((paud - aud).norm(dim=1) / rms(aud)).tolist()
                gap = max(gap, float(gaps.max()))
        pooled = [e for r in per_req for e in r]
        worst = sorted(per_req, key=lambda r: -float(np.median(r)))[:3]
        return {"requests": len(per_req), "frames": len(pooled),
                "latent_rel_err_req_max": max(float(np.median(r)) for r in per_req),
                "latent_rel_err_head_max": max(float(np.median(r[: k + 1])) for r in per_req),
                "audio_rel_err_max": max(aud_err), "token_gap_max": gap,
                # readings beside the compared numbers (stderr)
                "latent_rel_err_median": float(np.median(pooled)),
                "latent_rel_err_max": max(pooled),
                "latent_rel_err_first": float(np.median([r[0] for r in per_req])),
                "latent_rel_err_later": float(np.median([e for r in per_req for e in r[1:]]
                                                        or [math.nan])),
                "audio_rel_err_median": float(np.median(aud_err)),
                "worst": "; ".join(f"{len(r)} frames, median {np.median(r):.3g}, first window "
                                   f"{np.median(r[: k + 1]):.3g}, largest {max(r):.3g} at frame "
                                   f"{int(np.argmax(r))}" for r in worst)}

    out = compare(program, tokens)
    if control is not None:
        out = dict(compare(controlled, None), program=out)
    return out
