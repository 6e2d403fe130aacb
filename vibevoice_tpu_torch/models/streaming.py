"""Streaming VibeVoice model (0.5B): split-LM real-time TTS
(port of vibevoice_tpu/models/streaming.py).

* The Qwen2 stack is split into a lower text LM (``lm_num_hidden_layers``
  layers, final norm skipped) and an upper TTS LM
  (``tts_backbone_num_hidden_layers`` layers), two plain qwen2 parameter
  trees that share nothing; ``qwen2.forward(skip_final_norm=True)`` runs the
  lower one.
* A 2-entry type embedding marks text (1) and speech (0) inputs to the TTS
  LM, and a binary EOS classifier on its hidden state ends generation.
* Generation interleaves 5-token text windows with 6-frame speech windows.
  A speech frame solves the CFG diffusion over the positive and negative TTS
  hidden states, vocodes one frame (the acoustic decoder's stage 0 is
  kernel D after ``fuse_vocoder``), and runs the upper LM once over each of
  the positive and the negative cache (kernel B's decode route); a text
  window runs both LMs over 5 tokens (kernel B's prefill route).
* Voice presets are prefilled KV caches plus last hidden states of the
  streams (lm, tts_lm, neg_tts_lm), the reference's ``.pt`` format;
  ``VoicePreset.save``/``load`` keep the JAX package's ``.npz`` keys.

The caches hold the model's head_dim (64 for the 0.5B): the JAX package's
128-lane padding is a TPU layout that the port leaves out. As in
models/qwen2.py, the windows write the KV caches in place and return a
StreamState that shares those buffers.

The window functions (``make_window_fns``, ``make_session_fns``) run one
window per call. On CUDA tensors each kind of window (the text window, the
speech window of 6 frames, the single frame, a session window of n frames)
is captured once into a ``torch.cuda.CUDAGraph`` and replayed; the windows
of one (window functions, params object, batch, cache slots, cache dtype)
share one static StreamState, so passing one window's returned state to
the next copies nothing. That static state is one entry of
``inference.MAX_CAPTURES``. The window bodies draw nothing: the host draws
each window's noise (``inference.FrameNoise``: initial latents, SDE noise)
from a ``torch.Generator`` before the window, so graphed and eager runs give
the same audio. A capture that fails raises; ``WindowFn.eager`` runs the
same body launch by launch (always, on CPU tensors).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..configs import VibeVoiceStreamingConfig

from ..schedule import dpm_solver as dpm
from . import diffusion_head as dh
from . import inference as inf
from . import qwen2
from . import tokenizer as tok
from . import vibevoice as vv

TTS_TEXT_WINDOW_SIZE = 5  # reference modeling_vibevoice_streaming_inference.py:41
TTS_SPEECH_WINDOW_SIZE = 6  # reference :42

Params = Dict


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def _lower_cfg(cfg: VibeVoiceStreamingConfig):
    return dataclasses.replace(cfg.decoder_config, num_hidden_layers=cfg.lm_num_hidden_layers)


def _upper_cfg(cfg: VibeVoiceStreamingConfig):
    return dataclasses.replace(cfg.decoder_config,
                               num_hidden_layers=cfg.tts_backbone_num_hidden_layers)


def fuse_vocoder(params: Params, cfg: VibeVoiceStreamingConfig, quantize: bool = True) -> Params:
    """Pack the acoustic decoder's stage-0 block stack for kernel D
    (``tokenizer.fuse_hot_stages``; the streaming model has no semantic
    tokenizer)."""
    out = dict(params)
    ac = dict(params["acoustic_tokenizer"])
    ac.update(tok.fuse_hot_stages({"decoder": ac["decoder"]}, cfg.acoustic_tokenizer_config,
                                  quantize))
    out["acoustic_tokenizer"] = ac
    return out


def eos_logit(params: Params, h: torch.Tensor) -> torch.Tensor:
    """BinaryClassifier: Linear -> ReLU -> Linear -> 1 (reference :42-53)."""
    p = params["tts_eos_classifier"]
    x = torch.relu(h @ p["fc1"]["w"].to(h.dtype) + p["fc1"]["b"].to(h.dtype))
    return x @ p["fc2"]["w"].to(x.dtype) + p["fc2"]["b"].to(x.dtype)


# ---------------------------------------------------------------------------
# Streaming state / voice presets
# ---------------------------------------------------------------------------


class StreamState(NamedTuple):
    lm_cache: qwen2.KVCache
    tts_cache: qwen2.KVCache
    neg_tts_cache: qwen2.KVCache
    dec_state: Dict
    tts_h: torch.Tensor  # (B, H) last TTS hidden
    neg_tts_h: torch.Tensor  # (B, H)
    finished: torch.Tensor  # (B,) bool


@dataclass
class VoicePreset:
    """Prefilled prompt state of the streams, as host arrays: ``kv`` entries
    are (k, v, length) with k/v f32 (L, 1, KH, S, D) and length (1,) int32;
    ``h`` are (1, H) last hidden states. Mirrors the reference ``.pt``
    schema; ``save``/``load`` use the JAX package's ``.npz`` keys."""

    lm_kv: tuple
    tts_kv: tuple
    neg_tts_kv: tuple
    lm_h: np.ndarray
    tts_h: np.ndarray
    neg_tts_h: np.ndarray

    def save(self, path: str) -> None:
        np.savez(
            path,
            lm_k=self.lm_kv[0], lm_v=self.lm_kv[1], lm_len=self.lm_kv[2],
            tts_k=self.tts_kv[0], tts_v=self.tts_kv[1], tts_len=self.tts_kv[2],
            neg_tts_k=self.neg_tts_kv[0], neg_tts_v=self.neg_tts_kv[1],
            neg_tts_len=self.neg_tts_kv[2],
            lm_h=self.lm_h, tts_h=self.tts_h, neg_tts_h=self.neg_tts_h,
        )

    @classmethod
    def load(cls, path: str) -> "VoicePreset":
        z = np.load(path)
        return cls(
            lm_kv=(z["lm_k"], z["lm_v"], z["lm_len"]),
            tts_kv=(z["tts_k"], z["tts_v"], z["tts_len"]),
            neg_tts_kv=(z["neg_tts_k"], z["neg_tts_v"], z["neg_tts_len"]),
            lm_h=z["lm_h"], tts_h=z["tts_h"], neg_tts_h=z["neg_tts_h"],
        )


def _put_rows(cache: qwen2.KVCache, layer: int, row, k: torch.Tensor, v: torch.Tensor) -> None:
    """Write k/v (..., KH, S', D) f32 into layer ``layer`` of ``cache`` at
    slots [0, S') of batch rows ``row`` (a slice or an index), quantizing
    per row into an int8 cache."""
    s = k.shape[-2]
    for buf, scales, x in ((cache.k, cache.k_scale, k), (cache.v, cache.v_scale, v)):
        if cache.quantized:
            q, sc = qwen2.quantize_kv_rows(x)
            buf[layer][row, :, :s] = q
            scales[layer][row, :, 0, :s] = sc
        else:
            buf[layer][row, :, :s] = x.to(buf[layer].dtype)


def _cache_from_kv(cfg, kv, max_len: int, dtype, *, quantized: bool = False,
                   device=None) -> qwen2.KVCache:
    """A ``max_len``-slot cache holding a preset stream's rows (stacked
    (L, B, KH, S, D)); an int8 cache quantizes them per (token, head) row,
    as later writes quantize on write in qwen2.forward."""
    k, v, length = kv
    n_layers, b, _, _, d = k.shape
    if d != cfg.head_dim or n_layers != cfg.num_hidden_layers:
        raise ValueError(f"preset rows (L {n_layers}, D {d}) do not fit the model "
                         f"(L {cfg.num_hidden_layers}, head_dim {cfg.head_dim})")
    cache = qwen2.make_cache(cfg, b, max_len, dtype, quantized=quantized, device=device)
    kt, vt = (torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device) for x in (k, v))
    for i in range(n_layers):
        _put_rows(cache, i, slice(None), kt[i], vt[i])
    return cache._replace(length=torch.as_tensor(np.array(length, np.int32).reshape(b),
                                                 device=device))


def init_stream_state(cfg: VibeVoiceStreamingConfig, params: Params, preset: VoicePreset,
                      max_len: int, *, kv_int8: bool = False) -> StreamState:
    """Batch-1 state on the parameters' device from a voice preset."""
    embed = params["language_model"]["embed"]
    dtype, dev = embed.dtype, embed.device
    lcfg, ucfg = _lower_cfg(cfg), _upper_cfg(cfg)
    h = lambda x: torch.as_tensor(np.array(x, np.float32), device=dev).to(dtype)
    return StreamState(
        lm_cache=_cache_from_kv(lcfg, preset.lm_kv, max_len, dtype, quantized=kv_int8, device=dev),
        tts_cache=_cache_from_kv(ucfg, preset.tts_kv, max_len, dtype, quantized=kv_int8,
                                 device=dev),
        neg_tts_cache=_cache_from_kv(ucfg, preset.neg_tts_kv, max_len, dtype, quantized=kv_int8,
                                     device=dev),
        dec_state=tok.init_decoder_state(cfg.acoustic_tokenizer_config, 1, dtype, dev),
        tts_h=h(preset.tts_h),
        neg_tts_h=h(preset.neg_tts_h),
        finished=torch.zeros(1, dtype=torch.bool, device=dev),
    )


def init_session_state(cfg: VibeVoiceStreamingConfig, params: Params, batch: int, max_len: int,
                       kv_int8: bool = False) -> StreamState:
    """Empty multi-session state: ``batch`` slots, all finished (inactive);
    sessions are spliced in per slot by ``admit_session``. kv_int8 halves
    the caches' bytes (per-row scales, quantize-on-write in qwen2.forward)."""
    embed = params["language_model"]["embed"]
    dtype, dev = embed.dtype, embed.device
    h = cfg.decoder_config.hidden_size
    cache = lambda c: qwen2.make_cache(c, batch, max_len, dtype, quantized=kv_int8, device=dev)
    return StreamState(
        lm_cache=cache(_lower_cfg(cfg)),
        tts_cache=cache(_upper_cfg(cfg)),
        neg_tts_cache=cache(_upper_cfg(cfg)),
        dec_state=tok.init_decoder_state(cfg.acoustic_tokenizer_config, batch, dtype, dev),
        tts_h=torch.zeros(batch, h, dtype=dtype, device=dev),
        neg_tts_h=torch.zeros(batch, h, dtype=dtype, device=dev),
        finished=torch.ones(batch, dtype=torch.bool, device=dev),
    )


def preset_admit_arrays(preset: VoicePreset, lane_dim: int, bucket: int = 128,
                        max_len: Optional[int] = None) -> Dict:
    """Host-side: pad a VoicePreset's stacked (L, 1, KH, Sp, D) KV arrays to
    (L, KH, Sb, lane_dim), Sb = Sp rounded up to ``bucket`` (clamped to
    ``max_len``, the slot capacity). ``lane_dim`` is the model's head_dim
    here (the port's caches are not lane-padded). Returns the keyword
    arguments of ``admit_session`` as numpy."""

    def prep(kv):
        k, v, ln = kv
        n_layers, _, kh, sp, d = k.shape
        sb = -(-sp // bucket) * bucket
        if max_len is not None:
            if sp > max_len:
                raise ValueError(
                    f"voice preset has {sp} KV rows but the engine's max_len is {max_len}")
            sb = min(sb, max_len)
        ok = np.zeros((n_layers, kh, sb, lane_dim), np.float32)
        ov = np.zeros((n_layers, kh, sb, lane_dim), np.float32)
        ok[:, :, :sp, :d] = k[:, 0]
        ov[:, :, :sp, :d] = v[:, 0]
        return ok, ov, np.int32(ln[0])

    lm_k, lm_v, lm_len = prep(preset.lm_kv)
    tts_k, tts_v, tts_len = prep(preset.tts_kv)
    ng_k, ng_v, ng_len = prep(preset.neg_tts_kv)
    return dict(
        lm_k=lm_k, lm_v=lm_v, lm_len=lm_len,
        tts_k=tts_k, tts_v=tts_v, tts_len=tts_len,
        ng_k=ng_k, ng_v=ng_v, ng_len=ng_len,
        tts_h=np.asarray(preset.tts_h[0], np.float32),
        neg_tts_h=np.asarray(preset.neg_tts_h[0], np.float32),
    )


def admit_session(state: StreamState, slot: int, *, lm_k, lm_v, lm_len, tts_k, tts_v, tts_len,
                  ng_k, ng_v, ng_len, tts_h, neg_tts_h) -> StreamState:
    """Splice a voice preset (``preset_admit_arrays``; its float arrays as
    numpy or as tensors on any device) into slot ``slot`` of
    a multi-session state: its KV prefix is overwritten in place (quantized
    per row into an int8 cache), its lengths set, its vocoder conv state
    zeroed, the preset hidden states installed and the slot un-finished.
    Rows a previous session left past the preset are never read
    (valid-prefix attention)."""
    slot = int(slot)
    dev, dt = state.tts_h.device, state.tts_h.dtype
    on_dev = lambda x: (x.to(dev, torch.float32) if isinstance(x, torch.Tensor)
                        else torch.as_tensor(np.array(x, np.float32), device=dev))

    def put(cache: qwen2.KVCache, k_new, v_new, ln) -> qwen2.KVCache:
        kt, vt = on_dev(k_new), on_dev(v_new)
        for i in range(len(cache.k)):
            _put_rows(cache, i, slot, kt[i], vt[i])
        length = cache.length.clone()
        length[slot] = int(ln)
        return cache._replace(length=length)

    def row(t: torch.Tensor, value) -> torch.Tensor:
        t = t.clone()
        t[slot] = value
        return t

    return StreamState(
        lm_cache=put(state.lm_cache, lm_k, lm_v, lm_len),
        tts_cache=put(state.tts_cache, tts_k, tts_v, tts_len),
        neg_tts_cache=put(state.neg_tts_cache, ng_k, ng_v, ng_len),
        dec_state={k: row(v, 0) for k, v in state.dec_state.items()},
        tts_h=row(state.tts_h, on_dev(tts_h).to(dt)),
        neg_tts_h=row(state.neg_tts_h, on_dev(neg_tts_h).to(dt)),
        finished=row(state.finished, False),
    )


def clear_finished(state: StreamState, slot: int) -> StreamState:
    """Clear slot ``slot``'s finished flag in place, so that its next
    session windows commit again (a live session resuming after its EOS
    with more text). Returns ``state`` itself."""
    state.finished[int(slot)] = False
    return state


def build_voice_preset(cfg: VibeVoiceStreamingConfig, params: Params, prompt_ids: np.ndarray, *,
                       neg_prompt_id: int, max_len: int = 512) -> VoicePreset:
    """Prefill the streams from a voice-prompt token sequence from base 0
    (the analog of building the reference's ``.pt`` presets; the negative
    prompt is a single pad token, reference :467, :483-507). Over the whole
    prompt this is one chunk through both LMs: kernel B's prefill route on
    the card."""
    lm = params["language_model"]
    dtype, dev = lm["embed"].dtype, lm["embed"].device
    lcfg, ucfg = _lower_cfg(cfg), _upper_cfg(cfg)

    def prefill(ids: torch.Tensor):
        h, lm_cache = qwen2.forward(lcfg, lm, qwen2.embed_tokens(lm, ids),
                                    cache=qwen2.make_cache(lcfg, 1, max_len, dtype, device=dev),
                                    skip_final_norm=True)
        tts_in = h + params["tts_input_types"][1][None, None, :].to(h.dtype)
        th, tts_cache = qwen2.forward(ucfg, params["tts_language_model"], tts_in,
                                      cache=qwen2.make_cache(ucfg, 1, max_len, dtype, device=dev))
        return lm_cache, tts_cache, h[:, -1], th[:, -1]

    ids = torch.as_tensor(np.asarray(prompt_ids), dtype=torch.long, device=dev).reshape(1, -1)
    if ids.shape[1] > max_len:
        raise ValueError(f"a {ids.shape[1]}-token voice prompt does not fit {max_len} slots")
    lm_cache, tts_cache, lm_h, tts_h = prefill(ids)
    _, neg_tts_cache, _, neg_tts_h = prefill(torch.full((1, 1), neg_prompt_id, dtype=torch.long,
                                                        device=dev))

    def kv(c: qwen2.KVCache):
        ln = int(c.length[0])
        stack = lambda bufs: torch.stack([x[:, :, :ln] for x in bufs]).float().cpu().numpy()
        return stack(c.k), stack(c.v), c.length.cpu().numpy()

    host = lambda t: t.float().cpu().numpy()
    return VoicePreset(lm_kv=kv(lm_cache), tts_kv=kv(tts_cache), neg_tts_kv=kv(neg_tts_cache),
                       lm_h=host(lm_h), tts_h=host(tts_h), neg_tts_h=host(neg_tts_h))


# ---------------------------------------------------------------------------
# Window functions
# ---------------------------------------------------------------------------


class _Graph:
    """One captured kind of window: the graph, static copies of its inputs
    besides the state, its outputs and the kernel launches it holds."""

    def __init__(self, args):
        self.args = inf._tree_map(lambda t: t.clone(), args)
        self.graph = torch.cuda.CUDAGraph()
        self.out: tuple = ()
        self.launches: Dict[str, int] = {}


class _StreamCapture:
    """The captured windows of one stream shape: the static state they all
    read and write, and a graph per kind of window and input shapes."""

    def __init__(self, params, state: StreamState):
        self.params = params  # the graphs read these tensors: keep them alive
        self.state = inf._tree_map(torch.empty_like, state)
        self.graphs: Dict[tuple, _Graph] = {}


class WindowFn:
    """One window of ``StreamFns``: ``fn(params, state, *inputs)`` returns the
    new state (text window) or (state, audio, eos) (speech windows);
    graphed on CUDA tensors, ``eager`` launch by launch."""

    def __init__(self, fns: "StreamFns", kind, body):
        self.fns, self.kind, self.body = fns, kind, body

    def eager(self, params, state: StreamState, *inputs):
        state, out = self.body(params, state, *inputs)
        return (state, *out) if out else state

    def __call__(self, params, state: StreamState, *inputs):
        if state.tts_h.device.type != "cuda":
            return self.eager(params, state, *inputs)
        state, out = self.fns._replay(self, params, state, inputs)
        return (state, *out) if out else state


class StreamFns:
    """The window functions of one (config, solver options):

      text(params, state, text_ids (B, 5) long, valid (B, 5) bool) -> state
      speech(params, state, noise) -> (state, audio (6, B, hop, 1), eos (6, B))
      single(params, state, noise) -> (state, audio (B, hop, 1), eos (B,))
      session(n)(params, state, active (B,) bool, noise)
          -> (state, audio (n, B, hop, 1), eos (n, B))

    ``noise`` is an ``inference.FrameNoise`` of the window's frames: ``init``
    (n, B, D) and, under opts.sde, ``sde`` (n, S, B, D); ``single`` reads
    frame 0. Each WindowFn is graphed on CUDA tensors (module docstring).
    One request at a time owns the captures (``request()``); ``replays``
    counts graph launches."""

    def __init__(self, cfg: VibeVoiceStreamingConfig, opts: inf.GenerateOptions):
        self.cfg, self.opts = cfg, opts
        self.coeffs = inf.make_solver(cfg, opts)
        self.replays = 0
        self._timesteps: Dict = {}
        self._owner = threading.RLock()
        self._sessions: Dict[int, WindowFn] = {}
        self.text = WindowFn(self, "text", self._text_window)
        self.speech = WindowFn(self, "speech", lambda p, s, noise: self._frames(
            p, s, noise, None, TTS_SPEECH_WINDOW_SIZE))
        self.single = WindowFn(self, "single", self._single_frame)

    def request(self):
        """The captures held by the calling thread until the block ends."""
        return self._owner

    def session(self, n: int = TTS_SPEECH_WINDOW_SIZE) -> WindowFn:
        """The n-frame session window (n = the engine's admission quantum):
        frame for frame what the 6-frame window computes, in n-frame calls."""
        if TTS_SPEECH_WINDOW_SIZE % n != 0:
            raise ValueError(f"quantum must divide {TTS_SPEECH_WINDOW_SIZE}, got {n}")
        if n not in self._sessions:
            self._sessions[n] = WindowFn(self, ("session", n), lambda p, s, active, noise: (
                self._frames(p, s, noise, active, n)))
        return self._sessions[n]

    # -- bodies: device tensors only, nothing copied from the host, nothing drawn

    def _text_window(self, params, state: StreamState, text_ids, valid):
        """Feed a (B, W <= 5) text window through lm -> tts_lm (reference
        :590-610). A row whose window is ALL invalid (multi-session: out of
        text while others feed) keeps its tts_h and commits nothing (its
        lengths do not move; the speculative rows are overwritten later)."""
        cfg = self.cfg
        lm = params["language_model"]
        h, lm_cache = qwen2.forward(_lower_cfg(cfg), lm, qwen2.embed_tokens(lm, text_ids),
                                    valid_mask=valid, cache=state.lm_cache, skip_final_norm=True)
        tts_in = h + params["tts_input_types"][1][None, None, :].to(h.dtype)
        th, tts_cache = qwen2.forward(_upper_cfg(cfg), params["tts_language_model"], tts_in,
                                      valid_mask=valid, cache=state.tts_cache)
        last = (valid.to(torch.int64).sum(1) - 1).clamp_min(0)  # last VALID row
        tts_h = th[torch.arange(th.shape[0], device=th.device), last]
        tts_h = torch.where(valid.any(1)[:, None], tts_h, state.tts_h)
        return state._replace(lm_cache=lm_cache, tts_cache=tts_cache, tts_h=tts_h), ()

    def _frame(self, params, state: StreamState, x_init, sde_noise, active):
        """One diffusion frame. ``active`` (B,) bool (multi-session) gates
        what a row commits: rows not live (inactive or finished) still
        compute, but their cache lengths, hidden states, finished flag and
        vocoder conv state stay as they were. None: every row commits."""
        cfg, opts = self.cfg, self.opts
        hcfg = cfg.diffusion_head_config
        dtype = params["language_model"]["embed"].dtype
        dev = state.tts_h.device
        ts = self._timesteps.get(dev)
        if ts is None:
            ts = self._timesteps[dev] = torch.from_numpy(self.coeffs.timesteps).to(dev)
        head = params["diffusion_head"]
        # AdaLN modulations of every solver step, computed once a frame
        mods = dh.precompute_mods(head, hcfg, ts, torch.cat([state.tts_h, state.neg_tts_h]))
        latent = dpm.cfg_sample(
            self.coeffs, lambda x, t, e: dh.apply_with_mods(head, hcfg, x, e), state.tts_h,
            state.neg_tts_h, opts.cfg_scale, x_init, noise=sde_noise,
            extras=[dh.step_mods(mods, i) for i in range(self.coeffs.num_steps)])
        scaled = latent / params["speech_scaling_factor"] - params["speech_bias_factor"]
        audio, dec_new = tok.decode(cfg.acoustic_tokenizer_config, params["acoustic_tokenizer"],
                                    scaled[:, None, :].to(dtype), state.dec_state)
        acoustic_embed = vv.connector_apply(params["acoustic_connector"], latent.to(dtype))
        tts_in = (acoustic_embed + params["tts_input_types"][0][None, :].to(dtype))[:, None, :]
        live = None if active is None else active & ~state.finished
        adv = None if live is None else live.to(torch.int32)
        ucfg, upper = _upper_cfg(cfg), params["tts_language_model"]
        th, tts_cache = qwen2.forward(ucfg, upper, tts_in, cache=state.tts_cache, advance=adv)
        nh, neg_cache = qwen2.forward(ucfg, upper, tts_in, cache=state.neg_tts_cache, advance=adv)
        eos_p = torch.sigmoid(eos_logit(params, th[:, 0]).float())[:, 0]
        if live is None:
            tts_h, neg_tts_h, dec_state = th[:, 0], nh[:, 0], dec_new
            finished = state.finished | (eos_p > 0.5)
        else:
            tts_h = torch.where(live[:, None], th[:, 0], state.tts_h)
            neg_tts_h = torch.where(live[:, None], nh[:, 0], state.neg_tts_h)
            commit = live.reshape(-1, 1, 1)
            dec_state = {k: torch.where(commit, dec_new[k], v) for k, v in state.dec_state.items()}
            finished = state.finished | (live & (eos_p > 0.5))
        new = state._replace(tts_cache=tts_cache, neg_tts_cache=neg_cache, dec_state=dec_state,
                             tts_h=tts_h, neg_tts_h=neg_tts_h, finished=finished)
        return new, audio, eos_p

    def _frames(self, params, state, noise: inf.FrameNoise, active, n: int):
        """n frames, frame f reading row f of the noise."""
        audio, eos = [], []
        for f in range(n):
            state, a, e = self._frame(params, state, noise.init[f],
                                      None if noise.sde is None else noise.sde[f], active)
            audio.append(a)
            eos.append(e)
        return state, (torch.stack(audio), torch.stack(eos))

    def _single_frame(self, params, state, noise: inf.FrameNoise):
        """One diffusion frame (for the least time to first audio)."""
        state, audio, eos = self._frame(params, state, noise.init[0],
                                        None if noise.sde is None else noise.sde[0], None)
        return state, (audio, eos)

    # -- the CUDA graphs

    def _replay(self, fn: WindowFn, params, state: StreamState, inputs):
        with self._owner:
            key = (self, id(params), state.tts_h.device, tuple(state.tts_h.shape),
                   state.tts_h.dtype, state.lm_cache.max_len, state.lm_cache.k[0].dtype)
            with inf._captures_lock:
                cap = inf._captures.get(key)
                if cap is not None:
                    inf._captures.move_to_end(key)
            if cap is None:
                cap = _StreamCapture(params, state)
                with inf._captures_lock:
                    inf._captures[key] = cap
                    while len(inf._captures) > inf.MAX_CAPTURES:
                        inf._captures.popitem(last=False)
            if state is not cap.state:
                inf._copy_into(cap.state, state)
            shapes = []
            inf._tree_map(lambda t: shapes.append((tuple(t.shape), t.dtype)), inputs)
            gkey = (fn.kind, tuple(shapes))
            g = cap.graphs.get(gkey)
            if g is None:
                g = cap.graphs[gkey] = self._capture(fn, cap, params, inputs)
            inf._copy_into(g.args, inputs)
            g.graph.replay()
            inf._add_launches(g.launches)
            self.replays += 1
            return cap.state, g.out

    def _capture(self, fn: WindowFn, cap: _StreamCapture, params, inputs) -> _Graph:
        g = _Graph(inputs)
        # one eager window first, on a copy of the state and on the caller's
        # stream: it builds the kernel library, sizes the kernels' shared
        # workspaces and counters and lets cuDNN choose its algorithms
        fn.body(params, inf._tree_map(lambda t: t.clone(), cap.state), *g.args)
        before = inf._read_launches()
        try:
            with torch.cuda.graph(g.graph, capture_error_mode="thread_local"):
                new_state, g.out = fn.body(params, cap.state, *g.args)
                inf._copy_into(cap.state, new_state)  # replays chain through the static state
        finally:
            delta = {k: n - before.get(k, 0) for k, n in inf._read_launches().items()}
            g.launches = {k: n for k, n in delta.items() if n}
            inf._add_launches({k: -n for k, n in g.launches.items()})  # a capture launches nothing
        return g


@functools.lru_cache(maxsize=16)
def _stream_fns(cfg: VibeVoiceStreamingConfig, opts: inf.GenerateOptions) -> StreamFns:
    return StreamFns(cfg, opts)


def make_window_fns(cfg: VibeVoiceStreamingConfig, opts, inject: bool = False):
    """(text_window_fn, speech_window_fn, single_frame_fn) of ``StreamFns``,
    memoized on the options the windows read (``inference._trace_opts``).
    ``inject`` is the JAX signature's: the windows always read their noise
    from the caller, drawn or from a noise bank."""
    fns = _stream_fns(cfg, inf._trace_opts(opts))
    return fns.text, fns.speech, fns.single


def make_session_fns(cfg: VibeVoiceStreamingConfig, opts, inject: bool = False,
                     quantum: int = TTS_SPEECH_WINDOW_SIZE):
    """Multi-session (batched) window fns: (text_window_fn,
    session_window_fn). The text window takes per-slot (B, 5) ids and valid
    masks (all-invalid rows are no-ops); the session window takes an
    ``active`` (B,) bool gating which slots commit, and runs ``quantum``
    frames a call (6 % quantum == 0; a sub-window quantum changes only how
    often the host can admit and deliver, not what a row computes). Shares
    the memo and the static state with ``make_window_fns``."""
    fns = _stream_fns(cfg, inf._trace_opts(opts))
    return fns.text, fns.session(quantum)


# ---------------------------------------------------------------------------
# Host generate loop
# ---------------------------------------------------------------------------


def generate(
    cfg: VibeVoiceStreamingConfig,
    params: Params,
    *,
    tts_text_ids: np.ndarray,
    preset: VoicePreset,
    opts: Optional[inf.GenerateOptions] = None,
    max_len: int = 2048,
    seed: int = 0,
    audio_streamer=None,
    stop_check_fn=None,
    window_fns=None,
    noise_bank=None,
) -> inf.GenerationOutput:
    """Windowed streaming generation at batch 1 on the parameters' device
    (reference :412-725): the preset's caches, then 5-token text windows
    interleaved with 6-frame speech windows until EOS, the end of
    ``stop_check_fn`` or the cache's capacity (the next text + speech
    window would pass ``max_len``). Frames after the first EOS frame of a
    window are dropped. One host synchronisation a window.

    Each window's noise is drawn before it from a ``torch.Generator`` seeded
    with ``seed``, frame by frame (initial latents, then SDE noise).
    noise_bank (replaying another implementation's draws): {"init": (E, 1,
    D)[, "sde": (E, S, 1, D)]}, consumed one row per speech frame in order,
    the frames a window runs after EOS included (reference :613-694 keeps
    sampling after finished_tags). ``window_fns`` defaults to
    ``make_window_fns`` (graphed on the card); their ``eager`` calls run
    the same windows launch by launch."""
    opts = inf.resolve_kv_int8(opts or inf.GenerateOptions(cfg_scale=1.5, ddpm_steps=5), max_len)
    if window_fns is None:
        window_fns = make_window_fns(cfg, opts, noise_bank is not None)
    text_fn, speech_fn, _ = window_fns
    dev = params["language_model"]["embed"].device
    w6 = TTS_SPEECH_WINDOW_SIZE
    f32 = dict(dtype=torch.float32, device=dev)
    if noise_bank is not None:
        bank_init = torch.as_tensor(np.asarray(noise_bank["init"]), **f32)
        if opts.sde and "sde" not in noise_bank:
            raise ValueError("injection with opts.sde requires noise_bank['sde']")
        bank_sde = torch.as_tensor(np.asarray(noise_bank["sde"]), **f32) if opts.sde else None
    else:
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
        steps_sde = inf.make_solver(cfg, opts).num_steps
        noise = inf.FrameNoise(torch.empty(w6, 1, cfg.acoustic_vae_dim, **f32),
                               torch.empty(w6, steps_sde, 1, cfg.acoustic_vae_dim, **f32)
                               if opts.sde else None, None)

    state = init_stream_state(cfg, params, preset, max_len, kv_int8=opts.kv_int8)
    text = np.asarray(tts_text_ids).reshape(1, -1)
    n_text, w = text.shape[1], TTS_TEXT_WINDOW_SIZE
    audio_chunks: List[np.ndarray] = []
    text_pos, frame_counter, steps = 0, 0, 0
    max_steps = max_len - int(np.asarray(preset.tts_kv[2]).reshape(-1)[0])
    finished = False

    owner = speech_fn.fns.request() if isinstance(speech_fn, WindowFn) else contextlib.nullcontext()
    with owner:
        while True:
            if stop_check_fn is not None and stop_check_fn():
                break
            if finished:
                break
            if steps + w + w6 > max_steps:
                # the next text + speech window would write past max_len,
                # where the cache write clamps onto committed slots: stop
                break
            if text_pos < n_text:
                chunk = text[:, text_pos: text_pos + w]
                text_pos += chunk.shape[1]
                valid = np.zeros((1, w), bool)
                valid[:, : chunk.shape[1]] = True
                chunk = np.pad(chunk, ((0, 0), (0, w - chunk.shape[1])))
                state = text_fn(params, state, torch.as_tensor(chunk, dtype=torch.long, device=dev),
                                torch.as_tensor(valid, device=dev))
                steps += int(valid.sum())
            if noise_bank is not None:
                for name, bank in (("init", bank_init), ("sde", bank_sde)):
                    if bank is not None and frame_counter + w6 > bank.shape[0]:
                        raise ValueError(
                            f"noise_bank[{name!r}] has {bank.shape[0]} rows but frame "
                            f"{frame_counter + w6} is needed; enlarge the bank")
                noise = inf.FrameNoise(
                    bank_init[frame_counter: frame_counter + w6],
                    None if bank_sde is None else bank_sde[frame_counter: frame_counter + w6],
                    None)
                frame_counter += w6
            else:
                inf._fill_noise(noise, generator)
            state, audio, eos = speech_fn(params, state, noise)
            steps += w6
            # one synchronisation a window; audio (6, 1, hop, 1), eos (6, 1)
            audio_np, eos_np = audio.float().cpu().numpy(), eos.cpu().numpy()
            finished = bool(state.finished.cpu().all())
            keep = w6
            hit = np.nonzero(eos_np[:, 0] > 0.5)[0]
            if hit.size:
                keep = int(hit[0]) + 1  # frames after the first EOS frame are dropped
            for f in range(keep):
                audio_chunks.append(audio_np[f, 0, :, 0])
                if audio_streamer is not None:
                    audio_streamer.put([audio_np[f, 0, :, 0]], [0])
            if audio_streamer is not None and hit.size:
                audio_streamer.end([0])

    if audio_streamer is not None:
        audio_streamer.end()
    return inf.GenerationOutput(
        sequences=text,
        speech_outputs=[np.concatenate(audio_chunks) if audio_chunks else None],
        reach_max_step_sample=np.asarray([steps >= max_steps]),
    )
