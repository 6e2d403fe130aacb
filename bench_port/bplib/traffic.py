"""The traffic generator: one open-loop schedule of requests from a mix's
parameters (a ``traffic/<name>.json`` file) and the run's seed.

The sizes and the gaps between arrivals of each phase (warm, window, tail)
are drawn once from the mix's own ``population_seed``, in that order, and
rescaled so that the phase lasts exactly its seconds at the mix's rate: one
Poisson schedule that every run replays. The run's seed draws the contents
(text ids, voices, the request's own seed). Runs of different seeds
therefore differ by content, not by load: the tail of a few tens of
requests is not at the mercy of which of them happen to collide.

A request is laid out as the port's processor lays out a prompt
(``VibeVoiceProcessor._process_single``): system prompt, " Voice input:\\n",
per speaker " Speaker k:" <speech_start> N x <speech_diffusion>
<speech_end> "\\n" with N = ceil(samples / hop), " Text input:\\n", the
script's lines " Speaker k: text\\n", " Speech output:\\n" <speech_start>.
The fixed phrases are fixed id sequences; text ids are drawn below the
special ids.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

import numpy as np

from . import spec as sp

TEXT_ID_MAX = 150_000  # text ids stay below the Qwen special ids (151643 on)
PHRASES = {"system": 24, "voice_input": 4, "speaker": 3, "newline": 1, "text_input": 4,
           "speech_output": 4}
VOICE_BANK = 16
TARGET_RMS = 10 ** (-25 / 20)  # the processor's -25 dBFS normalisation


@dataclass
class Request:
    due: float  # seconds after the traffic starts
    phase: str  # "warm", "window" or "tail"
    input_ids: np.ndarray  # (T,) int64
    speech_mask: np.ndarray  # (T,) bool: the voice placeholders
    voices: List[np.ndarray]  # per speaker, float32 at 24 kHz
    frames: int  # frames of audio asked for
    seed: int  # the request's own seed (its voice prompt's VAE draws)


def load(path) -> Dict:
    return json.loads(Path(path).read_text())


def _lognormal(rng, n, d):
    v = np.exp(rng.normal(math.log(d["median"]), d["sigma"], n))
    return np.clip(np.round(v), d["min"], d["max"]).astype(np.int64)


def _phase(mix: Dict, rate: float, seconds: float, salt: int):
    """The sizes and gaps of a phase, fixed by the mix (not the run)."""
    n = max(1, int(round(rate * seconds)))
    rng = np.random.default_rng([mix["population_seed"], salt])
    gaps = rng.exponential(1.0 / rate, n)
    gaps *= seconds / gaps.sum()
    lo, hi = mix["voice_seconds"]
    voice_s = rng.uniform(lo, hi, (n, mix["speakers"]))
    script = _lognormal(rng, n, mix["script_tokens"])
    frames = _lognormal(rng, n, mix["frames"])
    lines = rng.integers(2, 5, n)  # the script's lines, speakers alternating
    return gaps, voice_s, script, frames, lines


def _phrases() -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(0)
    return {k: rng.integers(10, TEXT_ID_MAX, n) for k, n in PHRASES.items()}


def _voice_bank(rng, seconds: float) -> List[np.ndarray]:
    """Voiced waveforms: a few harmonics of a drifting pitch, a little
    noise, at the processor's loudness."""
    t = np.arange(int(seconds * sp.SAMPLE_RATE)) / sp.SAMPLE_RATE
    bank = []
    for _ in range(VOICE_BANK):
        f0 = rng.uniform(90, 260) * (1 + 0.05 * np.sin(2 * np.pi * rng.uniform(0.2, 1.0) * t))
        phase = 2 * np.pi * np.cumsum(f0) / sp.SAMPLE_RATE
        w = sum(rng.uniform(0.2, 1.0) / k * np.sin(k * phase) for k in range(1, 6))
        w = w + 0.05 * rng.standard_normal(t.size)
        bank.append((w * TARGET_RMS / np.sqrt(np.mean(w ** 2))).astype(np.float32))
    return bank


def layout(script_ids: List[np.ndarray], voices: List[np.ndarray], hop: int,
           phrases: Dict[str, np.ndarray]):
    """(input_ids, speech_mask) of one prompt: ``script_ids`` holds each
    line's text ids, speakers alternating."""
    ids, mask = [phrases["system"], phrases["voice_input"]], []
    for v in voices:
        n = math.ceil(len(v) / hop)
        ids += [phrases["speaker"], [sp.SPEECH_START], [sp.SPEECH_DIFFUSION] * n,
                [sp.SPEECH_END], phrases["newline"]]
    ids.append(phrases["text_input"])
    for line in script_ids:
        ids += [phrases["speaker"], line, phrases["newline"]]
    ids += [phrases["speech_output"], [sp.SPEECH_START]]
    flat = np.concatenate([np.asarray(x, np.int64) for x in ids])
    mask = flat == sp.SPEECH_DIFFUSION
    return flat, mask


def schedule(mix: Dict, seed: int, window_s: float, hop: int, rate: float = None) -> List[Request]:
    """The run's requests in order of arrival: the warm phase, the window
    (``window_s`` seconds) and a tail that keeps the load on while the
    window's last requests finish."""
    rate = float(mix["rate_per_s"] if rate is None else rate)
    rng = np.random.default_rng([seed, 1])
    bank = _voice_bank(rng, mix["voice_seconds"][1])
    phrases = _phrases()
    out, t0 = [], 0.0
    for salt, (phase, secs) in enumerate((("warm", mix["warm_seconds"]), ("window", window_s),
                                          ("tail", mix["tail_seconds"]))):
        gaps, voice_s, script, frames, lines = _phase(mix, rate, secs, salt)
        due = t0 + np.cumsum(gaps) - gaps[0]
        for j in range(len(gaps)):
            voices = [bank[k][: int(s * sp.SAMPLE_RATE)]
                      for k, s in zip(rng.choice(VOICE_BANK, mix["speakers"], replace=False),
                                      voice_s[j])]
            cuts = np.sort(rng.choice(np.arange(1, script[j]), lines[j] - 1, replace=False))
            text = rng.integers(10, TEXT_ID_MAX, script[j])
            ids, mask = layout(np.split(text, cuts), voices, hop, phrases)
            out.append(Request(float(due[j]), phase, ids, mask, voices, int(frames[j]),
                               int(rng.integers(0, 2 ** 31))))
        t0 += secs
    return out
