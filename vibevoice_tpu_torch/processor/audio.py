"""Host-side audio I/O and normalization.

Equivalent of the reference's VibeVoiceTokenizerProcessor / AudioNormalizer
(reference vibevoice/processor/vibevoice_tokenizer_processor.py:19-480) built
on stdlib `wave` + scipy (librosa/soundfile are not available in this image;
non-WAV formats are loaded through soundfile when importable).

The port's copy of vibevoice_tpu/processor/audio.py. It always takes the
numpy/scipy paths, which the JAX package also takes where its optional
native DSP library (native/, `make -C native`) is not built.
"""

from __future__ import annotations

import math
import os
import wave
from typing import List, Optional, Union

import numpy as np

TARGET_SAMPLE_RATE = 24_000


class AudioNormalizer:
    """dB-FS normalization to -25 dB followed by anti-clipping scaling
    (reference vibevoice_tokenizer_processor.py:19-87)."""

    def __init__(self, target_dB_FS: float = -25.0, eps: float = 1e-6):
        self.target_dB_FS = target_dB_FS
        self.eps = eps

    def tailor_dB_FS(self, audio: np.ndarray):
        rms = np.sqrt(np.mean(audio**2))
        scalar = 10 ** (self.target_dB_FS / 20) / (rms + self.eps)
        return audio * scalar, rms, scalar

    def avoid_clipping(self, audio: np.ndarray):
        max_val = np.max(np.abs(audio)) if audio.size else 0.0
        scalar = max_val + self.eps if max_val > 1.0 else 1.0
        return audio / scalar, scalar

    def __call__(self, audio: np.ndarray) -> np.ndarray:
        audio, _, _ = self.tailor_dB_FS(audio)
        audio, _ = self.avoid_clipping(audio)
        return audio


def resample(audio: np.ndarray, orig_sr: int, target_sr: int = TARGET_SAMPLE_RATE) -> np.ndarray:
    if orig_sr == target_sr:
        return audio
    from scipy.signal import resample_poly

    g = math.gcd(orig_sr, target_sr)
    return resample_poly(audio, target_sr // g, orig_sr // g).astype(np.float32)


def to_mono(audio: np.ndarray) -> np.ndarray:
    """Average channels (reference :135-161)."""
    if audio.ndim == 1:
        return audio
    # channels on the smaller axis
    if audio.shape[0] < audio.shape[-1]:
        return audio.mean(axis=0)
    return audio.mean(axis=-1)


def read_wav(path: str) -> tuple:
    """Read a PCM/float WAV via stdlib. Returns (float32 mono array, sr)."""
    with wave.open(path, "rb") as f:
        sr = f.getframerate()
        n = f.getnframes()
        ch = f.getnchannels()
        width = f.getsampwidth()
        raw = f.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype=np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width {width}")
    if ch > 1:
        data = data.reshape(-1, ch).mean(axis=1)
    return data, sr


def write_wav(path: str, audio: np.ndarray, sample_rate: int = TARGET_SAMPLE_RATE) -> None:
    audio = np.clip(np.asarray(audio, np.float32), -1.0, 1.0)
    pcm = (audio * 32767.0).astype(np.int16)
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm.tobytes())


def load_audio(path: str, target_sr: int = TARGET_SAMPLE_RATE) -> np.ndarray:
    """Load audio from wav/npy/pt paths, resampled to 24 kHz mono
    (reference :271-309)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        return np.load(path).astype(np.float32)
    if ext == ".pt":
        import torch

        t = torch.load(path, map_location="cpu", weights_only=False)
        return np.asarray(t, dtype=np.float32)
    if ext == ".wav":
        data, sr = read_wav(path)
        return resample(data, sr, target_sr)
    try:
        import soundfile as sf

        data, sr = sf.read(path, dtype="float32")
        return resample(to_mono(data), sr, target_sr)
    except ImportError as e:
        raise ValueError(
            f"format {ext} requires the optional soundfile dependency (unavailable): {path}"
        ) from e


class VibeVoiceTokenizerProcessor:
    """Batch audio front-end: mono-ize, normalize, stack
    (reference vibevoice_tokenizer_processor.py:91-480)."""

    def __init__(
        self,
        sampling_rate: int = TARGET_SAMPLE_RATE,
        normalize_audio: bool = True,
        target_dB_FS: float = -25.0,
        eps: float = 1e-6,
    ):
        self.sampling_rate = sampling_rate
        self.normalize_audio = normalize_audio
        self.normalizer = AudioNormalizer(target_dB_FS, eps) if normalize_audio else None

    def _load_audio_from_path(self, path: str) -> np.ndarray:
        return load_audio(path, self.sampling_rate)

    def __call__(self, audio: Union[np.ndarray, List[np.ndarray], str, List[str]]):
        items = audio if isinstance(audio, list) else [audio]
        out = []
        for a in items:
            wav = self._load_audio_from_path(a) if isinstance(a, str) else np.asarray(a, np.float32)
            wav = to_mono(wav)
            if self.normalizer is not None:
                wav = self.normalizer(wav)
            out.append(wav.astype(np.float32))
        max_len = max(len(w) for w in out)
        batch = np.zeros((len(out), 1, max_len), np.float32)
        for i, w in enumerate(out):
            batch[i, 0, : len(w)] = w
        return {"audio": batch}

    def save_audio(
        self,
        audio,
        output_path: str = "output.wav",
        sampling_rate: Optional[int] = None,
        normalize: bool = False,
        batch_prefix: str = "audio_",
    ) -> Union[str, List[str]]:
        """Write waveform(s) to WAV (reference :352-457); normalize=True
        applies the dB-FS normalizer before writing (reference :381-384)."""
        sr = sampling_rate or self.sampling_rate
        arr = np.asarray(audio)
        if normalize:
            norm = self.normalizer or AudioNormalizer()
            arr = norm(arr)
        if arr.ndim > 1 and arr.shape[0] > 1:
            os.makedirs(output_path, exist_ok=True)
            paths = []
            for i, a in enumerate(arr):
                p = os.path.join(output_path, f"{batch_prefix}{i}.wav")
                write_wav(p, np.squeeze(a), sr)
                paths.append(p)
            return paths
        write_wav(output_path, np.squeeze(arr), sr)
        return output_path
