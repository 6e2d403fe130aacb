"""Fine-tuning dataset and collator (port of vibevoice_tpu/finetune/data.py).

The dataset and collator are numpy and give the same arrays as the JAX
package's for the same raw items and seed:

* a 5-15 s voice prompt cropped from the target audio when none is given;
* 0.25 s lead / 0.75 s tail silence with linear crossfades on the target;
* prompt tokens + target latent placeholders + <speech_end> + eos, with
  acoustic_input_mask (voice + target) and acoustic_loss_mask (target);
* a hard error when truncation would cut into acoustic tokens;
* semantic features from the port's semantic encoder
  (``make_semantic_encode_fn``).
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..configs import SemanticTokenizerConfig

from .loss import Batch

SAMPLE_RATE = 24_000


def load_audio_to_24k(audio, target_sr: int = SAMPLE_RATE) -> np.ndarray:
    from ..processor.audio import load_audio, resample, to_mono

    if isinstance(audio, str):
        return load_audio(audio, target_sr)
    if isinstance(audio, dict):
        arr = np.asarray(audio.get("array", audio.get("audio")), np.float32)
        sr = int(audio.get("sampling_rate", target_sr))
        return resample(to_mono(arr), sr, target_sr)
    return to_mono(np.asarray(audio, np.float32))


def apply_silence_with_crossfade(
    wav: np.ndarray,
    *,
    sample_rate: int = SAMPLE_RATE,
    pre_silence_sec: float = 0.25,
    pre_crossfade_sec: float = 0.25,
    post_crossfade_sec: float = 0.25,
    post_silence_sec: float = 0.75,
) -> np.ndarray:
    """Pad target audio with silence, fading the boundaries."""
    wav = wav.astype(np.float32).copy()
    pre_fade = min(int(pre_crossfade_sec * sample_rate), len(wav))
    post_fade = min(int(post_crossfade_sec * sample_rate), len(wav))
    if pre_fade > 0:
        wav[:pre_fade] *= np.linspace(0.0, 1.0, pre_fade, dtype=np.float32)
    if post_fade > 0:
        wav[-post_fade:] *= np.linspace(1.0, 0.0, post_fade, dtype=np.float32)
    pre = np.zeros(int(pre_silence_sec * sample_rate), np.float32)
    post = np.zeros(int(post_silence_sec * sample_rate), np.float32)
    return np.concatenate([pre, wav, post])


class VibeVoiceDataset:
    """Wraps any indexable dataset of {text, audio[, voice_prompts]}."""

    def __init__(self, dataset: Any, text_column: str = "text", audio_column: str = "audio",
                 voice_prompts_column: Optional[str] = "voice_prompts", seed: int = 0):
        self.dataset = dataset
        self.text_column = text_column
        self.audio_column = audio_column
        self.voice_prompts_column = voice_prompts_column
        self.rng = random.Random(seed)

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        item = self.dataset[idx]
        data = {"text": item[self.text_column], "audio": item[self.audio_column]}
        prompt = item.get(self.voice_prompts_column) if self.voice_prompts_column else None
        if prompt:
            data["voice_prompts"] = prompt if isinstance(prompt, list) else [prompt]
            return data
        # auto-crop a 5-15 s voice prompt from the target audio
        wav = load_audio_to_24k(item[self.audio_column])
        dur = len(wav) / SAMPLE_RATE
        min_s = min(5.0, dur / 4.0)
        max_s = min(15.0, dur / 2.0, dur)
        if min_s > max_s:
            min_s = max_s
        if max_s > 0.1:
            n = int(self.rng.uniform(min_s, max_s) * SAMPLE_RATE)
            start = self.rng.randint(0, max(len(wav) - n, 0))
            data["voice_prompts"] = [wav[start : start + n]]
        else:
            data["voice_prompts"] = None
        return data


@dataclass
class VibeVoiceCollator:
    processor: Any  # VibeVoiceProcessor
    semantic_encode_fn: Optional[Any] = None  # wav (N, T, 1) -> (N, F, D)
    max_length: Optional[int] = None
    speech_compress_ratio: int = 3200
    semantic_vae_dim: int = 128
    voice_prompt_drop_rate: float = 0.0
    pad_to_multiple: Optional[int] = None
    pre_silence_sec: float = 0.25
    post_silence_sec: float = 0.75
    crossfade_sec: float = 0.25
    seed: int = 0

    def __post_init__(self):
        self._rng = random.Random(self.seed)

    def __call__(self, features: Sequence[Dict[str, Any]]) -> Batch:
        tok = self.processor.tokenizer
        ids_list, ain_list, aloss_list = [], [], []
        wavs: List[np.ndarray] = []
        latent_lens: List[int] = []
        is_target: List[bool] = []

        for ex in features:
            prompts = ex.get("voice_prompts")
            if prompts is not None and self._rng.random() < self.voice_prompt_drop_rate:
                prompts = None
            proc = self.processor(
                text=[ex["text"]], voice_samples=[prompts] if prompts is not None else None
            )
            ids = proc.input_ids[0].tolist()
            sim = proc.speech_input_mask[0].tolist()

            wav_target = apply_silence_with_crossfade(
                load_audio_to_24k(ex["audio"]),
                pre_silence_sec=self.pre_silence_sec,
                post_silence_sec=self.post_silence_sec,
                pre_crossfade_sec=self.crossfade_sec,
                post_crossfade_sec=self.crossfade_sec,
            )
            target_latent_len = max(1, math.ceil(len(wav_target) / self.speech_compress_ratio))

            ids = ids + [tok.speech_diffusion_id] * target_latent_len + [tok.speech_end_id]
            ain = sim + [True] * target_latent_len + [False]
            aloss = [False] * len(sim) + [True] * target_latent_len + [False]
            eos = getattr(tok, "eos_token_id", None)
            if eos is not None and eos >= 0:
                ids.append(eos)
                ain.append(False)
                aloss.append(False)

            if self.max_length is not None and len(ids) > self.max_length:
                cut = len(ids) - self.max_length
                leading = next((i for i, v in enumerate(ain) if v), len(ain))
                if cut > leading:
                    raise ValueError(
                        f"max_length={self.max_length} would truncate into acoustic tokens "
                        f"(cut={cut} > leading non-acoustic={leading})"
                    )
                ids, ain, aloss = ids[cut:], ain[cut:], aloss[cut:]

            ids_list.append(ids)
            ain_list.append(ain)
            aloss_list.append(aloss)

            if proc.speech_tensors is not None:
                for seg, m in zip(proc.speech_tensors, proc.speech_masks):
                    wavs.append(np.asarray(seg, np.float32))
                    latent_lens.append(int(m.sum()))
                    is_target.append(False)
            wavs.append(wav_target)
            latent_lens.append(target_latent_len)
            is_target.append(True)

        max_t = max(len(x) for x in ids_list)
        if self.pad_to_multiple:
            max_t = -(-max_t // self.pad_to_multiple) * self.pad_to_multiple
        pad_id = getattr(tok, "pad_token_id", None)
        if pad_id is None or pad_id < 0:
            pad_id = tok.eos_token_id
        b = len(ids_list)
        input_ids = np.full((b, max_t), pad_id, np.int32)
        attn = np.zeros((b, max_t), np.bool_)
        ain_arr = np.zeros((b, max_t), np.bool_)
        aloss_arr = np.zeros((b, max_t), np.bool_)
        for i, (ids, ain, aloss) in enumerate(zip(ids_list, ain_list, aloss_list)):
            n = len(ids)
            input_ids[i, :n] = ids
            attn[i, :n] = True
            ain_arr[i, :n] = ain
            aloss_arr[i, :n] = aloss

        max_wav = max(len(w) for w in wavs)
        if self.pad_to_multiple:
            max_wav = -(-max_wav // self.speech_compress_ratio) * self.speech_compress_ratio
        n_seg = len(wavs)
        speech = np.zeros((n_seg, max_wav), np.float32)
        max_f = max(latent_lens)
        masks = np.zeros((n_seg, max_f), np.bool_)
        for i, (w, fl) in enumerate(zip(wavs, latent_lens)):
            speech[i, : len(w)] = w
            masks[i, :fl] = True

        if self.semantic_encode_fn is None:
            raise RuntimeError("Semantic features are required: pass semantic_encode_fn")
        sem = np.asarray(self.semantic_encode_fn(speech[..., None]))  # (N, F', D)
        d = sem.shape[-1]
        if d < self.semantic_vae_dim:
            sem = np.pad(sem, ((0, 0), (0, 0), (0, self.semantic_vae_dim - d)))
        elif d > self.semantic_vae_dim:
            sem = sem[..., : self.semantic_vae_dim]
        f = sem.shape[1]
        if f < max_f:
            sem = np.pad(sem, ((0, 0), (0, max_f - f), (0, 0)))
        elif f > max_f:
            sem = sem[:, :max_f]

        return Batch(
            input_ids=input_ids,
            attention_mask=attn,
            speech_tensors=speech,
            speech_masks=masks,
            speech_semantic_tensors=sem.astype(np.float32),
            speeches_loss_input=np.asarray(is_target, np.bool_),
            acoustic_input_mask=ain_arr,
            acoustic_loss_mask=aloss_arr,
        )


def make_semantic_encode_fn(cfg: SemanticTokenizerConfig, params):
    """Host-callable semantic encoder for the collator: numpy (N, T, 1) in,
    numpy (N, F, D) means out, computed on the parameters' device one clip
    at a time."""
    from ..models import tokenizer as tokmod

    leaves = []

    def first(tree):
        if isinstance(tree, dict):
            for v in tree.values():
                first(v)
        elif isinstance(tree, list):
            for v in tree:
                first(v)
        elif isinstance(tree, torch.Tensor) and not leaves:
            leaves.append(tree)

    first(params)
    dev, dtype = leaves[0].device, leaves[0].dtype

    def enc(wav: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(wav, np.float32)).to(dev, dtype)
        with torch.no_grad():
            means = [tokmod.encode(cfg, params, x[i:i + 1])[0] for i in range(x.shape[0])]
        return torch.cat(means).float().cpu().numpy()

    return enc
