"""Streaming processor: script text + cached voice prompt -> engine inputs.

Reference VibeVoiceStreamingProcessor
(reference vibevoice/processor/vibevoice_streaming_processor.py:24-421):
the streaming model consumes *precomputed* voice-prompt KV caches; the
processor tokenizes the script (with a trailing newline) and reports the
cached prompt lengths. The reference builds pseudo pad-id input sequences so
HF's generation bookkeeping lines up (reference :233-240); here the native
engine tracks per-sample cache lengths directly so only `tts_text_ids` and
the prompt lengths are needed — the pseudo ids are still returned for API
parity.

Full public surface parity: `from_pretrained`/`save_pretrained` (:60-168),
`process_input_with_cached_prompt` (:180-261), `prepare_speech_inputs`
(:327-375), `decode`/`batch_decode` (:376-398), `save_audio` (:399-421),
`model_input_names` (:392-398 property).

The port's own copy of vibevoice_tpu/processor/streaming_processor.py;
``cached_prompt`` may be the port's models.streaming.VoicePreset, and
``return_tensors`` takes "np", "pt" or None here (no "jax").
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np

from .audio import VibeVoiceTokenizerProcessor
from .text_tokenizer import FallbackTextTokenizer


@dataclass
class StreamingProcessorOutput:
    input_ids: np.ndarray  # (1, L_lm) pseudo pad ids
    attention_mask: np.ndarray
    tts_lm_input_ids: np.ndarray  # (1, L_tts) pseudo pad ids
    tts_lm_attention_mask: np.ndarray
    tts_text_ids: np.ndarray  # (1, n) script tokens
    speech_input_mask: np.ndarray


class VibeVoiceStreamingProcessor:
    def __init__(
        self,
        tokenizer=None,
        audio_processor: Optional[VibeVoiceTokenizerProcessor] = None,
        speech_tok_compress_ratio: int = 3200,
        db_normalize: bool = True,
    ):
        self.tokenizer = tokenizer or FallbackTextTokenizer()
        self.audio_processor = audio_processor or VibeVoiceTokenizerProcessor()
        self.speech_tok_compress_ratio = speech_tok_compress_ratio
        self.db_normalize = db_normalize

    @classmethod
    def from_pretrained(cls, path: str, **kwargs) -> "VibeVoiceStreamingProcessor":
        """Reads preprocessor_config.json + the text tokenizer through the
        shared loader (same loud-failure policy as VibeVoiceProcessor on real
        checkpoints without tokenizer files; reference :60-133)."""
        from .processor import VibeVoiceProcessor

        base = VibeVoiceProcessor.from_pretrained(path, **kwargs)
        return cls(
            tokenizer=base.tokenizer,
            audio_processor=base.audio_processor,
            speech_tok_compress_ratio=base.speech_tok_compress_ratio,
            db_normalize=base.db_normalize,
        )

    def save_pretrained(self, save_directory: str, **kwargs) -> None:
        """Write preprocessor_config.json so from_pretrained round-trips
        (reference :135-168)."""
        os.makedirs(save_directory, exist_ok=True)
        config = {
            "processor_class": "VibeVoiceStreamingProcessor",
            "speech_tok_compress_ratio": self.speech_tok_compress_ratio,
            "db_normalize": self.db_normalize,
            "audio_processor": {
                "feature_extractor_type": "VibeVoiceTokenizerProcessor",
                "sampling_rate": getattr(self.audio_processor, "sampling_rate", 24000),
                "normalize_audio": getattr(self.audio_processor, "normalize_audio", True),
                "target_dB_FS": getattr(
                    getattr(self.audio_processor, "normalizer", None), "target_dB_FS", -25
                ),
            },
        }
        with open(os.path.join(save_directory, "preprocessor_config.json"), "w") as f:
            json.dump(config, f, indent=2)

    def __call__(self, *args, **kwargs):
        raise NotImplementedError(
            "VibeVoiceStreamingProcessor.__call__ is not implemented; use "
            "process_input_with_cached_prompt for streaming inputs "
            "(reference vibevoice_streaming_processor.py:169-178)."
        )

    def process_input_with_cached_prompt(
        self,
        text: str,
        cached_prompt: Any,
        **kwargs,
    ) -> StreamingProcessorOutput:
        """`cached_prompt` may be a models.streaming.VoicePreset or the
        reference's dict schema {'lm': {'last_hidden_state': ...}, ...}."""
        script_tokens = self.tokenizer.encode(text.strip() + "\n")

        if hasattr(cached_prompt, "lm_kv"):  # VoicePreset
            lm_len = int(np.asarray(cached_prompt.lm_kv[2]).reshape(-1)[0])
            tts_len = int(np.asarray(cached_prompt.tts_kv[2]).reshape(-1)[0])
        else:
            lm_len = cached_prompt["lm"]["last_hidden_state"].shape[1]
            tts_len = cached_prompt["tts_lm"]["last_hidden_state"].shape[1]

        pad = getattr(self.tokenizer, "pad_id", 0)
        return StreamingProcessorOutput(
            input_ids=np.full((1, lm_len), pad, np.int64),
            attention_mask=np.ones((1, lm_len), np.bool_),
            tts_lm_input_ids=np.full((1, tts_len), pad, np.int64),
            tts_lm_attention_mask=np.ones((1, tts_len), np.bool_),
            tts_text_ids=np.asarray([script_tokens], np.int64),
            speech_input_mask=np.zeros((1, tts_len), np.bool_),
        )

    def prepare_speech_inputs(
        self,
        speech_inputs: List[np.ndarray],
        return_tensors: Optional[str] = None,
    ) -> Dict[str, Any]:
        """Pad waveforms + latent-frame masks (reference :327-375).
        return_tensors: None/"np" -> numpy, "pt" -> torch."""
        if not speech_inputs:
            return {"padded_speeches": None, "speech_masks": None}
        frame_lens = [
            math.ceil(s.shape[0] / self.speech_tok_compress_ratio) for s in speech_inputs
        ]
        max_wav = max(s.shape[0] for s in speech_inputs)
        if speech_inputs[0].ndim == 1:
            padded = np.zeros((len(speech_inputs), max_wav), np.float32)
        else:
            padded = np.zeros(
                (len(speech_inputs), max_wav, speech_inputs[0].shape[-1]), np.float32
            )
        masks = np.zeros((len(speech_inputs), max(frame_lens)), np.bool_)
        for i, (s, fl) in enumerate(zip(speech_inputs, frame_lens)):
            padded[i, : len(s)] = s
            masks[i, :fl] = True
        if return_tensors == "pt":
            import torch

            return {
                "padded_speeches": torch.from_numpy(padded),
                "speech_masks": torch.from_numpy(masks),
            }
        return {"padded_speeches": padded, "speech_masks": masks}

    # ------------------------------------------------------------------
    # Tokenizer / audio passthroughs (reference :376-421)
    # ------------------------------------------------------------------

    def decode(self, *args, **kwargs):
        return self.tokenizer.decode(*args, **kwargs)

    def batch_decode(self, sequences, **kwargs):
        if hasattr(self.tokenizer, "hf") and hasattr(self.tokenizer.hf, "batch_decode"):
            return self.tokenizer.hf.batch_decode(sequences, **kwargs)
        return [self.tokenizer.decode(s, **kwargs) for s in sequences]

    def save_audio(
        self,
        audio,
        output_path: str = "output.wav",
        sampling_rate: Optional[int] = None,
        normalize: bool = False,
        batch_prefix: str = "audio_",
    ) -> str:
        return self.audio_processor.save_audio(
            audio,
            output_path=output_path,
            sampling_rate=sampling_rate,
            normalize=normalize,
            batch_prefix=batch_prefix,
        )

    @property
    def model_input_names(self) -> List[str]:
        tok = getattr(self.tokenizer, "model_input_names", ["input_ids", "attention_mask"])
        aud = getattr(self.audio_processor, "model_input_names", ["audio"])
        return list(dict.fromkeys(list(tok) + list(aud) + ["speech_inputs", "speech_input_mask"]))
