"""Text tokenizer wrapper: Qwen2 BPE + speech control tokens.

The reference subclasses HF's Qwen2Tokenizer(Fast) and aliases Qwen2.5-VL
vision tokens as speech controls (reference
modular_vibevoice_text_tokenizer.py:12-208):

  <|vision_start|> -> speech_start,  <|vision_end|> -> speech_end,
  <|vision_pad|>   -> speech_diffusion,  pad -> <|image_pad|> (fast variant)

Here the wrapper composes any HF tokenizer (loaded from a local checkpoint —
this image has no network), and a self-contained whitespace fallback tokenizer
keeps the processor usable in tests and offline environments.

The port's own copy of vibevoice_tpu/processor/text_tokenizer.py.
"""

from __future__ import annotations

from typing import List, Optional

QWEN_SPECIAL_IDS = {
    "speech_start": 151652,
    "speech_end": 151653,
    "speech_diffusion": 151654,
    "pad": 151655,  # <|image_pad|> (reference :181)
    "eos": 151643,  # <|endoftext|>
}


class VibeVoiceTextTokenizer:
    """Wraps an HF tokenizer, exposing the reference's special-token surface
    (speech_start_id / speech_end_id / speech_diffusion_id / pad_id)."""

    def __init__(self, hf_tokenizer):
        self.hf = hf_tokenizer
        self.speech_start_id = self._tok_id("<|vision_start|>", QWEN_SPECIAL_IDS["speech_start"])
        self.speech_end_id = self._tok_id("<|vision_end|>", QWEN_SPECIAL_IDS["speech_end"])
        self.speech_diffusion_id = self._tok_id("<|vision_pad|>", QWEN_SPECIAL_IDS["speech_diffusion"])
        self.pad_id = self._tok_id("<|image_pad|>", QWEN_SPECIAL_IDS["pad"])
        self.eos_token_id = hf_tokenizer.eos_token_id
        self.bos_token_id = getattr(hf_tokenizer, "bos_token_id", None)
        self.pad_token_id = self.pad_id

    def _tok_id(self, token: str, default: int) -> int:
        try:
            tid = self.hf.convert_tokens_to_ids(token)
            return tid if tid is not None else default
        except Exception:
            return default

    @classmethod
    def from_pretrained(cls, path: str, **kwargs) -> "VibeVoiceTextTokenizer":
        from transformers import AutoTokenizer

        return cls(AutoTokenizer.from_pretrained(path, **kwargs))

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        return self.hf.encode(text, add_special_tokens=add_special_tokens)

    def decode(self, ids, **kwargs) -> str:
        return self.hf.decode(ids, **kwargs)

    def __len__(self):
        return len(self.hf)


class FallbackTextTokenizer:
    """Deterministic hash-bucket tokenizer for offline/test use. NOT a BPE —
    only suitable for exercising the pipeline with random-weight models."""

    def __init__(
        self,
        vocab_size: int = 1024,
        speech_start_id: Optional[int] = None,
        speech_end_id: Optional[int] = None,
        speech_diffusion_id: Optional[int] = None,
        eos_token_id: Optional[int] = None,
        pad_id: Optional[int] = None,
    ):
        self.vocab_size = vocab_size
        self.eos_token_id = eos_token_id if eos_token_id is not None else 2
        self.speech_start_id = speech_start_id if speech_start_id is not None else 5
        self.speech_end_id = speech_end_id if speech_end_id is not None else 6
        self.speech_diffusion_id = (
            speech_diffusion_id if speech_diffusion_id is not None else 7
        )
        self.pad_id = pad_id if pad_id is not None else 3
        self.pad_token_id = self.pad_id
        self.bos_token_id = None
        self._reserved = {
            self.eos_token_id,
            self.speech_start_id,
            self.speech_end_id,
            self.speech_diffusion_id,
            self.pad_id,
        }

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        ids = []
        for word in text.split():
            h = 10 + (hash(word) % (self.vocab_size - 10))
            while h in self._reserved:
                h = 10 + ((h + 1) % (self.vocab_size - 10))
            ids.append(h)
        return ids

    def decode(self, ids, **kwargs) -> str:
        return " ".join(f"<{i}>" for i in ids)

    def __len__(self):
        return self.vocab_size
