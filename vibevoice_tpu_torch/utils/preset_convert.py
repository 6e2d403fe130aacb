"""Convert reference streaming voice presets (``.pt``) to the port's
VoicePreset (port of vibevoice_tpu/utils/preset_convert.py).

The reference ``.pt`` schema (reference demo/streaming_inference_from_file.py:288-291,
vibevoice_streaming_processor.py:233-240) is a dict with keys
'lm'/'tts_lm'/'neg_lm'/'neg_tts_lm', each holding 'last_hidden_state'
(B, S, H) and 'past_key_values' (HF cache: per-layer (k, v) of shape
(B, KH, S, D), a list of pairs or a transformers DynamicCache).
"""

from __future__ import annotations

import numpy as np
import torch


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _stack_kv(past_key_values) -> tuple:
    """HF per-layer [(k, v)] with (B, KH, S, D) -> ((L, B, KH, S, D) k, v,
    (B,) int32 lengths), f32."""
    if getattr(past_key_values, "key_cache", None) is not None:  # DynamicCache
        pairs = zip(past_key_values.key_cache, past_key_values.value_cache)
    else:
        pairs = past_key_values
    ks, vs = zip(*((_host(k), _host(v)) for k, v in pairs))
    k, v = np.stack(ks), np.stack(vs)
    return k, v, np.full((k.shape[1],), k.shape[3], np.int32)


def convert_torch_preset(pt_path: str):
    """Load a reference .pt voice preset into a models.streaming.VoicePreset."""
    from ..models.streaming import VoicePreset

    d = torch.load(pt_path, map_location="cpu", weights_only=False)

    def h(stream):
        return _host(d[stream]["last_hidden_state"])[:, -1]

    return VoicePreset(
        lm_kv=_stack_kv(d["lm"]["past_key_values"]),
        tts_kv=_stack_kv(d["tts_lm"]["past_key_values"]),
        neg_tts_kv=_stack_kv(d["neg_tts_lm"]["past_key_values"]),
        lm_h=h("lm"),
        tts_h=h("tts_lm"),
        neg_tts_h=h("neg_tts_lm"),
    )
