"""Configuration dataclasses of the PyTorch port (the port's own copy of
vibevoice_tpu/configs.py, field for field, so that the port imports nothing
of the JAX package; tests/test_torch_configs.py holds the two equal).

These mirror the reference's JSON config schema so that shipped checkpoints'
``config.json`` files load unmodified (reference:
vibevoice/modular/configuration_vibevoice.py:13-241 and
configuration_vibevoice_streaming.py:13-92), while being plain frozen
dataclasses that are hashable.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple


def _parse_depths(depths) -> Tuple[int, ...]:
    if isinstance(depths, str):
        return tuple(int(d) for d in depths.split("-"))
    return tuple(depths)


@dataclass(frozen=True)
class AcousticTokenizerConfig:
    """σ-VAE acoustic tokenizer config (reference configuration_vibevoice.py:13-73)."""

    channels: int = 1
    corpus_normalize: float = 0.0
    causal: bool = True
    vae_dim: int = 64
    fix_std: float = 0.5
    std_dist_type: str = "gaussian"
    mixer_layer: str = "depthwise_conv"
    conv_norm: str = "none"
    pad_mode: str = "constant"
    disable_last_norm: bool = True
    layernorm: str = "RMSNorm"
    layernorm_eps: float = 1e-5
    layernorm_elementwise_affine: bool = True
    conv_bias: bool = True
    layer_scale_init_value: float = 1e-6
    weight_init_value: float = 1e-2
    encoder_n_filters: int = 32
    encoder_ratios: Tuple[int, ...] = (8, 5, 5, 4, 2, 2)
    encoder_depths: Tuple[int, ...] = (3, 3, 3, 3, 3, 3, 8)
    decoder_n_filters: int = 32
    decoder_ratios: Optional[Tuple[int, ...]] = None
    decoder_depths: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        object.__setattr__(self, "encoder_ratios", tuple(self.encoder_ratios))
        object.__setattr__(self, "encoder_depths", _parse_depths(self.encoder_depths))
        if self.decoder_ratios is not None:
            object.__setattr__(self, "decoder_ratios", tuple(self.decoder_ratios))
        if self.decoder_depths is not None:
            object.__setattr__(self, "decoder_depths", _parse_depths(self.decoder_depths))
        # weight_norm/spectral_norm checkpoints are folded exactly at load
        # (utils/torch_convert._raw_conv_weight); the module-norm variants
        # would need per-conv norm layers nothing ships — fail loudly
        if self.conv_norm not in ("none", "weight_norm", "spectral_norm"):
            raise NotImplementedError(
                f"conv_norm={self.conv_norm!r} (per-conv norm modules) is not supported"
            )
        if not self.causal:
            raise NotImplementedError(
                "non-causal tokenizers are not supported (streaming decode "
                "requires causal convs; shipped configs are causal)"
            )

    @property
    def resolved_decoder_ratios(self) -> Tuple[int, ...]:
        return self.decoder_ratios if self.decoder_ratios is not None else self.encoder_ratios

    @property
    def resolved_decoder_depths(self) -> Tuple[int, ...]:
        # Decoder defaults to reversed encoder depths
        # (reference modular_vibevoice_tokenizer.py:1024-1028).
        if self.decoder_depths is not None:
            return self.decoder_depths
        return tuple(reversed(self.encoder_depths))

    @property
    def hop_length(self) -> int:
        hop = 1
        for r in self.encoder_ratios:
            hop *= r
        return hop

    @classmethod
    def from_dict(cls, d: dict) -> "AcousticTokenizerConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclass(frozen=True)
class SemanticTokenizerConfig:
    """Semantic tokenizer (encoder-only, deterministic) config
    (reference configuration_vibevoice.py:76-127)."""

    channels: int = 1
    corpus_normalize: float = 0.0
    causal: bool = True
    vae_dim: int = 64  # shipped full configs use 128
    fix_std: float = 0.0
    std_dist_type: str = "none"
    mixer_layer: str = "depthwise_conv"
    conv_norm: str = "none"
    pad_mode: str = "constant"
    disable_last_norm: bool = True
    layernorm: str = "RMSNorm"
    layernorm_eps: float = 1e-5
    layernorm_elementwise_affine: bool = True
    conv_bias: bool = True
    layer_scale_init_value: float = 1e-6
    weight_init_value: float = 1e-2
    encoder_n_filters: int = 32
    encoder_ratios: Tuple[int, ...] = (8, 5, 5, 4, 2, 2)
    encoder_depths: Tuple[int, ...] = (3, 3, 3, 3, 3, 3, 8)

    def __post_init__(self):
        object.__setattr__(self, "encoder_ratios", tuple(self.encoder_ratios))
        object.__setattr__(self, "encoder_depths", _parse_depths(self.encoder_depths))
        if self.conv_norm not in ("none", "weight_norm", "spectral_norm"):
            raise NotImplementedError(
                f"conv_norm={self.conv_norm!r} (per-conv norm modules) is not supported"
            )
        if not self.causal:
            raise NotImplementedError(
                "non-causal tokenizers are not supported (streaming decode "
                "requires causal convs; shipped configs are causal)"
            )

    @property
    def hop_length(self) -> int:
        hop = 1
        for r in self.encoder_ratios:
            hop *= r
        return hop

    @classmethod
    def from_dict(cls, d: dict) -> "SemanticTokenizerConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclass(frozen=True)
class DiffusionHeadConfig:
    """Per-token diffusion head config (reference configuration_vibevoice.py:130-162)."""

    hidden_size: int = 768
    head_layers: int = 4
    head_ffn_ratio: float = 3.0
    rms_norm_eps: float = 1e-5
    latent_size: int = 64
    speech_vae_dim: Optional[int] = None
    prediction_type: str = "v_prediction"
    diffusion_type: str = "ddpm"
    ddpm_num_steps: int = 1000
    ddpm_num_inference_steps: int = 20
    ddpm_beta_schedule: str = "cosine"
    ddpm_batch_mul: int = 4

    @property
    def ffn_dim(self) -> int:
        return int(self.hidden_size * self.head_ffn_ratio)

    @classmethod
    def from_dict(cls, d: dict) -> "DiffusionHeadConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclass(frozen=True)
class Qwen2Config:
    """Qwen2 decoder LM config — the fields of HF's Qwen2Config that the model
    math depends on (reference configs/qwen2.5_1.5b_64k.json decoder_config)."""

    vocab_size: int = 151936
    hidden_size: int = 1536
    intermediate_size: int = 8960
    num_hidden_layers: int = 28
    num_attention_heads: int = 12
    num_key_value_heads: int = 2
    max_position_embeddings: int = 65536
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    tie_word_embeddings: bool = True
    hidden_act: str = "silu"
    attention_dropout: float = 0.0
    initializer_range: float = 0.02

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def from_dict(cls, d: dict) -> "Qwen2Config":
        # all VibeVoice checkpoints ship use_sliding_window=false; silently
        # running full attention on a sliding-window checkpoint would
        # diverge, so reject it loudly
        if d.get("use_sliding_window"):
            raise NotImplementedError("sliding-window attention is not supported")
        if d.get("hidden_act", "silu") != "silu":
            raise NotImplementedError(f"hidden_act={d['hidden_act']!r} not supported")
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclass(frozen=True)
class VibeVoiceConfig:
    """Composite model config (reference configuration_vibevoice.py:164-241)."""

    acoustic_tokenizer_config: AcousticTokenizerConfig = field(
        default_factory=AcousticTokenizerConfig
    )
    semantic_tokenizer_config: SemanticTokenizerConfig = field(
        default_factory=SemanticTokenizerConfig
    )
    decoder_config: Qwen2Config = field(default_factory=Qwen2Config)
    diffusion_head_config: DiffusionHeadConfig = field(default_factory=DiffusionHeadConfig)

    @property
    def acoustic_vae_dim(self) -> int:
        return self.acoustic_tokenizer_config.vae_dim

    @property
    def semantic_vae_dim(self) -> int:
        return self.semantic_tokenizer_config.vae_dim

    @classmethod
    def from_dict(cls, d: dict) -> "VibeVoiceConfig":
        return cls(
            acoustic_tokenizer_config=AcousticTokenizerConfig.from_dict(
                d.get("acoustic_tokenizer_config", {}) or {}
            ),
            semantic_tokenizer_config=SemanticTokenizerConfig.from_dict(
                d.get("semantic_tokenizer_config", {}) or {}
            ),
            decoder_config=Qwen2Config.from_dict(d.get("decoder_config", {}) or {}),
            diffusion_head_config=DiffusionHeadConfig.from_dict(
                d.get("diffusion_head_config", {}) or {}
            ),
        )

    @classmethod
    def from_json_file(cls, path: str) -> "VibeVoiceConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))


@dataclass(frozen=True)
class VibeVoiceStreamingConfig:
    """Streaming 0.5B model config (reference configuration_vibevoice_streaming.py:13-92).

    The Qwen2 stack is split: the lower ``num_hidden_layers - tts_backbone_num_hidden_layers``
    layers form the text LM (final norm removed) and the upper
    ``tts_backbone_num_hidden_layers`` layers form the TTS backbone.
    """

    acoustic_tokenizer_config: AcousticTokenizerConfig = field(
        default_factory=AcousticTokenizerConfig
    )
    decoder_config: Qwen2Config = field(default_factory=Qwen2Config)
    diffusion_head_config: DiffusionHeadConfig = field(default_factory=DiffusionHeadConfig)
    tts_backbone_num_hidden_layers: int = 20

    @property
    def acoustic_vae_dim(self) -> int:
        return self.acoustic_tokenizer_config.vae_dim

    @property
    def lm_num_hidden_layers(self) -> int:
        return self.decoder_config.num_hidden_layers - self.tts_backbone_num_hidden_layers

    @classmethod
    def from_dict(cls, d: dict) -> "VibeVoiceStreamingConfig":
        return cls(
            acoustic_tokenizer_config=AcousticTokenizerConfig.from_dict(
                d.get("acoustic_tokenizer_config", {}) or {}
            ),
            decoder_config=Qwen2Config.from_dict(d.get("decoder_config", {}) or {}),
            diffusion_head_config=DiffusionHeadConfig.from_dict(
                d.get("diffusion_head_config", {}) or {}
            ),
            tts_backbone_num_hidden_layers=d.get("tts_backbone_num_hidden_layers", 20),
        )

    @classmethod
    def from_json_file(cls, path: str) -> "VibeVoiceStreamingConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))


def tiny_config(
    *,
    hidden_size: int = 64,
    num_hidden_layers: int = 2,
    vocab_size: int = 1024,
    n_filters: int = 4,
    ratios: Tuple[int, ...] = (4, 2),
    depths: Tuple[int, ...] = (1, 1, 2),
    vae_dim: int = 16,
    semantic_vae_dim: int = 16,
) -> VibeVoiceConfig:
    """A miniature config used across the test-suite (fast on CPU)."""
    return VibeVoiceConfig(
        acoustic_tokenizer_config=AcousticTokenizerConfig(
            vae_dim=vae_dim,
            encoder_n_filters=n_filters,
            encoder_ratios=ratios,
            encoder_depths=depths,
            decoder_n_filters=n_filters,
        ),
        semantic_tokenizer_config=SemanticTokenizerConfig(
            vae_dim=semantic_vae_dim,
            encoder_n_filters=n_filters,
            encoder_ratios=ratios,
            encoder_depths=depths,
        ),
        decoder_config=Qwen2Config(
            vocab_size=vocab_size,
            hidden_size=hidden_size,
            intermediate_size=hidden_size * 4,
            num_hidden_layers=num_hidden_layers,
            num_attention_heads=4,
            num_key_value_heads=2,
            max_position_embeddings=2048,
            rope_theta=10_000.0,
        ),
        diffusion_head_config=DiffusionHeadConfig(
            hidden_size=hidden_size,
            head_layers=2,
            latent_size=vae_dim,
        ),
    )
