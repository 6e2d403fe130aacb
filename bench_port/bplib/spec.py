"""A configuration file of the benchmark, read without the program: the
model's published sizes (the keys of the model's ``config.json``) and the
deployment that a cell serves (the ``bench`` group).

Everything here is the benchmark's own reading of the file, so that the
weights, the reference and the bound arithmetic never ask the program what
the model is.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Tuple

# The Qwen2.5-VL vision ids that VibeVoice repurposes as its speech tokens
# (the processor's tokenizer maps <|vision_start|> etc. onto them).
SPEECH_START = 151652
SPEECH_END = 151653
SPEECH_DIFFUSION = 151654
EOS = 151643
CANDIDATES = (SPEECH_START, SPEECH_END, SPEECH_DIFFUSION, EOS)
SAMPLE_RATE = 24_000


def _depths(d) -> Tuple[int, ...]:
    return tuple(int(x) for x in d.split("-")) if isinstance(d, str) else tuple(d)


@dataclass(frozen=True)
class Coder:
    """One σ-VAE encoder or decoder: channel widths, stride per stage, the
    ConvNeXt depth per stage, input and output channels."""

    dims: Tuple[int, ...]
    ratios: Tuple[int, ...]
    depths: Tuple[int, ...]
    in_ch: int
    out_ch: int
    eps: float
    std: float
    gamma: float

    @property
    def hop(self) -> int:
        h = 1
        for r in self.ratios:
            h *= r
        return h


def encoder(t: dict) -> Coder:
    depths = _depths(t["encoder_depths"])
    nf = t["encoder_n_filters"]
    return Coder(tuple(nf * 2 ** i for i in range(len(depths))),
                 tuple(reversed(t["encoder_ratios"])), depths, t["channels"], t["vae_dim"],
                 t["layernorm_eps"], t["weight_init_value"], t["layer_scale_init_value"])


def decoder(t: dict) -> Coder:
    depths = _depths(t["decoder_depths"]) if t.get("decoder_depths") else tuple(
        reversed(_depths(t["encoder_depths"])))
    n = len(depths)
    nf = t["decoder_n_filters"]
    ratios = tuple(t["decoder_ratios"] or t["encoder_ratios"])
    return Coder(tuple(nf * 2 ** (n - 1 - i) for i in range(n)), ratios, depths, t["vae_dim"],
                 t["channels"], t["layernorm_eps"], t["weight_init_value"],
                 t["layer_scale_init_value"])


@dataclass(frozen=True)
class Model:
    raw: dict  # the file as read
    hidden: int
    inter: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    vocab: int
    rms_eps: float
    rope_theta: float
    tied: bool
    init_std: float
    head_hidden: int
    head_ffn: int
    head_layers: int
    head_eps: float
    latent: int
    semantic_dim: int
    ddpm_train_steps: int
    beta_schedule: str
    prediction: str
    ac_enc: Coder
    ac_dec: Coder
    se_enc: Coder
    fix_std: float
    std_dist: str
    bench: dict

    @property
    def hop(self) -> int:
        return self.ac_dec.hop

    @property
    def frame_seconds(self) -> float:
        return self.hop / SAMPLE_RATE


def load(path) -> Model:
    raw = json.loads(Path(path).read_text())
    lm, hd = raw["decoder_config"], raw["diffusion_head_config"]
    ac, se = raw["acoustic_tokenizer_config"], raw["semantic_tokenizer_config"]
    for key in ("mixer_layer", "layernorm", "pad_mode"):
        want = {"mixer_layer": "depthwise_conv", "layernorm": "RMSNorm", "pad_mode": "constant"}
        if ac[key] != want[key] or se[key] != want[key]:
            raise ValueError(f"{path}: the reference implements {key}={want[key]!r} only")
    if not (ac["causal"] and se["causal"] and ac["disable_last_norm"] and se["disable_last_norm"]):
        raise ValueError(f"{path}: the reference implements causal tokenizers without a last norm")
    return Model(
        raw=raw, hidden=lm["hidden_size"], inter=lm["intermediate_size"],
        layers=lm["num_hidden_layers"], heads=lm["num_attention_heads"],
        kv_heads=lm["num_key_value_heads"],
        head_dim=lm["hidden_size"] // lm["num_attention_heads"], vocab=lm["vocab_size"],
        rms_eps=lm["rms_norm_eps"], rope_theta=lm["rope_theta"],
        tied=lm["tie_word_embeddings"], init_std=lm["initializer_range"],
        head_hidden=hd["hidden_size"], head_ffn=int(hd["hidden_size"] * hd["head_ffn_ratio"]),
        head_layers=hd["head_layers"], head_eps=hd["rms_norm_eps"], latent=hd["latent_size"],
        semantic_dim=se["vae_dim"], ddpm_train_steps=hd["ddpm_num_steps"],
        beta_schedule=hd["ddpm_beta_schedule"], prediction=hd["prediction_type"],
        ac_enc=encoder(ac), ac_dec=decoder(ac), se_enc=encoder(se),
        fix_std=ac["fix_std"], std_dist=ac["std_dist_type"], bench=raw["bench"],
    )
