"""The port's parameter tree: conversion from the JAX package's pytree, and
random initialisation from a seed (the multi-speaker model's ``init``, the
streaming 0.5B model's ``init_streaming``). Both constructors and
``from_jax`` put the weights on the card unless given ``device="cpu"``.

The tree has the JAX pytree's keys. Layouts:
  linear weights      (in, out), as in the JAX package (int8 weights too)
  conv weights        PyTorch's (C_out, C_in // groups, k)
  transposed convs    PyTorch's (C_in, C_out, k)
The JAX package stores convs as TIO (k, C_in // groups, C_out) and
transposed convs pre-flipped, w[t, i, o] = torch_w[i, o, k-1-t]
(vibevoice_tpu/utils/torch_convert.py:1-12).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ..configs import VibeVoiceConfig, VibeVoiceStreamingConfig

from ..models.tokenizer import decoder_spec, encoder_spec


def _tensor(a, dtype=None, device=None) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16 has no torch.from_numpy path
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a writable copy
    return t.to(device=device, dtype=dtype)


def _conv(w) -> torch.Tensor:  # TIO -> (out, in/g, k)
    return w.permute(2, 1, 0).contiguous()


def _conv_transpose(w) -> torch.Tensor:  # pre-flipped TIO -> (in, out, k)
    return w.flip(0).permute(1, 2, 0).contiguous()


def _tokenizer_part(p: Dict) -> Dict:
    """One encoder/decoder: the 'down'/'up' convs (decoder 'up' entries past
    the stem are transposed), the block mixers and the head conv."""
    out = dict(p)
    for key in ("down", "up"):
        if key in p:
            out[key] = [
                {**c, "w": (_conv_transpose if key == "up" and i > 0 else _conv)(c["w"])}
                for i, c in enumerate(p[key])
            ]
    out["stages"] = [[{**blk, "mixer": {**blk["mixer"], "w": _conv(blk["mixer"]["w"])}}
                      for blk in stage] for stage in p["stages"]]
    out["head"] = {**p["head"], "w": _conv(p["head"]["w"])}
    return out


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _device(device) -> torch.device:
    """The weights' device: the card unless the caller asks for the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r}: no CUDA device is available; pass "
                           "device=\"cpu\" to build the weights on the CPU (the kernels' plain "
                           "versions)")
    return device


def from_jax(params_np: Dict, cfg, *, dtype=None, device="cuda") -> Dict:
    """Convert the DENSE JAX pytree (after ``jax.tree.map(np.asarray, ...)``)
    to the port's tree on ``device``; a partial tree (e.g. only the
    tokenizers) works too, and so does the streaming model's. Quantization
    and fusion are run by the port itself
    (models/vibevoice.quantize_for_inference / fuse_for_serving)."""
    del cfg  # the structure is read from the tree
    device = _device(device)
    t = _map(params_np, lambda a: _tensor(a, device=device))
    if dtype is not None:
        t = _map(t, lambda x: x.to(dtype) if x.is_floating_point() and x.ndim else x)
    for name in ("acoustic_tokenizer", "semantic_tokenizer"):
        if name in t:
            t[name] = {part: _tokenizer_part(sub) for part, sub in t[name].items()}
    return t


class _Draws:
    """The random draws of ``init`` and ``init_streaming``: every tensor
    from one seeded generator on ``device``, in the order it is asked for."""

    def __init__(self, seed: int, dtype, device: torch.device):
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed)
        self.dtype, self.device = dtype, device

    def normal(self, *shape, std):
        return (torch.randn(shape, generator=self.gen, device=self.device) * std).to(self.dtype)

    def ones(self, n):
        return torch.ones(n, dtype=self.dtype, device=self.device)

    def zeros(self, n):
        return torch.zeros(n, dtype=self.dtype, device=self.device)

    def lin(self, cin, cout, std, bias=False):
        p = {"w": self.normal(cin, cout, std=std)}
        if bias:
            p["b"] = self.zeros(cout)
        return p

    def conv(self, cout, cin_g, k, std, bias):
        p = {"w": self.normal(cout, cin_g, k, std=std)}
        if bias:
            p["b"] = self.zeros(cout)
        return p


def _lm(r: _Draws, lm_cfg) -> Dict:
    """A Qwen2 stack: embedding, layers, final norm."""
    h, inter = lm_cfg.hidden_size, lm_cfg.intermediate_size
    kvw = lm_cfg.num_key_value_heads * lm_cfg.head_dim
    std = lm_cfg.initializer_range
    return {
        "embed": r.normal(lm_cfg.vocab_size, h, std=std),
        "layers": [
            {
                "input_norm": {"w": r.ones(h)},
                "attn": {"q": r.lin(h, h, std, True), "k": r.lin(h, kvw, std, True),
                         "v": r.lin(h, kvw, std, True), "o": r.lin(h, h, std)},
                "post_norm": {"w": r.ones(h)},
                "mlp": {"gate": r.lin(h, inter, std), "up": r.lin(h, inter, std),
                        "down": r.lin(inter, h, std)},
            }
            for _ in range(lm_cfg.num_hidden_layers)
        ],
        "final_norm": {"w": r.ones(h)},
    }


def _coder(r: _Draws, tcfg, decoder: bool) -> Dict:
    """A tokenizer encoder or decoder (convs in PyTorch's layouts)."""

    def block(dim):
        s = tcfg.weight_init_value
        groups = dim if tcfg.mixer_layer == "depthwise_conv" else 1
        p = {
            "norm": {"w": r.ones(dim)},
            "mixer": r.conv(dim, dim // groups, 7, s, tcfg.conv_bias),
            "ffn_norm": {"w": r.ones(dim)},
            "ffn": {"fc1": r.lin(dim, 4 * dim, s, tcfg.conv_bias),
                    "fc2": r.lin(4 * dim, dim, s, tcfg.conv_bias)},
        }
        if tcfg.layer_scale_init_value > 0:
            p["gamma"] = torch.full((dim,), tcfg.layer_scale_init_value, dtype=r.dtype,
                                    device=r.device)
            p["ffn_gamma"] = p["gamma"].clone()
        return p

    spec = decoder_spec(tcfg) if decoder else encoder_spec(tcfg)
    dims, ratios, depths = spec["dims"], spec["ratios"], spec["depths"]
    s, bias = tcfg.weight_init_value, tcfg.conv_bias
    convs = [r.conv(dims[0], spec["in_channels"], 7, s, bias)]
    for i in range(len(depths) - 1):
        k = 2 * ratios[i]
        if decoder:  # transposed: (C_in, C_out, k)
            p = {"w": r.normal(dims[i], dims[i + 1], k, std=s)}
            if bias:
                p["b"] = r.zeros(dims[i + 1])
            convs.append(p)
        else:
            convs.append(r.conv(dims[i + 1], dims[i], k, s, bias))
    p = {"up" if decoder else "down": convs,
         "stages": [[block(dims[i]) for _ in range(d)] for i, d in enumerate(depths)],
         "head": r.conv(spec["out_dim"], dims[-1], 7, s, bias)}
    if not tcfg.disable_last_norm:
        p["final_norm"] = {"w": r.ones(dims[-1])} if tcfg.layernorm_elementwise_affine else {}
    return p


def _connector(r: _Draws, cin, cout) -> Dict:
    return {"fc1": r.lin(cin, cout, 0.02, True), "norm": {"w": r.ones(cout)},
            "fc2": r.lin(cout, cout, 0.02, True)}


def _head(r: _Draws, hc) -> Dict:
    """The diffusion head."""
    hh, lat, ff = hc.hidden_size, hc.latent_size, hc.ffn_dim
    return {
        "noisy_proj": r.lin(lat, hh, 0.02),
        "cond_proj": r.lin(hh, hh, 0.02),
        "t_embedder": {"fc1": r.lin(256, hh, 0.02), "fc2": r.lin(hh, hh, 0.02)},
        "layers": [
            {"norm": {"w": r.ones(hh)}, "adaln": r.lin(hh, 3 * hh, 0.02),
             "ffn": {"gate": r.lin(hh, ff, 0.02), "up": r.lin(hh, ff, 0.02),
                     "down": r.lin(ff, hh, 0.02)}}
            for _ in range(hc.head_layers)
        ],
        "final": {"adaln": r.lin(hh, 2 * hh, 0.02), "linear": r.lin(hh, lat, 0.02)},
    }


def init(cfg: VibeVoiceConfig, *, seed: int = 0, dtype=torch.float32, device="cuda") -> Dict:
    """Random weights from ``seed`` with the reference's shapes, on
    ``device`` (the card unless the caller asks for the CPU). Every matrix
    is drawn N(0, std) (the AdaLN and final layers too, which the reference
    zero-initialises, so that every layer does work); norms are ones, biases
    zeros, layer scales the config's init value."""
    r = _Draws(seed, dtype, _device(device))
    lm_cfg = cfg.decoder_config
    h = lm_cfg.hidden_size
    lm = _lm(r, lm_cfg)
    head = _head(r, cfg.diffusion_head_config)
    acfg, scfg = cfg.acoustic_tokenizer_config, cfg.semantic_tokenizer_config
    params = {
        "lm": lm,
        "acoustic_tokenizer": {"encoder": _coder(r, acfg, False), "decoder": _coder(r, acfg, True)},
        "semantic_tokenizer": {"encoder": _coder(r, scfg, False)},
        "acoustic_connector": _connector(r, cfg.acoustic_vae_dim, h),
        "semantic_connector": _connector(r, cfg.semantic_vae_dim, h),
        "diffusion_head": head,
        "speech_scaling_factor": torch.tensor(1.0, device=r.device),
        "speech_bias_factor": torch.tensor(0.0, device=r.device),
    }
    if not lm_cfg.tie_word_embeddings:
        params["lm_head"] = r.normal(lm_cfg.vocab_size, h, std=0.02)
    return params


def init_streaming(cfg: VibeVoiceStreamingConfig, *, seed: int = 0, dtype=torch.float32,
                   device="cuda") -> Dict:
    """Random weights of the streaming 0.5B model (the tree of
    vibevoice_tpu/models/streaming.py ``init``), drawn as ``init`` draws
    them: the lower text LM (``lm_num_hidden_layers`` layers) and the upper
    TTS LM, the text/speech type embedding, the EOS classifier, the
    acoustic tokenizer, its connector, the diffusion head and the two
    scaling scalars, on ``device`` (the card unless the caller asks for the
    CPU)."""
    r = _Draws(seed, dtype, _device(device))
    lm_cfg = cfg.decoder_config
    h, std = lm_cfg.hidden_size, lm_cfg.initializer_range
    replace = dataclasses.replace
    acfg = cfg.acoustic_tokenizer_config
    return {
        "language_model": _lm(r, replace(lm_cfg, num_hidden_layers=cfg.lm_num_hidden_layers)),
        "tts_language_model": _lm(r, replace(
            lm_cfg, num_hidden_layers=cfg.tts_backbone_num_hidden_layers)),
        "tts_input_types": r.normal(2, h, std=std),
        "tts_eos_classifier": {"fc1": r.lin(h, h, std, True), "fc2": r.lin(h, 1, std, True)},
        "acoustic_tokenizer": {"encoder": _coder(r, acfg, False), "decoder": _coder(r, acfg, True)},
        "acoustic_connector": _connector(r, cfg.acoustic_vae_dim, h),
        "diffusion_head": _head(r, cfg.diffusion_head_config),
        "speech_scaling_factor": torch.tensor(1.0, device=r.device),
        "speech_bias_factor": torch.tensor(0.0, device=r.device),
    }


def lora_from_jax(lora_np: Dict, *, device="cuda") -> Dict:
    """Convert the JAX package's LoRA tree (after ``jax.tree.map(np.asarray,
    ...)``) to the port's on ``device`` (the card unless the caller asks for
    the CPU): the same keys and the same layouts, A (IN, r) and B (r, OUT);
    dense extras (connectors, a full diffusion head) are linears in (in,
    out) layout on both sides."""
    device = _device(device)
    return _map(lora_np, lambda a: _tensor(a, device=device))


def speaking(params: Dict, tokens, *, c: float = 4.0, alpha: float = 10.0, beta: float = 10.0,
             d0: int = 0) -> Dict:
    """Random multi-speaker weights that speak, for checks and benches on
    random weights (whose LM otherwise picks <speech_start> or EOS at every
    frame). Hidden dimension ``d0`` carries ``c`` at every position: its
    embedding column is set, the two connectors' output biases give c / 2
    each, and the columns that would change it (each layer's attention
    output and MLP down projection, the connectors' output weights) are
    zeroed. The LM head adds ``alpha`` per unit of that dimension to the
    <speech_diffusion> logit and takes ``beta`` from EOS's; an int8 head
    (``lm_head_q``) has those two columns replaced by that alone. Greedy
    decoding then diffuses at every frame; sampling mixes the other speech
    tokens in. Returns a new tree; ``params`` is left as it is (tensors that
    change are copied, the others shared). ``tokens`` is the model's
    ``inference.SpecialTokens``."""
    lm = dict(params["lm"])
    lm["embed"] = lm["embed"].clone()
    lm["embed"][:, d0] = c
    layers = []
    for layer in lm["layers"]:
        layer = {**layer, "attn": dict(layer["attn"]), "mlp": dict(layer["mlp"])}
        for group, name in (("attn", "o"), ("mlp", "down")):
            lin = dict(layer[group][name])
            for key in ("w8", "w", "b"):
                if key in lin:
                    lin[key] = lin[key].clone()
                    lin[key][..., d0] = 0
            layer[group][name] = lin
        layers.append(layer)
    lm["layers"] = layers
    out = {**params, "lm": lm}
    for conn in ("acoustic_connector", "semantic_connector"):
        fc2 = {k: v.clone() for k, v in params[conn]["fc2"].items()}
        fc2["w"][:, d0] = 0
        fc2["b"][d0] = c / 2
        out[conn] = {**params[conn], "fc2": fc2}
    owner = lm if "lm_head_q" in lm else out if "lm_head_q" in params else None
    if owner is not None:
        head = {k: v.clone() for k, v in owner["lm_head_q"].items()}
        for tok, gain in ((tokens.speech_diffusion, alpha), (tokens.eos, -beta)):
            head["w8"][:, tok] = 0
            head["w8"][d0, tok] = 127 if gain > 0 else -127
            head["scale"][tok] = abs(gain) / 127
        owner["lm_head_q"] = head
    else:
        head = (params["lm_head"] if "lm_head" in params else lm["embed"]).clone()
        head[tokens.speech_diffusion, d0] += alpha
        head[tokens.eos, d0] -= beta
        out["lm_head"] = head
    return out
