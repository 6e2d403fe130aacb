"""The port's parameter tree: conversion from the JAX package's pytree, and
random initialisation from a seed.

The tree has the JAX pytree's keys. Layouts:
  linear weights      (in, out), as in the JAX package (int8 weights too)
  conv weights        PyTorch's (C_out, C_in // groups, k)
  transposed convs    PyTorch's (C_in, C_out, k)
The JAX package stores convs as TIO (k, C_in // groups, C_out) and
transposed convs pre-flipped, w[t, i, o] = torch_w[i, o, k-1-t]
(vibevoice_tpu/utils/torch_convert.py:1-12).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..configs import VibeVoiceConfig

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


def from_jax(params_np: Dict, cfg: VibeVoiceConfig, *, dtype=None, device=None) -> Dict:
    """Convert the DENSE JAX pytree (after ``jax.tree.map(np.asarray, ...)``)
    to the port's tree; a partial tree (e.g. only the tokenizers) works too. Quantization and fusion are run by the port itself
    (models/vibevoice.quantize_for_inference / fuse_for_serving)."""
    del cfg  # the structure is read from the tree
    t = _map(params_np, lambda a: _tensor(a, device=device))
    if dtype is not None:
        t = _map(t, lambda x: x.to(dtype) if x.is_floating_point() and x.ndim else x)
    for name in ("acoustic_tokenizer", "semantic_tokenizer"):
        if name in t:
            t[name] = {part: _tokenizer_part(sub) for part, sub in t[name].items()}
    return t


def init(cfg: VibeVoiceConfig, *, seed: int = 0, dtype=torch.float32, device=None) -> Dict:
    """Random weights from ``seed`` with the reference's shapes. Every matrix
    is drawn N(0, std) (the AdaLN and final layers too, which the reference
    zero-initialises, so that every layer does work); norms are ones, biases
    zeros, layer scales the config's init value."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def normal(*shape, std):
        return (torch.randn(shape, generator=gen, device=device) * std).to(dtype)

    ones = lambda n: torch.ones(n, dtype=dtype, device=device)
    zeros = lambda n: torch.zeros(n, dtype=dtype, device=device)

    def lin(cin, cout, std, bias=False):
        p = {"w": normal(cin, cout, std=std)}
        if bias:
            p["b"] = zeros(cout)
        return p

    lm_cfg = cfg.decoder_config
    h, inter = lm_cfg.hidden_size, lm_cfg.intermediate_size
    kvw = lm_cfg.num_key_value_heads * lm_cfg.head_dim
    std = lm_cfg.initializer_range
    lm = {
        "embed": normal(lm_cfg.vocab_size, h, std=std),
        "layers": [
            {
                "input_norm": {"w": ones(h)},
                "attn": {"q": lin(h, h, std, True), "k": lin(h, kvw, std, True),
                         "v": lin(h, kvw, std, True), "o": lin(h, h, std)},
                "post_norm": {"w": ones(h)},
                "mlp": {"gate": lin(h, inter, std), "up": lin(h, inter, std),
                        "down": lin(inter, h, std)},
            }
            for _ in range(lm_cfg.num_hidden_layers)
        ],
        "final_norm": {"w": ones(h)},
    }

    def conv(cout, cin_g, k, std, bias):
        p = {"w": normal(cout, cin_g, k, std=std)}
        if bias:
            p["b"] = zeros(cout)
        return p

    def block(dim, tcfg):
        s = tcfg.weight_init_value
        groups = dim if tcfg.mixer_layer == "depthwise_conv" else 1
        p = {
            "norm": {"w": ones(dim)},
            "mixer": conv(dim, dim // groups, 7, s, tcfg.conv_bias),
            "ffn_norm": {"w": ones(dim)},
            "ffn": {"fc1": lin(dim, 4 * dim, s, tcfg.conv_bias),
                    "fc2": lin(4 * dim, dim, s, tcfg.conv_bias)},
        }
        if tcfg.layer_scale_init_value > 0:
            p["gamma"] = torch.full((dim,), tcfg.layer_scale_init_value, dtype=dtype, device=device)
            p["ffn_gamma"] = p["gamma"].clone()
        return p

    def coder(tcfg, decoder: bool):
        spec = decoder_spec(tcfg) if decoder else encoder_spec(tcfg)
        dims, ratios, depths = spec["dims"], spec["ratios"], spec["depths"]
        s, bias = tcfg.weight_init_value, tcfg.conv_bias
        convs = [conv(dims[0], spec["in_channels"], 7, s, bias)]
        for i in range(len(depths) - 1):
            k = 2 * ratios[i]
            if decoder:  # transposed: (C_in, C_out, k)
                p = {"w": normal(dims[i], dims[i + 1], k, std=s)}
                if bias:
                    p["b"] = zeros(dims[i + 1])
                convs.append(p)
            else:
                convs.append(conv(dims[i + 1], dims[i], k, s, bias))
        p = {"up" if decoder else "down": convs,
             "stages": [[block(dims[i], tcfg) for _ in range(d)] for i, d in enumerate(depths)],
             "head": conv(spec["out_dim"], dims[-1], 7, s, bias)}
        if not tcfg.disable_last_norm:
            p["final_norm"] = {"w": ones(dims[-1])} if tcfg.layernorm_elementwise_affine else {}
        return p

    def connector(cin, cout):
        return {"fc1": lin(cin, cout, 0.02, True), "norm": {"w": ones(cout)},
                "fc2": lin(cout, cout, 0.02, True)}

    hc = cfg.diffusion_head_config
    hh, lat, ff = hc.hidden_size, hc.latent_size, hc.ffn_dim
    head = {
        "noisy_proj": lin(lat, hh, 0.02),
        "cond_proj": lin(hh, hh, 0.02),
        "t_embedder": {"fc1": lin(256, hh, 0.02), "fc2": lin(hh, hh, 0.02)},
        "layers": [
            {"norm": {"w": ones(hh)}, "adaln": lin(hh, 3 * hh, 0.02),
             "ffn": {"gate": lin(hh, ff, 0.02), "up": lin(hh, ff, 0.02),
                     "down": lin(ff, hh, 0.02)}}
            for _ in range(hc.head_layers)
        ],
        "final": {"adaln": lin(hh, 2 * hh, 0.02), "linear": lin(hh, lat, 0.02)},
    }
    acfg, scfg = cfg.acoustic_tokenizer_config, cfg.semantic_tokenizer_config
    params = {
        "lm": lm,
        "acoustic_tokenizer": {"encoder": coder(acfg, False), "decoder": coder(acfg, True)},
        "semantic_tokenizer": {"encoder": coder(scfg, False)},
        "acoustic_connector": connector(cfg.acoustic_vae_dim, h),
        "semantic_connector": connector(cfg.semantic_vae_dim, h),
        "diffusion_head": head,
        "speech_scaling_factor": torch.tensor(1.0, device=device),
        "speech_bias_factor": torch.tensor(0.0, device=device),
    }
    if not lm_cfg.tie_word_embeddings:
        params["lm_head"] = normal(lm_cfg.vocab_size, h, std=0.02)
    return params


def lora_from_jax(lora_np: Dict, *, device=None) -> Dict:
    """Convert the JAX package's LoRA tree (after ``jax.tree.map(np.asarray,
    ...)``) to the port's: the same keys and the same layouts, A (IN, r) and
    B (r, OUT); dense extras (connectors, a full diffusion head) are linears
    in (in, out) layout on both sides."""
    return _map(lora_np, lambda a: _tensor(a, device=device))
