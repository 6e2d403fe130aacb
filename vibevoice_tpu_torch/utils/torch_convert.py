"""Reference (PyTorch) state dicts -> the port's parameter tree (port of
vibevoice_tpu/utils/torch_convert.py).

Layouts (utils/params.py):
  linear weight           torch (out, in)          ->  (in, out)
  conv weight             torch (C_out, C_in/g, k) ->  as stored
  conv-transpose weight   torch (C_in, C_out, k)   ->  as stored
  embed_tokens, lm_head   (vocab, hidden)          ->  as stored

Every tensor goes through ``Put`` first (to the tree's device and, if
floating, its dtype), so a transpose runs once, on the target, and a bf16
checkpoint is never up-cast on the host. State-dict key paths are the JAX
converter's (reference modular_vibevoice_tokenizer.py:687-951,
modeling_vibevoice.py:58-135, modular_vibevoice_diffusion_head.py:191-280).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .params import _device


class Put:
    """A state-dict tensor (torch or numpy) on ``device``, the card unless
    the caller asks for the CPU, cast to ``dtype`` if it is floating
    (``dtype=None`` keeps the stored dtype)."""

    def __init__(self, dtype: Optional[torch.dtype] = None, device="cuda"):
        self.dtype, self.device = dtype, _device(device)

    def __call__(self, x) -> torch.Tensor:
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
        cast = self.dtype if self.dtype is not None and t.is_floating_point() else None
        return t.detach().to(device=self.device, dtype=cast)

    def new(self, fill: float, *shape) -> torch.Tensor:
        """A filled tensor of the tree's float dtype (f32 when none is set)."""
        return torch.full(shape, fill, dtype=self.dtype or torch.float32, device=self.device)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().float().numpy()
    return np.asarray(x)


def _raw_conv_weight(sd: Dict, prefix: str):
    """Conv weight in torch layout, folding any conv_norm reparametrization
    exactly as the JAX converter does (vibevoice_tpu/utils/torch_convert.py:45-79;
    reference apply_parametrization_norm, modular_vibevoice_tokenizer.py:98-107):

    * weight_norm (legacy nn.utils.weight_norm: weight_g / weight_v, or the
      parametrize API's original0 / original1): w = g * v / ||v||, the norm
      over every dim but 0, in float64;
    * spectral_norm (legacy: weight_orig, weight_u[, weight_v]): the
      eval-time w = weight_orig / sigma, sigma = u^T W v with v the stored
      buffer or normalize(W^T u).

    A plain ``.weight`` comes back as stored; a folded one as f32 numpy."""
    if prefix + ".weight" in sd:
        return sd[prefix + ".weight"]
    if prefix + ".weight_g" in sd:
        g, v = _np(sd[prefix + ".weight_g"]), _np(sd[prefix + ".weight_v"])
    elif prefix + ".parametrizations.weight.original0" in sd:
        g = _np(sd[prefix + ".parametrizations.weight.original0"])
        v = _np(sd[prefix + ".parametrizations.weight.original1"])
    elif prefix + ".weight_orig" in sd:
        w = _np(sd[prefix + ".weight_orig"])
        u = _np(sd[prefix + ".weight_u"])
        wm = w.reshape(w.shape[0], -1)
        if prefix + ".weight_v" in sd:  # torch stores the settled v buffer
            vv = _np(sd[prefix + ".weight_v"])
        else:
            vv = wm.T @ u
            vv = vv / max(np.linalg.norm(vv), 1e-12)
        sigma = float(u @ (wm @ vv))
        return w / sigma
    else:
        raise KeyError(f"no conv weight found under '{prefix}'")
    axes = tuple(range(1, v.ndim))
    norm = np.sqrt(np.sum(v.astype(np.float64) ** 2, axis=axes, keepdims=True))
    return (g * (v / np.maximum(norm, 1e-12))).astype(v.dtype)


def _conv_params(sd: Dict, prefix: str, put: Put) -> Dict:
    p = {"w": put(_raw_conv_weight(sd, prefix)).contiguous()}
    if prefix + ".bias" in sd:
        p["b"] = put(sd[prefix + ".bias"])
    return p


def _linear_params(sd: Dict, prefix: str, put: Put) -> Dict:
    p = {"w": put(sd[prefix + ".weight"]).t().contiguous()}
    if prefix + ".bias" in sd:
        p["b"] = put(sd[prefix + ".bias"])
    return p


def _norm_params(sd: Dict, prefix: str, put: Put) -> Dict:
    # an affine-free norm (elementwise_affine=False) has no weight; only the
    # encoder's / decoder's final norm may be one
    return {"w": put(sd[f"{prefix}.weight"])} if f"{prefix}.weight" in sd else {}


def _block_params(sd: Dict, prefix: str, put: Put) -> Dict:
    p = {
        "norm": {"w": put(sd[f"{prefix}.norm.weight"])},
        "mixer": _conv_params(sd, f"{prefix}.mixer.conv.conv.conv", put),
        "ffn_norm": {"w": put(sd[f"{prefix}.ffn_norm.weight"])},
        "ffn": {
            "fc1": _linear_params(sd, f"{prefix}.ffn.linear1", put),
            "fc2": _linear_params(sd, f"{prefix}.ffn.linear2", put),
        },
    }
    if f"{prefix}.gamma" in sd:
        p["gamma"] = put(sd[f"{prefix}.gamma"])
        p["ffn_gamma"] = put(sd[f"{prefix}.ffn_gamma"])
    return p


def _final_norm(sd: Dict, cfg, prefix: str, put: Put, p: Dict) -> Dict:
    # presence is config-driven: an affine-free final norm leaves no keys in
    # the state dict but must still normalize
    if not getattr(cfg, "disable_last_norm", True) or f"{prefix}.norm.weight" in sd:
        p["final_norm"] = _norm_params(sd, f"{prefix}.norm", put)
    return p


def convert_encoder(sd: Dict, cfg, prefix: str, put: Put) -> Dict:
    """TokenizerEncoder state dict -> encoder params."""
    depths = tuple(cfg.encoder_depths)
    return _final_norm(sd, cfg, prefix, put, {
        "down": [_conv_params(sd, f"{prefix}.downsample_layers.{i}.0.conv.conv", put)
                 for i in range(len(depths))],
        "stages": [[_block_params(sd, f"{prefix}.stages.{i}.{j}", put) for j in range(d)]
                   for i, d in enumerate(depths)],
        "head": _conv_params(sd, f"{prefix}.head.conv.conv", put),
    })


def convert_decoder(sd: Dict, cfg, prefix: str, put: Put) -> Dict:
    """TokenizerDecoder state dict -> decoder params (the stem conv, then the
    transposed upsampling convs)."""
    depths = tuple(cfg.resolved_decoder_depths)
    up = [_conv_params(sd, f"{prefix}.upsample_layers.0.0.conv.conv", put)]
    up += [_conv_params(sd, f"{prefix}.upsample_layers.{i}.0.convtr.convtr", put)
           for i in range(1, len(depths))]
    return _final_norm(sd, cfg, prefix, put, {
        "up": up,
        "stages": [[_block_params(sd, f"{prefix}.stages.{i}.{j}", put) for j in range(d)]
                   for i, d in enumerate(depths)],
        "head": _conv_params(sd, f"{prefix}.head.conv.conv", put),
    })


def convert_acoustic_tokenizer(sd: Dict, cfg, prefix: str, put: Put) -> Dict:
    pre = prefix + "." if prefix else ""
    return {"encoder": convert_encoder(sd, cfg, pre + "encoder", put),
            "decoder": convert_decoder(sd, cfg, pre + "decoder", put)}


def convert_semantic_tokenizer(sd: Dict, cfg, prefix: str, put: Put) -> Dict:
    pre = prefix + "." if prefix else ""
    return {"encoder": convert_encoder(sd, cfg, pre + "encoder", put)}


def convert_diffusion_head(sd: Dict, cfg, prefix: str, put: Put) -> Dict:
    """VibeVoiceDiffusionHead state dict -> params
    (reference modular_vibevoice_diffusion_head.py:191-280)."""
    pre = prefix + "." if prefix else ""
    layers = []
    for i in range(cfg.head_layers):
        lp = f"{pre}layers.{i}"
        layers.append({
            "norm": {"w": put(sd[f"{lp}.norm.weight"])},
            "adaln": _linear_params(sd, f"{lp}.adaLN_modulation.1", put),
            "ffn": {name: _linear_params(sd, f"{lp}.ffn.{name}_proj", put)
                    for name in ("gate", "up", "down")},
        })
    return {
        "noisy_proj": _linear_params(sd, f"{pre}noisy_images_proj", put),
        "cond_proj": _linear_params(sd, f"{pre}cond_proj", put),
        "t_embedder": {"fc1": _linear_params(sd, f"{pre}t_embedder.mlp.0", put),
                       "fc2": _linear_params(sd, f"{pre}t_embedder.mlp.2", put)},
        "layers": layers,
        "final": {"adaln": _linear_params(sd, f"{pre}final_layer.adaLN_modulation.1", put),
                  "linear": _linear_params(sd, f"{pre}final_layer.linear", put)},
    }


def convert_speech_connector(sd: Dict, prefix: str, put: Put) -> Dict:
    """SpeechConnector: fc1 -> RMSNorm -> fc2 (reference modeling_vibevoice.py:58-69)."""
    return {"fc1": _linear_params(sd, f"{prefix}.fc1", put),
            "norm": {"w": put(sd[f"{prefix}.norm.weight"])},
            "fc2": _linear_params(sd, f"{prefix}.fc2", put)}


def convert_qwen2(sd: Dict, cfg, prefix: str, put: Put) -> Dict:
    """HF Qwen2Model state dict -> qwen2 params (see models/qwen2.py)."""
    pre = prefix + "." if prefix else ""
    layers = []
    for i in range(cfg.num_hidden_layers):
        lp = f"{pre}layers.{i}"
        layers.append({
            "input_norm": {"w": put(sd[f"{lp}.input_layernorm.weight"])},
            "attn": {name: _linear_params(sd, f"{lp}.self_attn.{name}_proj", put)
                     for name in ("q", "k", "v", "o")},
            "post_norm": {"w": put(sd[f"{lp}.post_attention_layernorm.weight"])},
            "mlp": {name: _linear_params(sd, f"{lp}.mlp.{name}_proj", put)
                    for name in ("gate", "up", "down")},
        })
    return {"embed": put(sd[f"{pre}embed_tokens.weight"]), "layers": layers,
            "final_norm": {"w": put(sd[f"{pre}norm.weight"])}}


def convert_qwen2_headless(sd: Dict, cfg, prefix: str, put: Put) -> Dict:
    """Like convert_qwen2 but tolerates a missing final norm (the streaming
    model's lower stack replaces it with Identity, reference
    modeling_vibevoice_streaming.py:138: ones) and a missing embedding
    table (the upper stack does not use one, reference :141-143: zeros).
    The fills are made on the target in the tree's dtype; the tree keeps
    both keys, as the port's ``init_streaming`` and the JAX converter have
    them."""
    pre = prefix + "." if prefix else ""
    fill = {}
    if f"{pre}norm.weight" not in sd:
        fill[f"{pre}norm.weight"] = put.new(1.0, cfg.hidden_size)
    if f"{pre}embed_tokens.weight" not in sd:
        fill[f"{pre}embed_tokens.weight"] = put.new(0.0, cfg.vocab_size, cfg.hidden_size)
    return convert_qwen2({**sd, **fill} if fill else sd, cfg, prefix, put)
