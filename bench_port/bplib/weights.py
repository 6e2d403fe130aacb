"""Random weights of a configuration, made on the device from the seed in
the port's parameter layout, and the edit that makes random weights speak.

The same seed gives the same tensors, so the reference makes them again
after the window instead of holding a second copy beside the program.
Every random matrix of a group is a view of one buffer drawn by one call
(N(0, 1) in the serving dtype, then scaled by the group's std), so set-up
draws the weights in a few large calls. The groups are those the program
replaces in set-up (the LM linears, the FFNs that the serving packs
quantize) and those it keeps, so that what it replaces is freed.

Layout (the port's ``utils/params.py``): linear weights (in, out), convs
(out, in / groups, k), transposed convs (in, out, k). Norm weights are
ones, biases zeros, layer scales the configuration's init value.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from . import spec as sp


class _Group:
    """Leaves of one std, later views of one buffer."""

    def __init__(self, std: float):
        self.std = std
        self.leaves: List[Tuple[dict, str, tuple]] = []

    def add(self, owner: dict, key: str, *shape):
        self.leaves.append((owner, key, shape))
        return owner

    def draw(self, gen: torch.Generator, dtype, device):
        n = sum(_numel(s) for _, _, s in self.leaves)
        flat = torch.empty(n, dtype=dtype, device=device)
        flat.normal_(0.0, 1.0, generator=gen)
        flat.mul_(self.std)
        off = 0
        for owner, key, shape in self.leaves:
            owner[key] = flat[off: off + _numel(shape)].view(shape)
            off += _numel(shape)


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _lin(group: _Group, cin: int, cout: int, bias: bool, zeros) -> dict:
    return _param(group, (cin, cout), cout if bias else 0, zeros)


def _param(group: _Group, shape: tuple, bias: int, zeros) -> dict:
    """A weight of ``shape`` drawn in ``group``, and ``bias`` zeros."""
    p = group.add({}, "w", *shape)
    if bias:
        p["b"] = zeros(bias)
    return p


def _coder(c: sp.Coder, decoder: bool, keep: _Group, hot: _Group, hot_stage: int,
           ones, zeros) -> dict:
    def block(dim, group):
        return {"norm": {"w": ones(dim)},
                "mixer": _param(keep, (dim, 1, 7), dim, zeros),
                "ffn_norm": {"w": ones(dim)},
                "ffn": {"fc1": _lin(group, dim, 4 * dim, True, zeros),
                        "fc2": _lin(group, 4 * dim, dim, True, zeros)},
                "gamma": ones(dim) * c.gamma, "ffn_gamma": ones(dim) * c.gamma}

    dims = c.dims
    convs = [_param(keep, (dims[0], c.in_ch, 7), dims[0], zeros)]
    for i in range(len(c.depths) - 1):
        k = 2 * c.ratios[i]
        shape = (dims[i], dims[i + 1], k) if decoder else (dims[i + 1], dims[i], k)
        convs.append(_param(keep, shape, dims[i + 1], zeros))
    n = len(c.depths)
    stages = [[block(dims[i], hot if i == hot_stage % n else keep) for _ in range(d)]
              for i, d in enumerate(c.depths)]
    return {"up" if decoder else "down": convs, "stages": stages,
            "head": _param(keep, (c.out_ch, dims[-1], 7), c.out_ch, zeros)}


def make(m: sp.Model, seed: int, device, dtype=torch.bfloat16) -> Dict:
    """The weight tree of configuration ``m`` from ``seed`` on ``device``,
    edited to speak (``speak``)."""
    device = torch.device(device)
    if m.se_enc.std != m.ac_dec.std:
        raise ValueError("the tokenizers' weights are drawn with one std")
    ones = lambda n: torch.ones(n, dtype=dtype, device=device)
    zeros = lambda n: torch.zeros(n, dtype=dtype, device=device)
    std = m.init_std
    lin_g, ffn_g, hot_g = _Group(std), _Group(std), _Group(m.ac_dec.std)
    keep_g, tok_g = _Group(std), _Group(m.ac_dec.std)
    h, kvw = m.hidden, m.kv_heads * m.head_dim
    layers = []
    for _ in range(m.layers):
        layers.append({
            "input_norm": {"w": ones(h)},
            "attn": {"q": _lin(lin_g, h, h, True, zeros), "k": _lin(lin_g, h, kvw, True, zeros),
                     "v": _lin(lin_g, h, kvw, True, zeros), "o": _lin(lin_g, h, h, False, zeros)},
            "post_norm": {"w": ones(h)},
            "mlp": {"gate": _lin(lin_g, h, m.inter, False, zeros),
                    "up": _lin(lin_g, h, m.inter, False, zeros),
                    "down": _lin(lin_g, m.inter, h, False, zeros)},
        })
    lm = keep_g.add({"layers": layers, "final_norm": {"w": ones(h)}}, "embed", m.vocab, h)
    hh, ff = m.head_hidden, m.head_ffn
    head = {
        "noisy_proj": _lin(keep_g, m.latent, hh, False, zeros),
        "cond_proj": _lin(keep_g, hh, hh, False, zeros),
        "t_embedder": {"fc1": _lin(keep_g, 256, hh, False, zeros),
                       "fc2": _lin(keep_g, hh, hh, False, zeros)},
        "layers": [{"norm": {"w": ones(hh)}, "adaln": _lin(keep_g, hh, 3 * hh, False, zeros),
                    "ffn": {"gate": _lin(ffn_g, hh, ff, False, zeros),
                            "up": _lin(ffn_g, hh, ff, False, zeros),
                            "down": _lin(ffn_g, ff, hh, False, zeros)}}
                   for _ in range(m.head_layers)],
        "final": {"adaln": _lin(keep_g, hh, 2 * hh, False, zeros),
                  "linear": _lin(keep_g, hh, m.latent, False, zeros)},
    }

    def connector(cin):
        return {"fc1": _lin(keep_g, cin, h, True, zeros), "norm": {"w": ones(h)},
                "fc2": _lin(keep_g, h, h, True, zeros)}

    params = {
        "lm": lm,
        # the decoder's first stage and the semantic encoder's last stage run
        # a frame at a time in the serving packs (kernel D), which hold their
        # FFNs quantized: they are drawn into the group the program replaces
        "acoustic_tokenizer": {
            "encoder": _coder(m.ac_enc, False, tok_g, tok_g, -1, ones, zeros),
            "decoder": _coder(m.ac_dec, True, tok_g, hot_g, 0, ones, zeros)},
        "semantic_tokenizer": {
            "encoder": _coder(m.se_enc, False, tok_g, hot_g, -1, ones, zeros)},
        "acoustic_connector": connector(m.latent),
        "semantic_connector": connector(m.semantic_dim),
        "diffusion_head": head,
        "speech_scaling_factor": torch.tensor(1.0, device=device),
        "speech_bias_factor": torch.tensor(0.0, device=device),
    }
    if not m.tied:
        keep_g.add(params, "lm_head", m.vocab, h)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    for g in (lin_g, ffn_g, hot_g, keep_g, tok_g):
        g.draw(gen, dtype, device)
    speak(params, m.bench["speak_c"], m.bench["speak_alpha"], m.bench["speak_beta"])
    return params


def speak(params: Dict, c: float, alpha: float, beta: float, d0: int = 0) -> None:
    """Make random weights speak, in place (the edit of the port's
    ``utils.params.speaking`` on dense weights): hidden dimension ``d0``
    carries ``c`` at every position (its embedding column; c / 2 from each
    connector's output bias; zero in every output column that would change
    it: each layer's attention output and MLP down projection, the
    connectors' output weights), and the LM head adds ``alpha`` a unit of
    it to <speech_diffusion>'s logit and takes ``beta`` from EOS's. Greedy
    decoding then diffuses at every frame. A tied head becomes an untied
    copy of the edited embedding, as in the port's edit."""
    lm = params["lm"]
    lm["embed"][:, d0] = c
    for layer in lm["layers"]:
        layer["attn"]["o"]["w"][:, d0] = 0
        layer["mlp"]["down"]["w"][:, d0] = 0
    for conn in ("acoustic_connector", "semantic_connector"):
        params[conn]["fc2"]["w"][:, d0] = 0
        params[conn]["fc2"]["b"][d0] = c / 2
    head = params.get("lm_head")
    if head is None:
        head = params["lm_head"] = lm["embed"].clone()
    head[sp.SPEECH_DIFFUSION, d0] += alpha
    head[sp.EOS, d0] -= beta
