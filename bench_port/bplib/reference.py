"""The plain reference of a VibeVoice request: the published model's
equations in plain PyTorch, one request at a time, with no kernel, no
batching and no code of the program (the JAX package's ``models/`` read as
the specification).

It takes the benchmark's raw weights (``weights.make``) and a request
(ids, voice waveforms, its frames' initial diffusion noise) and works out
again what the program derives in set-up: the per-column int8 weights of
the LM linears, of the LM head and of the FFNs that the serving packs
quantize (the diffusion head's, the acoustic decoder's first stage and the
semantic encoder's last stage).

``precision`` sets the arithmetic: "f32" is the reference (float32, TF32
off); "low" is the control, a step below what the configuration states
everywhere: the weights it states int8 (the LM linears and head, the
packed FFNs) int4 per column, and every result it states bf16 rounded to
fp8 (e4m3, a scale a tensor).

``follow`` is the comparison: the reference decodes requests teacher-forced
by what the program served (each frame's latent, read from the program's
decoder state, and its audio's semantic re-encode fed back, as a text
model's check feeds back the served ids) and returns its own latent and
its decoder's audio of every frame, to be held against the program's.
``generate`` decodes on its own outputs (a control put in the program's
place).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import spec as sp

PRECISIONS = ("f32", "low")
FP8_MAX = 448.0  # the largest e4m3 value
T_FREQ = 256


def quantized(w: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """w (in, out) with each output column rounded to ``bits``-bit
    integers over its absolute maximum, as float32."""
    wf = w.float()
    qmax = float(2 ** (bits - 1) - 1)
    scale = wf.abs().amax(dim=0).clamp_min(1e-8) / torch.full((), qmax, device=w.device)
    return torch.clamp(torch.round(wf / scale), -qmax, qmax) * scale


def _rms(x, w, eps):
    y = x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps)
    return y if w is None else y * w


class Reference:
    def __init__(self, m: sp.Model, raw: Dict, device, precision: str = "f32"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
        if m.beta_schedule != "cosine" or m.prediction != "v_prediction":
            raise ValueError("the reference solves the cosine schedule with v-prediction only")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.m, self.dev, self.precision = m, torch.device(device), precision
        bits = 4 if precision == "low" else 8
        f = lambda t: t.float()
        q = lambda t: quantized(t, bits)
        self.embed = raw["lm"]["embed"]  # rows are gathered, so it stays as made
        self.layers = []
        for lp in raw["lm"]["layers"]:
            a, mlp = lp["attn"], lp["mlp"]
            self.layers.append({
                "n1": f(lp["input_norm"]["w"]), "n2": f(lp["post_norm"]["w"]),
                "q": q(a["q"]["w"]), "qb": f(a["q"]["b"]), "k": q(a["k"]["w"]),
                "kb": f(a["k"]["b"]), "v": q(a["v"]["w"]), "vb": f(a["v"]["b"]),
                "o": q(a["o"]["w"]), "gate": q(mlp["gate"]["w"]), "up": q(mlp["up"]["w"]),
                "down": q(mlp["down"]["w"])})
        self.final_norm = f(raw["lm"]["final_norm"]["w"])
        cand = torch.tensor(sp.CANDIDATES, device=self.dev)
        self.head_cand = q(raw["lm_head"][cand].T.contiguous())  # per-token columns
        hd = raw["diffusion_head"]
        self.dh = {
            "noisy": f(hd["noisy_proj"]["w"]), "cond": f(hd["cond_proj"]["w"]),
            "t1": f(hd["t_embedder"]["fc1"]["w"]), "t2": f(hd["t_embedder"]["fc2"]["w"]),
            "layers": [{"norm": f(l["norm"]["w"]), "ada": f(l["adaln"]["w"]),
                        "gate": q(l["ffn"]["gate"]["w"]), "up": q(l["ffn"]["up"]["w"]),
                        "down": q(l["ffn"]["down"]["w"])} for l in hd["layers"]],
            "fada": f(hd["final"]["adaln"]["w"]), "flin": f(hd["final"]["linear"]["w"])}
        self.conn = {k: {n: {kk: f(vv) for kk, vv in raw[k][n].items()} for n in raw[k]}
                     for k in ("acoustic_connector", "semantic_connector")}
        self.scale = float(raw["speech_scaling_factor"])
        self.bias = float(raw["speech_bias_factor"])
        ac, se = raw["acoustic_tokenizer"], raw["semantic_tokenizer"]
        self.ac_enc = self._coder(ac["encoder"], None, bits)
        self.ac_dec = self._coder(ac["decoder"], 0, bits)
        self.se_enc = self._coder(se["encoder"], len(m.se_enc.depths) - 1, bits)
        self.solver = _solver(m, int(m.bench["ddpm_steps"]))

    def _coder(self, p, hot: Optional[int], bits: int):
        """f32 copies; the FFNs of stage ``hot`` as the serving packs hold them."""
        f = lambda t: t.float()
        convs = p["up"] if "up" in p else p["down"]
        return {
            "convs": [(f(c["w"]), f(c["b"])) for c in convs],
            "stages": [[{"n1": f(b["norm"]["w"]), "mix": f(b["mixer"]["w"]),
                         "mixb": f(b["mixer"]["b"]), "g1": f(b["gamma"]),
                         "n2": f(b["ffn_norm"]["w"]),
                         "fc1": quantized(b["ffn"]["fc1"]["w"], bits) if i == hot
                         else f(b["ffn"]["fc1"]["w"]), "b1": f(b["ffn"]["fc1"]["b"]),
                         "fc2": quantized(b["ffn"]["fc2"]["w"], bits) if i == hot
                         else f(b["ffn"]["fc2"]["w"]), "b2": f(b["ffn"]["fc2"]["b"]),
                         "g2": f(b["ffn_gamma"])} for b in stage]
                       for i, stage in enumerate(p["stages"])],
            "head": (f(p["head"]["w"]), f(p["head"]["b"]))}

    # -- precision ------------------------------------------------------

    def r(self, x: torch.Tensor) -> torch.Tensor:
        """An op's result as the precision keeps it."""
        if self.precision == "f32":
            return x
        s = x.abs().amax().clamp_min(1e-30) / FP8_MAX
        return (x / s).to(torch.float8_e4m3fn).float() * s

    # -- LM ---------------------------------------------------------------

    def _rope(self, x, pos):
        d = self.m.head_dim
        inv = 1.0 / (self.m.rope_theta ** (torch.arange(0, d, 2, device=self.dev,
                                                         dtype=torch.float64) / d))
        ang = (pos.double()[:, None] * inv[None]).float()
        cos, sin = torch.cat([ang.cos(), ang.cos()], -1), torch.cat([ang.sin(), ang.sin()], -1)
        half = d // 2
        rot = torch.cat([-x[..., half:], x[..., :half]], -1)
        return x * cos[:, None] + rot * sin[:, None]

    def _kv(self, t):
        """The cache's copy of new keys or values (T, KH, D)."""
        return self.r(t)

    def lm(self, seqs: List[torch.Tensor], caches: List[dict]) -> List[torch.Tensor]:
        """Each seqs[i] (T_i, H) appended to caches[i] ({"k", "v": per layer
        (S, KH, D)}); returns each sequence's final hidden states. The
        linears run over the sequences' rows together, the attention per
        sequence (causal, grouped heads)."""
        m = self.m
        nh, kh, d = m.heads, m.kv_heads, m.head_dim
        lens = [s.shape[0] for s in seqs]
        x = torch.cat(seqs).float()
        pos = torch.cat([torch.arange(c["n"], c["n"] + t, device=self.dev)
                         for c, t in zip(caches, lens)])
        for li, lp in enumerate(self.layers):
            h = self.r(_rms(x, lp["n1"], m.rms_eps))
            qa = self.r(h @ lp["q"] + lp["qb"]).view(-1, nh, d)
            ka = self.r(h @ lp["k"] + lp["kb"]).view(-1, kh, d)
            va = self.r(h @ lp["v"] + lp["vb"]).view(-1, kh, d)
            qa, ka = self.r(self._rope(qa, pos)), self.r(self._rope(ka, pos))
            outs, off = [], 0
            for c, t in zip(caches, lens):
                k, v = self._kv(ka[off: off + t]), self._kv(va[off: off + t])
                if c["k"][li] is not None:
                    k, v = torch.cat([c["k"][li], k]), torch.cat([c["v"][li], v])
                c["k"][li], c["v"][li] = k, v
                s = k.shape[0]
                qq = qa[off: off + t].transpose(0, 1)  # (NH, T, D)
                kk = k.transpose(0, 1).repeat_interleave(nh // kh, 0)
                vv = v.transpose(0, 1).repeat_interleave(nh // kh, 0)
                att = (qq @ kk.transpose(1, 2)) * d ** -0.5
                qpos = torch.arange(s - t, s, device=self.dev)[:, None]
                att = att.masked_fill(torch.arange(s, device=self.dev)[None] > qpos,
                                      float("-inf"))
                outs.append(self.r(torch.softmax(att, -1) @ vv).transpose(0, 1).reshape(t, -1))
                off += t
            x = self.r(x + self.r(torch.cat(outs) @ lp["o"]))
            h = self.r(_rms(x, lp["n2"], m.rms_eps))
            g = self.r(F.silu(self.r(h @ lp["gate"])) * self.r(h @ lp["up"]))
            x = self.r(x + self.r(g @ lp["down"]))
        for c, t in zip(caches, lens):
            c["n"] += t
        x = self.r(_rms(x, self.final_norm, m.rms_eps))
        return list(x.split(lens))

    def cand_logits(self, h: torch.Tensor) -> torch.Tensor:
        return h @ self.head_cand

    # -- connectors and the diffusion head --------------------------------

    def connector(self, name: str, x: torch.Tensor) -> torch.Tensor:
        p = self.conn[name]
        h = self.r(x @ p["fc1"]["w"] + p["fc1"]["b"])
        h = self.r(_rms(h, p["norm"]["w"], 1e-6))
        return self.r(h @ p["fc2"]["w"] + p["fc2"]["b"])

    def head(self, x, t, cond):
        """The head's raw output for noisy x (R, latent) at timestep t."""
        p, eps = self.dh, self.m.head_eps
        half = T_FREQ // 2
        freqs = torch.exp(-math.log(10000.0) * torch.arange(half, device=self.dev,
                                                             dtype=torch.float32) / half)
        ang = t.float()[:, None] * freqs[None]
        tf = torch.cat([torch.cos(ang), torch.sin(ang)], -1)
        c = self.r(cond @ p["cond"]) + self.r(self.r(F.silu(tf @ p["t1"])) @ p["t2"])
        sc = self.r(F.silu(c))
        x = self.r(x @ p["noisy"])
        for lp in p["layers"]:
            shift, scale, gate = self.r(sc @ lp["ada"]).chunk(3, -1)
            h = self.r(_rms(x, lp["norm"], eps) * (1 + scale) + shift)
            g = self.r(F.silu(self.r(h @ lp["gate"])) * self.r(h @ lp["up"]))
            x = self.r(x + gate * self.r(g @ lp["down"]))
        shift, scale = self.r(sc @ p["fada"]).chunk(2, -1)
        return self.r(self.r(_rms(x, None, eps) * (1 + scale) + shift) @ p["flin"])

    def diffuse(self, h_pos, h_neg, x_init):
        """The CFG-guided DPM-Solver++(2M) solve of one frame of each row:
        h_pos, h_neg (R, H), x_init (R, latent)."""
        s = self.solver
        cfg = float(self.m.bench["cfg_scale"])
        cond = torch.cat([h_pos, h_neg])
        x = x_init.float()
        prev = None
        for i, t in enumerate(s["t"]):
            tt = torch.full((2 * x.shape[0],), float(t), device=self.dev)
            c, u = self.head(torch.cat([x, x]), tt, cond).chunk(2)
            v = u + cfg * (c - u)
            x0 = s["alpha"][i] * x - s["sigma"][i] * v
            a_t, s_t, h = s["alpha"][i + 1], s["sigma"][i + 1], s["h"][i]
            phi = math.expm1(-h) if math.isfinite(h) else -1.0
            ratio = s_t / s["sigma"][i]
            if s["order"][i] == 1:
                x = ratio * x - a_t * phi * x0
            else:
                d1 = (x0 - prev) / s["r"][i]
                x = ratio * x - a_t * phi * x0 - 0.5 * a_t * phi * d1
            prev = x0
        return x

    # -- tokenizers -------------------------------------------------------

    def _conv(self, x, w, b, stride=1, groups=1):
        """Causal conv over (T, C): the left context k - stride, and right
        padding so that every input sample is consumed."""
        k, n = w.shape[-1], x.shape[0]
        pad = k - stride
        frames = (n - k + pad) / stride + 1
        extra = (math.ceil(frames) - 1) * stride + (k - pad) - n
        y = F.conv1d(F.pad(x.T[None], (pad, extra)), w, None, stride=stride, groups=groups)
        return self.r(y[0].T + b)

    def _block(self, p, x, eps):
        h = self.r(_rms(x, p["n1"], eps))
        h = self._conv(h, p["mix"], p["mixb"], groups=x.shape[1])
        x = self.r(x + p["g1"] * h)
        h = self.r(_rms(x, p["n2"], eps))
        h = self.r(F.gelu(self.r(h @ p["fc1"] + p["b1"])) @ p["fc2"] + p["b2"])
        return self.r(x + p["g2"] * h)

    def encode(self, which: str, audio: torch.Tensor) -> torch.Tensor:
        """Audio (T,) -> the encoder's mean latents (T // hop, D)."""
        c = self.m.ac_enc if which == "acoustic" else self.m.se_enc
        p = self.ac_enc if which == "acoustic" else self.se_enc
        x = self.r(audio.float()[:, None])
        for i, (w, b) in enumerate(p["convs"]):
            x = self._conv(x, w, b, stride=1 if i == 0 else c.ratios[i - 1])
            for blk in p["stages"][i]:
                x = self._block(blk, x, c.eps)
        return self._conv(x, *p["head"])

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Latents (T, D) -> audio (T * hop,)."""
        c, p = self.m.ac_dec, self.ac_dec
        x = self.r(latents.float())
        for i, (w, b) in enumerate(p["convs"]):
            if i == 0:
                x = self._conv(x, w, b)
            else:
                s = c.ratios[i - 1]
                y = F.conv_transpose1d(x.T[None], w, None, stride=s)[0].T
                x = self.r(y[: y.shape[0] - (w.shape[-1] - s)] + b)
            for blk in p["stages"][i]:
                x = self._block(blk, x, c.eps)
        return self._conv(x, *p["head"])[:, 0]

    # -- a frame at a time, the requests side by side ------------------------

    def _step_conv(self, st, key, x, w, b, stride=1, groups=1):
        """A causal conv over the next samples of (B, T, C), its left context
        carried in ``st[key]`` (zeros at first, as the full conv's padding)."""
        ctx = w.shape[-1] - stride
        prev = st.get(key)
        if prev is None:
            prev = torch.zeros(x.shape[0], ctx, x.shape[2], device=self.dev)
        full = torch.cat([prev, x], 1)
        st[key] = full[:, full.shape[1] - ctx:]
        y = F.conv1d(full.transpose(1, 2), w, None, stride=stride, groups=groups)
        return self.r(y.transpose(1, 2) + b)

    def _step_block(self, st, key, p, x, eps):
        h = self.r(_rms(x, p["n1"], eps))
        h = self._step_conv(st, key, h, p["mix"], p["mixb"], groups=x.shape[2])
        x = self.r(x + p["g1"] * h)
        h = self.r(_rms(x, p["n2"], eps))
        h = self.r(F.gelu(self.r(h @ p["fc1"] + p["b1"])) @ p["fc2"] + p["b2"])
        return self.r(x + p["g2"] * h)

    def decode_step(self, st, latent):
        """One latent a row (B, D) -> its hop samples (B, hop), the
        decoder's state in ``st`` (a new tensor a key each step, so a copy
        of the dict keeps a state)."""
        c, p = self.m.ac_dec, self.ac_dec
        x = self.r(latent.float())[:, None]
        for i, (w, b) in enumerate(p["convs"]):
            if i == 0:
                x = self._step_conv(st, "c0", x, w, b)
            else:
                s, k = c.ratios[i - 1], w.shape[-1]
                prev = st.get(f"c{i}")
                if prev is None:
                    prev = torch.zeros(x.shape[0], k - 1, x.shape[2], device=self.dev)
                full = torch.cat([prev, x], 1)
                st[f"c{i}"] = full[:, full.shape[1] - (k - 1):]
                y = F.conv_transpose1d(full.transpose(1, 2), w, None, stride=s).transpose(1, 2)
                y = y[:, : y.shape[1] - (k - s)]
                x = self.r(y[:, y.shape[1] - x.shape[1] * s:] + b)
            for j, blk in enumerate(p["stages"][i]):
                x = self._step_block(st, f"s{i}.{j}", blk, x, c.eps)
        return self._step_conv(st, "head", x, *p["head"])[:, :, 0]

    def encode_step(self, st, audio):
        """One frame's hop samples a row (B, hop) -> the semantic encoder's
        mean (B, D)."""
        c, p = self.m.se_enc, self.se_enc
        x = self.r(audio.float())[:, :, None]
        for i, (w, b) in enumerate(p["convs"]):
            x = self._step_conv(st, f"c{i}", x, w, b, stride=1 if i == 0 else c.ratios[i - 1])
            for j, blk in enumerate(p["stages"][i]):
                x = self._step_block(st, f"s{i}.{j}", blk, x, c.eps)
        return self._step_conv(st, "head", x, *p["head"])[:, 0]

    # -- a request ----------------------------------------------------------

    def prefill(self, req: Dict):
        """(h_pos, h_neg, the two caches) after the prompt: the voice
        prompts encoded, sampled with the request's own generator (its
        first draws, as the program draws them), connected and spliced over
        the prompt's speech placeholders; the negative stream's one-token
        <speech_start> prompt."""
        m = self.m
        ids = torch.as_tensor(req["input_ids"], device=self.dev)
        emb = self.r(self.embed[ids].float())
        voices = req["voices"]
        hop = m.hop
        wav = torch.zeros(len(voices), max(len(v) for v in voices))
        for i, v in enumerate(voices):
            wav[i, : len(v)] = torch.as_tensor(v)
        wav = wav.to(self.dev)
        means = torch.stack([self.encode("acoustic", w) for w in wav])
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(int(req["seed"]))
        std_eps = torch.randn(means.shape[0], generator=gen, device=self.dev)
        eps = torch.randn(means.shape, generator=gen, device=self.dev)
        if m.std_dist == "gaussian":
            lat = means + (std_eps * (m.fix_std / 0.8))[:, None, None] * eps
        elif m.std_dist == "fix":
            lat = means + m.fix_std * eps
        else:
            lat = means
        feats = self.connector("acoustic_connector", (lat + self.bias) * self.scale)
        valid = [math.ceil(len(v) / hop) for v in voices]
        rows = torch.cat([feats[i, :n] for i, n in enumerate(valid)])
        mask = torch.as_tensor(req["speech_mask"], device=self.dev)
        if int(mask.sum()) != rows.shape[0]:
            raise ValueError("the prompt's speech placeholders do not match its voices' frames")
        emb = emb.clone()
        emb[mask] = rows
        pos_c, neg_c = ({"n": 0, "k": [None] * m.layers, "v": [None] * m.layers}
                        for _ in range(2))
        neg_emb = self.r(self.embed[torch.tensor([sp.SPEECH_START], device=self.dev)].float())
        h_pos, h_neg = self.lm([emb, neg_emb], [pos_c, neg_c])
        return h_pos[-1:], h_neg[-1:], pos_c, neg_c

    def lm_step(self, x: torch.Tensor, cache: Dict) -> torch.Tensor:
        """One token a row, x (N, H), appended to a padded cache ({"k",
        "v": per layer (N, S, KH, D), "n": (N,) lengths}): each row
        attends its own keys. Returns the rows' final hidden states."""
        m = self.m
        nh, kh, d = m.heads, m.kv_heads, m.head_dim
        n_rows = x.shape[0]
        pos = cache["n"]
        rows = torch.arange(n_rows, device=self.dev)
        s_max = cache["k"][0].shape[1]
        mask = torch.arange(s_max, device=self.dev)[None] > pos[:, None]  # (N, S)
        for li, lp in enumerate(self.layers):
            h = self.r(_rms(x, lp["n1"], m.rms_eps))
            q = self.r(h @ lp["q"] + lp["qb"]).view(n_rows, nh, d)
            k = self.r(h @ lp["k"] + lp["kb"]).view(n_rows, kh, d)
            v = self.r(h @ lp["v"] + lp["vb"]).view(n_rows, kh, d)
            q, k = self.r(self._rope(q, pos)), self.r(self._rope(k, pos))
            cache["k"][li][rows, pos] = self._kv(k)
            cache["v"][li][rows, pos] = self._kv(v)
            kk = cache["k"][li].repeat_interleave(nh // kh, 2)  # (N, S, NH, D)
            vv = cache["v"][li].repeat_interleave(nh // kh, 2)
            att = torch.einsum("nhd,nshd->nhs", q, kk) * d ** -0.5
            att = att.masked_fill(mask[:, None], float("-inf"))
            o = self.r(torch.einsum("nhs,nshd->nhd", torch.softmax(att, -1), vv))
            x = self.r(x + self.r(o.reshape(n_rows, -1) @ lp["o"]))
            h = self.r(_rms(x, lp["n2"], m.rms_eps))
            g = self.r(F.silu(self.r(h @ lp["gate"])) * self.r(h @ lp["up"]))
            x = self.r(x + self.r(g @ lp["down"]))
        cache["n"] = pos + 1
        return self.r(_rms(x, self.final_norm, m.rms_eps))

    def _start(self, reqs: List[Dict], frames: int):
        """The requests prefilled side by side: (h_pos, h_neg (R, H), a
        padded cache of both streams with room for ``frames`` more)."""
        m, r = self.m, len(reqs)
        pre = [self.prefill(q) for q in reqs]
        s_max = max(c["n"] for _, _, c, _ in pre) + frames + 1
        cache = {"n": torch.tensor([c["n"] for _, _, c, _ in pre]
                                   + [c["n"] for _, _, _, c in pre], device=self.dev),
                 "k": [], "v": []}
        for li in range(m.layers):
            for key in ("k", "v"):
                buf = torch.zeros(2 * r, s_max, m.kv_heads, m.head_dim, device=self.dev)
                for i, (_, _, pc, nc) in enumerate(pre):
                    buf[i, : pc["n"]] = pc[key][li]
                    buf[r + i, : nc["n"]] = nc[key][li]
                cache[key].append(buf)
        return torch.cat([p[0] for p in pre]), torch.cat([p[1] for p in pre]), cache

    def _feed(self, latent, sem, cache):
        """The next LM step of both streams from a frame's latent and its
        semantic latent (R, .); returns (h_pos, h_neg)."""
        e = self.r(self.connector("acoustic_connector", latent)
                   + self.connector("semantic_connector", sem))
        h = self.lm_step(torch.cat([e, e]), cache)
        return h[: e.shape[0]], h[e.shape[0]:]

    @torch.no_grad()
    def follow(self, reqs: List[Dict], noises: List[torch.Tensor], latents: List[torch.Tensor],
               audios: List[torch.Tensor], tokens: Optional[List[List[int]]] = None):
        """Decode the requests side by side, each len(noise) frames (noise:
        each frame's initial latent), teacher-forced by what was served:
        each frame's latent (n, D) and its audio's semantic re-encode are
        the next LM step's inputs, as the served ids are a text model's.
        Returns per request the reference's latent of each frame (n, D),
        its audio of each frame decoded from the served latents (n, hop),
        and the gap of the served token's logit (``tokens``;
        <speech_diffusion>, which greedy decoding of the edited weights
        chooses, if not given) below the best candidate's, a token outside
        the candidates infinitely far (n,)."""
        m, hop = self.m, self.m.hop
        r = len(reqs)
        lens = [n.shape[0] for n in noises]
        n_max = max(lens)
        noise = torch.zeros(r, n_max, m.latent, device=self.dev)
        fed = torch.zeros(r, n_max, m.latent, device=self.dev)
        sem = torch.zeros(r, n_max, m.semantic_dim, device=self.dev)
        for i, (z, lat, a) in enumerate(zip(noises, latents, audios)):
            noise[i, : lens[i]] = z.to(self.dev).float()
            fed[i, : lens[i]] = lat.to(self.dev).float()
            sem[i, : lens[i]] = self.encode("semantic", a.to(self.dev).float()[: lens[i] * hop])
        cols = torch.full((r, n_max), sp.CANDIDATES.index(sp.SPEECH_DIFFUSION),
                          dtype=torch.long)
        bad = torch.zeros(r, n_max, dtype=torch.bool)
        for i, toks in enumerate(tokens or []):
            for j, t in enumerate(toks[:n_max]):
                if t in sp.CANDIDATES:
                    cols[i, j] = sp.CANDIDATES.index(t)
                else:
                    bad[i, j] = True
        cols = cols.to(self.dev)
        h_pos, h_neg, cache = self._start(reqs, n_max)
        gaps, lats, audio, dec = [], [], [], {}
        for j in range(n_max):
            lg = self.cand_logits(h_pos)
            gaps.append(lg.max(-1).values - lg.gather(1, cols[:, j: j + 1])[:, 0])
            lats.append(self.diffuse(h_pos, h_neg, noise[:, j]))
            audio.append(self.decode_step(dec, fed[:, j] / self.scale - self.bias))
            if j < n_max - 1:
                h_pos, h_neg = self._feed(fed[:, j], sem[:, j], cache)
        lats, audio = torch.stack(lats, 1), torch.stack(audio, 1)
        gaps = torch.stack(gaps, 1).cpu().masked_fill(bad, float("inf")).numpy()
        return [(lats[i, : lens[i]], audio[i, : lens[i]], gaps[i, : lens[i]]) for i in range(r)]

    @torch.no_grad()
    def generate(self, reqs: List[Dict], noises: List[torch.Tensor]):
        """The reference's own decode of the requests side by side, each
        len(noise) frames, each frame's latent and audio fed back (the
        control put in the program's place); returns per request its
        latents (n, D) and audio (n * hop,)."""
        m, r = self.m, len(reqs)
        lens = [n.shape[0] for n in noises]
        noise = torch.zeros(r, max(lens), m.latent, device=self.dev)
        for i, z in enumerate(noises):
            noise[i, : lens[i]] = z.to(self.dev).float()
        h_pos, h_neg, cache = self._start(reqs, max(lens))
        dec, enc, lats, audio = {}, {}, [], []
        for j in range(max(lens)):
            lats.append(self.diffuse(h_pos, h_neg, noise[:, j]))
            audio.append(self.decode_step(dec, lats[-1] / self.scale - self.bias))
            if j < max(lens) - 1:
                h_pos, h_neg = self._feed(lats[-1], self.encode_step(enc, audio[-1]), cache)
        lats, audio = torch.stack(lats, 1), torch.stack(audio, 1)
        return [(lats[i, : lens[i]], audio[i, : lens[i]].reshape(-1)) for i in range(r)]


def _solver(m: sp.Model, steps: int) -> Dict:
    """DPM-Solver++(2M) on the cosine schedule (first order at the first
    and the last step, the final sigma 0), in float64."""
    n_train = m.ddpm_train_steps
    fn = lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2
    betas = np.array([min(1 - fn((i + 1) / n_train) / fn(i / n_train), 0.999)
                      for i in range(n_train)])
    ac = np.cumprod(1.0 - betas)
    sig_full = np.sqrt((1 - ac) / ac)
    t = np.linspace(0, n_train - 1, steps + 1).round()[::-1][:-1].astype(np.int64)
    sig = np.concatenate([sig_full[t], [0.0]])
    alpha = 1.0 / np.sqrt(sig ** 2 + 1)
    sigma = sig * alpha
    with np.errstate(divide="ignore"):
        lam = np.log(alpha) - np.log(sigma)
    h = [lam[i + 1] - lam[i] for i in range(steps)]
    order = [1 if i in (0, steps - 1) else 2 for i in range(steps)]
    r = [None] + [(lam[i] - lam[i - 1]) / h[i] for i in range(1, steps)]
    return {"t": t.astype(np.float64).tolist(), "alpha": alpha.tolist(),
            "sigma": sigma.tolist(), "h": h, "order": order, "r": r}
