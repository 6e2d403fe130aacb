"""Training forward and loss of VibeVoice fine-tuning
(port of vibevoice_tpu/finetune/loss.py).

* The frozen acoustic tokenizer encodes each clip (under ``torch.no_grad``,
  the JAX ``stop_gradient``), the σ-VAE posterior is sampled, and the
  first-batch scaling statistics initialise NaN factors.
* Connector features are spliced into the token embeddings and the LM runs
  its no-cache training forward (training flash attention on CUDA).
* CE over text positions, dense or in sequence chunks each under
  ``torch.utils.checkpoint`` (the (B, T, vocab) f32 logits never exist).
* Diffusion loss: target latents scattered to their positions, conditioned
  on hidden[p - 1], noised at ``ddpm_batch_mul`` timesteps each, the
  diffusion head predicts v (or eps).

Randomness: four draws, in the order of the JAX key split (``loss.py:174``):
the σ-VAE std and eps, the diffusion noise and the timesteps, the last two
at the full B*T*mul size and then gathered under a head position budget.
They come from a ``torch.Generator`` or, to reproduce a run of the JAX
package, from an explicit ``Draws``.

Unlike the JAX package the clips are encoded one at a time, which bounds the
encoder's transient memory by one clip (an 18-minute clip at full width
needs ~30 GB of intermediates on its own).

Data parallelism (``dp_group``): each rank holds its samples of one global
batch (``split_batch``). The speech statistics are summed over the group,
and the losses are normalised by global counts, as the JAX package's step
over a sharded global batch computes them: each rank's loss carries the
value of the global loss and the gradient of its own share, so the
gradients summed over the group are the global gradient. With a generator,
every rank draws the global batch's random numbers and keeps its rows, so
the step equals the one-device step on the global batch. ``lm_forward``
swaps the LM stack (``parallel.pipeline.make_pp_lm_forward``); ``tp_group``
runs the LM on this rank's tensor-parallel shards.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from ..configs import VibeVoiceConfig

from ..models import diffusion_head as dh
from ..models import qwen2
from ..models import tokenizer as tok
from ..models import vibevoice as vv
from ..schedule.dpm_solver import NoiseSchedule


@dataclass(frozen=True)
class TrainOptions:
    ce_loss_weight: float = 1.0
    diffusion_loss_weight: float = 1.0
    ddpm_batch_mul: int = 4
    # memory levers, both exact: remat recomputes each LM layer (and the
    # diffusion head) in the backward; ce_chunk_size > 0 computes the CE in
    # sequence chunks
    remat: bool = False
    ce_chunk_size: int = 0
    # with remat, "dots" keeps the matmul outputs (faster backward, more
    # memory); None recomputes everything
    remat_policy: Optional[str] = None
    # K > 0: the diffusion head runs on the first K speech positions of each
    # sample (exact when K covers every sample's target frames)
    head_position_budget: int = 0


class Batch(NamedTuple):
    """One collated training batch (see finetune/data.py); right-padded.
    numpy arrays from the collator or tensors."""

    input_ids: object  # (B, T) int
    attention_mask: object  # (B, T) bool
    speech_tensors: object  # (N, T_wav) float: voice + target clips
    speech_masks: object  # (N, F) bool latent-frame validity
    speech_semantic_tensors: object  # (N, F, D_sem) semantic features
    speeches_loss_input: object  # (N,) bool: the clip is a diffusion target
    acoustic_input_mask: object  # (B, T) bool: all latent positions
    acoustic_loss_mask: object  # (B, T) bool: target latent positions


class TrainOut(NamedTuple):
    loss: torch.Tensor
    ce_loss: torch.Tensor
    diffusion_loss: torch.Tensor
    speech_scaling_factor: torch.Tensor
    speech_bias_factor: torch.Tensor
    ce_token_count: torch.Tensor
    ce_max: torch.Tensor
    ce_accuracy: torch.Tensor
    speech_frame_count: torch.Tensor


class Draws(NamedTuple):
    """The random numbers of one training forward."""

    vae_std: Optional[torch.Tensor]  # (N,) standard normal, 'gaussian' σ-VAE only
    vae_eps: torch.Tensor  # (N, F, vae_dim) standard normal
    noise: torch.Tensor  # (B*T*mul, latent) standard normal
    timesteps: torch.Tensor  # (B*T*mul,) integers in [0, ddpm_num_steps)


_BATCH_DTYPES = dict(input_ids=torch.long, attention_mask=torch.bool,
                     speech_tensors=torch.float32, speech_masks=torch.bool,
                     speech_semantic_tensors=torch.float32, speeches_loss_input=torch.bool,
                     acoustic_input_mask=torch.bool, acoustic_loss_mask=torch.bool)


def batch_to(batch: Batch, device) -> Batch:
    """The batch as tensors on ``device`` (the collator gives numpy arrays)."""
    out = {}
    for name, dt in _BATCH_DTYPES.items():
        x = getattr(batch, name)
        x = torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
        out[name] = x.to(device=device, dtype=dt)
    return Batch(**out)


def draw(generator: Optional[torch.Generator], *, n: int, frames: int, vae_dim: int,
         rows: int, latent: int, num_steps: int, dist_type: str, device) -> Draws:
    """Draw the four random inputs of ``train_forward`` from ``generator``."""
    kw = dict(generator=generator, device=device)
    std = torch.randn(n, **kw) if dist_type == "gaussian" else None
    eps = torch.randn(n, frames, vae_dim, **kw)
    noise = torch.randn(rows, latent, **kw)
    ts = torch.randint(0, num_steps, (rows,), **kw)
    return Draws(std, eps, noise, ts)


def split_batch(batch: Batch, n: int, i: int) -> Batch:
    """Rank i's part of a collated global batch over n data ranks: samples
    [i B/n, (i + 1) B/n) with their speech clips, each clip wholly in the
    sample whose latent positions take its frames (clips in sample order).
    Sequence and frame padding stay the global batch's."""
    arr = lambda x: np.asarray(x)
    b = arr(batch.input_ids).shape[0]
    if b % n:
        raise ValueError(f"a global batch of {b} samples does not split over {n} data ranks")
    m = b // n
    per_sample = arr(batch.acoustic_input_mask).sum(axis=1)
    per_clip = arr(batch.speech_masks).sum(axis=1)
    bounds = np.concatenate([[0], np.cumsum(per_sample)])
    clip_end = np.cumsum(per_clip)
    c0 = int(np.searchsorted(clip_end, bounds[i * m], side="right"))
    c1 = int(np.searchsorted(clip_end, bounds[(i + 1) * m], side="left")) + 1
    c1 = min(c1, len(per_clip)) if bounds[(i + 1) * m] > bounds[i * m] else c0
    rows, clips = slice(i * m, (i + 1) * m), slice(c0, c1)
    return Batch(input_ids=arr(batch.input_ids)[rows],
                 attention_mask=arr(batch.attention_mask)[rows],
                 speech_tensors=arr(batch.speech_tensors)[clips],
                 speech_masks=arr(batch.speech_masks)[clips],
                 speech_semantic_tensors=arr(batch.speech_semantic_tensors)[clips],
                 speeches_loss_input=arr(batch.speeches_loss_input)[clips],
                 acoustic_input_mask=arr(batch.acoustic_input_mask)[rows],
                 acoustic_loss_mask=arr(batch.acoustic_loss_mask)[rows])


def _dp_sum(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over the data group (a copy; no gradient flows through)."""
    if group is None:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, group=group)
    return y


def _global(local: torch.Tensor, group) -> torch.Tensor:
    """The global value (summed over the group) with the gradient of this
    rank's share."""
    if group is None:
        return local
    return local + (_dp_sum(local, group) - local.detach())


def _dp_draws(generator, group, *, b: int, n: int, t: int, mul: int, **kw) -> Draws:
    """This rank's rows of the global batch's draws: every rank of the data
    group draws them all from its (identically seeded) generator."""
    sizes = torch.tensor([b, n], dtype=torch.int64, device=kw["device"])
    parts = [torch.empty_like(sizes) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, sizes, group=group)
    sizes = torch.stack(parts).cpu()
    me = dist.get_rank(group)
    b0, n0 = (int(x) for x in sizes[:me].sum(0))
    bg, ng = (int(x) for x in sizes.sum(0))
    full = draw(generator, n=ng, rows=bg * t * mul, **kw)
    rows = slice(b0 * t * mul, (b0 + b) * t * mul)
    return Draws(None if full.vae_std is None else full.vae_std[n0:n0 + n],
                 full.vae_eps[n0:n0 + n], full.noise[rows], full.timesteps[rows])


def _masked_std_mean(x: torch.Tensor, mask: torch.Tensor, dp_group=None):
    """Std (unbiased, as torch.std) and mean of the masked latent elements,
    over the data group's samples too."""
    m = mask[..., None].float()
    n = _dp_sum(m.sum() * x.shape[-1], dp_group)
    s = _dp_sum((x * m).sum(), dp_group)
    ss = _dp_sum((x.square() * m).sum(), dp_group)
    mean = s / n.clamp_min(1.0)
    var = (ss - n * mean.square()) / (n - 1.0).clamp_min(1.0)
    return var.sqrt(), mean


def _pad_t(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Pad axis 1 with `pad` zero (False) entries."""
    if not pad:
        return x
    shape = list(x.shape)
    shape[1] = pad
    return torch.cat([x, torch.zeros(shape, dtype=x.dtype, device=x.device)], dim=1)


def _ce_stats(params, hc, lc, mc):
    mcf = mc.float()
    logits = vv.lm_logits(params, hc).float()
    logp = torch.log_softmax(logits, dim=-1)
    tlp = logp.gather(-1, lc[..., None])[..., 0]
    s = (-tlp * mcf).sum()
    mx = torch.where(mc, -tlp, torch.zeros_like(tlp)).max()
    hit = ((logits.argmax(dim=-1) == lc) & mc).float().sum()
    return s, mcf.sum(), mx, hit


def _ce_chunked(params, hidden, labels, label_mask, chunk: int):
    """CE statistics (the sum, the count, the max and the hits) over
    sequence chunks, each under torch.utils.checkpoint: the forward keeps
    per-chunk scalars only and the backward recomputes each chunk's logits.
    Exact (same loss and gradients as the dense path)."""
    tm1 = hidden.shape[1]
    n_chunks = -(-tm1 // chunk)
    pad = n_chunks * chunk - tm1
    hs, ls, ms = _pad_t(hidden, pad), _pad_t(labels, pad), _pad_t(label_mask, pad)
    s = n = mx = hit = torch.zeros((), device=hidden.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        cs, cn, cmx, chit = checkpoint(_ce_stats, params, hs[:, sl], ls[:, sl], ms[:, sl],
                                       use_reentrant=False)
        s, n, mx, hit = s + cs, n + cn, torch.maximum(mx, cmx), hit + chit
    return s, n, mx, hit


def train_forward(
    cfg: VibeVoiceConfig,
    params: Dict,
    batch: Batch,
    generator: Optional[torch.Generator] = None,
    opts: TrainOptions = TrainOptions(),
    noise_schedule: Optional[NoiseSchedule] = None,
    draws: Optional[Draws] = None,
    lm_forward=None,
    dp_group=None,
    tp_group=None,
) -> TrainOut:
    """Loss of one batch. Randomness from ``draws`` when given (this rank's
    rows under ``dp_group``), else from ``generator`` (a generator on the
    parameters' device). ``lm_forward(cfg, lm_params, embeds, valid_mask,
    remat, remat_policy) -> hidden`` replaces the LM forward; ``dp_group``
    and ``tp_group`` as in the module docstring."""
    hcfg = cfg.diffusion_head_config
    acfg = cfg.acoustic_tokenizer_config
    qwen2.check_remat_policy(opts.remat_policy)
    if noise_schedule is None:
        noise_schedule = NoiseSchedule.create(hcfg.ddpm_num_steps, hcfg.ddpm_beta_schedule)
    embed = params["lm"]["embed"]
    dev, dtype = embed.device, embed.dtype
    batch = batch_to(batch, dev)
    b, t = batch.input_ids.shape
    n = batch.speech_masks.shape[0]
    mul, d = opts.ddpm_batch_mul, hcfg.latent_size

    # ---- acoustic encode + σ-sample + scaling stats (frozen) --------------
    with torch.no_grad(), record_function("vv.encode"):
        wav = batch.speech_tensors[..., None].to(dtype)
        mean = torch.cat([tok.encode(acfg, params["acoustic_tokenizer"], wav[i:i + 1])[0]
                          for i in range(n)]).float()
        if draws is None:
            kw = dict(frames=mean.shape[1], vae_dim=mean.shape[2], latent=d,
                      num_steps=hcfg.ddpm_num_steps, dist_type=acfg.std_dist_type, device=dev)
            if dp_group is None:
                draws = draw(generator, n=n, rows=b * t * mul, **kw)
            else:
                draws = _dp_draws(generator, dp_group, b=b, n=n, t=t, mul=mul, **kw)
        vae_std = draws.vae_std.to(dev) if draws.vae_std is not None else None
        latents = tok.sample_latents_from_noise(mean, acfg.fix_std, acfg.std_dist_type, vae_std,
                                                draws.vae_eps.to(dev))

    scaling = torch.as_tensor(params["speech_scaling_factor"], dtype=torch.float32, device=dev)
    bias = torch.as_tensor(params["speech_bias_factor"], dtype=torch.float32, device=dev)
    std, lat_mean = _masked_std_mean(latents, batch.speech_masks, dp_group)
    need_init = torch.isnan(scaling) | torch.isnan(bias)
    scaling = torch.where(need_init, 1.0 / std, scaling)
    bias = torch.where(need_init, -lat_mean, bias)
    speech_features = (latents + bias) * scaling  # (N, F, D) f32

    # ---- splice connector features into the token embeddings -------------
    connect = (vv.connector_apply(params["acoustic_connector"], speech_features.to(dtype))
               + vv.connector_apply(params["semantic_connector"],
                                    batch.speech_semantic_tensors.to(dtype)))
    embeds = qwen2.embed_tokens(params["lm"], batch.input_ids)
    embeds = vv.splice_speech_features(embeds, batch.acoustic_input_mask, connect,
                                       batch.speech_masks)

    # ---- LM forward --------------------------------------------------------
    with record_function("vv.lm_forward"):
        if lm_forward is not None:
            hidden = lm_forward(cfg.decoder_config, params["lm"], embeds, batch.attention_mask,
                                opts.remat, opts.remat_policy)
        else:
            hidden, _ = qwen2.forward(cfg.decoder_config, params["lm"], embeds,
                                      valid_mask=batch.attention_mask, remat=opts.remat,
                                      remat_policy=opts.remat_policy, tp_group=tp_group)

    # ---- CE over text positions (pads and acoustic positions masked) -----
    labels = batch.input_ids[:, 1:]
    label_mask = (batch.attention_mask[:, 1:] & batch.attention_mask[:, :-1]
                  & ~batch.acoustic_input_mask[:, 1:])
    with record_function("vv.ce"):
        if opts.ce_chunk_size > 0:
            s, cnt, ce_max, hit = _ce_chunked(params, hidden[:, :-1], labels, label_mask,
                                              opts.ce_chunk_size)
        else:
            s, cnt, ce_max, hit = _ce_stats(params, hidden[:, :-1], labels, label_mask)
        cnt, hit = _dp_sum(cnt, dp_group), _dp_sum(hit, dp_group)
        if dp_group is not None:
            ce_max = ce_max.detach().clone()
            dist.all_reduce(ce_max, op=dist.ReduceOp.MAX, group=dp_group)
        ce = _global(s / cnt.clamp_min(1.0), dp_group)
        ce_acc = hit / cnt.clamp_min(1.0)
        n_ce = cnt.to(torch.int32)

    # ---- diffusion loss ----------------------------------------------------
    target_valid = batch.speech_masks & batch.speeches_loss_input[:, None]
    lat_at_pos = vv.splice_speech_features(
        torch.zeros(b, t, d, dtype=torch.float32, device=dev), batch.acoustic_loss_mask,
        speech_features, target_valid)
    cond_at_pos = torch.roll(hidden, 1, dims=1).float()  # position p is conditioned on p - 1
    loss_mask = batch.acoustic_loss_mask & (torch.arange(t, device=dev)[None, :] > 0)

    k_pos = opts.head_position_budget
    noise, timesteps = draws.noise.to(dev), draws.timesteps.to(dev)
    if k_pos > 0:
        k_pos = min(k_pos, t)
        idx = torch.argsort((~loss_mask).to(torch.int8), dim=1, stable=True)[:, :k_pos]
        lat_at_pos = lat_at_pos.gather(1, idx[..., None].expand(-1, -1, d))
        cond_at_pos = cond_at_pos.gather(1, idx[..., None].expand(-1, -1, cond_at_pos.shape[-1]))
        head_mask = loss_mask.gather(1, idx)
        rows = b * k_pos
        base = (torch.arange(b, device=dev)[:, None] * t + idx) * mul  # (B, K)
        flat = (base[..., None] + torch.arange(mul, device=dev)).reshape(-1)
        noise, timesteps = noise[flat], timesteps[flat]
    else:
        head_mask = loss_mask
        rows = b * t
    x0 = lat_at_pos.reshape(rows, d).repeat_interleave(mul, dim=0)
    cond = cond_at_pos.reshape(rows, -1).repeat_interleave(mul, dim=0)

    noisy = noise_schedule.add_noise(x0, noise, timesteps)
    head_args = (params["diffusion_head"], hcfg, noisy.to(dtype), timesteps.float(),
                 cond.to(dtype))
    with record_function("vv.diffusion_head"):
        if opts.remat:
            pred = qwen2.checkpointed(dh.apply, *head_args, policy=opts.remat_policy)
        else:
            pred = dh.apply(*head_args)
    pred = pred.float()
    if hcfg.prediction_type == "v_prediction":
        target = noise_schedule.get_velocity(x0, noise, timesteps)
    elif hcfg.prediction_type == "epsilon":
        target = noise
    else:
        raise NotImplementedError(hcfg.prediction_type)

    per_elem = (pred - target).square()
    elem_mask = head_mask.reshape(-1).repeat_interleave(mul)[:, None].float()
    speech_len = _dp_sum(loss_mask.sum(), dp_group)
    diffusion_loss = _global((per_elem * elem_mask).sum() / d / mul / speech_len.clamp_min(1),
                             dp_group)

    total = opts.ce_loss_weight * ce + opts.diffusion_loss_weight * diffusion_loss
    return TrainOut(
        loss=total,
        ce_loss=ce,
        diffusion_loss=diffusion_loss,
        speech_scaling_factor=scaling.detach(),
        speech_bias_factor=bias.detach(),
        ce_token_count=n_ce,
        ce_max=ce_max,
        ce_accuracy=ce_acc,
        speech_frame_count=speech_len.to(torch.int32),
    )
