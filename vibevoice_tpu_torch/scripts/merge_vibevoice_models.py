"""Merge trained LoRA adapters and component overrides into a base
checkpoint (port of vibevoice_tpu/scripts/merge_vibevoice_models.py).

It reads the adapters (``lora_adapters.pkl``) and the dense overrides
(``extras.pkl``) that either package's trainer writes, merges the LM's
adapters (attention and MLP projections) and the diffusion head's, swaps in
the trained connectors or full head, then verifies the merge before it
saves anything: every adapted weight equals base + (alpha / r) * A @ B
(and changed where that delta is nonzero), every overridden tensor equals
the trained one exactly, and the parameter count is unchanged. The merged
tree is written in the native format (``params.pkl``, which both packages'
``load_native`` read). The merge runs on the card unless given
``--device cpu``.

Usage:
  python -m vibevoice_tpu_torch.scripts.merge_vibevoice_models \\
      --base_model <checkpoint dir> --trained_checkpoint <output_dir/checkpoint-N> \\
      --output_dir merged/ [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import pickle

import torch


def _check_close(tag: str, got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float):
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        err = (got - want).abs().max().item()
        raise AssertionError(f"{tag}: merged weight differs from base + scaling * A @ B by "
                             f"{err:.3e} (rtol {rtol:g}, atol {atol:g})")


def _verify_adapted(tag, base_entry, merged_entry, pair, scaling, rtol, atol):
    """merged == base + scaling * A @ B, and changed iff the delta is
    nonzero. Returns (changed, unchanged) counts."""
    b = base_entry["w"].float()
    m = merged_entry["w"].float()
    delta = (pair["a"].float() @ pair["b"].float()).to(b.device) * scaling
    changed = int(delta.abs().max().item() > 0)
    if changed and torch.allclose(b, m, rtol=rtol, atol=atol):
        raise AssertionError(f"{tag}: merge produced no weight change despite nonzero delta")
    _check_close(tag, m, b + delta, rtol, max(atol, 1e-6))
    return changed, 1 - changed


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def merge_and_verify(params, merged, lora, lora_cfg, extras=None, rtol=1e-5, atol=1e-8):
    """Verify ``merged`` against base ``params`` + adapters and overrides.
    Returns a dict of counters; raises AssertionError on any mismatch."""
    changed = unchanged = 0
    for li, (base_l, merged_l, entry) in enumerate(
            zip(params["lm"]["layers"], merged["lm"]["layers"], lora["lm_layers"])):
        for group, names in (("attn", ("q", "k", "v", "o")), ("mlp", ("gate", "up", "down"))):
            for name in names:
                if name not in entry:
                    continue
                c, u = _verify_adapted(f"lm layer {li} {group}.{name}", base_l[group][name],
                                       merged_l[group][name], entry[name], lora_cfg.scaling,
                                       rtol, atol)
                changed += c
                unchanged += u

    head_changed = head_unchanged = 0
    if "diffusion_head_layers" in lora:
        for li, (base_l, merged_l, entry) in enumerate(
                zip(params["diffusion_head"]["layers"], merged["diffusion_head"]["layers"],
                    lora["diffusion_head_layers"])):
            for name in ("gate", "up", "down"):
                c, u = _verify_adapted(f"diffusion_head layer {li} ffn.{name}",
                                       base_l["ffn"][name], merged_l["ffn"][name], entry[name],
                                       lora_cfg.scaling, rtol, atol)
                head_changed += c
                head_unchanged += u

    # overridden components must be exactly the trained tensors
    overridden = []
    for key, trained in (extras or {}).items():
        got, want = list(_leaves(merged[key])), dict(_leaves(trained))
        if len(got) != len(want):
            raise AssertionError(f"{key}: override structure mismatch ({len(got)} vs "
                                 f"{len(want)} tensors)")
        for path, leaf in got:
            ref = torch.as_tensor(want[path]).to(leaf.device)
            if leaf.dtype != ref.dtype or not torch.equal(leaf, ref):
                raise AssertionError(f"override {key}{path} not exactly the trained tensor")
        overridden.append(key)

    return {"lm_changed": changed, "lm_unchanged": unchanged, "head_changed": head_changed,
            "head_unchanged": head_unchanged, "overridden": overridden}


def _count(tree) -> int:
    return sum(leaf.numel() for _, leaf in _leaves(tree) if isinstance(leaf, torch.Tensor))


def run_merge(base_model, trained_checkpoint, output_dir, rtol=1e-5, atol=1e-8, device="cuda"):
    from ..finetune.lora import LoraConfig, apply_lora, to_torch
    from ..utils.hf_interop import load_checkpoint, load_native, save_native
    from ..utils.params import _device

    device = _device(device)
    if os.path.exists(os.path.join(base_model, "params.pkl")):
        cfg, params = load_native(base_model, device=device)
    else:
        cfg, params, _ = load_checkpoint(base_model, dtype="float32", device=device)

    lora_dir = trained_checkpoint
    if os.path.isdir(os.path.join(lora_dir, "lora")):
        lora_dir = os.path.join(lora_dir, "lora")
    with open(os.path.join(lora_dir, "lora_adapters.pkl"), "rb") as f:
        blob = pickle.load(f)
    lora_cfg = LoraConfig(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in blob["config"].items()})
    lora = to_torch(blob["lora"], device)
    print(f"Detected LoRA adapters: r={lora_cfg.r} alpha={lora_cfg.alpha} "
          f"targets={lora_cfg.target_modules} head={lora_cfg.train_diffusion_head}"
          f"{' (full-rank override)' if lora_cfg.full_diffusion_head else ''}")

    extras = None
    extras_path = os.path.join(lora_dir, "extras.pkl")
    if os.path.exists(extras_path):
        with open(extras_path, "rb") as f:
            extras = to_torch(pickle.load(f), device)
        print(f"Detected trained component overrides: {sorted(extras)}")
        lora = {**lora, "extras": extras}

    merged = apply_lora(params, lora, lora_cfg)

    report = merge_and_verify(params, merged, lora, lora_cfg, extras, rtol, atol)
    print(f"Verified LM merge: {report['lm_changed']} weights changed, "
          f"{report['lm_unchanged']} zero-delta")
    if "diffusion_head_layers" in lora:
        print(f"Verified diffusion-head merge: {report['head_changed']} changed, "
              f"{report['head_unchanged']} zero-delta")
    for key in report["overridden"]:
        print(f"Verified component override: {key} (exact match)")

    n_base, n_merged = _count(params), _count(merged)
    if n_base != n_merged:
        raise AssertionError(f"parameter count changed: {n_base} vs {n_merged}")

    save_native(output_dir, cfg, merged)
    print(f"Merged model saved to {output_dir}")
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base_model", required=True, help="base checkpoint dir (HF or native)")
    ap.add_argument("--trained_checkpoint", required=True, help="dir containing lora/ assets")
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--atol", type=float, default=1e-8)
    ap.add_argument("--rtol", type=float, default=1e-5)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; there must be a card) or cpu")
    args = ap.parse_args(argv)
    from ..utils.params import _device

    try:
        _device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"--device {args.device}: {e}; pass --device cpu") from e
    return run_merge(args.base_model, args.trained_checkpoint, args.output_dir, args.rtol,
                     args.atol, args.device)


if __name__ == "__main__":
    main()
