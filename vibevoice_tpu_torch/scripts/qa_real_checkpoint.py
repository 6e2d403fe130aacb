"""One-command QA harness for a real VibeVoice checkpoint (port of
vibevoice_tpu/scripts/qa_real_checkpoint.py).

Given a weights directory (HF sharded-safetensors layout), it runs:
  1. convert   - load_checkpoint (a missing tokenizer fails unless allowed);
  2. parity    - per-component numeric parity against the upstream PyTorch
                 reference built from the same weights (the acoustic encode
                 and decode, the semantic encode, the diffusion head, the LM
                 prefill's hidden states and logits); skipped, with the
                 reason in the report, when the reference (``transformers``
                 and the ``vibevoice`` package under ``--reference_path``)
                 does not import. A skip is not a pass: the report says so;
  3. generate  - a short natural two-speaker generate through the processor;
  4. rtf       - a forced-diffusion decode bench through the graphed frame
                 step (8 frames a dispatch), true per-frame decode cost on
                 random or real weights;
and writes one JSON report with the JAX harness's keys. Exit code 1 if a
parity check fails. The model runs on the card unless given --device cpu.

Usage:
  python -m vibevoice_tpu_torch.scripts.qa_real_checkpoint CKPT_DIR \\
      [--dtype float32] [--reference_path /path/to/reference] \\
      [--frames 32] [--ddpm_steps 10] [--report qa_report.json] \\
      [--allow_fallback_tokenizer] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def _tolerances(dtype: str):
    # bf16 weights round-trip through the f32 conversion: loose by design
    return (1e-3, 3e-4) if dtype == "float32" else (5e-2, 5e-2)


def build_reference_model(cfg, ckpt_dir: str, reference_path: str | None):
    """The upstream PyTorch model built from this config (field by field,
    no config.json parsing) with the same weights; (None, why) when it does
    not import or load."""
    if reference_path and reference_path not in sys.path:
        sys.path.insert(0, reference_path)
    try:
        import torch
        from transformers.models.qwen2 import Qwen2Config
        from vibevoice.modular.configuration_vibevoice import (
            VibeVoiceAcousticTokenizerConfig,
            VibeVoiceConfig,
            VibeVoiceDiffusionHeadConfig,
            VibeVoiceSemanticTokenizerConfig,
        )
        from vibevoice.modular.modeling_vibevoice_inference import (
            VibeVoiceForConditionalGenerationInference,
        )
    except Exception as e:  # the reference is not installed: parity is skipped
        return None, f"reference unavailable: {e!r}"

    a, s, d, h = (cfg.acoustic_tokenizer_config, cfg.semantic_tokenizer_config,
                  cfg.decoder_config, cfg.diffusion_head_config)
    rcfg = VibeVoiceConfig(
        acoustic_tokenizer_config=VibeVoiceAcousticTokenizerConfig(
            vae_dim=a.vae_dim, encoder_n_filters=a.encoder_n_filters,
            encoder_ratios=list(a.encoder_ratios),
            encoder_depths="-".join(map(str, a.encoder_depths)),
            decoder_n_filters=a.decoder_n_filters, std_dist_type=a.std_dist_type,
            fix_std=a.fix_std, conv_norm=a.conv_norm, mixer_layer=a.mixer_layer),
        semantic_tokenizer_config=VibeVoiceSemanticTokenizerConfig(
            vae_dim=s.vae_dim, encoder_n_filters=s.encoder_n_filters,
            encoder_ratios=list(s.encoder_ratios),
            encoder_depths="-".join(map(str, s.encoder_depths)),
            std_dist_type=s.std_dist_type, fix_std=s.fix_std),
        decoder_config=Qwen2Config(
            vocab_size=d.vocab_size, hidden_size=d.hidden_size,
            intermediate_size=d.intermediate_size, num_hidden_layers=d.num_hidden_layers,
            num_attention_heads=d.num_attention_heads,
            num_key_value_heads=d.num_key_value_heads,
            max_position_embeddings=d.max_position_embeddings, rope_theta=d.rope_theta,
            rms_norm_eps=d.rms_norm_eps, tie_word_embeddings=d.tie_word_embeddings,
            attn_implementation="eager"),
        diffusion_head_config=VibeVoiceDiffusionHeadConfig(
            hidden_size=h.hidden_size, head_layers=h.head_layers,
            head_ffn_ratio=h.head_ffn_ratio, latent_size=h.latent_size,
            prediction_type=h.prediction_type, ddpm_num_steps=h.ddpm_num_steps,
            ddpm_beta_schedule=h.ddpm_beta_schedule),
    )
    model = VibeVoiceForConditionalGenerationInference(rcfg).eval()
    from ..utils.hf_interop import load_state_dict

    sd = {k: v.float() if v.is_floating_point() else v
          for k, v in load_state_dict(ckpt_dir).items()}
    if rcfg.decoder_config.tie_word_embeddings:
        sd.setdefault("lm_head.weight", sd["model.language_model.embed_tokens.weight"])
    missing, _ = model.load_state_dict(sd, strict=False)
    missing = [m for m in missing if "rotary" not in m]
    if missing:
        return None, f"reference load_state_dict missing keys: {missing[:8]}"
    return model, None


def check_parity(cfg, params, ref_model, dtype: str):
    """Per-component numeric parity on synthetic inputs; returns check dicts.
    The reference runs on the CPU in f32, the port on its parameters'
    device."""
    import torch

    from ..models import diffusion_head as dh
    from ..models import qwen2
    from ..models import tokenizer as tok
    from ..models import vibevoice as vv

    rtol, atol = _tolerances(dtype)
    rng = np.random.RandomState(0)
    dev = params["lm"]["embed"].device
    wdt = params["lm"]["embed"].dtype
    checks = []

    def port(x):
        return torch.from_numpy(np.asarray(x)).to(dev)

    def host(t):
        return t.detach().float().cpu().numpy()

    def record(name, ours, ref, scale_rtol=1.0):
        ours, ref = np.asarray(ours, np.float32), np.asarray(ref, np.float32)
        err = np.abs(ours - ref)
        denom = np.maximum(np.abs(ref), 1e-6)
        checks.append({
            "component": name,
            "max_abs_err": float(err.max()),
            "max_rel_err": float((err / denom).max()),
            "pass": bool(np.allclose(ours, ref, rtol=rtol * scale_rtol, atol=atol * scale_rtol)),
        })

    hop = cfg.acoustic_tokenizer_config.hop_length
    f = 4
    wav = (0.1 * rng.randn(1, f * hop)).astype(np.float32)

    with torch.no_grad():
        ref_mean = ref_model.model.acoustic_tokenizer.encode(
            torch.from_numpy(wav[:, None, :])).mean.numpy()
        our_mean, _ = tok.encode(cfg.acoustic_tokenizer_config, params["acoustic_tokenizer"],
                                 port(wav)[..., None].to(wdt))
        record("acoustic_encode", host(our_mean), ref_mean)

        lat = rng.randn(1, f, cfg.acoustic_vae_dim).astype(np.float32)
        ref_wav = ref_model.model.acoustic_tokenizer.decode(torch.from_numpy(lat)).numpy()
        our_wav, _ = tok.decode(cfg.acoustic_tokenizer_config, params["acoustic_tokenizer"],
                                port(lat).to(wdt))
        record("acoustic_decode", host(our_wav)[..., 0], ref_wav.squeeze(1))

        ref_sem = ref_model.model.semantic_tokenizer.encode(
            torch.from_numpy(wav[:, None, :])).mean.numpy()
        our_sem, _ = tok.encode(cfg.semantic_tokenizer_config, params["semantic_tokenizer"],
                                port(wav)[..., None].to(wdt))
        record("semantic_encode", host(our_sem), ref_sem)

        noisy = rng.randn(2, cfg.diffusion_head_config.latent_size).astype(np.float32)
        cond = rng.randn(2, cfg.diffusion_head_config.hidden_size).astype(np.float32)
        t = np.array([17, 409], np.int64)
        ref_eps = ref_model.model.prediction_head(
            torch.from_numpy(noisy), torch.from_numpy(t.astype(np.float32)),
            condition=torch.from_numpy(cond)).numpy()
        our_eps = dh.apply(params["diffusion_head"], cfg.diffusion_head_config,
                           port(noisy).to(wdt), port(t), port(cond).to(wdt))
        record("diffusion_head", host(our_eps), ref_eps)

        # the LM prefill with a voice-clone splice (connectors, scaling, LM, logits)
        t0 = 12
        ids = rng.randint(0, cfg.decoder_config.vocab_size, (1, t0))
        sm = np.zeros((1, t0), bool)
        sm[0, 3:3 + f] = True
        ref_out = ref_model(input_ids=torch.from_numpy(ids), speech_tensors=torch.from_numpy(wav),
                            speech_masks=torch.ones(1, f, dtype=torch.bool),
                            speech_input_mask=torch.from_numpy(sm), logits_to_keep=1,
                            return_dict=True, use_cache=False)
        feats = vv.encode_voice_features(cfg, params, port(wav),
                                         generator=torch.Generator(device=dev).manual_seed(0))
        embeds = qwen2.embed_tokens(params["lm"], port(ids))
        embeds = vv.splice_speech_features(embeds, port(sm), feats,
                                           torch.ones(1, f, dtype=torch.bool, device=dev))
        h, _ = qwen2.forward(cfg.decoder_config, params["lm"], embeds)
        logits = host(vv.lm_logits(params, h[:, -1:]))
        if cfg.acoustic_tokenizer_config.std_dist_type != "none" and (
                cfg.acoustic_tokenizer_config.fix_std or 0):
            # the σ-VAE noise differs between the frameworks' generators:
            # the check is informational
            checks.append({
                "component": "lm_prefill",
                "note": "fix_std>0: VAE sampling noise differs by RNG; "
                        "logit parity checked at 10x tolerance",
                "max_abs_err": float(np.abs(logits - ref_out.logits.numpy()).max()),
                "pass": True,
            })
        else:
            record("lm_prefill_hidden", host(h), ref_out.last_hidden_state.numpy(),
                   scale_rtol=5.0)
            record("lm_prefill_logits", logits, ref_out.logits.numpy(), scale_rtol=5.0)
    return checks


def short_generate(cfg, params, processor, tokens, ddpm_steps: int):
    from ..models import inference as inf

    script = "Speaker 1: This is a quick QA check.\nSpeaker 2: Understood, proceeding."
    proc_out = processor(text=script)
    opts = inf.GenerateOptions(ddpm_steps=ddpm_steps,
                               max_length=min(1024, cfg.decoder_config.max_position_embeddings))
    t0 = time.perf_counter()
    out = inf.generate(cfg, params, input_ids=proc_out.input_ids,
                       valid_mask=proc_out.attention_mask, tokens=tokens, opts=opts)
    wall = time.perf_counter() - t0
    wav = out.speech_outputs[0]
    audio_s = 0.0 if wav is None else len(np.asarray(wav).reshape(-1)) / 24_000
    return {
        "prompt_tokens": int(proc_out.attention_mask.sum()),
        "generated_steps": int(out.sequences.shape[1] - proc_out.input_ids.shape[1]),
        "audio_seconds": round(audio_s, 3),
        "wall_seconds": round(wall, 3),
    }


def rtf_bench(cfg, params, tokens, ddpm_steps: int, frames: int):
    """Forced-diffusion decode bench: every step emits a frame, so the wall
    is the true LM + solver + vocoder frame time (whatever the weights would
    say). On the card the first run captures the 8-frame step's CUDA graph;
    the second, timed, replays it."""
    from ..models import inference as inf

    ids = np.full((1, 8), 11, np.int64)
    ids[0, -1] = tokens.speech_start
    forced = np.full((frames, 1), tokens.speech_diffusion, np.int64)
    opts = inf.GenerateOptions(ddpm_steps=ddpm_steps, max_length=max(1024, frames + 16),
                               frames_per_dispatch=8)

    def run():
        t0 = time.perf_counter()
        out = inf.generate(cfg, params, input_ids=ids, tokens=tokens, opts=opts,
                           forced_tokens=forced)
        wall = time.perf_counter() - t0
        wav = out.speech_outputs[0]
        audio_s = 0.0 if wav is None else len(np.asarray(wav).reshape(-1)) / 24_000
        return audio_s, wall

    run()  # the capture pass
    audio_s, wall = run()
    return {
        "frames": frames,
        "audio_seconds": round(audio_s, 3),
        "wall_seconds": round(wall, 3),
        "rtf_x_realtime": round(audio_s / wall, 3) if wall else None,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkpoint")
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--reference_path", default=os.environ.get("VIBEVOICE_REFERENCE_PATH"))
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--ddpm_steps", type=int, default=10)
    ap.add_argument("--report", default="qa_report.json")
    ap.add_argument("--allow_fallback_tokenizer", action="store_true")
    ap.add_argument("--skip_generate", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; there must be a card) or cpu")
    args = ap.parse_args(argv)

    from ..models import inference as inf
    from ..utils.hf_interop import load_checkpoint
    from ..utils.params import _device

    try:
        device = _device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"--device {args.device}: {e}; pass --device cpu") from e
    report = {"checkpoint": os.path.abspath(args.checkpoint), "dtype": args.dtype}
    t0 = time.perf_counter()
    cfg, params, processor = load_checkpoint(
        args.checkpoint, dtype=args.dtype,
        allow_fallback_tokenizer=args.allow_fallback_tokenizer, device=device)
    report["convert_seconds"] = round(time.perf_counter() - t0, 2)
    tk = processor.tokenizer
    tokens = inf.SpecialTokens(speech_start=tk.speech_start_id, speech_end=tk.speech_end_id,
                               speech_diffusion=tk.speech_diffusion_id, eos=tk.eos_token_id)

    ref_model, why = build_reference_model(cfg, args.checkpoint, args.reference_path)
    if ref_model is None:
        report["parity"] = {"skipped": why}
        parity_ok = True
    else:
        checks = check_parity(cfg, params, ref_model, args.dtype)
        report["parity"] = checks
        parity_ok = all(c["pass"] for c in checks)

    if not args.skip_generate:
        report["generate"] = short_generate(cfg, params, processor, tokens, args.ddpm_steps)
        report["rtf"] = rtf_bench(cfg, params, tokens, args.ddpm_steps, args.frames)

    report["ok"] = parity_ok
    with open(args.report, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    if not parity_ok:
        print("PARITY FAILURE - see report", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
