"""Multi-speaker file inference (port of demo/inference_from_file.py): a
script and the speakers' voice wavs -> a 24 kHz WAV, with the token counts
and the real-time factor.

Usage (on the card; --device cpu runs the kernels' plain versions):

  python -m vibevoice_tpu_torch.demo.inference_from_file --model_path <ckpt> \\
      --txt_path script.txt --speaker_names Alice Bob --output_dir ./outputs --int8
  python -m vibevoice_tpu_torch.demo.inference_from_file --random_weights
  python -m vibevoice_tpu_torch.demo.inference_from_file --device cpu

``--model_path`` loads a checkpoint directory (tts.VibeVoiceTTS.from_pretrained;
a checkpoint without tokenizer files needs VIBEVOICE_ALLOW_FALLBACK_TOKENIZER=1);
``--int8`` quantizes its LM and lm_head and packs the serving stacks of
kernels C and D. ``--random_weights`` runs the full-width 1.5B with random
weights (served int8, as VibeVoiceTTS.random sets it up); neither runs the
tiny random-weight model. Speaker names pick voices from ``--voices_dir``
('en-Carter_man.wav' answers to 'Carter'); without names, random-weight runs
get synthetic voice prompts. ``--frames_per_dispatch`` is generate()'s K,
the frames of one replayed CUDA graph. The WAV is written even when the
model diffused no frame (it is then empty).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

DEFAULT_SCRIPT = ("Speaker 1: Hello, this is a smoke test of the VibeVoice port.\n"
                  "Speaker 2: And this is the second speaker replying.")


def parse_args(argv=None) -> argparse.Namespace:
    from ..serving.server import VOICES_DIR

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model_path", type=str, default=None, help="checkpoint directory")
    ap.add_argument("--txt_path", type=str, default=None, help="a script file")
    ap.add_argument("--script", type=str, default=None, help="inline script text")
    ap.add_argument("--speaker_names", type=str, nargs="*", default=[])
    ap.add_argument("--voices_dir", type=str, default=str(VOICES_DIR))
    ap.add_argument("--output_dir", type=str, default="./outputs")
    ap.add_argument("--cfg_scale", type=float, default=1.3)
    ap.add_argument("--ddpm_steps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--max_length", type=int, default=None,
                    help="cache slots (prompt + frames); default 256 with random weights, the "
                         "LM's context with a checkpoint")
    ap.add_argument("--checkpoint_path", type=str, default=None, help="LoRA adapter directory")
    ap.add_argument("--disable_prefill", action="store_true",
                    help="leave the voice prompts out of the prefill")
    ap.add_argument("--device_dtype", type=str, default="bfloat16")
    ap.add_argument("--frames_per_dispatch", type=int, default=8)
    ap.add_argument("--int8", action="store_true",
                    help="int8 LM + lm_head and the serving packs of kernels C and D")
    ap.add_argument("--kv_int8", action=argparse.BooleanOptionalAction, default=None,
                    help="int8 KV cache; default: on from 16384 cache slots")
    ap.add_argument("--random_weights", action="store_true",
                    help="the full-width 1.5B with random weights (no checkpoint)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the default; there must be a card) or cpu (the kernels' plain "
                         "versions)")
    return ap.parse_args(argv)


def _need_device(device: str) -> None:
    import torch

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {device}: no CUDA device is available; pass --device cpu")


def build_model(args):
    """The VibeVoiceTTS of the options."""
    from ..models import vibevoice as vv
    from ..serving.server import CONFIG_ALIASES
    from ..tts import VibeVoiceTTS

    if args.model_path:
        tts = VibeVoiceTTS.from_pretrained(args.model_path, int8=args.int8,
                                           dtype=args.device_dtype,
                                           lora_path=args.checkpoint_path, device=args.device)
    elif args.random_weights:
        print("Random-weight full-width 1.5B model (pipeline validation)")
        return VibeVoiceTTS.random(str(CONFIG_ALIASES["1.5b"]), device=args.device)
    else:
        print("No --model_path: the tiny random-weight model (smoke mode)")
        tts = VibeVoiceTTS.smoke(device=args.device)
        if args.int8:
            tts.params = vv.quantize_for_inference(tts.params)
    if args.int8:
        tts.params = vv.fuse_for_serving(tts.params, tts.cfg, quantize=True)
    return tts


def main(argv=None) -> dict:
    args = parse_args(argv)
    _need_device(args.device)
    from ..models import inference as inf
    from ..serving.server import VoiceMapper

    if args.script is not None:
        script = args.script
    elif args.txt_path is not None:
        with open(args.txt_path) as f:
            script = f.read()
    else:
        script = DEFAULT_SCRIPT
    tts = build_model(args)
    hop = tts.cfg.acoustic_tokenizer_config.hop_length
    voice_samples = None
    if args.speaker_names:
        mapper = VoiceMapper(args.voices_dir)
        voice_samples = [[mapper.get_voice_path(n) for n in args.speaker_names]]
    elif args.model_path is None:  # random weights: synthetic voice prompts
        rng = np.random.RandomState(0)
        voice_samples = [[rng.randn(hop * 4).astype(np.float32) * 0.05 for _ in range(2)]]

    proc_out = tts.processor(text=script, voice_samples=voice_samples)
    opts = inf.GenerateOptions(
        cfg_scale=args.cfg_scale, ddpm_steps=args.ddpm_steps,
        max_length=args.max_length or (256 if args.model_path is None else None),
        frames_per_dispatch=args.frames_per_dispatch, kv_int8=args.kv_int8)
    prefill = not args.disable_prefill
    t0 = time.perf_counter()
    out = inf.generate(
        tts.cfg, tts.params, input_ids=proc_out.input_ids, valid_mask=proc_out.attention_mask,
        speech_tensors=proc_out.speech_tensors if prefill else None,
        speech_frame_valid=proc_out.speech_masks if prefill else None,
        speech_input_mask=proc_out.speech_input_mask if prefill else None,
        tokens=tts.tokens, opts=opts, seed=args.seed, show_progress_bar=True)
    wall = time.perf_counter() - t0

    os.makedirs(args.output_dir, exist_ok=True)
    total_audio_sec, paths = 0.0, []
    for i, audio in enumerate(out.speech_outputs):
        audio = np.zeros(0, np.float32) if audio is None else np.asarray(audio, np.float32)
        path = os.path.join(args.output_dir, f"generated_{i}.wav")
        tts.save_audio(audio, path)
        total_audio_sec += len(audio) / tts.sample_rate
        paths.append(path)
        note = "" if len(audio) else " (no speech frame was diffused)"
        print(f"Sample {i}: {len(audio) / tts.sample_rate:.2f}s audio -> {path}{note}")
    gen_tokens = out.sequences.shape[1] - proc_out.input_ids.shape[1]
    rtf = total_audio_sec / wall if wall > 0 else 0.0
    print(f"Prefill tokens: {int(proc_out.attention_mask.sum())}")
    print(f"Generated tokens: {gen_tokens}")
    print(f"Wall time: {wall:.2f}s, audio: {total_audio_sec:.2f}s, RTF: {rtf:.3f}x realtime")
    return dict(paths=paths, audio_seconds=total_audio_sec, wall_s=wall, rtf=rtf,
                generated_tokens=gen_tokens, load_walls=tts.load_walls)


if __name__ == "__main__":
    main()
