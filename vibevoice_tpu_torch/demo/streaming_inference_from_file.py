"""Streaming 0.5B inference (port of demo/streaming_inference_from_file.py):
a voice preset and a text -> a 24 kHz WAV, with the time to first audio
and the real-time factor.

Usage (on the card; --device cpu runs the kernels' plain versions):

  python -m vibevoice_tpu_torch.demo.streaming_inference_from_file --model_path <ckpt> \\
      --voice_preset voice.npz --text "Hello world" --int8
  python -m vibevoice_tpu_torch.demo.streaming_inference_from_file --device cpu

``--model_path`` loads a streaming checkpoint directory (a checkpoint
without tokenizer files needs VIBEVOICE_ALLOW_FALLBACK_TOKENIZER=1); without
``--voice_preset`` (.npz, or the reference's .pt) a synthetic prompt is
prefilled into one. ``--int8`` packs the vocoder's stage 0 int8 for kernel
D, as StreamingTTS.random does. Without ``--model_path`` the tiny
random-weight model runs. ``--max_len`` bounds the run: generation stops
when the next text and speech window would pass it. One short stream runs
first, so that the time to first audio is the captured windows'.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model_path", type=str, default=None)
    ap.add_argument("--voice_preset", type=str, default=None,
                    help=".npz (VoicePreset.save) or .pt (the reference's)")
    ap.add_argument("--text", type=str,
                    default="Hello, this is a streaming synthesis smoke test.")
    ap.add_argument("--txt_path", type=str, default=None)
    ap.add_argument("--output_path", type=str, default="./outputs/streaming.wav")
    ap.add_argument("--cfg_scale", type=float, default=1.5)
    ap.add_argument("--ddpm_steps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max_len", type=int, default=2048)
    ap.add_argument("--int8", action="store_true",
                    help="pack the vocoder's stage 0 int8 for kernel D")
    ap.add_argument("--kv_int8", action=argparse.BooleanOptionalAction, default=None,
                    help="int8 KV caches; default: on from 16384 cache slots")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the default; there must be a card) or cpu (the kernels' plain "
                         "versions)")
    return ap.parse_args(argv)


def build_model(args):
    """The StreamingTTS of the options."""
    from ..models import streaming as st
    from ..tts import StreamingTTS
    from ..utils.hf_interop import load_pretrained

    if not args.model_path:
        print("No --model_path: the tiny random-weight model (smoke mode)")
        tts = StreamingTTS.smoke(max_len=args.max_len, device=args.device)
    elif args.voice_preset:
        tts = StreamingTTS.from_pretrained(args.model_path, voice=args.voice_preset,
                                           max_len=args.max_len, device=args.device)
    else:
        loaded = load_pretrained(args.model_path, device=args.device)
        if loaded.model_type != "vibevoice_streaming":
            raise SystemExit(f"{args.model_path} is a {loaded.model_type} checkpoint; use "
                             "vibevoice_tpu_torch.demo.inference_from_file")
        cfg, params, processor = loaded
        print("No --voice_preset: prefilling a synthetic prompt")
        prompt = np.random.RandomState(0).randint(10, 200, (1, 16))
        preset = st.build_voice_preset(cfg, params, prompt,
                                       neg_prompt_id=getattr(processor.tokenizer, "pad_id", 3),
                                       max_len=args.max_len)
        tts = StreamingTTS(cfg, params, processor, preset, max_len=args.max_len)
    if args.int8:
        tts.params = st.fuse_vocoder(tts.params, tts.cfg, quantize=True)
    return tts


def main(argv=None) -> dict:
    args = parse_args(argv)
    from .inference_from_file import _need_device

    _need_device(args.device)
    from ..models import streaming as st
    from ..models.inference import GenerateOptions
    from ..processor.audio import write_wav
    from ..streamer import AudioStreamer

    tts = build_model(args)
    text = args.text
    if args.txt_path:
        with open(args.txt_path) as f:
            text = f.read()
    proc_out = tts.processor.process_input_with_cached_prompt(text, tts.preset)
    opts = GenerateOptions(cfg_scale=args.cfg_scale, ddpm_steps=args.ddpm_steps,
                           kv_int8=args.kv_int8)
    window_fns = st.make_window_fns(tts.cfg, opts)
    kw = dict(preset=tts.preset, opts=opts, max_len=args.max_len, seed=args.seed,
              window_fns=window_fns)
    # a short stream first: it captures the windows (excluded from the times)
    st.generate(tts.cfg, tts.params, tts_text_ids=proc_out.tts_text_ids[:, :1],
                stop_check_fn=lambda c=iter(range(3)): next(c, None) is None, **kw)

    streamer = AudioStreamer(batch_size=1)
    first = []
    put = streamer.put

    def timed_put(chunks, idx):
        if not first:
            first.append(time.perf_counter())
        put(chunks, idx)

    streamer.put = timed_put
    t0 = time.perf_counter()
    out = st.generate(tts.cfg, tts.params, tts_text_ids=proc_out.tts_text_ids,
                      audio_streamer=streamer, **kw)
    wall = time.perf_counter() - t0
    audio = out.speech_outputs[0]
    audio = np.zeros(0, np.float32) if audio is None else np.asarray(audio, np.float32)
    ttfa = first[0] - t0 if first else float("nan")
    seconds = len(audio) / tts.sample_rate
    os.makedirs(os.path.dirname(args.output_path) or ".", exist_ok=True)
    write_wav(args.output_path, audio, tts.sample_rate)
    print(f"Audio: {seconds:.2f}s -> {args.output_path}")
    print(f"Time-to-first-audio: {ttfa * 1000:.1f} ms")
    print(f"Wall: {wall:.2f}s, RTF: {seconds / wall:.3f}x realtime")
    return dict(path=args.output_path, audio_seconds=seconds, wall_s=wall, ttfa_s=ttfa,
                rtf=seconds / wall, load_walls=tts.load_walls)


if __name__ == "__main__":
    main()
