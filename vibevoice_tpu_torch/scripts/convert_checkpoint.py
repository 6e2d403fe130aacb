"""Checkpoint conversion (port of vibevoice_tpu/scripts/convert_checkpoint.py):
an HF-style directory (safetensors or pytorch_model*.bin) -> a native one
(params.pkl in the JAX package's format, config.json, preprocessor_config.json),
which both packages' ``load_native`` read.

nnscaler-trained checkpoints (``--nnscaler``) have their ``model.model.``
prefix stripped first, and their optimizer entries dropped (reference
scripts/convert_nnscaler_checkpoint_to_transformers.py:53-56).

Usage (the conversion runs on the card unless given --device cpu):

  python -m vibevoice_tpu_torch.scripts.convert_checkpoint --input <dir> \\
      --output <dir> [--streaming] [--nnscaler] [--dtype float32] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os


def strip_nnscaler_prefixes(sd):
    """model.model.xxx -> model.xxx; optimizer entries and step counters go."""
    out = {}
    for k, v in sd.items():
        if k.startswith("model.model."):
            k = k[len("model."):]
        if k.startswith("optimizer") or k.endswith(".step"):
            continue
        out[k] = v
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--streaming", action="store_true", help="the streaming 0.5B model")
    ap.add_argument("--nnscaler", action="store_true", help="the input is an nnscaler checkpoint")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; there must be a card) or cpu")
    args = ap.parse_args(argv)

    from ..configs import VibeVoiceConfig, VibeVoiceStreamingConfig
    from ..utils import hf_interop as hf
    from ..utils.params import _device

    try:
        device = _device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"--device {args.device}: {e}; pass --device cpu") from e
    cfg_cls = VibeVoiceStreamingConfig if args.streaming else VibeVoiceConfig
    cfg = cfg_cls.from_json_file(os.path.join(args.input, "config.json"))
    sd = hf.load_state_dict(args.input)
    if args.nnscaler:
        sd = strip_nnscaler_prefixes(sd)
    convert = hf.convert_streaming_model if args.streaming else hf.convert_full_model
    params = hf._to_dtype(convert(sd, cfg, device=device), hf._dtype(args.dtype))
    hf.save_native(args.output, cfg, params)
    # the processor config comes along (reference :92-124)
    src = os.path.join(args.input, "preprocessor_config.json")
    with open(os.path.join(args.output, "preprocessor_config.json"), "w") as g:
        if os.path.exists(src):
            with open(src) as f:
                g.write(f.read())
        else:
            json.dump({"speech_tok_compress_ratio": 3200, "db_normalize": True}, g, indent=2)
    print(f"Converted {args.input} -> {args.output}")


if __name__ == "__main__":
    main()
