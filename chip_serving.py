#!/usr/bin/env python3
"""Repeat chip_smoke.py's serving phase, or time kernels, in one process, to
compare two checkouts on one card.

    python3 chip_serving.py [--checkout DIR]
        [--what serving|engine|kernels|fused|sk_bits|phase4_bits] [--config 1.5b|7b]

Imports chip_smoke.py from DIR (default: this checkout). With --what
engine it builds the serving engine of chip_smoke.py's phase 8 (max_batch
4, 4,096 slots, K 4, the speaking 1.5B; with --config 7b the 7B of phase
12), warms it up and prints the device time a frame (CUDA events) of three
replays of one window with every slot active; with --what kernels, the
device time (chip_smoke.bench_ms, the weights rotating) of the streaming
core's kernels at the 1.5B's and the 7B's shapes: kernel A's GEMV at 2
rows (1 row for a tokenizer fc1), C (4 layers, 2 rows, int8) and D (8
blocks, 1 row, int8); with --what fused, kernels C (4 layers, int8, f32 x,
the 1.5B's and the 7B's widths) at 2, 3, 4, 8 and 16 rows and D (8 blocks,
int8, bf16 x) at 1, 2, 4, 8 and 16, by the routes that checkout's
wrappers take; with --what sk_bits, a SHA-256 of each output of kernel A's
split-K route (ops/quant._gemm_splitk, bf16 x from one seed) at every
shape of chip_smoke.py's route sweep, to hold two checkouts' bits equal;
with --what phase4_bits, a SHA-256 of the tokens and of the audio of
chip_smoke.py's phase 4 reference (the forced 32-frame generate() at
4,096 slots, graphed, K = 4, seed 0), likewise. By default it builds the
full-width 1.5B serving model once (seed 0) and runs its end_to_end()
three times, printing each run's ms per frame as a JSON line. Each
end_to_end() alternates, at max_length 4096 and 65536 and for K = 1 and 4
frames a window, the graphed generate() (a CUDA-graph replay a window)
and the same runs through the step function's eager call (each a 3- and
a 32-frame run). The eager frame is bound by host dispatch and its wall
time spreads widely between runs, so a comparison of two checkouts
alternates them in one call (A, B, A, B) and reads the spreads. Needs one
CUDA device; exits non-zero otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

REPEATS = 3


def engine_window(chip_smoke, config: str = "1.5b") -> list:
    """Device ms a frame of REPEATS replays of phase 8's engine window (every
    slot active, the carry warmup() left); the 7B's (phase 12 (d)) with
    config "7b"."""
    import torch

    from vibevoice_tpu_torch.models import inference as inf
    from vibevoice_tpu_torch.serving.engine import ServingEngine
    from vibevoice_tpu_torch.utils.params import speaking

    big = config == "7b"
    model = chip_smoke.serving_model(0, chip_smoke.CONFIG_7B) if big else \
        chip_smoke.serving_model(0)
    cfg, toks, k, b = model["cfg"], model["toks"], 4, chip_smoke.ENGINE_BATCH
    params = speaking(model["params"], toks, c=chip_smoke.SPEAK_C_7B if big else 64.0)
    eng = ServingEngine(cfg, params, tokens=toks, frames_per_dispatch=k, max_batch=b,
                        max_len=4096,
                        opts=inf.GenerateOptions(ddpm_steps=10, cfg_scale=1.3, max_length=4096))
    eng.warmup()
    try:
        eng.carry.finished.zero_()
        noise, ext = eng._draw_noise(), torch.zeros(k, b, dtype=torch.bool, device="cuda")
        eng.step_fn(params, eng.carry, noise, ext)
        times = []
        for _ in range(REPEATS):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            eng.step_fn(params, eng.carry, noise, ext)
            ev[1].record()
            torch.cuda.synchronize()
            times.append(ev[0].elapsed_time(ev[1]) / k)
        eng.carry.finished.fill_(True)
    finally:
        eng.shutdown()
    return times


def stream_kernels(chip_smoke) -> dict:
    """Device ms of one call of each kernel on the streaming core."""
    import torch

    from vibevoice_tpu_torch.ops import head_fused as hf
    from vibevoice_tpu_torch.ops import quant
    from vibevoice_tpu_torch.ops import vocoder_fused as vf

    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    randn = lambda *s, dt=torch.bfloat16: torch.randn(s, generator=g, device="cuda").to(dt)
    ms = {}
    for name, k, n, rows in (("gate/up", 1536, 8960, 2), ("q/o", 1536, 1536, 2),
                             ("down", 8960, 1536, 2), ("7B gate/up", 3584, 18944, 2),
                             ("tokenizer fc1", 2048, 8192, 1)):
        ws = chip_smoke.rotating(
            lambda: quant.quantize_weight(randn(k, n, dt=torch.float32) * 0.02), k * n)
        x = randn(rows, k)
        ms[f"A {name} {rows} rows"] = chip_smoke.bench_ms(
            lambda w: quant.int8_matmul(x, w["w8"], w["scale"]), ws)
    layers = chip_smoke.head_layers(randn, 1536, 4608, 4)
    packs = chip_smoke.rotating(lambda: hf.pack_head_ffns(layers, 1e-5, True),
                                3 * 4 * 1536 * 4608, budget=120 << 20)
    x, mods = randn(2, 1536, dt=torch.float32), randn(4, 2, 3 * 1536, dt=torch.float32) * 0.5
    ms["C 2 rows"] = chip_smoke.bench_ms(lambda pk: hf.fused_head_ffn_stack(pk, x, mods), packs)
    blocks = chip_smoke.stage_blocks(randn, 2048, 8)
    packs = chip_smoke.rotating(lambda: vf.pack_stage(blocks, 1e-5, True), 8 * 8 * 2048 * 2048,
                                budget=120 << 20)
    x, st = randn(1, 1, 2048), randn(8, 1, 6, 2048)
    ms["D 1 row"] = chip_smoke.bench_ms(lambda pk: vf.fused_stage_step(pk, x, st), packs)
    return ms


FUSED_C_ROWS = (2, 3, 4, 8, 16)
FUSED_D_ROWS = (1, 2, 4, 8, 16)


def fused_kernels(chip_smoke) -> dict:
    """Device ms of one call of kernels C (4 layers, int8 weights, f32 x and
    mods, the 1.5B's 1536-4608 and the 7B's 3584-10752 head) and D (8
    blocks, int8, bf16 x and state, 2048-8192) at FUSED_C_ROWS and
    FUSED_D_ROWS, the packs rotating, by the route the checkout's wrappers
    take at each row count."""
    import torch

    from vibevoice_tpu_torch.ops import head_fused as hf
    from vibevoice_tpu_torch.ops import vocoder_fused as vf

    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    randn = lambda *s, dt=torch.bfloat16: torch.randn(s, generator=g, device="cuda").to(dt)
    ms = {}
    for model, dim, hid in (("1.5B", 1536, 4608), ("7B", 3584, 10752)):
        layers = chip_smoke.head_layers(randn, dim, hid, 4)
        packs = chip_smoke.rotating(lambda: hf.pack_head_ffns(layers, 1e-5, True),
                                    3 * 4 * dim * hid, budget=120 << 20)
        for rows in FUSED_C_ROWS:
            x, mods = randn(rows, dim, dt=torch.float32), randn(4, rows, 3 * dim,
                                                              dt=torch.float32) * 0.5
            ms[f"C {model} {rows} rows"] = chip_smoke.bench_ms(
                lambda pk: hf.fused_head_ffn_stack(pk, x, mods), packs)
        del packs
    blocks = chip_smoke.stage_blocks(randn, 2048, 8)
    packs = chip_smoke.rotating(lambda: vf.pack_stage(blocks, 1e-5, True), 8 * 8 * 2048 * 2048,
                                budget=120 << 20)
    for rows in FUSED_D_ROWS:
        x, st = randn(rows, 1, 2048), randn(8, rows, 6, 2048)
        ms[f"D {rows} rows"] = chip_smoke.bench_ms(lambda pk: vf.fused_stage_step(pk, x, st),
                                                   packs)
    return ms


def splitk_bits(chip_smoke) -> dict:
    """A SHA-256 of kernel A's split-K output (ops/quant._gemm_splitk, bf16
    x) at each shape of chip_smoke.py's route sweep: a layer's four int8 LM
    shapes of the 1.5B and the 7B at every SWEEP_ROWS count, weights and x
    drawn from one seed in a fixed order."""
    import hashlib

    import torch

    from vibevoice_tpu_torch.ops import quant

    g = torch.Generator(device="cuda")
    g.manual_seed(15)
    randn = lambda *s, dt=torch.bfloat16: torch.randn(s, generator=g, device="cuda").to(dt)
    out = {}
    for model, shapes in (("1.5B", chip_smoke.LM_SHAPES), ("7B", chip_smoke.LM_SHAPES_7B)):
        for name, k, n in shapes:
            w = quant.quantize_weight(randn(k, n, dt=torch.float32) * 0.02)
            for rows in chip_smoke.SWEEP_ROWS:
                y = quant._gemm_splitk(randn(rows, k), w["w8"], w["scale"])
                out[f"{model} {name} {k}x{n} rows={rows}"] = hashlib.sha256(
                    y.view(torch.int16).cpu().numpy().tobytes()).hexdigest()[:16]
    return out


def phase4_bits(chip_smoke) -> dict:
    """SHA-256 digests of phase 4's reference run (end_to_end's forced
    32-frame generate() at 4,096 slots, graphed, K = 4) on seed 0's 1.5B."""
    import hashlib

    sequences, audio = chip_smoke.end_to_end(chip_smoke.serving_model(0), 0, 32)["reference"]
    return {name: hashlib.sha256(a.tobytes()).hexdigest()[:16]
            for name, a in (("tokens", sequences), ("audio", audio))}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkout", default=str(Path(__file__).resolve().parent))
    ap.add_argument("--what", choices=("serving", "engine", "kernels", "fused", "sk_bits",
                                       "phase4_bits"), default="serving")
    ap.add_argument("--config", choices=("1.5b", "7b"), default="1.5b",
                    help="the engine's model (--what engine)")
    args = ap.parse_args()
    if os.environ.get("PYTHONHASHSEED") != "0":  # the prompt's ids, as in chip_smoke.py
        os.environ["PYTHONHASHSEED"] = "0"
        os.execv(sys.executable, [sys.executable, *sys.orig_argv[1:]])
    root = Path(args.checkout).resolve()
    sys.path.insert(0, str(root))
    os.chdir(root)
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_serving.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    if args.what != "serving":
        if args.what == "engine":
            ms = engine_window(chip_smoke, args.config)
        else:
            ms = {"kernels": stream_kernels, "fused": fused_kernels, "sk_bits": splitk_bits,
                  "phase4_bits": phase4_bits}[args.what](chip_smoke)
        print(json.dumps({"checkout": root.name, "what": args.what, "config": args.config,
                          "card": card, "device": torch.cuda.get_device_name(0),
                          "sha256" if args.what.endswith("_bits") else "ms": ms}), flush=True)
        return
    model = chip_smoke.serving_model(0)
    for i in range(REPEATS):
        runs = chip_smoke.end_to_end(model, 0, 32)["runs"]
        print(json.dumps({"checkout": root.name, "run": i, "device": torch.cuda.get_device_name(0),
                          "card": card,
                          "per_frame_ms": {k: v["per_frame_ms"] for k, v in runs.items()},
                          "rtf": {k: v["rtf"] for k, v in runs.items()},
                          "alloc_retries": {k: v["alloc_retries"] for k, v in runs.items()}}),
              flush=True)


if __name__ == "__main__":
    main()
