#!/usr/bin/env python3
"""Repeat chip_smoke.py's serving phase in one process, to compare the
per-frame time of two checkouts on one card.

    python3 chip_serving.py [--checkout DIR]

Imports chip_smoke.py from DIR (default: this checkout), builds its
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkout", default=str(Path(__file__).resolve().parent))
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
