#!/usr/bin/env python3
"""Run one cell of the benchmark of ``vibevoice_tpu_torch`` once.

    python3 bench_port/run.py --workload vv1.5b-clips --seed 7 --seconds 40 --trace 0

from the root of a checkout. It makes the cell's weights on the card from
the seed, sets the program up as a deployment does, warms it up, sends the
cell's traffic open loop, measures for ``--seconds`` seconds, checks a
sample of the served requests against the plain reference, and prints one
JSON line last: the cell's end-to-end metrics (``--trace 0``) or its
per-layer metrics from a profile of the window (``--trace 1``).

``--rate`` (requests a second) replaces the traffic file's rate (the knee
sweep); ``--control low`` puts the reference a precision lower in the
program's place for the check (the correctness control), and prints the
program's own numbers over the same requests beside it. The benchmark's
own runs pass neither.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for key, value in (
        # keep CUPTI up between profiles of one process (profiles beside live
        # CUDA graphs otherwise come back empty late in a run)
        ("TEARDOWN_CUPTI", "0"), ("DISABLE_CUPTI_LAZY_REINIT", "1"),
        # nothing the run loads may bring JAX in
        ("USE_FLAX", "0"), ("USE_JAX", "0"),
        # every compiler cache at a fixed place inside the checkout
        ("TRITON_CACHE_DIR", str(ROOT / "build" / "bench_port" / "triton")),
        ("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "bench_port" / "torch_extensions"))):
    os.environ.setdefault(key, value)

import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
from bplib import harness, spec, traffic, weights  # noqa: E402

BENCHMARK = ROOT / "BENCHMARK.json"


def _entry(items, name, what):
    for it in items:
        if it["name"] == name:
            return it
    raise SystemExit(f"no {what} named {name!r} in {BENCHMARK}")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def run_cell(bench: dict, root: Path, workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", rate=None, control=None,
             t_start: float = None, on_engine=None):
    """One run; returns (result dict, the numbers compared with their
    limits, the breakdown). ``on_engine(engine)`` lets a test break the
    program under the run."""
    wl = _entry(bench["workloads"], workload, "workload")
    cfg_entry = _entry(bench["configs"], wl["config"], "config")
    m = spec.load(root / cfg_entry["file"])
    mix = traffic.load(root / "bench_port" / "traffic" / f"{wl['traffic']}.json")
    dev = torch.device(device)
    sys.path.insert(0, str(root))
    from vibevoice_tpu_torch.models import inference as inf

    if trace and dev.type == "cuda":
        # bring CUPTI up before the program runs (kept up, TEARDOWN_CUPTI=0):
        # a first profile late in a long process records no device activity
        from bplib import trace_read

        trace_read.Profile().stop()
    raw = weights.make(m, seed, dev)
    engine = harness.build_program(m, raw, dev)
    del raw
    gc.collect()
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    gate = harness.Pause() if trace else None
    rec = harness.Recorder(engine, m.latent, gate)
    if on_engine is not None:
        on_engine(engine)
    b = m.bench
    engine.warmup(prompt_tokens=b["warmup_prompt_tokens"],
                  voice_samples=b["warmup_voice_frames"] * m.hop)
    sched = traffic.schedule(mix, seed, seconds, m.hop, rate)
    served, window, give_up, occupancy, prof, span = harness.serve(
        engine, sched, m.hop, mix["warm_seconds"], seconds, mix["tail_seconds"],
        mix["trace_seconds"] if trace else 0.0, gate)
    engine.shutdown(timeout=60)
    if not rec.windows or not rec.prefills:
        raise SystemExit("the benchmark's hooks saw no window or no prefill of the engine")
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    # a traced run's host-side readings end where its profile starts
    run = harness.Run(m=m, window=(window[0], span[0]) if trace else window,
                      give_up=give_up, served=served,
                      setup_s=window[0] - (T_START if t_start is None else t_start),
                      frames_per_dispatch=engine.frames_per_dispatch, max_batch=engine.max_batch,
                      prefills=list(rec.prefills), occupancy=occupancy, trace_span=span)
    if prof is not None:
        run.trace = prof.read()
        if not run.trace.device:
            raise SystemExit("the profile of the window recorded no device activity")
        print(f"trace: the frame step's streams {sorted(run.trace.decode_streams())}, "
              f"{run.trace.graph_launches()} graph launches over {run.trace.window_s:.3f} s",
              file=sys.stderr)
    print(harness.load_report(run), file=sys.stderr)
    metrics = {}
    for mt in (bench["per_layer"] if trace else bench["end_to_end"]):
        if not _applies(mt, workload):
            continue
        value = harness.load_reader(root, mt["name"])(run)
        if value is not None:
            metrics[mt["name"]] = {"value": value, "unit": mt["unit"]}
    # the program's state is freed before the reference runs on the card
    k = engine.frames_per_dispatch
    rec.release()
    del engine
    inf._captures.clear()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    w0, w1 = window
    due = [s for s in served if w0 <= s.due < w1]
    # never had audio, or ended in an error while the run still watched it
    # (the shutdown after the run fails what is still streaming)
    failed = sum(1 for s in due if s.first_audio is None or (s.done and s.handle.error is not None))
    t_check = time.monotonic()
    cmp = harness.check(m, rec, run, seed, dev, k, control)
    own = cmp.pop("program", None)
    for who, c in (("the program", own), ("the control" if own else "the program", cmp)):
        if c is None:
            continue
        g = lambda key: c.get(key, float("nan"))
        print(f"{who}: checked {c['frames']} frames of {c['requests']} requests: latent error "
              f"by request's median frame, largest {g('latent_rel_err_req_max'):.4g}; of all "
              f"frames, median {g('latent_rel_err_median'):.4g}, largest "
              f"{g('latent_rel_err_max'):.4g}; median first frame {g('latent_rel_err_first'):.4g}, "
              f"later frames {g('latent_rel_err_later'):.4g}; audio, median frame "
              f"{g('audio_rel_err_median'):.4g}, largest {g('audio_rel_err_max'):.4g}; by "
              f"request's first window, largest {g('latent_rel_err_head_max'):.4g}; worst "
              f"requests: {c.pop('worst', '')}", file=sys.stderr)
    print(f"reference check took {time.monotonic() - t_check:.1f} s", file=sys.stderr)
    limits = b["check"]
    compared = {name: {"value": cmp.get(name, float("nan")), "limit": lim}
                for name, lim in limits.items()}
    correct = (cmp["requests"] > 0 and failed == 0
               and all(c["value"] <= c["limit"] for c in compared.values()))
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": wl["chips"], "memory_peak_bytes": int(peak)}
    breakdown = None
    if run.trace is not None:
        device_info["busy_s"] = run.trace.busy_s()
        device_info["window_s"] = run.trace.window_s
        breakdown = {"device_ops": [[n, s] for n, s in run.trace.top_ops(10)],
                     "idle_gaps": [[n, s] for n, s in run.trace.idle_gaps(10)]}
    result = {"correct": bool(correct), "attempted": len(due), "failed": failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compare"] = compared
    return result, compared


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rate", type=float, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--control", choices=("low",), default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    bench = json.loads(BENCHMARK.read_text())
    wl = _entry(bench["workloads"], args.workload, "workload")
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"{args.workload} needs {wl['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    result, compared = run_cell(bench, ROOT, args.workload, args.seed, args.seconds,
                                bool(args.trace), rate=args.rate, control=args.control)
    found = harness.forbidden_modules()
    if found:
        print(f"the run loaded modules it must not: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in compared.items():
        print(f"compare {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
