"""Whole runs of the harness on the CPU at a tiny configuration
(``tiny.json``, ``tiny_clips.json``): the look for a chip skipped, the
program's plain kernels, the reference, the check. A sound run is
correct; the control (the reference in a lower precision put in the
program's place) and each fault planted under the timed path are not.

    python3 -m pytest bench_port/tests -q
"""

import json
import math
import sys
import time
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
sys.path.insert(0, str(BENCH_DIR))

import run  # noqa: E402
from bplib import spec  # noqa: E402

SEED = 2 ** 31 + 5


def _bench():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    b["configs"] = [{"name": "tiny", "source": "tests", "file": "bench_port/tests/tiny.json",
                     "reduced": [], "why": "tests"}]
    b["workloads"] = [{"name": "tiny-clips", "config": "tiny", "traffic": "../tests/tiny_clips",
                       "chips": 1, "why": "tests"}]
    for mt in b["end_to_end"] + b["per_layer"]:
        mt.pop("workloads", None)
    return b


def _run(**kw):
    result, compared = run.run_cell(_bench(), ROOT, "tiny-clips", SEED, 2.0, False,
                                    device="cpu", t_start=time.monotonic(), **kw)
    return result, compared


def test_a_sound_run_is_correct():
    result, compared = _run()
    assert result["correct"], compared
    assert len(compared) == 5 and all(math.isfinite(c["value"]) for c in compared.values())
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"audio_s_per_s", "ttfa_p95_ms", "gap_p99_ms", "setup_s"}
    assert list(result)[-1] == "compare"


@pytest.mark.parametrize("control", ["low"])
def test_the_control_is_not_correct(control):
    result, compared = _run(control=control)
    assert not result["correct"], compared


def _break_step(engine, how):
    """Wrap the engine's compiled step so that every window comes out wrong
    in one way."""
    step = engine.step_fn

    def broken(params, carry, noise, ext):
        if how == "one_slot_latents":  # slot 0's latents solved from other noise
            init = noise.init.clone()
            init[:, 0] = -init[:, 0]
            noise = noise._replace(init=init)
        new, out = step(params, carry, noise, ext)
        if how == "state_unchanged":
            return carry, out
        audio, tokens = out.audio.clone(), out.tokens.clone()
        if how == "half_batch":  # the first half of the slots' rows left out
            audio[:, : audio.shape[1] // 2] = 0
        elif how == "answer_altered":  # each window's first frame, negated
            audio[0] = -audio[0]
        elif how == "token_altered":  # each window's first token
            tokens[0] = spec.SPEECH_END
        return new, out._replace(audio=audio, tokens=tokens)

    broken.eager = broken
    engine.step_fn = broken


@pytest.mark.parametrize("how", ["state_unchanged", "half_batch", "answer_altered",
                                 "token_altered", "one_slot_latents"])
def test_a_fault_under_the_timed_path_is_not_correct(how):
    result, compared = _run(on_engine=lambda e: _break_step(e, how))
    assert not result["correct"], (how, compared)
    if how == "one_slot_latents":  # the audio follows the latents it was decoded from
        assert compared["latent_rel_err_req_max"]["value"] > compared["latent_rel_err_req_max"]["limit"]
