"""The port's multi-host training surface on the CPU: sharded checkpoints
(utils/checkpoint.py, torch.distributed.checkpoint) in a world of 2, the
trainer CLI on a dp 2 x tp 2 mesh with sharded checkpoints and a resume
from them, and on 2 GPipe stages (tests/test_multihost.py:106 runs the JAX
trainer so), and the trainer's refusals, each the JAX package's message.

The CLI starts its own ranks (one process each, gloo) when torchrun has not;
tests/torch_workers.py runs the checkpoint world and imports nothing of JAX.
"""

import os
import pickle
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

import torch_workers as W
from vibevoice_tpu_torch.configs import tiny_config
from vibevoice_tpu_torch.finetune import train as ttrain
from vibevoice_tpu_torch.utils.params import init

REPO = Path(__file__).resolve().parents[1]
CFG = tiny_config()


def test_checkpoint_roundtrip_world_of_2(tmp_path):
    """A tp 2 train state saved by both ranks (each writes its own shards)
    and restored into zeros of the same layout comes back bit-equal (shards,
    AdamW moments, counts, step); parameters saved from tp 2 shards restore
    whole on every rank, bit-equal to the full tree."""
    params = init(CFG, seed=0, dtype=torch.float32, device="cpu")
    ranks = W.run_world(2, tmp_path, {"c": (("mesh", 1, 2), W.ckpt_roundtrip,
                                            (CFG, params, str(tmp_path / "ckpt")))})
    lm = CFG.decoder_config
    for r in ranks:
        assert r["c"]["state"] and r["c"]["whole"]
        assert r["c"]["q_shape"] == (lm.hidden_size, lm.num_attention_heads * lm.head_dim // 2)
    assert (tmp_path / "ckpt" / "state" / ".metadata").exists()


def _train(tmp_path, *extra, timeout=600):
    argv = ["--synthetic_data", "--max_steps", "2", "--save_steps", "2", "--max_length", "128",
            "--log_steps", "1",
            "--device", "cpu", "--output_dir", str(tmp_path / "out"), *extra]
    out = subprocess.run([sys.executable, "-m", "vibevoice_tpu_torch.finetune.train", *argv],
                         cwd=REPO, env={**os.environ, "PYTHONPATH": str(REPO)},
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    return out.stdout


def test_trainer_cli_dp_tp_mesh_with_sharded_checkpoints(tmp_path):
    """--mesh_dp 2 --mesh_tp 2 --checkpoint_format orbax: four ranks, a
    torch.distributed.checkpoint directory at step 2, then a resume from it
    to step 3."""
    mesh = ("--mesh_dp", "2", "--mesh_tp", "2", "--per_device_batch_size", "1",
            "--checkpoint_format", "orbax")
    log = _train(tmp_path, *mesh)
    assert "mesh: {'dp': 2, 'tp': 2} (2 data shards; gloo)" in log
    assert "step 2/2" in log and "saved" in log
    ckpt = tmp_path / "out" / "checkpoint-2"
    assert (ckpt / "orbax" / ".metadata").exists() and (ckpt / "params.pkl").exists()
    log = _train(tmp_path, *mesh, "--max_steps", "3", "--save_steps", "5",
                 "--resume_from_checkpoint", str(ckpt))
    assert "Resumed from step 2" in log and "step 3/3" in log


def test_trainer_cli_pipeline(tmp_path):
    """--mesh_pp 2: two GPipe stages of the tiny model's 2 layers; the
    exported params.pkl keeps the list layout of the layers."""
    log = _train(tmp_path, "--mesh_pp", "2", "--per_device_batch_size", "2")
    assert "mesh: {'dp': 1, 'pp': 2} (1 data shards, 2 micro-batches; gloo)" in log
    with open(tmp_path / "out" / "checkpoint-2" / "params.pkl", "rb") as f:
        lm = pickle.load(f)["lm"]
    assert "layers_stacked" not in lm and len(lm["layers"]) == CFG.decoder_config.num_hidden_layers


# the JAX trainer's source with its implicitly concatenated string pieces joined
JAX_TRAIN = re.sub(r'"\s*\n\s*f?"', "", (REPO / "vibevoice_tpu" / "finetune" / "train.py").read_text())


@pytest.mark.parametrize("argv,message", [
    (["--use_lora", "--int8_base", "--mesh_tp", "2"],
     "--int8_base is a single-chip path (no mesh flags)"),
    (["--fsdp"], "--fsdp shards parameters/optimizer state over the data axis; it needs "
                 "--mesh_dp (or --mesh_dcn) > 1 to do anything"),
    (["--mesh_pp", "2", "--mesh_tp", "2"], "--mesh_pp composes only with --mesh_dp (full fine-tune)"),
    (["--mesh_pp", "2", "--use_lora"], "--mesh_pp composes only with --mesh_dp (full fine-tune)"),
    (["--mesh_pp", "2", "--fsdp", "--mesh_dp", "2"],
     "--mesh_pp composes only with --mesh_dp (full fine-tune)"),
    (["--mesh_pp", "2", "--lm_layers_to_freeze", "0"],
     "--lm_layers_to_freeze is not supported with --mesh_pp"),
    (["--mesh_pp", "2", "--per_device_batch_size", "3"],
     "--per_device_batch_size {args.per_device_batch_size} must divide by --pp_microbatches "
     "{args.pp_microbatches}"),
])
def test_refusals_are_the_jax_trainers(argv, message):
    """Each refusal exits with the JAX trainer's message (its text, the
    f-string's fields filled in)."""
    assert message in JAX_TRAIN
    with pytest.raises(SystemExit) as e:
        ttrain.parse_args(argv)
    fields = SimpleNamespace(per_device_batch_size=3, pp_microbatches=2)
    assert str(e.value) == message.format(args=fields)


def test_multihost_needs_torchrun(monkeypatch):
    """--multihost takes its rank from torchrun's environment and says so
    without one."""
    for name in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(SystemExit, match="torchrun"):
        ttrain.main(["--multihost", "--device", "cpu"])
