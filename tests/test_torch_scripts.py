"""The port's two checkpoint scripts on the CPU, on tiny checkpoints written
here (chip_smoke.reference_state_dict / write_checkpoint, as the card run
writes them at full width):

* ``scripts/merge_vibevoice_models``: a checkpoint merged with adapters
  and connector overrides written by the JAX package's trainer assets
  (``save_lora_assets``), against the JAX package's merge of the same
  files (both outputs loaded by the port's ``load_native``: every leaf to
  f32 rounding of the merge, 1e-6 of its peak; overrides bit-equal); the
  verification raising on a tampered merge;
* ``scripts/qa_real_checkpoint --device cpu``: the report has the JAX
  harness's keys; without the upstream reference the parity step is
  skipped with its reason.
"""

import dataclasses
import json
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vibevoice_tpu import configs as JC
from vibevoice_tpu.finetune import lora as jlora
from vibevoice_tpu.models import vibevoice as jvv
from vibevoice_tpu.scripts import merge_vibevoice_models as jmerge

import chip_smoke
from test_torch_hf_interop import _randomize, write_tokenizer
from vibevoice_tpu_torch import configs as TC
from vibevoice_tpu_torch.finetune import lora as tlora
from vibevoice_tpu_torch.scripts import merge_vibevoice_models as tmerge
from vibevoice_tpu_torch.scripts import qa_real_checkpoint as tqa
from vibevoice_tpu_torch.utils import hf_interop as thf
from vibevoice_tpu_torch.utils.params import from_jax


def _config_json(cfg):
    blob = dataclasses.asdict(cfg)
    blob["model_type"] = "vibevoice"
    return json.loads(json.dumps(blob, default=str))


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A tiny multi-speaker checkpoint (three f32 shards and a tokenizer),
    the JAX tree it holds, and a lora/ directory written by the JAX
    package: adapters with non-zero B (r 4, alpha 8; the LM's seven targets
    and the head) and trained connectors in extras.pkl."""
    cfg, jcfg = TC.tiny_config(), JC.tiny_config()
    jp = _randomize(jax.eval_shape(lambda k: jvv.init(k, jcfg), jax.random.PRNGKey(0)), 1)
    tp = from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    root = tmp_path_factory.mktemp("merge")
    path = root / "model"
    sd = {k: v.contiguous() for k, v in chip_smoke.reference_state_dict(tp).items()}
    chip_smoke.write_checkpoint(path, sd, _config_json(cfg))
    write_tokenizer(path, cfg.decoder_config.vocab_size)
    lcfg = jlora.LoraConfig(r=4, alpha=8, train_connectors=True)
    adapters = jax.eval_shape(lambda k: jlora.init_lora(k, jp, lcfg), jax.random.PRNGKey(3))
    rng = np.random.RandomState(5)
    adapters = jax.tree.map(lambda x: jnp.asarray(rng.randn(*x.shape) * 0.05, x.dtype), adapters)
    jlora.save_lora_assets(str(root / "trained" / "lora"), adapters, lcfg)
    return path, root / "trained"


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def test_merge_matches_jax(checkpoint, tmp_path, capsys):
    """The port's merge (on the CPU) and the JAX package's of one
    checkpoint and one set of JAX-written assets: the same counters, and
    the two native outputs, both read by the port's load_native, hold the
    same tree (adapted weights to 1e-6 of their peak, the rest and the
    connector overrides bit-equal)."""
    path, trained = checkpoint
    rep = tmerge.main(["--base_model", str(path), "--trained_checkpoint", str(trained),
                       "--output_dir", str(tmp_path / "port"), "--device", "cpu"])
    out = capsys.readouterr().out
    jrep = jmerge.run_merge(str(path), str(trained), str(tmp_path / "jax"))
    assert rep == jrep
    assert rep["lm_changed"] == 2 * 7 and rep["head_changed"] == 2 * 3
    assert rep["overridden"] == ["acoustic_connector", "semantic_connector"]
    assert "Verified component override: acoustic_connector (exact match)" in out
    _, got = thf.load_native(str(tmp_path / "port"), device="cpu")
    _, want = thf.load_native(str(tmp_path / "jax"), device="cpu")
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert set(got) == set(want)
    for p, w in want.items():
        g = got[p]
        assert g.dtype == w.dtype, p
        if "/ffn/" in p or "/attn/" in p or "/mlp/" in p:
            assert (g - w).abs().max() <= 1e-6 * max(w.abs().max(), 1e-30), p
        else:
            assert torch.equal(g, w), p


def test_merge_verification_raises_on_a_tampered_merge(checkpoint):
    """merge_and_verify on the merged tree passes; a weight nudged by 1e-3
    of its peak, a merge that left a weight unchanged, and a connector
    override that is not the trained tensor each raise."""
    path, trained = checkpoint
    cfg, params, _ = thf.load_checkpoint(str(path), dtype="float32", device="cpu")
    with open(trained / "lora" / "lora_adapters.pkl", "rb") as f:
        blob = pickle.load(f)
    with open(trained / "lora" / "extras.pkl", "rb") as f:
        extras = tlora.to_torch(pickle.load(f))
    lcfg = tlora.LoraConfig(**{k: tuple(v) if isinstance(v, list) else v
                               for k, v in blob["config"].items()})
    lora = {**tlora.to_torch(blob["lora"]), "extras": extras}
    merged = tlora.apply_lora(params, lora, lcfg)
    tmerge.merge_and_verify(params, merged, lora, lcfg, extras)

    def tampered(layer, entry):
        lm = dict(merged["lm"])
        lm["layers"] = list(lm["layers"])
        lm["layers"][1] = {**lm["layers"][1], "mlp": {**lm["layers"][1]["mlp"], "up": entry}}
        return {**merged, "lm": lm}

    up = merged["lm"]["layers"][1]["mlp"]["up"]
    w = up["w"].clone()
    w[3, 5] += 1e-3 * w.abs().max()
    with pytest.raises(AssertionError, match="layer 1 mlp.up"):
        tmerge.merge_and_verify(params, tampered(1, {**up, "w": w}), lora, lcfg, extras)
    with pytest.raises(AssertionError, match="no weight change"):
        tmerge.merge_and_verify(params, tampered(1, params["lm"]["layers"][1]["mlp"]["up"]),
                                lora, lcfg, extras)
    conn = {**merged["acoustic_connector"],
            "fc1": {**merged["acoustic_connector"]["fc1"],
                    "b": merged["acoustic_connector"]["fc1"]["b"] + 1e-7}}
    with pytest.raises(AssertionError, match="override acoustic_connector"):
        tmerge.merge_and_verify(params, {**merged, "acoustic_connector": conn}, lora, lcfg,
                                extras)


def test_qa_harness_on_cpu(checkpoint, tmp_path):
    """qa_real_checkpoint --device cpu on the tiny checkpoint: exit 0 and a
    report with the JAX harness's keys (checkpoint, dtype, convert_seconds,
    parity, generate, rtf, ok); the upstream reference does not import
    here, so parity holds the skip's reason (not a pass); the forced rtf
    run made its 8 frames of audio. Without a card, --device cuda exits
    naming --device cpu."""
    path, _ = checkpoint
    report = tmp_path / "qa.json"
    rc = tqa.main([str(path), "--device", "cpu", "--frames", "8", "--ddpm_steps", "2",
                   "--report", str(report), "--reference_path", str(tmp_path / "none")])
    assert rc == 0
    rep = json.loads(report.read_text())
    assert set(rep) == {"checkpoint", "dtype", "convert_seconds", "parity", "generate", "rtf",
                        "ok"}
    assert rep["dtype"] == "float32" and rep["ok"] is True
    assert rep["parity"]["skipped"].startswith("reference unavailable")
    hop = TC.tiny_config().acoustic_tokenizer_config.hop_length
    assert rep["rtf"]["frames"] == 8 and rep["rtf"]["audio_seconds"] == round(8 * hop / 24000, 3)
    assert set(rep["generate"]) == {"prompt_tokens", "generated_steps", "audio_seconds",
                                    "wall_seconds"}
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="--device cpu"):
            tqa.main([str(path), "--report", str(report)])
