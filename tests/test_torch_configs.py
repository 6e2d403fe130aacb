"""The port's own copies of the JAX package's framework-free modules agree
with the originals: the config dataclasses field for field (the three JSON
configs and tiny_config()), the copied 1.5B JSON byte for byte, and the
processor (fallback tokenizer, voice prompts) on a two-speaker script."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from vibevoice_tpu import configs as jconfigs
from vibevoice_tpu.processor.processor import VibeVoiceProcessor as JProcessor
from vibevoice_tpu.processor.text_tokenizer import FallbackTextTokenizer as JTokenizer

from vibevoice_tpu_torch import configs as tconfigs
from vibevoice_tpu_torch.processor.processor import VibeVoiceProcessor as TProcessor
from vibevoice_tpu_torch.processor.text_tokenizer import FallbackTextTokenizer as TTokenizer

ROOT = Path(__file__).resolve().parent.parent
JSONS = sorted((ROOT / "vibevoice_tpu" / "configs").glob("*.json"))


def _load(mod, path: Path):
    cls = mod.VibeVoiceStreamingConfig if "streaming" in path.name else mod.VibeVoiceConfig
    return cls.from_json_file(str(path))


@pytest.mark.parametrize("which", [p.name for p in JSONS] + ["tiny_config()"])
def test_configs_equal_jax(which):
    if which == "tiny_config()":
        jcfg, tcfg = jconfigs.tiny_config(), tconfigs.tiny_config()
    else:
        jcfg = _load(jconfigs, ROOT / "vibevoice_tpu" / "configs" / which)
        tcfg = _load(tconfigs, ROOT / "vibevoice_tpu" / "configs" / which)
    assert type(tcfg).__name__ == type(jcfg).__name__
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)


def test_copied_json_is_byte_equal_and_loads():
    name = "qwen2.5_1.5b_64k.json"
    port = ROOT / "vibevoice_tpu_torch" / "configs" / name
    assert len(JSONS) == 3
    assert port.read_bytes() == (ROOT / "vibevoice_tpu" / "configs" / name).read_bytes()
    assert _load(tconfigs, port).decoder_config.hidden_size == 1536


def test_processor_matches_jax():
    """Same ids (the hash-bucket fallback tokenizer, in one process), masks,
    voice tensors and parsed scripts for two speakers with two voices, and
    for a batch of two scripts."""
    rng = np.random.RandomState(0)
    voices = [(0.3 * rng.randn(n)).astype(np.float32) for n in (7200, 9600)]
    script = ("Speaker 1: Welcome back to the show, today we talk about speech.\n"
              "Speaker 2: Thanks for having me!\nSpeaker 1: Let us begin.")
    outs = []
    for proc_cls, tok_cls in ((JProcessor, JTokenizer), (TProcessor, TTokenizer)):
        proc = proc_cls(tokenizer=tok_cls(), speech_tok_compress_ratio=3200)
        outs.append((proc(text=script, voice_samples=voices),
                     proc(text=[script, "Speaker 2: Short one."], voice_samples=[voices, voices[1:]])))
    for j, t in zip(*outs):
        for name in ("input_ids", "attention_mask", "speech_input_mask", "speech_tensors",
                     "speech_masks"):
            want, got = getattr(j, name), getattr(t, name)
            assert got.dtype == want.dtype and got.shape == want.shape, name
            np.testing.assert_array_equal(got, want, err_msg=name)
        assert t.parsed_scripts == j.parsed_scripts
        assert t.all_speakers_list == j.all_speakers_list
    assert outs[0][0].speech_masks.sum() > 0 and outs[0][0].speech_input_mask.sum() > 0
