"""The port's own copies of the JAX package's framework-free modules agree
with the originals: the config dataclasses field for field (the three JSON
configs and tiny_config()), the copied 1.5B, 7B and 0.5B streaming JSONs
byte for byte, the processor (fallback tokenizer, voice prompts) on a
two-speaker script, and the streaming processor on a script over a
cached voice prompt."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from vibevoice_tpu import configs as jconfigs
from vibevoice_tpu.processor.processor import VibeVoiceProcessor as JProcessor
from vibevoice_tpu.processor.streaming_processor import VibeVoiceStreamingProcessor as JStreaming
from vibevoice_tpu.processor.text_tokenizer import FallbackTextTokenizer as JTokenizer

from vibevoice_tpu_torch import configs as tconfigs
from vibevoice_tpu_torch.processor.processor import VibeVoiceProcessor as TProcessor
from vibevoice_tpu_torch.processor.streaming_processor import (
    VibeVoiceStreamingProcessor as TStreaming)
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


COPIED = {"qwen2.5_1.5b_64k.json": 1536, "qwen2.5_7b_32k.json": 3584,
          "qwen2.5_0.5b_streaming.json": 896}


def test_copied_json_is_byte_equal_and_loads():
    """The port copies all three JSONs: the 1.5B's, the 7B's and the 0.5B
    streaming model's."""
    port_dir = ROOT / "vibevoice_tpu_torch" / "configs"
    assert len(JSONS) == 3
    assert sorted(p.name for p in port_dir.glob("*.json")) == sorted(COPIED)
    for name, hidden in COPIED.items():
        port = port_dir / name
        assert port.read_bytes() == (ROOT / "vibevoice_tpu" / "configs" / name).read_bytes()
        assert _load(tconfigs, port).decoder_config.hidden_size == hidden


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


def test_streaming_processor_matches_jax(tmp_path):
    """The streaming processor: the same script ids and pseudo prompt ids
    over a cached prompt given as a preset-like object and as the
    reference's dict, the same padded speech inputs, and a saved config
    that the other loads."""
    from types import SimpleNamespace

    preset = SimpleNamespace(lm_kv=(None, None, np.array([9], np.int32)),
                             tts_kv=(None, None, np.array([11], np.int32)))
    ref_dict = {"lm": {"last_hidden_state": np.zeros((1, 7, 4))},
                "tts_lm": {"last_hidden_state": np.zeros((1, 5, 4))}}
    text = "  Welcome back to the show, today we talk about speech.  "
    procs = [cls(tok_cls()) for cls, tok_cls in ((JStreaming, JTokenizer), (TStreaming, TTokenizer))]
    for cached in (preset, ref_dict):
        j, t = (p.process_input_with_cached_prompt(text, cached) for p in procs)
        for name in ("input_ids", "attention_mask", "tts_lm_input_ids", "tts_lm_attention_mask",
                     "tts_text_ids", "speech_input_mask"):
            want, got = getattr(j, name), getattr(t, name)
            assert got.dtype == want.dtype and got.shape == want.shape, name
            np.testing.assert_array_equal(got, want, err_msg=name)
    waves = [np.ones(5000, np.float32), np.ones(9000, np.float32)]
    j, t = (p.prepare_speech_inputs(waves) for p in procs)
    for name in ("padded_speeches", "speech_masks"):
        np.testing.assert_array_equal(t[name], j[name])
    procs[1].save_pretrained(str(tmp_path))
    back = JStreaming.from_pretrained(str(tmp_path))
    assert back.speech_tok_compress_ratio == procs[1].speech_tok_compress_ratio
