"""The port's checkpoint loading (vibevoice_tpu_torch/utils/torch_convert.py,
utils/safetensors_io.py, utils/hf_interop.py, VibeVoiceTTS/StreamingTTS
.from_pretrained) against the JAX package's on the tiny configs.

No reference checkpoint ships with the repo, so the tests write their own:
the JAX package's init (randomised with numpy), carried to the port's
layout by ``from_jax`` and laid out as the reference's state dict by
``chip_smoke.reference_state_dict`` (the writer the card run uses at full
width). The JAX converter must read every key the writer writes and give
the JAX tree back; the port's converters must give
``from_jax(JAX converter)`` bit for bit, leaf by leaf, in every layout.

Tolerances: trees are bit-equal (dtypes too). generate() from the two
loaders: tokens equal, audio to 1e-5 of the peak dense (f32 summation
order) and 2e-2 with int8 (tests/test_torch_generate.py: the JAX CPU path
rounds tiny int8 linears to bf16 where the port keeps f32). The conv_norm
folding is held to torch's remove_* as tests/test_hf_interop.py holds the
JAX package's.
"""

import dataclasses
import json
import re
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vibevoice_tpu import configs as JC
from vibevoice_tpu import tts as jtts
from vibevoice_tpu.finetune import lora as jlora
from vibevoice_tpu.models import inference as jinf
from vibevoice_tpu.models import streaming as jst
from vibevoice_tpu.models import vibevoice as jvv
from vibevoice_tpu.utils import compile_cache as jcache
from vibevoice_tpu.utils import hf_interop as jhf

from vibevoice_tpu_torch import configs as TC
from vibevoice_tpu_torch.models import inference as tinf
from vibevoice_tpu_torch.models import streaming as tst
from vibevoice_tpu_torch.tts import StreamingTTS, VibeVoiceTTS
from vibevoice_tpu_torch.utils import hf_interop as thf
from vibevoice_tpu_torch.utils import safetensors_io, torch_convert
from vibevoice_tpu_torch.utils.params import from_jax

import chip_smoke

TOK = dict(speech_start=5, speech_end=6, speech_diffusion=7, eos=2)
SCRIPT = np.array([7, 7, 7, 6, 5, 7, 7, -1, 7, 7, 2], np.int64)[:, None]
INT8_TOL = 2e-2  # of the peak (tests/test_torch_generate.py)
CONV_KEY = re.compile(r"(conv|convtr)\.weight$")


def _untied(C):
    cfg = C.tiny_config()
    return dataclasses.replace(cfg, decoder_config=dataclasses.replace(
        cfg.decoder_config, tie_word_embeddings=False))


def _streaming(C):
    return C.VibeVoiceStreamingConfig(
        acoustic_tokenizer_config=C.AcousticTokenizerConfig(
            vae_dim=16, encoder_n_filters=4, encoder_ratios=(4, 2), encoder_depths=(1, 1, 2),
            decoder_n_filters=4),
        decoder_config=C.Qwen2Config(
            vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=4,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=1024,
            rope_theta=10_000.0),
        diffusion_head_config=C.DiffusionHeadConfig(hidden_size=64, head_layers=2,
                                                    latent_size=16),
        tts_backbone_num_hidden_layers=2)


CFGS = {"tied": (JC.tiny_config(), TC.tiny_config()), "untied": (_untied(JC), _untied(TC)),
        "streaming": (_streaming(JC), _streaming(TC))}


def _randomize(tree, seed):
    """JAX init's tree (its shapes and dtypes) filled from numpy: matrices
    N(0, 0.7 / sqrt(fan-in)), vectors perturbed (norms around 1), layer
    scales 0.3, the two scale scalars 0.8 and 0.1, so that every weight and
    every key of the checkpoint does work."""
    rng = np.random.RandomState(seed)

    def fill(path, x):
        name = jax.tree_util.keystr(path)
        if "gamma" in name:
            return jnp.full(x.shape, 0.3, x.dtype)
        if x.ndim == 0:
            return jnp.asarray(0.8 if "scaling" in name else 0.1, x.dtype)
        if x.ndim == 1:
            return jnp.asarray(rng.randn(*x.shape) * 0.1 + (1.0 if "norm" in name else 0.0),
                               x.dtype)
        return jnp.asarray(rng.randn(*x.shape) * (0.7 / np.sqrt(np.prod(x.shape[:-1]))), x.dtype)

    return jax.tree_util.tree_map_with_path(fill, tree)


@pytest.fixture(scope="module")
def trees():
    """kind -> (JAX config, port config, JAX tree, the port's from_jax of it)."""
    out = {}
    for kind, (jcfg, tcfg) in CFGS.items():
        init = jst.init if kind == "streaming" else jvv.init
        jp = _randomize(jax.eval_shape(lambda key: init(key, jcfg), jax.random.PRNGKey(0)), 1)
        out[kind] = (jcfg, tcfg, jp, from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu"))
    return out


def _sd(tp, kind, **kw):
    """The reference state dict of a port tree, as contiguous CPU tensors."""
    sd = chip_smoke.reference_state_dict(tp, streaming=kind == "streaming", **kw)
    return {k: v.contiguous() for k, v in sd.items()}


def _config_json(cfg):
    blob = dataclasses.asdict(cfg)
    blob["model_type"] = ("vibevoice_streaming" if isinstance(cfg, TC.VibeVoiceStreamingConfig)
                          else "vibevoice")
    return json.loads(json.dumps(blob, default=str))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def assert_same_tree(got, want):
    """Bit-equal, key by key and dtype by dtype (torch trees)."""
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(g) == sorted(w)
    for k in w:
        assert isinstance(g[k], torch.Tensor), k
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, (k, g[k].dtype, w[k].dtype)
        assert torch.equal(g[k].reshape(-1).view(torch.uint8) if g[k].numel() else g[k],
                           w[k].reshape(-1).view(torch.uint8) if w[k].numel() else w[k]), k


class _Read:
    """A state-dict value that records its key when the JAX converter reads
    it (``_np`` calls ``detach``; ``np.asarray`` calls ``__array__``)."""

    def __init__(self, key, value, reads):
        self.key, self.value, self.reads = key, value, reads

    def detach(self):
        self.reads.add(self.key)
        return self.value.detach()

    def __array__(self, dtype=None, copy=None):
        self.reads.add(self.key)
        return self.value.numpy() if dtype is None else self.value.numpy().astype(dtype)


# ---------------------------------------------------------------------------
# the writer against the JAX converter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,prefix", [("tied", "model."), ("untied", ""),
                                         ("streaming", "model."), ("streaming", "")])
def test_jax_converter_reads_every_written_key(trees, kind, prefix):
    """The JAX converter reads every key the writer writes (a key it never
    reads would mean the two converters could agree on a wrong layout) and
    gives the JAX tree back exactly."""
    jcfg, _, jp, tp = trees[kind]
    sd = _sd(tp, kind, prefix=prefix)
    if kind == "untied":
        assert "lm_head.weight" in sd
    reads = set()
    wrapped = {k: _Read(k, v, reads) for k, v in sd.items()}
    convert = jhf.convert_streaming_model if kind == "streaming" else jhf.convert_full_model
    back = convert(wrapped, jcfg)
    assert sorted(set(sd) - reads) == []
    want = dict(_leaves(jax.tree.map(np.asarray, jp)))
    got = dict(_leaves(jax.tree.map(np.asarray, back)))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# the converters against the JAX package's
# ---------------------------------------------------------------------------


def _reparametrize(sd, conv_norm, seed=0):
    """Every conv weight stored as conv_norm's reparametrization would store
    it: weight_norm (legacy weight_g / weight_v, or the parametrize API's
    original0 / original1) or spectral_norm (weight_orig, weight_u,
    weight_v)."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in sd.items():
        if not CONV_KEY.search(k):
            out[k] = v
            continue
        pre, w = k[: -len(".weight")], v.numpy()
        g = torch.from_numpy(rng.uniform(0.5, 1.5, (w.shape[0],) + (1,) * (w.ndim - 1))
                             .astype(np.float32))
        if conv_norm == "weight_norm":
            out[pre + ".weight_g"], out[pre + ".weight_v"] = g, v
        elif conv_norm == "parametrize":
            out[pre + ".parametrizations.weight.original0"] = g
            out[pre + ".parametrizations.weight.original1"] = v
        else:
            u = rng.randn(w.shape[0]).astype(np.float32)
            vv = rng.randn(int(np.prod(w.shape[1:]))).astype(np.float32)
            out[pre + ".weight_orig"] = v
            out[pre + ".weight_u"] = torch.from_numpy(u / np.linalg.norm(u))
            out[pre + ".weight_v"] = torch.from_numpy(vv / np.linalg.norm(vv))
    return out


CONVERT_CASES = [
    ("tied", dict(prefix="model."), None),
    ("untied", dict(prefix=""), None),
    ("tied", dict(prefix="model."), "weight_norm"),
    ("tied", dict(prefix=""), "parametrize"),
    ("tied", dict(prefix="model."), "spectral_norm"),
    ("streaming", dict(prefix="model."), None),
    ("streaming", dict(prefix="", lower_norm=False, upper_embed=False), None),
    ("streaming", dict(prefix="model.", lower_norm=False, upper_embed=False), "weight_norm"),
]


@pytest.mark.parametrize("kind,layout,conv_norm", CONVERT_CASES,
                         ids=[f"{k}-{l['prefix'] or 'bare'}-{'headless-' if 'lower_norm' in l else ''}"
                              f"{c or 'plain'}" for k, l, c in CONVERT_CASES])
def test_converters_match_jax(trees, kind, layout, conv_norm):
    """convert_full_model / convert_streaming_model on one f32 state dict:
    the port's tree is from_jax(the JAX converter's), bit for bit; tied
    and untied lm_head, the `model.` prefix and none, a lower stack without
    its final norm and an upper one without its embedding (filled with ones
    and zeros), and the conv_norm reparametrizations."""
    jcfg, tcfg, _, tp = trees[kind]
    sd = _sd(tp, kind, **layout)
    if conv_norm:
        sd = _reparametrize(sd, conv_norm)
    streaming = kind == "streaming"
    jconvert = jhf.convert_streaming_model if streaming else jhf.convert_full_model
    tconvert = thf.convert_streaming_model if streaming else thf.convert_full_model
    want = from_jax(jax.tree.map(np.asarray, jconvert({k: v.numpy() for k, v in sd.items()}, jcfg)),
                    tcfg, device="cpu")
    got = tconvert(sd, tcfg, device="cpu")
    assert_same_tree(got, want)
    if "lower_norm" in layout:
        assert torch.equal(got["language_model"]["final_norm"]["w"], torch.ones(64))
        assert not got["tts_language_model"]["embed"].any()
    assert ("lm_head" in got) == (kind == "untied")
    # and the cast: bf16 on the way in is the JAX loader's _to_dtype after it
    got16 = tconvert(sd, tcfg, dtype="bfloat16", device="cpu")
    want16 = thf._to_dtype(want, torch.bfloat16)
    assert_same_tree(got16, want16)


def test_raw_conv_weight_folds_as_torch_removes():
    """conv_norm checkpoints store reparametrized conv tensors; the folding
    gives the eval-time weight torch computes (tests/test_hf_interop.py's
    checks and limits, on the port's _raw_conv_weight), and a plain weight
    passes through untouched."""
    from vibevoice_tpu_torch.utils.torch_convert import _raw_conv_weight

    torch.manual_seed(0)
    conv = torch.nn.Conv1d(4, 6, 5)
    wn = torch.nn.utils.weight_norm(torch.nn.Conv1d(4, 6, 5))
    wn.load_state_dict(dict(torch.nn.utils.weight_norm(conv).state_dict()))
    sd = {f"c.{k}": v for k, v in wn.state_dict().items()}
    folded = _raw_conv_weight(sd, "c")
    ref = torch.nn.utils.remove_weight_norm(wn).weight.detach().numpy()
    np.testing.assert_allclose(folded, ref, rtol=1e-6, atol=1e-6)

    pn = torch.nn.utils.parametrizations.weight_norm(torch.nn.Conv1d(4, 6, 5))
    sd = {f"c.{k}": v for k, v in pn.state_dict().items()}
    folded = _raw_conv_weight(sd, "c")
    torch.nn.utils.parametrize.remove_parametrizations(pn, "weight")
    np.testing.assert_allclose(folded, pn.weight.detach().numpy(), rtol=1e-6, atol=1e-6)

    sn = torch.nn.utils.spectral_norm(torch.nn.Conv1d(4, 6, 5))
    sn.eval()
    with torch.no_grad():
        sn(torch.zeros(1, 4, 16))
    sd = {f"c.{k}": v for k, v in sn.state_dict().items()}
    folded = _raw_conv_weight(sd, "c")
    ref = torch.nn.utils.remove_spectral_norm(sn).weight.detach().numpy()
    np.testing.assert_allclose(folded, ref, rtol=1e-5, atol=1e-6)

    sd = {"c.weight": conv.weight.detach()}
    assert _raw_conv_weight(sd, "c") is sd["c.weight"]


# ---------------------------------------------------------------------------
# the safetensors reader
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(safetensors_io.DTYPES))
def test_reader_matches_safetensors(tmp_path, name):
    """The port's reader against safetensors.torch.load_file, bit for bit,
    for each dtype it maps: a matrix, a 0-d tensor and an empty one, beside
    an odd-length bf16 tensor, in a file that safetensors itself wrote."""
    from safetensors.torch import load_file, save_file

    dtype = safetensors_io.DTYPES[name]
    g = torch.Generator().manual_seed(0)
    raw = torch.randint(0, 256, (3 * 5 * 8 + 8,), dtype=torch.uint8, generator=g)
    if dtype == torch.bool:
        mat, scalar = raw[:15].reshape(3, 5) % 2 == 1, torch.tensor(True)
    else:
        size = torch.empty((), dtype=dtype).element_size()
        mat = raw[: 15 * size].view(dtype).reshape(3, 5)
        scalar = raw[15 * size: 16 * size].view(dtype).reshape(())
    tensors = {"a_odd": torch.ones(3, dtype=torch.bfloat16), "b_mat": mat, "c_scalar": scalar,
               "d_empty": torch.zeros(0, 4, dtype=dtype)}
    path = str(tmp_path / "x.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    want, got = load_file(path), safetensors_io.load_file(path)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]) or (got[k].numel() and torch.equal(
            got[k].reshape(-1).view(torch.uint8), want[k].reshape(-1).view(torch.uint8))), k


def test_reader_refuses_other_dtypes_and_writer_round_trips(tmp_path):
    """A dtype outside the map (float8) is refused by name; chip_smoke's
    writer gives files that safetensors itself reads back bit for bit, and
    so does the port's reader, also where a tensor's start is not aligned
    to its dtype (the writer keeps the dict's order: the int64 after 15
    bf16 values), whose bytes it copies rather than views."""
    from safetensors.torch import load_file, save_file

    path = str(tmp_path / "f8.safetensors")
    save_file({"w": torch.zeros(4, dtype=torch.float8_e4m3fn)}, path)
    with pytest.raises(ValueError, match="F8_E4M3"):
        safetensors_io.load_file(path)
    g = torch.Generator().manual_seed(1)
    tensors = {"w": torch.randn(5, 3, generator=g).to(torch.bfloat16).t(),
               "i": torch.arange(7, dtype=torch.int64), "s": torch.tensor(0.5)}
    path = str(tmp_path / "mine.safetensors")
    n = chip_smoke.write_safetensors(path, tensors)
    assert n == (tmp_path / "mine.safetensors").stat().st_size
    back, mine = load_file(path), safetensors_io.load_file(path)
    header, base = safetensors_io.read_header(path)
    assert (base + header["i"]["data_offsets"][0]) % 8 != 0
    for k, v in tensors.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
        assert mine[k].dtype == v.dtype and torch.equal(mine[k], v), k


# ---------------------------------------------------------------------------
# checkpoint directories, native checkpoints, routing
# ---------------------------------------------------------------------------


def _write_dir(path, tp, tcfg, kind, layout, dtype=torch.float32, **writer):
    from safetensors.torch import save_file

    sd = {k: v.to(dtype) if v.is_floating_point() else v for k, v in _sd(tp, kind, **writer).items()}
    path.mkdir(parents=True, exist_ok=True)
    if layout == "sharded":
        chip_smoke.write_checkpoint(path, sd, _config_json(tcfg))
    else:
        (path / "config.json").write_text(json.dumps(_config_json(tcfg)))
        if layout == "single":
            save_file(sd, str(path / "model.safetensors"))
        else:
            torch.save(sd, str(path / "pytorch_model.bin"))
    return path


@pytest.mark.parametrize("layout,dtype", [("single", "float32"), ("sharded", "float32"),
                                          ("sharded", "bfloat16"), ("bin", "float32")])
def test_load_checkpoint_matches_jax(trees, tmp_path, layout, dtype):
    """One tiny multi-speaker checkpoint directory per layout (one
    safetensors file; three shards with model.safetensors.index.json, f32
    and bf16; pytorch_model.bin), loaded by both packages at ``dtype``:
    the port's tree is from_jax(the JAX package's), bit for bit."""
    jcfg, tcfg, _, tp = trees["untied"]
    stored = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    path = _write_dir(tmp_path / "ckpt", tp, tcfg, "untied", layout, stored)
    _, jparams, _ = jhf.load_checkpoint(str(path), dtype=dtype, allow_fallback_tokenizer=True)
    cfg, got, proc = thf.load_checkpoint(str(path), dtype=dtype, allow_fallback_tokenizer=True,
                                         device="cpu")
    assert cfg == tcfg and proc.tokenizer.speech_diffusion_id == TOK["speech_diffusion"]
    assert_same_tree(got, from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu"))
    assert got["lm"]["embed"].dtype == thf._dtype(dtype)


def test_native_checkpoints_cross_load(trees, tmp_path):
    """A params.pkl that the JAX package's save_native wrote (f32 and bf16)
    loads in the port as from_jax of the tree; the port's save_native
    writes what the JAX package's load_native reads back as the JAX tree."""
    jcfg, tcfg, jp, tp = trees["tied"]
    for dtype in (jnp.float32, jnp.bfloat16):
        tree = jhf._to_dtype(jp, dtype)
        jhf.save_native(str(tmp_path / f"jax-{dtype.__name__}"), jcfg, tree)
        cfg, got = thf.load_native(str(tmp_path / f"jax-{dtype.__name__}"), device="cpu")
        assert cfg == tcfg
        assert_same_tree(got, from_jax(jax.tree.map(np.asarray, tree), tcfg, device="cpu"))
    for dtype in (torch.float32, torch.bfloat16):
        path = str(tmp_path / f"port-{dtype}")
        thf.save_native(path, tcfg, thf._to_dtype(tp, dtype))
        cfg, back = jhf.load_native(path)
        assert cfg == jcfg
        want = dict(_leaves(jax.tree.map(np.asarray, jhf._to_dtype(jp, jnp.dtype(str(dtype)[6:])))))
        got = dict(_leaves(jax.tree.map(np.asarray, back)))
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_native_bf16_needs_ml_dtypes(trees, tmp_path, monkeypatch):
    """Without ml_dtypes a bf16 tree can be neither pickled in the JAX
    format nor read from it: both raise and name the package (no silent
    cast); an f32 tree needs none."""
    jcfg, tcfg, jp, tp = trees["tied"]
    jhf.save_native(str(tmp_path / "bf16"), jcfg, jhf._to_dtype(jp, jnp.bfloat16))
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    with pytest.raises(ImportError, match="ml_dtypes"):
        thf.save_native(str(tmp_path / "port"), tcfg, thf._to_dtype(tp, torch.bfloat16))
    with pytest.raises(ImportError, match="ml_dtypes"):
        thf.load_native(str(tmp_path / "bf16"), device="cpu")
    thf.save_native(str(tmp_path / "f32"), tcfg, tp)
    assert_same_tree(thf.load_native(str(tmp_path / "f32"), device="cpu")[1], tp)


def test_load_pretrained_routes_by_model_type(trees, tmp_path):
    """load_pretrained routes HF-style and native directories of both
    models by config.json's model_type, and by its structure where the
    field is missing, as the JAX package's read_model_type does; the
    streaming model refuses int8."""
    cases = []
    for kind in ("tied", "streaming"):
        jcfg, tcfg, jp, tp = trees[kind]
        hf_dir = _write_dir(tmp_path / f"hf-{kind}", tp, tcfg, kind, "sharded")
        native = tmp_path / f"native-{kind}"
        thf.save_native(str(native), tcfg, tp)
        cases += [(hf_dir, kind), (native, kind)]
    bare = tmp_path / "bare-streaming"
    _write_dir(bare, trees["streaming"][3], trees["streaming"][1], "streaming", "single")
    blob = json.loads((bare / "config.json").read_text())
    del blob["model_type"]
    (bare / "config.json").write_text(json.dumps(blob))
    cases.append((bare, "streaming"))
    for path, kind in cases:
        want = "vibevoice_streaming" if kind == "streaming" else "vibevoice"
        assert thf.read_model_type(str(path)) == jhf.read_model_type(str(path)) == want
        loaded = thf.load_pretrained(str(path), dtype="float32", allow_fallback_tokenizer=True,
                                     device="cpu")
        assert loaded.model_type == want and set(loaded.walls) >= {"read"}
        assert_same_tree(loaded.params, thf._to_dtype(trees[kind][3], torch.float32))
        cfg, params, proc = loaded
        assert cfg == trees[kind][1]
    with pytest.raises(NotImplementedError, match="int8"):
        thf.load_pretrained(str(cases[2][0]), int8=True, allow_fallback_tokenizer=True,
                            device="cpu")


# ---------------------------------------------------------------------------
# end to end: from_pretrained and generate() against the JAX package's
# ---------------------------------------------------------------------------


def write_tokenizer(path, vocab_size):
    """A word-level tokenizer (tokenizer.json + tokenizer_config.json) whose
    special tokens carry the tiny configs' ids: <|endoftext|> 2, the
    speech tokens (<|vision_start|>, _end|>, _pad|>) 5-7, <|image_pad|> 3."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    specials = {"<|endoftext|>": 2, "<|image_pad|>": 3, "<|vision_start|>": 5,
                "<|vision_end|>": 6, "<|vision_pad|>": 7}
    vocab = {f"w{i}": i for i in range(vocab_size) if i not in specials.values()}
    vocab.update(specials)
    tok = Tokenizer(models.WordLevel(vocab, unk_token="w1"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.save(str(path / "tokenizer.json"))
    (path / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "PreTrainedTokenizerFast", "eos_token": "<|endoftext|>",
         "unk_token": "w1", "pad_token": "<|image_pad|>"}))


@pytest.fixture(scope="module")
def checkpoint(trees, tmp_path_factory):
    """A tiny multi-speaker checkpoint (three f32 shards, a tokenizer) and
    LoRA assets written by the JAX package's save_lora_assets."""
    jcfg, tcfg, jp, tp = trees["untied"]
    path = _write_dir(tmp_path_factory.mktemp("ckpt") / "model", tp, tcfg, "untied", "sharded")
    write_tokenizer(path, tcfg.decoder_config.vocab_size)
    lcfg = jlora.LoraConfig(r=4, alpha=8)
    adapters = jax.eval_shape(lambda key: jlora.init_lora(key, jp, lcfg), jax.random.PRNGKey(3))
    rng = np.random.RandomState(5)
    adapters = jax.tree.map(lambda x: jnp.asarray(rng.randn(*x.shape) * 0.05, x.dtype), adapters)
    jlora.save_lora_assets(str(path.parent / "lora"), adapters, lcfg)
    return path, path.parent / "lora"


def _inputs(hop, vae):
    rng = np.random.RandomState(0)
    ids = rng.randint(10, 100, (1, 12)).astype(np.int64)
    ids[0, 2:6] = TOK["speech_diffusion"]
    ids[0, -1] = TOK["speech_start"]
    mask = np.zeros((1, 12), bool)
    mask[0, 2:6] = True
    bank = {"init": rng.randn(16, 1, vae).astype(np.float32),
            "vae_std": rng.randn(1).astype(np.float32),
            "vae_eps": rng.randn(1, 4, vae).astype(np.float32)}
    return dict(input_ids=ids, speech_tensors=rng.randn(1, 4 * hop).astype(np.float32),
                speech_frame_valid=np.ones((1, 4), bool), speech_input_mask=mask,
                noise_bank=bank, forced_tokens=SCRIPT)


@pytest.mark.parametrize("int8,lora", [(False, False), (True, False), (False, True),
                                       (True, True)])
def test_from_pretrained_generate_matches_jax(checkpoint, monkeypatch, int8, lora):
    """VibeVoiceTTS.from_pretrained in both packages on one checkpoint
    (dense, int8, with LoRA assets merged, and int8 after the merge):
    the same special tokens from the tokenizer, and generate() with a
    forced script and a noise bank gives equal tokens and audio within
    1e-5 of the peak (dense) or INT8_TOL (int8)."""
    monkeypatch.setattr(jcache, "_DONE", True)  # no XLA disk cache for this process
    path, lora_path = checkpoint
    kw = dict(int8=int8, dtype="float32", lora_path=str(lora_path) if lora else None)
    j = jtts.VibeVoiceTTS.from_pretrained(str(path), **kw)
    t = VibeVoiceTTS.from_pretrained(str(path), device="cpu", **kw)
    assert {k: getattr(t.tokens, k) for k in TOK} == {k: getattr(j.tokens, k) for k in TOK} == TOK
    assert ("lm_head_q" in t.params) == int8 and t.load_walls
    hop = t.cfg.acoustic_tokenizer_config.hop_length
    inputs = _inputs(hop, t.cfg.acoustic_vae_dim)
    jo = jinf.generate(j.cfg, j.params, tokens=j.tokens,
                       opts=jinf.GenerateOptions(ddpm_steps=3, max_length=64), **inputs)
    to = tinf.generate(t.cfg, t.params, tokens=t.tokens,
                       opts=tinf.GenerateOptions(ddpm_steps=3, max_length=64), **inputs)
    np.testing.assert_array_equal(to.sequences, jo.sequences)
    a, b = np.asarray(jo.speech_outputs[0], np.float32), to.speech_outputs[0]
    assert a.shape == b.shape and len(a) >= 5 * hop  # the model may pick EOS at its free frame
    peak = float(np.abs(a).max())
    assert peak > 1e-3
    assert float(np.abs(a - b).max()) <= (INT8_TOL if int8 else 1e-5) * peak


def _pt_preset(preset, path):
    """The reference's .pt schema (four streams; last_hidden_state
    (1, S, H) whose last row is the preset's, past_key_values per layer
    (1, KH, S, D)) holding a VoicePreset's arrays."""
    def stream(kv, h):
        k, v, _ = (np.asarray(x) for x in kv)
        s = k.shape[3]
        hidden = np.zeros((1, s, h.shape[-1]), np.float32)
        hidden[:, -1] = np.asarray(h)
        return {"last_hidden_state": torch.from_numpy(hidden),
                "past_key_values": [(torch.from_numpy(k[i]), torch.from_numpy(v[i]))
                                    for i in range(k.shape[0])]}

    torch.save({"lm": stream(preset.lm_kv, preset.lm_h),
                "tts_lm": stream(preset.tts_kv, preset.tts_h),
                "neg_lm": stream(preset.neg_tts_kv, preset.neg_tts_h),
                "neg_tts_lm": stream(preset.neg_tts_kv, preset.neg_tts_h)}, str(path))


@pytest.mark.parametrize("voice", ["npz", "pt"])
def test_streaming_from_pretrained_generate_matches_jax(trees, tmp_path, monkeypatch, voice):
    """StreamingTTS.from_pretrained in both packages on one streaming
    checkpoint (no lower final norm, as the reference stores it) with a
    .npz or a reference .pt preset: the same preset arrays, and generate()
    with a noise bank, EOS held off (bias -30 in both trees) and the cache
    capacity stopping it after three windows, gives the same frames (1e-5
    of the peak) as tests/test_torch_streaming.py holds it."""
    monkeypatch.setattr(jcache, "_DONE", True)
    jcfg, tcfg, jp, tp = trees["streaming"]
    path = _write_dir(tmp_path / "rt", tp, tcfg, "streaming", "sharded", lower_norm=False)
    write_tokenizer(path, tcfg.decoder_config.vocab_size)
    prompt = np.random.RandomState(0).randint(10, 200, (1, 12))
    jpre = jst.build_voice_preset(jcfg, jhf.load_streaming_checkpoint(str(path), dtype="float32")[1],
                                  prompt, neg_prompt_id=3, max_len=96)
    preset = tmp_path / f"voice.{voice}"
    if voice == "npz":
        jpre.save(str(preset))
    else:
        _pt_preset(jpre, preset)
    j = jtts.StreamingTTS.from_pretrained(str(path), voice=str(preset), dtype="float32")
    t = StreamingTTS.from_pretrained(str(path), voice=str(preset), dtype="float32", device="cpu")
    for name in ("lm_kv", "tts_kv", "neg_tts_kv"):
        for a, b in zip(getattr(t.preset, name), getattr(j.preset, name)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    eos = lambda tree, full: {**tree, "tts_eos_classifier": {  # noqa: E731
        **tree["tts_eos_classifier"], "fc2": {**tree["tts_eos_classifier"]["fc2"], "b": full}}}
    jparams, tparams = eos(j.params, jnp.full((1,), -30.0)), eos(t.params, torch.full((1,), -30.0))
    text = np.random.RandomState(9).randint(10, 200, (1, 15))
    bank = {"init": np.random.RandomState(9).randn(60, 1, 16).astype(np.float32)}
    kw = dict(tts_text_ids=text, max_len=12 + 33, seed=0, noise_bank=bank)
    jo = jst.generate(jcfg, jparams, preset=j.preset,
                      opts=jinf.GenerateOptions(cfg_scale=1.5, ddpm_steps=3), **kw)
    to = tst.generate(tcfg, tparams, preset=t.preset,
                      opts=tinf.GenerateOptions(cfg_scale=1.5, ddpm_steps=3), **kw)
    a, b = np.asarray(jo.speech_outputs[0], np.float32), to.speech_outputs[0]
    assert a.shape == b.shape == (18 * tcfg.acoustic_tokenizer_config.hop_length,)
    assert float(np.abs(a - b).max()) <= 1e-5 * float(np.abs(a).max())
    np.testing.assert_array_equal(to.sequences, jo.sequences)


def test_from_pretrained_wants_a_card_and_a_tokenizer(trees, tmp_path, monkeypatch):
    """Without device="cpu" the loaders and converters want the card and, where there is
    none, raise naming device="cpu" before reading a file; a checkpoint
    without tokenizer files raises unless VIBEVOICE_ALLOW_FALLBACK_TOKENIZER
    is set (then the hash-bucket tokenizer serves)."""
    jcfg, tcfg, _, tp = trees["tied"]
    path = _write_dir(tmp_path / "bare", tp, tcfg, "tied", "single")
    monkeypatch.delenv("VIBEVOICE_ALLOW_FALLBACK_TOKENIZER", raising=False)
    with pytest.raises(RuntimeError, match="tokenizer"):
        VibeVoiceTTS.from_pretrained(str(path), device="cpu")
    monkeypatch.setenv("VIBEVOICE_ALLOW_FALLBACK_TOKENIZER", "1")
    with pytest.warns(RuntimeWarning, match="FALLING BACK"):
        tts = VibeVoiceTTS.from_pretrained(str(path), device="cpu")
    assert tts.params["lm"]["embed"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="VibeVoiceTTS.from_pretrained"):
        StreamingTTS.from_pretrained(str(path), voice="x.npz", device="cpu")
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    for call in (lambda: VibeVoiceTTS.from_pretrained(str(path)),
                 lambda: StreamingTTS.from_pretrained(str(path), voice="x.npz"),
                 lambda: thf.load_pretrained(str(path)),
                 lambda: thf.load_native(str(path)),
                 lambda: thf.convert_full_model({}, tcfg),
                 lambda: thf.convert_streaming_model({}, CFGS["streaming"][1]),
                 lambda: torch_convert.Put()):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()


def test_put_casts_floats_only_and_keeps_views():
    """Put moves and casts floating tensors only; an int tensor keeps its
    dtype, and a tensor already in place is not copied."""
    put = torch_convert.Put(torch.bfloat16, device="cpu")
    x = torch.arange(4)
    assert put(x).dtype == torch.int64 and put(np.ones(2, np.float32)).dtype == torch.bfloat16
    y = torch.ones(3)
    assert torch_convert.Put(device="cpu")(y).data_ptr() == y.data_ptr()
