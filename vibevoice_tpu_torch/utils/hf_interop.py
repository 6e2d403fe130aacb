"""Checkpoint loading (port of vibevoice_tpu/utils/hf_interop.py): HF-style
directories (sharded safetensors with ``model.safetensors.index.json``, or
``pytorch_model*.bin``) and the JAX package's native format (``params.pkl``
+ ``config.json``) -> the port's parameter tree, plus ``save_native``.

State-dict prefixes follow VibeVoiceForConditionalGenerationInference
(reference modeling_vibevoice_inference.py:68-85) and
VibeVoiceStreamingForConditionalGenerationInference
(reference modeling_vibevoice_streaming_inference.py:93-117).

Every loader builds the tree on ``device``, the card unless the caller
asks for the CPU, and raises without one. The shards are memory-mapped
and moved to the device in their stored dtype; the layout changes, the
cast to ``dtype`` and the int8 quantization run there.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import time
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..configs import VibeVoiceConfig, VibeVoiceStreamingConfig
from . import torch_convert as tc
from .params import _device, _map, from_jax
from .safetensors_io import load_file

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def _dtype(dtype) -> torch.dtype:
    return DTYPES[dtype] if isinstance(dtype, str) else dtype


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Every weight file of a checkpoint directory as one flat dict of CPU
    tensors in the stored dtypes (safetensors shards memory-mapped): the
    shards that the index's ``weight_map`` names (else every
    ``*.safetensors``), else every ``pytorch_model*.bin``."""
    files = sorted(os.listdir(path))
    index = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            st_files = sorted(set(json.load(f)["weight_map"].values()))
    else:
        st_files = [f for f in files if f.endswith(".safetensors")]
    bin_files = [f for f in files if f.endswith(".bin") and "pytorch_model" in f]
    sd: Dict[str, torch.Tensor] = {}
    if st_files:
        for f in st_files:
            sd.update(load_file(os.path.join(path, f)))
    elif bin_files:
        for f in bin_files:
            sd.update(torch.load(os.path.join(path, f), map_location="cpu", weights_only=True))
    else:
        raise FileNotFoundError(f"no safetensors/bin weights found in {path}")
    return sd


def _to_dtype(tree, dtype: torch.dtype):
    """Every floating leaf (the two scale scalars included) cast to dtype."""
    return _map(tree, lambda x: x.to(dtype) if x.is_floating_point() else x)


def _put(dtype, device) -> tc.Put:
    return tc.Put(_dtype(dtype) if dtype is not None else None, device)


def _scalar(sd: Dict, key: str, default: float, put: tc.Put) -> torch.Tensor:
    x = sd[key] if key in sd else np.float32(default)
    return put(x).reshape(())


def convert_full_model(sd: Dict, cfg: VibeVoiceConfig, *, dtype=None, device="cuda") -> Dict:
    """State dict of VibeVoice(ForConditionalGeneration[Inference]) -> tree
    on ``device`` (the card unless the caller asks for the CPU), floating
    tensors cast to ``dtype`` (None: as stored)."""
    put = _put(dtype, device)
    prefix = "model." if any(k.startswith("model.") for k in sd) else ""
    p = {
        "lm": tc.convert_qwen2(sd, cfg.decoder_config, prefix + "language_model", put),
        "acoustic_tokenizer": tc.convert_acoustic_tokenizer(
            sd, cfg.acoustic_tokenizer_config, prefix + "acoustic_tokenizer", put),
        "semantic_tokenizer": tc.convert_semantic_tokenizer(
            sd, cfg.semantic_tokenizer_config, prefix + "semantic_tokenizer", put),
        "acoustic_connector": tc.convert_speech_connector(sd, prefix + "acoustic_connector", put),
        "semantic_connector": tc.convert_speech_connector(sd, prefix + "semantic_connector", put),
        "diffusion_head": tc.convert_diffusion_head(
            sd, cfg.diffusion_head_config, prefix + "prediction_head", put),
        "speech_scaling_factor": _scalar(sd, prefix + "speech_scaling_factor", 1.0, put),
        "speech_bias_factor": _scalar(sd, prefix + "speech_bias_factor", 0.0, put),
    }
    # the reference's lm_head sits beside `model.`, not under it
    if not cfg.decoder_config.tie_word_embeddings and "lm_head.weight" in sd:
        p["lm_head"] = put(sd["lm_head.weight"])
    return p


def convert_streaming_model(sd: Dict, cfg: VibeVoiceStreamingConfig, *, dtype=None,
                            device="cuda") -> Dict:
    """State dict of the streaming model -> tree on ``device``. The prefix is
    detected from ``model.language_model`` (not any ``model.`` key, as for
    the full model), and the EOS classifier is read without it, as the JAX
    converter reads them."""
    put = _put(dtype, device)
    prefix = "model." if any(k.startswith("model.language_model") for k in sd) else ""
    lower = dataclasses.replace(cfg.decoder_config, num_hidden_layers=cfg.lm_num_hidden_layers)
    upper = dataclasses.replace(cfg.decoder_config,
                                num_hidden_layers=cfg.tts_backbone_num_hidden_layers)
    return {
        "language_model": tc.convert_qwen2_headless(sd, lower, prefix + "language_model", put),
        "tts_language_model": tc.convert_qwen2_headless(sd, upper, prefix + "tts_language_model",
                                                        put),
        "tts_input_types": put(sd[prefix + "tts_input_types.weight"]),
        "tts_eos_classifier": {"fc1": tc._linear_params(sd, "tts_eos_classifier.fc1", put),
                               "fc2": tc._linear_params(sd, "tts_eos_classifier.fc2", put)},
        "acoustic_tokenizer": tc.convert_acoustic_tokenizer(
            sd, cfg.acoustic_tokenizer_config, prefix + "acoustic_tokenizer", put),
        "acoustic_connector": tc.convert_speech_connector(sd, prefix + "acoustic_connector", put),
        "diffusion_head": tc.convert_diffusion_head(
            sd, cfg.diffusion_head_config, prefix + "prediction_head", put),
        "speech_scaling_factor": _scalar(sd, prefix + "speech_scaling_factor", 1.0, put),
        "speech_bias_factor": _scalar(sd, prefix + "speech_bias_factor", 0.0, put),
    }


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Walls:
    """Wall seconds of a load's phases (read, transfer, convert, quantize),
    each ending in a device synchronisation."""

    def __init__(self, device: torch.device):
        self.device, self.walls, self.t = device, {}, time.perf_counter()

    def lap(self, name: str) -> None:
        _sync(self.device)
        now = time.perf_counter()
        self.walls[name] = now - self.t
        self.t = now


def _load(path: str, streaming: bool, dtype, int8: bool, allow_fallback_tokenizer,
          device: torch.device) -> "LoadedModel":
    """One checkpoint directory, HF-style or native, onto ``device``, with
    the walls of its phases: read (the shards mapped), transfer (their
    pages read and copied to the device), convert (layouts and the cast
    there), quantize; a native directory's are read alone."""
    from ..processor.processor import VibeVoiceProcessor
    from ..processor.streaming_processor import VibeVoiceStreamingProcessor

    cfg_cls, proc_cls, convert = (
        (VibeVoiceStreamingConfig, VibeVoiceStreamingProcessor, convert_streaming_model)
        if streaming else (VibeVoiceConfig, VibeVoiceProcessor, convert_full_model))
    cfg = cfg_cls.from_json_file(os.path.join(path, "config.json"))
    processor = proc_cls.from_pretrained(path, allow_fallback_tokenizer=allow_fallback_tokenizer)
    walls = _Walls(device)
    if os.path.exists(os.path.join(path, "params.pkl")):
        params = _to_dtype(load_native(path, streaming, device=device)[1], _dtype(dtype))
        walls.lap("read")
    else:
        sd = load_state_dict(path)
        walls.lap("read")
        sd = {k: v.to(device) for k, v in sd.items()}
        walls.lap("transfer")
        params = convert(sd, cfg, dtype=dtype, device=device)
        del sd
        walls.lap("convert")
    if int8:
        from ..models.vibevoice import quantize_for_inference

        params = quantize_for_inference(params)
        walls.lap("quantize")
    return LoadedModel(cfg, params, processor,
                       "vibevoice_streaming" if streaming else "vibevoice", walls.walls)


def load_checkpoint(path: str, dtype="bfloat16", int8: bool = False,
                    allow_fallback_tokenizer: Optional[bool] = None, *, device="cuda"):
    """(config, params, processor) of a multi-speaker checkpoint directory,
    the params on ``device``. int8=True quantizes the LM and the logits
    projection there (models/vibevoice.quantize_for_inference).
    ``allow_fallback_tokenizer=None`` leaves the choice to
    VIBEVOICE_ALLOW_FALLBACK_TOKENIZER."""
    return tuple(_load(path, False, dtype, int8, allow_fallback_tokenizer, _device(device)))


def load_streaming_checkpoint(path: str, dtype="bfloat16",
                              allow_fallback_tokenizer: Optional[bool] = None, *, device="cuda"):
    """(config, params, processor) of a streaming checkpoint directory."""
    return tuple(_load(path, True, dtype, False, allow_fallback_tokenizer, _device(device)))


# ---------------------------------------------------------------------------
# Native checkpoints: the JAX package's format, a pickle of the numpy tree in
# the JAX package's layout (convolutions TIO, transposed ones pre-flipped)
# plus config.json with model_type
# ---------------------------------------------------------------------------


def _jax_conv(w: torch.Tensor) -> torch.Tensor:  # (out, in/g, k) -> TIO
    return w.permute(2, 1, 0)


def _jax_conv_transpose(w: torch.Tensor) -> torch.Tensor:  # (in, out, k) -> pre-flipped TIO
    return w.permute(2, 0, 1).flip(0)


def _jax_tokenizer_part(p: Dict) -> Dict:
    """The inverse of params._tokenizer_part."""
    out = dict(p)
    for key in ("down", "up"):
        if key in p:
            out[key] = [{**c, "w": (_jax_conv_transpose if key == "up" and i > 0
                                    else _jax_conv)(c["w"])} for i, c in enumerate(p[key])]
    out["stages"] = [[{**blk, "mixer": {**blk["mixer"], "w": _jax_conv(blk["mixer"]["w"])}}
                      for blk in stage] for stage in p["stages"]]
    out["head"] = {**p["head"], "w": _jax_conv(p["head"]["w"])}
    return out


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    try:
        import ml_dtypes
    except ImportError as e:
        raise ImportError("save_native: a bf16 tree is pickled as ml_dtypes.bfloat16 arrays (the "
                          "JAX package's format), and ml_dtypes is not installed; save a "
                          "float32 tree instead") from e
    return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)


def save_native(path: str, cfg, params: Dict) -> None:
    """Write the dense tree in the JAX package's native format, which its
    ``load_native`` reads (config.json with model_type, params.pkl)."""
    os.makedirs(path, exist_ok=True)
    blob = dataclasses.asdict(cfg)
    blob["model_type"] = ("vibevoice_streaming" if isinstance(cfg, VibeVoiceStreamingConfig)
                          else "vibevoice")
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(blob, f, indent=2, default=str)
    tree = dict(params)
    for name in ("acoustic_tokenizer", "semantic_tokenizer"):
        if name in tree:
            tree[name] = {part: _jax_tokenizer_part(sub) for part, sub in tree[name].items()}
    with open(os.path.join(path, "params.pkl"), "wb") as f:
        pickle.dump(_map(tree, _numpy), f)


def load_native(path: str, streaming: Optional[bool] = None, *, device="cuda"):
    """(config, params on ``device``) of a native checkpoint, written by
    either package's ``save_native``."""
    device = _device(device)
    if streaming is None:
        streaming = read_model_type(path) == "vibevoice_streaming"
    cls = VibeVoiceStreamingConfig if streaming else VibeVoiceConfig
    cfg = cls.from_json_file(os.path.join(path, "config.json"))
    try:
        with open(os.path.join(path, "params.pkl"), "rb") as f:
            params = pickle.load(f)
    except ModuleNotFoundError as e:
        if e.name != "ml_dtypes":
            raise
        raise ImportError(f"{path}/params.pkl holds ml_dtypes arrays (a bf16 tree) and "
                          "ml_dtypes is not installed") from e
    return cfg, from_jax(params, cfg, device=device)


# ---------------------------------------------------------------------------
# One entry point, routed by config.json's model_type
# ---------------------------------------------------------------------------


class LoadedModel(NamedTuple):
    config: object
    params: Dict
    processor: object
    model_type: str  # "vibevoice" | "vibevoice_streaming"
    walls: Dict  # wall seconds of the load's phases: read, transfer, convert, quantize

    # unpacks like load_checkpoint's 3-tuple
    def __iter__(self):
        return iter((self.config, self.params, self.processor))


def read_model_type(path: str) -> str:
    """model_type from config.json, with a structural fallback for configs
    written before the field existed (streaming configs carry
    tts_backbone_num_hidden_layers; full configs carry a semantic tokenizer)."""
    with open(os.path.join(path, "config.json")) as f:
        d = json.load(f)
    mt = d.get("model_type")
    if mt in ("vibevoice", "vibevoice_streaming"):
        return mt
    if mt is not None and str(mt).startswith("vibevoice_streaming"):
        return "vibevoice_streaming"
    if "tts_backbone_num_hidden_layers" in d:
        return "vibevoice_streaming"
    return "vibevoice"


def load_pretrained(path: str, dtype="bfloat16", int8: bool = False,
                    allow_fallback_tokenizer: Optional[bool] = None, *,
                    device="cuda") -> LoadedModel:
    """Load any checkpoint directory (multi-speaker or streaming, HF-style
    or native) onto ``device``, routed by config.json's model_type.
    ``cfg, params, proc = load_pretrained(p)`` unpacks like the 3-tuple
    loaders; ``.model_type`` routes engines, ``.walls`` times the load."""
    device = _device(device)
    streaming = read_model_type(path) == "vibevoice_streaming"
    if streaming and int8:
        raise NotImplementedError(
            "int8 loading is wired for the multi-speaker model; the streaming 0.5B fits in bf16 "
            "(models.streaming.fuse_vocoder packs its vocoder for kernel D)")
    return _load(path, streaming, dtype, int8, allow_fallback_tokenizer, device)
