"""One-call user API (port of vibevoice_tpu/tts.py): the multi-speaker
model (``VibeVoiceTTS``) and the streaming 0.5B model (``StreamingTTS``).

    from vibevoice_tpu_torch.tts import StreamingTTS, VibeVoiceTTS

    tts = VibeVoiceTTS(cfg, params, processor)          # params on the GPU
    audio = tts.synthesize("Speaker 1: Hello!", voices=[wav])
    for chunk in tts.stream("Speaker 1: Hello!", voices=[wav]):
        play(chunk)                                     # 24 kHz float32 frames

    rt = StreamingTTS(cfg, params, processor, preset)   # a VoicePreset
    for chunk in rt.stream("Hello!"):
        play(chunk)

The processor is the port's ``vibevoice_tpu_torch.processor.VibeVoiceProcessor``.
Every call goes through ``inference.generate``, whose step function is
memoized on the options it reads: on the card, calls with one shape replay
the CUDA graph that the first of them captured. That graph holds one
request's state, so such calls decode one after another: two streams read
in turn are served whole, the first before the second.
``StreamingTTS`` goes through ``models.streaming.generate``, whose text and
speech windows are replayed CUDA graphs on the card, one stream at a time.
``from_pretrained(path)`` loads a checkpoint directory (utils/hf_interop),
``smoke()`` builds a tiny random-weight instance, ``random(config)`` a
full-width configuration with random weights.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Iterator, List, Optional, Sequence, Union

import numpy as np

from .streamer import AudioStreamer

from .models import inference as inf
from .models.inference import GenerateOptions, SpecialTokens

Audio = Union[str, np.ndarray]  # wav path or waveform array


def _tokens_from_processor(processor) -> SpecialTokens:
    tk = processor.tokenizer
    return SpecialTokens(speech_start=tk.speech_start_id, speech_end=tk.speech_end_id,
                         speech_diffusion=tk.speech_diffusion_id, eos=tk.eos_token_id)


def _threaded_stream(produce: Callable) -> Iterator[np.ndarray]:
    """Run ``produce(streamer, stopped)`` on a worker thread and yield the
    frames it puts into the streamer; its error is re-raised here, and
    closing the iterator makes ``stopped()`` true and joins the worker."""
    streamer = AudioStreamer(batch_size=1)
    stop = threading.Event()
    err: List[BaseException] = []

    def run():
        try:
            produce(streamer, stop.is_set)
        except BaseException as e:  # re-raised in the consumer below
            err.append(e)
        finally:
            streamer.end()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    try:
        yield from streamer.get_stream(0)
        if err:
            raise err[0]
    finally:
        stop.set()
        t.join()


class VibeVoiceTTS:
    """Multi-speaker model behind a one-call API."""

    load_walls: Optional[dict] = None  # from_pretrained: the load's phases, wall seconds

    def __init__(self, cfg, params, processor, tokens: Optional[SpecialTokens] = None):
        self.cfg = cfg
        self.params = params
        self.processor = processor
        self.tokens = tokens or _tokens_from_processor(processor)
        self.sample_rate = 24_000

    @classmethod
    def from_pretrained(cls, path: str, *, int8: bool = False, dtype: str = "bfloat16",
                        lora_path: Optional[str] = None, device="cuda") -> "VibeVoiceTTS":
        """Load a multi-speaker checkpoint directory (HF-style safetensors or
        native) onto ``device``, the card unless given device="cpu".
        int8=True quantizes the LM and lm_head there; ``lora_path`` merges a
        fine-tune's ``lora/`` assets first, and int8 quantizes after the
        merge. The serving packs of kernels C and D are the caller's:
        ``models.vibevoice.fuse_for_serving``."""
        from .utils.hf_interop import load_pretrained

        loaded = load_pretrained(path, dtype=dtype, int8=int8 and not lora_path, device=device)
        if loaded.model_type != "vibevoice":
            raise ValueError(f"{path} is a {loaded.model_type} checkpoint; use "
                             "StreamingTTS.from_pretrained for streaming models")
        cfg, params, processor = loaded
        if lora_path:
            from .finetune.lora import load_lora_assets
            from .models.vibevoice import quantize_for_inference

            params = load_lora_assets(params, lora_path)
            if int8:
                params = quantize_for_inference(params)
        tts = cls(cfg, params, processor)
        tts.load_walls = loaded.walls
        return tts

    @classmethod
    def smoke(cls, device="cuda") -> "VibeVoiceTTS":
        """Tiny random-weight instance (``configs.tiny_config``, the
        hash-bucket tokenizer and its special tokens) on ``device``, the
        card unless given device="cpu"."""
        from .configs import tiny_config
        from .processor.processor import VibeVoiceProcessor
        from .processor.text_tokenizer import FallbackTextTokenizer
        from .utils.params import init

        cfg = tiny_config()
        params = init(cfg, seed=0, device=device)
        processor = VibeVoiceProcessor(
            tokenizer=FallbackTextTokenizer(),
            speech_tok_compress_ratio=cfg.acoustic_tokenizer_config.hop_length)
        tokens = SpecialTokens(speech_start=5, speech_end=6, speech_diffusion=7, eos=2)
        return cls(cfg, params, processor, tokens)

    @classmethod
    def random(cls, config: str, *, seed: int = 0, device="cuda",
               int8_lm: bool = True) -> "VibeVoiceTTS":
        """A full-width configuration (a config JSON) with random bf16
        weights from ``seed``, set up for serving as the benchmarks serve
        it: int8 LM and lm_head (dense with ``int8_lm=False``, as
        tensor-parallel serving takes them), ``fuse_for_serving(quantize=True)``;
        the hash-bucket tokenizer with the Qwen special token ids."""
        import torch

        from .configs import VibeVoiceConfig
        from .models import vibevoice as vv
        from .processor.processor import VibeVoiceProcessor
        from .processor.text_tokenizer import QWEN_SPECIAL_IDS, FallbackTextTokenizer
        from .utils.params import init

        cfg = VibeVoiceConfig.from_json_file(config)
        params = init(cfg, seed=seed, dtype=torch.bfloat16, device=device)
        if int8_lm:
            params = vv.quantize_for_inference(params, ("lm", "lm_head"))
        params = vv.fuse_for_serving(params, cfg, quantize=True)
        tk = FallbackTextTokenizer(
            vocab_size=cfg.decoder_config.vocab_size,
            speech_start_id=QWEN_SPECIAL_IDS["speech_start"],
            speech_end_id=QWEN_SPECIAL_IDS["speech_end"],
            speech_diffusion_id=QWEN_SPECIAL_IDS["speech_diffusion"],
            eos_token_id=QWEN_SPECIAL_IDS["eos"], pad_id=QWEN_SPECIAL_IDS["pad"])
        processor = VibeVoiceProcessor(
            tokenizer=tk, speech_tok_compress_ratio=cfg.acoustic_tokenizer_config.hop_length)
        return cls(cfg, params, processor)

    def save_audio(self, audio: np.ndarray, path: str) -> None:
        self.processor.save_audio(audio, output_path=path)

    def _generate(self, script: str, voices: Optional[Sequence[Audio]],
                  opts: Optional[GenerateOptions], seed: int, audio_streamer=None,
                  stop_check_fn=None, **overrides):
        proc_out = self.processor(text=script, voice_samples=[list(voices)] if voices else None)
        if opts is None:
            opts = GenerateOptions(**overrides)
        elif overrides:
            opts = dataclasses.replace(opts, **overrides)
        return inf.generate(
            self.cfg, self.params,
            input_ids=proc_out.input_ids,
            valid_mask=proc_out.attention_mask,
            speech_tensors=proc_out.speech_tensors,
            speech_frame_valid=proc_out.speech_masks,
            speech_input_mask=proc_out.speech_input_mask,
            tokens=self.tokens, opts=opts, seed=seed,
            audio_streamer=audio_streamer, stop_check_fn=stop_check_fn,
        )

    def synthesize(self, script: str, *, voices: Optional[Sequence[Audio]] = None, seed: int = 0,
                   opts: Optional[GenerateOptions] = None, **overrides) -> np.ndarray:
        """Script -> 24 kHz float32 waveform; ``voices[k]`` is speaker k's
        prompt. Keyword overrides go to GenerateOptions."""
        out = self._generate(script, voices, opts, seed, **overrides)
        audio = out.speech_outputs[0]
        return np.zeros(0, np.float32) if audio is None else np.asarray(audio, np.float32)

    def stream(self, script: str, *, voices: Optional[Sequence[Audio]] = None, seed: int = 0,
               opts: Optional[GenerateOptions] = None, **overrides) -> Iterator[np.ndarray]:
        """Yields audio frames as they are produced (generation runs on a
        worker thread). Closing the iterator stops generation."""
        return _threaded_stream(lambda streamer, stopped: self._generate(
            script, voices, opts, seed, audio_streamer=streamer, stop_check_fn=stopped,
            **overrides))


class StreamingTTS:
    """The streaming 0.5B model (lowest time to first audio) behind the same
    one-call shape: batch 1, the voice fixed per instance by its preset
    (``models.streaming.VoicePreset``: ``build_voice_preset``, ``.npz`` or the
    reference's ``.pt`` through ``utils.preset_convert``). One stream at a
    time: concurrent calls wait for each other."""

    load_walls: Optional[dict] = None  # from_pretrained: the load's phases, wall seconds

    def __init__(self, cfg, params, processor, preset, *, max_len: int = 8192):
        from .models import streaming as st

        self.st = st
        self.cfg = cfg
        self.params = params
        self.processor = processor
        self.preset = preset
        self.max_len = max_len
        self.sample_rate = 24_000
        self._lock = threading.Lock()

    @classmethod
    def from_pretrained(cls, path: str, *, voice: Optional[str] = None, dtype: str = "bfloat16",
                        max_len: int = 8192, device="cuda") -> "StreamingTTS":
        """Load a streaming checkpoint directory onto ``device`` (the card
        unless given device="cpu"), with the voice preset ``voice``: .npz
        (VoicePreset.save) or the reference's .pt (utils/preset_convert).
        Kernel D's vocoder pack is the caller's: models.streaming.fuse_vocoder."""
        from .models import streaming as st
        from .utils.hf_interop import load_pretrained

        if voice is None:
            raise ValueError("StreamingTTS needs a voice preset (.npz or .pt)")
        loaded = load_pretrained(path, dtype=dtype, device=device)
        if loaded.model_type != "vibevoice_streaming":
            raise ValueError(f"{path} is a {loaded.model_type} checkpoint; use "
                             "VibeVoiceTTS.from_pretrained for multi-speaker models")
        cfg, params, processor = loaded
        if voice.endswith(".pt"):
            from .utils.preset_convert import convert_torch_preset

            preset = convert_torch_preset(voice)
        else:
            preset = st.VoicePreset.load(voice)
        tts = cls(cfg, params, processor, preset, max_len=max_len)
        tts.load_walls = loaded.walls
        return tts

    @classmethod
    def smoke(cls, max_len: int = 512, device="cuda") -> "StreamingTTS":
        """Tiny random-weight instance with a synthetic preset, on ``device``
        (the card unless given device="cpu")."""
        from .configs import (AcousticTokenizerConfig, DiffusionHeadConfig, Qwen2Config,
                              VibeVoiceStreamingConfig)
        from .models import streaming as st
        from .processor.streaming_processor import VibeVoiceStreamingProcessor
        from .processor.text_tokenizer import FallbackTextTokenizer
        from .utils.params import init_streaming

        cfg = VibeVoiceStreamingConfig(
            acoustic_tokenizer_config=AcousticTokenizerConfig(
                vae_dim=16, encoder_n_filters=4, encoder_ratios=(4, 2),
                encoder_depths=(1, 1, 2), decoder_n_filters=4,
            ),
            decoder_config=Qwen2Config(
                vocab_size=256, hidden_size=64, intermediate_size=128,
                num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
                max_position_embeddings=1024, rope_theta=10_000.0,
            ),
            diffusion_head_config=DiffusionHeadConfig(hidden_size=64, head_layers=2,
                                                      latent_size=16),
            tts_backbone_num_hidden_layers=2,
        )
        params = init_streaming(cfg, seed=0, device=device)
        processor = VibeVoiceStreamingProcessor(FallbackTextTokenizer(vocab_size=256))
        prompt = np.random.RandomState(0).randint(10, 200, (1, 16))
        preset = st.build_voice_preset(cfg, params, prompt,
                                       neg_prompt_id=getattr(processor.tokenizer, "pad_id", 3),
                                       max_len=max_len)
        return cls(cfg, params, processor, preset, max_len=max_len)

    @classmethod
    def random(cls, config: str, *, seed: int = 0, max_len: int = 8192, preset_tokens: int = 256,
               device="cuda") -> "StreamingTTS":
        """A full-width streaming configuration (a config JSON) with random
        bf16 weights from ``seed``, the vocoder's stage 0 packed int8 for
        kernel D, the hash-bucket tokenizer, and a voice preset prefilled
        from a random ``preset_tokens``-token prompt."""
        import torch

        from .configs import VibeVoiceStreamingConfig
        from .models import streaming as st
        from .processor.streaming_processor import VibeVoiceStreamingProcessor
        from .processor.text_tokenizer import QWEN_SPECIAL_IDS, FallbackTextTokenizer
        from .utils.params import init_streaming

        cfg = VibeVoiceStreamingConfig.from_json_file(config)
        params = st.fuse_vocoder(init_streaming(cfg, seed=seed, dtype=torch.bfloat16,
                                                device=device), cfg, quantize=True)
        vocab = cfg.decoder_config.vocab_size
        tk = FallbackTextTokenizer(vocab_size=vocab, eos_token_id=QWEN_SPECIAL_IDS["eos"],
                                   pad_id=QWEN_SPECIAL_IDS["pad"])
        prompt = np.random.RandomState(seed).randint(10, vocab, (1, preset_tokens))
        preset = st.build_voice_preset(cfg, params, prompt, neg_prompt_id=tk.pad_id,
                                       max_len=max_len)
        return cls(cfg, params, VibeVoiceStreamingProcessor(tk), preset, max_len=max_len)

    def _opts(self, opts: Optional[GenerateOptions], overrides) -> GenerateOptions:
        if opts is None:
            return GenerateOptions(**{"cfg_scale": 1.5, "ddpm_steps": 5, **overrides})
        return dataclasses.replace(opts, **overrides) if overrides else opts

    def stream(self, text: str, *, seed: int = 0, opts: Optional[GenerateOptions] = None,
               stop_check_fn=None, **overrides) -> Iterator[np.ndarray]:
        """Text -> audio frames as they are produced (generation runs on a
        worker thread). Closing the iterator stops generation, as does
        ``stop_check_fn()`` returning True."""
        opts = self._opts(opts, overrides)

        def produce(streamer, stopped):
            with self._lock:
                proc_out = self.processor.process_input_with_cached_prompt(text, self.preset)
                self.st.generate(
                    self.cfg, self.params, tts_text_ids=proc_out.tts_text_ids, preset=self.preset,
                    opts=opts, max_len=self.max_len, seed=seed, audio_streamer=streamer,
                    stop_check_fn=lambda: stopped() or (stop_check_fn is not None
                                                        and stop_check_fn()))

        return _threaded_stream(produce)

    def warmup(self, max_frames: int = 12, **overrides) -> float:
        """Capture the windows (text window, speech window, vocoder) before
        the first real stream, so that its time to first audio is steady
        state: one short stream whose audio is dropped. Returns wall
        seconds."""
        t0 = time.monotonic()
        for i, _ in enumerate(self.stream("Warming up the serving path.", **overrides)):
            if i >= max_frames:  # closing the generator stops generation
                break
        return time.monotonic() - t0

    def synthesize(self, text: str, **kw) -> np.ndarray:
        chunks = list(self.stream(text, **kw))
        return (np.concatenate([np.asarray(c).reshape(-1) for c in chunks]) if chunks
                else np.zeros(0, np.float32))
