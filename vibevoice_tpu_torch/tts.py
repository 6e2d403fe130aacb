"""One-call user API of the multi-speaker model (port of vibevoice_tpu/tts.py).

    from vibevoice_tpu_torch.tts import VibeVoiceTTS

    tts = VibeVoiceTTS(cfg, params, processor)          # params on the GPU
    audio = tts.synthesize("Speaker 1: Hello!", voices=[wav])
    for chunk in tts.stream("Speaker 1: Hello!", voices=[wav]):
        play(chunk)                                     # 24 kHz float32 frames

The processor is the port's ``vibevoice_tpu_torch.processor.VibeVoiceProcessor``.
Every call goes through ``inference.generate``, whose step function is
memoized on the options it reads: on the card, calls with one shape replay
the CUDA graph that the first of them captured. That graph holds one
request's state, so such calls decode one after another: two streams read
in turn are served whole, the first before the second.
Loading a checkpoint (``from_pretrained``) waits for the checkpoint loader's port.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Iterator, List, Optional, Sequence, Union

import numpy as np

from .streamer import AudioStreamer

from .models import inference as inf
from .models.inference import GenerateOptions, SpecialTokens

Audio = Union[str, np.ndarray]  # wav path or waveform array


def _tokens_from_processor(processor) -> SpecialTokens:
    tk = processor.tokenizer
    return SpecialTokens(speech_start=tk.speech_start_id, speech_end=tk.speech_end_id,
                         speech_diffusion=tk.speech_diffusion_id, eos=tk.eos_token_id)


class VibeVoiceTTS:
    """Multi-speaker model behind a one-call API."""

    def __init__(self, cfg, params, processor, tokens: Optional[SpecialTokens] = None):
        self.cfg = cfg
        self.params = params
        self.processor = processor
        self.tokens = tokens or _tokens_from_processor(processor)
        self.sample_rate = 24_000

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
        streamer = AudioStreamer(batch_size=1)
        stop = threading.Event()
        err: List[BaseException] = []

        def run():
            try:
                self._generate(script, voices, opts, seed, audio_streamer=streamer,
                               stop_check_fn=stop.is_set, **overrides)
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
