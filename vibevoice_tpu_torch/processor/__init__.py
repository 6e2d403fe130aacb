"""Scripts and voice prompts to model inputs: the port's own copy of the
framework-free vibevoice_tpu/processor (audio, processor, text_tokenizer)."""

from .audio import AudioNormalizer, VibeVoiceTokenizerProcessor, load_audio, write_wav
from .processor import VibeVoiceProcessor, VibeVoiceProcessorOutput
from .text_tokenizer import FallbackTextTokenizer, VibeVoiceTextTokenizer

__all__ = [
    "AudioNormalizer",
    "VibeVoiceTokenizerProcessor",
    "VibeVoiceProcessor",
    "VibeVoiceProcessorOutput",
    "VibeVoiceTextTokenizer",
    "FallbackTextTokenizer",
    "load_audio",
    "write_wav",
]
