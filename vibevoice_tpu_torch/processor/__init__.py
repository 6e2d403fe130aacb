"""Scripts and voice prompts to model inputs: the port's own copy of the
framework-free vibevoice_tpu/processor (audio, processor,
streaming_processor, text_tokenizer)."""

from .audio import AudioNormalizer, VibeVoiceTokenizerProcessor, load_audio, write_wav
from .processor import VibeVoiceProcessor, VibeVoiceProcessorOutput
from .streaming_processor import StreamingProcessorOutput, VibeVoiceStreamingProcessor
from .text_tokenizer import FallbackTextTokenizer, VibeVoiceTextTokenizer

__all__ = [
    "AudioNormalizer",
    "VibeVoiceTokenizerProcessor",
    "VibeVoiceProcessor",
    "VibeVoiceProcessorOutput",
    "VibeVoiceStreamingProcessor",
    "StreamingProcessorOutput",
    "VibeVoiceTextTokenizer",
    "FallbackTextTokenizer",
    "load_audio",
    "write_wav",
]
