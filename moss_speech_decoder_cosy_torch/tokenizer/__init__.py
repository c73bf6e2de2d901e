"""The WhisperVQ speech tokenizer: 16 kHz audio -> tokens at 12.5 Hz, and
its Whisper ASR head (``asr_decoder``)."""

from .config import (  # noqa: F401
    WhisperVQConfig, glm4_voice_tokenizer_config, tiny_tokenizer_config)
from .features import (  # noqa: F401
    StreamingFeatures, WhisperFeatureExtractor, mel_filter_bank)
from .model import TokenizerStreamState, WhisperVQEncoder  # noqa: F401
