"""The speech LM stack: the Qwen2 backbone, the CosyVoice2 speech LM and
the v1 TransformerLM (ROADMAP A10)."""

from .qwen2 import Qwen2Config, Qwen2Model, tiny_qwen2_config
from .speech_lm import (BistreamSession, Qwen2SpeechLM, SpeechLMConfig,
                        load_lm, tiny_speech_lm_config)
