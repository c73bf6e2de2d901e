"""WhisperVQ tokenizer configuration, the port's own copy of the JAX
package's ``tokenizer/config.py``.

The reference ``WhisperVQConfig`` (speech_tokenizer/
configuration_whisper.py:4-37) as the GLM-4-Voice tokenizer sets them:
fully causal attention and causal convs, average pooling by 4 and the VQ
after layer 16, a codebook of 16384; the ASR head's post-VQ encoder layers
and Whisper decoder (``tokenizer/asr_decoder.py``; quantize_encoder_only
checkpoints ship without it, config.json:55).  Only the fields the port
reads are here: the EMA codebook's training knobs come with the trainer.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class WhisperVQConfig:
    num_mel_bins: int = 128
    d_model: int = 1280
    attention_heads: int = 20
    ffn_dim: int = 5120
    encoder_layers: int = 32             # the whole Whisper encoder's depth
    quantize_position: int = 16          # the VQ after this many layers
    pooling_kernel_size: int = 4
    quantize_vocab_size: int = 16384
    max_source_positions: int = 1500     # post-conv positions (30 s)
    causal_attention: bool = True
    quantize_causal_block_size: int = 200  # used when causal_attention=False
    # the ASR supervision head
    decoder_layers: int = 4
    decoder_attention_heads: int = 20
    decoder_ffn_dim: int = 5120
    vocab_size: int = 51866
    max_target_positions: int = 448

    # the feature extractor's constants
    sampling_rate: int = 16000
    n_fft: int = 400
    hop_length: int = 160

    @property
    def head_dim(self) -> int:
        return self.d_model // self.attention_heads

    @property
    def samples_per_token(self) -> int:
        # conv2 stride 2 * pool 4 * hop 160 = 1280 samples = 80 ms
        return 2 * self.pooling_kernel_size * self.hop_length


def glm4_voice_tokenizer_config() -> WhisperVQConfig:
    return WhisperVQConfig()


def tiny_tokenizer_config() -> WhisperVQConfig:
    return WhisperVQConfig(
        num_mel_bins=8, d_model=16, attention_heads=2, ffn_dim=24,
        encoder_layers=3, quantize_position=2,
        quantize_vocab_size=32, max_source_positions=64,
        decoder_layers=2, decoder_attention_heads=2, decoder_ffn_dim=24,
        vocab_size=64, max_target_positions=32)
