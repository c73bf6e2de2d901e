"""Declarative model configs (the port's own copy of the JAX package's
``utils/config.py`` dataclasses and of the presets the port runs; the
dataclasses are kept field-for-field identical so a config built for one
package describes the same model in the other).

The reference instantiates live objects from hyperpyyaml checkpoint configs
(flow_inference.py:53-64); here every model is described by a frozen
dataclass so configs are hashable, serializable, and diffable.  Presets:

- ``moss_flow_config`` / ``moss_hift_config``: the MOSS-Speech 24 kHz decoder
  (12.5 Hz tokens, vocab 16384, token→mel ratio 4 via upsample_stride 4;
  SURVEY.md §0 and gradio_voice_converter_unstreaming_streaming.py:324).
- ``cosyvoice2_flow_config``: CosyVoice2-0.5B's flow (25 Hz tokens, vocab
  6561, ratio 2); its vocoder is ``HiFTConfig()`` as MOSS's.
- ``cosyvoice1_flow_config`` / ``cosyvoice1_hift_config``: CosyVoice-300M
  and the stock GLM-4-Voice decoder at 22.05 kHz (50 Hz tokens, 256-sample
  mel hop, the two-level non-causal U-Net).
- ``tiny_*``: small shapes for unit tests.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """UpsampleConformerEncoder (upsample_encoder.py:105-321)."""
    input_size: int = 512
    output_size: int = 512
    attention_heads: int = 8
    linear_units: int = 2048
    num_blocks: int = 6
    num_up_blocks: int = 4
    static_chunk_size: int = 25          # tokens per streaming chunk
    upsample_stride: int = 2
    macaron_style: bool = False
    use_cnn_module: bool = False
    cnn_module_kernel: int = 15
    cnn_causal: bool = False
    # conv-module norm: 'layer_norm' or 'batch_norm' (wenet
    # transformer/convolution.py:24-145 supports both; checkpoints trained
    # with the wenet default use batch_norm running stats)
    cnn_module_norm: str = "layer_norm"
    key_bias: bool = True
    activation: str = "swish"
    pre_lookahead_len: int = 3
    dropout_rate: float = 0.1
    # 'rel_pos' (wenet length-T table, no rel-shift — the reference default,
    # upsample_encoder.py:118 + class_utils.py:64) or 'rel_pos_espnet'
    # (2T-1 table with rel-shift, used by cosyvoice1 checkpoints)
    pos_enc_layer_type: str = "rel_pos"


@dataclasses.dataclass(frozen=True)
class EstimatorConfig:
    """CausalConditionalDecoder U-Net (flow/decoder.py:294-494)."""
    in_channels: int = 320               # x(80) + mu(80) + spk(80) + cond(80)
    out_channels: int = 80
    channels: Tuple[int, ...] = (256,)
    attention_head_dim: int = 64
    n_blocks: int = 4
    num_mid_blocks: int = 12
    num_heads: int = 8
    act_fn: str = "gelu"
    static_chunk_size: int = 50          # mel frames per streaming chunk
    num_left_chunks: int = -1            # forward passes -1 (decoder.py:440)
    dropout: float = 0.0
    causal: bool = True                  # False -> v1 ConditionalDecoder
    use_flash_attention: bool = False    # pallas kernel for long offline T


@dataclasses.dataclass(frozen=True)
class CFMConfig:
    """ConditionalCFM params (flow/flow_matching.py:27-40)."""
    sigma_min: float = 1e-6
    t_scheduler: str = "cosine"
    training_cfg_rate: float = 0.2
    inference_cfg_rate: float = 0.7
    n_timesteps: int = 10
    max_noise_len: int = 15000           # rand_noise buffer (flow_matching.py:203)
    # ODE solver state dtype: "float32" keeps the Euler carry, the CFG
    # combine and the t/dt schedule in f32 while the estimator runs in the
    # compute dtype (bf16 serving).  10 Euler steps accumulate O(2^-8)
    # rounding per step in bf16; the f32 island costs only elementwise ops
    # on (B, T, 80).  "compute" follows the input dtype (pre-ablation
    # behavior, kept for the BENCH_NOTES dtype table).
    solver_dtype: str = "float32"
    # Estimator compute dtype override (None = follow the input/compute
    # dtype).  "float32" with a bf16 encoder is the hybrid serving recipe:
    # the round-2 ablation isolated the bf16 mel error to the estimator
    # (0.40% vs 2.9% rel MAE, BENCH_NOTES).  AudioDecoder sets this when
    # constructed with ``estimator_dtype=...`` and casts the estimator
    # param subtree to match.
    estimator_dtype: str = ""


@dataclasses.dataclass(frozen=True)
class FlowConfig:
    """CausalMaskedDiffWithXvec (flow/flow.py:151-283)."""
    vocab_size: int = 16384
    input_size: int = 512
    output_size: int = 80
    spk_embed_dim: int = 192
    input_frame_rate: float = 12.5
    token_mel_ratio: int = 4
    pre_lookahead_len: int = 3
    encoder: EncoderConfig = EncoderConfig()
    estimator: EstimatorConfig = EstimatorConfig()
    cfm: CFMConfig = CFMConfig()


@dataclasses.dataclass(frozen=True)
class HiFTConfig:
    """HiFTGenerator (hifigan/generator.py:392-470), 24 kHz MOSS variant."""
    in_channels: int = 80
    base_channels: int = 512
    nb_harmonics: int = 8
    sampling_rate: int = 24000
    nsf_alpha: float = 0.1
    nsf_sigma: float = 0.003
    nsf_voiced_threshold: float = 10.0
    upsample_rates: Tuple[int, ...] = (8, 5, 3)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 11, 7)
    istft_n_fft: int = 16
    istft_hop_len: int = 4
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = (
        (1, 3, 5), (1, 3, 5), (1, 3, 5))
    source_resblock_kernel_sizes: Tuple[int, ...] = (7, 7, 11)
    source_resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = (
        (1, 3, 5), (1, 3, 5), (1, 3, 5))
    lrelu_slope: float = 0.1
    audio_limit: float = 0.99
    f0_cond_channels: int = 512

    @property
    def total_upsample(self) -> int:
        u = self.istft_hop_len
        for r in self.upsample_rates:
            u *= r
        return u                          # samples per mel frame (480)


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Streaming session knobs (flow_inference.py:48-92,
    scripts/evaluate_moss_decoder.sh:14-16)."""
    block_size: int = 5                  # token hop per streaming step
    mel_cache_len: int = 8               # hift mel cache frames
    max_token_len: int = 40              # sliding window bound
    sample_rate: int = 24000
    token_overlap_len: float = 3.5

    @property
    def mel_overlap_len(self) -> int:
        return 7                         # flow_inference.py:78

    @property
    def source_cache_len(self) -> int:
        return self.mel_cache_len * 480  # flow_inference.py:84


def moss_flow_config() -> FlowConfig:
    return FlowConfig(
        vocab_size=16384, input_frame_rate=12.5, token_mel_ratio=4,
        encoder=EncoderConfig(upsample_stride=4, static_chunk_size=25),
        estimator=EstimatorConfig(static_chunk_size=50),
    )


def moss_hift_config() -> HiFTConfig:
    return HiFTConfig()


def cosyvoice2_flow_config() -> FlowConfig:
    """CosyVoice2-0.5B's flow: 25 Hz tokens, vocab 6561, token -> mel
    ratio 2 through upsample_stride 2 (the JAX package's preset)."""
    return FlowConfig(
        vocab_size=6561, input_frame_rate=25, token_mel_ratio=2,
        encoder=EncoderConfig(upsample_stride=2, static_chunk_size=25),
        estimator=EstimatorConfig(static_chunk_size=50),
    )


def cosyvoice1_flow_config() -> FlowConfig:
    """CosyVoice v1 / stock GLM-4-Voice 22.05 kHz flow (MaskedDiffWithXvec,
    flow.py:24-148): plain 512-d conformer text encoder (rel_pos_espnet),
    InterpolateRegulator, non-causal matcha U-Net (256, 256) estimator."""
    return FlowConfig(
        vocab_size=4096, input_size=512, output_size=80, spk_embed_dim=192,
        input_frame_rate=50, token_mel_ratio=2,  # ~50 Hz -> 86.13 Hz mels
        encoder=EncoderConfig(
            input_size=512, output_size=512, attention_heads=8,
            linear_units=2048, num_blocks=6, macaron_style=False,
            use_cnn_module=False, dropout_rate=0.0,
            pos_enc_layer_type="rel_pos_espnet"),
        estimator=EstimatorConfig(
            in_channels=320, out_channels=80, channels=(256, 256),
            attention_head_dim=64, n_blocks=4, num_mid_blocks=12,
            num_heads=8, act_fn="gelu", causal=False),
        cfm=CFMConfig(n_timesteps=10, max_noise_len=15000),
    )


def cosyvoice1_hift_config() -> HiFTConfig:
    """22.05 kHz HiFT of CosyVoice-300M's published ``cosyvoice.yaml``
    (FunAudioLLM/CosyVoice examples/libritts/cosyvoice/conf, ``hift:``):
    upsample rates (8, 8), kernels (16, 16), source resblocks (7, 11) and
    the 16-point iSTFT at hop 4, so 256 samples a mel frame, the v1 flow's
    22050 / 256 Hz mel rate; the 22.05 kHz source (``SourceModuleHnNSF``).
    The JAX package's preset keeps the 24 kHz rates (480 samples a frame)."""
    return HiFTConfig(
        sampling_rate=22050, upsample_rates=(8, 8),
        upsample_kernel_sizes=(16, 16),
        source_resblock_kernel_sizes=(7, 11),
        source_resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)))


def tiny_flow_config() -> FlowConfig:
    """Small config for tests: same topology, tiny widths."""
    return FlowConfig(
        vocab_size=64, input_size=32, output_size=16, spk_embed_dim=12,
        input_frame_rate=12.5, token_mel_ratio=4,
        encoder=EncoderConfig(
            input_size=32, output_size=32, attention_heads=2,
            linear_units=48, num_blocks=2, num_up_blocks=1,
            static_chunk_size=4, upsample_stride=4, dropout_rate=0.0),
        estimator=EstimatorConfig(
            in_channels=64, out_channels=16, channels=(24,),
            attention_head_dim=8, n_blocks=1, num_mid_blocks=1,
            num_heads=2, static_chunk_size=8),
        cfm=CFMConfig(n_timesteps=4, max_noise_len=512),
    )


def tiny_hift_config() -> HiFTConfig:
    return HiFTConfig(
        in_channels=16, base_channels=32, nb_harmonics=4,
        upsample_rates=(4, 3), upsample_kernel_sizes=(8, 5),
        resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 3), (1, 3)),
        source_resblock_kernel_sizes=(5, 5),
        source_resblock_dilation_sizes=((1, 3), (1, 3)),
        f0_cond_channels=24,
    )
