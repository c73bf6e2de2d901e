"""The reference's torch checkpoints in the port: ``flow.pt`` (v2, and the
CosyVoice-v1 ``MaskedDiffWithXvec``) and ``hift.pt`` (flow_inference.py:
53-64), the cosyvoice1 block conformer and DiT estimator, the HF WhisperVQ
tokenizer (speech_tokenizer/utils.py:18-38) with its ASR head (the post-VQ
layers and the Whisper decoder), CAM++ (``campplus.onnx``
initializers or a ``campplus.pt`` state dict) and the LMs (an HF Qwen2,
CosyVoice2's and CosyVoice v1's ``llm.pt``), after the JAX package's
``utils/checkpoint.py``; and the trainer's own checkpoints
(``save_checkpoint``, ``AsyncCheckpointManager``, ``shape_filtered_merge``;
torch files where the JAX package writes orbax directories).

The port's modules carry the JAX package's parameter names (``weights.py``),
so a reference tensor maps onto a port key straight, with no detour through
the flax layout: torch Linear, Conv1d, ConvTranspose1d and Conv2d weights
already have the port's layout, LayerNorm and GroupNorm keep ``weight`` and
``bias``, BatchNorm its running statistics.  Two reshapes remain:

- ``"g"``: a weight-norm gain (O, 1, 1) -> the port's 1-D ``g`` (its ``v``
  keeps the torch layout);
- ``"conv1"``: a kernel-1 Conv1d weight (O, I, 1) that the port holds as a
  Linear weight (O, I).

Each converter is a plan of ``(port_key, reference_key, reshape)`` rows,
built by ``_map_*`` functions that mirror the JAX package's one for one
(``conversion_plan``), so it leaves the same reference keys unused.  Every
tensor converts to float32, as ``weights.py`` does.
"""

from __future__ import annotations

import json
import os
import shutil
import struct
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from .config import EncoderConfig, FlowConfig, HiFTConfig

Row = Tuple[str, str, Optional[str]]
RESHAPES = {
    "g": lambda w: w.reshape(-1),
    "conv1": lambda w: w[:, :, 0],
}


class _Plan:
    """Collects the rows of one converter.  ``keys`` (the reference state
    dict's keys) resolves what depends on the checkpoint, as the JAX
    ``_Mapper`` does on its state dict: an optional tensor (``maybe``)
    joins only if present, and a weight-norm pair is found under torch's
    parametrization names or the legacy ``weight_g`` / ``weight_v``.  With
    ``keys=None`` every optional row joins and weight norm takes the
    parametrization names (the JAX package's record mode)."""

    def __init__(self, keys=None):
        self.keys = None if keys is None else set(keys)
        self.rows: List[Row] = []
        self.ignored: set = set()

    def put(self, dst: str, src: str, reshape: Optional[str] = None):
        self.rows.append((dst, src, reshape))

    def maybe(self, dst: str, src: str, reshape: Optional[str] = None):
        if self.keys is None or src in self.keys:
            self.put(dst, src, reshape)

    def ignore(self, src: str):
        """A torch-only bookkeeping key (BatchNorm ``num_batches_tracked``)
        consumed without a port tensor."""
        self.ignored.add(src)

    def linear(self, dst: str, src: str, bias: bool = True):
        self.put(f"{dst}.weight", f"{src}.weight")
        if bias:
            self.maybe(f"{dst}.bias", f"{src}.bias")

    def conv(self, dst: str, src: str, weight_norm: bool = False):
        if weight_norm:
            pairs = ((f"{src}.parametrizations.weight.original0",
                      f"{src}.parametrizations.weight.original1"),
                     (f"{src}.weight_g", f"{src}.weight_v"))
            if self.keys is None:
                gk, vk = pairs[0]
            else:
                for gk, vk in pairs:
                    if gk in self.keys:
                        break
                else:
                    raise KeyError(f"no weight_norm params for {src}")
            self.put(f"{dst}.g", gk, "g")
            self.put(f"{dst}.v", vk)
        else:
            self.put(f"{dst}.weight", f"{src}.weight")
        self.maybe(f"{dst}.bias", f"{src}.bias")

    def norm(self, dst: str, src: str):
        self.put(f"{dst}.weight", f"{src}.weight")
        self.put(f"{dst}.bias", f"{src}.bias")

    def batchnorm(self, dst: str, src: str):
        self.norm(dst, src)
        self.put(f"{dst}.running_mean", f"{src}.running_mean")
        self.put(f"{dst}.running_var", f"{src}.running_var")

    def conv2d(self, dst: str, src: str):
        self.put(f"{dst}.weight", f"{src}.weight")


# --------------------------------------------------------------- estimator
def _map_basic_tf_block(m: _Plan, dst: str, src: str):
    """Matcha BasicTransformerBlock (flow/decoder.py via matcha)."""
    m.norm(f"{dst}.norm1", f"{src}.norm1")
    m.norm(f"{dst}.norm3", f"{src}.norm3")
    m.linear(f"{dst}.attn1.to_q", f"{src}.attn1.to_q", bias=False)
    m.linear(f"{dst}.attn1.to_k", f"{src}.attn1.to_k", bias=False)
    m.linear(f"{dst}.attn1.to_v", f"{src}.attn1.to_v", bias=False)
    m.linear(f"{dst}.attn1.to_out", f"{src}.attn1.to_out.0")
    m.linear(f"{dst}.ff_proj", f"{src}.ff.net.0.proj")
    m.linear(f"{dst}.ff_out", f"{src}.ff.net.2")


def _map_resnet(m: _Plan, dst: str, src: str, causal: bool = True):
    """(Causal)ResnetBlock1D (flow/decoder.py:83-88 / matcha): a causal
    block wraps its conv (``conv.conv``) with the LayerNorm at
    ``block.2``; the non-causal matcha block is Conv1d + GroupNorm
    (``block.0`` / ``block.1``)."""
    conv, nidx = ("conv.conv", 2) if causal else ("conv", 1)
    m.conv(f"{dst}.block1.{conv}", f"{src}.block1.block.0")
    m.norm(f"{dst}.block1.norm", f"{src}.block1.block.{nidx}")
    m.conv(f"{dst}.block2.{conv}", f"{src}.block2.block.0")
    m.norm(f"{dst}.block2.norm", f"{src}.block2.block.{nidx}")
    m.linear(f"{dst}.mlp", f"{src}.mlp.1")
    m.conv(f"{dst}.res_conv", f"{src}.res_conv")


def _map_estimator(m: _Plan, dst: str, src: str, cfg: FlowConfig,
                   causal: bool = True):
    est = cfg.estimator
    m.linear(f"{dst}.time_mlp.linear_1", f"{src}.time_mlp.linear_1")
    m.linear(f"{dst}.time_mlp.linear_2", f"{src}.time_mlp.linear_2")
    # a level's last conv: CausalConv1d wraps a Conv1d, the non-causal
    # one is the Conv1d itself
    last = ".conv" if causal else ""
    n_ch = len(est.channels)
    for i in range(n_ch):
        _map_resnet(m, f"{dst}.down_res_{i}", f"{src}.down_blocks.{i}.0",
                    causal)
        for j in range(est.n_blocks):
            _map_basic_tf_block(m, f"{dst}.down_tf_{i}_{j}",
                                f"{src}.down_blocks.{i}.1.{j}")
        if i == n_ch - 1:
            m.conv(f"{dst}.down_conv_{i}{last}", f"{src}.down_blocks.{i}.2")
        else:
            m.conv(f"{dst}.down_conv_{i}.conv",
                   f"{src}.down_blocks.{i}.2.conv")
    for i in range(est.num_mid_blocks):
        _map_resnet(m, f"{dst}.mid_res_{i}", f"{src}.mid_blocks.{i}.0",
                    causal)
        for j in range(est.n_blocks):
            _map_basic_tf_block(m, f"{dst}.mid_tf_{i}_{j}",
                                f"{src}.mid_blocks.{i}.1.{j}")
    for i in range(n_ch):
        _map_resnet(m, f"{dst}.up_res_{i}", f"{src}.up_blocks.{i}.0",
                    causal)
        for j in range(est.n_blocks):
            _map_basic_tf_block(m, f"{dst}.up_tf_{i}_{j}",
                                f"{src}.up_blocks.{i}.1.{j}")
        if i == n_ch - 1:
            m.conv(f"{dst}.up_conv_{i}{last}", f"{src}.up_blocks.{i}.2")
        else:       # a ConvTranspose1d: torch's layout is the port's
            m.conv(f"{dst}.up_conv_{i}.conv", f"{src}.up_blocks.{i}.2.conv")
    nidx = 2 if causal else 1
    m.conv(f"{dst}.final_block.conv{last}", f"{src}.final_block.block.0")
    m.norm(f"{dst}.final_block.norm", f"{src}.final_block.block.{nidx}")
    m.conv(f"{dst}.final_proj", f"{src}.final_proj")


# ----------------------------------------------------------------- encoder
def _map_conformer_layer(m: _Plan, dst: str, src: str, enc: EncoderConfig):
    """wenet rel-pos conformer layer, with the macaron FF and the conv
    module where the config has them (batch norm: torch ``BatchNorm1d``'s
    eval statistics, convolution.py:84-90)."""
    m.norm(f"{dst}.norm_mha", f"{src}.norm_mha")
    m.norm(f"{dst}.norm_ff", f"{src}.norm_ff")
    a, d = f"{src}.self_attn", f"{dst}.self_attn"
    m.linear(f"{d}.linear_q", f"{a}.linear_q")
    m.linear(f"{d}.linear_k", f"{a}.linear_k", bias=enc.key_bias)
    m.linear(f"{d}.linear_v", f"{a}.linear_v")
    m.linear(f"{d}.linear_out", f"{a}.linear_out")
    m.linear(f"{d}.linear_pos", f"{a}.linear_pos", bias=False)
    m.put(f"{d}.pos_bias_u", f"{a}.pos_bias_u")
    m.put(f"{d}.pos_bias_v", f"{a}.pos_bias_v")
    m.linear(f"{dst}.feed_forward.w_1", f"{src}.feed_forward.w_1")
    m.linear(f"{dst}.feed_forward.w_2", f"{src}.feed_forward.w_2")
    if enc.macaron_style:
        m.norm(f"{dst}.norm_ff_macaron", f"{src}.norm_ff_macaron")
        m.linear(f"{dst}.ff_macaron.w_1", f"{src}.feed_forward_macaron.w_1")
        m.linear(f"{dst}.ff_macaron.w_2", f"{src}.feed_forward_macaron.w_2")
    if enc.use_cnn_module:
        m.norm(f"{dst}.norm_conv", f"{src}.norm_conv")
        m.norm(f"{dst}.norm_final", f"{src}.norm_final")
        cm, cd = f"{src}.conv_module", f"{dst}.conv_module"
        m.conv(f"{cd}.pointwise_conv1", f"{cm}.pointwise_conv1")
        m.conv(f"{cd}.depthwise_conv", f"{cm}.depthwise_conv")
        m.conv(f"{cd}.pointwise_conv2", f"{cm}.pointwise_conv2")
        if enc.cnn_module_norm == "batch_norm":
            m.norm(cd, f"{cm}.norm")
            m.put(f"{cd}.running_mean", f"{cm}.norm.running_mean")
            m.put(f"{cd}.running_var", f"{cm}.norm.running_var")
            m.ignore(f"{cm}.norm.num_batches_tracked")
        else:
            m.norm(f"{cd}.norm", f"{cm}.norm")


def _map_flow(m: _Plan, cfg: FlowConfig):
    """CausalMaskedDiffWithXvec (cosyvoice/flow/flow.py:151-186,
    transformer/upsample_encoder.py:105-246)."""
    m.put("input_embedding.weight", "input_embedding.weight")
    m.linear("spk_embed_affine_layer", "spk_embed_affine_layer")
    m.linear("encoder_proj", "encoder_proj")
    e = "encoder"
    m.linear(f"{e}.embed.linear", f"{e}.embed.out.0")
    m.norm(f"{e}.embed.norm", f"{e}.embed.out.1")
    m.conv(f"{e}.pre_lookahead_layer.conv1", f"{e}.pre_lookahead_layer.conv1")
    m.conv(f"{e}.pre_lookahead_layer.conv2", f"{e}.pre_lookahead_layer.conv2")
    for i in range(cfg.encoder.num_blocks):
        _map_conformer_layer(m, f"{e}.encoders_{i}", f"{e}.encoders.{i}",
                             cfg.encoder)
    m.conv(f"{e}.up_layer.conv", f"{e}.up_layer.conv")
    m.linear(f"{e}.up_embed.linear", f"{e}.up_embed.out.0")
    m.norm(f"{e}.up_embed.norm", f"{e}.up_embed.out.1")
    for i in range(cfg.encoder.num_up_blocks):
        _map_conformer_layer(m, f"{e}.up_encoders_{i}",
                             f"{e}.up_encoders.{i}", cfg.encoder)
    m.norm(f"{e}.after_norm", f"{e}.after_norm")
    _map_estimator(m, "decoder.estimator", "decoder.estimator", cfg)


def _map_hift(m: _Plan, cfg: HiFTConfig):
    """HiFTGenerator (hifigan/generator.py:392-470), ``generator.``
    stripped."""
    for i in range(5):
        m.conv(f"f0_predictor.cond{i}", f"f0_predictor.condnet.{2 * i}",
               weight_norm=True)
    m.linear("f0_predictor.classifier", "f0_predictor.classifier")
    m.linear("m_source.l_linear", "m_source.l_linear")
    m.conv("conv_pre", "conv_pre", weight_norm=True)
    m.conv("conv_post", "conv_post", weight_norm=True)
    for i in range(len(cfg.upsample_rates)):
        m.conv(f"ups_{i}", f"ups.{i}", weight_norm=True)
        m.conv(f"source_down_{i}", f"source_downs.{i}")
        ks = cfg.source_resblock_dilation_sizes[i]
        for j in range(len(ks)):
            for name, tname in (("conv1", "convs1"), ("conv2", "convs2")):
                m.conv(f"source_res_{i}.{name}_{j}",
                       f"source_resblocks.{i}.{tname}.{j}", weight_norm=True)
            for name, tname in (("act1", "activations1"),
                                ("act2", "activations2")):
                m.put(f"source_res_{i}.{name}_{j}.alpha",
                      f"source_resblocks.{i}.{tname}.{j}.alpha")
        for j in range(len(cfg.resblock_kernel_sizes)):
            r = i * len(cfg.resblock_kernel_sizes) + j
            for k in range(len(cfg.resblock_dilation_sizes[j])):
                m.conv(f"resblock_{i}_{j}.conv1_{k}",
                       f"resblocks.{r}.convs1.{k}", weight_norm=True)
                m.conv(f"resblock_{i}_{j}.conv2_{k}",
                       f"resblocks.{r}.convs2.{k}", weight_norm=True)
                m.put(f"resblock_{i}_{j}.act1_{k}.alpha",
                      f"resblocks.{r}.activations1.{k}.alpha")
                m.put(f"resblock_{i}_{j}.act2_{k}.alpha",
                      f"resblocks.{r}.activations2.{k}.alpha")


def _map_flow_v1(m: _Plan, cfg: FlowConfig, regulator_layers: int = 4):
    """v1 MaskedDiffWithXvec (flow.py:24-148): plain ConformerEncoder,
    InterpolateRegulator (length_regulator.py:21-43: conv, GroupNorm, Mish
    at ``model.3i``, ``3i+1``, ``3i+2``), non-causal matcha U-Net."""
    m.put("input_embedding.weight", "input_embedding.weight")
    m.linear("spk_embed_affine_layer", "spk_embed_affine_layer")
    m.linear("encoder_proj", "encoder_proj")
    e = "encoder"
    m.linear(f"{e}.embed.linear", f"{e}.embed.out.0")
    m.norm(f"{e}.embed.norm", f"{e}.embed.out.1")
    for i in range(cfg.encoder.num_blocks):
        _map_conformer_layer(m, f"{e}.encoders_{i}", f"{e}.encoders.{i}",
                             cfg.encoder)
    m.norm(f"{e}.after_norm", f"{e}.after_norm")
    lr = "length_regulator"
    for i in range(regulator_layers):
        m.conv(f"{lr}.conv_{i}", f"{lr}.model.{3 * i}")
        m.norm(f"{lr}.norm_{i}", f"{lr}.model.{3 * i + 1}")
    m.conv(f"{lr}.out_conv", f"{lr}.model.{3 * regulator_layers}")
    _map_estimator(m, "decoder.estimator", "decoder.estimator", cfg,
                   causal=False)


def _map_block_conformer(m: _Plan, enc: EncoderConfig):
    """cosyvoice1 BlockConformerEncoder (cosyvoice1/transformer/
    encoder.py:477), a standalone state dict -> ``flow_v1.ConformerEncoder``
    (its grid mask is a mask setting, not a parameter)."""
    m.linear("embed.linear", "embed.out.0")
    m.norm("embed.norm", "embed.out.1")
    for i in range(enc.num_blocks):
        _map_conformer_layer(m, f"encoders_{i}", f"encoders.{i}", enc)
    m.norm("after_norm", "after_norm")


def _map_dit(m: _Plan, cfg):
    """cosyvoice1 stable-audio DiffusionTransformer (cosyvoice1/flow/
    stable/dit.py:15-258, stable/transformer.py; continuous transformer,
    prepended global token) -> ``models/flow/dit.DiTEstimator``.  The 1x1
    pre / post convs become Linear weights; the scale-only LayerNorms drop
    their fixed beta."""
    m.put("timestep_features.weight", "timestep_features.weight")
    m.linear("ts_embed_1", "to_timestep_embed.0")
    m.linear("ts_embed_2", "to_timestep_embed.2")
    m.linear("global_embed_1", "to_global_embed.0", bias=False)
    m.linear("global_embed_2", "to_global_embed.2", bias=False)
    m.put("preprocess.weight", "preprocess_conv.weight", "conv1")
    m.put("postprocess.weight", "postprocess_conv.weight", "conv1")
    m.linear("project_in", "transformer.project_in", bias=False)
    m.linear("project_out", "transformer.project_out", bias=False)
    m.ignore("transformer.inv_freq")
    m.ignore("transformer.rotary_pos_emb.inv_freq")
    for i in range(cfg.depth):
        s, d = f"transformer.layers.{i}", f"block_{i}"
        m.put(f"{d}.pre_norm.weight", f"{s}.pre_norm.gamma")
        m.ignore(f"{s}.pre_norm.beta")
        m.linear(f"{d}.to_qkv", f"{s}.self_attn.to_qkv", bias=False)
        m.linear(f"{d}.attn_out", f"{s}.self_attn.to_out", bias=False)
        m.put(f"{d}.ff_norm.weight", f"{s}.ff_norm.gamma")
        m.ignore(f"{s}.ff_norm.beta")
        m.linear(f"{d}.ff_in", f"{s}.ff.ff.0.proj")
        m.linear(f"{d}.ff_out", f"{s}.ff.ff.2")


def _map_whisper_attn(m: _Plan, dst: str, src: str):
    m.linear(f"{dst}.q_proj", f"{src}.q_proj")
    m.linear(f"{dst}.k_proj", f"{src}.k_proj", bias=False)
    m.linear(f"{dst}.v_proj", f"{src}.v_proj")
    m.linear(f"{dst}.out_proj", f"{src}.out_proj")


def _map_whisper_enc_layer(m: _Plan, dst: str, src: str):
    m.norm(f"{dst}.self_attn_layer_norm", f"{src}.self_attn_layer_norm")
    m.norm(f"{dst}.final_layer_norm", f"{src}.final_layer_norm")
    _map_whisper_attn(m, f"{dst}.self_attn", f"{src}.self_attn")
    m.linear(f"{dst}.fc1", f"{src}.fc1")
    m.linear(f"{dst}.fc2", f"{src}.fc2")


def _map_tokenizer(m: _Plan, cfg):
    """HF WhisperVQEncoder, the pre-VQ stack (``generator.encoder.`` or
    ``encoder.`` stripped)."""
    m.conv("conv1", "conv1")
    m.conv("conv2", "conv2")
    m.put("embed_positions", "embed_positions.weight")
    m.put("codebook", "codebook.weight")
    for i in range(cfg.quantize_position):
        _map_whisper_enc_layer(m, f"layers_{i}", f"layers.{i}")


def _map_post_vq(m: _Plan, cfg):
    """The same encoder's layers after ``quantize_position`` and its second
    position table (modeling_whisper.py:1265-1269,1466-1486) -> the port's
    ``PostVQEncoder``; the pre-VQ keys stay unused."""
    m.put("embed_positions2", "embed_positions2.weight")
    for i in range(cfg.encoder_layers - cfg.quantize_position):
        _map_whisper_enc_layer(m, f"layers_{i}",
                               f"layers.{cfg.quantize_position + i}")
    m.norm("layer_norm", "layer_norm")


def _map_whisper_decoder(m: _Plan, cfg):
    """WhisperVQDecoder (modeling_whisper.py:1614-1974) -> the port's
    ``WhisperVQDecoder`` (tied output projection)."""
    m.put("embed_tokens.weight", "embed_tokens.weight")
    m.put("embed_positions", "embed_positions.weight")
    for i in range(cfg.decoder_layers):
        s, d = f"layers.{i}", f"layers_{i}"
        m.norm(f"{d}.self_attn_layer_norm", f"{s}.self_attn_layer_norm")
        m.norm(f"{d}.encoder_attn_layer_norm",
               f"{s}.encoder_attn_layer_norm")
        m.norm(f"{d}.final_layer_norm", f"{s}.final_layer_norm")
        for att in ("self_attn", "encoder_attn"):
            _map_whisper_attn(m, f"{d}.{att}", f"{s}.{att}")
        m.linear(f"{d}.fc1", f"{s}.fc1")
        m.linear(f"{d}.fc2", f"{s}.fc2")
    m.norm("layer_norm", "layer_norm")


def _map_campplus(m: _Plan, block_layers=(12, 24, 16)):
    """modelscope speakerlab CAMPPlus names (the torch model the reference's
    campplus.onnx was exported from, GLM_modules/flow_inference.py:86-89).
    ONNX exports keep the state dict's names for initializers, so the same
    plan serves ``campplus.pt`` and ``utils.onnx_io``'s output."""
    m.conv2d("head.conv1", "head.conv1")
    m.batchnorm("head.bn1", "head.bn1")
    for i in range(2):
        for j, tag in enumerate("ab"):
            s = f"head.layer{i + 1}.{j}"
            d = f"head.block{i}{tag}"
            m.conv2d(f"{d}.conv1", f"{s}.conv1")
            m.batchnorm(f"{d}.bn1", f"{s}.bn1")
            m.conv2d(f"{d}.conv2", f"{s}.conv2")
            m.batchnorm(f"{d}.bn2", f"{s}.bn2")
            if j == 0:                       # the strided block's shortcut
                m.conv2d(f"{d}.shortcut_conv", f"{s}.shortcut.0")
                m.batchnorm(f"{d}.shortcut_bn", f"{s}.shortcut.1")
    m.conv2d("head.conv2", "head.conv2")
    m.batchnorm("head.bn2", "head.bn2")

    m.put("tdnn_conv.weight", "xvector.tdnn.linear.weight")
    m.batchnorm("tdnn_bn", "xvector.tdnn.nonlinear.batchnorm")
    for bi, n_layers in enumerate(block_layers):
        for li in range(n_layers):
            s = f"xvector.block{bi + 1}.tdnnd{li + 1}"
            d = f"block{bi}_layer{li}"
            m.batchnorm(f"{d}.bn1", f"{s}.nonlinear1.batchnorm")
            m.put(f"{d}.linear1.weight", f"{s}.linear1.weight")
            m.batchnorm(f"{d}.bn2", f"{s}.nonlinear2.batchnorm")
            cam, cd = f"{s}.cam_layer", f"{d}.cam_layer"
            m.put(f"{cd}.linear_local.weight", f"{cam}.linear_local.weight")
            m.put(f"{cd}.linear1.weight", f"{cam}.linear1.weight")
            m.maybe(f"{cd}.linear1.bias", f"{cam}.linear1.bias")
            m.put(f"{cd}.linear2.weight", f"{cam}.linear2.weight")
            m.maybe(f"{cd}.linear2.bias", f"{cam}.linear2.bias")
        m.batchnorm(f"transit{bi}_bn",
                    f"xvector.transit{bi + 1}.nonlinear.batchnorm")
        m.put(f"transit{bi}_conv.weight",
              f"xvector.transit{bi + 1}.linear.weight")
    m.batchnorm("out_bn", "xvector.out_nonlinear.batchnorm")
    m.put("dense.weight", "xvector.dense.linear.weight", "conv1")
    m.maybe("dense.bias", "xvector.dense.linear.bias")
    m.batchnorm("dense_bn", "xvector.dense.nonlinear.batchnorm")


# ---------------------------------------------------------------- speech LM
def _map_qwen2_layers(m: _Plan, dst: str, src: str, cfg):
    """HF Qwen2 decoder layers, embeddings and final norm (``src`` the
    prefix of ``model.``) -> ``models/llm/qwen2.Qwen2Model``."""
    m.put(f"{dst}embed_tokens.weight", f"{src}model.embed_tokens.weight")
    for i in range(cfg.num_layers):
        s, d = f"{src}model.layers.{i}", f"{dst}layers_{i}"
        m.put(f"{d}.input_layernorm.weight", f"{s}.input_layernorm.weight")
        m.put(f"{d}.post_attention_layernorm.weight",
              f"{s}.post_attention_layernorm.weight")
        m.linear(f"{d}.q_proj", f"{s}.self_attn.q_proj")
        m.linear(f"{d}.k_proj", f"{s}.self_attn.k_proj")
        m.linear(f"{d}.v_proj", f"{s}.self_attn.v_proj")
        m.linear(f"{d}.o_proj", f"{s}.self_attn.o_proj", bias=False)
        m.linear(f"{d}.gate_proj", f"{s}.mlp.gate_proj", bias=False)
        m.linear(f"{d}.up_proj", f"{s}.mlp.up_proj", bias=False)
        m.linear(f"{d}.down_proj", f"{s}.mlp.down_proj", bias=False)
    m.put(f"{dst}norm.weight", f"{src}model.norm.weight")


def _map_qwen2(m: _Plan, cfg):
    """HF Qwen2ForCausalLM (``model.*``; its lm_head stays unused, the
    speech LM has its own head)."""
    _map_qwen2_layers(m, "", "", cfg)


def _map_speech_lm(m: _Plan, cfg):
    """CosyVoice2 ``llm.pt``: the speech heads (llm.py:286-295) and the
    Qwen2 backbone under ``llm.model.`` (llm.py:231-260)."""
    m.put("llm_embedding.weight", "llm_embedding.weight")
    m.put("speech_embedding.weight", "speech_embedding.weight")
    m.linear("llm_decoder", "llm_decoder")
    _map_qwen2_layers(m, "llm.", "llm.model.", cfg.backbone)


def _map_transformer_layer(m: _Plan, dst: str, src: str):
    """wenet TransformerEncoderLayer with rel-pos attention (norm1 ->
    norm_mha, norm2 -> norm_ff)."""
    m.norm(f"{dst}.norm_mha", f"{src}.norm1")
    m.norm(f"{dst}.norm_ff", f"{src}.norm2")
    a, d = f"{src}.self_attn", f"{dst}.self_attn"
    m.linear(f"{d}.linear_q", f"{a}.linear_q")
    m.linear(f"{d}.linear_k", f"{a}.linear_k")
    m.linear(f"{d}.linear_v", f"{a}.linear_v")
    m.linear(f"{d}.linear_out", f"{a}.linear_out")
    m.linear(f"{d}.linear_pos", f"{a}.linear_pos", bias=False)
    m.put(f"{d}.pos_bias_u", f"{a}.pos_bias_u")
    m.put(f"{d}.pos_bias_v", f"{a}.pos_bias_v")
    m.linear(f"{dst}.feed_forward.w_1", f"{src}.feed_forward.w_1")
    m.linear(f"{dst}.feed_forward.w_2", f"{src}.feed_forward.w_2")


def _map_transformer_lm(m: _Plan, cfg):
    """CosyVoice v1 ``llm.pt`` (llm.py:32-229): text embedding, conformer
    text encoder, affines, the TransformerEncoder decoder stack, heads."""
    m.put("text_embedding.weight", "text_embedding.weight")
    te = "text_encoder"
    m.linear("text_embed_in.linear", f"{te}.embed.out.0")
    m.norm("text_embed_in.norm", f"{te}.embed.out.1")
    for i in range(cfg.text_encoder.num_blocks):
        _map_conformer_layer(m, f"text_enc_{i}", f"{te}.encoders.{i}",
                             cfg.text_encoder)
    m.norm("text_after_norm", f"{te}.after_norm")
    m.linear("text_encoder_affine_layer", "text_encoder_affine_layer")
    m.linear("spk_embed_affine_layer", "spk_embed_affine_layer")
    m.put("llm_embedding.weight", "llm_embedding.weight")
    m.put("speech_embedding.weight", "speech_embedding.weight")
    m.linear("llm_decoder", "llm_decoder")
    m.linear("llm.embed.linear", "llm.embed.out.0")
    m.norm("llm.embed.norm", "llm.embed.out.1")
    for i in range(cfg.llm_blocks):
        _map_transformer_layer(m, f"llm.layers_{i}", f"llm.encoders.{i}")
    m.norm("llm.after_norm", "llm.after_norm")


_MAPS = {"flow": _map_flow, "hift": _map_hift, "tokenizer": _map_tokenizer,
         "campplus": _map_campplus, "qwen2": _map_qwen2,
         "speech_lm": _map_speech_lm, "transformer_lm": _map_transformer_lm,
         "flow_v1": _map_flow_v1, "block_conformer": _map_block_conformer,
         "dit": _map_dit, "post_vq": _map_post_vq,
         "whisper_decoder": _map_whisper_decoder}


def _plan(kind: str, cfg, keys=None) -> _Plan:
    if kind not in _MAPS:
        raise ValueError(f"unknown converter {kind!r}; one of "
                         f"{sorted(_MAPS)}")
    m = _Plan(keys)
    if kind == "campplus":
        _map_campplus(m, cfg if cfg is not None else (12, 24, 16))
    else:
        _MAPS[kind](m, cfg)
    return m


def conversion_plan(kind: str, cfg) -> List[Row]:
    """The ``(port_key, reference_key, reshape)`` rows of a converter
    (``kind`` one of flow, hift, tokenizer, campplus, qwen2, speech_lm,
    transformer_lm, flow_v1, block_conformer, dit, post_vq,
    whisper_decoder; ``cfg`` the model's
    config, for CAM++ its ``block_layers``, for the block conformer its
    ``EncoderConfig``, for the DiT its ``DiTConfig``), every optional row
    included
    and weight norm under torch's parametrization names.  ``reshape`` is
    None or a key of ``RESHAPES``."""
    return _plan(kind, cfg).rows


def _convert(kind: str, sd: Mapping, cfg
             ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    m = _plan(kind, cfg, sd.keys())
    out: Dict[str, torch.Tensor] = {}
    used = m.ignored & set(sd)
    for dst, src, reshape in m.rows:
        if src not in sd:
            raise KeyError(f"missing reference key: {src}")
        w = np.asarray(sd[src])
        if reshape is not None:
            w = RESHAPES[reshape](w)
        out[dst] = torch.from_numpy(np.array(w, dtype=np.float32))
        used.add(src)
    return out, sorted(set(sd) - used)


def convert_flow_state_dict(sd: Mapping, cfg: FlowConfig):
    """``flow.pt`` state dict -> (state dict of the port's
    ``CausalMaskedDiffWithXvec(cfg)``, unused reference keys)."""
    return _convert("flow", sd, cfg)


def convert_flow_v1_state_dict(sd: Mapping, cfg: FlowConfig):
    """v1 ``flow.pt`` (MaskedDiffWithXvec) -> (state dict of the port's
    ``flow_v1.MaskedDiffWithXvec(cfg)``, unused reference keys)."""
    return _convert("flow_v1", sd, cfg)


def convert_block_conformer_state_dict(sd: Mapping, enc_cfg: EncoderConfig):
    """cosyvoice1 BlockConformerEncoder state dict -> (state dict of the
    port's ``flow_v1.ConformerEncoder(enc_cfg)``, unused keys)."""
    return _convert("block_conformer", sd, enc_cfg)


def convert_dit_state_dict(sd: Mapping, cfg):
    """stable-audio DiffusionTransformer state dict -> (state dict of the
    port's ``dit.DiTEstimator(cfg)``, unused keys)."""
    return _convert("dit", sd, cfg)


def convert_hift_state_dict(sd: Mapping, cfg: HiFTConfig):
    """``hift.pt`` state dict (``generator.`` stripped) -> (state dict of
    the port's ``HiFTGenerator(cfg)``, unused reference keys)."""
    return _convert("hift", sd, cfg)


def convert_tokenizer_state_dict(sd: Mapping, cfg):
    """HF WhisperVQEncoder weights (strip ``generator.encoder.`` or
    ``encoder.`` first, whisper_encoder_decoder.py:90-100) -> (state dict
    of the port's ``tokenizer.WhisperVQEncoder(cfg)``, unused keys: the
    post-VQ layers among them)."""
    return _convert("tokenizer", sd, cfg)


def convert_post_vq_state_dict(sd: Mapping, cfg):
    """The post-VQ slice of HF WhisperVQEncoder weights (the same dict as
    ``convert_tokenizer_state_dict``'s) -> (state dict of the port's
    ``asr_decoder.PostVQEncoder(cfg)``, unused keys: the pre-VQ ones)."""
    return _convert("post_vq", sd, cfg)


def convert_whisper_decoder_state_dict(sd: Mapping, cfg):
    """HF WhisperVQDecoder weights (``decoder.`` stripped) -> (state dict of
    the port's ``asr_decoder.WhisperVQDecoder(cfg)``, unused keys)."""
    return _convert("whisper_decoder", sd, cfg)


def convert_qwen2_state_dict(sd: Mapping, cfg):
    """HF Qwen2ForCausalLM state dict -> (state dict of the port's
    ``Qwen2Model(cfg)``, unused keys: ``lm_head.weight`` among them)."""
    return _convert("qwen2", sd, cfg)


def convert_speech_lm_state_dict(sd: Mapping, cfg):
    """CosyVoice2 ``llm.pt`` -> (state dict of the port's
    ``Qwen2SpeechLM(cfg)``, unused keys)."""
    return _convert("speech_lm", sd, cfg)


def convert_transformer_lm_state_dict(sd: Mapping, cfg):
    """CosyVoice v1 ``llm.pt`` -> (state dict of the port's
    ``TransformerLM(cfg)``, unused keys)."""
    return _convert("transformer_lm", sd, cfg)


def convert_campplus_state_dict(sd: Mapping, block_layers=(12, 24, 16)):
    """CAM++ torch state dict or ONNX initializers -> (state dict of the
    port's ``CAMPPlus``, unused keys but ``num_batches_tracked``)."""
    out, unused = _convert("campplus", sd, tuple(block_layers))
    return out, [k for k in unused if not k.endswith("num_batches_tracked")]


def strip_prefix(sd: Mapping, *prefixes: str) -> Dict[str, np.ndarray]:
    """Drops the first matching prefix from every key."""
    out = {}
    for k, v in sd.items():
        for p in prefixes:
            if k.startswith(p):
                k = k[len(p):]
                break
        out[k] = v
    return out


# numpy dtypes of the safetensors header's names
_ST_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16,
              "I64": np.int64, "I32": np.int32, "I16": np.int16,
              "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_}


def load_safetensors(path) -> Dict[str, np.ndarray]:
    """A ``.safetensors`` file -> {name: array}, without the safetensors
    package: an 8-byte little-endian header length, a JSON header of
    ``{name: {dtype, shape, data_offsets}}`` (and ``__metadata__``), then
    the raw little-endian tensors.  BF16 reads as float32."""
    with open(path, "rb") as f:
        buf = f.read()
    (n,) = struct.unpack("<Q", buf[:8])
    header = json.loads(buf[8: 8 + n])
    base = 8 + n
    out: Dict[str, np.ndarray] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        lo, hi = info["data_offsets"]
        raw = buf[base + lo: base + hi]
        shape = tuple(info["shape"])
        if info["dtype"] == "BF16":
            bits = np.frombuffer(raw, "<u2").astype(np.uint32) << 16
            arr = bits.view(np.float32)
        elif info["dtype"] in _ST_DTYPES:
            arr = np.frombuffer(raw, np.dtype(_ST_DTYPES[info["dtype"]])
                                .newbyteorder("<")).copy()
        else:
            raise ValueError(f"{path}: tensor {name!r} has unsupported "
                             f"dtype {info['dtype']}")
        out[name] = arr.reshape(shape)
    return out


def load_torch_state_dict(path) -> Dict[str, np.ndarray]:
    """A ``.pt`` (``torch.load(weights_only=True)``, on the CPU) or
    ``.safetensors`` state dict -> {name: numpy array}; a checkpoint that
    wraps it under ``state_dict`` is unwrapped; bf16 tensors read as
    float32."""
    path = str(path)
    if path.endswith(".safetensors"):
        return load_safetensors(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: (v.float() if v.dtype == torch.bfloat16 else v
                ).detach().numpy() for k, v in sd.items()}


# ------------------------------------------------------------- native IO
# A checkpoint is a directory holding the tree (nested dicts of tensors:
# state dicts, optimizer states) as one torch file, and ``metadata.json``.
STATE_FILE = "state.pt"
META_FILE = "metadata.json"


def _to_cpu(tree):
    """A copy of ``tree`` with every tensor detached onto the CPU."""
    if isinstance(tree, Mapping):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    return tree


def _write(path: str, tree, metadata: Optional[dict]) -> None:
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(tree, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    if metadata:
        with open(os.path.join(path, META_FILE), "w") as f:
            json.dump(metadata, f, indent=2)


def save_checkpoint(path, tree, metadata: Optional[dict] = None) -> None:
    """Writes ``tree`` (copied to the CPU) and ``metadata`` under the
    directory ``path``."""
    _write(os.path.abspath(path), _to_cpu(tree), metadata)


def load_checkpoint(path, map_location="cpu"):
    """The tree ``save_checkpoint`` wrote under ``path``."""
    return torch.load(os.path.join(path, STATE_FILE),
                      map_location=map_location, weights_only=True)


def load_metadata(path) -> dict:
    """``path``'s metadata ({} when it has none)."""
    meta = os.path.join(path, META_FILE)
    if not os.path.exists(meta):
        return {}
    with open(meta) as f:
        return json.load(f)


class AsyncCheckpointManager:
    """Checkpoints written in the background while training goes on, with
    a keep-latest retention: ``save(step, tree)`` copies the tree to the
    CPU at once and writes ``root/{prefix}{step}`` on a writer thread
    (into a temporary directory renamed when complete, so ``steps()`` sees
    only whole checkpoints); after each write, the directories beyond the
    newest ``keep`` are deleted.  Call ``wait()`` before exit: it raises a
    failed write's error."""

    def __init__(self, root, keep: int = 3, prefix: str = "step_"):
        self.root = os.path.abspath(root)
        self.keep = keep
        self.prefix = prefix
        os.makedirs(self.root, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: List[Future] = []

    def _dir(self, step: int) -> str:
        return os.path.join(self.root, f"{self.prefix}{step}")

    def _commit(self, step: int, tree, metadata: Optional[dict]) -> None:
        tmp = self._dir(step) + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        _write(tmp, tree, {"step": step, **metadata} if metadata else None)
        shutil.rmtree(self._dir(step), ignore_errors=True)
        os.rename(tmp, self._dir(step))
        self.gc()

    def save(self, step: int, tree, metadata: Optional[dict] = None) -> None:
        self._pending.append(self._pool.submit(self._commit, step,
                                               _to_cpu(tree), metadata))

    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.root):
            if name.startswith(self.prefix):
                try:
                    out.append(int(name[len(self.prefix):]))
                except ValueError:
                    pass
        return sorted(out)

    def gc(self) -> None:
        """Deletes all but the newest ``keep`` committed checkpoints."""
        for step in self.steps()[: -self.keep or None]:
            shutil.rmtree(self._dir(step), ignore_errors=True)

    def wait(self) -> None:
        pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()
        self.gc()

    def latest(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore_latest(self, map_location="cpu"):
        """(tree, step) of the newest committed checkpoint, or (None,
        None)."""
        step = self.latest()
        if step is None:
            return None, None
        return load_checkpoint(self._dir(step), map_location), step

    def close(self) -> None:
        self.wait()
        self._pool.shutdown()


def _flatten(tree: Mapping, prefix: Tuple = ()) -> Dict[Tuple, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _unflatten(flat: Mapping[Tuple, Any]) -> Dict:
    out: Dict = {}
    for path, v in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def shape_filtered_merge(params: Mapping, loaded: Mapping
                         ) -> Tuple[Dict, List[str]]:
    """A partial restore that keeps ``params``' leaf where ``loaded`` has
    none of the same path and shape, reporting those paths of ``loaded``
    ("/"-joined) it skipped (the reference's shape-filtered load,
    bin/train.py:149-169).  Trees are nested mappings; a state dict is
    one level."""
    flat_p, flat_l = _flatten(params), _flatten(loaded)
    out = dict(flat_p)
    skipped = []
    for k, v in flat_l.items():
        if k in flat_p and tuple(np.shape(flat_p[k])) == tuple(np.shape(v)):
            out[k] = v
        else:
            skipped.append("/".join(map(str, k)))
    return _unflatten(out), skipped
