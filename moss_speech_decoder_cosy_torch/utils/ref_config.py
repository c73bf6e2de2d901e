"""The reference's hyperpyyaml checkpoint configs into the port's config
dataclasses (the port's copy of the JAX package's
``utils/ref_config.py``).

The reference's checkpoint directories carry a hyperpyyaml ``config.yaml``
that instantiates live torch objects (flow_inference.py:53-64).  Only the
constructor arguments are needed: the loader maps every ``!new:`` /
``!name:`` / ``!apply:`` tag to a plain dict ``{"__class__": name,
**kwargs}``, and the known model classes become ``FlowConfig`` /
``HiFTConfig``.  A ``!ref <key>`` (the published configs write
``sampling_rate: !ref <sample_rate>``) takes the value of the top-level
``key``; the JAX package's loader fails on any ``!ref``.  PyYAML is
imported when a file is read, so the module imports where it is missing.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Tuple

from .config import (CFMConfig, EncoderConfig, EstimatorConfig, FlowConfig,
                     HiFTConfig)


def _tag_constructor(loader, tag_suffix: str, node):
    import yaml
    if isinstance(node, yaml.MappingNode):
        value = loader.construct_mapping(node, deep=True)
    elif isinstance(node, yaml.SequenceNode):
        value = {"__args__": loader.construct_sequence(node, deep=True)}
    else:
        value = {"__value__": loader.construct_scalar(node)}
    value["__class__"] = tag_suffix
    return value


class _Ref(str):
    """The text of a ``!ref`` tag, resolved once the whole file is read."""


def _resolve(value: Any, top: Dict[str, Any], depth: int = 0) -> Any:
    if isinstance(value, _Ref):
        m = re.fullmatch(r"\s*<([\w.]+)>\s*", value)
        if m is None or m.group(1) not in top or depth > 16:
            return str(value)            # an expression: left as its text
        return _resolve(top[m.group(1)], top, depth + 1)
    if isinstance(value, dict):
        return {k: _resolve(v, top, depth) for k, v in value.items()}
    if isinstance(value, list):
        return [_resolve(v, top, depth) for v in value]
    return value


def load_reference_yaml(path) -> Dict[str, Any]:
    import yaml

    class RefLoader(yaml.SafeLoader):
        pass

    RefLoader.add_multi_constructor("!new:", _tag_constructor)
    RefLoader.add_multi_constructor("!name:", _tag_constructor)
    RefLoader.add_multi_constructor(
        "!ref", lambda loader, suffix, node: _Ref(
            loader.construct_scalar(node)))
    RefLoader.add_multi_constructor("!apply:", _tag_constructor)
    with open(path) as f:
        raw = yaml.load(f, Loader=RefLoader)
    return _resolve(raw, raw) if isinstance(raw, dict) else raw


def _cls(d: Any) -> str:
    return d.get("__class__", "") if isinstance(d, dict) else ""


def flow_config_from_reference(cfg: Dict[str, Any]) -> FlowConfig:
    """Build FlowConfig from a parsed checkpoint yaml (expects the
    CausalMaskedDiffWithXvec layout; cf. cosyvoice2.yaml)."""
    flow = cfg["flow"]
    if "MaskedDiffWithXvec" not in _cls(flow):
        raise ValueError(f"not a MaskedDiffWithXvec flow: {_cls(flow)!r}")
    enc = flow["encoder"]
    dec = flow["decoder"]
    est = dec["estimator"]
    cfm_p = dec.get("cfm_params", {})
    if isinstance(cfm_p, dict):
        # omegaconf DictConfig wraps the mapping under 'content'
        cfm_p = cfm_p.get("content", cfm_p)
        cfm_p = {k: v for k, v in cfm_p.items() if not k.startswith("__")}

    encoder = EncoderConfig(
        input_size=enc.get("input_size", 512),
        output_size=enc.get("output_size", 512),
        attention_heads=enc.get("attention_heads", 8),
        linear_units=enc.get("linear_units", 2048),
        num_blocks=enc.get("num_blocks", 6),
        static_chunk_size=enc.get("static_chunk_size", 25),
        upsample_stride=enc.get("upsample_stride", 2),
        macaron_style=enc.get("macaron_style", False),
        use_cnn_module=enc.get("use_cnn_module", False),
        key_bias=enc.get("key_bias", True),
        dropout_rate=enc.get("dropout_rate", 0.1),
        pos_enc_layer_type=enc.get("pos_enc_layer_type", "rel_pos"),
        num_up_blocks=enc.get("num_up_blocks", 4),
    )
    estimator = EstimatorConfig(
        in_channels=est.get("in_channels", 320),
        out_channels=est.get("out_channels", 80),
        channels=tuple(est.get("channels", (256,))),
        attention_head_dim=est.get("attention_head_dim", 64),
        n_blocks=est.get("n_blocks", 4),
        num_mid_blocks=est.get("num_mid_blocks", 12),
        num_heads=est.get("num_heads", 8),
        act_fn=est.get("act_fn", "gelu"),
        static_chunk_size=est.get("static_chunk_size", 50),
        causal="Causal" in _cls(est),
    )
    cfm = CFMConfig(
        sigma_min=float(cfm_p.get("sigma_min", 1e-6)),
        t_scheduler=cfm_p.get("t_scheduler", "cosine"),
        training_cfg_rate=float(cfm_p.get("training_cfg_rate", 0.2)),
        inference_cfg_rate=float(cfm_p.get("inference_cfg_rate", 0.7)),
    )
    return FlowConfig(
        vocab_size=flow.get("vocab_size", 16384),
        input_size=flow.get("input_size", 512),
        output_size=flow.get("output_size", 80),
        spk_embed_dim=flow.get("spk_embed_dim", 192),
        input_frame_rate=flow.get("input_frame_rate", 12.5),
        token_mel_ratio=flow.get("token_mel_ratio", 2),
        pre_lookahead_len=flow.get("pre_lookahead_len", 3),
        encoder=encoder, estimator=estimator, cfm=cfm,
    )


def hift_config_from_reference(cfg: Dict[str, Any]) -> HiFTConfig:
    h = cfg["hift"]
    istft = h.get("istft_params", {})
    f0 = h.get("f0_predictor", {})
    return HiFTConfig(
        f0_cond_channels=(f0.get("cond_channels", 512)
                          if isinstance(f0, dict) else 512),
        in_channels=h.get("in_channels", 80),
        base_channels=h.get("base_channels", 512),
        nb_harmonics=h.get("nb_harmonics", 8),
        sampling_rate=h.get("sampling_rate", cfg.get("sample_rate", 24000)),
        nsf_alpha=h.get("nsf_alpha", 0.1),
        nsf_sigma=h.get("nsf_sigma", 0.003),
        nsf_voiced_threshold=h.get("nsf_voiced_threshold", 10),
        upsample_rates=tuple(h.get("upsample_rates", (8, 5, 3))),
        upsample_kernel_sizes=tuple(
            h.get("upsample_kernel_sizes", (16, 11, 7))),
        istft_n_fft=istft.get("n_fft", 16),
        istft_hop_len=istft.get("hop_len", 4),
        resblock_kernel_sizes=tuple(
            h.get("resblock_kernel_sizes", (3, 7, 11))),
        resblock_dilation_sizes=tuple(
            tuple(d) for d in h.get("resblock_dilation_sizes",
                                    ((1, 3, 5),) * 3)),
        source_resblock_kernel_sizes=tuple(
            h.get("source_resblock_kernel_sizes", (7, 7, 11))),
        source_resblock_dilation_sizes=tuple(
            tuple(d) for d in h.get("source_resblock_dilation_sizes",
                                    ((1, 3, 5),) * 3)),
        lrelu_slope=h.get("lrelu_slope", 0.1),
        audio_limit=h.get("audio_limit", 0.99),
    )


def configs_from_reference_yaml(path: str) -> Tuple[FlowConfig, HiFTConfig]:
    cfg = load_reference_yaml(path)
    return flow_config_from_reference(cfg), hift_config_from_reference(cfg)
