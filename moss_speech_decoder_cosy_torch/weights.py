"""State dicts for the port's modules: from the JAX package's param trees,
or drawn from a seed.

The port's modules carry the JAX package's parameter names (``encoders_0``,
``down_tf_0_1``, ...), so a flax path maps to a state-dict key one to one
and every leaf is used exactly once.  Layouts:

- Dense kernel (I, O) -> ``weight`` (O, I)
- conv kernel / weight-norm ``v`` (K, I, O) -> (O, I, K)
- conv-transpose kernel / ``v`` (K, I, O) -> (I, O, K) (the JAX package's
  ``ConvTranspose1d`` is torch's with ``W[i, o, k] = kernel[k, i, o]``)
- LayerNorm ``scale`` -> ``weight``; Embed ``embedding`` -> ``weight``
- weight-norm ``g``, ``bias``, Snake ``alpha``, ``pos_bias_u/v`` as they are
- the tokenizer's ``embed_positions`` and ``codebook``, the post-VQ
  encoder's ``embed_positions2`` and the classifier's ``layer_weights`` as
  they are
- CAM++: Conv2d kernel (KH, KW, I, O) -> (O, I, KH, KW), BatchNorm ``scale``
  -> ``weight`` and its ``mean`` / ``var`` -> the ``running_mean`` /
  ``running_var`` buffers
- the conformer conv module's batch norm: ``scale`` -> ``weight``,
  ``running_mean`` / ``running_var`` (flax params) -> the buffers of the
  same names; the DiT's Fourier ``weight`` as it is
"""

from __future__ import annotations

import math
import re
from typing import Any, Callable, Dict, Iterable, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from .ops.convs import Conv1d, Conv2d, ConvTranspose1d
from .ops.norms import GroupNorm, LayerNorm

_SAME = {"bias", "g", "alpha", "pos_bias_u", "pos_bias_v"}
_RENAME = {"scale": "weight", "embedding": "weight"}


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
            ) -> Iterable[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(val)


def state_from_jax_tree(params: Mapping[str, Any],
                        is_transpose: Callable[[str], bool] = (
                            lambda mod: False),
                        same=frozenset(), renamed=None
                        ) -> Dict[str, torch.Tensor]:
    """Any flax param tree -> state dict by the layout rules above;
    ``is_transpose(module_path)`` marks conv-transpose kernels; ``same``
    more leaf names kept as they are, ``renamed`` more leaf renames."""
    tree = params.get("params", params)
    renames = dict(_RENAME, **(renamed or {}))
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(tree):
        mod, name = ".".join(path[:-1]), path[-1]
        if name in _SAME or name in same:
            new, arr = name, leaf
        elif name in renames:
            new, arr = renames[name], leaf
        elif name in ("kernel", "v"):
            new = "weight" if name == "kernel" else "v"
            if leaf.ndim == 2:
                arr = leaf.T
            elif leaf.ndim == 3:
                arr = leaf.transpose((1, 2, 0) if is_transpose(mod)
                                     else (2, 1, 0))
            elif leaf.ndim == 4:
                arr = leaf.transpose(3, 2, 0, 1)
            else:
                raise ValueError(f"unexpected kernel rank at {path}")
        else:
            raise ValueError(f"no mapping for flax leaf {'/'.join(path)}")
        key = f"{mod}.{new}" if mod else new
        if key in out:
            raise ValueError(f"two flax leaves map to {key}")
        out[key] = torch.from_numpy(np.array(arr, dtype=np.float32))
    return out


_BN_STATS = frozenset({"running_mean", "running_var"})


def flow_state_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``CausalMaskedDiffWithXvec`` or v1 ``MaskedDiffWithXvec`` params
    (numpy leaves) -> state dict of this package's module of the same
    name.  An ``up_conv_i`` below the last U-Net level is a transposed
    conv; a conv module's batch-norm statistics become buffers."""
    tree = params.get("params", params)
    est = tree["decoder"]["estimator"]
    levels = sum(1 for k in est if re.fullmatch(r"down_res_\d+", k))

    def is_transpose(mod: str) -> bool:
        m = re.search(r"(?:^|\.)up_conv_(\d+)\.conv$", mod)
        return bool(m) and int(m.group(1)) < levels - 1

    return state_from_jax_tree(params, is_transpose, same=_BN_STATS)


# the v1 flow's tree has the v2 flow's layout rules (``models/flow/
# flow_v1.py``; the standalone block conformer is a subtree of it)
flow_v1_state_from_jax = flow_state_from_jax


def dit_state_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``DiTEstimator`` or ``DiTConditionalCFM`` params -> state dict of
    this package's module of the same name (``models/flow/dit.py``)."""
    return state_from_jax_tree(params, same={"weight"})


def gradtts_state_from_jax(params: Mapping[str, Any]
                           ) -> Dict[str, torch.Tensor]:
    """JAX ``GradTTSDiffWithXvec`` params -> state dict of this package's
    ``models/flow/vdiff.GradTTSDiffWithXvec`` (v1 encoder and regulator,
    the DiT under ``decoder.estimator``)."""
    return state_from_jax_tree(params, same=_BN_STATS | {"weight"})


def hift_state_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``HiFTGenerator`` params (numpy leaves) -> state dict of this
    package's ``HiFTGenerator``; ``ups_i`` are transposed convs."""
    return state_from_jax_tree(
        params, lambda mod: re.fullmatch(r"ups_\d+", mod) is not None)


def tokenizer_state_from_jax(params: Mapping[str, Any]
                             ) -> Dict[str, torch.Tensor]:
    """JAX ``WhisperVQEncoder`` params (numpy leaves) -> state dict of this
    package's ``tokenizer.WhisperVQEncoder``."""
    return state_from_jax_tree(params,
                               same={"embed_positions", "codebook"})


def post_vq_state_from_jax(params: Mapping[str, Any]
                           ) -> Dict[str, torch.Tensor]:
    """JAX ``PostVQEncoder`` params -> state dict of this package's
    ``tokenizer.asr_decoder.PostVQEncoder``."""
    return state_from_jax_tree(params, same={"embed_positions2"})


def whisper_decoder_state_from_jax(params: Mapping[str, Any]
                                   ) -> Dict[str, torch.Tensor]:
    """JAX ``WhisperVQDecoder`` params -> state dict of this package's
    ``tokenizer.asr_decoder.WhisperVQDecoder``."""
    return state_from_jax_tree(params, same={"embed_positions"})


def audio_classifier_state_from_jax(params: Mapping[str, Any]
                                    ) -> Dict[str, torch.Tensor]:
    """JAX ``WhisperAudioClassifier`` params -> state dict of this
    package's ``tokenizer.asr_decoder.WhisperAudioClassifier``."""
    return state_from_jax_tree(params, same={"layer_weights"})


def campplus_state_from_jax(params: Mapping[str, Any]
                            ) -> Dict[str, torch.Tensor]:
    """JAX ``CAMPPlus`` params (numpy leaves, the BatchNorm running
    statistics among them) -> state dict of this package's
    ``models.campplus.CAMPPlus``."""
    return state_from_jax_tree(params, renamed={"mean": "running_mean",
                                                "var": "running_var"})


# JAX ``training.gan`` discriminators' params (``MultipleDiscriminator``,
# ``MultiPeriodDiscriminator``, ``MultiResolutionDiscriminator``, the single
# ones) -> state dicts of this package's ``training.gan`` modules of the same
# names: weight-norm Conv2d ``v`` (KH, KW, I, O) -> (O, I, KH, KW), ``g`` and
# ``bias`` as they are
discriminator_state_from_jax = state_from_jax_tree

# JAX ``Qwen2Model``, ``Qwen2SpeechLM`` and ``TransformerLM`` params (numpy
# leaves) -> state dicts of this package's ``models.llm`` modules: their
# names carry over one to one (RMSNorm ``scale`` -> ``weight``)
qwen2_state_from_jax = state_from_jax_tree
speech_lm_state_from_jax = state_from_jax_tree
transformer_lm_state_from_jax = state_from_jax_tree


# modules the JAX HiFT initialises with normal(0.01) (its ``_INIT_001``)
_SMALL_INIT = re.compile(r"(?:^|\.)(?:ups_\d+|conv_post|conv[12]_\d+)$")


@torch.no_grad()
def seeded_state(module: nn.Module, seed: int) -> Dict[str, torch.Tensor]:
    """A state dict for ``module`` drawn on the CPU from ``seed``, so the
    same seed gives the same weights on every device.  Dense and conv
    weights are lecun-normal (std 1/sqrt(fan_in)), HiFT's ``_INIT_001``
    convs normal(0.01), weight-norm gains ||v|| (so the kernel starts equal
    to v), norms and Snake alphas ones, biases zeros, pos biases
    xavier-uniform, embeddings normal(1).  A module with a
    ``seed_init(name, shape, g)`` method draws its own leaves first: it
    returns a tensor for a parameter or buffer it sets, None to leave a
    parameter to these rules (its buffers are then left out)."""
    g = torch.Generator().manual_seed(seed)
    state: Dict[str, torch.Tensor] = {}

    def normal(shape, std):
        return torch.randn(shape, generator=g, device="cpu") * std

    for mod_name, mod in module.named_modules():
        pre = f"{mod_name}." if mod_name else ""
        small = _SMALL_INIT.search(mod_name) is not None
        hook = getattr(mod, "seed_init", None)
        for name, p in mod.named_parameters(recurse=False):
            shape = tuple(p.shape)
            val = hook(name, shape, g) if hook is not None else None
            if val is not None:
                pass
            elif name == "bias":
                val = torch.zeros(shape, device="cpu")
            elif isinstance(mod, (LayerNorm, GroupNorm)) or name == "alpha":
                val = torch.ones(shape, device="cpu")
            elif name in ("pos_bias_u", "pos_bias_v"):
                bound = math.sqrt(6.0 / (shape[0] + shape[1]))
                val = (torch.rand(shape, generator=g, device="cpu") * 2 - 1) * bound
            elif isinstance(mod, nn.Embedding):
                val = normal(shape, 1.0)
            elif isinstance(mod, nn.Linear):
                val = normal(shape, 1.0 / math.sqrt(shape[1]))
            elif isinstance(mod, (Conv1d, Conv2d, ConvTranspose1d)) \
                    and name in ("weight", "v"):
                fan_in = (shape[0] * shape[2]
                          if isinstance(mod, ConvTranspose1d)
                          else math.prod(shape[1:]))
                val = normal(shape, 0.01 if small
                             else 1.0 / math.sqrt(fan_in))
            elif name == "g":
                continue                      # set from v below
            else:
                raise ValueError(f"no init rule for {pre}{name}")
            state[pre + name] = val
        if hook is not None:
            for name, b in mod.named_buffers(recurse=False):
                val = hook(name, tuple(b.shape), g)
                if val is not None:
                    state[pre + name] = val
        if getattr(mod, "weight_norm", False):
            v = state[pre + "v"]
            state[pre + "g"] = torch.sqrt(
                (v * v).sum(dim=tuple(range(1, v.dim()))))
    return state


def seeded_module(build: Callable[[], nn.Module], seed: int,
                  device=None) -> nn.Module:
    """``build()`` holding ``seeded_state`` of ``seed`` (drawn from a twin
    built on the meta device), on ``device`` (the card unless the caller
    asks for the CPU), f32, in train mode: a trainer's initial weights."""
    from .utils.device import resolve_device
    with torch.device("meta"):
        meta = build()
    module = build()
    module.load_state_dict(seeded_state(meta, seed), strict=True)
    return module.to(resolve_device(device)).train()


def seeded_states(flow_cfg, hift_cfg, seed: int = 0, v1: bool = False
                  ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(flow_state, hift_state) drawn from seeds ``seed`` and ``seed + 1``
    for the given configs (the modules are built on the meta device);
    ``v1``: the flow is the CosyVoice-v1 ``MaskedDiffWithXvec``."""
    from .models.flow import CausalMaskedDiffWithXvec
    from .models.flow.flow_v1 import MaskedDiffWithXvec
    from .models.hift import HiFTGenerator
    with torch.device("meta"):
        flow = (MaskedDiffWithXvec if v1 else CausalMaskedDiffWithXvec)(
            flow_cfg)
        hift = HiFTGenerator(hift_cfg)
    return seeded_state(flow, seed), seeded_state(hift, seed + 1)
