"""The port's tensor-parallel and ZeRO sharding rules (``parallel/tp.py``,
``parallel/mesh.py``) against the JAX package's, on every parameter of the
tiny ``Qwen2SpeechLM`` and the tiny v1 ``TransformerLM``.  Mirrors the
spec tests of ``tests/test_tp.py``; the sharded forwards and train steps
run on two ranks in ``tests/test_torch_distributed.py``.

- ``tp_specs`` at tp 2, 3 and 4: the same split (a torch ``nn.Linear``
  weight is the flax kernel transposed, so a column split is dim 0 and a
  row split dim 1) or both replicated, parameter by parameter;
- tp 3 divides none of the tiny widths: every parameter replicated;
- ``tp_shard_params``: each rank's slices, together the whole;
- ``zero_sharding`` against JAX's on the same shapes over 2, 3 and 8
  ranks;
- a rank's heads at CosyVoice2's Qwen2 geometry (14 q / 2 k/v heads):
  at tp 2 each rank runs 7 q heads on its one k/v head; where a rank's
  q heads do not read its own k/v column slice (one k/v head over 2
  ranks, or 14 / 2 heads at tp 7) ``NotImplementedError``.

Shapes only: the JAX trees come from ``jax.eval_shape``."""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh, PartitionSpec as P

from moss_speech_decoder_cosy_tpu.models.llm import speech_lm as JS
from moss_speech_decoder_cosy_tpu.models.llm import transformer_lm as JTL
from moss_speech_decoder_cosy_tpu.parallel import mesh as JM
from moss_speech_decoder_cosy_tpu.parallel import tp as JTP
from moss_speech_decoder_cosy_torch.models.llm import speech_lm as TS
from moss_speech_decoder_cosy_torch.models.llm.qwen2 import (Qwen2Config,
                                                             Qwen2Layer)
from moss_speech_decoder_cosy_torch.models.llm import transformer_lm as TTL
from moss_speech_decoder_cosy_torch.parallel import mesh as TM
from moss_speech_decoder_cosy_torch.parallel import tp as TTP


@functools.lru_cache(maxsize=None)
def _jax_shapes(kind):
    """The JAX model's parameter shapes, traced once a kind."""
    if kind == "qwen2":
        m = JS.Qwen2SpeechLM(JS.tiny_speech_lm_config())
        return jax.eval_shape(lambda k: m.init(
            k, jnp.zeros((1, 4), jnp.int32), jnp.zeros((1, 0), jnp.int32),
            jax.random.PRNGKey(1), max_len=4), jax.random.PRNGKey(0))
    m = JTL.TransformerLM(JTL.tiny_transformer_lm_config())
    spk = TTL.tiny_transformer_lm_config().spk_embed_dim
    return jax.eval_shape(m.init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 5), jnp.int32), jnp.ones((1, 5), bool),
                          jnp.zeros((1, 7), jnp.int32), jnp.ones((1, 7), bool),
                          jnp.zeros((1, spk)))


def _port(kind):
    with torch.device("meta"):
        if kind == "qwen2":
            return TS.Qwen2SpeechLM(TS.tiny_speech_lm_config())
        return TTL.TransformerLM(TTL.tiny_transformer_lm_config())


def _name(path) -> str:
    """A flax path as the port's parameter name."""
    keys = [str(getattr(k, "key", k)) for k in path][1:]
    if keys[-1] in ("kernel", "scale", "embedding"):
        keys[-1] = "weight"
    return ".".join(keys)


def _as_port(path, spec: P):
    """A JAX PartitionSpec in the port's terms."""
    leaf = str(getattr(path[-1], "key", path[-1]))
    if spec == P():
        return None
    if leaf == "bias" and spec == P("model"):
        return ("col", 0)
    if leaf == "kernel" and spec == P(None, "model"):
        return ("col", 0)
    if leaf == "kernel" and spec == P("model", None):
        return ("row", 1)
    raise AssertionError(f"unexpected spec {spec} at {path}")


def _jax_specs(kind, tp):
    shapes = _jax_shapes(kind)
    mesh = JTP.make_tp_mesh(tp * (8 // tp), tp=tp)
    specs = JTP.tp_specs(shapes, mesh)
    return {_name(p): _as_port(p, s.spec)
            for p, s in jax.tree_util.tree_leaves_with_path(specs)}


@pytest.mark.parametrize("tp", [2, 3, 4])
@pytest.mark.parametrize("kind", ["qwen2", "v1"])
def test_tp_specs_match_jax(kind, tp):
    want = _jax_specs(kind, tp)
    got = TTP.tp_specs(_port(kind), tp)
    assert set(got) == set(want)
    assert got == want
    if tp in (2, 4):
        assert sum(s is not None for s in got.values()) > 0


def test_indivisible_dims_fall_back_to_replicated():
    """tp 3 divides none of the tiny Qwen2's widths (kv 16, ffn 64, hidden
    32): every rule parameter replicates; tp 4 still splits gate."""
    specs = TTP.tp_specs(_port("qwen2"), 3)
    for mod in ("q_proj", "k_proj", "o_proj", "gate_proj", "down_proj"):
        assert specs[f"llm.layers_0.{mod}.weight"] is None, mod
    assert TTP.tp_specs(_port("qwen2"), 4)[
        "llm.layers_0.gate_proj.weight"] == ("col", 0)


def test_tp_shard_params_slices_make_the_whole():
    g = torch.Generator().manual_seed(0)
    state = {k: torch.randn(tuple(v.shape), generator=g)
             for k, v in _port("qwen2").named_parameters()}
    specs = TTP.tp_specs(state, 2)
    parts = [TTP.tp_shard_params(state, 2, r) for r in range(2)]
    for k, v in state.items():
        if specs[k] is None:
            assert all(torch.equal(p[k], v) for p in parts)
        else:
            d = specs[k][1]
            assert parts[0][k].shape[d] * 2 == v.shape[d]
            assert torch.equal(torch.cat([p[k] for p in parts], d), v)


@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("kind", ["qwen2", "v1"])
def test_zero_sharding_matches_jax(kind, n):
    shapes = _jax_shapes(kind)
    mesh = Mesh(np.array(jax.devices()[:n]), ("data",))
    specs = JM.zero_sharding(shapes, mesh)
    leaves = jax.tree_util.tree_leaves(shapes)
    want = []
    for s in jax.tree_util.tree_leaves(specs):
        dims = [i for i, a in enumerate(s.spec) if a == "data"]
        want.append(dims[0] if dims else None)
    got = TM.zero_sharding([torch.empty(x.shape, device="meta")
                            for x in leaves], n)
    assert got == want
    if n != 3:
        assert any(d is not None for d in got)


def test_make_mesh_on_the_cpu():
    assert TM.make_mesh(3, "cpu") == [torch.device("cpu")] * 3


def _layer(h, hkv, dk):
    with torch.device("meta"):
        return Qwen2Layer(Qwen2Config(vocab_size=8, hidden_size=h * dk,
                                      num_layers=1, num_heads=h,
                                      num_kv_heads=hkv, ffn_size=64))


@pytest.mark.parametrize("rank", [0, 1])
def test_cosyvoice2_heads_split_at_tp_2(rank):
    """14 q / 2 k/v heads of 64 over 2 ranks: 7 q heads and the k/v head
    they read on each rank, its column slice of k and v."""
    layer = _layer(14, 2, 64)
    TTP._qwen2_layer(layer, 2, rank, None)
    assert (layer.cfg.num_heads, layer.cfg.num_kv_heads) == (7, 1)
    assert layer.cfg.head_dim == 64
    for name, rows in (("q_proj", 448), ("k_proj", 64), ("v_proj", 64)):
        mod = getattr(layer, name)
        assert isinstance(mod, TTP.ColumnParallelLinear), name
        assert mod.weight.shape[0] == rows and mod.weight.tp_dim == 0
    assert layer.o_proj.weight.shape == (896, 448)


@pytest.mark.parametrize("h, hkv, dk, tp", [(2, 1, 8, 2), (14, 2, 64, 7)])
def test_kv_heads_off_the_ranks_slice_raise(h, hkv, dk, tp):
    """A rank's q heads that read k/v heads other than its own k/v column
    slice: ``NotImplementedError``, not a wrong split."""
    with pytest.raises(NotImplementedError, match="k/v heads"):
        TTP._qwen2_layer(_layer(h, hkv, dk), tp, 0, None)
