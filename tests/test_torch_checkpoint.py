"""The port's reference-checkpoint readers (``utils/checkpoint.py``,
``utils/onnx_io.py``, ``utils/ref_config.py``) against the JAX package,
f32 on the CPU, tiny configs:

- converters: a synthetic reference state dict comes from the JAX
  package's ``conversion_plan`` and flax params drawn from a seed (plus
  keys neither package maps); for flow, HiFT, the tokenizer, CAM++, the
  three LM plans (qwen2, speech_lm, transformer_lm) and the v1 plans
  (flow_v1 with the macaron FF and a batch-norm conv module,
  block_conformer, dit) and the ASR head's (post_vq, whisper_decoder) the
  port's ``convert_*_state_dict`` is exactly ``*_state_from_jax`` of the
  JAX ``convert_*_state_dict``, with the same unused keys, also under
  torch's legacy ``weight_g`` / ``weight_v`` names; the port's plan,
  inverted, writes a reference state dict that converts back to the same
  state bit for bit (the writer ``chip_smoke.py`` uses);
- a flow encoder forward and a HiFT forward on the converted state within
  1e-5 of JAX (the HiFT given the JAX source's draws);
- ``strip_prefix``, ``.pt`` round trips (a ``state_dict`` wrapper, bf16)
  and the port's safetensors reader against ``safetensors``;
- ``onnx_io``: the port's reader equal to ``load_onnx_initializers`` on the
  same bytes; ``SpeakerEncoder.from_onnx`` within 1e-5 of the JAX
  ``SpeakerEncoder`` on the same initializers;
- ``ref_config``: the JAX package's test yaml gives equal configs, field
  for field.

Torch runs on one thread here, as in the other port test modules."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import flax.traverse_util as tu
import torch

from moss_speech_decoder_cosy_tpu.models import campplus as JCam
from moss_speech_decoder_cosy_tpu.models.flow import dit as JDiT
from moss_speech_decoder_cosy_tpu.models.flow import flow_v1 as JV1
from moss_speech_decoder_cosy_tpu.models.flow import (
    CausalMaskedDiffWithXvec as JFlow, UpsampleConformerEncoder as JEncoder)
from moss_speech_decoder_cosy_tpu.models.hift import HiFTGenerator as JHiFT
from moss_speech_decoder_cosy_tpu.models.llm import speech_lm as JSL
from moss_speech_decoder_cosy_tpu.models.llm import transformer_lm as JTL
from moss_speech_decoder_cosy_tpu.tokenizer import asr_decoder as JA
from moss_speech_decoder_cosy_tpu.tokenizer import model as JT
from moss_speech_decoder_cosy_tpu.tokenizer import tiny_tokenizer_config
from moss_speech_decoder_cosy_tpu.utils import checkpoint as JK
from moss_speech_decoder_cosy_tpu.utils import onnx_io as JO
from moss_speech_decoder_cosy_tpu.utils import ref_config as JR
from moss_speech_decoder_cosy_tpu.utils import config as JC
from moss_speech_decoder_cosy_tpu.utils.config import (
    tiny_flow_config, tiny_hift_config)
from moss_speech_decoder_cosy_torch.models import campplus as TCam
from moss_speech_decoder_cosy_torch.models.flow import dit as TDiT
from moss_speech_decoder_cosy_torch.models.flow import (
    CausalMaskedDiffWithXvec as TFlow)
from moss_speech_decoder_cosy_torch.models.hift import HiFTGenerator as THiFT
from moss_speech_decoder_cosy_torch.models.llm import speech_lm as TSL
from moss_speech_decoder_cosy_torch.models.llm import transformer_lm as TTL
from moss_speech_decoder_cosy_torch.tokenizer import config as TTC
from moss_speech_decoder_cosy_torch.utils import checkpoint as TK
from moss_speech_decoder_cosy_torch.utils import config as TC
from moss_speech_decoder_cosy_torch.utils import onnx_io as TO
from moss_speech_decoder_cosy_torch.utils import ref_config as TR
from moss_speech_decoder_cosy_torch.weights import (
    campplus_state_from_jax, dit_state_from_jax, flow_state_from_jax,
    flow_v1_state_from_jax, hift_state_from_jax, post_vq_state_from_jax,
    qwen2_state_from_jax, speech_lm_state_from_jax, state_from_jax_tree,
    tokenizer_state_from_jax, transformer_lm_state_from_jax,
    whisper_decoder_state_from_jax)

from test_torch_flow_v1 import init_v1, tiny_v1_config

FORWARD_ATOL = 1e-5
CAM_KW = dict(embedding_size=12, growth_rate=4, bn_size=2, init_channels=8,
              block_layers=(2, 2, 1), block_dilations=(1, 2, 2))

# the JAX converters' transforms, inverted: flax layout -> torch layout
JAX_INVERSE = {
    JK._t: lambda x: x.T, JK._conv: lambda x: x.transpose(2, 1, 0),
    JK._convT: lambda x: x.transpose(1, 2, 0),
    JK._g: lambda x: x.reshape(-1, 1, 1),
    JK._conv2: lambda x: x.transpose(3, 2, 0, 1),
    JK._dense_from_conv1: lambda x: x.T[..., None]}
# the port's reshapes, inverted: port layout -> torch layout
PORT_INVERSE = {"g": lambda x: x.reshape(-1, 1, 1),
                "conv1": lambda x: x[..., None]}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_plan(kind, cfg):
    """The JAX package's plan rows; the block conformer's (which the JAX
    ``conversion_plan`` does not list) are the v1 flow's encoder rows."""
    if kind != "block_conformer":
        return JK.conversion_plan(kind, cfg)
    flow = dataclasses.replace(tiny_v1_config(JC), encoder=cfg)
    return [(d[len("encoder/"):], s[len("encoder."):], fn)
            for d, s, fn in JK.conversion_plan("flow_v1", flow)
            if s.startswith("encoder.")]


def reference_sd_from_jax(kind, cfg, params):
    """A reference (torch-named) state dict of numpy arrays from flax
    params, through the JAX package's plan."""
    flat = {"/".join(k): np.asarray(v) for k, v in
            tu.flatten_dict(params["params"]).items()}
    return {src: np.ascontiguousarray(
        JAX_INVERSE[fn](flat[dst]) if fn else flat[dst])
        for dst, src, fn in _jax_plan(kind, cfg)}


def reference_sd(kind, cfg, state):
    """A reference (torch-named) state dict of tensors from a port state
    dict, through the port's plan."""
    return {src: torch.from_numpy(np.ascontiguousarray(
        PORT_INVERSE[r](state[dst].numpy()) if r else state[dst].numpy()))
        for dst, src, r in TK.conversion_plan(kind, cfg)}


def _seeded_bn(params, seed):
    """JAX CAM++ params with every BatchNorm's running statistics drawn."""
    rng = np.random.RandomState(seed)

    def go(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = go(v)
            elif k == "mean":
                out[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
            elif k == "var":
                out[k] = (0.5 + rng.rand(*v.shape)).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out
    return go(params)


@pytest.fixture(scope="module")
def models():
    """kind -> (JAX cfg, port cfg, flax params, JAX state_from_jax, extra
    reference keys that neither package maps)."""
    fcfg, hcfg = tiny_flow_config(), tiny_hift_config()
    fp = jax.jit(JFlow(fcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
        jnp.ones((1, 8), bool), jnp.zeros((1, 0, fcfg.output_size)),
        jnp.zeros((1, fcfg.spk_embed_dim)))
    hp = jax.jit(JHiFT(hcfg).init)(jax.random.PRNGKey(1),
                                   jnp.zeros((1, 8, hcfg.in_channels)))
    hp = jax.tree_util.tree_map_with_path(
        lambda path, a: a * 200.0 if "conv_post" in str(path)
        and str(path[-1]) == "['g']" else a, hp)
    tcfg = tiny_tokenizer_config()
    tp = jax.jit(JT.WhisperVQEncoder(tcfg).init)(
        jax.random.PRNGKey(2), jnp.zeros((1, 16, tcfg.num_mel_bins)),
        jnp.ones((1, 16), bool))
    q0, v0 = jnp.zeros((1, 4, tcfg.d_model)), jnp.ones((1, 4), bool)
    pvq = jax.jit(JA.PostVQEncoder(tcfg).init)(jax.random.PRNGKey(13), q0, v0)
    wd = jax.jit(JA.WhisperVQDecoder(tcfg).init)(
        jax.random.PRNGKey(14), jnp.zeros((1, 5), jnp.int32),
        jnp.ones((1, 5), bool), q0, v0)
    cp = _seeded_bn(_np(jax.jit(JCam.CAMPPlus(**CAM_KW).init)(
        jax.random.PRNGKey(3), jnp.zeros((1, 50, 80)))), 4)
    scfg = JSL.tiny_speech_lm_config()
    sp = jax.jit(JSL.Qwen2SpeechLM(scfg).init, static_argnames="max_len")(
        jax.random.PRNGKey(5), jnp.zeros((1, 4), jnp.int32),
        jnp.zeros((1, 0), jnp.int32), jax.random.PRNGKey(6), max_len=4)
    vcfg, vcfg_t = JTL.tiny_transformer_lm_config(), \
        TTL.tiny_transformer_lm_config()
    vp = jax.jit(JTL.TransformerLM(vcfg).init)(
        jax.random.PRNGKey(7), jnp.zeros((1, 5), jnp.int32),
        jnp.ones((1, 5), bool), jnp.zeros((1, 7), jnp.int32),
        jnp.ones((1, 7), bool), jnp.zeros((1, vcfg_t.spk_embed_dim)))
    extra = np.zeros(3, np.float32)
    v1kw = dict(macaron_style=True, use_cnn_module=True,
                cnn_module_norm="batch_norm")
    v1j, v1t = tiny_v1_config(JC, **v1kw), tiny_v1_config(TC, **v1kw)
    _, v1p = init_v1(v1j, seed=11)
    bc = {"params": v1p["params"]["encoder"]}
    dcfg = JDiT.tiny_dit_config()
    dp = jax.jit(JDiT.DiTEstimator(dcfg).init)(
        jax.random.PRNGKey(12), jnp.zeros((1, 5, dcfg.io_channels)),
        jnp.ones((1, 5), bool), jnp.zeros((1, 5, dcfg.io_channels)),
        jnp.zeros((1,)), jnp.zeros((1, dcfg.spk_embed_dim)),
        jnp.zeros((1, 5, dcfg.io_channels)))
    bn_tracked = {"encoder.encoders.0.conv_module.norm.num_batches_tracked":
                  np.zeros((), np.int64)}
    return {
        "flow_v1": (v1j, v1t, v1p, flow_v1_state_from_jax,
                    dict(bn_tracked,
                         **{"decoder.estimator.spare.weight": extra})),
        "block_conformer": (v1j.encoder, v1t.encoder, bc,
                            lambda p: state_from_jax_tree(
                                p, same={"running_mean", "running_var"}),
                            {"encoders.1.conv_module.norm."
                             "num_batches_tracked": np.zeros((), np.int64),
                             "global_cmvn.mean": extra}),
        "dit": (dcfg, TDiT.tiny_dit_config(), _np(dp), dit_state_from_jax,
                {"spare.weight": extra}),
        "qwen2": (scfg.backbone, TSL.tiny_speech_lm_config().backbone,
                  {"params": _np(sp)["params"]["llm"]}, qwen2_state_from_jax,
                  {"lm_head.weight": extra}),
        "speech_lm": (scfg, TSL.tiny_speech_lm_config(), _np(sp),
                      speech_lm_state_from_jax,
                      {"criterion_ce.weight": extra}),
        "transformer_lm": (vcfg, vcfg_t, _np(vp),
                           transformer_lm_state_from_jax,
                           {"text_encoder.global_cmvn": extra}),
        "flow": (fcfg, TC.tiny_flow_config(), _np(fp), flow_state_from_jax,
                 {"decoder.estimator.spare.weight": extra}),
        "hift": (hcfg, TC.tiny_hift_config(), _np(hp), hift_state_from_jax,
                 {"stft_window": extra}),
        "tokenizer": (tcfg, TTC.tiny_tokenizer_config(), _np(tp),
                      tokenizer_state_from_jax,
                      {"embed_positions2.weight": extra,
                       "layers.2.fc1.weight": extra}),
        # the post-VQ plan leaves the pre-VQ keys, the decoder's the
        # tokenizer's (one checkpoint holds all three)
        "post_vq": (tcfg, TTC.tiny_tokenizer_config(), _np(pvq),
                    post_vq_state_from_jax,
                    {"layers.0.fc1.weight": extra, "conv1.weight": extra,
                     "codebook.weight": extra}),
        "whisper_decoder": (tcfg, TTC.tiny_tokenizer_config(), _np(wd),
                            whisper_decoder_state_from_jax,
                            {"proj_out.weight": extra,
                             "layers.2.fc1.weight": extra}),
        "campplus": (CAM_KW["block_layers"], CAM_KW["block_layers"], cp,
                     campplus_state_from_jax,
                     {"head.bn1.num_batches_tracked": np.zeros((), np.int64),
                      "xvector.spare": extra})}


KINDS = ("flow", "hift", "tokenizer", "campplus", "qwen2", "speech_lm",
         "transformer_lm", "flow_v1", "block_conformer", "dit", "post_vq",
         "whisper_decoder")
PORT_CONVERT = {k: getattr(TK, f"convert_{k}_state_dict") for k in KINDS}
JAX_CONVERT = {k: getattr(JK, f"convert_{k}_state_dict") for k in KINDS}


def _legacy_weight_norm(sd):
    out = {}
    for k, v in sd.items():
        k = (k.replace(".parametrizations.weight.original0", ".weight_g")
             .replace(".parametrizations.weight.original1", ".weight_v"))
        out[k] = v
    return out


def _assert_states_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("kind,legacy", [
    ("flow", False), ("hift", False), ("hift", True), ("tokenizer", False),
    ("campplus", False), ("qwen2", False), ("speech_lm", False),
    ("transformer_lm", False), ("flow_v1", False),
    ("block_conformer", False), ("dit", False), ("post_vq", False),
    ("whisper_decoder", False)])
def test_converter_equals_jax_path(models, kind, legacy):
    """``legacy``: HiFT's weight-norm pairs under ``weight_g`` /
    ``weight_v`` (the other models hold no weight norm)."""
    jcfg, tcfg, params, from_jax, extra = models[kind]
    sd = dict(reference_sd_from_jax(kind, jcfg, params), **extra)
    if legacy:
        sd = _legacy_weight_norm(sd)
    jtree, junused = JAX_CONVERT[kind](sd, jcfg)
    got, unused = PORT_CONVERT[kind](sd, tcfg)
    assert unused == junused
    assert set(unused) >= {k for k in extra
                           if not k.endswith("num_batches_tracked")}
    _assert_states_equal(got, from_jax(_np(jtree)))


@pytest.mark.parametrize("kind", KINDS)
def test_port_plan_inverts(models, kind):
    """The port's plan is a rename plus a reshape: inverted it writes a
    reference state dict (as ``chip_smoke.py`` does) that converts back
    bit for bit with nothing unused, and it names the JAX plan's reference
    keys."""
    jcfg, tcfg, params, from_jax, _ = models[kind]
    state = from_jax(params)
    rows = TK.conversion_plan(kind, tcfg)
    assert [s for _, s, _ in rows] == [
        s for _, s, _ in _jax_plan(kind, jcfg)]
    assert len({d for d, _, _ in rows}) == len(rows) == len(state)
    got, unused = PORT_CONVERT[kind](reference_sd(kind, tcfg, state), tcfg)
    assert unused == []
    _assert_states_equal(got, state)


def test_dit_plan_consumes_the_reference_buffers(models):
    """The rotary tables and the scale-only norms' fixed betas map to no
    port tensor and are not reported unused, as in the JAX package."""
    jcfg, tcfg, params, _, _ = models["dit"]
    buffers = {"transformer.inv_freq": np.zeros(4, np.float32),
               "transformer.rotary_pos_emb.inv_freq": np.zeros(4, np.float32),
               "transformer.layers.1.ff_norm.beta": np.zeros(
                   jcfg.embed_dim, np.float32)}
    sd = dict(reference_sd_from_jax("dit", jcfg, params), **buffers)
    _, junused = JK.convert_dit_state_dict(sd, jcfg)
    got, unused = TK.convert_dit_state_dict(sd, tcfg)
    assert unused == junused == []
    assert len(got) == len(TK.conversion_plan("dit", tcfg))


def test_converter_names_a_missing_key(models):
    jcfg, tcfg, params, _, _ = models["hift"]
    sd = reference_sd_from_jax("hift", jcfg, params)
    sd.pop("m_source.l_linear.weight")
    with pytest.raises(KeyError, match="m_source.l_linear.weight"):
        TK.convert_hift_state_dict(sd, tcfg)
    sd = reference_sd_from_jax("hift", jcfg, params)
    sd.pop("conv_pre.parametrizations.weight.original0")
    with pytest.raises(KeyError, match="conv_pre"):
        TK.convert_hift_state_dict(sd, tcfg)


def test_flow_and_hift_forward_on_converted_state(models):
    """The encoder of the flow and the whole HiFT, run on the converted
    state against JAX on the params the reference files came from."""
    jcfg, tcfg, params, _, _ = models["flow"]
    state, _ = TK.convert_flow_state_dict(
        reference_sd_from_jax("flow", jcfg, params), tcfg)
    with torch.device("meta"):
        flow = TFlow(tcfg)
    flow.load_state_dict(state, strict=True, assign=True)
    rng = np.random.RandomState(1)
    x = rng.randn(1, 10, jcfg.input_size).astype(np.float32)
    valid = np.ones((1, 10), bool)
    want, _ = jax.jit(JEncoder(jcfg.encoder).apply)(
        {"params": params["params"]["encoder"]}, jnp.asarray(x),
        jnp.asarray(valid))
    with torch.no_grad():
        got, _ = flow.eval().encoder(torch.from_numpy(x),
                                     torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=FORWARD_ATOL, rtol=0)

    hcfg, thcfg, hparams, _, _ = models["hift"]
    state, _ = TK.convert_hift_state_dict(
        reference_sd_from_jax("hift", hcfg, hparams), thcfg)
    with torch.device("meta"):
        hift = THiFT(thcfg)
    hift.load_state_dict(state, strict=True, assign=True)
    mel = (rng.randn(1, 12, hcfg.in_channels) * 2.0).astype(np.float32)
    want_wav, _ = jax.jit(JHiFT(hcfg).apply)(hparams, jnp.asarray(mel))
    k_ini, k_noise = jax.random.split(jax.random.PRNGKey(0))
    n_h, n = hcfg.nb_harmonics + 1, 12 * hcfg.total_upsample
    draws = (torch.from_numpy(np.array(jax.random.uniform(
        k_ini, (1, n_h), dtype=jnp.float32))),
        torch.from_numpy(np.array(jax.random.normal(
            k_noise, (1, n, n_h), jnp.float32))))
    with torch.no_grad():
        got_wav, _ = hift.eval()(torch.from_numpy(mel), draws=draws)
    assert float(np.abs(np.asarray(want_wav)).max()) > 0.05, "trivial wav"
    np.testing.assert_allclose(got_wav.numpy(), np.asarray(want_wav),
                               atol=FORWARD_ATOL, rtol=0)


def test_strip_prefix():
    sd = {"generator.a": 1, "encoder.b": 2, "generator.encoder.c": 3, "d": 4}
    assert TK.strip_prefix(sd, "generator.encoder.", "encoder.") == {
        "generator.a": 1, "b": 2, "c": 3, "d": 4}
    assert TK.strip_prefix(sd, "generator.") == JK.strip_prefix(
        sd, "generator.")


def test_pt_round_trip(tmp_path):
    g = torch.Generator().manual_seed(0)
    sd = {"w": torch.randn(3, 4, generator=g), "n": torch.arange(5),
          "h": torch.randn(2, 2, generator=g).to(torch.bfloat16)}
    torch.save(sd, tmp_path / "plain.pt")
    torch.save({"state_dict": sd}, tmp_path / "wrapped.pt")
    for name in ("plain.pt", "wrapped.pt"):
        got = TK.load_torch_state_dict(tmp_path / name)
        assert set(got) == set(sd)
        np.testing.assert_array_equal(got["w"], sd["w"].numpy())
        np.testing.assert_array_equal(got["n"], sd["n"].numpy())
        assert got["h"].dtype == np.float32
        np.testing.assert_array_equal(got["h"], sd["h"].float().numpy())


def test_safetensors_reader_matches_safetensors(tmp_path):
    st_np = pytest.importorskip("safetensors.numpy")
    st_torch = pytest.importorskip("safetensors.torch")
    rng = np.random.RandomState(0)
    arrays = {"f32": rng.randn(3, 5).astype(np.float32),
              "f16": rng.randn(7).astype(np.float16),
              "f64": rng.randn(2, 2, 2),
              "i64": rng.randint(-9, 9, (4,)).astype(np.int64),
              "i32": rng.randint(-9, 9, (2, 3)).astype(np.int32),
              "u8": rng.randint(0, 255, (6,)).astype(np.uint8),
              "b": rng.rand(3) > 0.5,
              "empty": np.zeros((0, 4), np.float32),
              "scalar": np.asarray(2.5, np.float32)}
    path = str(tmp_path / "a.safetensors")
    st_np.save_file(arrays, path, metadata={"format": "np"})
    got, want = TK.load_safetensors(path), st_np.load_file(path)
    assert set(got) == set(want) == set(arrays)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])
    assert TK.load_torch_state_dict(path).keys() == want.keys()
    bf = {"h": torch.randn(4, 3, generator=torch.Generator().manual_seed(1)
                           ).to(torch.bfloat16)}
    path = str(tmp_path / "b.safetensors")
    st_torch.save_file(bf, path)
    np.testing.assert_array_equal(TK.load_safetensors(path)["h"],
                                  st_torch.load_file(path)["h"].float()
                                  .numpy())


def _varint(v):
    out = b""
    while True:
        b7 = v & 0x7F
        v >>= 7
        if not v:
            return out + bytes([b7])
        out += bytes([b7 | 0x80])


def _field(num, wire, payload):
    return _varint((num << 3) | wire) + payload


def _ld(num, payload):                          # length-delimited
    return _field(num, 2, _varint(len(payload)) + payload)


def onnx_bytes(arrays, float_data=()):
    """A ModelProto whose graph holds ``arrays`` as initializers: float32
    raw_data, int64 packed ``int64_data``; names in ``float_data`` as
    packed ``float_data`` instead."""
    tensors = b""
    for name, a in arrays.items():
        a = np.asarray(a)
        t = _ld(1, b"".join(_varint(d) for d in a.shape)) if a.ndim else b""
        if a.dtype == np.int64:
            t += _field(2, 0, _varint(7)) + _ld(7, b"".join(
                _varint(int(v) & (2 ** 64 - 1)) for v in a.reshape(-1)))
        elif name in float_data:
            t += _field(2, 0, _varint(1)) + _ld(
                4, a.astype("<f4").tobytes())
        else:
            t += _field(2, 0, _varint(1)) + _ld(
                9, a.astype("<f4").tobytes())
        tensors += _ld(5, t + _ld(8, name.encode()))
    return _ld(7, tensors) + _ld(2, b"test-producer")


def test_onnx_reader_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    arrays = {"weight": rng.randn(3, 2, 4).astype(np.float32),
              "packed": rng.randn(5).astype(np.float32),
              "ids": np.asarray([5, 600, 70000], np.int64),
              "scalar": np.asarray(1.5, np.float32)}
    path = tmp_path / "m.onnx"
    path.write_bytes(onnx_bytes(arrays, float_data=("packed",)))
    got = TO.load_onnx_initializers(str(path))
    want = JO.load_onnx_initializers(str(path))
    assert set(got) == set(want) == set(arrays)
    for k in arrays:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got[k], arrays[k])


def test_speaker_encoder_from_onnx_matches_jax(models, tmp_path):
    """campplus.onnx written from a seeded CAM++ (drawn BatchNorm running
    statistics) through the JAX plan: the port's ``from_onnx`` against the
    JAX ``SpeakerEncoder`` on the same initializers, 1e-5."""
    jcfg, _, params, _, _ = models["campplus"]
    sd = reference_sd_from_jax("campplus", jcfg, params)
    path = tmp_path / "campplus.onnx"
    path.write_bytes(onnx_bytes(sd))
    jparams, unused = JK.convert_campplus_state_dict(
        JO.load_onnx_initializers(str(path)), jcfg)
    assert unused == []
    jspk = JCam.SpeakerEncoder(jparams, JCam.CAMPPlus(**CAM_KW))
    with torch.device("meta"):
        model = TCam.CAMPPlus(**CAM_KW)
    tspk = TCam.SpeakerEncoder.from_onnx(str(path), model, device="cpu")
    wav = (np.random.RandomState(5).randn(16000) * 0.1).astype(np.float32)
    want = jspk(wav)
    got = tspk(wav)
    assert got.shape == want.shape == (1, CAM_KW["embedding_size"])
    assert float(np.abs(want).max()) > 0.1
    np.testing.assert_allclose(got, want, atol=FORWARD_ATOL, rtol=0)


REFERENCE_YAML = """
sample_rate: 24000
flow: !new:cosyvoice.flow.flow.CausalMaskedDiffWithXvec
    input_size: 512
    output_size: 80
    spk_embed_dim: 192
    vocab_size: 16384
    input_frame_rate: 12.5
    token_mel_ratio: 4
    pre_lookahead_len: 3
    encoder: !new:cosyvoice.transformer.upsample_encoder.UpsampleConformerEncoder
        output_size: 512
        attention_heads: 8
        linear_units: 2048
        num_blocks: 6
        input_size: 512
        use_cnn_module: False
        macaron_style: False
        static_chunk_size: 25
        upsample_stride: 4
    decoder: !new:cosyvoice.flow.flow_matching.CausalConditionalCFM
        in_channels: 240
        cfm_params: !new:omegaconf.DictConfig
            content:
                sigma_min: 1e-06
                t_scheduler: cosine
                training_cfg_rate: 0.2
                inference_cfg_rate: 0.7
        estimator: !new:cosyvoice.flow.decoder.CausalConditionalDecoder
            in_channels: 320
            out_channels: 80
            channels: [256]
            attention_head_dim: 64
            n_blocks: 4
            num_mid_blocks: 12
            num_heads: 8
            act_fn: gelu
            static_chunk_size: 50
hift: !new:cosyvoice.hifigan.generator.HiFTGenerator
    in_channels: 80
    base_channels: 512
    nb_harmonics: 8
    sampling_rate: 24000
    upsample_rates: [8, 5, 3]
    upsample_kernel_sizes: [16, 11, 7]
    istft_params:
        n_fft: 16
        hop_len: 4
"""


def test_reference_yaml_configs_equal_jax(tmp_path):
    """The yaml of the JAX package's ``test_reference_yaml_parsing``: the
    port's configs equal the JAX package's field for field, and the MOSS
    presets."""
    y = tmp_path / "config.yaml"
    y.write_text(REFERENCE_YAML)
    tf, th = TR.configs_from_reference_yaml(str(y))
    jf, jh = JR.configs_from_reference_yaml(str(y))
    assert dataclasses.asdict(tf) == dataclasses.asdict(jf)
    assert dataclasses.asdict(th) == dataclasses.asdict(jh)
    assert tf.estimator.causal and th.total_upsample == 480
    assert tf.encoder == TC.moss_flow_config().encoder
    assert th == TC.moss_hift_config()
    raw = TR.load_reference_yaml(str(y))
    assert raw["flow"]["__class__"] == "cosyvoice.flow.flow.CausalMaskedDiffWithXvec"


def test_reference_yaml_refuses_another_flow(tmp_path):
    y = tmp_path / "config.yaml"
    y.write_text("flow: !new:some.OtherModel\n  vocab_size: 3\n")
    with pytest.raises(ValueError, match="MaskedDiffWithXvec"):
        TR.flow_config_from_reference(TR.load_reference_yaml(str(y)))
