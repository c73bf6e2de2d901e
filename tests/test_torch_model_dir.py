"""``model_dir.load_model_dir`` of the port against the JAX package's, f32 on
the CPU, on one tiny reference-layout directory: ``config.yaml`` (the tiny
flow and HiFT configs), ``flow.pt``, ``hift.pt`` (``generator.`` prefix),
``spk2info.pt`` and ``speech_tokenizer/`` (``config.json`` and
``model.safetensors``, ``encoder.`` prefix and a post-VQ key), the
checkpoints written from seeded flax params through the JAX package's
plan:

- the configs parsed equal field for field, the unused-key reports equal;
- ``token2wav`` of the loaded decoders within 1e-4 (the port's NSF source
  given the JAX draws), with and without a cached speaker's prompt;
- the spk2info prompts equal; the tokenizer loaded through the port's
  safetensors reader equal to the JAX one's weights;
- a missing ``flow.pt`` raises ``FileNotFoundError`` in both;
- a CosyVoice-v1 directory (``config.yaml`` with a ``MaskedDiffWithXvec``
  flow and a 22.05 kHz HiFT, the tiny v1 topology of
  ``test_torch_flow_v1``; ``flow.pt`` written from flax params through the
  JAX package's ``flow_v1`` plan, since the reference's torch modules are
  not in the repository) loads into a ``V1Decoder`` whose ``token2wav``
  (with and without a prompt) and ``stream_inference`` are within 1e-4 of
  the JAX package's, and ``flow_version="v1"`` overrides a yaml that names
  the v2 flow;
- ``bin/inference.py --mode decode`` on the directory writes the
  ``token2wav`` wav (through ``build_decoder``), and with
  ``--flow_version v1`` on the v1 directory the ``V1Decoder``'s, offline
  and ``--streaming``; ``--mode reconstruct`` (the directory's tokenizer,
  offline and ``--streaming --engine kv``) writes the audio of the tokens
  it encodes.

Torch runs on one thread here, as in the other port test modules."""

import dataclasses
import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from moss_speech_decoder_cosy_tpu import model_dir as JMD
from moss_speech_decoder_cosy_tpu.models.flow import (
    CausalMaskedDiffWithXvec as JFlow)
from moss_speech_decoder_cosy_tpu.models.hift import HiFTGenerator as JHiFT
from moss_speech_decoder_cosy_tpu.tokenizer import model as JT
from moss_speech_decoder_cosy_tpu.tokenizer import tiny_tokenizer_config
from moss_speech_decoder_cosy_tpu.utils import config as JC
from moss_speech_decoder_cosy_tpu.utils.config import (
    tiny_flow_config, tiny_hift_config)
from moss_speech_decoder_cosy_torch import model_dir as TMD
from moss_speech_decoder_cosy_torch.bin import inference as TI
from moss_speech_decoder_cosy_torch.tokenizer import config as TTC
from moss_speech_decoder_cosy_torch.weights import tokenizer_state_from_jax

from test_torch_checkpoint import reference_sd_from_jax
from test_torch_flow_v1 import N_MEL, SPK, init_v1, tiny_v1_config
from test_torch_hift import jax_phase_draws

WAV_ATOL = 1e-4

CONFIG_YAML = """\
sample_rate: 24000
flow: !new:cosyvoice.flow.flow.CausalMaskedDiffWithXvec
  vocab_size: {f.vocab_size}
  input_size: {f.input_size}
  output_size: {f.output_size}
  spk_embed_dim: {f.spk_embed_dim}
  input_frame_rate: {f.input_frame_rate}
  token_mel_ratio: {f.token_mel_ratio}
  pre_lookahead_len: {f.pre_lookahead_len}
  encoder: !new:cosyvoice.transformer.upsample_encoder.UpsampleConformerEncoder
    input_size: {e.input_size}
    output_size: {e.output_size}
    attention_heads: {e.attention_heads}
    linear_units: {e.linear_units}
    num_blocks: {e.num_blocks}
    num_up_blocks: {e.num_up_blocks}
    static_chunk_size: {e.static_chunk_size}
    upsample_stride: {e.upsample_stride}
    dropout_rate: 0.0
  decoder: !new:cosyvoice.flow.flow_matching.CausalConditionalCFM
    cfm_params: !new:omegaconf.DictConfig
      content:
        sigma_min: 1e-06
        t_scheduler: cosine
        training_cfg_rate: 0.2
        inference_cfg_rate: 0.7
    estimator: !new:cosyvoice.flow.decoder.CausalConditionalDecoder
      in_channels: {s.in_channels}
      out_channels: {s.out_channels}
      channels: {channels}
      attention_head_dim: {s.attention_head_dim}
      n_blocks: {s.n_blocks}
      num_mid_blocks: {s.num_mid_blocks}
      num_heads: {s.num_heads}
      static_chunk_size: {s.static_chunk_size}
hift: !new:cosyvoice.hifigan.generator.HiFTGenerator
  in_channels: {h.in_channels}
  base_channels: {h.base_channels}
  nb_harmonics: {h.nb_harmonics}
  sampling_rate: {h.sampling_rate}
  upsample_rates: {ups}
  upsample_kernel_sizes: {upk}
  istft_params:
    n_fft: {h.istft_n_fft}
    hop_len: {h.istft_hop_len}
  resblock_kernel_sizes: {rk}
  resblock_dilation_sizes: {rd}
  source_resblock_kernel_sizes: {sk}
  source_resblock_dilation_sizes: {sd}
  f0_predictor: !new:cosyvoice.hifigan.f0_predictor.ConvRNNF0Predictor
    num_class: 1
    in_channels: {h.in_channels}
    cond_channels: {h.f0_cond_channels}
"""


def _yaml(flow_cfg, hift_cfg) -> str:
    j = lambda x: json.dumps(  # noqa: E731
        [list(d) if isinstance(d, tuple) else d for d in x])
    return CONFIG_YAML.format(
        f=flow_cfg, e=flow_cfg.encoder, s=flow_cfg.estimator, h=hift_cfg,
        channels=j(flow_cfg.estimator.channels),
        ups=j(hift_cfg.upsample_rates), upk=j(hift_cfg.upsample_kernel_sizes),
        rk=j(hift_cfg.resblock_kernel_sizes),
        rd=j(hift_cfg.resblock_dilation_sizes),
        sk=j(hift_cfg.source_resblock_kernel_sizes),
        sd=j(hift_cfg.source_resblock_dilation_sizes))


def jax_draws(harmonics, length, device):
    k_ini, k_noise = jax.random.split(jax.random.PRNGKey(0))
    rand_ini = jax.random.uniform(k_ini, (1, harmonics), dtype=jnp.float32)
    noise = jax.random.normal(k_noise, (1, length, harmonics), jnp.float32)
    return (torch.from_numpy(np.array(rand_ini)).to(device),
            torch.from_numpy(np.array(noise)).to(device))


def _torch_sd(sd, prefix=""):
    return {prefix + k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """The tiny reference-layout directory and the tokenizer's flax
    params."""
    path = tmp_path_factory.mktemp("model_dir")
    fcfg, hcfg = tiny_flow_config(), tiny_hift_config()
    fp = jax.jit(JFlow(fcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
        jnp.ones((1, 8), bool), jnp.zeros((1, 0, fcfg.output_size)),
        jnp.zeros((1, fcfg.spk_embed_dim)))
    hp = jax.jit(JHiFT(hcfg).init)(jax.random.PRNGKey(1),
                                   jnp.zeros((1, 8, hcfg.in_channels)))
    hp = jax.tree_util.tree_map_with_path(
        lambda p, a: a * 200.0 if "conv_post" in str(p)
        and str(p[-1]) == "['g']" else a, hp)
    tcfg = tiny_tokenizer_config()
    tp = jax.tree.map(np.asarray, jax.jit(JT.WhisperVQEncoder(tcfg).init)(
        jax.random.PRNGKey(2), jnp.zeros((1, 16, tcfg.num_mel_bins)),
        jnp.ones((1, 16), bool)))
    torch.save(_torch_sd(reference_sd_from_jax(
        "flow", fcfg, jax.tree.map(np.asarray, fp))), path / "flow.pt")
    torch.save(_torch_sd(reference_sd_from_jax(
        "hift", hcfg, jax.tree.map(np.asarray, hp)), "generator."),
        path / "hift.pt")
    (path / "config.yaml").write_text(_yaml(fcfg, hcfg))
    rng = np.random.RandomState(3)
    torch.save({"alice": {"embedding": torch.zeros(1, fcfg.spk_embed_dim)},
                "bob": {"flow_embedding": torch.from_numpy(
                            rng.randn(1, fcfg.spk_embed_dim)
                            .astype(np.float32)),
                        "flow_prompt_speech_token": torch.from_numpy(
                            rng.randint(0, fcfg.vocab_size, (1, 3))),
                        "prompt_speech_feat": torch.from_numpy(
                            (rng.randn(1, 12, fcfg.output_size) * 0.1)
                            .astype(np.float32))}},
               path / "spk2info.pt")
    tok_dir = path / "speech_tokenizer"
    tok_dir.mkdir()
    (tok_dir / "config.json").write_text(json.dumps(dict(
        num_mel_bins=tcfg.num_mel_bins, d_model=tcfg.d_model,
        encoder_attention_heads=tcfg.attention_heads,
        encoder_ffn_dim=tcfg.ffn_dim, encoder_layers=tcfg.encoder_layers,
        quantize_position=tcfg.quantize_position,
        pooling_position=tcfg.pooling_position,
        quantize_vocab_size=tcfg.quantize_vocab_size,
        max_source_positions=tcfg.max_source_positions,
        decoder_layers=tcfg.decoder_layers,
        decoder_attention_heads=tcfg.decoder_attention_heads,
        decoder_ffn_dim=tcfg.decoder_ffn_dim, vocab_size=tcfg.vocab_size,
        max_target_positions=tcfg.max_target_positions)))
    from safetensors.torch import save_file
    tok_sd = _torch_sd(reference_sd_from_jax("tokenizer", tcfg, tp),
                       "encoder.")
    tok_sd["encoder.embed_positions2.weight"] = torch.zeros(4, tcfg.d_model)
    save_file(tok_sd, str(tok_dir / "model.safetensors"))
    return path, tp


@pytest.fixture(scope="module")
def loaded(model_dir):
    path, _ = model_dir
    jmd = JMD.load_model_dir(str(path), verbose=False)
    tmd = TMD.load_model_dir(str(path), device="cpu", verbose=False)
    tmd.decoder.hift.draws = jax_draws
    return jmd, tmd


def test_configs_and_reports_equal_jax(loaded, model_dir):
    jmd, tmd = loaded
    assert tmd.flow_version == jmd.flow_version == "v2"
    assert dataclasses.asdict(tmd.flow_cfg) == dataclasses.asdict(
        jmd.flow_cfg)
    assert dataclasses.asdict(tmd.hift_cfg) == dataclasses.asdict(
        jmd.hift_cfg)
    assert tmd.report == jmd.report
    assert tmd.report == {"flow_unused": 0, "hift_unused": 0,
                          "tokenizer_unused": 0}
    # the tokenizer through the port's safetensors reader
    _, tp = model_dir
    want = tokenizer_state_from_jax(tp)
    got = tmd.codec.tokenizer.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    tcfg = tmd.codec.tok_cfg
    for f in dataclasses.fields(tcfg):
        assert getattr(tcfg, f.name) == getattr(jmd.codec.tok_cfg, f.name)
    assert tmd.speaker_encoder is None and jmd.speaker_encoder is None


@pytest.mark.parametrize("speaker", [None, "bob"])
def test_token2wav_matches_jax(loaded, speaker):
    jmd, tmd = loaded
    tokens = np.random.RandomState(4).randint(
        0, tmd.flow_cfg.vocab_size, (1, 10))
    args = ()
    if speaker is not None:
        jp, tp = jmd.prompt(speaker), tmd.prompt(speaker)
        for a in ("token", "feat", "embedding"):
            np.testing.assert_array_equal(getattr(tp, a), getattr(jp, a))
        args = (tp.token, tp.feat, tp.embedding)
    got = tmd.decoder.token2wav(tokens, *args)
    want = np.asarray(jmd.decoder.token2wav(tokens, *args))
    assert got.shape == want.shape == (
        1, 10 * tmd.decoder.ratio * tmd.hift_cfg.total_upsample)
    assert float(np.abs(want).max()) > 0.05, "trivial waveform"
    np.testing.assert_allclose(got, want, atol=WAV_ATOL, rtol=0)


def test_prompts_equal_jax(loaded):
    jmd, tmd = loaded
    for spk in ("alice", "bob"):
        jp, tp = jmd.prompt(spk), tmd.prompt(spk)
        for a in ("token", "feat", "embedding"):
            assert getattr(tp, a).dtype == getattr(jp, a).dtype
            np.testing.assert_array_equal(getattr(tp, a), getattr(jp, a))
    assert tmd.prompt("alice").token.shape == (1, 0)


def test_missing_checkpoint_raises_as_jax(tmp_path, model_dir):
    path, _ = model_dir
    (tmp_path / "hift.pt").write_bytes((path / "hift.pt").read_bytes())
    with pytest.raises(FileNotFoundError):
        JMD.load_model_dir(str(tmp_path), verbose=False)
    with pytest.raises(FileNotFoundError, match="flow.pt"):
        TMD.load_model_dir(str(tmp_path), device="cpu", verbose=False)


V1_YAML = """\
sample_rate: 22050
flow: !new:cosyvoice.flow.flow.MaskedDiffWithXvec
  vocab_size: {f.vocab_size}
  input_size: {f.input_size}
  output_size: {f.output_size}
  spk_embed_dim: {f.spk_embed_dim}
  input_frame_rate: {f.input_frame_rate}
  encoder: !new:cosyvoice.transformer.encoder.ConformerEncoder
    input_size: {e.input_size}
    output_size: {e.output_size}
    attention_heads: {e.attention_heads}
    linear_units: {e.linear_units}
    num_blocks: {e.num_blocks}
    dropout_rate: 0.0
    pos_enc_layer_type: rel_pos_espnet
    macaron_style: false
    use_cnn_module: false
  length_regulator: !new:cosyvoice.flow.length_regulator.InterpolateRegulator
    channels: {f.output_size}
    sampling_ratios: [1, 1, 1, 1]
  decoder: !new:cosyvoice.flow.flow_matching.ConditionalCFM
    cfm_params: !new:omegaconf.DictConfig
      content:
        sigma_min: 1e-06
        t_scheduler: cosine
        training_cfg_rate: 0.2
        inference_cfg_rate: 0.7
    estimator: !new:cosyvoice.flow.decoder.ConditionalDecoder
      in_channels: {s.in_channels}
      out_channels: {s.out_channels}
      channels: {channels}
      attention_head_dim: {s.attention_head_dim}
      n_blocks: {s.n_blocks}
      num_mid_blocks: {s.num_mid_blocks}
      num_heads: {s.num_heads}
hift: !new:cosyvoice.hifigan.generator.HiFTGenerator
  in_channels: {h.in_channels}
  base_channels: {h.base_channels}
  nb_harmonics: {h.nb_harmonics}
  sampling_rate: {h.sampling_rate}
  upsample_rates: {ups}
  upsample_kernel_sizes: {upk}
  istft_params:
    n_fft: {h.istft_n_fft}
    hop_len: {h.istft_hop_len}
  resblock_kernel_sizes: {rk}
  resblock_dilation_sizes: {rd}
  source_resblock_kernel_sizes: {sk}
  source_resblock_dilation_sizes: {sd}
  f0_predictor: !new:cosyvoice.hifigan.f0_predictor.ConvRNNF0Predictor
    num_class: 1
    in_channels: {h.in_channels}
    cond_channels: {h.f0_cond_channels}
"""


def _v1_yaml(flow_cfg, hift_cfg) -> str:
    j = lambda x: json.dumps(  # noqa: E731
        [list(d) if isinstance(d, tuple) else d for d in x])
    return V1_YAML.format(
        f=flow_cfg, e=flow_cfg.encoder, s=flow_cfg.estimator, h=hift_cfg,
        channels=j(flow_cfg.estimator.channels),
        ups=j(hift_cfg.upsample_rates), upk=j(hift_cfg.upsample_kernel_sizes),
        rk=j(hift_cfg.resblock_kernel_sizes),
        rd=j(hift_cfg.resblock_dilation_sizes),
        sk=j(hift_cfg.source_resblock_kernel_sizes),
        sd=j(hift_cfg.source_resblock_dilation_sizes))


@pytest.fixture(scope="module")
def v1_dir(tmp_path_factory):
    """A tiny v1 directory: config.yaml, flow.pt, hift.pt (22.05 kHz)."""
    path = tmp_path_factory.mktemp("v1_dir")
    fcfg = tiny_v1_config(JC)
    hcfg = dataclasses.replace(tiny_hift_config(), in_channels=N_MEL,
                               sampling_rate=22050)
    _, fp = init_v1(fcfg, seed=30)
    hp = jax.jit(JHiFT(hcfg).init)(jax.random.PRNGKey(31),
                                   jnp.zeros((1, 8, N_MEL)))
    hp = jax.tree_util.tree_map_with_path(
        lambda p, a: a * 200.0 if "conv_post" in str(p)
        and str(p[-1]) == "['g']" else a, hp)
    torch.save(_torch_sd(reference_sd_from_jax("flow_v1", fcfg, fp)),
               path / "flow.pt")
    torch.save(_torch_sd(reference_sd_from_jax(
        "hift", hcfg, jax.tree.map(np.asarray, hp)), "generator."),
        path / "hift.pt")
    (path / "config.yaml").write_text(_v1_yaml(fcfg, hcfg))
    return path


@pytest.fixture(scope="module")
def v1_loaded(v1_dir):
    jmd = JMD.load_model_dir(str(v1_dir), verbose=False)
    tmd = TMD.load_model_dir(str(v1_dir), device="cpu", verbose=False)
    tmd.decoder.hift.draws = jax_phase_draws
    return jmd, tmd


@pytest.mark.parametrize("prompt", [False, True])
def test_v1_directory_loads_and_decodes_as_jax(v1_loaded, prompt):
    jmd, tmd = v1_loaded
    assert tmd.flow_version == jmd.flow_version == "v1"
    assert isinstance(tmd.decoder, TMD.V1Decoder)
    assert dataclasses.asdict(tmd.flow_cfg) == dataclasses.asdict(
        jmd.flow_cfg)
    assert dataclasses.asdict(tmd.hift_cfg) == dataclasses.asdict(
        jmd.hift_cfg)
    assert tmd.report == jmd.report == {"flow_unused": 0, "hift_unused": 0}
    assert tmd.decoder.ratio == jmd.decoder.ratio
    rng = np.random.RandomState(32)
    tokens = rng.randint(0, tmd.flow_cfg.vocab_size, (1, 30))
    args = ()
    if prompt:
        args = (rng.randint(0, tmd.flow_cfg.vocab_size, (1, 6)),
                (rng.randn(1, 10, N_MEL) * 0.5).astype(np.float32),
                rng.randn(1, SPK).astype(np.float32))
    got = tmd.decoder.token2wav(tokens, *args)
    want = np.asarray(jmd.decoder.token2wav(tokens, *args))
    n_mel = tmd.decoder.mel_len(30)
    assert got.shape == want.shape == (
        1, n_mel * tmd.hift_cfg.total_upsample)
    assert float(np.abs(want).max()) > 0.05, "trivial waveform"
    np.testing.assert_allclose(got, want, atol=WAV_ATOL, rtol=0)
    got_s = tmd.decoder.stream_inference(tokens, *args)
    want_s = np.asarray(jmd.decoder.stream_inference(tokens, *args))
    assert got_s.shape == want_s.shape
    np.testing.assert_allclose(got_s, want_s, atol=WAV_ATOL, rtol=0)


def test_flow_version_v1_overrides_a_v2_yaml(tmp_path, v1_dir, v1_loaded):
    """A yaml that names the v2 flow class loads as v2 (and the v1 weights
    miss its keys); ``flow_version="v1"`` loads the same directory as the
    v1 one."""
    for f in ("flow.pt", "hift.pt"):
        (tmp_path / f).write_bytes((v1_dir / f).read_bytes())
    (tmp_path / "config.yaml").write_text(
        (v1_dir / "config.yaml").read_text().replace(
            "cosyvoice.flow.flow.MaskedDiffWithXvec",
            "cosyvoice.flow.flow.CausalMaskedDiffWithXvec"))
    with pytest.raises(KeyError, match="pre_lookahead_layer"):
        TMD.load_model_dir(str(tmp_path), device="cpu", verbose=False)
    md = TMD.load_model_dir(str(tmp_path), flow_version="v1", device="cpu",
                            verbose=False)
    assert md.flow_version == "v1" and isinstance(md.decoder, TMD.V1Decoder)
    md.decoder.hift.draws = jax_phase_draws
    tokens = np.arange(20)[None] % md.flow_cfg.vocab_size
    _, ref = v1_loaded
    np.testing.assert_array_equal(md.decoder.token2wav(tokens),
                                  ref.decoder.token2wav(tokens))


def test_load_model_dir_needs_a_card_by_default(model_dir):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TMD.load_model_dir(str(model_dir[0]), verbose=False)


def test_inference_cli_decode(tmp_path, loaded, model_dir):
    """``bin/inference.py --mode decode`` on the directory: the wav it
    writes is the port's ``token2wav`` of the same tokens as 16-bit PCM."""
    from scipy.io import wavfile
    jmd, tmd = loaded
    path, _ = model_dir
    tokens = np.random.RandomState(6).randint(0, tmd.flow_cfg.vocab_size,
                                              (12,))
    (tmp_path / "tokens.json").write_text(json.dumps(tokens.tolist()))
    out = tmp_path / "out.wav"
    TI.main(["--mode", "decode", "--model_dir", str(path), "--input",
             str(tmp_path / "tokens.json"), "--output", str(out),
             "--device", "cpu"])
    sr, got = wavfile.read(out)
    fresh = TMD.load_model_dir(str(path), device="cpu", verbose=False)
    want = fresh.decoder.token2wav(tokens[None])[0]
    assert sr == tmd.hift_cfg.sampling_rate and got.dtype == np.int16
    np.testing.assert_array_equal(
        got, (np.clip(want, -1, 1) * 32767.0).astype(np.int16))


def test_inference_cli_decode_v1(tmp_path, v1_dir):
    """``--flow_version v1 --mode decode`` on the v1 directory: the
    ``V1Decoder``'s ``token2wav`` at 22.05 kHz, and with ``--streaming`` its
    ``stream_inference``, as 16-bit PCM."""
    from scipy.io import wavfile
    tokens = np.random.RandomState(33).randint(0, 64, (30,))
    np.save(tmp_path / "tokens.npy", tokens)
    fresh = TMD.load_model_dir(str(v1_dir), device="cpu", verbose=False)
    for extra, call in (([], fresh.decoder.token2wav),
                        (["--streaming"], fresh.decoder.stream_inference)):
        out = tmp_path / "out.wav"
        TI.main(["--mode", "decode", "--flow_version", "v1", "--model_dir",
                 str(v1_dir), "--input", str(tmp_path / "tokens.npy"),
                 "--output", str(out), "--device", "cpu"] + extra)
        sr, got = wavfile.read(out)
        want = call(tokens[None])[0]
        assert sr == 22050 and got.dtype == np.int16
        np.testing.assert_array_equal(
            got, (np.clip(want, -1, 1) * 32767.0).astype(np.int16))


def test_inference_cli_reconstruct(tmp_path, loaded, model_dir):
    """``--mode reconstruct``: the wav through the directory's tokenizer
    (``build_codec`` takes the model directory's codec), then
    ``token2wav``; ``--streaming --engine kv`` through the KV session."""
    from scipy.io import wavfile
    _, tmd = loaded
    path, _ = model_dir
    rng = np.random.RandomState(7)
    wav = (rng.randn(16000) * 0.2).astype(np.float32)
    wavfile.write(tmp_path / "in.wav", 16000, (wav * 32767).astype(np.int16))
    fresh = TMD.load_model_dir(str(path), device="cpu", verbose=False)
    from moss_speech_decoder_cosy_torch.eval.audio_io import read_wav
    x, _ = read_wav(str(tmp_path / "in.wav"))
    tokens = fresh.codec.encode(x)
    n = tokens.shape[1] * tmd.decoder.ratio * tmd.hift_cfg.total_upsample
    for extra in ([], ["--streaming", "--engine", "kv"]):
        out = tmp_path / "out.wav"
        TI.main(["--mode", "reconstruct", "--model_dir", str(path),
                 "--input", str(tmp_path / "in.wav"), "--output", str(out),
                 "--device", "cpu"] + extra)
        sr, got = wavfile.read(out)
        assert sr == 24000 and got.shape == (n,) and np.abs(got).max() > 0
        if not extra:
            want = fresh.decoder.token2wav(tokens)[0]
            np.testing.assert_array_equal(
                got, (np.clip(want, -1, 1) * 32767.0).astype(np.int16))


def test_v1_yaml_parses_as_jax_and_resolves_refs(tmp_path):
    """The v1 yaml gives the JAX package's configs; with the published
    configs' ``!ref <sample_rate>`` (on which the JAX loader fails) the
    port reads the top-level value."""
    from moss_speech_decoder_cosy_tpu.utils import ref_config as JR
    from moss_speech_decoder_cosy_torch.utils import ref_config as TR
    text = _v1_yaml(tiny_v1_config(JC), dataclasses.replace(
        tiny_hift_config(), in_channels=N_MEL, sampling_rate=22050))
    y = tmp_path / "config.yaml"
    y.write_text(text)
    tf, th = TR.configs_from_reference_yaml(str(y))
    jf, jh = JR.configs_from_reference_yaml(str(y))
    assert dataclasses.asdict(tf) == dataclasses.asdict(jf)
    assert dataclasses.asdict(th) == dataclasses.asdict(jh)
    assert not tf.estimator.causal and th.sampling_rate == 22050
    assert tf.encoder.pos_enc_layer_type == "rel_pos_espnet"
    y.write_text(text.replace("  sampling_rate: 22050",
                              "  sampling_rate: !ref <sample_rate>"))
    rf, rh = TR.configs_from_reference_yaml(str(y))
    assert (rf, rh) == (tf, th)


def test_codec_decodes_through_v1_decoder_as_jax(model_dir, v1_loaded):
    """``SpeechCodec`` over a ``V1Decoder``: ``decode`` and
    ``convert_voice`` with a v1 prompt within 1e-4 of the JAX codec over
    the JAX ``V1Decoder``."""
    from moss_speech_decoder_cosy_tpu.codec import (
        Prompt as JPrompt, SpeechCodec as JCodec)
    from moss_speech_decoder_cosy_torch.codec import (
        Prompt as TPrompt, SpeechCodec as TCodec)
    _, tp = model_dir
    jmd, tmd = v1_loaded
    tcfg = tiny_tokenizer_config()
    jc = JCodec(tcfg, tp, jmd.decoder)
    tc = TCodec(TTC.tiny_tokenizer_config(), tokenizer_state_from_jax(tp),
                tmd.decoder, device="cpu")
    rng = np.random.RandomState(34)
    tokens = rng.randint(0, 64, (1, 25))
    np.testing.assert_allclose(tc.decode(tokens),
                               np.asarray(jc.decode(tokens)),
                               atol=WAV_ATOL, rtol=0)
    p = (rng.randint(0, 64, (1, 4)),
         (rng.randn(1, 7, N_MEL) * 0.5).astype(np.float32),
         rng.randn(1, SPK).astype(np.float32))
    wav = (rng.randn(16000) * 0.2).astype(np.float32)
    got = tc.convert_voice(wav, TPrompt(*p))
    want = np.asarray(jc.convert_voice(wav, JPrompt(*p)))
    assert got.shape == want.shape and got.shape[1] > 0
    np.testing.assert_allclose(got, want, atol=WAV_ATOL, rtol=0)
