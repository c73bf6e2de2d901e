"""The port's eval harness (``eval/{rtf,score,benchmark}.py``,
``bin/{benchmark,score,validate_reference}.py``) against the JAX package's
at tiny configs, f32 on the CPU.  Mirrors ``tests/test_eval.py``:

- WAV IO, resampling, the WER and similarity metrics equal to JAX's;
- the scoring plumbing with deterministic stand-in models: per-sample
  scores, corpus WER, SIM and ``result.json`` equal to JAX's;
- ``run_seed_tts_benchmark`` over the port's tiny ``SpeechCodec``: the
  Seed-TTS layout, tokens equal to the JAX codec's, resume by existence, a
  failing sample counted and the shard kept alive; with ``score=True`` the
  run scored by the port's ASR and CAM++, and the same run scored by the
  JAX stack (its codec, ASR and CAM++ with the same weights): WER equal,
  SIM within 1e-5, ``result.json`` alike;
- ``bin.benchmark.build_asr`` from a reference-named tokenizer file equal
  to the JAX ``build_asr``'s transcriber; ``bin.validate_reference`` on
  tiny reference files;
- the RTF harness.

Torch runs on one thread here, as in the other port test modules."""

import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from moss_speech_decoder_cosy_tpu import codec as JC
from moss_speech_decoder_cosy_tpu.eval import audio_io as JIO
from moss_speech_decoder_cosy_tpu.eval import score as JS
from moss_speech_decoder_cosy_tpu.models import campplus as JCam
from moss_speech_decoder_cosy_tpu.models.flow import CausalMaskedDiffWithXvec
from moss_speech_decoder_cosy_tpu.models.hift import HiFTGenerator
from moss_speech_decoder_cosy_tpu.ops import melspec as JM
from moss_speech_decoder_cosy_tpu.pipeline import AudioDecoder as JDecoder
from moss_speech_decoder_cosy_tpu.tokenizer import asr_decoder as JA
from moss_speech_decoder_cosy_tpu.tokenizer import model as JT
from moss_speech_decoder_cosy_tpu.tokenizer import tiny_tokenizer_config
from moss_speech_decoder_cosy_tpu.utils.config import (
    PipelineConfig, tiny_flow_config, tiny_hift_config)
from moss_speech_decoder_cosy_torch import codec as TC
from moss_speech_decoder_cosy_torch.eval import audio_io as TIO
from moss_speech_decoder_cosy_torch.eval import benchmark as TB
from moss_speech_decoder_cosy_torch.eval import rtf as TR
from moss_speech_decoder_cosy_torch.eval import score as TS
from moss_speech_decoder_cosy_torch.models import campplus as TCam
from moss_speech_decoder_cosy_torch.ops import melspec as TM
from moss_speech_decoder_cosy_torch.pipeline import AudioDecoder as TDecoder
from moss_speech_decoder_cosy_torch.tokenizer import asr_decoder as TA
from moss_speech_decoder_cosy_torch.tokenizer import config as TTC
from moss_speech_decoder_cosy_torch.utils import config as TCfg
from moss_speech_decoder_cosy_torch.weights import (
    campplus_state_from_jax, flow_state_from_jax, hift_state_from_jax,
    post_vq_state_from_jax, tokenizer_state_from_jax,
    whisper_decoder_state_from_jax)
from test_torch_asr import ladder_noise
from test_torch_checkpoint import reference_sd_from_jax
from test_torch_codec import CAM_KW, _seeded_bn, jax_draws

SR = 24000
SEG_T, MAX_LEN = 8, 8            # MAX_LEN as test_torch_asr's ladder_noise
PIPE = dict(block_size=4, mel_cache_len=4, max_token_len=16)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def stacks():
    """The tiny JAX and port codecs (same tokenizer, flow and HiFT weights;
    the port's NSF source given JAX's draws), CAM++ speaker encoders and
    Whisper ASRs over the codec's codebook, all with the same weights."""
    cfg = tiny_tokenizer_config()
    tp = _np(jax.jit(JT.WhisperVQEncoder(cfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, cfg.num_mel_bins)),
        jnp.ones((1, 16), bool)))
    fcfg, hcfg = tiny_flow_config(), tiny_hift_config()
    fp = _np(jax.jit(CausalMaskedDiffWithXvec(fcfg).init)(
        jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32),
        jnp.ones((1, 8), bool), jnp.zeros((1, 0, fcfg.output_size)),
        jnp.zeros((1, fcfg.spk_embed_dim))))
    hp = _np(jax.jit(HiFTGenerator(hcfg).init)(
        jax.random.PRNGKey(2), jnp.zeros((1, 8, hcfg.in_channels))))
    cam = JCam.CAMPPlus(**CAM_KW)
    cp = _seeded_bn(_np(jax.jit(cam.init)(jax.random.PRNGKey(3),
                                          jnp.zeros((1, 50, 80)))), 4)
    z = jnp.zeros((1, SEG_T, cfg.d_model))
    v0 = jnp.ones((1, SEG_T), bool)
    pp = _np(jax.jit(JA.PostVQEncoder(cfg).init)(jax.random.PRNGKey(5), z, v0))
    dp = _np(jax.jit(JA.WhisperVQDecoder(cfg).init)(
        jax.random.PRNGKey(6), jnp.zeros((1, 8), jnp.int32),
        jnp.ones((1, 8), bool), z, v0))
    mel_kw = dict(n_fft=96, num_mels=fcfg.output_size, sampling_rate=SR,
                  hop_size=48, win_size=96)
    jdec = JDecoder(fcfg, hcfg, fp, hp, PipelineConfig(**PIPE))
    jcodec = JC.SpeechCodec(
        cfg, tp, jdec, speaker_encoder=JCam.SpeakerEncoder(cp, cam),
        segment_seconds=1.28,
        prompt_mel_fn=lambda w: JM.matcha_mel_spectrogram(w, **mel_kw))
    tdec = TDecoder(TCfg.tiny_flow_config(), TCfg.tiny_hift_config(),
                    flow_state_from_jax(fp), hift_state_from_jax(hp),
                    TCfg.PipelineConfig(**PIPE), device="cpu",
                    nsf_draws=jax_draws)
    with torch.device("meta"):
        tcam = TCam.CAMPPlus(**CAM_KW)
    tcodec = TC.SpeechCodec(
        TTC.tiny_tokenizer_config(), tokenizer_state_from_jax(tp), tdec,
        speaker_encoder=TCam.SpeakerEncoder(campplus_state_from_jax(cp),
                                            tcam, device="cpu"),
        segment_seconds=1.28,
        prompt_mel_fn=lambda w: TM.matcha_mel_spectrogram(w, **mel_kw),
        device="cpu")
    codebook = tp["params"]["codebook"]
    asr_kw = dict(bos_id=1, eos_id=2, max_len=MAX_LEN, segment_tokens=SEG_T)
    jasr = JA.WhisperASR(cfg, pp, dp, codebook, **asr_kw)
    tasr = TA.WhisperASR(TTC.tiny_tokenizer_config(),
                         post_vq_state_from_jax(pp),
                         whisper_decoder_state_from_jax(dp), codebook,
                         device="cpu", **asr_kw)
    return dict(cfg=cfg, tp=tp, pp=pp, dp=dp, jcodec=jcodec, tcodec=tcodec,
                jasr=jasr, tasr=tasr)


def _write_bench(root, rng, names=("s1", "s2"), label_s=1.0):
    for name in names:
        d = root / "en" / name
        d.mkdir(parents=True)
        TIO.write_wav(str(d / "prompt.wav"),
                      rng.randn(8000).astype(np.float32) * 0.1, 16000)
        TIO.write_wav(str(d / "label.wav"),
                      rng.randn(int(16000 * label_s)).astype(np.float32)
                      * 0.1, 16000)
        (d / "prompt.txt").write_text("prompt text\n")
        (d / "label.txt").write_text("label text\n")


# ------------------------------------------------------------------- IO
def test_wav_io_and_resampling_equal_jax(tmp_path):
    x = (np.sin(np.linspace(0, 100, 24000)) * 0.5).astype(np.float32)
    TIO.write_wav(str(tmp_path / "t.wav"), x, SR)
    JIO.write_wav(str(tmp_path / "j.wav"), x, SR)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    y, sr = TIO.read_wav(str(tmp_path / "t.wav"))
    assert sr == SR
    np.testing.assert_allclose(x, y, atol=1e-3)
    for a, b in ((24000, 16000), (16000, 24000), (22050, 16000), (8, 8)):
        np.testing.assert_array_equal(TIO.resample(x, a, b),
                                      JIO.resample(x, a, b))
    assert len(TIO.resample(np.zeros(24000, np.float32), SR, 16000)) == 16000


def test_wer_and_similarity_metrics_equal_jax():
    assert TS.edit_distance("kitten", "sitting") == 3
    assert TS.word_error_rate([1, 2, 3, 4], [1, 9, 3, 4]) == 0.25
    rng = np.random.RandomState(0)
    cases = [("kitten", "sitting"), ([], [1, 2]), ([1], []), ("abc", "abc"),
             ([], [])] + [(list(rng.randint(0, 4, rng.randint(0, 9))),
                           list(rng.randint(0, 4, rng.randint(0, 9))))
                          for _ in range(20)]
    for ref, hyp in cases:
        assert TS.edit_distance(ref, hyp) == JS.edit_distance(ref, hyp)
        assert TS.word_error_rate(ref, hyp) == JS.word_error_rate(ref, hyp)
    a = np.array([1.0, 0.0, 0.0])
    for b in (3 * a, [0.0, 1.0, 0.0], np.zeros(3), rng.randn(3)):
        assert TS.speaker_similarity(a, b) == JS.speaker_similarity(a, b)
    assert abs(TS.speaker_similarity(a, 3 * a) - 1.0) < 1e-12


def _fake_units(wav):
    """wav -> units: the same wav gives the same units."""
    w = np.asarray(wav, np.float64).reshape(-1)
    chunks = w[: len(w) // 100 * 100].reshape(-1, 100)
    return tuple((np.abs(chunks).mean(1) * 1e4).astype(np.int64) % 97)


def _fake_embed(wav):
    w = np.asarray(wav, np.float64).reshape(-1)
    n = len(w) // 4 * 4
    return w[:n].reshape(4, -1).std(axis=1)


def test_score_plumbing_equals_jax(tmp_path):
    """The JAX test's run (a perfect-copy and a corrupted sample) scored by
    both scorers with the same stand-in models: equal results; the prompt
    recovered from ``prompt_concat_pred.wav`` without a benchmark layout;
    ``result.json`` merged per language."""
    rng = np.random.RandomState(3)
    bench, save = tmp_path / "bench" / "en", tmp_path / "out" / "en"
    prompt = rng.randn(4800).astype(np.float32) * 0.1
    for name, corrupt in (("good", False), ("bad", True)):
        (bench / name).mkdir(parents=True)
        label = rng.randn(9600).astype(np.float32) * 0.1
        TIO.write_wav(str(bench / name / "prompt.wav"), prompt, SR)
        TIO.write_wav(str(bench / name / "label.wav"), label, SR)
        (save / name).mkdir(parents=True)
        pred = rng.randn(9600).astype(np.float32) * 0.3 if corrupt else label
        pwav = rng.randn(4800).astype(np.float32) * 0.3 if corrupt else prompt
        TIO.write_wav(str(save / name / "pred.wav"), pred, SR)
        TIO.write_wav(str(save / name / "prompt_concat_pred.wav"),
                      np.concatenate([pwav, pred]), SR)
    kw = dict(transcribe_fn=_fake_units, speaker_fn=_fake_embed,
              benchmark_dir=str(tmp_path / "bench"))
    got = TS.score_seed_tts_run(str(tmp_path / "out"), "en", **kw)
    want = JS.score_seed_tts_run(str(tmp_path / "out"), "en", **kw)
    assert got == want
    assert got["per_sample"]["good"] == {"wer": 0.0,
                                         "sim": got["per_sample"]["good"]
                                         ["sim"]}
    assert got["per_sample"]["good"]["sim"] > 0.999
    assert got["per_sample"]["bad"]["wer"] > 0.0 and got["wer"] > 0.0
    got2 = TS.score_seed_tts_run(str(tmp_path / "out"), "en",
                                 speaker_fn=_fake_embed)
    assert got2 == JS.score_seed_tts_run(str(tmp_path / "out"), "en",
                                         speaker_fn=_fake_embed)
    assert got2["wer"] is None and got2["per_sample"]["good"]["sim"] > 0.999
    path = TS.write_result_json(str(tmp_path / "out"), {"en": got})
    TS.write_result_json(str(tmp_path / "out"),
                         {"zh": {"wer": 0.1, "sim": 0.9, "n": 1}})
    merged = json.loads((tmp_path / "out" / "result.json").read_text())
    assert set(merged) == {"en", "zh"} and path.endswith("result.json")
    assert merged["en"] == {"wer": want["wer"], "sim": want["sim"], "n": 2}


# --------------------------------------------------------- the benchmark
@pytest.fixture(scope="module")
def scored_run(stacks, tmp_path_factory):
    """The port's benchmark over two seeded samples with ``score=True``,
    then a resume of the same run."""
    root = tmp_path_factory.mktemp("seedtts")
    _write_bench(root / "bench", np.random.RandomState(0))
    c = stacks["tcodec"]
    # the random ASR fails the ladder's gates, so transcripts are sampled:
    # the port's transcriber is fed JAX's draws (each call's PRNGKey(0))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TA, "counter_gumbel", ladder_noise(
            jax.random.PRNGKey(0), 3, 6, stacks["cfg"].vocab_size))
        stats = TB.run_seed_tts_benchmark(c, str(root / "bench"),
                                          str(root / "out"), lang="en",
                                          block_size=4, max_token_len=16,
                                          score=True, asr=stacks["tasr"])
    again = TB.run_seed_tts_benchmark(c, str(root / "bench"),
                                      str(root / "out"), lang="en")
    return root, stats, again


def test_seed_tts_benchmark_writes_the_layout(stacks, scored_run):
    root, stats, again = scored_run
    assert {k: stats[k] for k in ("ok", "failed", "skipped", "total")} == \
        {"ok": 2, "failed": 0, "skipped": 0, "total": 2}
    assert again == {"ok": 0, "failed": 0, "skipped": 2, "total": 2}
    data = TB.load_benchmark_data(str(root / "bench"), "en")
    assert [d[0] for d in data] == ["s1", "s2"]
    assert data[0][3:] == ("prompt text", "label text")
    c = stacks["tcodec"]
    for name, prompt_path, label_path, _, _ in data:
        d = root / "out" / "en" / name
        meta = json.loads((d / "metadata.json").read_text())
        label, sr = TIO.read_wav(label_path)
        want_tok = stacks["jcodec"].encode(JIO.resample(label, sr, 16000))
        assert meta["num_tokens"] == want_tok.shape[1] > 0
        assert meta["label_text"] == "label text"
        pred, psr = TIO.read_wav(str(d / "pred.wav"))
        concat, _ = TIO.read_wav(str(d / "prompt_concat_pred.wav"))
        assert psr == SR and len(concat) == len(pred) + 12000
        # pred.wav holds the codec's streaming decode of those tokens
        pw, _ = TIO.read_wav(prompt_path)
        prompt = c.prepare_prompt(TIO.resample(pw, 16000, SR),
                                  TIO.resample(pw, 16000, 16000))
        wav = c.decode_streaming(want_tok, prompt, block_size=4,
                                 max_token_len=16)[0]
        np.testing.assert_allclose(pred, np.clip(wav, -1, 1), atol=1e-4)


def test_benchmark_scores_equal_the_jax_stack(stacks, scored_run):
    """The run's WER and SIM from the port's ASR and CAM++ against the same
    run scored by the JAX codec, ASR and CAM++ (same weights; the port's
    sampling rungs fed JAX's draws)."""
    root, stats, _ = scored_run
    got = stats["scores"]
    want = JS.score_seed_tts_run(
        str(root / "out"), "en",
        transcribe_fn=JS.make_asr_transcriber(stacks["jcodec"],
                                              stacks["jasr"]),
        speaker_fn=stacks["jcodec"].speaker_encoder,
        benchmark_dir=str(root / "bench"))
    assert got["n"] == want["n"] == 2
    assert got["wer"] == want["wer"] and got["wer"] is not None
    assert abs(got["sim"] - want["sim"]) <= 1e-5
    for name in ("s1", "s2"):
        g, w = got["per_sample"][name], want["per_sample"][name]
        assert g["wer"] == w["wer"]
        assert abs(g["sim"] - w["sim"]) <= 1e-5
    merged = json.loads((root / "out" / "result.json").read_text())
    assert merged == {"en": {"wer": got["wer"], "sim": got["sim"], "n": 2}}
    assert stats["result_json"] == str(root / "out" / "result.json")


def test_a_failing_sample_keeps_the_shard_alive(stacks, tmp_path, capsys):
    """A sample whose label wav cannot be read is counted as failed (its
    traceback printed); the shard's other samples decode."""
    _write_bench(tmp_path / "bench", np.random.RandomState(1),
                 names=("a", "b"), label_s=0.5)
    (tmp_path / "bench" / "en" / "a" / "label.wav").write_bytes(b"not a wav")
    stats = TB.run_seed_tts_benchmark(stacks["tcodec"],
                                      str(tmp_path / "bench"),
                                      str(tmp_path / "out"), block_size=4,
                                      max_token_len=16, rank=0, world_size=1)
    assert stats == {"ok": 1, "failed": 1, "skipped": 0, "total": 2}
    assert "Traceback" in capsys.readouterr().err
    assert (tmp_path / "out" / "en" / "b" / "pred.wav").exists()
    assert not (tmp_path / "out" / "en" / "a" / "pred.wav").exists()
    # rank 1 of 2 takes the second sample only
    shard = TB.run_seed_tts_benchmark(stacks["tcodec"],
                                      str(tmp_path / "bench"),
                                      str(tmp_path / "out2"), rank=1,
                                      world_size=2, block_size=4,
                                      max_token_len=16)
    assert shard == {"ok": 1, "failed": 0, "skipped": 0, "total": 1}


def test_rtf_measurement(stacks):
    rng = np.random.RandomState(1)
    c = stacks["tcodec"]
    tokens = [rng.randint(0, 32, (1, 20)) for _ in range(2)]
    res = TR.measure_decode_rtf(c.decoder, tokens, warmup=1, streaming=True,
                                block_size=4)
    assert res["rtf"] > 0 and res["first_chunk_ms"] > 0
    off = TR.measure_decode_rtf(c.decoder, tokens, warmup=0, streaming=False)
    assert off["rtf"] > 0 and "first_chunk_ms" not in off
    wavs = [rng.randn(12800).astype(np.float32) * 0.1 for _ in range(2)]
    enc = TR.measure_encode_rtf(c, wavs, warmup=1)
    assert enc["rtf"] > 0 and abs(enc["audio_s"] - 1.6) < 1e-9
    ext = TR.measure_tokenizer_rtf(c.encode, wavs, 16000, warmup=1,
                                   name="glm4", device="cpu")
    assert ext["rtf"] > 0 and ext["tokenizer"] == "glm4"
    assert abs(ext["audio_s"] - 2 * 0.8) < 1e-6


# ------------------------------------------------------------- the CLIs
def test_build_asr_from_a_reference_file_equals_jax(stacks, tmp_path):
    """``bin.benchmark.build_asr``: the post-VQ layers and the decoder of a
    reference-named tokenizer file (``generator.encoder.`` /
    ``generator.decoder.``) through the port's converters, transcribing
    as the JAX ``build_asr``'s ASR does."""
    import dataclasses
    from safetensors.numpy import save_file
    from moss_speech_decoder_cosy_tpu.bin.benchmark import build_asr as jbuild
    from moss_speech_decoder_cosy_torch.bin.benchmark import (
        build_asr as tbuild)
    cfg = stacks["cfg"]
    sd = {}
    for kind, params, pre in (("tokenizer", stacks["tp"], "generator.encoder."),
                              ("post_vq", stacks["pp"], "generator.encoder."),
                              ("whisper_decoder", stacks["dp"],
                               "generator.decoder.")):
        sd.update({pre + k: np.ascontiguousarray(v) for k, v in
                   reference_sd_from_jax(kind, cfg, params).items()})
    path = str(tmp_path / "tok.safetensors")
    save_file(sd, path)
    ids = np.random.RandomState(2).randint(0, 32, (1, 20)).astype(np.int32)
    jasr = jbuild(path, stacks["jcodec"])
    assert jasr.segment_tokens == tbuild(path, stacks["tcodec"]
                                         ).segment_tokens == 375
    # the tiny position tables hold 16 tokens and 32 targets
    jasr.segment_tokens, jasr.max_len = SEG_T, MAX_LEN
    tasr = tbuild(path, stacks["tcodec"], segment_tokens=SEG_T,
                  max_len=MAX_LEN)
    assert tasr.device.type == "cpu"
    got = tasr.transcribe(ids, temperatures=(0.0,))
    want = jasr.transcribe(ids, temperatures=(0.0,))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    nodec = {k: v for k, v in sd.items() if "decoder" not in k}
    save_file(nodec, str(tmp_path / "enc.safetensors"))
    assert tbuild(str(tmp_path / "enc.safetensors"), stacks["tcodec"]) is None
    assert dataclasses.asdict(tasr.cfg) == dataclasses.asdict(
        stacks["tcodec"].tok_cfg)


def test_validate_reference_on_tiny_reference_files(stacks, tmp_path,
                                                    capsys):
    """The port's ``validate_reference``: tiny ``flow.pt`` / ``hift.pt``
    (``generator.``-prefixed) in the reference's names convert with
    nothing unused and decode finite audio; the tokenizer file's post-VQ
    extra is not counted, as in JAX."""
    from moss_speech_decoder_cosy_torch.bin import validate_reference as vr
    fcfg, hcfg = tiny_flow_config(), tiny_hift_config()
    fp = stacks["jcodec"].decoder.flow_params
    hp = stacks["jcodec"].decoder.hift_params
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in
                reference_sd_from_jax("flow", fcfg, _np(fp)).items()},
               tmp_path / "flow.pt")
    torch.save({"generator." + k: torch.from_numpy(np.array(v)) for k, v in
                reference_sd_from_jax("hift", hcfg, _np(hp)).items()},
               tmp_path / "hift.pt")
    tok = {"encoder." + k: torch.from_numpy(np.array(v)) for k, v in
           reference_sd_from_jax("tokenizer", stacks["cfg"],
                                 stacks["tp"]).items()}
    tok["encoder.embed_positions2.weight"] = torch.zeros(4, 16)
    torch.save(tok, tmp_path / "tok.pt")
    res = vr.main(["--flow", str(tmp_path / "flow.pt"),
                   "--hift", str(tmp_path / "hift.pt"),
                   "--tokenizer", str(tmp_path / "tok.pt"), "--tiny",
                   "--seconds", "1", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == res
    assert res["flow_unused"] == res["hift_unused"] == 0
    assert res["tokenizer_unused"] == 0
    assert res["finite"] is True and res["rtf"] > 0
    assert res["device"] == "cpu" and "waveform_mae" not in res
