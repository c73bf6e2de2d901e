"""The port's data pipeline (``data/{dataset,processor,tar}.py``,
``bin/tools.py``) against the JAX package's, host numpy with
``compute_fbank`` on the CPU.  Mirrors ``tests/test_data.py``: the same
seeded shards through both chains give the same batches (the matcha
features within 1e-4, everything else equal), and each processor, opener
and tar reader equals its JAX twin."""

import functools
import io
import json
import random
import tarfile

import numpy as np
import pytest
import torch

from moss_speech_decoder_cosy_tpu.bin import tools as JTools
from moss_speech_decoder_cosy_tpu.data import DataList as JDataList
from moss_speech_decoder_cosy_tpu.data import build_pipeline as jbuild
from moss_speech_decoder_cosy_tpu.data import processor as JP
from moss_speech_decoder_cosy_tpu.data import tar as JTar
from moss_speech_decoder_cosy_tpu.data.dataset import Prefetcher as JPrefetch
from moss_speech_decoder_cosy_torch.bin import tools as TTools
from moss_speech_decoder_cosy_torch.data import DataList, Prefetcher
from moss_speech_decoder_cosy_torch.data import build_pipeline
from moss_speech_decoder_cosy_torch.data import processor as TP
from moss_speech_decoder_cosy_torch.data import tar as TTar
from moss_speech_decoder_cosy_torch.eval.audio_io import write_wav

# the matcha mel against JAX's, as ``test_torch_codec.py`` bounds it (the
# two FFTs round differently: 2.4e-5 at most on a log-mel of -3 here)
FEAT_ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def parquet_shards(tmp_path_factory):
    import pyarrow as pa
    import pyarrow.parquet as pq
    tmp = tmp_path_factory.mktemp("shards")
    rng = np.random.RandomState(0)
    paths = []
    for shard in range(2):
        rows = []
        for i in range(4):
            sr = 16000
            rows.append({
                "utt": f"utt_{shard}_{i}",
                "speech": (rng.randn(sr * (i + 2) // 4) * 0.1).astype(
                    np.float32).tolist(),
                "sample_rate": sr,
                "speech_token": rng.randint(0, 64, 12).tolist(),
                "utt_embedding": rng.randn(8).astype(np.float32).tolist(),
                "spk_embedding": rng.randn(8).astype(np.float32).tolist()})
        p = str(tmp / f"shard_{shard}.parquet")
        pq.write_table(pa.Table.from_pylist(rows), p)
        paths.append(p)
    return paths


def _assert_rows_equal(got, want, feat_atol=0.0):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if isinstance(w[k], (np.ndarray, list)) and k != "utts":
                gv, wv = np.asarray(g[k]), np.asarray(w[k])
                assert gv.dtype == wv.dtype and gv.shape == wv.shape, k
                if k == "speech_feat":
                    np.testing.assert_allclose(gv, wv, atol=feat_atol,
                                               err_msg=k)
                else:
                    np.testing.assert_array_equal(gv, wv, err_msg=k)
            else:
                assert g[k] == w[k], k


def test_datalist_partition_equals_jax(parquet_shards):
    for kw in (dict(rank=0, world_size=2), dict(rank=1, world_size=2,
                                                 worker_id=1, num_workers=2),
               dict(shuffle=False, partition=False)):
        t, j = DataList(parquet_shards * 4, **kw), JDataList(
            parquet_shards * 4, **kw)
        for epoch in (0, 1):
            t.set_epoch(epoch)
            j.set_epoch(epoch)
            assert list(t) == list(j)
    dl = DataList(parquet_shards * 4, rank=0, world_size=2)
    dl.set_epoch(0)
    assert len(list(dl)) == 4


def _chain(mod, build, dl_cls, shards, **fbank):
    dl = dl_cls(shards, shuffle=False)
    dl.set_epoch(0)
    return list(build(dl, [
        mod.parquet_opener,
        functools.partial(mod.filter_samples, max_length=10000),
        functools.partial(mod.resample, resample_rate=24000),
        functools.partial(mod.compute_fbank, n_fft=480, hop_size=480,
                          win_size=480, **fbank),
        functools.partial(mod.compute_f0),
        mod.parse_embedding,
        functools.partial(mod.sort, sort_size=4),
        functools.partial(mod.static_batch, batch_size=4),
        functools.partial(mod.padding, gan=True, pad_to_multiple=8,
                          token_mel_ratio=4)]))


def test_full_chain_to_batches_equals_jax(parquet_shards):
    """parquet -> filter -> resample -> fbank -> f0 -> embeddings -> sort
    -> batch -> padding: the port's batches equal JAX's (features within
    ``FEAT_ATOL``), with the JAX test's shape checks."""
    got = _chain(TP, build_pipeline, DataList, parquet_shards, device="cpu")
    want = _chain(JP, jbuild, JDataList, parquet_shards)
    assert len(got) == 2
    _assert_rows_equal(got, want, FEAT_ATOL)
    b = got[0]
    assert b["speech_token"].shape[0] == 4 and b["speech_feat"].shape[2] == 80
    assert b["speech_feat"].shape[1] % 8 == 0
    assert b["speech_token"].shape[1] * 4 == b["speech_feat"].shape[1]
    assert b["token_valid"].dtype == bool and b["embedding"].shape == (4, 8)
    assert b["pitch_feat"].shape[:2] == b["speech_feat"].shape[:2]
    assert np.isfinite(b["speech_feat"]).all()


@pytest.mark.parametrize("n", [4800, 24000, 37411])
def test_compute_fbank_matches_jax_mel(n):
    wav = (np.random.RandomState(n).randn(n) * 0.2).astype(np.float32)
    got = next(TP.compute_fbank(iter([{"speech": wav}]), device="cpu"))
    want = next(JP.compute_fbank(iter([{"speech": wav}])))
    assert got["speech_feat"].dtype == np.float32
    assert got["speech_feat"].shape == want["speech_feat"].shape
    np.testing.assert_allclose(got["speech_feat"], want["speech_feat"],
                               atol=FEAT_ATOL)


def test_compute_fbank_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the default device on a machine without a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        next(TP.compute_fbank(iter([{"speech": np.zeros(4800, np.float32)}])))


def test_shuffle_sort_and_batching_equal_jax():
    rng = np.random.RandomState(2)
    rows = [{"speech_feat": np.zeros((int(n), 4)), "i": i}
            for i, n in enumerate(rng.randint(3, 40, 23))]
    for fn in (functools.partial(TP.shuffle, shuffle_size=5),
               functools.partial(TP.sort, sort_size=6)):
        jfn = getattr(JP, fn.func.__name__)
        random.seed(7)
        got = [r["i"] for r in fn(iter(rows))]
        random.seed(7)
        want = [r["i"] for r in jfn(iter(rows), **fn.keywords)]
        assert got == want and sorted(got) == list(range(23))
    for budget in (40, 100):
        got = list(TP.dynamic_batch(iter(rows), max_frames_in_batch=budget))
        want = list(JP.dynamic_batch(iter(rows), max_frames_in_batch=budget))
        assert [[r["i"] for r in b] for b in got] == \
            [[r["i"] for r in b] for b in want]
        for b in got:
            longest = max(x["speech_feat"].shape[0] for x in b)
            assert longest * len(b) <= budget or len(b) == 1
    got = [[r["i"] for r in b] for b in TP.static_batch(iter(rows), 5)]
    assert got == [[r["i"] for r in b] for b in JP.static_batch(iter(rows),
                                                                5)]


def test_f0_tracker_equals_jax_and_finds_the_tone():
    sr = 24000
    t = np.arange(sr) / sr
    rng = np.random.RandomState(0)
    signals = [0.5 * np.sin(2 * np.pi * 220.0 * t),
               0.4 * np.sin(2 * np.pi * 180 * t)
               + 0.8 * np.sin(2 * np.pi * 360 * t)
               + 0.5 * np.sin(2 * np.pi * 540 * t),
               np.sin(2 * np.pi * np.cumsum(150.0 + 100.0 * t) / sr),
               rng.randn(sr) * 0.1, np.zeros(sr)]
    for k, wav in enumerate(signals):
        row = {"speech": wav.astype(np.float32)}
        if k == 0:
            row["speech_feat"] = np.zeros((50, 4), np.float32)
        got = next(TP.compute_f0(iter([dict(row)]), sample_rate=sr))
        want = next(JP.compute_f0(iter([dict(row)]), sample_rate=sr))
        np.testing.assert_array_equal(got["pitch_feat"], want["pitch_feat"])
        if k == 0:
            voiced = got["pitch_feat"][got["pitch_feat"] > 0]
            assert len(voiced) > 20
            assert abs(np.median(voiced) - 220.0) < 8.0
        if k == 4:
            assert (got["pitch_feat"] == 0).all()


def test_prefetcher():
    import time

    def slow_gen():
        for i in range(5):
            time.sleep(0.01)
            yield i

    assert list(Prefetcher(slow_gen(), depth=2)) == [0, 1, 2, 3, 4]
    assert list(Prefetcher(iter(range(7)), depth=1)) == \
        list(JPrefetch(iter(range(7)), depth=1))

    def failing():
        yield 1
        raise ValueError("boom")

    it = iter(Prefetcher(failing()))
    assert next(it) == 1
    with pytest.raises(ValueError, match="boom"):
        list(it)


def _tar(path, files, fmt=tarfile.USTAR_FORMAT):
    with tarfile.open(path, "w", format=fmt) as tf:
        for name, payload in files.items():
            info = tarfile.TarInfo(name)
            info.size = len(payload)
            tf.addfile(info, io.BytesIO(payload))


def test_indexed_tar_roundtrip_equals_jax(tmp_path):
    import pickle
    files = {f"f{i}.bin": bytes(range(i, i + 64)) for i in range(5)}
    tp = tmp_path / "shard.tar"
    _tar(tp, files)
    t = TTar.IndexedTar(str(tp))
    assert sorted(t.names()) == sorted(files)
    for name, payload in files.items():
        assert t.read(name) == payload
    t.close()
    idx = tmp_path / "shard.index"
    entries = pickle.loads(idx.read_bytes())
    m = JTar.MMTar(str(tp))
    assert entries == m.scan() and len(entries) == 5
    m.close()
    assert TTar.build_index(str(tp)) == str(idx)
    assert pickle.loads(idx.read_bytes()) == entries


def test_indexed_tar_gnu_and_pax_long_names(tmp_path):
    long_name = "d/" + "x" * 120 + ".txt"
    for fmt, tag in ((tarfile.GNU_FORMAT, "gnu"),
                     (tarfile.PAX_FORMAT, "pax")):
        tp = tmp_path / f"long_{tag}.tar"
        _tar(tp, {long_name: b"payload-" + tag.encode(),
                  "short.txt": b"abcde"}, fmt)
        t = TTar.IndexedTar(str(tp))
        assert long_name in t.names(), (tag, t.names())
        assert t.read(long_name) == b"payload-" + tag.encode()
        assert t.read("short.txt") == b"abcde"
        m = JTar.MMTar(str(tp))
        assert TTar.MMTar(str(tp)).scan() == m.scan()
        m.close()
        t.close()


def _wav_bytes(x, sr):
    from scipy.io import wavfile
    buf = io.BytesIO()
    wavfile.write(buf, sr, (x * 32767).astype(np.int16))
    return buf.getvalue()


def test_cosy_jsonl_opener_equals_jax(tmp_path):
    """A jsonl of tokens beside a tar of wavs; a row whose member is
    missing is skipped, as in JAX."""
    sr = 16000
    wavs = {f"utt{i}.wav": np.sin(np.arange(400) * 0.01 * (i + 1)).astype(
        np.float32) for i in range(3)}
    _tar(tmp_path / "shard.tar", {k: _wav_bytes(v, sr)
                                  for k, v in wavs.items()})
    jp = tmp_path / "shard.vq.jsonl"
    with open(jp, "w") as f:
        for i in range(4):
            f.write(json.dumps({"filename": f"utt{i}.wav",
                                "cosy_token": list(range(i + 2))}) + "\n")
    kw = dict(jsonl_suffix=".vq.jsonl")
    got = list(TP.cosy_jsonl_opener(iter([{"src": str(jp), "epoch": 3}]),
                                    **kw))
    want = list(JP.cosy_jsonl_opener(iter([{"src": str(jp), "epoch": 3}]),
                                     **kw))
    assert len(got) == 3
    _assert_rows_equal(got, want)
    for i, r in enumerate(got):
        assert r["sample_rate"] == sr and r["epoch"] == 3
        assert r["speech_token"].tolist() == list(range(i + 2))
        np.testing.assert_allclose(r["speech"], wavs[f"utt{i}.wav"],
                                   atol=1e-3)


def test_sft_npy_opener_split_equals_jax(tmp_path):
    sr, token_rate = 16000, 12.5
    wav = np.random.RandomState(0).randn(sr * 2).astype(np.float32) * .1
    write_wav(str(tmp_path / "utt.wav"), wav, sr)
    npy = tmp_path / "utt.wav.vq0918-pool4.npy"
    np.save(npy, np.arange(25, dtype=np.int32))
    for kw in (dict(npy_suffix=".vq0918-pool4.npy"),
               dict(npy_suffix=".vq0918-pool4.npy", token_rate=token_rate,
                    split_token=10), {}):
        got = list(TP.sft_npy_opener(iter([{"src": str(npy)}]), **kw))
        want = list(JP.sft_npy_opener(iter([{"src": str(npy)}]), **kw))
        _assert_rows_equal(got, want)
    assert [len(r["speech_token"]) for r in got] == [25]
    rows = list(TP.sft_npy_opener(iter([{"src": str(npy)}]),
                                  npy_suffix=".vq0918-pool4.npy",
                                  token_rate=token_rate, split_token=10))
    assert [len(r["speech_token"]) for r in rows] == [10, 20, 25]
    for r in rows:
        want = int(np.ceil(len(r["speech_token"]) / token_rate * sr))
        assert len(r["speech"]) == min(want, len(wav))


def test_openers_loaders_and_padding_without_gan_equal_jax(tmp_path):
    """jsonl rows with wav paths through ``wav_loader``, ``truncate`` (the
    random crop seeded), ``tokenize`` with a stand-in tokenizer, and
    ``padding`` with speaker embeddings and no GAN fields."""
    sr = 24000
    rng = np.random.RandomState(5)
    lines = []
    for i in range(3):
        p = tmp_path / f"w{i}.wav"
        write_wav(str(p), rng.randn(sr // 2 + 999 * i).astype(np.float32)
                  * 0.1, sr)
        lines.append({"utt": f"u{i}", "wav": str(p),
                      "spk_embedding": rng.randn(4).tolist()})
    src = tmp_path / "rows.jsonl"
    src.write_text("\n".join(json.dumps(r) for r in lines) + "\n\n")

    def run(mod, build, **fb):
        random.seed(11)
        return list(build(iter([{"src": str(src)}]), [
            mod.jsonl_opener, mod.wav_loader,
            functools.partial(mod.truncate, truncate_length=13000),
            functools.partial(mod.tokenize,
                              tokenize_fn=lambda w: (np.abs(w[::640]) * 99
                                                     ).astype(np.int32)),
            functools.partial(mod.compute_fbank, **fb),
            functools.partial(mod.parse_embedding, normalize=True),
            functools.partial(mod.static_batch, batch_size=2),
            functools.partial(mod.padding, use_spk_embedding=True)]))
    got, want = run(TP, build_pipeline, device="cpu"), run(JP, jbuild)
    assert len(got) == 2 and "pitch_feat" not in got[0]
    _assert_rows_equal(got, want, FEAT_ATOL)
    np.testing.assert_allclose(np.linalg.norm(got[0]["embedding"], axis=1),
                               1.0, atol=1e-6)


def test_tools_make_parquet_and_rebatch_equal_jax(tmp_path):
    """``bin.tools``: a wav.scp with a token jsonl into parquet shards, then
    re-sharded; the shards read back through ``parquet_opener`` equal the
    JAX tools' shards."""
    import argparse
    import pyarrow.parquet as pq
    rng = np.random.RandomState(6)
    scp = tmp_path / "wav.scp"
    toks = tmp_path / "tokens.jsonl"
    with open(scp, "w") as f, open(toks, "w") as g:
        for i in range(5):
            p = tmp_path / f"a{i}.wav"
            write_wav(str(p), rng.randn(1600 * (i + 1)).astype(np.float32)
                      * 0.1, 16000)
            f.write(f"a{i} {p}\n")
            g.write(json.dumps({"utt": f"a{i}",
                                "speech_token": list(range(i + 1))}) + "\n")
    tables = {}
    for name, tools in (("port", TTools), ("jax", JTools)):
        out = tmp_path / name
        tools.make_parquet(argparse.Namespace(
            wav_scp=str(scp), token_jsonl=str(toks),
            output_dir=str(out / "a"), num_utts_per_parquet=2))
        tools.rebatch(argparse.Namespace(
            input_list=str(out / "a" / "data.list"),
            output_dir=str(out / "b"), num_utts_per_parquet=3))
        lists = [(out / s / "data.list").read_text().split()
                 for s in ("a", "b")]
        assert [len(x) for x in lists] == [3, 2]
        tables[name] = [pq.read_table(p).to_pylist()
                        for x in lists for p in x]
    assert tables["port"] == tables["jax"]
    rows = list(TP.parquet_opener(iter([{"src": str(tmp_path / "port" / "b" /
                                                    "parquet_000000000.tar"),
                                         "epoch": 0}])))
    assert [r["utt"] for r in rows] == ["a0", "a1", "a2"]
    assert rows[2]["speech_token"] == [0, 1, 2] and rows[0]["epoch"] == 0
