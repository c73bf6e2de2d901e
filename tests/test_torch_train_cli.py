"""The port's training entry point (``bin/train.py``) and its checkpoint IO
(``utils/checkpoint.py``'s native section, ``utils/export.py``), on the
CPU at the tiny configs.  Mirrors ``tests/test_lm_training.py``'s
``test_train_lm_dpo_entry_smoke``: each model trains 2 steps on seeded
shards written here (parquet audio for the flow and the GAN, jsonl token
rows for the LMs), writes a ``metrics.jsonl`` line and a checkpoint, and
resumes from it for a third step.  ``shape_filtered_merge`` and
``average_checkpoints`` against the JAX package's."""

import json
import os

import numpy as np
import pytest
import torch

from moss_speech_decoder_cosy_tpu.utils import checkpoint as JCK
from moss_speech_decoder_cosy_tpu.utils import export as JEX
from moss_speech_decoder_cosy_torch.bin import train as T
from moss_speech_decoder_cosy_torch.utils import checkpoint as CK
from moss_speech_decoder_cosy_torch.utils import config as TC
from moss_speech_decoder_cosy_torch.utils.export import average_checkpoints


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """A list file of one parquet shard (6 seeded 24 kHz utterances of
    0.4-0.6 s, tokens for the tiny flow), and one of a jsonl shard of LM
    rows (CE and DPO keys)."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    root = tmp_path_factory.mktemp("train_shards")
    cfg = TC.tiny_flow_config()
    rng = np.random.RandomState(0)
    rows = []
    for i in range(6):
        n = int(24000 * (0.4 + 0.2 * rng.rand()))
        t = np.arange(n) / 24000.0
        wav = (0.3 * np.sin(2 * np.pi * (120 + 40 * i) * t)
               + 0.02 * rng.randn(n)).astype(np.float32)
        frames = n // 480 + 1
        rows.append(dict(
            utt=f"u{i}", speech=wav.tolist(), sample_rate=24000,
            speech_token=rng.randint(0, cfg.vocab_size,
                                     -(-frames // cfg.token_mel_ratio))
            .tolist(),
            utt_embedding=rng.randn(cfg.spk_embed_dim).astype(
                np.float32).tolist()))
    pq.write_table(pa.Table.from_pylist(rows), str(root / "a.parquet"))
    (root / "audio.list").write_text(str(root / "a.parquet") + "\n")
    with open(root / "lm.jsonl", "w") as f:
        for _ in range(4):
            f.write(json.dumps({
                "text_token": rng.randint(0, 100, 4).tolist(),
                "speech_token": rng.randint(0, 32, 6).tolist(),
                "chosen_token": rng.randint(0, 32, 6).tolist(),
                "rejected_token": rng.randint(0, 32, 5).tolist()}) + "\n")
    (root / "lm.list").write_text(str(root / "lm.jsonl") + "\n")
    return root


CKPT = {"flow": "step_{}", "hifigan": "gan_step_{}", "lm": "lm_step_{}",
        "lm_dpo": "lm_step_{}"}


def _args(model, shards, out, *extra):
    data = shards / ("lm.list" if model.startswith("lm") else "audio.list")
    return ["--model", model, "--config", "tiny", "--train_data", str(data),
            "--model_dir", str(out), "--device", "cpu", "--batch_size", "2",
            "--max_steps", "2", "--save_per_step", "2", "--warmup_steps",
            "2", *extra]


def _metrics(out):
    with open(out / "tensorboard" / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("model", list(CKPT))
def test_train_entry_runs_and_resumes(model, shards, tmp_path):
    """2 steps, a metrics line and a checkpoint with its step; then a run
    from that checkpoint to step 3 (shape-filtered load, step fast-
    forwarded: the schedule and the step count go on from 2).  The flow
    also runs the CV pass and writes a mel sample at the save."""
    out = tmp_path / "run"
    extra = (["--cv_data", str(shards / "audio.list"), "--cv_batches", "1",
              "--sample_at_save"] if model == "flow" else [])
    state = T.main(_args(model, shards, out, *extra))
    assert state.step == 2
    first = out / CKPT[model].format(2)
    assert (first / CK.STATE_FILE).exists()
    assert CK.load_metadata(first)["step"] == 2
    lines = _metrics(out)
    assert any(r["step"] == 2 and np.isfinite(r.get("loss", r.get(
        "loss_disc", np.nan))) for r in lines)
    if model == "flow":
        assert (out / "sample_step_2.npy").exists()
        assert any("cv_loss" in r for r in lines)
        assert (out / "epoch_0" / CK.STATE_FILE).exists()
    args = _args(model, shards, out, "--checkpoint", str(first))
    args[args.index("--max_steps") + 1] = "3"
    resumed = T.main(args)
    assert resumed.step == 3
    assert CK.load_metadata(out / CKPT[model].format(3))["step"] == 3
    opt = getattr(resumed, "optimizer", None) or resumed.gen_opt
    assert opt.count == 3
    assert any(r["step"] == 3 for r in _metrics(out))


@pytest.mark.parametrize("flag", ["--tp", "--world_size"])
def test_parallel_training_raises(flag, shards, tmp_path):
    """Two ranks asked for in one process with no process group to join
    (no ``--dist_address``, no torchrun): the trainer raises instead of
    training alone.  Two real ranks: ``tests/test_torch_distributed.py``."""
    with pytest.raises(ValueError, match="divide|process group|address"):
        T.main(_args("lm_dpo", shards, tmp_path, flag, "2"))


def _tree(seed, shapes=None):
    g = torch.Generator().manual_seed(seed)
    shapes = shapes or {"a": (3, 4), "b": (5,)}
    return {"model": {k: torch.randn(s, generator=g)
                      for k, s in shapes.items()},
            "opt": {"count": torch.tensor(seed),
                    "half": torch.randn((2, 2), generator=g).half()}}


def test_checkpoint_roundtrip_is_bit_equal(tmp_path):
    tree = _tree(1)
    CK.save_checkpoint(tmp_path / "c", tree, metadata={"step": 7})
    back = CK.load_checkpoint(tmp_path / "c")
    for k in ("model", "opt"):
        for name, v in tree[k].items():
            assert back[k][name].dtype == v.dtype
            assert torch.equal(back[k][name], v)
    assert CK.load_metadata(tmp_path / "c") == {"step": 7}
    assert CK.load_metadata(tmp_path) == {}


def test_async_manager_keep_gc_latest_restore(tmp_path):
    """Saves go on in the background and copy the tree at once (a later
    in-place change does not reach the file); ``keep`` newest stay;
    ``latest`` / ``restore_latest`` give the newest; metadata carries the
    step."""
    mgr = CK.AsyncCheckpointManager(tmp_path / "ckpts", keep=2)
    assert mgr.latest() is None and mgr.restore_latest() == (None, None)
    trees = {}
    for step in (10, 20, 30):
        tree = _tree(step)
        trees[step] = {k: {n: v.clone() for n, v in d.items()}
                       for k, d in tree.items()}
        mgr.save(step, tree, metadata={"epoch": 0})
        tree["model"]["a"].add_(1.0)
    mgr.wait()
    assert mgr.steps() == [20, 30] and mgr.latest() == 30
    back, step = mgr.restore_latest()
    assert step == 30
    assert torch.equal(back["model"]["a"], trees[30]["model"]["a"])
    assert CK.load_metadata(tmp_path / "ckpts" / "step_30") == {
        "step": 30, "epoch": 0}
    assert not any(n.endswith(".tmp") for n in os.listdir(mgr.root))
    mgr.close()


def test_shape_filtered_merge_matches_jax():
    """The same nested tree through both: the same merged leaves and the
    same skipped paths (a shape mismatch and a key the target lacks)."""
    rng = np.random.RandomState(0)
    params = {"enc": {"w": rng.randn(3, 4), "b": rng.randn(4)},
              "head": {"w": rng.randn(4, 2)}}
    loaded = {"enc": {"w": rng.randn(3, 4), "b": rng.randn(5)},
              "head": {"w": rng.randn(4, 2)}, "extra": {"x": rng.randn(2)}}
    jm, js = JCK.shape_filtered_merge(params, loaded)
    tm, ts = CK.shape_filtered_merge(params, loaded)
    assert ts == js == ["enc/b", "extra/x"]
    for path, want in (("enc", "w"), ("enc", "b"), ("head", "w")):
        np.testing.assert_array_equal(tm[path][want], jm[path][want])
    # a flat state dict of tensors (what the trainer passes)
    sd = {"a.weight": torch.zeros(2, 3), "b.bias": torch.zeros(4)}
    merged, skipped = CK.shape_filtered_merge(
        sd, {"a.weight": torch.ones(2, 3), "b.bias": torch.ones(5)})
    assert skipped == ["b.bias"]
    assert torch.equal(merged["a.weight"], torch.ones(2, 3))
    assert torch.equal(merged["b.bias"], torch.zeros(4))


def test_average_checkpoints_matches_jax():
    trees = [{"m": {"w": np.random.RandomState(i).randn(3, 2).astype(
        np.float32)}, "b": np.float32(i)} for i in range(3)]
    want = JEX.average_checkpoints(trees)
    got = average_checkpoints([{"m": {"w": torch.from_numpy(t["m"]["w"])},
                                "b": torch.tensor(t["b"])} for t in trees])
    np.testing.assert_array_equal(got["m"]["w"].numpy(),
                                  np.asarray(want["m"]["w"]))
    assert float(got["b"]) == float(want["b"])
    with pytest.raises(ValueError):
        average_checkpoints([])
