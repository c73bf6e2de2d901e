"""Two ranks over ``torch.distributed`` (gloo, the CPU): the port's process
groups, data parallelism, ZeRO and tensor parallelism (``parallel/``,
``training/``, ``bin/train.py``).  Mirrors ``tests/test_multiprocess.py``
and ``tests/test_tp.py``.

One run, started once for the module: two worker processes (this file run
as a script) and, beside them, a two-rank ``bin/train.py`` flow run, a
two-rank ``--model lm --tp 2`` run and one single-process ``--model lm``
run; each process has 300 s and a hang fails the tests.  The workers write what they
measured; the tests read it.  The single-process steps they compare with
are held against the JAX package's steps in ``tests/test_torch_training.py``
and ``tests/test_torch_lm_training.py``; JAX's own mesh step is not run
here (its compiles would take about half a minute of this file's budget).

- init, rank and world; ``host_shard`` disjoint and complete; an
  all-reduced mean;
- the data-parallel flow step, 2 ranks with unequal valid frames (and the
  encoder's dropout on), two steps against the single-process step on the
  global batch with the same generator: loss 1e-6 relative, parameters
  1e-6 of their peak (the elements whose gradient is within the gradient
  tolerance of 0, which Adam moves by up to the learning rate whatever the
  order of the sums, held apart as ``test_torch_training.py`` holds them:
  to twice the learning rates' sum; those with a gradient not exactly 0
  at most 5% of the elements);
- the data-parallel flow step with ``accum_steps=2`` against one process
  on the global batch in microbatch order, the data-parallel LM and DPO
  steps (unequal speech lengths) against one process: loss 1e-6
  relative, parameters 1e-6 (the floor as above); the GAN turns, which
  average their gradients, leave both ranks' weights equal, and with the
  TPR term off (its median is each rank's) each turn's gradients are
  within 1e-5 of one process's on both rows;
- the ZeRO step against the replicated one: parameters 1e-6, each rank
  holding half the sharded moments' bytes;
- tensor parallelism at tp 2 against the unsharded port (which
  ``tests/test_torch_llm.py`` holds against JAX): the tiny LM's loss
  (rtol 2e-5), one clipped train step (loss 2e-5, parameters 1e-4 rtol /
  1e-6 atol, the floor elements as above), the same step at a head
  layout the tiny config does not reach (q heads not divisible by the
  ranks), prefill + 3 forced decode steps'
  logits (1e-5), the v1 ``TransformerLM``'s teacher-forced logits (1e-5);
- ``bin/train.py --world_size 2``: two ranks (one from explicit
  arguments, one from torchrun's environment) train 2 steps; only rank 0
  writes a checkpoint and logs.  ``--model lm --tp 2``: rank 0's
  checkpoints hold the whole weights and equal one process's steps.

Torch runs on one thread in every process."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
TIMEOUT_S = 300
PEAK_LR, WARMUP, CLIP = 1e-3, 2, 5.0


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def flow_batch(cfg, b=4, tt=8, seed=0):
    """A global batch whose two halves (the ranks' rows) hold unequal
    valid frames: rows 2 and 3 end after 3 and 5 tokens."""
    rng = np.random.RandomState(seed)
    valid = np.ones((b, tt), bool)
    valid[2, 3:] = False
    valid[3, 5:] = False
    return {
        "speech_token": rng.randint(0, cfg.vocab_size, (b, tt)).astype(
            np.int64),
        "token_valid": valid,
        "speech_feat": rng.randn(b, tt * cfg.token_mel_ratio,
                                 cfg.output_size).astype(np.float32),
        "feat_valid": np.repeat(valid, cfg.token_mel_ratio, axis=1),
        "embedding": rng.randn(b, cfg.spk_embed_dim).astype(np.float32),
    }


def lm_batch(cfg, b=4, seed=0):
    rng = np.random.RandomState(seed)
    return {
        "text_token": torch.as_tensor(rng.randint(
            0, cfg.backbone.vocab_size, (b, 6))),
        "text_token_len": torch.tensor([6, 6, 4, 5]),
        "speech_token": torch.as_tensor(rng.randint(
            0, cfg.speech_token_size, (b, 5))),
        "speech_token_len": torch.tensor([5, 5, 2, 3]),
    }


# ------------------------------------------------------------------ worker
# Adam divides each gradient by its own RMS, so an element whose gradient
# is within the gradient tolerance of 0 (a key bias's gradient is 0 in
# exact arithmetic, ~1e-10 here) moves by up to the learning rate whatever
# the order of the sums: ``test_torch_training.py``'s floor (its
# ``noise_floor``: within 1e-4 of the tensor's peak gradient plus 1e-7 of
# the largest), held to twice the learning rates' sum and to at most 5% of
# the elements; every other element to the tight bound.
GRAD_REL, GRAD_NOISE = 1e-4, 1e-7


def _floor(grads: dict, floor: dict = None) -> dict:
    """``floor`` or-ed with the elements of ``grads`` within the gradient
    tolerance of 0: a pair of masks, all of them and those not exactly 0
    (an exact 0 leaves Adam's moments at 0 on every path)."""
    top = max(float(v.abs().max()) for v in grads.values())
    out = {}
    for k, v in grads.items():
        m = v.abs() <= GRAD_REL * float(v.abs().max()) + GRAD_NOISE * top
        nz = m & (v != 0)
        out[k] = (m, nz) if floor is None else (m | floor[k][0],
                                                nz | floor[k][1])
    return out


def _grads(model) -> dict:
    return {k: p.grad.detach().clone() for k, p in model.named_parameters()}


def _compare(got: dict, want: dict, floor: dict, atol: float,
             rtol: float = 0.0, peak_rel: bool = True) -> dict:
    """The worst excess over ``atol`` (times max(1, the tensor's peak) with
    ``peak_rel``) + ``rtol`` |want| outside the floor, the largest move of
    a floor element and the share of the elements in the floor whose
    gradient is not exactly 0."""
    worst = moved = 0.0
    n_floor = n_all = 0
    for k, w in want.items():
        d = (got[k] - w).abs()
        m, nz = floor[k]
        scale = max(1.0, float(w.abs().max())) if peak_rel else 1.0
        excess = d - atol * scale - rtol * w.abs()
        worst = max(worst, float(torch.where(m, -1.0, excess).max()))
        if m.any():
            moved = max(moved, float(d[m].max()))
        n_floor += int(nz.sum())
        n_all += m.numel()
    return dict(worst=worst, floor_moved=moved, floor_share=n_floor / n_all)


def _params(model) -> dict:
    return {k: v.detach().clone() for k, v in model.named_parameters()}


def _flow_part(res, dg):
    import dataclasses
    from moss_speech_decoder_cosy_torch.parallel import local_rows
    from moss_speech_decoder_cosy_torch.training import train_step as TT
    from moss_speech_decoder_cosy_torch.utils import config as TC

    cfg = TC.tiny_flow_config()
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, dropout_rate=0.1))
    glob = {k: torch.as_tensor(v) for k, v in flow_batch(cfg).items()}
    mine = local_rows(glob)

    def run(dp, zero, batch, steps=2):
        opt = TT.make_optimizer(PEAK_LR, WARMUP, CLIP,
                                zero=dg if zero else None)
        state = TT.create_flow_train_state(cfg, seed=0, optimizer=opt,
                                           device="cpu")
        step = TT.make_flow_train_step(state.model, dp=dp)
        g = torch.Generator().manual_seed(5)
        losses, floor = [], None
        for _ in range(steps):
            state, m = step(state, batch, generator=g)
            losses.append(float(m["loss"]))
            floor = _floor(_grads(state.model), floor)
        return losses, _params(state.model), state.optimizer, floor

    one, p_one, opt_one, floor = run(None, False, glob)
    dp, p_dp, opt_dp, _ = run(dg, False, mine)
    zero, p_zero, opt_zero, _ = run(dg, True, mine)
    res["flow_loss_single"], res["flow_loss_dp"] = one, dp
    res["flow_loss_zero"] = zero
    res["flow_params_dp"] = _compare(p_dp, p_one, floor, 1e-6)
    res["flow_lrs"] = sum(opt_one.schedule(i) for i in range(2))
    res["flow_params_zero"] = float(max(
        (p_zero[k] - p_dp[k]).abs().max() for k in p_dp))
    res["moment_bytes"] = (opt_dp.moment_bytes(), opt_zero.moment_bytes())
    res["sharded_moment_bytes"] = sum(
        2 * m.numel() * m.element_size()
        for m, d in zip(opt_dp.mu, opt_zero.zero_dims) if d is not None)

    # accum_steps 2: global microbatch i is every rank's microbatch i, so
    # one process runs the global batch in that row order
    order = [0, 2, 1, 3]
    reordered = {k: v[order] for k, v in glob.items()}

    def accum(dp, batch):
        state = TT.create_flow_train_state(
            cfg, seed=0, optimizer=TT.make_optimizer(PEAK_LR, WARMUP, CLIP),
            device="cpu")
        g = torch.Generator().manual_seed(6)
        _, m = TT.make_flow_train_step(state.model, accum_steps=2, dp=dp)(
            state, batch, generator=g)
        return float(m["loss"]), _params(state.model), _floor(
            _grads(state.model))

    l1, p1, floor = accum(None, reordered)
    l2, p2, _ = accum(dg, mine)
    res["flow_accum"] = (l1, l2, _compare(p2, p1, floor, 1e-6))



def _lm_dp_part(res, dg):
    from moss_speech_decoder_cosy_torch.models.llm.speech_lm import (
        Qwen2SpeechLM, tiny_speech_lm_config)
    from moss_speech_decoder_cosy_torch.parallel import local_rows
    from moss_speech_decoder_cosy_torch.training import lm as LM
    from moss_speech_decoder_cosy_torch.training import train_step as TT
    from moss_speech_decoder_cosy_torch.weights import seeded_module

    cfg = tiny_speech_lm_config()
    glob = lm_batch(cfg)

    def run(dp, batch):
        model = seeded_module(lambda: Qwen2SpeechLM(cfg), 0, "cpu")
        state = TT.TrainState(0, model, TT.make_optimizer(
            PEAK_LR, WARMUP, 0.05)(model.parameters()))
        state, m = LM.make_lm_train_step(dp=dp)(state, batch)
        return float(m["loss"]), _params(model), _floor(_grads(model))

    loss1, p1, floor = run(None, glob)
    loss2, p2, _ = run(dg, local_rows(glob))
    res["lm_dp"] = (loss1, loss2, _compare(p2, p1, floor, 1e-6))

    # DPO: the mean over the global batch's rows
    rng = np.random.RandomState(4)
    pairs = dict(glob, chosen_token=glob["speech_token"],
                 chosen_token_len=glob["speech_token_len"],
                 rejected_token=torch.as_tensor(rng.randint(
                     0, cfg.speech_token_size, (4, 5))),
                 rejected_token_len=torch.tensor([4, 5, 5, 2]))

    def dpo(dp, batch):
        model = seeded_module(lambda: Qwen2SpeechLM(cfg), 0, "cpu")
        ref = seeded_module(lambda: Qwen2SpeechLM(cfg), 1, "cpu")
        state = TT.TrainState(0, model, TT.make_optimizer(
            PEAK_LR, WARMUP, 0.05)(model.parameters()))
        _, m = LM.make_dpo_train_step(ref.requires_grad_(False), beta=0.5,
                                      dp=dp)(state, batch)
        return float(m["loss"]), _params(model), _floor(_grads(model))

    loss1, p1, floor = dpo(None, pairs)
    loss2, p2, _ = dpo(dg, local_rows(pairs))
    res["dpo_dp"] = (loss1, loss2, _compare(p2, p1, floor, 1e-6))


def _gan_part(res, dg):
    """The tiny HiFT GAN's turns on each rank's row, the gradients
    averaged.  With the TPR term on (its median is each rank's own) a
    discriminator and a generator turn leave both ranks' weights equal;
    with it off, each turn's gradients and losses equal one process's on
    both rows (the NSF draws are seeded alike everywhere)."""
    import torch.distributed as dist
    from moss_speech_decoder_cosy_torch.models.hift import HiFTGenerator
    from moss_speech_decoder_cosy_torch.training import gan as G
    from moss_speech_decoder_cosy_torch.training import train_step as TT
    from moss_speech_decoder_cosy_torch.utils import config as TC
    from moss_speech_decoder_cosy_torch.weights import seeded_module
    hcfg = TC.tiny_hift_config()

    def adam(m):
        return TT.AdamW(m.parameters(), TT.constant_lr(2e-4), b1=0.8,
                        b2=0.99, weight_decay=0.0)

    def build():
        gen = seeded_module(lambda: HiFTGenerator(hcfg), 0, "cpu")
        disc = seeded_module(lambda: G.MultiResolutionDiscriminator(
            fft_sizes=(512,)), 1, "cpu")
        return G.GanTrainState(0, gen, disc, adam(gen), adam(disc))

    mel = [lambda w: w.reshape(w.shape[0], -1, 16).mean(-1)]
    t = 8
    rows = []                                        # row r is rank r's
    for r in range(dg.world):
        rng = np.random.RandomState(10 + r)
        rows.append({
            "speech_feat": torch.as_tensor(rng.randn(1, t, 16).astype(
                np.float32)),
            "speech": torch.as_tensor((rng.randn(
                1, t * hcfg.total_upsample) * 0.3).astype(np.float32)),
            "pitch_feat": torch.as_tensor((np.abs(rng.randn(1, t))
                                           * 100).astype(np.float32))})
    batch = rows[dg.rank]
    glob = {k: torch.cat([x[k] for x in rows]) for k in batch}

    state = build()
    disc_step, gen_step = G.make_gan_train_step(mel, dp=dg)
    state, dm = disc_step(state, batch)
    state, gm = gen_step(state, batch)
    sums = torch.stack([p.detach().double().abs().sum() for p in
                        list(state.generator.parameters())
                        + list(state.discriminator.parameters())])
    got = [torch.empty_like(sums) for _ in range(dg.world)]
    dist.all_gather(got, sums)
    res["gan"] = dict(equal=all(torch.equal(got[0], x) for x in got),
                      losses=[float(dm["loss_disc"]), float(gm["loss"])])

    def turn(which, dp, b):
        """One turn from the seeded state: its metrics and the gradients
        of the module it updates."""
        state = build()
        steps = G.make_gan_train_step(mel, tpr_weight=0.0, dp=dp)
        state, m = steps[which == "gen"](state, b)
        mod = state.generator if which == "gen" else state.discriminator
        return ({k: float(v) for k, v in m.items()},
                {k: torch.zeros_like(p) if p.grad is None else p.grad.clone()
                 for k, p in mod.named_parameters()})

    res["gan_no_tpr"] = {}
    for which in ("disc", "gen"):
        m_dp, g_dp = turn(which, dg, batch)
        m_one, g_one = turn(which, None, glob)
        res["gan_no_tpr"][which] = dict(
            metrics=(m_dp, m_one), grad_excess=_grad_excess(g_dp, g_one))


def _grad_excess(got: dict, want: dict, rel: float = 1e-5) -> float:
    """The largest error of ``got`` over the bound ``rel`` of each tensor's
    peak in ``want`` plus ``GRAD_NOISE`` of the largest: <= 1 within."""
    top = max(float(w.abs().max()) for w in want.values())
    return max(float((got[k] - w).abs().max())
               / (rel * float(w.abs().max()) + GRAD_NOISE * top)
               for k, w in want.items())


def _tp_part(res, rank):
    import copy
    import dataclasses
    from moss_speech_decoder_cosy_torch.models.llm.speech_lm import (
        Qwen2SpeechLM, tiny_speech_lm_config)
    from moss_speech_decoder_cosy_torch.models.llm.transformer_lm import (
        TransformerLM, tiny_transformer_lm_config)
    from moss_speech_decoder_cosy_torch.parallel.tp import (
        tensor_parallel, tp_global_norm, tp_shard_params)
    from moss_speech_decoder_cosy_torch.training import lm as LM
    from moss_speech_decoder_cosy_torch.training import train_step as TT
    from moss_speech_decoder_cosy_torch.weights import seeded_module

    cfg = tiny_speech_lm_config()
    batch = lm_batch(cfg)
    ref = seeded_module(lambda: Qwen2SpeechLM(cfg), 3, "cpu")
    tp = tensor_parallel(copy.deepcopy(ref))
    res["q_rows"] = (tp.llm.layers[0].q_proj.weight.shape[0],
                     ref.llm.layers[0].q_proj.weight.shape[0])
    with torch.no_grad():
        res["tp_loss"] = (float(LM.lm_loss(tp, batch)[0]),
                          float(LM.lm_loss(ref, batch)[0]))

    # one clipped Adam step (the clip reads the whole gradient's norm)
    def step(model, norm_fn=None):
        opt = TT.AdamW(model.parameters(), TT.constant_lr(1e-3),
                       weight_decay=0.0, clip_norm=0.05, norm_fn=norm_fn)
        state = TT.TrainState(0, model, opt)
        _, m = LM.make_lm_train_step(dp=None)(state, batch)
        return float(m["loss"]), float(opt.grad_norm())

    lt, nt = step(tp, tp_global_norm)
    lr_, nr = step(ref)
    want = tp_shard_params(ref, 2, rank)
    floor = _floor(tp_shard_params(_grads(ref), 2, rank))
    res["tp_floor_zero"] = sum(int((m & ~nz).sum()) for m, nz in
                               floor.values())
    got = _params(tp)
    res["tp_step"] = dict(loss=(lt, lr_), norm=(nt, nr),
                          names_equal=sorted(got) == sorted(want),
                          **_compare(got, want, floor, 1e-6, 1e-4,
                                     peak_rel=False))

    # a head layout the tiny config does not reach: a q split that is not
    # whole heads (3 heads over 2 ranks: gathered, the row product on the
    # rank's columns)
    res["tp_layouts"] = {}
    for name, h, hkv, dk in (("q_gathered", 3, 1, 6),):
        lcfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
            cfg.backbone, hidden_size=h * dk, num_heads=h,
            num_kv_heads=hkv, ffn_size=40, num_layers=1))
        ref = seeded_module(lambda: Qwen2SpeechLM(lcfg), 5, "cpu")
        tp = tensor_parallel(copy.deepcopy(ref))
        lt, nt = step(tp, tp_global_norm)
        lr_, nr = step(ref)
        floor = _floor(tp_shard_params(_grads(ref), 2, rank))
        res["tp_layouts"][name] = dict(
            loss=(lt, lr_), norm=(nt, nr),
            **_compare(_params(tp), tp_shard_params(ref, 2, rank), floor,
                       1e-6, 1e-4, peak_rel=False))

    # prefill + 3 forced decode steps through the KV cache
    rng = np.random.RandomState(1)
    text = rng.randint(0, cfg.backbone.vocab_size, (1, 5))
    pspeech = rng.randint(0, cfg.speech_token_size, (1, 3))
    forced = rng.randint(0, cfg.speech_token_size, (3,))
    ref = seeded_module(lambda: Qwen2SpeechLM(cfg), 3, "cpu").eval()
    tp = tensor_parallel(copy.deepcopy(ref))

    @torch.inference_mode()
    def decode(m):
        h, cache = m.prefill(m.prompt_embeds(text, pspeech))
        out = [m.llm_decoder(h[:, -1])]
        for tok in forced:
            e = m.speech_embedding(torch.tensor([[int(tok)]]))
            h, cache = m.llm.forward_embeds(e, cache)
            out.append(m.llm_decoder(h[:, -1]))
        return torch.stack(out)

    a, b = decode(tp), decode(ref)
    res["tp_decode"] = float((a - b).abs().max())
    res["tp_cache_heads"] = tp.llm.init_cache().k.shape[2]

    vcfg = tiny_transformer_lm_config()
    v1 = seeded_module(lambda: TransformerLM(vcfg), 4, "cpu").eval()
    v1tp = tensor_parallel(copy.deepcopy(v1))
    rng = np.random.RandomState(2)
    args = (torch.as_tensor(rng.randint(0, vcfg.text_token_size, (1, 5))),
            torch.ones(1, 5, dtype=torch.bool),
            torch.as_tensor(rng.randint(0, vcfg.speech_token_size, (1, 7))),
            torch.ones(1, 7, dtype=torch.bool))
    with torch.inference_mode():
        a, b = v1tp(*args)[0], v1(*args)[0]
    res["tp_v1"] = (float((a - b).abs().max()), float(b.abs().max()))
    res["tp_v1_heads"] = v1tp.llm.layers[0].self_attn.heads


def worker(addr: str, rank: int, out_dir: str) -> None:
    torch.set_num_threads(1)
    from moss_speech_decoder_cosy_torch.parallel import distributed as D
    from moss_speech_decoder_cosy_torch.parallel.mesh import data_group
    D.initialize(addr, 2, rank, device="cpu")
    res = {"rank": D.rank(), "world": D.world_size(),
           "shard": D.host_shard(list(range(11)))}
    res["mean"] = float(D.all_reduce_sum(torch.tensor([rank + 1.0]))) / 2
    dg = data_group()
    _flow_part(res, dg)
    _lm_dp_part(res, dg)
    _gan_part(res, dg)
    _tp_part(res, rank)
    D.shutdown()
    torch.save(res, Path(out_dir) / f"rank{rank}.pt")
    print(f"DIST_OK rank={rank}", flush=True)


# ------------------------------------------------------------------ driver
def _shards(root: Path) -> Path:
    """Two parquet shards of 4 seeded utterances each (one a rank)."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    from moss_speech_decoder_cosy_torch.utils import config as TC
    cfg = TC.tiny_flow_config()
    rng = np.random.RandomState(0)
    names = []
    for s in range(2):
        rows = []
        for i in range(4):
            n = int(24000 * (0.3 + 0.2 * rng.rand()))
            wav = (0.3 * np.sin(2 * np.pi * (120 + 30 * i)
                                * np.arange(n) / 24000.0)
                   + 0.02 * rng.randn(n)).astype(np.float32)
            frames = n // 480 + 1
            rows.append(dict(
                utt=f"s{s}u{i}", speech=wav.tolist(), sample_rate=24000,
                speech_token=rng.randint(0, cfg.vocab_size, -(
                    -frames // cfg.token_mel_ratio)).tolist(),
                utt_embedding=rng.randn(cfg.spk_embed_dim).astype(
                    np.float32).tolist()))
        path = root / f"s{s}.parquet"
        pq.write_table(pa.Table.from_pylist(rows), str(path))
        names.append(str(path))
    (root / "train.list").write_text("\n".join(names) + "\n")
    with open(root / "lm.jsonl", "w") as f:            # the LM's rows
        for i in range(4):
            f.write(json.dumps({
                "text_token": rng.randint(0, 100, 3 + i).tolist(),
                "speech_token": rng.randint(0, 32, 7 - i).tolist()}) + "\n")
    (root / "lm.list").write_text(str(root / "lm.jsonl") + "\n")
    return root / "train.list"


def _spawn(args, env):
    return subprocess.Popen(args, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, env=env, cwd=ROOT,
                            text=True)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist")
    data = _shards(out)
    # the trainer logs to tensorboard when it imports; here its import pulls
    # in TensorFlow (~17 s), so the ranks run as where it is not installed
    # (the metrics' JSONL alone): a package of that name that fails to load
    stub = out / "no_tensorboard" / "tensorboard"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text(
        "raise ImportError('tensorboard left out of this test')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), str(stub.parent), os.environ.get("PYTHONPATH", "")]),
        OMP_NUM_THREADS="1")
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        env.pop(k, None)
    addr = f"127.0.0.1:{_free_port()}"
    cli_addr = f"127.0.0.1:{_free_port()}"
    # the trainer's ranks (rank 0 with its rank and address as arguments,
    # rank 1 from torchrun's environment) beside the workers
    host, port = cli_addr.split(":")
    cli = [sys.executable, "-m", "moss_speech_decoder_cosy_torch.bin.train",
           "--model", "flow", "--config", "tiny", "--train_data", str(data),
           "--device", "cpu", "--batch_size", "2", "--max_steps", "2",
           "--save_per_step", "2", "--warmup_steps", "2"]
    procs = [
        _spawn(cli + ["--model_dir", str(out / "cli0"), "--world_size", "2",
                      "--rank", "0", "--dist_address", cli_addr], env),
        _spawn(cli + ["--model_dir", str(out / "cli1")],
               dict(env, MASTER_ADDR=host, MASTER_PORT=port, RANK="1",
                    WORLD_SIZE="2", LOCAL_RANK="1"))]
    procs += [_spawn([sys.executable, str(HERE / "test_torch_distributed.py"),
                      addr, str(r), str(out)], env) for r in range(2)]
    # the LM trainer at --tp 2 over two ranks, and one process alone
    lm = [sys.executable, "-m", "moss_speech_decoder_cosy_torch.bin.train",
          "--model", "lm", "--config", "tiny", "--train_data",
          str(out / "lm.list"), "--device", "cpu", "--batch_size", "2",
          "--max_steps", "2", "--save_per_step", "1", "--warmup_steps", "2"]
    tp_addr = f"127.0.0.1:{_free_port()}"
    procs += [_spawn(lm + ["--model_dir", str(out / f"lm_tp{r}"), "--tp",
                           "2", "--world_size", "2", "--rank", str(r),
                           "--dist_address", tp_addr], env)
              for r in range(2)]
    procs.append(_spawn(lm + ["--model_dir", str(out / "lm_one")], env))
    try:
        outs = []
        for p in procs:
            try:
                o, e = p.communicate(timeout=TIMEOUT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                o, e = p.communicate()
                e += f"\n(killed after {TIMEOUT_S} s)"
            outs.append((p.returncode, o, e))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (rc, o, e) in enumerate(outs):
        assert rc == 0, f"process {i} rc={rc}\nstdout:{o}\nstderr:{e}"
    ranks = [torch.load(out / f"rank{r}.pt") for r in range(2)]
    return dict(ranks=ranks, out=out, outs=outs)


def test_init_rank_and_world(run):
    for r, res in enumerate(run["ranks"]):
        assert (res["rank"], res["world"]) == (r, 2)
        assert f"DIST_OK rank={r}" in run["outs"][2 + r][1]


def test_host_shard_disjoint_and_complete(run):
    a, b = (res["shard"] for res in run["ranks"])
    assert not set(a) & set(b) and sorted(a + b) == list(range(11))
    assert a == list(range(0, 11, 2))


def test_all_reduced_mean(run):
    assert all(res["mean"] == 1.5 for res in run["ranks"])


def test_dp_flow_step_equals_single_process(run):
    for res in run["ranks"]:
        np.testing.assert_allclose(res["flow_loss_dp"],
                                   res["flow_loss_single"], rtol=1e-6)
        c = res["flow_params_dp"]
        assert c["worst"] <= 0 and c["floor_share"] <= 0.05
        assert c["floor_moved"] <= 2 * res["flow_lrs"]


def test_dp_flow_accumulation_equals_single_process(run):
    """``accum_steps=2`` over 2 ranks: microbatch i of the global batch is
    every rank's microbatch i; one process on that row order."""
    for res in run["ranks"]:
        one, dp, c = res["flow_accum"]
        np.testing.assert_allclose(dp, one, rtol=1e-6)
        assert c["worst"] <= 0 and c["floor_share"] <= 0.05
        assert c["floor_moved"] <= 2 * PEAK_LR


def test_dp_dpo_step_equals_single_process(run):
    for res in run["ranks"]:
        one, dp, c = res["dpo_dp"]
        np.testing.assert_allclose(dp, one, rtol=1e-6)
        assert c["worst"] <= 0 and c["floor_share"] <= 0.05
        assert c["floor_moved"] <= 2 * PEAK_LR


def test_dp_gan_turns_keep_the_ranks_equal(run):
    """The GAN averages its gradients (DDP): after a discriminator and a
    generator turn on different rows, both ranks hold the same weights."""
    for res in run["ranks"]:
        assert res["gan"]["equal"]
        assert np.isfinite(res["gan"]["losses"]).all()


@pytest.mark.parametrize("which", ["disc", "gen"])
def test_dp_gan_turn_without_tpr_equals_single_process(run, which):
    """With the TPR term off, a data-parallel turn on one row a rank
    equals one process's turn on both rows: gradients within 1e-5 of
    each tensor's peak (plus 1e-7 of the largest), losses 1e-6
    relative."""
    for res in run["ranks"]:
        r = res["gan_no_tpr"][which]
        assert r["grad_excess"] <= 1.0
        m_dp, m_one = r["metrics"]
        assert sorted(m_dp) == sorted(m_one)
        for k in m_one:
            np.testing.assert_allclose(m_dp[k], m_one[k], rtol=1e-6)


def test_zero_step_equals_replicated(run):
    for res in run["ranks"]:
        np.testing.assert_allclose(res["flow_loss_zero"],
                                   res["flow_loss_dp"], rtol=1e-6)
        assert res["flow_params_zero"] <= 1e-6
        full, zero = res["moment_bytes"]
        sharded = res["sharded_moment_bytes"]
        assert sharded > 0.9 * full
        assert zero == full - sharded // 2


def test_dp_lm_step_equals_single_process(run):
    for res in run["ranks"]:
        one, dp, c = res["lm_dp"]
        np.testing.assert_allclose(dp, one, rtol=1e-6)
        assert c["worst"] <= 0 and c["floor_share"] <= 0.05
        assert c["floor_moved"] <= 2 * PEAK_LR


def test_tp_splits_the_heads(run):
    for res in run["ranks"]:
        local, full = res["q_rows"]
        assert local * 2 == full
        assert res["tp_cache_heads"] == 1            # 2 k/v heads over 2
        assert res["tp_v1_heads"] == 1               # 2 heads over 2


def test_tp_lm_loss_matches_unsharded(run):
    for res in run["ranks"]:
        np.testing.assert_allclose(*res["tp_loss"], rtol=2e-5)


def test_tp_train_step_matches_unsharded(run):
    for res in run["ranks"]:
        s = res["tp_step"]
        np.testing.assert_allclose(*s["loss"], rtol=2e-5)
        np.testing.assert_allclose(*s["norm"], rtol=1e-5)
        assert s["names_equal"] and s["worst"] <= 0
        assert s["floor_share"] <= 0.05 and s["floor_moved"] <= 2e-3


@pytest.mark.parametrize("layout", ["q_gathered"])
def test_tp_head_layouts_match_unsharded(run, layout):
    """One clipped train step of a one-layer LM whose 3 q heads do not
    split over 2 ranks (the columns gathered, every head run, the row
    product on the rank's columns): loss, norm and parameters as the tiny
    LM's."""
    for res in run["ranks"]:
        s = res["tp_layouts"][layout]
        np.testing.assert_allclose(*s["loss"], rtol=2e-5)
        np.testing.assert_allclose(*s["norm"], rtol=1e-5)
        assert s["worst"] <= 0 and s["floor_moved"] <= 2e-3


def test_tp_decode_matches_unsharded(run):
    for res in run["ranks"]:
        assert res["tp_decode"] <= 1e-5


def test_tp_transformer_lm_v1_matches_unsharded(run):
    for res in run["ranks"]:
        err, peak = res["tp_v1"]
        assert err <= 1e-5 * max(1.0, peak)


def test_train_cli_two_ranks_only_rank0_writes(run):
    out = run["out"]
    assert (out / "cli0" / "step_2" / "state.pt").exists()
    assert (out / "cli0" / "epoch_0" / "state.pt").exists()
    lines = (out / "cli0" / "tensorboard" / "metrics.jsonl").read_text()
    assert any(json.loads(x)["step"] == 2 for x in lines.splitlines())
    assert not (out / "cli1").exists()
    assert "step 2: loss=" in run["outs"][0][1]


def test_train_cli_tp_checkpoint_is_the_whole_model(run):
    """``--model lm --tp 2`` over two ranks: rank 0's checkpoints hold the
    whole weights (they load strictly into one process's
    ``Qwen2SpeechLM``, the ranks' slices gathered) and equal one
    process's after steps 1 and 2 on the same rows: the loss 2e-5
    relative, every parameter within twice the learning rates' sum, at
    least 95% of the elements within 1e-4 relative + 1e-6 (the rest are
    the elements whose gradient is f32 noise, which Adam moves by up to
    the rate); the second step moved the weights."""
    from moss_speech_decoder_cosy_torch.models.llm.speech_lm import (
        Qwen2SpeechLM, tiny_speech_lm_config)
    from moss_speech_decoder_cosy_torch.training.train_step import warmup_lr
    from moss_speech_decoder_cosy_torch.utils import checkpoint as CK
    out = run["out"]
    assert not (out / "lm_tp1").exists()
    one = {}
    for step in (1, 2):
        tp = CK.load_checkpoint(out / "lm_tp0" / f"lm_step_{step}")
        one[step] = CK.load_checkpoint(out / "lm_one" / f"lm_step_{step}")
        Qwen2SpeechLM(tiny_speech_lm_config()).load_state_dict(tp,
                                                               strict=True)
        lrs = sum(warmup_lr(1e-3, 2)(i) for i in range(step))
        tight = total = 0
        for k, w in one[step].items():
            d = (tp[k] - w).abs()
            assert float(d.max()) <= 2 * lrs, (step, k)
            tight += int((d <= 1e-4 * w.abs() + 1e-6).sum())
            total += d.numel()
        assert tight >= 0.95 * total, step
    moved = max(float((one[2][k] - one[1][k]).abs().max()) for k in one[1])
    assert moved > 0.5 * warmup_lr(1e-3, 2)(1)

    def loss(d):
        lines = (out / d / "tensorboard" / "metrics.jsonl").read_text()
        return [json.loads(x)["loss"] for x in lines.splitlines()
                if json.loads(x)["step"] == 2]
    np.testing.assert_allclose(loss("lm_tp0"), loss("lm_one"), rtol=2e-5)


if __name__ == "__main__":
    worker(sys.argv[1], int(sys.argv[2]), sys.argv[3])
