"""Training entry point in one process, after the JAX package's
``bin/train.py`` (the reference cosyvoice/bin/train.py).

Models: ``flow`` (``training/train_step.py``), ``hifigan`` (the GAN turns,
``training/gan.py``), ``lm`` (teacher-forced CE) and ``lm_dpo`` (DPO
against a frozen reference policy; ``training/lm.py``).  Gradient
accumulation, checkpoints with a metadata sidecar (torch files; resume
with a shape-filtered load and the step fast-forwarded), scalars to
``metrics.jsonl`` (and tensorboard when it imports), a cross-validation
pass and an optional mel sample at every save.  Runs on the card unless
``--device cpu``; the weights start from seeds.

Example:
  python -m moss_speech_decoder_cosy_torch.bin.train \\
      --model flow --train_data shards.list --model_dir exp/flow \\
      --epochs 1 --accum_grad 2

Several processes (``torchrun --nproc_per_node N -m
moss_speech_decoder_cosy_torch.bin.train ... --world_size N``, or one
process per rank with ``--rank R --dist_address HOST:PORT``): ``nccl`` on
the cards, ``gloo`` with ``--device cpu``.  The ranks form ``world_size /
tp`` data-parallel replicas of ``tp`` tensor-parallel ranks each (TP
inner, as the JAX package's ``(data, model)`` mesh).  Each replica reads
its own shards (``DataList(rank=, world_size=)``); a step runs only while
every rank has a batch.  The flow step is the single-process step on the
replicas' rows together (``training/train_step.py``) with ZeRO-sharded
moments, the LM steps likewise (moments replicated), the GAN turns
average their gradients (DDP).  ``--tp`` shards the LM and DPO trainers'
``Qwen2SpeechLM`` (``parallel/tp.py``), as in the JAX package; its
checkpoints hold the whole weights, gathered from the ranks' slices.  Only
rank 0 writes checkpoints, logs and samples.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import faulthandler
import functools
import json
import os
import random
import time

import numpy as np
import torch

# the reference's torchrun @record role: crash visibility
faulthandler.enable()

FLOW_KEYS = ("speech_token", "token_valid", "speech_feat", "feat_valid")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", choices=["flow", "hifigan", "lm", "lm_dpo"],
                   default="flow")
    p.add_argument("--config", default="moss",
                   choices=["moss", "cosyvoice2", "tiny"])
    p.add_argument("--train_data", required=True,
                   help="file listing parquet (or, for the LM, jsonl) "
                        "shard paths")
    p.add_argument("--cv_data", default=None,
                   help="cross-validation shard list; the CV loss runs at "
                        "every save (executor.py:273-377's role)")
    p.add_argument("--cv_batches", type=int, default=8)
    p.add_argument("--sample_at_save", action="store_true",
                   help="synthesize a mel from the first CV batch at every "
                        "save")
    p.add_argument("--dpo_beta", type=float, default=0.01)
    p.add_argument("--ref_checkpoint", default=None,
                   help="frozen reference policy for DPO (default: the "
                        "initial or resumed weights)")
    p.add_argument("--model_dir", required=True)
    p.add_argument("--checkpoint", default=None,
                   help="resume from this checkpoint (shape-filtered load)")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--accum_grad", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--peak_lr", type=float, default=1e-3)
    p.add_argument("--warmup_steps", type=int, default=2500)
    p.add_argument("--save_per_step", type=int, default=1000)
    p.add_argument("--max_steps", type=int, default=-1)
    p.add_argument("--seed", type=int, default=0,
                   help="weights from seed, the step draws from seed + 1")
    p.add_argument("--device", default="cuda")
    p.add_argument("--tp", type=int, default=1,
                   help="LM tensor parallelism: ranks a replica")
    p.add_argument("--world_size", type=int, default=1,
                   help="processes (default torchrun's WORLD_SIZE)")
    p.add_argument("--rank", type=int, default=None,
                   help="this process's rank (default torchrun's RANK)")
    p.add_argument("--dist_address", default=None,
                   help="host:port of rank 0 (default MASTER_ADDR:"
                        "MASTER_PORT)")
    return p.parse_args(argv)


class NullLogger:
    """The logger of a rank other than 0."""

    def log(self, step, metrics):
        pass

    def close(self):
        pass


@dataclasses.dataclass
class Parallel:
    """The process's place: its data-parallel group (None in one replica)
    and replica index and count, its tensor-parallel group (None without
    ``--tp``), and whether it writes (rank 0)."""
    dp: object = None
    dp_rank: int = 0
    dp_world: int = 1
    tp_group: object = None
    writer: bool = True
    device: object = None
    owns_group: bool = False


def setup_parallel(args, device) -> Parallel:
    """Joins the process group of ``--world_size`` ranks (or torchrun's)
    and makes the data- and tensor-parallel groups."""
    import torch.distributed as dist
    from ..parallel import distributed as D
    from ..parallel.mesh import DataGroup
    world = (args.world_size if args.world_size > 1
             else int(os.environ.get("WORLD_SIZE", "1")))
    if world == 1 and args.tp == 1:
        return Parallel()
    if args.tp > 1 and args.model not in ("lm", "lm_dpo"):
        raise ValueError("--tp shards the LM and DPO trainers only")
    if world % args.tp:
        raise ValueError(f"--tp {args.tp} does not divide the world size "
                         f"{world}")
    if not D.initialize(args.dist_address, world, args.rank, device=device):
        raise ValueError(f"--world_size {world} --tp {args.tp} needs a "
                         "process group: --dist_address or torchrun")
    rank, tp = dist.get_rank(), args.tp
    n_dp = world // tp
    # every rank makes every group, in the same order
    tp_groups = [dist.new_group(list(range(d * tp, (d + 1) * tp)))
                 for d in range(n_dp)] if tp > 1 else None
    dp_groups = [dist.new_group(list(range(t, world, tp)))
                 for t in range(tp)] if n_dp > 1 else None
    return Parallel(
        dp=DataGroup(dp_groups[rank % tp]) if dp_groups else None,
        dp_rank=rank // tp, dp_world=n_dp,
        tp_group=tp_groups[rank // tp] if tp_groups else None,
        writer=rank == 0, owns_group=True)


def lockstep(batches, par: Parallel):
    """``batches`` while every rank has one: each step the ranks agree
    that none has run out (the JAX package's fixed steps per epoch)."""
    from ..parallel import distributed as D
    synced = par.dp is not None or par.tp_group is not None
    it = iter(batches)
    while True:
        got = next(it, None)
        if synced:
            have = torch.tensor([0 if got is None else 1],
                                device=par.device)
            if int(-D.all_reduce_max(-have)) == 0:
                return
        if got is None:
            return
        yield got


class MetricLogger:
    """Scalar logging: JSONL always, tensorboard when it imports
    (train_utils.py:330-374)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.f = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        try:
            from torch.utils.tensorboard import SummaryWriter
            self.tb = SummaryWriter(log_dir)
        except ImportError:
            self.tb = None

    def log(self, step: int, metrics: dict):
        rec = {"step": step, "time": time.time(),
               **{k: float(v) for k, v in metrics.items()}}
        self.f.write(json.dumps(rec) + "\n")
        self.f.flush()
        if self.tb:
            for k, v in rec.items():
                if k not in ("step", "time"):
                    self.tb.add_scalar(f"train/{k}", v, step)

    def close(self):
        self.f.close()
        if self.tb:
            self.tb.close()


def configs(name: str):
    """(flow_cfg, hift_cfg) of ``--config``."""
    from ..utils import config as C
    flow = {"moss": C.moss_flow_config, "cosyvoice2": C.cosyvoice2_flow_config,
            "tiny": C.tiny_flow_config}[name]()
    hift = C.tiny_hift_config() if name == "tiny" else C.moss_hift_config()
    return flow, hift


def make_dataloader(args, data_list: str, flow_cfg, hift_cfg):
    """(DataList, pipeline) over the port's ``data/`` chain: parquet ->
    24 kHz -> matcha mel at the model's mel width (on ``--device``) ->
    [f0] -> embeddings -> shuffle -> sort -> batches -> padding."""
    from ..data import DataList, build_pipeline, processor
    gan = args.model == "hifigan"
    with open(data_list) as f:
        shards = [line.strip() for line in f if line.strip()]
    dl = DataList(shards, rank=args.par.dp_rank,
                  world_size=args.par.dp_world)
    procs = [
        processor.parquet_opener,
        functools.partial(processor.resample, resample_rate=24000),
        functools.partial(processor.compute_fbank, device=args.device,
                          num_mels=(hift_cfg.in_channels if gan
                                    else flow_cfg.output_size)),
        processor.parse_embedding,
        functools.partial(processor.shuffle, shuffle_size=500),
        functools.partial(processor.sort, sort_size=100),
        functools.partial(processor.static_batch,
                          batch_size=args.batch_size),
        functools.partial(processor.padding,
                          token_mel_ratio=flow_cfg.token_mel_ratio, gan=gan),
    ]
    if gan:
        procs.insert(3, processor.compute_f0)
    return dl, build_pipeline(dl, procs)


def epochs(args, make):
    """Yields (epoch, batch) over ``--epochs``, each epoch a fresh
    pipeline from ``make() -> (DataList, pipeline)``, while every rank has
    a batch."""
    for epoch in range(args.epochs):
        # the sample shuffle's draws, seeded: alike on the tensor-parallel
        # ranks of one replica (they must read the same batches), each
        # replica's own
        random.seed(f"{args.seed}/{args.par.dp_rank}/{epoch}")
        dl, pipeline = make()
        dl.set_epoch(epoch)
        for batch in lockstep(pipeline, args.par):
            yield epoch, batch


def resume(args, modules: dict) -> int:
    """Shape-filtered load of ``--checkpoint`` into ``modules`` ({tree key:
    module}, or {None: module} for a checkpoint that is one state dict);
    returns the step its metadata records (0 without)."""
    from ..utils import checkpoint as ckpt
    if not args.checkpoint:
        return 0
    loaded = ckpt.load_checkpoint(args.checkpoint)
    skipped = []
    for key, mod in modules.items():
        merged, sk = ckpt.shape_filtered_merge(
            mod.state_dict(), loaded if key is None else loaded[key])
        mod.load_state_dict(merged)
        skipped += sk
    step = int(ckpt.load_metadata(args.checkpoint).get("step", 0))
    print(f"resumed {args.checkpoint} at step {step}; skipped "
          f"{len(skipped)} keys", flush=True)
    return step


def fast_forward(opt, step: int) -> None:
    """The schedule resumes at ``step`` (the reference's
    scheduler.set_step, bin/train.py:199-201)."""
    opt.count = step


def _tensors(batch: dict, keys, device) -> dict:
    return {k: torch.as_tensor(np.asarray(batch[k])).to(device)
            for k in keys}


def flow_arrays(batch: dict, flow_cfg, device) -> dict:
    out = _tensors(batch, FLOW_KEYS, device)
    emb = batch.get("embedding")
    if emb is None:
        emb = np.zeros((batch["speech_token"].shape[0],
                        flow_cfg.spk_embed_dim), np.float32)
    out["embedding"] = torch.as_tensor(np.asarray(emb)).to(device)
    return out


def train_flow(args, flow_cfg, hift_cfg, logger, device):
    from ..training import (create_flow_train_state, make_flow_train_step,
                            make_optimizer)
    from ..utils import checkpoint as ckpt
    par = args.par
    state = create_flow_train_state(
        flow_cfg, args.seed, make_optimizer(args.peak_lr, args.warmup_steps,
                                            zero=par.dp),
        device=device)
    state.step = resume(args, {None: state.model})
    fast_forward(state.optimizer, state.step)
    step_fn = make_flow_train_step(state.model, accum_steps=args.accum_grad,
                                   dp=par.dp)
    g = torch.Generator(device=device).manual_seed(args.seed + 1)
    make = functools.partial(make_dataloader, args, args.train_data,
                             flow_cfg, hift_cfg)
    epoch = 0
    for epoch, batch in epochs(args, make):
        state, metrics = step_fn(state, flow_arrays(batch, flow_cfg, device),
                                 generator=g)
        last = 0 < args.max_steps <= state.step
        if state.step % 10 == 0 or last:
            logger.log(state.step, metrics)
            print(f"epoch {epoch} step {state.step}: "
                  f"loss={float(metrics['loss']):.4f}", flush=True)
        if (state.step % args.save_per_step == 0 or last) and par.writer:
            ckpt.save_checkpoint(
                os.path.join(args.model_dir, f"step_{state.step}"),
                state.model.state_dict(),
                metadata={"step": state.step, "epoch": epoch})
            if args.cv_data:
                run_cv(args, state.model, flow_cfg, hift_cfg, state.step,
                       logger, device)
        if last:
            break
    if par.writer:
        ckpt.save_checkpoint(os.path.join(args.model_dir, f"epoch_{epoch}"),
                             state.model.state_dict(),
                             metadata={"step": state.step, "epoch": epoch})
    return state


@torch.no_grad()
def run_cv(args, model, flow_cfg, hift_cfg, step, logger, device):
    """The cross-validation loss over ``--cv_batches`` (draws from a
    generator seeded 0, no dropout), and with ``--sample_at_save`` the mel
    of the first CV batch's first row (executor.py:273-377)."""
    from ..models.flow.flow import FlowLossDraws
    _, pipeline = make_dataloader(_single(args), args.cv_data, flow_cfg,
                                  hift_cfg)
    g = torch.Generator(device=device).manual_seed(0)
    was_training = model.training
    model.eval()
    losses, first = [], None
    for i, batch in enumerate(pipeline):
        if i >= args.cv_batches:
            break
        b = flow_arrays(batch, flow_cfg, device)
        first = first or b
        draws = FlowLossDraws.draw(tuple(b["speech_feat"].shape), g, device)
        losses.append(float(model.loss(b["speech_token"], b["token_valid"],
                                       b["speech_feat"], b["feat_valid"],
                                       b["embedding"], draws)))
    if losses:
        cv_loss = float(np.mean(losses))
        logger.log(step, {"cv_loss": cv_loss})
        print(f"step {step}: cv_loss={cv_loss:.4f} ({len(losses)} batches)",
              flush=True)
    if args.sample_at_save and first is not None:
        mel = model(first["speech_token"][:1], first["token_valid"][:1],
                    torch.zeros((1, 0, flow_cfg.output_size), device=device),
                    first["embedding"][:1], streaming=False, finalize=True)
        out = os.path.join(args.model_dir, f"sample_step_{step}.npy")
        np.save(out, mel.cpu().numpy())
        print(f"step {step}: wrote {out}", flush=True)
    model.train(was_training)


def _single(args):
    """``args`` as one process reads the data: every shard (the CV pass
    runs on rank 0 alone)."""
    single = copy.copy(args)
    single.par = Parallel()
    return single


def _fit(x: torch.Tensor, n: int) -> torch.Tensor:
    """(B, L) cut or zero-padded to (B, n)."""
    return x[:, :n] if x.shape[1] >= n else torch.nn.functional.pad(
        x, (0, n - x.shape[1]))


def train_hifigan(args, flow_cfg, hift_cfg, logger, device):
    """The GAN fine-tune loop: a discriminator turn and a generator turn a
    batch (executor.train_one_epoc_gan, executor.py:94-180)."""
    from ..models.hift import HiFTGenerator
    from ..ops.melspec import matcha_mel_spectrogram
    from ..training import gan as gan_mod
    from ..training.train_step import AdamW, constant_lr
    from ..utils import checkpoint as ckpt
    from ..weights import seeded_module
    gen = seeded_module(lambda: HiFTGenerator(hift_cfg), args.seed, device)
    disc = seeded_module(gan_mod.MultipleDiscriminator, args.seed + 1,
                         device)
    start = resume(args, {"generator": gen, "discriminator": disc})

    def adam(m):
        opt = AdamW(m.parameters(), constant_lr(args.peak_lr), b1=0.8,
                    b2=0.99, weight_decay=0.0)
        fast_forward(opt, start)
        return opt

    state = gan_mod.GanTrainState(start, gen, disc, adam(gen), adam(disc))
    disc_step, gen_step = gan_mod.make_gan_train_step([functools.partial(
        matcha_mel_spectrogram, sampling_rate=hift_cfg.sampling_rate)],
        dp=args.par.dp)
    make = functools.partial(make_dataloader, args, args.train_data,
                             flow_cfg, hift_cfg)
    for epoch, batch in epochs(args, make):
        arrays = _tensors(batch, ("speech", "speech_feat", "pitch_feat"),
                          device)
        # the real audio cut to the generator's output length
        arrays["speech"] = _fit(arrays["speech"], arrays["speech_feat"]
                                .shape[1] * hift_cfg.total_upsample)
        state, dm = disc_step(state, arrays)
        state, gm = gen_step(state, arrays)
        last = 0 < args.max_steps <= state.step
        if state.step % 10 == 0 or last:
            logger.log(state.step, {**dm, **gm})
            print(f"epoch {epoch} step {state.step}: "
                  f"gen={float(gm['loss']):.4f} "
                  f"disc={float(dm['loss_disc']):.4f}", flush=True)
        if (state.step % args.save_per_step == 0 or last) and \
                args.par.writer:
            ckpt.save_checkpoint(
                os.path.join(args.model_dir, f"gan_step_{state.step}"),
                {"generator": gen.state_dict(),
                 "discriminator": disc.state_dict()},
                metadata={"step": state.step, "epoch": epoch})
        if last:
            break
    return state


def _pad_lm_batch(rows, dpo=False):
    """Collates text / speech token rows into right-padded arrays (lengths
    rounded up to 8)."""
    def pad(key, bucket=8):
        arrs = [np.asarray(r[key], np.int64).reshape(-1) for r in rows]
        n = max(len(a) for a in arrs)
        n = ((n + bucket - 1) // bucket) * bucket
        out = np.zeros((len(arrs), n), np.int64)
        for i, a in enumerate(arrs):
            out[i, :len(a)] = a
        return out, np.asarray([len(a) for a in arrs], np.int64)

    text, text_len = pad("text_token")
    batch = {"text_token": text, "text_token_len": text_len}
    for which in (("chosen", "rejected") if dpo else ("speech",)):
        tok, tl = pad(f"{which}_token")
        batch[f"{which}_token"] = tok
        batch[f"{which}_token_len"] = tl
    return batch


def make_lm_dataloader(args, dpo=False):
    from ..data import DataList, build_pipeline, processor
    with open(args.train_data) as f:
        shards = [line.strip() for line in f if line.strip()]
    dl = DataList(shards, rank=args.par.dp_rank,
                  world_size=args.par.dp_world)
    opener = (processor.jsonl_opener if shards[0].endswith(".jsonl")
              else processor.parquet_opener)
    procs = [
        opener,
        functools.partial(processor.shuffle, shuffle_size=500),
        functools.partial(processor.static_batch,
                          batch_size=args.batch_size),
        lambda data: (_pad_lm_batch(rows, dpo=dpo) for rows in data),
    ]
    return dl, build_pipeline(dl, procs)


def train_lm(args, logger, device, dpo=False):
    """Speech-LM training: teacher-forced CE (llm.py:263-427) or DPO over
    chosen / rejected completions (utils/losses.py:24-60)."""
    from ..models.llm.speech_lm import (Qwen2SpeechLM, SpeechLMConfig,
                                        tiny_speech_lm_config)
    from ..training import lm as lm_mod
    from ..training.train_step import TrainState, make_optimizer
    from ..utils import checkpoint as ckpt
    from ..weights import seeded_module
    cfg = (tiny_speech_lm_config() if args.config == "tiny"
           else SpeechLMConfig())
    par = args.par
    model = seeded_module(lambda: Qwen2SpeechLM(cfg), args.seed, device)
    step0 = resume(args, {None: model})
    if dpo:
        ref = copy.deepcopy(model).eval().requires_grad_(False)
        if args.ref_checkpoint:
            ref.load_state_dict(ckpt.load_checkpoint(args.ref_checkpoint))
    norm_fn = None
    if par.tp_group is not None:
        from ..parallel.tp import (tensor_parallel, tp_full_state,
                                   tp_global_norm)
        tensor_parallel(model, par.tp_group)
        if dpo:
            tensor_parallel(ref, par.tp_group)
        norm_fn = functools.partial(tp_global_norm, group=par.tp_group)
    state = TrainState(step0, model, make_optimizer(
        args.peak_lr, args.warmup_steps, norm_fn=norm_fn)(
            model.parameters()))
    fast_forward(state.optimizer, state.step)
    if dpo:
        step_fn = lm_mod.make_dpo_train_step(ref, beta=args.dpo_beta,
                                             dp=par.dp)
    else:
        step_fn = lm_mod.make_lm_train_step(dp=par.dp)
    for epoch, batch in epochs(args, functools.partial(
            make_lm_dataloader, args, dpo)):
        state, metrics = step_fn(state, {k: torch.as_tensor(v).to(device)
                                         for k, v in batch.items()})
        last = 0 < args.max_steps <= state.step
        if state.step % 10 == 0 or last:
            logger.log(state.step, metrics)
            print(f"epoch {epoch} step {state.step}: "
                  f"loss={float(metrics['loss']):.4f}", flush=True)
        if state.step % args.save_per_step == 0 or last:
            # the whole weights: under --tp every rank gives its slices
            whole = (model.state_dict() if par.tp_group is None
                     else tp_full_state(model, par.tp_group))
            if par.writer:
                ckpt.save_checkpoint(
                    os.path.join(args.model_dir, f"lm_step_{state.step}"),
                    whole, metadata={"step": state.step, "epoch": epoch})
        if last:
            break
    return state


def main(argv=None):
    args = parse_args(argv)
    from ..parallel import distributed as D
    from ..utils.device import resolve_device
    device = resolve_device(args.device)
    par = setup_parallel(args, device)
    if device.type == "cuda" and D.is_initialized():
        device = torch.device("cuda", torch.cuda.current_device())
    par.device = device
    args.par = par
    flow_cfg, hift_cfg = configs(args.config)
    logger = (MetricLogger(os.path.join(args.model_dir, "tensorboard"))
              if par.writer else NullLogger())
    try:
        if args.model == "hifigan":
            return train_hifigan(args, flow_cfg, hift_cfg, logger, device)
        if args.model in ("lm", "lm_dpo"):
            return train_lm(args, logger, device, dpo=args.model == "lm_dpo")
        return train_flow(args, flow_cfg, hift_cfg, logger, device)
    finally:
        logger.close()
        if par.owns_group:
            D.shutdown()


if __name__ == "__main__":
    main()
