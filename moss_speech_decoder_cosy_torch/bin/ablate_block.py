"""KV block-size quality ablation, after the JAX package's
``bin/ablate_block.py``: how does the banded-mask deviation grow with the
serving hop?

    python -m moss_speech_decoder_cosy_torch.bin.ablate_block --random-init \
        [block sizes...] [--rings [r1 r2 ...]] [--lengths 120,250,500] \
        [--trained N] [--config moss|tiny] [--device cuda|cpu]

The KV wavefront computes each frame once under a banded chunk-causal
mask; its deviation from the reference's windowed re-decode
(flow_inference.py:194-204) grows with the chunk (a bigger hop is a
coarser causality boundary and, at the serving default ``ring_tokens =
max_token_len - block_size``, a shorter left context).  Protocol: a
120-token stream behind a 4-token prompt; the golden is the flow's full
streaming forward (``streaming=True, finalize=True``), the KV mel the
port's KV session's per-hop flow (prefill, then ``_flow_mels``) at each
block and ring.  Metrics: MCD (dB, DCT cepstra 1..12), per-band relative
error (max / mean), relative MAE.  f32.

- ``--random-init``: the weights drawn from seed 0.  The JAX tool's
  default, converted torch-init weights at the golden test's topology
  (``tests/test_golden_parity._make_flow_pair``), needs the reference's
  checkout and torch modules, which are not in the repository: without
  ``--random-init`` the tool raises with that reason.
- ``--trained N``: the weights first fit for N steps on a synthetic
  token -> mel task (each token a fixed mel prototype plus jitter) through
  the port's ``training/train_step.make_flow_train_step``, so the ODE's
  dynamics are smooth and the MCDs mean something.
- ``--rings``: the ring swept at block 5 (the numbers, default 35 70 105).
- ``--lengths``: block 5, rings 35 / 70 / 105 over each stream length,
  each against the offline forward of that length, beside the reference's
  own windowed engine (window 40, the windowed device session's flow
  steps).

Prints the JAX tool's JSON (``protocol``, ``mean_abs_golden``,
``blocks`` or ``lengths``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .tool_setup import configs

WEIGHTS_REASON = (
    "the converted-weights protocol builds its flow from "
    "tests/test_golden_parity._make_flow_pair, which needs the reference "
    "checkout and its torch modules; neither is in the repository: pass "
    "--random-init")


def _mcd_db(a: np.ndarray, b: np.ndarray, k: int = 13) -> float:
    from scipy.fftpack import dct
    ca = dct(a, axis=-1, norm="ortho")[..., 1:k]
    cb = dct(b, axis=-1, norm="ortho")[..., 1:k]
    d = np.sqrt(2.0 * np.sum((ca - cb) ** 2, axis=-1))
    return float(np.mean((10.0 / np.log(10)) * d))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("blocks", nargs="*", type=int)
    p.add_argument("--random-init", action="store_true")
    p.add_argument("--trained", type=int, default=0)
    p.add_argument("--rings", action="store_true")
    p.add_argument("--lengths", default=None)
    p.add_argument("--config", choices=["moss", "tiny"], default="moss")
    p.add_argument("--device", default="cuda")
    p.add_argument("--tokens", type=int, default=120)
    return p.parse_args(argv)


def train_flow(model, cfg, steps: int, seed: int = 0):
    """``model`` fit for ``steps`` steps on the synthetic token -> mel
    task, in place (the JAX tool's ``_train_flow``)."""
    from ..training.train_step import (TrainState, make_flow_train_step,
                                       make_optimizer)
    dev = next(model.parameters()).device
    r = cfg.token_mel_ratio
    proto = np.random.RandomState(seed).randn(
        cfg.vocab_size, cfg.output_size).astype(np.float32) * 0.5
    bsz, tt = 8, 24

    def batch(i):
        rs = np.random.RandomState(seed + 1 + i)
        tok = rs.randint(0, cfg.vocab_size, (bsz, tt))
        feat = np.repeat(proto[tok], r, axis=1)
        ramp = 0.1 * np.sin(np.linspace(0, 6.28, tt * r, dtype=np.float32))
        feat = (feat + ramp[None, :, None] + 0.02 * rs.randn(
            *feat.shape)).astype(np.float32)
        t = lambda a: torch.as_tensor(a).to(dev)  # noqa: E731
        return {"speech_token": t(tok),
                "token_valid": t(np.ones((bsz, tt), bool)),
                "speech_feat": t(feat),
                "feat_valid": t(np.ones((bsz, tt * r), bool)),
                "embedding": t(rs.randn(bsz, cfg.spk_embed_dim).astype(
                    np.float32))}

    model.train()
    state = TrainState(0, model, make_optimizer()(model.parameters()))
    step = make_flow_train_step(model, dp=None)
    g = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.time()
    for i in range(steps):
        state, m = step(state, batch(i), generator=g)
        if i % 50 == 0 or i == steps - 1:
            print(f"# train step {i}: loss={float(m['loss']):.4f} "
                  f"({time.time() - t0:.0f}s)", file=sys.stderr, flush=True)
    return model.eval()


class Setup:
    """The flow and decoders of one run: weights, prompt, tokens."""

    def __init__(self, args, states=None):
        from ..models.flow import CausalMaskedDiffWithXvec
        from ..utils.device import resolve_device
        from ..weights import seeded_states
        self.dev = resolve_device(args.device)
        self.cfg, self.hcfg = configs(args.config)
        flow_state, self.hift_state = states or seeded_states(self.cfg,
                                                              self.hcfg)
        self.flow = CausalMaskedDiffWithXvec(self.cfg)
        self.flow.load_state_dict(flow_state)
        self.flow.to(self.dev).eval()
        self.weights = "random seed 0"
        if args.trained:
            train_flow(self.flow, self.cfg, args.trained)
            self.weights += f" + {args.trained} synthetic-fit steps"
        self.p = 4
        r = self.cfg.token_mel_ratio
        rng = np.random.RandomState(5)
        self.rng_tokens = lambda n: rng.randint(
            0, self.cfg.vocab_size, (1, self.p + n)).astype(np.int32)
        self.prompt_feat = rng.randn(1, self.p * r,
                                     self.cfg.output_size).astype(np.float32)
        self.emb = rng.randn(1, self.cfg.spk_embed_dim).astype(np.float32)

    def decoder(self, hop: int, window: int = 40):
        from ..pipeline import AudioDecoder
        from ..utils.config import PipelineConfig
        return AudioDecoder(
            self.cfg, self.hcfg,
            {k: v.detach() for k, v in self.flow.state_dict().items()},
            self.hift_state, PipelineConfig(block_size=hop, mel_cache_len=8,
                                            max_token_len=window),
            device=self.dev)

    @torch.inference_mode()
    def golden(self, tokens: np.ndarray) -> np.ndarray:
        """The full streaming forward's mel after the prompt."""
        t = torch.as_tensor(tokens).long().to(self.dev)
        mel = self.flow(t, torch.ones_like(t, dtype=torch.bool),
                        torch.as_tensor(self.prompt_feat).to(self.dev),
                        torch.as_tensor(self.emb).to(self.dev),
                        streaming=True, finalize=True)
        return mel.float().cpu().numpy()[:, self.p * self.cfg.token_mel_ratio:]

    @torch.inference_mode()
    def kv_mel(self, dec, tokens: np.ndarray, hop: int, ring: int):
        """The KV session's per-hop flow mel of ``tokens`` after the
        prompt."""
        n = tokens.shape[1] - self.p
        kv = dec.kv_stream_decoder(tokens[:, :self.p], self.prompt_feat,
                                   self.emb, block_size=hop, ring_tokens=ring,
                                   token_cap=self.p + n + 16)
        buf = kv._token_buf(tokens[:, self.p:])
        cache, _ = kv.init_state()
        cache = kv._prefill(buf, cache)
        mel, _ = kv._flow_mels(buf, cache, kv.schedule(n))
        return mel.float().cpu().numpy()

    @torch.inference_mode()
    def windowed_mel(self, dec, tokens: np.ndarray) -> np.ndarray:
        """The windowed device session's emit mels (the reference's
        serving semantics), in stream order."""
        sess = dec.device_stream_decoder(tokens[:, :self.p],
                                         self.prompt_feat, self.emb)
        n = tokens.shape[1] - self.p
        sess._token_buf(tokens[:, self.p:])
        sess.init_state()
        mels = []
        for key in sess.dispatches(n):
            sess._launch(key)
            if key[0] == "flow":
                mels.append(sess._mels[key[1], key[2]].float().cpu().clone())
            elif key[0] in ("fbatch", "fscan"):
                m = sess._mels[key[1]].float().cpu().clone()
                mels.append(m.transpose(0, 1).reshape(1, -1, m.shape[-1]))
        return torch.cat(mels, dim=1).numpy()


def _scores(win, inc, scale, band=True):
    out = {"mcd_db": _mcd_db(win, inc),
           "rel_mae": float(np.mean(np.abs(win - inc)) / scale)}
    if band:
        b = (np.mean(np.abs(win - inc), axis=(0, 1))
             / (np.mean(np.abs(win), axis=(0, 1)) + 1e-9))
        out.update(band_rel_max=float(b.max()), band_rel_mean=float(b.mean()))
    return out


def length_sweep(s: Setup, lengths):
    out = {"protocol": f"p={s.p} block=5 window=40, weights={s.weights}",
           "lengths": {}}
    tokens_all = s.rng_tokens(max(lengths))
    dec = s.decoder(5)
    for n in lengths:
        t0 = time.time()
        tokens = tokens_all[:, :s.p + n]
        win = s.golden(tokens)
        scale = float(np.mean(np.abs(win)))
        row = {"mean_abs_golden": scale}
        wmel = s.windowed_mel(dec, tokens)
        row["windowed40"] = _scores(win, wmel, scale, band=False)
        for ring in (35, 70, 105):
            inc = s.kv_mel(dec, tokens, 5, ring)
            row[f"ring{ring}"] = dict(
                _scores(win, inc, scale, band=False),
                mcd_vs_windowed_db=_mcd_db(wmel, inc))
        row["wall_s"] = time.time() - t0
        out["lengths"][n] = row
        print(json.dumps({f"n={n}": row}), file=sys.stderr, flush=True)
    return out


def main(argv=None, states=None):
    """``states``: the seeded (flow, hift) state dicts of ``--config``'s
    modules, when the caller holds them already."""
    args = parse_args(argv)
    if not args.random_init:
        raise RuntimeError(WEIGHTS_REASON)
    s = Setup(args, states)
    if args.lengths:
        out = length_sweep(s, [int(x) for x in args.lengths.split(",")])
        print(json.dumps(out), flush=True)
        return out
    blocks = args.blocks or [5, 10, 15, 20]
    ring_sweep = None
    if args.rings:
        ring_sweep = args.blocks or [35, 70, 105]
        blocks = [5] * len(ring_sweep)
    tokens = s.rng_tokens(args.tokens)
    win = s.golden(tokens)
    scale = float(np.mean(np.abs(win)))
    out = {"protocol": f"p={s.p} n={args.tokens}, weights={s.weights}",
           "mean_abs_golden": scale, "blocks": {}}
    for i, hop in enumerate(blocks):
        ring = ring_sweep[i] if ring_sweep else 40 - hop   # serving default
        inc = s.kv_mel(s.decoder(hop), tokens, hop, ring)
        assert inc.shape == win.shape, (inc.shape, win.shape)
        key = f"ring{ring}" if ring_sweep else hop
        out["blocks"][key] = dict(ring_tokens=ring,
                                  **_scores(win, inc, scale))
        print(json.dumps({str(key): out["blocks"][key]}), file=sys.stderr,
              flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
