"""Lane-sharded multi-stream serving over several devices, after the JAX
package's ``pipeline/spmd_session.py``.

The lockstep KV session (``kv_session.py``, ``batch=B``) has no cross-lane
math: every estimator, encoder and vocoder op treats a stream (and its CFG
double) alone.  JAX partitions the whole decode with ``shard_map`` over a
1-D mesh, zero collectives.  PyTorch has no partitioned program, so the
port runs one replica per device: an ``AudioDecoder`` on that device (the
decoder itself on its own device; replicas on one device share one) with
its own lockstep ``kv_stream_decoder(batch=B / n)``, whose wavefront
launches ``fused_tf_group`` on the card.  Stream i goes to replica
``i // (B / n)``; a prompt with a leading dim of 1 is shared by every
stream.  Still no collective and no cross-device tensor
(``replica_devices`` shows where every tensor of a replica lives).

A decode enqueues every replica's work, in replica order, before it reads
any result back, so n cards run side by side once each is enqueued.
Replicas on one device run one after another on its stream.  Each replica's graphs live in its own
pool on its device.  ``devices=[d]`` is ``kv_stream_decoder(batch=B)`` on
``d``.

Scope, as in JAX: homogeneous fan-out (all streams of one length and one
hop plan, at least two steady hops); heterogeneous arrival is the
continuous batcher's job.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


def _tensors(obj, seen=None):
    """Every tensor reachable from ``obj`` through attributes, mappings,
    sequences and modules (the session's buffers and its decoder's
    weights)."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, torch.nn.Module):
        yield from obj.parameters()
        yield from obj.buffers()
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v, seen)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v, seen)
    elif hasattr(obj, "__dict__") and not isinstance(obj, type):
        for v in vars(obj).values():
            yield from _tensors(v, seen)


class SPMDKVDecoder:
    """Lockstep KV decoding of ``batch`` streams split over ``devices``, one
    replica each (a device may repeat).  ``decode(tokens)`` takes (batch,
    n) tokens, ``batch`` a multiple of the replica count (default one
    stream a replica), and returns (batch, samples) float32 audio (or
    16-bit PCM).  Keyword arguments as ``kv_stream_decoder``'s."""

    def __init__(self, dec, devices: Sequence, prompt_token=None,
                 prompt_feat=None, embedding=None,
                 block_size: Optional[int] = None,
                 ring_tokens: Optional[int] = None, token_cap: int = 2048,
                 batch: Optional[int] = None, **session_kw):
        self.devices = [torch.device(d) for d in devices]
        n = len(self.devices)
        if n == 0:
            raise ValueError("no devices")
        self.b = batch or n
        if self.b % n:
            raise ValueError(f"batch {self.b} does not split over {n} "
                             "replicas")
        self.b_local = self.b // n
        prompt_token, prompt_feat, embedding = dec._defaults(
            prompt_token, prompt_feat, embedding)
        decoders: Dict[str, object] = {}
        self.replicas = []
        for i, d in enumerate(self.devices):
            key = str(d)
            if key not in decoders:
                decoders[key] = (dec if _same(d, dec.device)
                                 else dec.replica(d))
            rows = slice(i * self.b_local, (i + 1) * self.b_local)

            def mine(a):
                a = np.asarray(a)
                return a if a.shape[0] == 1 else a[rows]
            self.replicas.append(decoders[key].kv_stream_decoder(
                mine(prompt_token), mine(prompt_feat), mine(embedding),
                block_size=block_size, ring_tokens=ring_tokens,
                token_cap=token_cap, batch=self.b_local, **session_kw))
        loc = self.replicas[0]
        self.hop, self.la, self.ratio = loc.hop, loc.la, loc.ratio

    def schedule(self, n_tokens: int):
        return self.replicas[0].schedule(n_tokens)

    @torch.inference_mode()
    def decode(self, tokens: np.ndarray, output: str = "float32"
               ) -> np.ndarray:
        """tokens (batch, n) -> audio (batch, samples), float32 or, with
        ``output="int16"``, 16-bit PCM quantized on each device."""
        if output not in ("float32", "int16"):
            raise ValueError(f"output {output!r}: 'float32' or 'int16'")
        tokens = np.asarray(tokens)
        if tokens.ndim != 2 or tokens.shape[0] != self.b:
            raise ValueError(f"tokens {tokens.shape}: {self.b} streams")
        n = int(tokens.shape[1])
        plan = self.schedule(n)
        steady = sum(1 for _, fin in plan if not fin)
        assert steady >= 2, "SPMD decoder needs >= 2 steady hops"
        fetches = []                    # every replica enqueued first
        for i, rep in enumerate(self.replicas):
            if rep.dev.type == "cuda" and rep.dev.index is not None:
                torch.cuda.set_device(rep.dev)
            wav = rep.launch(tokens[i * self.b_local:(i + 1) * self.b_local])
            fetches.append(rep._enqueue_fetch([wav], wav.shape[1], output))
        outs = []
        for host, done in fetches:
            if done is not None:
                done.synchronize()
            outs.append(host.numpy())
        return np.concatenate(outs, axis=0)

    def program_flops(self, n_tokens: int) -> float:
        """The FLOPs one ``decode`` of ``n_tokens``-token streams runs: the
        sum of the replicas' (``KVStreamDecoder.program_flops``)."""
        return float(sum(r.program_flops(n_tokens) for r in self.replicas))

    def replica_devices(self) -> List[set]:
        """For each replica, the devices its tensors live on (its session's
        buffers and its decoder's weights): the zero-collective check, one
        device a replica."""
        return [{_norm(t.device) for t in _tensors(r)}
                for r in self.replicas]


def _norm(d: torch.device) -> str:
    if d.type == "cuda":
        return f"cuda:{d.index if d.index is not None else 0}"
    return d.type


def _same(a: torch.device, b: torch.device) -> bool:
    return _norm(torch.device(a)) == _norm(torch.device(b))
