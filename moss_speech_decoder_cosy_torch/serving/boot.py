"""Boot-time warm-up of the serving paths (the JAX package's
``serving/boot.py``).

What a first request would otherwise pay, paid before the server accepts
traffic:

- the CUDA kernels built (``ops/cuda_build.build_all``: one ``nvcc`` per
  source) and the host C++ library (``native``);
- the batcher's CUDA graphs captured (``boot_warmup_batcher``: the tick,
  the encoder hop, the steady vocoder hop and one finalize hop per tail
  length);
- the streaming session's and the tokenizer's first calls made
  (``boot_warmup``: cuDNN and cuBLAS pick their kernels, the allocator
  grows its pools).

The throwaway streams are the JAX package's (``boot.py:40-129``).  The JAX
package also points XLA at a persistent compilation cache; the port has no
compilation cache to keep (its kernels are built once per checkout, into
``build/``), so there is no counterpart of ``enable_persistent_cache``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import native


def _build_kernels(device: torch.device) -> None:
    native.available()
    if device.type == "cuda":
        from ..ops import cuda_build
        cuda_build.build_all()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def boot_warmup(codec=None, decoder=None, prompt=None,
                n_tokens: int = 64, verbose: bool = True) -> float:
    """Warms the websocket path before the first request.

    ``codec``: a ``SpeechCodec`` (its streaming tokenizer is warmed too),
    or ``decoder``: a bare ``AudioDecoder``.  ``prompt``: the prompt the
    real sessions use (its length sets the first hop's window, so warm with
    the same geometry).  Returns the wall seconds spent."""
    t0 = time.perf_counter()
    dec = decoder if decoder is not None else codec.decoder
    _build_kernels(dec.device)
    if prompt is not None:
        session = dec.new_session(prompt.token, prompt.feat,
                                  prompt.embedding)
    else:
        session = dec.new_session()
    rng = np.random.RandomState(0)
    toks = rng.randint(0, dec.flow_cfg.vocab_size, (n_tokens,))
    # hop-sized pieces, then the finalize: the first hop, the steady hops
    # and the tail
    for i in range(0, n_tokens, dec.pipe_cfg.block_size):
        list(session.push(toks[i:i + dec.pipe_cfg.block_size]))
    list(session.finish())
    if codec is not None:
        enc = codec.new_encode_session()
        frame = int(0.08 * 16000)
        for _ in range(3):
            list(enc.push(rng.randn(frame).astype(np.float32) * 0.01))
    _sync(dec.device)
    dt = time.perf_counter() - t0
    if verbose:
        print(f"# boot_warmup: serving path ready in {dt:.1f}s")
    return dt


def boot_warmup_batcher(batcher, prompt=None, pump_iters: int = 8,
                        warm_tails: bool = True,
                        verbose: bool = True) -> float:
    """Warms the continuous batcher (``pipeline/kv_batcher.py``) that will
    serve: the lane prefill with the prompt geometry real requests use, the
    promptless admit, the encoder hop, the wavefront tick at ``pump_iters``
    (the engine's), the first and the batched steady vocoder hops and,
    with ``warm_tails``, one finalize hop per possible tail length (tail =
    lookahead + (n - lookahead) % hop).  On the card each of those steps is captured as a
    CUDA graph here, so requests after it only replay.

    Warm the instance that will serve: graphs belong to their batcher."""
    t0 = time.perf_counter()
    d = batcher.dec
    _build_kernels(batcher.dev)
    hop, la = batcher.hop, batcher.la
    rng = np.random.RandomState(0)

    def run_stream(n_tokens: int, use_prompt: bool) -> None:
        if use_prompt and prompt is not None:
            lane = batcher.admit(prompt.token, prompt.feat,
                                 prompt.embedding)
        else:
            lane = batcher.admit(
                np.zeros((1, 0), np.int32),
                np.zeros((1, 0, d.flow_cfg.output_size), np.float32),
                np.zeros((1, d.flow_cfg.spk_embed_dim), np.float32))
        toks = rng.randint(0, d.flow_cfg.vocab_size,
                           (1, n_tokens)).astype(np.int32)
        batcher.push(lane, toks)
        batcher.finish(lane)
        while batcher._lanes[lane].active:
            batcher.pump(max_iters=pump_iters)

    # 13 steady hops; the tail of length la (r = 0)
    run_stream(la + hop * 13, prompt is not None)
    # the promptless admit, then the tails la + 1 .. la + hop - 1
    run_stream(la + hop, False)
    if warm_tails:
        for r in range(1, hop):
            run_stream(la + hop + r, prompt is not None)
    _sync(batcher.dev)
    dt = time.perf_counter() - t0
    if verbose:
        print(f"# boot_warmup_batcher: serving path ready in {dt:.1f}s")
    return dt
