"""Launch the continuous-batching token -> wav HTTP server of the port.

    python -m moss_speech_decoder_cosy_torch.bin.decode_server \
        --port 10010 --lanes 4 --model_dir DIR --bf16

``POST /decode_stream`` with JSON ``{"tokens": [[...]], "prompt_token"?,
"prompt_feat"?, "embedding"?, "format": "pcm16"|"oggopus"}`` streams the
decoded audio back while later chunks are still being computed
(``serving/audio_batcher.py``).  Concurrent requests share one estimator
wavefront (``pipeline/kv_batcher.py``).  At boot ``boot_warmup_batcher``
builds the kernels and captures the batcher's CUDA graphs, so the first
request only replays them.  Needs aiohttp; runs on the CUDA card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse

from .inference import add_model_args, build_decoder


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=10010)
    p.add_argument("--lanes", type=int, default=4)
    p.add_argument("--ring_tokens", type=int, default=None)
    p.add_argument("--token_cap", type=int, default=1024)
    p.add_argument("--no_warmup", action="store_true")
    add_model_args(p)
    args = p.parse_args(argv)

    from ..serving.audio_batcher import (AudioBatchEngine,
                                         AudioBatcherHTTPServer)
    from ..serving.boot import boot_warmup_batcher

    dec, _ = build_decoder(args)
    engine = AudioBatchEngine(dec, n_lanes=args.lanes,
                              block_size=args.block_size,
                              ring_tokens=args.ring_tokens,
                              token_cap=args.token_cap)
    server = AudioBatcherHTTPServer(engine, host=args.host, port=args.port)
    if not args.no_warmup:
        boot_warmup_batcher(engine.batcher, pump_iters=engine.pump_iters)
    print(f"decode server ready: {args.lanes} lanes on "
          f"{args.host}:{args.port}")
    server.run()


if __name__ == "__main__":
    main()
