"""``engine.queue_ms``: p95 over the requests opened in the window of the
decode server's ``open`` entered -> ``finish`` done: the wait for a lane,
the waits for the engine lock, and the admit, push and finish calls (the
program's own stamps, ``serving/audio_batcher.py``)."""

from port_bench.harness import telemetry

LAYER = "serving engine"
MOVES = "first_audio_p95_ms"
WORKLOADS = ["moss_serve16"]


def read(run):
    return telemetry.p95([1e3 * (r["finished"] - r["open"])
                          for r in telemetry.requests(run)])
