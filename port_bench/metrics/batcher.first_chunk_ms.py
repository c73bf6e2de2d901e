"""``batcher.first_chunk_ms``: p95 over the requests opened in the window
of ``finish`` done -> the first chunk put on the stream's queue (the pump
in flight, the request's prefill and encoder hops, its S ticks and the
rest of their bursts; the program's own stamps)."""

from port_bench.harness import telemetry

LAYER = "continuous batcher"
MOVES = "first_audio_p95_ms"
WORKLOADS = ["moss_serve16"]


def read(run):
    return telemetry.p95([1e3 * (r["first_chunk"] - r["finished"])
                          for r in telemetry.requests(run)])
