"""``batcher.first_chunk_ticks``: p95 over the requests opened in the
window of the batcher's wavefront ticks from the lane's prefill to its
first chunk handed out (at least S, the ODE steps, for a stream without a
prompt; a pump hands its chunks out after its last tick)."""

from port_bench.harness import telemetry

LAYER = "continuous batcher"
MOVES = "first_audio_p95_ms"
WORKLOADS = ["moss_serve16"]


def read(run):
    return telemetry.p95([r.get("first_ticks")
                          for r in telemetry.requests(run)])
