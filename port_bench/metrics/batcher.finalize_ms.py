"""``batcher.finalize_ms``: device ms of the lanes' finalize tails
(``batcher.finalize``: the finalize hop, the last vocoder hop, the lane's
rows cleared), between the CUDA events at their edges, per wavefront tick
of the window's pumps."""

from port_bench.harness import telemetry

LAYER = "continuous batcher"
MOVES = "audio_x_realtime"
WORKLOADS = ["moss_serve16"]


def read(run):
    return telemetry.phase_device_ms(run, "batcher.finalize")
