"""``batcher.wave_ms``: device ms of the pumps' ``batcher.wave`` phase (the
wavefront tick replays and the fetch of their valid flags), between the
CUDA events at its edges, per wavefront tick of the window's pumps."""

from port_bench.harness import telemetry

LAYER = "continuous batcher"
MOVES = "audio_x_realtime"
WORKLOADS = ["moss_serve16"]


def read(run):
    return telemetry.phase_device_ms(run, "batcher.wave")
