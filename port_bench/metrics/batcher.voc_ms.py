"""``batcher.voc_ms``: device ms of the pumps' ``batcher.emit`` phase (the
lanes' vocoder hops and audio copies) less its ``batcher.finalize`` tails,
between the CUDA events at their edges, per wavefront tick of the window's
pumps."""

from port_bench.harness import telemetry

LAYER = "continuous batcher"
MOVES = "audio_x_realtime"
WORKLOADS = ["moss_serve16"]


def read(run):
    return telemetry.phase_device_ms(run, "batcher.emit")
