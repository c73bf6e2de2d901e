"""``batcher.enc_ms``: device ms of the pumps' ``batcher.encode`` phase
(the deferred prefills and every lane's encoder hops), between the CUDA
events at its edges, per wavefront tick of the window's pumps."""

from port_bench.harness import telemetry

LAYER = "continuous batcher"
MOVES = "audio_x_realtime"
WORKLOADS = ["moss_serve16"]


def read(run):
    return telemetry.phase_device_ms(run, "batcher.encode")
