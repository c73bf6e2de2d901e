"""``graphs.launch_ms``: host ms inside CUDA graph replays (the program's
``graphs.<key>`` spans: tick, enc, voc, fin) that started inside the
window's pumps, per wavefront tick of those pumps."""

from port_bench.harness import telemetry

LAYER = "host dispatch"
MOVES = "audio_x_realtime"
WORKLOADS = ["moss_serve16"]


def read(run):
    ps = telemetry.pumps(run)
    spans = telemetry.inside_pumps("graphs.", ps)
    if not spans:
        return None
    return telemetry.per_tick_ms(run, 1e3 * sum(s.t1 - s.t0 for s in spans),
                                 ps)
