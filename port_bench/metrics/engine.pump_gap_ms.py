"""``engine.pump_gap_ms``: the engine's pump loop's time outside
``KVContinuousBatcher.pump`` while a stream is open (fan-out, lock waits,
idle sleeps, executor hops; the program's ``engine.pump_gap`` spans that
started in the window) per wavefront tick of the window's pumps."""

from port_bench.harness import telemetry

LAYER = "serving engine"
MOVES = "audio_x_realtime"
WORKLOADS = ["moss_serve16"]


def read(run):
    tel = telemetry.store()
    if tel is None:
        return None
    gaps = telemetry.in_window(run, tel.spans("engine.pump_gap"))
    return telemetry.per_tick_ms(run, 1e3 * sum(s.t1 - s.t0 for s in gaps),
                                 telemetry.pumps(run))
