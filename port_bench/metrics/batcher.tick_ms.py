"""``batcher.tick_ms``: milliseconds of ``KVContinuousBatcher.pump`` a
wavefront tick: the benchmark's span around each pump in the window
outside the traced slice, summed, over the growth of the batcher's own
``ticks`` counter in those pumps (a pump also encodes, vocodes and
finalizes, so this is the whole batcher's time a tick)."""

LAYER = "continuous batcher"
MOVES = "audio_x_realtime"
WORKLOADS = ["moss_serve16"]


def read(run):
    pumps = [p for p in run.counters.get("pumps", [])
             if run.t0 <= p["t"] < run.t1 and not p["traced"]]
    ticks = sum(p["ticks"] for p in pumps)
    if not ticks:
        return None
    return 1e3 * sum(p["t_end"] - p["t"] for p in pumps) / ticks
