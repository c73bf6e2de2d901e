"""``batcher.useful_rows``: the share of the wavefront's rows whose ring
write is enabled (the kernel's per-row write flag: an advancing lane's ODE
step on an existing chunk), of the S x 2 x lanes rows each tick computes,
in percent, over the ticks of the window's pumps (the batcher's counters
``batcher.rows_useful`` and ``batcher.rows_computed``)."""

from port_bench.harness import telemetry

LAYER = "continuous batcher"
MOVES = "audio_x_realtime"
WORKLOADS = ["moss_serve16"]


def read(run):
    ps = telemetry.pumps(run)
    computed = telemetry.counted(run, "batcher.rows_computed", ps)
    if not computed:
        return None
    return 100.0 * telemetry.counted(run, "batcher.rows_useful", ps) / computed
