"""``device_idle_share``: the share of the traced slice in which no
operation ran on the device, in percent (between the marker kernels; the
union of every kernel, copy and fill)."""

LAYER = "device"
MOVES = "audio_x_realtime"
WORKLOADS = ["moss_serve16", "cosyvoice1_offline_long"]


def read(run):
    t = run.trace
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
