"""``lm.decode_step_ms``: the mean host time of one batched decode step over
the slots, its logits fetched to the host, over the steps that began in the
window (the fixture driver's counters ``lm.decode_steps`` and
``lm.decode_s``)."""

LAYER = "slot decode"
MOVES = "audio_x_realtime"
WORKLOADS = ["lm_slots4"]


def read(run):
    steps = run.counters.get("lm.decode_steps")
    if not steps:
        return None
    return 1000.0 * run.counters["lm.decode_s"] / steps
