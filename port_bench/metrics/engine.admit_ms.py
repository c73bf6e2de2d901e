"""``engine.admit_ms``: mean milliseconds of ``AudioBatchEngine.open`` (the
wait for a free lane, the admission, the pump task's start), from the
benchmark's span around each call opened in the window outside the traced
slice."""

LAYER = "serving engine"
MOVES = "first_audio_p95_ms"
WORKLOADS = ["moss_serve16"]


def read(run):
    spans = run.spans.items.get("engine.open", []) if run.spans else []
    lo, hi = run.slice or (run.t1, run.t1)
    got = [b - a for a, b in spans
           if run.t0 <= a < run.t1 and not (lo <= a <= hi)]
    return 1e3 * sum(got) / len(got) if got else None
