"""``host_launches_per_audio_s``: the host's kernel launch calls
(``cudaLaunchKernel``, ``cudaLaunchKernelExC``, ``cudaGraphLaunch``) in the
traced slice over the seconds of audio the clients received in it."""

LAYER = "host dispatch"
MOVES = "audio_x_realtime"
WORKLOADS = ["moss_serve16", "cosyvoice1_offline_long"]


def read(run):
    if not run.trace or not run.slice:
        return None
    lo, hi = run.slice
    samples = sum(n for rec in run.records for t, n in rec.chunks
                  if lo <= t <= hi)
    calls = sum(run.trace["launches"].values())
    if not samples or not calls:
        return None
    return calls / (samples / run.sample_rate)
