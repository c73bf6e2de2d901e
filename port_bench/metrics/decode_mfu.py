"""``decode_mfu``: the model FLOPs of the audio delivered in the window
over the window's seconds and the chip's peak at the configuration's
precision, in percent.  The FLOPs are ``model_flops``'s count from the
configuration: a streamed request's delivered samples at its steady-state
FLOPs a mel frame; an offline request's whole count once its audio
arrived."""

from port_bench.harness import model_flops
from port_bench.harness.roofline import peak_flops

LAYER = "model step"
MOVES = "audio_x_realtime"
WORKLOADS = ["moss_serve16", "cosyvoice1_offline_long"]


def read(run):
    cfg = run.cell.config
    mode = run.cell.cell["flops"]
    flops = 0.0
    if mode == "stream":
        frame = model_flops.stream_frame_flops(cfg)
        up = cfg["hift"]["istft_hop_len"]
        for r in cfg["hift"]["upsample_rates"]:
            up *= r
        samples = sum(n for rec in run.records for t, n in rec.chunks
                      if run.t0 <= t < run.t1)
        flops = samples / up * frame
    elif mode == "offline_v1":
        flops = sum(model_flops.offline_v1_flops(cfg, rec.n_tokens)
                    for rec in run.records
                    if rec.ok and run.t0 <= rec.t_last < run.t1)
    if not flops:
        return None
    return 100.0 * flops / (run.t1 - run.t0) / peak_flops(cfg["precision"])
