"""``fused_tf_group_roofline``: the least time of the traced slice's
``fused_tf_group`` launches over their device time, in percent.  Each
wavefront tick launches the estimator's down group (320 input channels),
its mid groups (one a mid block) and its up group (512) over S x 2 x lanes
rows; each launch's least time is ``roofline.group_bound_s`` at the rows'
valid ring slots and enabled writes, taken from the lanes' host state
before each traced pump."""

import re

from port_bench.harness.roofline import group_bound_s, lanes_tick_rows

LAYER = "kernels"
MOVES = "audio_x_realtime"
WORKLOADS = ["moss_serve16"]
KERNEL = re.compile(r"fused_tf_group_kernel")


def read(run):
    if not run.trace:
        return None
    dev_s = sum(v[1] for k, v in run.trace["kernels"].items()
                if KERNEL.search(k))
    cfg = run.cell.config
    fl, est = cfg["flow"], cfg["flow"]["estimator"]
    dtype = (cfg["precision"].get("estimator_dtype")
             or cfg["precision"]["compute_dtype"])
    ch, heads, hd = est["channels"][0], est["num_heads"], est["attention_head_dim"]
    cf = cfg["pipeline"]["block_size"] * fl["token_mel_ratio"]
    rp = cfg["serving"]["ring_tokens"] * fl["token_mel_ratio"] + cf
    s_steps = fl["cfm"]["n_timesteps"]
    groups = ([est["in_channels"]] + [ch] * est["num_mid_blocks"] + [2 * ch])
    bound = 0.0
    for p in run.counters.get("pumps", []):
        if not p["traced"]:
            continue
        w = [list(lane) for lane in p["lanes"]]
        for _ in range(p["ticks"]):
            nd, en = lanes_tick_rows(w, s_steps, cf)
            for cin in groups:
                bound += group_bound_s(len(nd), cf, cin, ch, heads * hd,
                                       4 * ch, 4 * ch, est["n_blocks"], rp,
                                       nd, en, dtype)
            for lane in w:
                lane[0] = min(lane[0] + 1, max(lane[1], lane[0]))
    if not dev_s or not bound:
        return None
    return 100.0 * bound / dev_s
