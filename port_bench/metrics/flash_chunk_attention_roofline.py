"""``flash_chunk_attention_roofline``: the least time of the traced
slice's ``flash_chunk_attention`` launches over their device time, in
percent.  Each Euler step of a v1 ``token2wav`` attends over (2 CFG rows,
heads, T, head_dim) at every level of the U-Net: ``2 n_blocks`` launches
at a level's length ceil(T / 2^level), and the mid blocks' at the last
level; each launch's least time is ``roofline.attention_bound_s`` (full
attention, all keys valid) in the configuration's precision."""

import re

from port_bench.harness.model_flops import v1_mel_len
from port_bench.harness.roofline import attention_bound_s

LAYER = "kernels"
MOVES = "audio_x_realtime"
WORKLOADS = ["cosyvoice1_offline_long"]
KERNEL = re.compile(r"flash_(?:f32|bf16)_kernel")


def request_bound_s(cfg, n_tokens: int) -> float:
    est = cfg["flow"]["estimator"]
    dtype = cfg["precision"]["compute_dtype"]
    levels, nb = len(est["channels"]), est["n_blocks"]
    t = v1_mel_len(cfg, n_tokens)
    step = 0.0
    for lvl in range(levels):
        tl = -(-t // 2 ** lvl)
        n = 2 * nb + (est["num_mid_blocks"] * nb if lvl == levels - 1 else 0)
        step += n * attention_bound_s(2, est["num_heads"], tl,
                                      est["attention_head_dim"], 0, tl, dtype)
    return cfg["flow"]["cfm"]["n_timesteps"] * step


def read(run):
    if not run.trace:
        return None
    dev_s = sum(v[1] for k, v in run.trace["kernels"].items()
                if KERNEL.search(k))
    bound = sum(request_bound_s(run.cell.config, n)
                for n in run.counters.get("traced_requests", []))
    if not dev_s or not bound:
        return None
    return 100.0 * bound / dev_s
