"""The chip's peaks and the least time of a kernel launch.

Peaks are NVIDIA's H100 SXM data-sheet figures (dense, no sparsity), at the
full 700 W power limit.  A launch's least time is the larger of its
operations over the peak of its precision and its bytes over HBM bandwidth.

The formulas are frozen copies of ``chip_smoke.py``'s ``attention_bound_ms``
and ``group_bound_ms``, which give the bound column of the kernel table in
``PERF.md``; ``tests/test_bench_roofline.py`` holds them to that column.
"""

from __future__ import annotations

from typing import Sequence

PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
PEAK_BYTES = 3.35e12


def peak_flops(precision: dict) -> float:
    """The peak of a configuration's ``precision`` entry: bf16 on the
    tensor cores; f32 on the CUDA cores, or in TF32 where it allows TF32."""
    dt = precision["compute_dtype"]
    if dt == "bfloat16":
        return PEAK_FLOPS["bfloat16"]
    return PEAK_FLOPS["tf32" if precision.get("tf32") else "float32"]


def _elem(dtype: str) -> int:
    return 2 if dtype == "bfloat16" else 4


def attention_bound_s(b: int, h: int, t: int, dk: int, chunk: int,
                      valid_len: int, dtype: str) -> float:
    """Least seconds of one ``flash_chunk_attention`` call: q read and out
    written over all T rows, k and v read up to ``valid_len``; 2 QK^T + 2 PV
    flops per visible (query, key) pair and feature."""
    nbytes = (2 * t + 2 * valid_len) * b * h * dk * _elem(dtype)
    if chunk == 0:
        pairs = t * valid_len
    else:
        pairs = sum(min(valid_len, (i // chunk + 1) * chunk)
                    for i in range(t))
    flops = 4 * pairs * dk * b * h
    return max(nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype])


def group_bound_s(rows: int, cf: int, cin: int, ch: int, inner: int,
                  ff: int, tdim: int, n_layers: int, rp: int,
                  nd: Sequence[int], enable: Sequence[int],
                  dtype: str) -> float:
    """Least seconds of one ``fused_tf_group`` call.  Bytes: every input
    read once (x, mt, conv caches, the group's weights, and of each layer's
    ring only the valid slots the chunk does not overwrite), every output
    written once (x_out, conv caches, the enabled rows' chunk K/V).
    Operations: the resnet's convs and time projection, each layer's QKV,
    out-projection and FF products, and QK^T and A V over each row's valid
    slots."""
    elem = _elem(dtype)
    valid = [min(int(n), rp) for n in nd]
    written = [cf if e else 0 for e in enable]
    res_w = 3 * cin * ch + 3 * ch * ch + tdim * ch + cin * ch + 7 * ch
    tf_w = n_layers * (3 * ch * inner + inner * ch + 2 * ch * ff + 6 * ch
                       + ff)
    ring_read = n_layers * sum(max(v - w, 0) for v, w in
                               zip(valid, written)) * 2 * inner
    ring_write = n_layers * sum(written) * 2 * inner
    nbytes = elem * (rows * (cf * cin + tdim + 2 * cin + 2 * ch)
                     + res_w + tf_w + ring_read + ring_write
                     + rows * (cf * ch + 2 * cin + 2 * ch))
    flops = (2 * rows * cf * (3 * cin * ch + 3 * ch * ch + cin * ch)
             + 2 * rows * tdim * ch
             + n_layers * 2 * rows * cf * (3 * ch * inner + inner * ch
                                           + 2 * ch * ff)
             + n_layers * 4 * sum(valid) * cf * inner)
    return max(nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype])


def lanes_tick_rows(lanes: Sequence[Sequence[int]], s_steps: int, cf: int):
    """The per-row (valid slots + chunk, enable) of one wavefront tick of
    the continuous batcher, rows ordered (step, CFG half, lane), from each
    lane's (w, avail, k_total, base frames): step s of a lane works on its
    chunk w - s, enabled while that chunk exists and the lane advances."""
    nd, enable = [], []
    for s in range(s_steps):
        for _ in range(2):
            for w, avail, k_total, base in lanes:
                h = w - s
                nd.append(base + max(h, 0) * cf + cf)
                enable.append(int(0 <= h < k_total and w < avail))
    return nd, enable
