"""Runs one cell of ``BENCHMARK.json`` once and prints one JSON line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (the program built, its weights drawn on the card from the seed,
every shape the cell uses warmed), then a window of ``--seconds`` of the
cell's traffic, then the check of the served outputs against the plain
reference, through the configuration's family (``families/``).
``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics, read in the same kind of run with a slice of the window
under the profiler.  Exits non-zero and prints no result
without the card(s) the cell asks for, or when JAX or the JAX package is
loaded.  The last lines on standard error are the numbers compared with
their limits.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def _env() -> None:
    """Build and kernel caches at fixed paths inside the checkout, and no
    JAX behind any library."""
    build = REPO / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def _finite(v):
    return v if math.isfinite(v) else 1e30


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float = T_START) -> dict:
    """One run of ``cell`` on ``device``: the result line's dict."""
    import torch
    from port_bench.harness import check as check_mod
    from port_bench.harness import window

    drv = cell.driver().Driver(cell, seed, torch.device(device), trace)
    cuda = drv.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t_setup = time.perf_counter()
    drv.setup()
    res = drv.run(seconds)
    setup_s = res.t0 - t_start
    parts = dict(drv.setup_parts, before_setup=t_setup - t_start)
    summ = window.summarize(res.records, res.t0, res.t1, drv.sample_rate)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    counted = {r.index for r in window.sent_in(res.records, res.t0, res.t1)}
    served = {i: s for i, s in drv.served().items() if i in counted}
    lengths = {i: s.tokens.shape[0] for i, s in served.items()}
    drv.close()
    del drv
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    sample = check_mod.choose(list(served), lengths,
                              cell.cell["check"]["sample"], seed)
    fam = cell.family()
    states = fam.states(cell, seed, device)
    pairs = [(served[i].output,
              fam.reference_output(cell, served[i], states, device))
             for i in sample]
    readings, each = fam.compare(cell, pairs)
    t_checked = time.perf_counter()
    ok, compared = check_mod.verdict(readings, cell.cell["check"]["limits"])
    correct = bool(ok and summ["failed"] == 0 and len(sample) > 0)

    if trace:
        metrics = {}
        readers = cell.readers()
        for m in cell.per_layer:
            val = readers[m["name"]].read(res)
            if val is not None:
                metrics[m["name"]] = {"value": float(val), "unit": m["unit"]}
    else:
        e2e = dict(summ, setup_s=setup_s)
        metrics = {m["name"]: {"value": _finite(float(e2e[m["name"]])),
                               "unit": m["unit"]} for m in cell.end_to_end}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": summ["attempted"],
           "failed": summ["failed"], "metrics": metrics, "device": dev}
    if trace and res.trace is not None:
        dev["busy_s"] = res.trace["busy_s"]
        dev["window_s"] = res.trace["window_s"]
        out["breakdown"] = res.trace["breakdown"]
    out["readings"] = {k: _finite(v) for k, v in readings.items()}
    out["timing_s"] = {"setup": setup_s, "setup_parts": parts,
                       "window": res.t1 - res.t0,
                       "drain": res.t_done - res.t1,
                       "check": t_checked - res.t_done}
    out["sample"] = [[i, lengths[i], *[_finite(v) for v in g]]
                     for i, g in zip(sample, each)]
    out["check"] = {k: {"value": _finite(v["value"]), "limit": v["limit"]}
                    for k, v in compared.items()}
    out["check"]["failed_requests"] = {"value": summ["failed"], "limit": 0}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _env()
    from port_bench.harness import guard, spec
    try:
        cell = spec.resolve(args.workload)
    except spec.SpecError as e:
        print(f"port_bench: {e}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"port_bench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    bad = guard.forbidden_loaded()
    if bad:
        print(f"port_bench: the process holds {sorted(bad)}; no result",
              file=sys.stderr)
        return 4
    print(f"timing_s {json.dumps(out['timing_s'])}", file=sys.stderr)
    for name, v in out["check"].items():
        print(f"check {name} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
