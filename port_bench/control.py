"""The control of a cell's check: the plain reference put in the program's
place, computed one precision below the configuration's, compared with the
reference as the check compares the program.

    python3 port_bench/control.py --workload <cell> --seeds 1,2,3 \
        [--precision fp8] [--first 64]

For each seed: the weights and the traffic of that seed, a sample drawn as a
run draws it (the longest and ``sample - 1`` others, here from the first
``--first`` requests, which a run's window finishes), each request's
reference output (the configuration's family, ``families/``) in float32 and
in the control's precision (the cell's ``check.control``), and the check's
readings of the pair.  Prints one JSON line per seed; the benchmark's runs
never run this.  A cell's limits sit between the program's readings over a
dozen seeds and these.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def control_readings(cell, seed: int, device, precision: str = None,
                     first: int = 64) -> dict:
    from port_bench.harness import check
    from port_bench.harness.traffic import Traffic
    precision = precision or cell.cell["check"]["control"]
    traffic = Traffic(cell.traffic, seed)
    reqs = [traffic.get(i) for i in range(first)]
    lengths = {r.index: r.n_tokens for r in reqs}
    sample = check.choose(list(lengths), lengths, cell.cell["check"]["sample"],
                          seed)
    fam = cell.family()
    states = fam.states(cell, seed, device)
    pairs = []
    for i in sample:
        want = fam.reference_output(cell, reqs[i], states, device)
        got = fam.reference_output(cell, reqs[i], states, device,
                                   precision=precision)
        pairs.append((got, want))
    readings, each = fam.compare(cell, pairs)
    ok, _ = check.verdict(readings, cell.cell["check"]["limits"])
    return {"seed": seed, "precision": precision, "readings": readings,
            "passes_check": ok,
            "sample": [[i, lengths[i], *g] for i, g in zip(sample, each)]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--precision", default=None)
    ap.add_argument("--first", type=int, default=64)
    args = ap.parse_args(argv)
    import torch
    from port_bench.harness import spec
    cell = spec.resolve(args.workload)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    for s in args.seeds.split(","):
        t = time.perf_counter()
        out = control_readings(cell, int(s), "cuda", args.precision,
                               args.first)
        out["seconds"] = time.perf_counter() - t
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
