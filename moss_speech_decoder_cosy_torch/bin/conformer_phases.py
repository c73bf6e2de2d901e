"""Where a ``fused_conformer_group`` launch spends its time, phase by phase,
on one CUDA card; and, given other sources of the kernel, whether they agree
with it bit for bit and which is faster.

    python -m moss_speech_decoder_cosy_torch.bin.conformer_phases \
        [--against OTHER.cu ...] [--reps 10] [--out phases.json]

Builds ``csrc/fused_conformer_group.cu`` (and each ``--against``, for
example an earlier version taken out of git with ``git show REV:path >
OTHER.cu``, labelled by its file's stem) with the package's nvcc flags, each
twice: as it is, and as a copy in which
thread 0 of block 0 reads ``clock64()`` and ``%globaltimer`` at the start,
before and after every grid barrier and at the end.  The copies go to
``build/conformer_phases/``; the sources are not changed.  Then:

- the ptxas report of each build (registers, spills);
- for the encoder's blocks group (L 6, C 5, Rt 35) and up group (L 4,
  C 20, Rt 140) at D 512, 8 x 64 heads, FF 2048, full ring, both dtypes,
  L2 flushed before each launch and warm: the launcher's grid and shared
  bytes a block, and per phase (1 LN + QKV + positions, 2 attention,
  3 ring write + out-proj, 4 LN + W_1, 5 W_2) the time from the previous
  barrier's release to this one's, summed over the layers, and the part
  of it block 0 spent before reaching the barrier; medians over ``--reps``
  launches;
- with ``--against``: every case below in both dtypes through every
  build from the same inputs, compared bit for bit with this one and each
  against the plain version (``kernel_tolerance``); then both groups timed
  with CUDA events, the builds in turns (this, others, others reversed,
  this) on one set of inputs.

The stamps rely on the source's text: ``cg::grid_group grid =
cg::this_grid();``, every barrier written ``grid.sync();``, the layer loop
``  for (int l = 0; l < p.L; ++l) {`` closed by a line ``  }``, and
``cfg.dynamicSmemBytes = smem;`` in the launcher.  Prints one JSON object
per measurement and writes them all to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
from pathlib import Path

import torch

from ..ops import cuda_build
from ..ops import fused_conformer as fc
from ..ops.fused_block import _DTYPE_CODE
from ..utils.device import card_line

OUT_DIR = cuda_build.BUILD_DIR.parent / "conformer_phases"
PHASES = ("p1_ln_qkv_pos", "p2_attention", "p3_ring_write_out_proj",
          "p4_ln_w1_swish", "p5_w2")
# the encoder's two groups in the KV session: (L, C, Rt)
GROUPS = {"blocks": (6, 5, 35), "up": (4, 20, 140)}
D, HEADS, FF = 512, 8, 2048
# (L, C, D, heads, FF, Rt, n_tok): tests/test_torch_cuda.py's edge cases
CASES = {
    "C1_rampup": (2, 1, 64, 2, 96, 8, 3),
    "C_is_Rt_wrap": (2, 8, 64, 2, 128, 8, 13),
    "n_tok0": (2, 5, 64, 4, 64, 12, 0),
    "wrap": (2, 6, 64, 2, 96, 10, 7),
    "ragged_column_tiles": (2, 7, 24, 3, 40, 9, 4),
    "head_off_16_bytes": (2, 7, 24, 2, 40, 9, 4),
    "more_slots_than_threads": (1, 4, 64, 1, 64, 300, 290),
    "full_width_two_layers": (2, 5, 512, 8, 2048, 35, 35),
    "wide_several_items_a_block": (2, 20, 1024, 16, 4096, 60, 75),
    "wide_ff_ragged_tile": (2, 9, 1024, 16, 3000, 40, 33),
}
_N_STAMPS = 1024

_STAMP = r'''
__device__ unsigned long long g_phase_stamps[2][%d];
static int g_phase_grid = 0;
static size_t g_phase_smem = 0;
#define PHASE_STAMP() do { \
  if (blockIdx.x == 0 && threadIdx.x == 0 && phase_n < %d) { \
    unsigned long long t_; \
    asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t_)); \
    g_phase_stamps[0][phase_n] = clock64(); \
    g_phase_stamps[1][phase_n] = t_; \
  } \
  ++phase_n; } while (0)
''' % (_N_STAMPS, _N_STAMPS)
_READ = r'''
extern "C" int phase_stamps(unsigned long long* host, int* cfg) {
  cfg[0] = g_phase_grid;
  cfg[1] = (int)g_phase_smem;
  return (int)cudaMemcpyFromSymbol(host, g_phase_stamps,
                                   sizeof(g_phase_stamps));
}
'''


def _sub(text: str, old: str, new: str, count: int = 1) -> str:
    if text.count(old) < 1 or (count and text.count(old) != count):
        raise ValueError(f"the kernel source no longer holds {old!r}")
    return text.replace(old, new)


def instrument(src: str) -> str:
    """The kernel source with phase stamps (see the module docstring)."""
    s = _sub(src, "#include <cuda_runtime.h>\n",
             "#include <cuda_runtime.h>\n" + _STAMP)
    s = _sub(s, "cg::grid_group grid = cg::this_grid();",
             "cg::grid_group grid = cg::this_grid();\n"
             "  int phase_n = 0;\n  PHASE_STAMP();")
    s = _sub(s, "grid.sync();",
             "{ PHASE_STAMP(); grid.sync(); PHASE_STAMP(); }", count=0)
    lines = s.split("\n")
    start = lines.index("  for (int l = 0; l < p.L; ++l) {")
    end = lines.index("  }", start + 1)
    lines.insert(end + 1, "  PHASE_STAMP();")
    s = _sub("\n".join(lines), "cfg.dynamicSmemBytes = smem;",
             "cfg.dynamicSmemBytes = smem;\n"
             "  g_phase_grid = (int)cfg.gridDim.x;\n"
             "  g_phase_smem = cfg.dynamicSmemBytes;")
    return s + _READ


def build(sources: dict) -> tuple:
    """label -> source path; builds each plain and stamped, in parallel.
    Returns ({(label, kind): CDLL}, {f"{label}_{kind}": ptxas report})."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, path in sources.items():
        text = Path(path).read_text()
        for kind, body in (("plain", text), ("stamped", instrument(text))):
            cu = OUT_DIR / f"{label}_{kind}.cu"
            cu.write_text(body)
            so = OUT_DIR / f"lib{label}_{kind}.so"
            procs[label, kind] = (subprocess.Popen(
                [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so),
                 str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), so)
    libs, logs = {}, {}
    for key, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        logs[f"{key[0]}_{key[1]}"] = [
            ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]
        lib = ctypes.CDLL(str(so))
        lib.fused_conformer_group.restype = ctypes.c_int
        lib.fused_conformer_group.argtypes = (
            [ctypes.POINTER(ctypes.c_void_p)] + [ctypes.c_int] * 8
            + [ctypes.c_void_p])
        libs[key] = lib
    return libs, logs


class Case:
    """One set of seeded inputs, launched through any build's C entry."""

    def __init__(self, n_layers, c, d, heads, ff, rt, n_tok, dtype, seed):
        self.shape = (c, d, heads, d // heads, ff, n_layers, rt)
        self.heads, self.n_tok, self.dtype = heads, n_tok, dtype
        self.p, self.x, self.pe, self.kv, self.pk = fc.make_conformer_inputs(
            n_layers, c, d, heads, ff, rt, dtype, "cuda", seed=seed)
        self.held = torch.tensor([n_tok], dtype=torch.int32, device="cuda")
        self.x_out = torch.empty_like(self.x)
        self.scratch = torch.empty((c * (5 * d + ff),), dtype=dtype,
                                   device="cuda")

    def run(self, lib, kv=None, pk=None, x_out=None) -> None:
        ts = ([self.x, self.pe] + [self.p[k] for k in fc.CONF_KEYS]
              + [self.kv if kv is None else kv,
                 self.pk if pk is None else pk,
                 self.x_out if x_out is None else x_out, self.scratch,
                 self.held])
        ptrs = (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])
        rc = lib.fused_conformer_group(
            ptrs, _DTYPE_CODE[self.dtype], *self.shape,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed with CUDA error {rc} at "
                               f"{self.shape}")


def _flush_buffer():
    return torch.empty(128 << 20, dtype=torch.uint8, device="cuda")


def phases(lib, case: Case, n_layers: int, reps: int, cold: bool) -> dict:
    """Medians over ``reps`` launches (after 2) of the stamped build."""
    host = (ctypes.c_ulonglong * (2 * _N_STAMPS))()
    cfg = (ctypes.c_int * 2)()
    flush = _flush_buffer()
    n = 10 * n_layers      # start, (before, after) x (5 L - 1) barriers, end
    runs = []
    for i in range(reps + 2):
        if cold:
            flush.fill_(1)
        case.run(lib)
        torch.cuda.synchronize()
        if lib.phase_stamps(host, cfg):
            raise RuntimeError("reading the phase stamps failed")
        if i < 2:
            continue
        clk = [host[k] for k in range(n)]
        ns = [host[_N_STAMPS + k] for k in range(n)]
        ghz = (clk[-1] - clk[0]) / (ns[-1] - ns[0])
        us = [(c - clk[0]) / ghz / 1e3 for c in clk]
        released = [us[0]] + us[2:n - 1:2] + [us[-1]]
        arrived = us[1:n - 1:2] + [us[-1]]
        tot, busy = dict.fromkeys(PHASES, 0.0), dict.fromkeys(PHASES, 0.0)
        for k in range(5 * n_layers):
            tot[PHASES[k % 5]] += released[k + 1] - released[k]
            busy[PHASES[k % 5]] += arrived[k] - released[k]
        runs.append(dict(total=us[-1], ghz=ghz, tot=tot, busy=busy))

    def med(key, ph=None):
        return statistics.median(r[key] if ph is None else r[key][ph]
                                 for r in runs)
    return dict(grid=cfg[0], smem_bytes=cfg[1], total_us=med("total"),
                sm_ghz=med("ghz"),
                phase_us={ph: med("tot", ph) for ph in PHASES},
                block0_before_barrier_us={ph: med("busy", ph)
                                          for ph in PHASES})


def compare(libs, labels) -> tuple:
    """Every case through each build from the same inputs: bit equality
    with the first label and the error against the plain version."""
    cases = dict(CASES)
    for g, (n_layers, c, rt) in GROUPS.items():
        for mode, n_tok in {"empty": 0, "rampup": 2 * c, "full": 3 * rt,
                            "wrap": 3 * rt + rt - c // 2 - 1}.items():
            cases[f"{g}_{mode}"] = (n_layers, c, D, HEADS, FF, rt, n_tok)
    out, all_same = {}, True
    for name, (n_layers, c, d, heads, ff, rt, n_tok) in cases.items():
        for dtype in (torch.float32, torch.bfloat16):
            case = Case(n_layers, c, d, heads, ff, rt, n_tok, dtype,
                        seed=len(name) + n_tok)
            kv_w, pk_w = case.kv.clone(), case.pk.clone()
            want = fc.fused_conformer_group_plain(
                case.p, case.x, case.pe, kv_w, pk_w, n_tok, heads=heads,
                head_dim=d // heads)
            got = {}
            for label in labels:
                kv, pk = case.kv.clone(), case.pk.clone()
                x_out = torch.empty_like(case.x)
                case.run(libs[label, "plain"], kv, pk, x_out)
                torch.cuda.synchronize()
                got[label] = (x_out, kv, pk)
            rec = {}
            for label in labels:
                errs = [(a.float() - b.float()).abs().max().item()
                        for a, b in zip(got[label], want)]
                same = all(torch.equal(a, b) for a, b in
                           zip(got[label], got[labels[0]]))
                rec[label] = dict(
                    max_abs_err=errs, bit_equal=same,
                    within_tol=all(e <= fc.kernel_tolerance(b)
                                   for e, b in zip(errs, want)))
                all_same &= same and rec[label]["within_tol"]
            out[f"{name}_{str(dtype)[6:]}"] = rec
    return out, all_same


def _time(call, cold: bool, iters: int = 20) -> float:
    """Mean ms a launch (CUDA events); cold: a 128 MB write before each."""
    flush = _flush_buffer()
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    pairs = []
    if not cold:
        torch.cuda._sleep(50_000_000)
        pairs.append((torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True)))
        pairs[0][0].record()
    for _ in range(iters):
        if cold:
            flush.fill_(1)
            torch.cuda._sleep(2_000_000)
            pairs.append((torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True)))
            pairs[-1][0].record()
        call()
        if cold:
            pairs[-1][1].record()
    if not cold:
        pairs[0][1].record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", action="append", default=[],
                    help="another source of the kernel (repeatable)")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", help="also write the results as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("conformer_phases needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    sources = {"this": cuda_build.CSRC / "fused_conformer_group.cu"}
    for path in args.against:
        sources[Path(path).stem] = Path(path)
    labels = list(sources)
    res = dict(card=card_line(), sources={k: str(v) for k, v in
                                          sources.items()})
    print(json.dumps(res), flush=True)
    libs, res["ptxas"] = build(sources)
    print(json.dumps(dict(ptxas=res["ptxas"])), flush=True)
    res["phases"] = {}
    for g, (n_layers, c, rt) in GROUPS.items():
        for dtype in (torch.bfloat16, torch.float32):
            case = Case(n_layers, c, D, HEADS, FF, rt, 3 * rt, dtype, seed=1)
            for label in labels:
                for cold in (True, False):
                    key = (f"{label}_{g}_{str(dtype)[6:]}_"
                           f"{'cold' if cold else 'warm'}")
                    res["phases"][key] = phases(libs[label, "stamped"], case,
                                                n_layers, args.reps, cold)
                    print(json.dumps({key: res["phases"][key]}), flush=True)
    if args.against:
        res["compare"], res["all_bit_equal_and_within_tol"] = compare(
            libs, labels)
        print(json.dumps(dict(all_bit_equal_and_within_tol=res[
            "all_bit_equal_and_within_tol"])), flush=True)
        res["timing_ms"] = {}
        for g, (n_layers, c, rt) in GROUPS.items():
            for dtype in (torch.bfloat16, torch.float32):
                case = Case(n_layers, c, D, HEADS, FF, rt, 3 * rt, dtype,
                            seed=1)
                t = {label: dict(cold=[], warm=[]) for label in labels}
                for label in labels + labels[::-1]:
                    lib = libs[label, "plain"]
                    for cold in (True, False):
                        t[label]["cold" if cold else "warm"].append(
                            _time(lambda: case.run(lib), cold))
                key = f"{g}_{str(dtype)[6:]}"
                res["timing_ms"][key] = t
                print(json.dumps({f"timing_ms_{key}": t}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    print(res["card"], flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
