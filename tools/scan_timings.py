#!/usr/bin/env python3
"""Time the selective-scan kernel of the ``repro_torch`` that is first on
``sys.path`` on one CUDA card, at the shapes of the port's main paths;
print one JSON line.

    PYTHONPATH=src python3 tools/scan_timings.py [--label NAME] [--sass DIR]

Two checkouts compare by running the script once with each one's ``src``
on ``PYTHONPATH``, in one run on one card (A, B, B, A): the wrapper's
signature is the same in every checkout since the kernel was first ported.

Shapes (``chip_smoke.py``'s ``SCAN_SHAPES``, its inputs made on the card
from ``--seed`` as ``chip_smoke.scan_inputs`` makes them), each in bfloat16
and float32: jamba's width, 1 × 8,192 × 16,384 at d_state 16; 777 steps at
that width with a carried state; one decode step of 4 rows; 2 × 300 × 1,000
at d_state 4.

Each result is first held against the plain twin (``selective_scan_plain``,
the reference's per-step loop) at rtol = atol = 1e-4 and cosine ≥ 0.9999.
Times are device milliseconds a call: the stream sleeps while the host
queues ``--reps`` calls, CUDA events time them back to back; the median of
three such rounds.  ``bound_ms`` is the byte bound (x, dt, B, C, A and h0
read once, y and h_T written once, at 3.35 TB/s).

``--set NAME=VALUE`` (repeatable) rebuilds this tree's kernel with a
``constexpr int`` of ``csrc/selective_scan.cu`` set to another value (the
design choices it names: ``TILE``, ``UNROLL``); ``--shapes 0,1`` times only
those entries of the shape list; ``--unchecked`` times without holding
each result against the twin first (for a kernel altered on purpose to see
what a part of it costs).

``--sass DIR`` also writes the kernel's SASS (``cuobjdump -sass`` of the
library this process loaded) to ``DIR/scan_sass_<label>.txt`` and counts,
for the bf16 and float32 kernels at d_state 16, the instructions of the
innermost loop that holds the most ``MUFU.EX2``: each lane-step runs one
exponential, so instructions / ``MUFU.EX2`` is the loop's instructions a
lane-step.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess

import torch
import torch.nn.functional as F

SHAPES = [(1, 8192, 16384, 16, False), (1, 777, 16384, 16, True), (4, 1, 16384, 16, True),
          (2, 300, 1000, 4, True)]
TOL, COS = 1e-4, 0.9999
HBM_BYTES_PER_S = 3.35e12
SASS_KERNELS = {"bfloat16": "Li16E13__nv_bfloat16E", "float32": "Li16EfE"}


def device_ms(fn, reps):
    """Device ms of one call, calls back to back behind a device sleep."""
    fn()
    torch.cuda.synchronize()
    rounds = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000 * reps)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        rounds.append(start.elapsed_time(end) / reps)
    return statistics.median(rounds)


def scan_inputs(dev, case, dtype, seed):
    """``chip_smoke.scan_inputs``: x as a post-conv SiLU, dt in Mamba's range,
    B and C normal, A = -(1 .. ds), h0 normal when carried."""
    B, T, d_in, ds, carried = case
    g = torch.Generator(device=dev).manual_seed(seed)
    xc = F.silu(torch.randn((B, T, d_in), generator=g, device=dev)).to(dtype)
    dt = F.softplus(torch.randn((B, T, d_in), generator=g, device=dev) * 0.5 - 4.0).to(dtype)
    Bt = torch.randn((B, T, ds), generator=g, device=dev).to(dtype)
    Ct = torch.randn((B, T, ds), generator=g, device=dev).to(dtype)
    A = -torch.arange(1, ds + 1, dtype=torch.float32, device=dev).repeat(d_in, 1)
    h0 = torch.randn((B, d_in, ds), generator=g, device=dev) if carried else None
    return xc, dt, Bt, Ct, A, h0


def bound_ms(case, esz):
    B, T, d_in, ds, carried = case
    nbytes = (2 * B * T * d_in * esz + 2 * B * T * ds * esz + d_in * ds * 4 + B * T * d_in * 4
              + B * d_in * ds * 4 * (2 if carried else 1))
    return nbytes / HBM_BYTES_PER_S * 1e3


def check(SS, inputs, case, dtype):
    """Max |kernel - twin| over y and h_T; exits where either is off."""
    err = 0.0
    for name, g, w in zip(("y", "h_T"), SS.selective_scan(*inputs), SS.selective_scan_plain(*inputs)):
        cos = float(F.cosine_similarity(g.flatten(), w.flatten(), dim=0))
        if not (torch.allclose(g, w, rtol=TOL, atol=TOL) and cos >= COS):
            raise SystemExit(f"scan_timings: {name} at {case} {dtype} is {float((g - w).abs().max())} off its "
                             f"twin (cosine {cos})")
        err = max(err, float((g - w).abs().max()))
    return err


def innermost_loops(sass):
    """``[(instructions, MUFU.EX2 count)]`` of each loop (a backward branch
    and its target) that holds no other loop, in one function's SASS."""
    ins = []  # (address, text)
    for line in sass.splitlines():
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m:
            ins.append((int(m.group(1), 16), m.group(2)))
    loops = []
    for addr, text in ins:
        m = re.search(r"\bBRA(?:\.\S+)?\s+(0x[0-9a-f]+)", text)
        if m and int(m.group(1), 16) <= addr:
            loops.append((int(m.group(1), 16), addr))
    inner = [lp for lp in loops if not any(o != lp and lp[0] <= o[0] and o[1] <= lp[1] for o in loops)]
    out = []
    for lo, hi in inner:
        body = [t for a, t in ins if lo <= a <= hi]
        out.append((len(body), sum("MUFU.EX2" in t for t in body)))
    return out


def sass_counts(label, out_dir):
    from repro_torch.kernels import build

    libs = [p for p in build._LOADED if os.path.basename(p).startswith("selective_scan")]
    cuobjdump = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", libs[-1]], capture_output=True, text=True, check=True).stdout
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"scan_sass_{label or 'tree'}.txt"), "w") as f:
        f.write(text)
    funcs = re.split(r"\n\s*Function : ", text)
    counts = {}
    for dtype, key in SASS_KERNELS.items():
        body = next(f for f in funcs if f.startswith("_Z") and "selective_scan_kernel" in f.split("\n", 1)[0]
                    and key in f.split("\n", 1)[0])
        loops = [lp for lp in innermost_loops(body) if lp[1] > 0]
        n, mufu = max(loops, key=lambda lp: (lp[1], lp[0]))
        counts[dtype] = {"loop_instructions": n, "mufu_ex2": mufu, "per_lane_step": n / mufu}
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=200)
    ap.add_argument("--sass", default=None, help="write the kernel's SASS here and count its loop")
    ap.add_argument("--set", action="append", default=[], metavar="NAME=VALUE",
                    help="rebuild the kernel with this constexpr int changed")
    ap.add_argument("--shapes", default=None, help="comma-separated indices into the shape list")
    ap.add_argument("--unchecked", action="store_true", help="time without holding results against the twin")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("scan_timings: no CUDA device")
    from repro_torch.kernels import build
    from repro_torch.kernels import selective_scan as SS

    if args.set:
        src = (build.CSRC / "selective_scan.cu").read_text()
        for item in args.set:
            name, value = item.split("=")
            src, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {int(value)};", src)
            if n != 1:
                raise SystemExit(f"scan_timings: no constexpr int {name} in selective_scan.cu")
        tag = "_".join(s.replace("=", "") for s in args.set)
        SS._LIB["fn"] = build.launcher(build.load(f"selective_scan_{tag}", src), "selective_scan_launch")
    shapes = SHAPES if args.shapes is None else [SHAPES[int(i)] for i in args.shapes.split(",")]

    dev = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()
    rows = []
    for case in shapes:
        i = SHAPES.index(case)
        for dtype in (torch.bfloat16, torch.float32):
            args_ = scan_inputs(dev, case, dtype, args.seed + i)
            err = None if args.unchecked else check(SS, args_, case, dtype)
            row = {"shape": list(case[:4]), "carried": case[4], "dtype": str(dtype).split(".")[-1],
                   "ms": device_ms(lambda: SS.selective_scan(*args_), args.reps), "max_abs_err": err,
                   "bound_ms": bound_ms(case, dtype.itemsize)}
            if hasattr(SS, "launch_geometry"):
                geom = SS.launch_geometry(case[0], case[2], case[3])
                row.update(threads_a_channel=geom.group, warps=geom.warps, blocks=geom.blocks_x * geom.blocks_y)
            rows.append(row)
            print(f"{args.label} scan {case} {row['dtype']}: {row['ms']:.4f} ms (bound {row['bound_ms']:.4f}), "
                  f"max |kernel - twin| {err}", flush=True)
            del args_
    out = {"label": args.label, "set": args.set, "card": card[0] if card else None, "rows": rows}
    if args.sass:
        out["sass"] = sass_counts(args.label, args.sass)
        print(f"{args.label} SASS: {out['sass']}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
