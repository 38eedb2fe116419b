#!/usr/bin/env python3
"""Time the selective-scan kernel of the ``repro_torch`` that is first on
``sys.path`` on one CUDA card, at the shapes of the port's main paths;
print one JSON line.

    PYTHONPATH=src python3 tools/scan_timings.py [--label NAME] [--sass DIR] [--backward]

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

``--backward`` also times the backward kernel (``selective_scan_backward``:
the walk and the fixed-order sums) on the same inputs with a random ``dy``
and, where the shape carries a state, ``dh_T``, each result first held
against ``selective_scan_backward_plain`` (float32 within 1e-5 of the
largest gradient, bf16 within 2^-7 of it, cosine >= 0.9999; ~12 s of twin
at jamba's width); ``bwd_bound_ms`` is the larger of its bytes (x, dt, B,
C, A, dy and h0, dh_T read, dx, ddt, dB, dC, dA and dh0 written once) at
3.35 TB/s and its operations (20 a lane-step, 4 a channel-step) at 67
TFLOP/s.  With ``--sass`` the backward library's SASS goes to
``DIR/scan_bwd_sass_<label>.txt``, and its count a lane-step adds the two
loops that hold exponentials, each loop's own instructions (its nested
loops' taken out) over its lane-steps: the first pass (one ``MUFU.EX2`` a
lane-step) and the chunk walk (two: the recompute and the walk back).
``--set`` then also reaches ``csrc/selective_scan_bwd.cu``'s constants
(``CHUNK`` excepted: the wrapper sizes its checkpoints by ``BWD_TILE``;
``MIN_BLOCKS``, the blocks an SM its registers are budgeted for).
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
BWD_TOL = {"bfloat16": 2.0**-7, "float32": 1e-5}
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
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


def bwd_bound_ms(case, esz):
    """``chip_smoke.scan_bwd_bytes_ops``'s bytes and operations, as time."""
    B, T, d_in, ds, carried = case
    nbytes = (4 * B * T * d_in * esz + B * T * d_in * 4 + 4 * B * T * ds * esz + 2 * d_in * ds * 4
              + B * d_in * ds * 4 * (3 if carried else 0))
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, B * T * d_in * (20 * ds + 4) / FP32_OPS_PER_S)


def bwd_inputs(dev, case, seed):
    B, T, d_in, ds, carried = case
    g = torch.Generator(device=dev).manual_seed(seed)
    dy = torch.randn((B, T, d_in), generator=g, device=dev)
    return dy, (torch.randn((B, d_in, ds), generator=g, device=dev) if carried else None)


def check_backward(SS, inputs, dy, dh_T, case, dtype):
    """Max |kernel - twin| over the gradients; exits where one is off."""
    err, tol = 0.0, BWD_TOL[str(dtype).split(".")[-1]]
    got = SS.selective_scan_backward(*inputs, dy, dh_T)
    for name, g, w in zip(("dx", "ddt", "dB", "dC", "dA", "dh0"), got,
                          SS.selective_scan_backward_plain(*inputs, dy, dh_T)):
        if w is None:
            continue
        g, w = g.float(), w.float()
        cos = float(F.cosine_similarity(g.flatten(), w.flatten(), dim=0))
        if not (torch.allclose(g, w, rtol=tol, atol=tol * float(w.abs().max())) and cos >= COS):
            raise SystemExit(f"scan_timings: the backward's {name} at {case} {dtype} is "
                             f"{float((g - w).abs().max())} off its twin (cosine {cos})")
        err = max(err, float((g - w).abs().max()))
    return err


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


def own_loops(sass):
    """``[(instructions, MUFU.EX2 count)]`` of each loop of one function's
    SASS (a target and its furthest backward branch), the instructions of
    the loops nested in it taken out."""
    ins = []
    for line in sass.splitlines():
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m:
            ins.append((int(m.group(1), 16), m.group(2)))
    ends = {}
    for addr, text in ins:
        m = re.search(r"\bBRA(?:\.\S+)?\s+(0x[0-9a-f]+)", text)
        if m and int(m.group(1), 16) <= addr:
            lo = int(m.group(1), 16)
            ends[lo] = max(ends.get(lo, addr), addr)
    loops = sorted(ends.items())
    out = []
    for lo, hi in loops:
        inner = [o for o in loops if o != (lo, hi) and lo <= o[0] and o[1] <= hi]
        body = [t for a, t in ins if lo <= a <= hi and not any(i <= a <= j for i, j in inner)]
        out.append((len(body), sum("MUFU.EX2" in t for t in body)))
    return out


def library_sass(backward, label, out_dir, stem):
    """The functions of the last loaded forward (or backward) library's SASS,
    which is also written to ``out_dir``."""
    from repro_torch.kernels import build

    libs = [p for p in build._LOADED if os.path.basename(p).startswith("selective_scan")
            and os.path.basename(p).startswith("selective_scan_bwd") == backward]
    cuobjdump = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", libs[-1]], capture_output=True, text=True, check=True).stdout
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{stem}_{label or 'tree'}.txt"), "w") as f:
        f.write(text)
    return re.split(r"\n\s*Function : ", text)


def bwd_sass_counts(label, out_dir):
    """The backward walk's instructions a lane-step at d_state 16: the loop
    with the most exponentials is the chunk walk (two a lane-step), the
    next the first pass (one)."""
    funcs = library_sass(True, label, out_dir, "scan_bwd_sass")
    counts = {}
    for dtype, key in SASS_KERNELS.items():
        body = next(f for f in funcs if f.startswith("_Z") and "selective_scan_bwd_kernel" in f.split("\n", 1)[0]
                    and key in f.split("\n", 1)[0])
        (walk_n, walk_ex2), (first_n, first_ex2) = sorted(
            [lp for lp in own_loops(body) if lp[1] > 0], key=lambda lp: -lp[1])[:2]
        counts[dtype] = {"walk_instructions": walk_n, "walk_mufu_ex2": walk_ex2, "first_pass_instructions": first_n,
                         "first_pass_mufu_ex2": first_ex2,
                         "per_lane_step": first_n / first_ex2 + walk_n / (walk_ex2 / 2)}
    return counts


def sass_counts(label, out_dir):
    funcs = library_sass(False, label, out_dir, "scan_sass")
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
    ap.add_argument("--backward", action="store_true", help="time the backward kernel beside the forward")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("scan_timings: no CUDA device")
    from repro_torch.kernels import build
    from repro_torch.kernels import selective_scan as SS

    if args.set:
        files = {"fn": ("selective_scan.cu", "selective_scan_launch")}
        if args.backward:
            files["bwd"] = ("selective_scan_bwd.cu", "selective_scan_backward_launch")
        srcs = {k: (build.CSRC / f).read_text() for k, (f, _) in files.items()}
        for item in args.set:
            name, value = item.split("=")
            hits = 0
            for k in srcs:
                srcs[k], n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {int(value)};", srcs[k])
                hits += n
            if hits == 0 or name == "CHUNK":
                raise SystemExit(f"scan_timings: no constexpr int {name} to set in {[f for f, _ in files.values()]}")
        tag = "_".join(s.replace("=", "") for s in args.set)
        for k, (f, symbol) in files.items():
            stem = f[:-3]
            SS._LIB[k] = build.launcher(build.load(f"{stem}_{tag}", srcs[k]), symbol)
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
            if args.backward:
                dy, dh_T = bwd_inputs(dev, case, args.seed + 100 + i)
                berr = None if args.unchecked else check_backward(SS, args_, dy, dh_T, case, dtype)
                row.update(bwd_ms=device_ms(lambda: SS.selective_scan_backward(*args_, dy, dh_T), args.reps),
                           bwd_max_abs_err=berr, bwd_bound_ms=bwd_bound_ms(case, dtype.itemsize))
                del dy, dh_T
            rows.append(row)
            print(f"{args.label} scan {case} {row['dtype']}: {row['ms']:.4f} ms (bound {row['bound_ms']:.4f}), "
                  f"max |kernel - twin| {err}" + (f"; backward {row['bwd_ms']:.4f} ms (bound "
                                                  f"{row['bwd_bound_ms']:.4f}), max |kernel - twin| "
                                                  f"{row['bwd_max_abs_err']}" if args.backward else ""), flush=True)
            del args_
    out = {"label": args.label, "set": args.set, "card": card[0] if card else None, "rows": rows}
    if args.sass:
        out["sass"] = sass_counts(args.label, args.sass)
        print(f"{args.label} SASS: {out['sass']}", flush=True)
        if args.backward:
            out["bwd_sass"] = bwd_sass_counts(args.label, args.sass)
            print(f"{args.label} backward SASS: {out['bwd_sass']}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
