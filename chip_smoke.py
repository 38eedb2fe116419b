#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. print the card (``nvidia-smi`` name and power limit, torch's name);
2. build the CUDA kernels from the checkout's sources (``build/kernels/``)
   and print ``-Xptxas -v`` and the build seconds — the merge lookup is
   built first; each fused region compiles at its first launch;
3. generate TPC-H SF 1 (6M lineitem rows, seed 7) on the card and run the
   five queries through ``repro_torch.connect(db).query(q)`` (the cold run),
   each held against its numpy ``reference()`` at rtol=3e-3, atol=3e-2
   with equal key sets;
4. with every launch count set to 0, drive the main path again (the warm
   run, timed per query), print each region's mode and each kernel's
   launches, and require >= 3 fused-pipeline launches (Q1, Q3, Q18) and
   >= 1 merge-lookup launch (Q9);
5. hold every kernel launch of that run against its plain PyTorch twin on
   the same card inputs: equal key sets / found flags, float lanes within
   the tolerance above (atomics fold float32 sums in another order);
6. time each kernel and its twin with CUDA events (mean over repeated
   launches after a warm-up), beside its least-time bound (bytes over
   3.35 TB/s or operations over 67 TFLOP/s, whichever is larger) and, for
   the merge lookup, ``torch.searchsorted`` plus a gather; then profile one
   warm pass (``torch.profiler``: device time by op, device idle share);
7. print the kernels' JSON line, then ``{"ok": true, "device": ...}`` last.

It imports nothing of JAX and nothing of the reference package.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
RTOL, ATOL = 3e-3, 3e-2
SCALE, SEED = 1.0, 7
QUERIES = ("q1", "q3", "q5", "q9", "q18")


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def same_items(got, want, what):
    check(set(got) == set(want), f"{what}: key sets differ ({len(got)} vs {len(want)})")
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=f"{what} key {k}")


def timed(torch, fn, reps):
    """Mean milliseconds per call over ``reps`` calls, after a warm-up."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def dict_items(keys, vals, empty):
    ks, vs = keys.cpu().numpy(), vals.cpu().numpy()
    live = ks != empty
    return dict(zip(ks[live].tolist(), vs[live]))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))
    import repro_torch
    from repro_torch.data import tpch
    from repro_torch.dicts import base as dbase
    from repro_torch.exec.queries import REGISTRY
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_pipeline as fp
    from repro_torch.kernels import merge_lookup as ml

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. the card ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"card: {smi}")
    print(f"torch: {torch.__version__} cuda {torch.version.cuda} device {kind}")
    dev = torch.device("cuda:0")

    # -- 2. build the merge lookup + 3. data and cold run ---------------------
    build.load("merge_lookup", (build.CSRC / "merge_lookup.cu").read_text())
    t0 = time.perf_counter()
    db = tpch.generate(scale=SCALE, seed=SEED, device=dev).tables()
    torch.cuda.synchronize()
    print(f"data: TPC-H SF {SCALE} seed {SEED}: {db['lineitem'].nrows} lineitem rows on {dev} "
          f"({time.perf_counter() - t0:.1f}s)")
    session = repro_torch.connect(db, device=dev)
    refs = {}
    for q in QUERIES:
        t = time.perf_counter()
        got = session.query(q)
        cold = time.perf_counter() - t
        t = time.perf_counter()
        refs[q] = REGISTRY[q].reference(db, **REGISTRY[q].defaults)
        same_items(got, refs[q], f"{q} (cold run)")
        print(f"cold {q}: {cold:.2f}s, {len(got)} groups match the numpy reference "
              f"(reference {time.perf_counter() - t:.1f}s)")
    for rec in build.BUILDS:
        print(f"build {rec.name}: {rec.seconds:.1f}s {os.path.basename(rec.path)}")
        for line in rec.ptxas.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas {line.strip()}")
    check(build.BUILDS, "no kernel was built from source")

    # -- 4. the main path, counts from zero -----------------------------------
    real_fp, real_ml = fp.fused_pipeline, ml.merge_lookup
    fp_calls, ml_calls = [], []

    def rec_fp(*args):
        out = real_fp(*args)
        fp_calls.append((args, out))
        return out

    def rec_ml(*args):
        out = real_ml(*args)
        ml_calls.append((args, out))
        return out

    fp.fused_pipeline, ml.merge_lookup = rec_fp, rec_ml
    real_fp.launches = real_ml.launches = 0
    walls, modes = {}, {}
    try:
        for q in QUERIES:
            torch.cuda.synchronize()
            t = time.perf_counter()
            got = session.query(q)
            torch.cuda.synchronize()
            walls[q] = time.perf_counter() - t
            modes[q] = session.report().modes()
            same_items(got, refs[q], f"{q} (warm run)")
    finally:
        fp.fused_pipeline, ml.merge_lookup = real_fp, real_ml
    launches = {"fused_pipeline": real_fp.launches, "merge_lookup": real_ml.launches}
    for q in QUERIES:
        print(f"warm {q}: {walls[q] * 1e3:.1f} ms; regions {modes[q]}")
    print(f"launches on the main path: {launches}")
    check(launches["fused_pipeline"] >= 3, "fewer than 3 fused-pipeline launches (Q1, Q3, Q18)")
    check(launches["merge_lookup"] >= 1, "no merge-lookup launch (Q9)")
    check(len(fp_calls) == launches["fused_pipeline"] and len(ml_calls) == launches["merge_lookup"],
          "recorded calls disagree with the launch counts")

    # -- 5. every launch against its plain twin; 6. timing ---------------------
    regions, fp_err = [], 0.0
    for (args, out) in fp_calls:
        program = args[0]
        want = fp.fused_pipeline_plain(*args)
        torch.cuda.synchronize()
        if program.out[0] == "dict":
            g = dict_items(*out, dbase.EMPTY)
            w = dict_items(*want, dbase.EMPTY)
            same_items(g, w, f"fused region {program.term[0]} kernel vs plain")
            err = max((float(np.abs(g[k] - w[k]).max()) for k in w), default=0.0)
        else:
            np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(), rtol=RTOL, atol=ATOL)
            err = float((out - want).abs().max())
        fp_err = max(fp_err, err)
        nbytes, nops = fp.roofline(*args)
        ms = timed(torch, lambda: real_fp(*args), 20)
        plain_ms = timed(torch, lambda: fp.fused_pipeline_plain(*args), 3)
        regions.append({
            "term": program.term[0], "rows": int(args[2].shape[0]), "out": list(program.out[:4]),
            "ms": ms, "plain_ms": plain_ms, "bytes": nbytes, "ops": nops,
            "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S, nops / FP32_OPS_PER_S),
            "max_abs_err": err,
        })
        print(f"fused region {program.term[0]} ({program.dicts and [d.ds for d in program.dicts]}): "
              f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {regions[-1]['bound_ms']:.4f} ms, "
              f"max |kernel-plain| {err:.4g}")

    ml_rows, ml_err = [], 0.0
    for (args, out) in ml_calls:
        keys, vals, qs = args
        want = ml.merge_lookup_plain(keys, vals, qs)
        torch.cuda.synchronize()
        check(torch.equal(out[1], want[1]), "merge lookup: found flags differ from the plain twin")
        err = float((out[0] - want[0]).abs().max()) if qs.numel() else 0.0
        check(err == 0.0, f"merge lookup: values differ from the plain twin by {err}")
        C, V, n = keys.shape[0], vals.shape[1], qs.shape[0]
        lo = int(torch.searchsorted(keys, qs[:1]).item()) if n else 0
        hi = int(torch.searchsorted(keys, qs[-1:], right=True).item()) if n else 0
        span = min(C, hi - lo + 1)  # table rows these sorted probes can touch
        nbytes = span * 4 * (1 + V) + n * 4 + n * (4 * V + 1)
        nops = n * 13  # one compare per window search round
        ms = timed(torch, lambda: real_ml(keys, vals, qs), 20)
        plain_ms = timed(torch, lambda: ml.merge_lookup_plain(keys, vals, qs), 20)

        def library():
            idx = torch.searchsorted(keys, qs).clamp_(max=C - 1)
            return vals[idx], keys[idx] == qs

        lib_ms = timed(torch, library, 20)
        ml_rows.append({"C": C, "V": V, "n": n, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                        "bytes": nbytes, "ops": nops,
                        "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S, nops / FP32_OPS_PER_S)})
        ml_err = max(ml_err, err)
        print(f"merge lookup C={C} V={V} n={n}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
              f"searchsorted+gather {lib_ms:.3f} ms, bound {ml_rows[-1]['bound_ms']:.4f} ms")

    # where a warm pass spends device time, and how long the device idles
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for q in QUERIES:
            session.query(q)
        torch.cuda.synchronize()
        pass_s = time.perf_counter() - t
    # device events only (kernels, copies, sets): an aten op on the host also
    # carries its kernels' device time, so summing every event counts twice;
    # busy time is the union of the device events' intervals
    from torch.autograd import DeviceType

    def on_device(e):
        return e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)

    busy_us, reach = 0.0, float("-inf")
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in prof.events() if on_device(e)):
        busy_us += max(0.0, e - max(s, reach))
        reach = max(reach, e)
    check(busy_us > 0, "the profiler saw no device time")
    ops = sorted((e for e in prof.key_averages() if on_device(e)), key=lambda e: -e.self_device_time_total)
    top = [{"op": e.key[:60], "device_ms": e.self_device_time_total / 1e3, "calls": e.count}
           for e in ops[:12]]
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    top_host = [{"op": e.key[:60], "host_ms": e.self_cpu_time_total / 1e3, "calls": e.count}
                for e in host[:12]]
    print(json.dumps({"profile": {"pass_ms": pass_s * 1e3, "device_busy_ms": busy_us / 1e3,
                                  "device_idle_share": 1.0 - busy_us / 1e6 / pass_s,
                                  "top_device": top, "top_host": top_host}}))

    def entry(name, source, replaces, rows, err, library_ms):
        nbytes = sum(r["bytes"] for r in rows)
        nops = sum(r["ops"] for r in rows)
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err,
            "ms": sum(r["ms"] for r in rows), "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S, nops / FP32_OPS_PER_S),
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= nops / FP32_OPS_PER_S else "operations",
            "library_ms": library_ms,
        }

    kernels = [
        entry("fused_pipeline", "src/repro_torch/kernels/csrc/fused_kernels.cuh",
              "src/repro/kernels/fused_pipeline.py:388", regions, fp_err, None),
        entry("merge_lookup", "src/repro_torch/kernels/csrc/merge_lookup.cu",
              "src/repro/kernels/merge_lookup.py:93", ml_rows, ml_err,
              sum(r["library_ms"] for r in ml_rows)),
    ]
    print(json.dumps({"regions": regions, "merge_lookups": ml_rows, "warm_query_ms":
                      {q: walls[q] * 1e3 for q in QUERIES}}))
    print(f"card: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
