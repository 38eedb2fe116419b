#!/usr/bin/env python3
"""Time the merge lookup and the sorted lookup of the ``repro_torch`` that
is first on ``sys.path`` on one CUDA card, at the shapes of the port's main
paths; print one JSON line.

    PYTHONPATH=src python3 tools/lookup_timings.py [--ppt K] [--path P] [--label NAME]

Two checkouts compare by running the script once with each one's ``src``
on ``PYTHONPATH``, in one run on one card (A, B, B, A).  ``--ppt K``
rebuilds this tree's sorted lookup with ``K`` probes a thread in place of
its ``PPT`` constant; ``--path global`` or ``--path staged`` makes this
tree's sorted lookup take that path at every shape (``staged``: the whole
table or the sample, by size) where ``search_path`` would choose.  The
wrappers' signatures are the same in every checkout since the kernels were
first ported, so one script times each.

Shapes (synthetic data from ``--seed``, made on the card):

* merge lookup at Q9's shape: TPC-H SF 1's 1,500,000 orderkeys (the first
  8 of every 32 integers, as ``dbgen`` makes them) PAD-tailed to C =
  4,194,304, V = 1, 6,000,000 lineitem orderkeys (1 to 7 a key), sorted;
* merge lookup at the in-DB ML covariance shape: 1,159,457 keys in C =
  4,194,304, V = 3, 84,055,817 sorted probes (about 72 a key);
* sorted lookup at SF 1: the same orderkeys and probes, shuffled;
* sorted lookup into small dictionaries (1,024, 16,384 and 40,000 keys of
  1 .. 8·live in 2,048, 32,768 and 49,152 slots) under SF 1's 6,000,000
  shuffled hit probes;
* sorted lookup at the installation sweep's lookup cells (the profiler's
  draws: ``size`` distinct keys of 1 .. 8·size in ``next_pow2(2·size)``
  slots, 4·size hit probes), 2^10 to 2^21 keys, ordered and shuffled.

Each kernel result is held against ``searchsorted`` + clamp + gather bit
for bit before it is timed.  Times are device milliseconds a call: the
stream sleeps while the host queues ``--reps`` calls, CUDA events time
them back to back; the median of three such rounds.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

PAD = 2**31 - 1


def device_ms(fn, reps):
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


def library(keys, vals, qs):
    idx = torch.searchsorted(keys, qs).clamp_(max=keys.shape[0] - 1)
    found = keys[idx] == qs
    return torch.where(found[:, None], vals[idx], 0.0), found


def padded(live, C, V, gen):
    keys = torch.full((C,), PAD, dtype=torch.int32, device=live.device)
    keys[: live.shape[0]] = live
    vals = torch.zeros((C, V), device=live.device)
    vals[: live.shape[0]] = torch.randn((live.shape[0], V), generator=gen, device=live.device)
    return keys, vals


def orderkeys(gen, dev):
    """SF 1's orderkeys and its lineitem orderkeys (sorted)."""
    i = torch.arange(1_500_000, device=dev)
    okeys = ((i // 8) * 32 + i % 8 + 1).to(torch.int32)
    lines = torch.randint(1, 8, (okeys.shape[0],), generator=gen, device=dev)
    probes = torch.repeat_interleave(okeys, lines)
    return okeys, probes[:6_000_000] if probes.shape[0] >= 6_000_000 else torch.cat(
        [probes, okeys[-1:].expand(6_000_000 - probes.shape[0])])


def shapes(gen, dev):
    """``(kernel, what, keys, vals, probes)`` of every timed shape."""
    okeys, lprobes = orderkeys(gen, dev)
    k, v = padded(okeys, 4_194_304, 1, gen)
    yield "merge_lookup", "Q9 (C=4194304, V=1, n=6000000)", k, v, lprobes
    perm = torch.randperm(lprobes.shape[0], generator=gen, device=dev)
    yield "sorted_lookup", "SF 1 shuffled (C=4194304, 1500000 live, n=6000000)", k, v, lprobes[perm]
    del k, v, lprobes, perm
    K = 1_159_457
    live = torch.sort(torch.randperm(4 * K, generator=gen, device=dev)[:K]).values.to(torch.int32)
    k, v = padded(live, 4_194_304, 3, gen)
    qs = torch.sort(live[torch.randint(0, K, (84_055_817,), generator=gen, device=dev)]).values
    yield "merge_lookup", "covariance (C=4194304, V=3, n=84055817)", k, v, qs
    del k, v, qs, live
    for live, C in ((1024, 2048), (16_384, 32_768), (40_000, 49_152)):  # small dictionaries, SF 1's probe count
        present = (torch.randperm(8 * live, generator=gen, device=dev)[:live] + 1).to(torch.int32)
        k, v = padded(torch.sort(present).values, C, 1, gen)
        hits = present[torch.randint(0, live, (6_000_000,), generator=gen, device=dev)]
        yield "sorted_lookup", f"small table shuffled (C={C}, {live} live, n=6000000)", k, v, hits
    del k, v, hits, present
    for size in (2**10, 2**12, 2**14, 2**16, 2**17, 2**18, 2**19, 2**20, 2**21):
        present = (torch.randperm(8 * size - 1, generator=gen, device=dev)[:size] + 1).to(torch.int32)
        cap = 1 << (max(2 * size, 256) - 1).bit_length()  # next_pow2(2·size), at least 256
        k, v = padded(torch.sort(present).values, cap, 1, gen)
        hits = present[torch.randint(0, size, (4 * size,), generator=gen, device=dev)]
        yield "sorted_lookup", f"sweep 2^{size.bit_length() - 1} ordered (C={cap}, n={4 * size})", k, v, \
            torch.sort(hits).values
        yield "sorted_lookup", f"sweep 2^{size.bit_length() - 1} shuffled (C={cap}, n={4 * size})", k, v, hits


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--ppt", type=int, default=None, help="rebuild the sorted lookup with this many probes a thread")
    ap.add_argument("--path", choices=("global", "staged"), default=None,
                    help="the sorted lookup's path at every shape")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("lookup_timings: no CUDA device")
    from repro_torch.kernels import build
    from repro_torch.kernels import merge_lookup as ml
    from repro_torch.kernels import sorted_lookup as sl

    if args.ppt is not None:
        src = (build.CSRC / "sorted_lookup.cu").read_text()
        const = "constexpr int PPT = "
        if const not in src:
            raise SystemExit("lookup_timings: --ppt needs a sorted lookup with a PPT constant")
        line = src[src.index(const):src.index(";", src.index(const)) + 1]
        src = src.replace(line, f"{const}{args.ppt};", 1)
        sl._LIB["fn"] = build.launcher(build.load(f"sorted_lookup_ppt{args.ppt}", src), "sorted_lookup_launch")
    if args.path is not None:
        if not hasattr(sl, "search_path"):
            raise SystemExit("lookup_timings: --path needs a sorted lookup with search_path")
        sl.search_path = lambda n, C, sms: (
            args.path if args.path == "global" else "table" if C <= sl.SAMPLE_KEYS else "sampled")
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()
    rows = []
    for kernel, what, keys, vals, qs in shapes(gen, dev):
        fn = {"merge_lookup": ml.merge_lookup, "sorted_lookup": sl.sorted_lookup}[kernel]
        got, want = fn(keys, vals, qs), library(keys, vals, qs)
        if not (torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])):
            raise SystemExit(f"lookup_timings: {kernel} at {what} differs from searchsorted + gather")
        del got, want
        rows.append({"kernel": kernel, "shape": what, "ms": device_ms(lambda: fn(keys, vals, qs), args.reps)})
        print(f"{args.label} {kernel} {what}: {rows[-1]['ms']:.4f} ms", flush=True)
    print(json.dumps({"label": args.label, "ppt": args.ppt, "path": args.path, "card": card[0] if card else None, "rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
