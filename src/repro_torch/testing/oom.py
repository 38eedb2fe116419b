"""One real device out-of-memory served by a lower rung of the ladder.

``oom_job`` generates TPC-H on the card, measures the peak memory of each
rung of one query's resident ladder, then caps the process's share of the
card (``torch.cuda.set_per_process_memory_fraction``) until the fused pass
fails with ``torch.cuda.OutOfMemoryError``: the session must classify it
``DeviceOOMError`` and serve the right result from a lower rung.  The smoke
script and the card's tests run it in a spawned worker process.
"""
from __future__ import annotations

import gc

import numpy as np
import torch

import repro_torch
from repro_torch import errors as ERR
from repro_torch import session as SESS
from repro_torch.data import tpch
from repro_torch.exec.queries import REGISTRY


def _check(cond, msg):
    if not cond:
        raise RuntimeError(f"oom_job: {msg}")


def _same_items(got, want, what):
    """Equal key sets and values within the card's cross-executor tolerance."""
    _check(got.keys() == want.keys(), f"{what}: key sets differ ({len(got)} vs {len(want)})")
    ks = list(want)
    g = np.asarray([got[k] for k in ks], dtype=np.float64).reshape(len(ks), -1)
    w = np.asarray([want[k] for k in ks], dtype=np.float64).reshape(len(ks), -1)
    np.testing.assert_allclose(g, w, rtol=SESS.CROSS_EXECUTOR_RTOL, atol=SESS.CROSS_EXECUTOR_ATOL, err_msg=what)


def oom_job(scale, seed, chunk_rows, q):
    """One real out-of-memory on the card, in a worker process: TPC-H at
    ``scale`` generated on the card, each rung of query ``q``'s ladder run
    warm with its peak device memory measured, then a
    ``set_per_process_memory_fraction`` cap bisected between the lighter
    lower rung's reserved peak and the fused pass's until the fused pass
    fails with ``torch.cuda.OutOfMemoryError``, the ladder classifies it
    ``DeviceOOMError`` and a lower rung serves the right result.  The
    fraction is restored after every try.  Returns what it measured and its
    printed lines.  Run it in a fresh process (``spawn``), so that its
    caching allocator holds only this job's memory."""
    dev = torch.device("cuda:0")
    db = tpch.generate(scale=scale, seed=seed, device=dev).tables()
    want = REGISTRY[q].reference(db, **REGISTRY[q].defaults)
    session = repro_torch.connect(db, device=dev, chunk_rows=chunk_rows)
    clean = session.query(q)
    _same_items(clean, want, f"{q} (out-of-memory worker)")
    total = torch.cuda.get_device_properties(dev).total_memory
    shape = session.shape(q)
    bound = shape.query.bind_defaults({})
    peaks, lines = {}, []
    for mode in session._ladder_modes():
        ex, mdb = session._mode_executable(shape, mode)
        ex(mdb, bound)  # warm
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        a0, r0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        res = ex(mdb, bound)
        torch.cuda.synchronize()
        del res
        peaks[mode] = {"allocated_before": a0, "reserved_before": r0,
                       "max_allocated": torch.cuda.max_memory_allocated(),
                       "max_reserved": torch.cuda.max_memory_reserved()}
        lines.append(f"{q} {mode}: max_memory_allocated {peaks[mode]['max_allocated']} B ({a0} before), "
                     f"max_memory_reserved {peaks[mode]['max_reserved']} B ({r0} before)")
    gc.collect()
    torch.cuda.empty_cache()
    hi = peaks["fused"]["max_reserved"]
    lo = min(peaks[m]["max_reserved"] for m in ("materialized", "streamed"))
    out = {"query": q, "peaks": peaks, "tries": [], "served": None, "lines": lines}
    seen = []
    real_classified = ERR.classified

    def classified(e):  # what the ladder saw, and what it made of it
        typed = real_classified(e)
        cause = e.__cause__ if isinstance(e, ERR.ReproError) else e
        seen.append((type(e).__name__, type(cause).__name__ if cause is not None else None, type(typed).__name__))
        return typed

    ERR.classified = classified
    try:
        for _ in range(6 if lo < hi else 0):  # bisect the cap between the lower rung's peak and the fused one's
            cap = (lo + hi) // 2
            session._breaker.clear()
            seen.clear()
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.set_per_process_memory_fraction(cap / total, dev)
            try:
                got = session.query(q)
                rep = session.report()
                result = rep.degradation or "fused"
            except ERR.DeviceOOMError:
                got, result = None, "every rung out of memory"
            finally:
                torch.cuda.set_per_process_memory_fraction(1.0, dev)
                gc.collect()
                torch.cuda.empty_cache()
            out["tries"].append({"cap_bytes": cap, "served": result, "seen": list(seen)})
            lines.append(f"{q} under a cap of {cap} B reserved ({cap / total:.5f} of the card): {result}; "
                         f"the ladder saw {seen}")
            if result == "fused":
                hi = cap
            elif got is None:
                lo = cap
            else:
                _check(("OutOfMemoryError", "OutOfMemoryError", "DeviceOOMError") in seen
                      or ("DeviceOOMError", "OutOfMemoryError", "DeviceOOMError") in seen,
                      f"the fused pass under the cap did not fail with a classified torch.cuda.OutOfMemoryError: {seen}")
                _check(SESS.degraded_equal(got, clean, dev), f"{q} served at {result} differs from its primary")
                _same_items(got, want, f"{q} served at {result} after an out-of-memory, against numpy")
                out.update(served=result, cap_bytes=cap, degraded=rep.degraded, faults=rep.faults)
                break
    finally:
        ERR.classified = real_classified
        torch.cuda.set_per_process_memory_fraction(1.0, dev)
    # the fraction restored, the primary serves again
    session._breaker.clear()
    _same_items(session.query(q), want, f"{q} after the cap was lifted")
    _check(session.report().degraded == 0, f"{q} did not return to its primary rung after the cap was lifted")
    if out["served"] is None:
        lines.append(f"no cap between {lo} and {hi} B reserved made the fused pass of {q} run out of memory while "
                     f"a lower rung fitted (peaks above)")
    else:
        lines.append(f"a real torch.cuda.OutOfMemoryError: {q}'s fused pass under a cap of {out['cap_bytes']} B "
                     f"reserved, classified DeviceOOMError, served at {out['served']} ({out['degraded']} rungs down) "
                     f"with the right result; the fraction restored, the fused rung serves again")
    return out
