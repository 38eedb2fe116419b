"""Typed error taxonomy for fault-tolerant serving (DESIGN.md §12).

The paper's core equivalence result — every dictionary implementation
realizes the same LLQL semantics, differing only in cost — is what makes
*recovery* legal: when an execution mode fails, a cheaper-but-equivalent
mode can re-run the query and the answer is still the answer.  This module
gives every failure a type so callers can tell the three kinds apart:

* **permanent** (``PlanError``) — the request itself is wrong (unknown
  parameter, NaN binding, unsupported program shape).  Retrying is useless;
  the error goes straight back to the caller.
* **transient** (``CompileError``, ``FaultInjected``, ``ShardExecError``)
  — the attempt failed but the same attempt may succeed: retry with
  backoff (``QueryServer``), same execution mode.
* **degradable** (``DeviceOOMError``, repeated transient failures) — the
  *mode* is broken, not the query: re-execute down the degradation ladder
  (fused → materialized → streamed, ``Session``) and open the
  per-(shape, mode) circuit breaker.

``classify`` maps raw runtime exceptions (XLA RESOURCE_EXHAUSTED, jit
failures) onto the taxonomy at the engine boundary, so nothing above the
executor ever has to string-match an XLA message.
"""
from __future__ import annotations

from typing import Dict, Optional


class ReproError(Exception):
    """Base of every typed error the repro stack raises deliberately."""

    #: transient errors are retry-worthy (same mode, backoff); permanent
    #: ones go straight back to the caller
    transient = False

    #: attribute names serialized by :meth:`to_dict` (and restored by
    #: :func:`from_dict`) beyond kind/transient/message — subclasses with
    #: structured payload declare theirs here
    _payload_fields: tuple = ()

    def to_dict(self) -> Dict[str, object]:
        """Structured wire form: ``kind`` (class name), ``transient``,
        ``message``, plus every declared payload field.  Response payloads
        carry this instead of exception objects so clients never parse
        message strings (DESIGN.md §12)."""
        d: Dict[str, object] = {
            "kind": type(self).__name__,
            "transient": bool(self.transient),
            "message": str(self),
        }
        for f in self._payload_fields:
            d[f] = getattr(self, f, None)
        return d


class PlanError(ReproError):
    """The request or program is invalid: unknown/missing/NaN parameter
    bindings, wrong binding dtypes, or an LLQL shape outside the recognized
    forms.  Permanent — raised at the API boundary, before any tracing."""


class CompileError(ReproError):
    """Tracing / XLA compilation of a cold shape failed.  Transient: a
    retry re-enters the compile (the failed attempt populated no cache)."""

    transient = True


class DeviceOOMError(ReproError):
    """The device ran out of memory (or an injected stand-in did).
    Not retryable at the same rung — the degradation ladder re-executes
    the query in a cheaper mode (materialized, then streamed under a
    shrunken memory budget)."""


class DeadlineExceeded(ReproError):
    """The request's deadline passed (or the next serving round is
    predicted — from warm latency counters — to miss it).  Carries the
    deadline and, when shed pre-emptively, the predicted completion."""

    _payload_fields = ("deadline_s", "predicted_s")

    def __init__(
        self,
        msg: str = "deadline exceeded",
        deadline_s: Optional[float] = None,
        predicted_s: Optional[float] = None,
    ):
        super().__init__(msg)
        self.deadline_s = deadline_s
        self.predicted_s = predicted_s


class AdmissionRejected(ReproError):
    """Load shedding at the queue boundary: the bounded request queue is
    full.  Carries the observed queue depth and a retry-after hint derived
    from the server's warm throughput counters."""

    _payload_fields = ("queue_depth", "retry_after_s")

    def __init__(
        self,
        msg: str = "queue full",
        queue_depth: int = 0,
        retry_after_s: float = 0.0,
    ):
        super().__init__(msg)
        self.queue_depth = queue_depth
        self.retry_after_s = retry_after_s


class FaultInjected(ReproError):
    """A deterministic fault from ``repro_torch.testing.faults`` — the chaos
    harness's stand-in for a sporadic device/runtime failure.  Transient by
    construction (fail-nth / fail-once specs pass on retry)."""

    transient = True
    _payload_fields = ("point",)

    def __init__(self, msg: str = "injected fault", point: str = ""):
        super().__init__(msg)
        self.point = point


class ShardExecError(ReproError):
    """A shard-local execution or cross-shard collective failed (a shard's
    launch died, an all-to-all / all-gather / psum collective aborted).
    Transient: the mesh is still up, so the same sharded attempt may
    succeed on retry; repeated failures degrade through the sharded ladder
    (materialized-sharded, then the single-shard replan rung)."""

    transient = True
    _payload_fields = ("site",)

    def __init__(self, msg: str = "shard execution failed", site: str = ""):
        super().__init__(msg)
        self.site = site  # "exec" | "merge" | free-form collective name


class UnsupportedSessionError(ReproError):
    """The session's execution regime is outside what this component
    supports (e.g. ``QueryServer(share_scans=True)`` over a sharded
    session — cross-query shared-scan merging is per-host only)."""


def is_transient(err: BaseException) -> bool:
    return bool(getattr(err, "transient", False))


def _taxonomy() -> Dict[str, type]:
    """Every concrete member of the taxonomy, by class name (recursive —
    ``PlanError`` subclasses like lowering's ``_Unsupported`` resolve to
    their public base by walking the MRO in :func:`from_dict`)."""
    out: Dict[str, type] = {"ReproError": ReproError}
    stack = [ReproError]
    while stack:
        cls = stack.pop()
        for sub in cls.__subclasses__():
            out.setdefault(sub.__name__, sub)
            stack.append(sub)
    return out


def from_dict(d: Dict[str, object]) -> ReproError:
    """Rebuild a typed error from its :meth:`ReproError.to_dict` wire form.
    Unknown kinds fall back to the ``ReproError`` base (forward
    compatibility) — ``kind``/``message``/payload fields round-trip for
    every taxonomy member."""
    cls = _taxonomy().get(str(d.get("kind", "")), ReproError)
    msg = str(d.get("message", ""))
    kwargs = {
        f: d[f] for f in getattr(cls, "_payload_fields", ()) if f in d
    }
    try:
        err = cls(msg, **kwargs)
    except TypeError:  # subclass with a bespoke __init__ signature
        err = cls(msg)
        for f, v in kwargs.items():
            setattr(err, f, v)
    return err


# -- classification of raw runtime errors -----------------------------------

#: substrings that mark an out-of-memory failure across jax/XLA versions
_OOM_MARKS = (
    "RESOURCE_EXHAUSTED",
    "Out of memory",
    "out of memory",
    "OOM",
    "Resource exhausted",
)

_COMPILE_MARKS = (
    "INTERNAL: Failed to compile",
    "Compilation failure",
    "compilation failed",
    "UNIMPLEMENTED",
)

#: substrings marking a cross-shard collective / shard-local launch failure
#: across jax/XLA versions — checked after the OOM and compile marks, so a
#: collective that died from memory exhaustion still classifies as OOM
_SHARD_MARKS = (
    "all_to_all",
    "all-to-all",
    "all_gather",
    "all-gather",
    "all_reduce",
    "all-reduce",
    "collective_permute",
    "CollectivePermute",
    "NCCL",
    "collective operation",
    "launch failed on shard",
)


def classify(err: BaseException) -> Optional[ReproError]:
    """Map a raw exception onto the taxonomy.

    Returns the matching :class:`ReproError` (the error itself when already
    typed, a wrapper chained via ``__cause__`` for recognized runtime
    failures), or ``None`` for exceptions that are none of our business —
    genuine bugs must keep their original type and traceback."""
    if isinstance(err, ReproError):
        return err
    # jax re-raises through trace machinery; the original typed error (an
    # injected fault firing inside a traced region body) rides __cause__
    cause = err.__cause__
    while cause is not None:
        if isinstance(cause, ReproError):
            return cause
        cause = cause.__cause__
    if isinstance(err, MemoryError):
        oom = DeviceOOMError(str(err) or "host out of memory")
        oom.__cause__ = err
        return oom
    name = type(err).__name__
    if name in ("OutOfMemoryError", "RuntimeError"):  # torch.cuda's OOM too
        msg = str(err)
        if any(m in msg for m in _OOM_MARKS):
            oom = DeviceOOMError(msg.splitlines()[0][:300])
            oom.__cause__ = err
            return oom
        if any(m in msg for m in _COMPILE_MARKS):
            ce = CompileError(msg.splitlines()[0][:300])
            ce.__cause__ = err
            return ce
        if any(m in msg for m in _SHARD_MARKS):
            se = ShardExecError(msg.splitlines()[0][:300], site="collective")
            se.__cause__ = err
            return se
    return None


def classified(err: BaseException) -> BaseException:
    """``classify`` with pass-through: the typed wrapper when one applies,
    otherwise the original exception unchanged."""
    return classify(err) or err
