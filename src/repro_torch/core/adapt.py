"""Serving-time adaptive planning: race → validate → recalibrate (the twin
of ``repro.core.adapt``).

Algorithm 1 commits to dictionary/fusion/placement choices from an offline
cost model before a single row is touched, and a misrank on the critical
dictionary of a hot query is paid on every request.  This module closes the
loop at serving time (DESIGN.md §11):

* :func:`enumerate_candidates` — the Alg.-1 winner plus its single-symbol
  neighborhood (every alternative ``DictChoice`` for every dictionary,
  re-costed by the full-program ``infer_cost``), filtered to the top-k
  candidates whose modeled cost is within ``(1 + band)`` of the winner's.
  When the model is sure, the band is empty and nothing is raced; when
  candidates are within noise of each other, measurement decides.
* :class:`AdaptivePlanner` — races the candidates on warm-up (or sampled
  live) traffic, validates every raced result against the model-chosen
  plan by the device's rule (:func:`degraded_equal`: bitwise on the CPU;
  on the card exact key sets and integer lanes, float lanes at
  ``CROSS_EXECUTOR_RTOL`` / ``ATOL``, since the fused terminal folds float
  sums by atomics and two runs of one Γ differ in the last bits), caches
  the measured winner per ``(plan fingerprint, binding bucket)``, and feeds
  measured-vs-predicted residuals back into
  ``AnalyticCostModel.apply_residual`` so the model's per-op correction
  table improves as the server runs.

A lane's timed window runs from the call to ``torch.cuda.synchronize`` on a
CUDA device (to the call's return on the CPU) and ends before
``result_items`` copies the result to the host.  The untimed first call of
a lane compiles the candidate's fused regions (``nvcc`` on the card); its
wall is kept as ``Lane.first_s``.

The planner is executor-agnostic: callers hand it ``make_executor(choices)
-> callable(params) -> result`` (resident or streamed executable —
``repro_torch.session.Session`` wires both).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import llql as L
from .cardinality import CardModel
from .cost import CostResult, GammaDict, infer_cost
from .synthesis import DEFAULT_CANDIDATES, _candidates_for, synthesize
from ..data.table import to_numpy

#: the tolerance two results of one query are held to on the card: the
#: fused terminal folds float sums by atomics, in another order than the
#: materialized and streamed folds and than another run of itself, so float
#: lanes agree to the suite's tolerance and key sets and integer lanes
#: exactly
CROSS_EXECUTOR_RTOL = 3e-3
CROSS_EXECUTOR_ATOL = 3e-2


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AdaptConfig:
    """Knobs of the adaptive loop.

    ``band``/``top_k`` bound the race (candidates within ``(1+band)×`` of
    the modeled winner, at most ``top_k`` raced); ``warmup`` is how many
    requests per binding bucket race before the winner freezes;
    ``sample_every`` re-races every Nth steady-state request (0 = never:
    after warm-up the cached winner serves with zero planning overhead);
    ``repeats`` timing repeats per candidate (min taken — races measure
    best-case dispatch, not scheduler noise); ``residual_alpha`` the
    geometric step of :meth:`AnalyticCostModel.apply_residual`;
    ``validate`` turns the result check off (benchmarks only)."""

    band: float = 0.25
    top_k: int = 3
    warmup: int = 1
    sample_every: int = 0
    repeats: int = 2
    residual_alpha: float = 0.5
    validate: bool = True


# ---------------------------------------------------------------------------
# binding buckets
# ---------------------------------------------------------------------------


def binding_bucket(params: Optional[Dict[str, object]]) -> Tuple:
    """Coarse equivalence class of a parameter binding.

    The measured winner of a race is a property of the *data volumes* the
    binding selects, not the exact binding: Q18 at threshold 199 and 201
    want the same plan, Q18 at 0.0 (every group survives) may not.  Floats
    bucket by the rounded log2 of their magnitude (decade-ish resolution),
    ints and strings by value (TPC-H's int knobs — region, color — change
    selectivity per value), so the winner cache neither explodes per
    binding nor conflates regimes."""
    if not params:
        return ()
    out = []
    for name in sorted(params):
        v = params[name]
        if isinstance(v, bool) or isinstance(v, (int, np.integer)):
            out.append((name, int(v)))
        elif isinstance(v, (float, np.floating)):
            a = abs(float(v))
            out.append((name, round(np.log2(a)) if a > 1e-12 else None))
        else:
            out.append((name, str(v)))
    return tuple(out)


def choices_key(choices: GammaDict) -> Tuple:
    """Canonical hashable identity of a Γ assignment."""
    return tuple(
        (sym, c.ds, bool(c.hinted), c.placement or "")
        for sym, c in sorted(choices.items())
    )


# ---------------------------------------------------------------------------
# candidate enumeration (the race roster)
# ---------------------------------------------------------------------------


@dataclass
class Candidate:
    choices: GammaDict
    modeled_s: float
    cost: CostResult
    swapped: str = ""  # symbol whose choice differs from the winner ("" = winner)

    @property
    def key(self) -> Tuple:
        return choices_key(self.choices)


def enumerate_candidates(
    expr: L.Expr,
    sigma: CardModel,
    delta,
    band: float = 0.25,
    top_k: int = 3,
    candidates: Sequence[str] = DEFAULT_CANDIDATES,
    net=None,
    sharded_rels: Optional[Tuple[str, ...]] = None,
) -> List[Candidate]:
    """Alg.-1 winner + its near-cost single-symbol neighborhood.

    Runs the greedy synthesis, then prices every single-symbol swap of the
    winning Γ with the full-program ``infer_cost`` (the same objective the
    greedy minimized), keeps swaps within ``(1 + band)×`` of the winner's
    modeled cost, and returns the ``top_k`` cheapest — winner always first
    (it is the validation reference even when a swap models cheaper, which
    the greedy's known sub-optimality permits)."""
    syn = synthesize(
        expr, sigma, delta, candidates=candidates,
        net=net, sharded_rels=sharded_rels,
    )
    winner = Candidate(dict(syn.choices), syn.cost.total, syn.cost)
    limit = winner.modeled_s * (1.0 + max(0.0, band))
    seen = {winner.key}
    pool: List[Candidate] = []
    for sym in sorted(syn.choices):
        for alt in _candidates_for(sym, expr, candidates):
            trial = dict(syn.choices)
            trial[sym] = alt
            k = choices_key(trial)
            if k in seen:
                continue
            seen.add(k)
            res = infer_cost(
                expr, sigma, delta, trial, net=net, sharded_rels=sharded_rels
            )
            if res.total <= limit:
                pool.append(Candidate(trial, res.total, res, swapped=sym))
    pool.sort(key=lambda c: c.modeled_s)
    return [winner] + pool[: max(0, top_k - 1)]


# ---------------------------------------------------------------------------
# result validation
# ---------------------------------------------------------------------------


def result_items(out) -> Dict[int, np.ndarray]:
    """Normalize any executor result to its ``{key: np.ndarray}`` view."""
    if hasattr(out, "items_np"):
        return out.items_np()
    if isinstance(out, dict):
        return {k: to_numpy(v) for k, v in out.items()}
    raise TypeError(f"cannot normalize result of type {type(out).__name__}")


def bitwise_equal(a: Dict[int, np.ndarray], b: Dict[int, np.ndarray]) -> bool:
    """Same key set, identical value bytes per key."""
    if set(a) != set(b):
        return False
    for k, va in a.items():
        va, vb = np.asarray(va), np.asarray(b[k])
        if va.shape != vb.shape or va.dtype != vb.dtype or not (va == vb).all():
            return False
    return True


def degraded_equal(a, b, device, across_executors: bool = False) -> bool:
    """Whether result ``a`` may stand for result ``b`` of the same query on
    ``device``: a degraded rung's for the primary rung's, or a raced lane's
    for the model-chosen lane's.  On the CPU every plan folds in row order,
    so the results must be bitwise equal.  On the card the key sets and
    integer lanes must be equal and float lanes within
    ``CROSS_EXECUTOR_RTOL`` / ``ATOL``; ``across_executors`` (a sharded
    result against a single-device one, whose float folds differ in order)
    applies the card's rule on every device."""
    if bitwise_equal(a, b):
        return True
    if set(a) != set(b) or not (across_executors or torch.device(device).type == "cuda"):
        return False
    for k, va in a.items():
        va, vb = np.asarray(va), np.asarray(b[k])
        if va.shape != vb.shape or va.dtype != vb.dtype:
            return False
        if np.issubdtype(va.dtype, np.floating):
            if not np.allclose(va, vb, rtol=CROSS_EXECUTOR_RTOL, atol=CROSS_EXECUTOR_ATOL):
                return False
        elif not (va == vb).all():
            return False
    return True


def _sync(device) -> None:
    """Finish ``device``'s queued work (nothing to wait for off the card)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# the adaptive planner
# ---------------------------------------------------------------------------


@dataclass
class Lane:
    """One raced candidate's outcome.  ``first_s``: the wall of its untimed
    first call, result on the host (on the card it includes building the
    candidate's fused regions)."""

    candidate: Candidate
    measured_s: float = float("inf")
    validated: bool = False
    first_s: float = 0.0


@dataclass
class RaceRecord:
    bucket: Tuple
    lanes: List[Lane] = field(default_factory=list)
    winner_key: Tuple = ()

    @property
    def winner(self) -> Optional[Lane]:
        for lane in self.lanes:
            if lane.candidate.key == self.winner_key:
                return lane
        return None


class AdaptivePlanner:
    """Race / validate / recalibrate for ONE query shape (LLQL program) on
    ``device``, whose rule validates the lanes and whose queue ends each
    timed window.

    ``make_executor(choices)`` must return a callable ``run(params) ->
    result``.  Executors are cached per Γ so racing never rebuilds on later
    rounds; the winner per ``(fingerprint, binding bucket)`` serves
    steady-state traffic with no replanning — ``choose`` is a dict
    lookup.  ``net`` and ``sharded_rels`` price the candidates for a sharded
    executor (Δ_net), as synthesis does."""

    def __init__(
        self,
        expr: L.Expr,
        sigma: CardModel,
        delta,
        make_executor: Callable[[GammaDict], Callable],
        config: Optional[AdaptConfig] = None,
        fingerprint: str = "",
        candidates: Sequence[str] = DEFAULT_CANDIDATES,
        device="cpu",
        net=None,
        sharded_rels: Optional[Tuple[str, ...]] = None,
    ):
        self.expr = expr
        self.sigma = sigma
        self.delta = delta
        self.make_executor = make_executor
        self.config = config or AdaptConfig()
        self.fingerprint = fingerprint
        self.candidates = tuple(candidates)
        self.device = torch.device(device)
        self.net = net
        self.sharded_rels = sharded_rels
        self.winners: Dict[Tuple, GammaDict] = {}
        self.races: List[RaceRecord] = []
        self._counts: Dict[Tuple, int] = {}
        self._executors: Dict[Tuple, Callable] = {}

    # -- steady-state entry point -------------------------------------------
    def choose(self, params: Optional[Dict[str, object]] = None) -> GammaDict:
        """The Γ to execute this request under.  Races on the first
        ``warmup`` requests of each binding bucket (and every
        ``sample_every``-th after, when sampling is on); otherwise returns
        the cached winner without touching the cost model."""
        bucket = binding_bucket(params)
        key = (self.fingerprint, bucket)
        n = self._counts.get(bucket, 0)
        self._counts[bucket] = n + 1
        cfg = self.config
        race_now = (
            key not in self.winners
            or n < cfg.warmup
            or (cfg.sample_every and (n % cfg.sample_every) == 0)
        )
        if race_now:
            self.race(params)
        return self.winners[key]

    def executor_for(self, choices: GammaDict) -> Callable:
        k = choices_key(choices)
        ex = self._executors.get(k)
        if ex is None:
            ex = self._executors[k] = self.make_executor(dict(choices))
        return ex

    # -- one race round ------------------------------------------------------
    def race(self, params: Optional[Dict[str, object]] = None) -> RaceRecord:
        """Enumerate the near-cost candidates under the CURRENT (corrected)
        cost model, run each on this binding, validate it against the
        model-chosen reference by the device's rule, time the validated
        ones, install the measured winner, and push residuals into the
        correction table."""
        cfg = self.config
        bucket = binding_bucket(params)
        cands = enumerate_candidates(
            self.expr, self.sigma, self.delta,
            band=cfg.band, top_k=cfg.top_k, candidates=self.candidates,
            net=self.net, sharded_rels=self.sharded_rels,
        )
        record = RaceRecord(bucket)
        reference: Optional[Dict[int, np.ndarray]] = None
        for cand in cands:
            lane = Lane(cand)
            record.lanes.append(lane)
            ex = self.executor_for(cand.choices)
            t0 = time.perf_counter()
            items = result_items(ex(params))  # the first call, untimed
            lane.first_s = time.perf_counter() - t0
            if reference is None:
                reference = items  # model winner IS the reference
                lane.validated = True
            else:
                lane.validated = (not cfg.validate) or degraded_equal(
                    items, reference, self.device
                )
            if not lane.validated:
                continue  # never adopt (or learn from) an unvalidated lane
            best = float("inf")
            for _ in range(max(1, cfg.repeats)):
                t0 = time.perf_counter()
                ex(params)
                _sync(self.device)
                best = min(best, time.perf_counter() - t0)
            lane.measured_s = best
            self._recalibrate(cand, best)
        winner = min(
            (ln for ln in record.lanes if ln.validated),
            key=lambda ln: ln.measured_s,
        )
        record.winner_key = winner.candidate.key
        self.winners[(self.fingerprint, bucket)] = dict(winner.candidate.choices)
        self.races.append(record)
        return record

    # -- residual feedback ---------------------------------------------------
    def _recalibrate(self, cand: Candidate, measured_s: float) -> None:
        """One ``apply_residual`` step per dominant op of the candidate.

        The measured/predicted ratio of a whole plan is attributed to the
        (ds, op[, ordered]) keys that dominate its modeled dictionary cost
        (≥ 20% share) — blaming every op equally would smear a single
        mispriced coefficient across the table; blaming only the top one
        starves multi-dictionary plans.  Predictions use the corrections
        already applied, so repeated consistent races converge the factors
        instead of double-counting."""
        apply_residual = getattr(self.delta, "apply_residual", None)
        op_key = getattr(self.delta, "op_key", None)
        if apply_residual is None or op_key is None:
            return  # learned / foreign Δ: racing still works, learning is off
        if not (measured_s > 0.0) or not (cand.modeled_s > 0.0):
            return
        ratio = measured_s / cand.modeled_s
        by_key: Dict[Tuple, List] = {}
        dict_total = 0.0
        for it in cand.cost.items:
            try:
                k = op_key(it.ds, it.op, it.ordered)
            except KeyError:
                continue
            by_key.setdefault(k, []).append(it)
            dict_total += it.seconds
        if dict_total <= 0.0:
            return
        for k, items in by_key.items():
            share = sum(it.seconds for it in items) / dict_total
            if share < 0.2:
                continue
            rep = max(items, key=lambda it: it.seconds)
            apply_residual(
                rep.ds, rep.op, rep.ordered, ratio, alpha=self.config.residual_alpha
            )
