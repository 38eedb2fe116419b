"""Program synthesis — the paper's Algorithm 1 (greedy data-structure choice).

Given an LLQL program with open ``@ds`` annotations, a cardinality model Σ and
a dictionary cost model Δ, pick per dictionary symbol the implementation (and,
for sort-based families, whether its access sites use the hinted/merge form)
that minimises the inferred program cost.

Exactly as in the paper:
* symbols are visited in dependency order (a dictionary that is *probed while
  building another* is decided first);
* each decision evaluates the full-program cost with the candidate choice and
  the already-fixed choices (Γ), remaining symbols at their defaults;
* ties and local optima: the paper notes the greedy can be sub-optimal when
  dictionaries are iterated downstream (e.g. Q18, in-DB ML); we additionally
  provide ``synthesize_exhaustive`` for small programs, used in tests to
  check the greedy's optimality gap.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from . import llql as L
from .cardinality import CardModel
from .cost import CostResult, DictChoice, DictCostModel, GammaDict, infer_cost

DEFAULT_CANDIDATES: Tuple[str, ...] = (
    "ht_linear",
    "ht_twochoice",
    "st_sorted",
    "st_blocked",
)


@dataclass
class SynthesisResult:
    choices: GammaDict
    cost: CostResult
    evaluated: int = 0
    log: List[str] = field(default_factory=list)

    def annotated(self, expr: L.Expr) -> L.Expr:
        return L.annotate(expr, {k: v.ds for k, v in self.choices.items()})


# ---------------------------------------------------------------------------
# Dependency order (Alg. 1 line 3)
# ---------------------------------------------------------------------------


def dependency_order(
    expr: L.Expr, log: Optional[List[str]] = None
) -> Tuple[str, ...]:
    """Topological order of dictionary symbols: if building/filling symbol B
    probes symbol A, then A precedes B.  Ties broken by program order.

    On a dependency cycle the remaining symbols fall back to program order;
    the cycle is recorded in ``log`` (surfaced through
    ``SynthesisResult.log``) so synthesis explains stay trustworthy."""
    syms = list(L.dict_symbols(expr))
    deps: Dict[str, set] = {s: set() for s in syms}

    def updated_dict(e: L.Expr) -> Optional[str]:
        d = e.dict  # type: ignore[attr-defined]
        return d.name if isinstance(d, L.Var) else None

    def looked_up(e: L.Expr) -> Iterable[str]:
        for n in L.walk(e):
            if isinstance(n, (L.DictLookup, L.HintedLookup)) and isinstance(
                n.dict, L.Var
            ):
                yield n.dict.name

    # For every update site of B, every dictionary looked up in the update's
    # enclosing statement is a dependency of B.
    def scan(e: L.Expr) -> None:
        for n in L.walk(e):
            if isinstance(n, (L.DictUpdate, L.HintedUpdate)):
                b = updated_dict(n)
                if b in deps:
                    for a in looked_up(n):
                        if a in deps and a != b:
                            deps[b].add(a)

    scan(expr)
    out: List[str] = []
    remaining = list(syms)
    while remaining:
        progress = False
        for s in list(remaining):
            if deps[s] <= set(out):
                out.append(s)
                remaining.remove(s)
                progress = True
        if not progress:  # cycle — fall back to program order
            cycle = {
                s: sorted(deps[s] - set(out)) for s in remaining
            }
            if log is not None:
                log.append(
                    "dependency cycle: "
                    + "; ".join(f"{s} <- {', '.join(d)}" for s, d in cycle.items())
                    + " — falling back to program order"
                )
            out.extend(remaining)
            break
    return tuple(out)


# ---------------------------------------------------------------------------
# Candidate enumeration per symbol
# ---------------------------------------------------------------------------


def _placeable_syms(
    expr: L.Expr,
    sigma: CardModel,
    delta: DictCostModel,
    net,
    sharded_rels: Optional[Tuple[str, ...]],
) -> Optional[set]:
    """Symbols whose distributed *placement* is a real degree of freedom:
    index/partition dictionaries (nested values — the Fig. 6a build side,
    probed downstream) that are built, transitively, from a sharded base
    relation.  Dictionaries built purely from replicated inputs stay
    replicated under the legalizer, so enumerating placements for them would
    only double the search and stamp meaningless labels on the choices."""
    if net is None or net.n_shards <= 1:
        return None
    base = infer_cost(expr, sigma, delta)
    return {
        name
        for name, meta in base.dict_meta.items()
        if meta.nested
        and (sharded_rels is None or meta.build_rels & set(sharded_rels))
    }


def _candidates_for(
    sym: str, expr: L.Expr, candidates: Sequence[str], placeable=None
) -> List[DictChoice]:
    """ds × hinted (× placement) variants.  ``hinted`` is only meaningful for
    sort-based implementations, and only when the program actually contains
    hinted sites for this symbol *or* the cost model is allowed to consider
    the merge form (the lowering can legalise hinted probes whenever the
    probe sequence is sorted — the `ordered` flag in Δ prices exactly that).
    Under a distributed cost realization, symbols in ``placeable``
    additionally enumerate their placement — broadcast-build vs
    co-partitioned — so Alg. 1 decides implementation and placement jointly.
    """
    out = []
    for ds in candidates:
        if ds.startswith("st"):
            out.append(DictChoice(ds, hinted=True))
            out.append(DictChoice(ds, hinted=False))
        else:
            out.append(DictChoice(ds))
    if placeable is not None and sym in placeable:
        out = [
            DictChoice(c.ds, c.hinted, placement)
            for c in out
            for placement in ("partition", "broadcast")
        ]
    return out


# ---------------------------------------------------------------------------
# Algorithm 1
# ---------------------------------------------------------------------------


def synthesize(
    expr: L.Expr,
    sigma: CardModel,
    delta: DictCostModel,
    candidates: Sequence[str] = DEFAULT_CANDIDATES,
    net=None,
    sharded_rels: Optional[Tuple[str, ...]] = None,
) -> SynthesisResult:
    """Greedy Algorithm 1.  Pass ``net`` (a :class:`repro_torch.core.cost.NetCostModel`)
    to cost the *distributed* realization — each candidate then also pays the
    Exchange the sharded executor would insert for its dictionary, so choices
    account for shuffle volume, not just local op costs."""
    log: List[str] = []
    order = dependency_order(expr, log=log)
    placeable = _placeable_syms(expr, sigma, delta, net, sharded_rels)
    gamma: GammaDict = {}
    evaluated = 0
    for sym in order:
        best: Optional[DictChoice] = None
        best_cost = float("inf")
        for choice in _candidates_for(sym, expr, candidates, placeable):
            trial = dict(gamma)
            trial[sym] = choice
            res = infer_cost(
                expr, sigma, delta, trial, net=net, sharded_rels=sharded_rels
            )
            evaluated += 1
            if res.total < best_cost:
                best_cost = res.total
                best = choice
        assert best is not None
        gamma[sym] = best
        log.append(f"{sym}: {best} ({best_cost*1e3:.3f} ms)")
    final = infer_cost(expr, sigma, delta, gamma, net=net, sharded_rels=sharded_rels)
    return SynthesisResult(choices=gamma, cost=final, evaluated=evaluated, log=log)


def synthesize_exhaustive(
    expr: L.Expr,
    sigma: CardModel,
    delta: DictCostModel,
    candidates: Sequence[str] = DEFAULT_CANDIDATES,
    net=None,
    sharded_rels: Optional[Tuple[str, ...]] = None,
) -> SynthesisResult:
    """Exact search over the full cross product — exponential; tests only."""
    syms = L.dict_symbols(expr)
    placeable = _placeable_syms(expr, sigma, delta, net, sharded_rels)
    per_sym = [_candidates_for(s, expr, candidates, placeable) for s in syms]
    best: Optional[GammaDict] = None
    best_res: Optional[CostResult] = None
    evaluated = 0
    for combo in itertools.product(*per_sym):
        gamma = dict(zip(syms, combo))
        res = infer_cost(
            expr, sigma, delta, gamma, net=net, sharded_rels=sharded_rels
        )
        evaluated += 1
        if best_res is None or res.total < best_res.total:
            best_res, best = res, gamma
    assert best is not None and best_res is not None
    return SynthesisResult(choices=best, cost=best_res, evaluated=evaluated)
