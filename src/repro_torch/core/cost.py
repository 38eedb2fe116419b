"""LLQL cost model — the paper's Fig. 8 inference rules.

Combines three ingredients, exactly as the paper does:

* **Σ** (``cardinality.CardModel``) — cardinalities, distinct counts,
  selectivities, physical orderedness of inputs;
* **Δ** (``DictCostModel`` protocol) — per-operation dictionary costs.  The
  production Δ is *learned* from installation-stage profiling
  (``repro_torch.costmodel``); ``AnalyticCostModel`` below is a closed-form fallback
  used by unit tests and as a sanity prior;
* **Γ** (``Gamma``) — the runtime context threaded through the rules:
  accumulated invocation count ``Γ_calls``, path probability ``Γ_cond``, and
  the dictionary-implementation assignment ``Γ_dict``.

The inference walks the program once, maintaining per-dictionary metadata
(estimated cardinality, nested-group size, build orderedness), and emits both
a total cost and a per-site breakdown (for the paper-style "explain" output
in the benchmarks).

Deviation from the paper (documented): Fig. 8's lookup rule sets the hit
fraction σ = Σ_dist(e2)/N, which exceeds 1 whenever the probe side has more
distinct keys than the dictionary.  We use the standard containment form
σ = min(1, N / Σ_dist(e2)) — identical on the paper's key/foreign-key
workloads, well-behaved elsewhere.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Protocol, Tuple, Union

from . import llql as L
from .cardinality import CardModel, key_columns

DEFAULT_DS = "ht_linear"

# Vectorized-engine counting (DESIGN.md §2, EXPERIMENTS.md §Perf finding):
# on batch-vectorized hardware a masked (filtered) loop still runs every
# row through the dictionary op, and a masked build cannot use the
# sorted-input fast path (dicts.base re-sorts under a mask).  The paper's
# per-row rules (Fig. 8 exactly) are recovered with vectorized=False.
VECTORIZED_DEFAULT = True

# ---------------------------------------------------------------------------
# Δ — dictionary cost model interface
# ---------------------------------------------------------------------------

OPS = ("insert", "lookup_hit", "lookup_miss")


class DictCostModel(Protocol):
    def op_cost(self, ds: str, op: str, n: float, size: float, ordered: bool) -> float:
        """Total cost in **seconds** of ``n`` operations of kind ``op`` against
        a dictionary of (final) cardinality ``size``; ``ordered`` = the key
        sequence of the n operations is sorted."""
        ...


# Per-op leading coefficients (nanoseconds) of the analytic shapes below:
# hash entries are keyed (ds, op) — order-insensitive; sort entries are
# keyed (ds, op, ordered) — the ordered coefficient is the flat amortized
# per-op cost of the hinted fast path, the unordered one multiplies log2(N).
PRIOR_OP_NS = {
    ("ht_linear", "insert"): 26.0,
    ("ht_linear", "lookup_hit"): 18.0,
    ("ht_linear", "lookup_miss"): 34.0,
    ("ht_twochoice", "insert"): 38.0,
    ("ht_twochoice", "lookup_hit"): 22.0,
    ("ht_twochoice", "lookup_miss"): 24.0,
    ("st_sorted", "insert", True): 7.0,
    ("st_sorted", "lookup_hit", True): 9.0,
    ("st_sorted", "lookup_miss", True): 9.0,
    ("st_blocked", "insert", True): 6.3,
    ("st_blocked", "lookup_hit", True): 8.1,
    ("st_blocked", "lookup_miss", True): 8.1,
    ("st_sorted", "insert", False): 14.0,
    ("st_sorted", "lookup_hit", False): 11.0,
    ("st_sorted", "lookup_miss", False): 11.0,
    ("st_blocked", "insert", False): 14.0,
    ("st_blocked", "lookup_hit", False): 6.05,
    ("st_blocked", "lookup_miss", False): 6.05,
}

# Coefficients fitted against a measured sweep on the reference engine
# (``benchmarks/profile_dicts.py`` — the paper's profiled-regression story
# in miniature: same closed-form shapes, leading constants regressed by
# median ratio from ``costmodel.profiler`` timings; rank agreement 0.98
# over 345 well-separated pairs at fit time).  The sweep they were fitted
# to is committed as benchmarks/baselines/BENCH_profile_dicts.json and
# tests/test_cost_calibration.py replays it: predicted per-op rankings
# must keep matching the measured ones.  Note the vectorized-engine truths
# the priors missed: a batch hash insert costs ~µs/op at these batch
# shapes (round-based scatter arbitration), while an ordered sort-family
# build is ~100 ns/op and an unordered one ~30·log2(N) — which is exactly
# why Algorithm 1 under this Δ favours ``st_*<hinted>`` builds on sorted
# fact streams.
CALIBRATED_OP_NS = {
    ("ht_linear", "insert"): 2418.17,
    ("ht_linear", "lookup_hit"): 75.26,
    ("ht_linear", "lookup_miss"): 70.04,
    ("ht_twochoice", "insert"): 2049.99,
    ("ht_twochoice", "lookup_hit"): 86.7,
    ("ht_twochoice", "lookup_miss"): 77.56,
    ("st_blocked", "insert", False): 29.56,
    ("st_blocked", "insert", True): 109.98,
    ("st_blocked", "lookup_hit", False): 22.21,
    ("st_blocked", "lookup_hit", True): 298.79,
    ("st_blocked", "lookup_miss", False): 21.31,
    ("st_blocked", "lookup_miss", True): 266.21,
    ("st_sorted", "insert", False): 29.79,
    ("st_sorted", "insert", True): 106.07,
    ("st_sorted", "lookup_hit", False): 5.68,
    ("st_sorted", "lookup_hit", True): 56.04,
    ("st_sorted", "lookup_miss", False): 4.74,
    ("st_sorted", "lookup_miss", True): 50.07,
}


class AnalyticCostModel:
    """Closed-form Δ with plausible big-O shapes and table-driven constants.

    Used by unit tests and as the pre-installation prior; the learned model
    (``repro_torch.costmodel.load_model``) replaces it after profiling.
    ``constants`` selects the leading coefficients: ``"prior"`` (hand-set
    plausible values — the default, stable for unit tests) or
    ``"calibrated"`` (fitted from the measured sweep), or an explicit
    table.  Only *relative* shape matters for synthesis.

    ``corrections`` is the ONLINE recalibration table (DESIGN.md §11): a
    per-(ds, op[, ordered]) multiplicative factor, updated from
    measured-vs-predicted residuals by the adaptive planner
    (``core.adapt``) as raced candidates report real wall times.  It
    starts empty (identity) and deforms the installed constants toward
    what this process actually measures — the serving-time continuation
    of the offline profiled regression.
    """

    def __init__(
        self, scale: float = 1.0, constants="prior", corrections=None
    ) -> None:
        self.scale = scale
        if constants == "prior":
            self.table = PRIOR_OP_NS
        elif constants == "calibrated":
            self.table = CALIBRATED_OP_NS
        else:
            self.table = dict(constants)
        self.corrections: Dict[tuple, float] = dict(corrections or {})

    @classmethod
    def calibrated(cls, scale: float = 1.0) -> "AnalyticCostModel":
        return cls(scale, constants="calibrated")

    @staticmethod
    def op_key(ds: str, op: str, ordered: bool) -> tuple:
        if ds.startswith("ht"):
            return (ds, op)
        if ds.startswith("st"):
            return (ds, op, bool(ordered))
        raise KeyError(f"unknown dictionary implementation {ds!r}")

    def correction(self, ds: str, op: str, ordered: bool = False) -> float:
        return self.corrections.get(self.op_key(ds, op, ordered), 1.0)

    def apply_residual(
        self,
        ds: str,
        op: str,
        ordered: bool,
        ratio: float,
        alpha: float = 0.5,
    ) -> float:
        """One online-recalibration step: nudge the (ds, op) correction a
        geometric ``alpha`` of the way toward the observed
        measured/predicted ratio (predicted under the CURRENT corrections,
        so repeated consistent observations converge the factor).  Returns
        the updated correction."""
        key = self.op_key(ds, op, ordered)
        ratio = min(max(float(ratio), 1e-3), 1e3)
        cur = self.corrections.get(key, 1.0)
        new = min(max(cur * ratio ** float(alpha), 1e-4), 1e4)
        self.corrections[key] = new
        return new

    @staticmethod
    def shape_factor(ds: str, op: str, size: float, ordered: bool) -> float:
        """The size-dependent multiplier of the per-op cost — everything in
        ``op_cost`` except the leading coefficient.  Shared with the fitter
        (``benchmarks/profile_dicts.py``) so fitted constants live in
        exactly the model's shape family."""
        size = max(2.0, float(size))
        lg = math.log2(size)
        if ds.startswith("ht"):
            return 1.0 + 0.12 * max(0.0, lg - 10.0)  # past-L1 growth
        if ordered:
            # hinted/merge access or append-build: amortized O(1)
            return 1.0
        growth = 1.0 + 0.05 * max(0.0, lg - 13.0)
        # unordered sorted-dict build ~ sort, lookup ~ binary search:
        # O(log n) amortized per op
        return lg * growth

    def op_cost(self, ds: str, op: str, n: float, size: float, ordered: bool) -> float:
        n = max(0.0, float(n))
        if n == 0.0:
            return 0.0
        key = self.op_key(ds, op, ordered)
        per = (
            self.table[key]
            * self.corrections.get(key, 1.0)
            * self.shape_factor(ds, op, size, ordered)
        )
        return self.scale * n * per * 1e-9


# ---------------------------------------------------------------------------
# Γ — runtime context & synthesis choices
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DictChoice:
    ds: str = DEFAULT_DS
    hinted: bool = False  # use hinted (iterator/merge) probe & insert sites
    # Distributed placement of a dictionary built from sharded rows:
    # "partition" — hash-repartition the build rows by key, per-shard slices,
    #               probes repartitioned to match (co-partitioned join);
    # "broadcast" — all-gather the build rows, replicated copy, local probes;
    # ""          — unplaced (single-shard plans; legalizer defaults to
    #               "partition").  Chosen by Alg. 1 under Δ_net.
    placement: str = ""

    def __str__(self) -> str:
        s = self.ds + ("<hinted>" if self.hinted else "")
        return s + (f"@{self.placement}" if self.placement else "")


GammaDict = Dict[str, DictChoice]


# ---------------------------------------------------------------------------
# Δ_net — exchange/shuffle cost for the distributed plan realization
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class NetCostModel:
    """α-β model of the cross-shard Exchange the sharded executor inserts
    after every dictionary built from sharded inputs (DESIGN.md §4): each
    shard's partial dictionary is routed by key hash through an all-to-all,
    then merged by one local build.  ``shuffle_seconds`` prices the wire
    traffic; the merge build is priced through Δ by the caller."""

    n_shards: int = 1
    alpha: float = 2e-6  # per-collective latency (s) — one all-to-all phase
    beta: float = 1.0 / 10e9  # seconds per byte through the interconnect
    key_bytes: float = 4.0  # int32 keys
    lane_bytes: float = 4.0  # f32 value lanes

    def entry_bytes(self, lanes: float = 1.0) -> float:
        return self.key_bytes + self.lane_bytes * max(1.0, lanes)

    def shuffle_seconds(self, entries: float, lanes: float = 1.0) -> float:
        if self.n_shards <= 1 or entries <= 0:
            return 0.0
        hops = math.log2(max(2.0, float(self.n_shards)))
        return self.alpha * hops + entries * self.entry_bytes(lanes) * self.beta

    def repartition_seconds(self, rows: float, lanes: float = 1.0) -> float:
        """Hash all-to-all of ``rows`` global rows: per-shard wall clock —
        each shard sends and receives ~rows/n_shards entries."""
        if self.n_shards <= 1 or rows <= 0:
            return 0.0
        hops = math.log2(max(2.0, float(self.n_shards)))
        per_shard = rows / float(self.n_shards)
        return self.alpha * hops + per_shard * self.entry_bytes(lanes) * self.beta

    def broadcast_seconds(self, rows: float, lanes: float = 1.0) -> float:
        """All-gather of ``rows`` global rows onto every shard: each shard
        receives the (n-1)/n of the rows it does not already hold."""
        if self.n_shards <= 1 or rows <= 0:
            return 0.0
        hops = math.log2(max(2.0, float(self.n_shards)))
        recv = rows * (1.0 - 1.0 / float(self.n_shards))
        return self.alpha * hops + recv * self.entry_bytes(lanes) * self.beta


# ---------------------------------------------------------------------------
# Δ_fuse — the fuse-vs-materialize term for pipeline regions (DESIGN.md §7)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FusionCostModel:
    """Prices the per-region fuse/materialize decision of ``plan.fuse``.

    Fusing a ``Scan → Select* → HashProbe* → GroupBy/Reduce`` chain into one
    streaming kernel saves the HBM round-trips of every elided intermediate
    (masks written+reread by the next operator, probe-gathered build-side
    columns materialized at probe-stream width) at the price of keeping the
    probed dictionaries *and* their gather payloads co-resident in VMEM for
    the whole pass.  Δ_fuse is therefore

        saved_bytes / hbm_bytes_per_sec      if resident ≤ vmem_budget
        -inf                                 otherwise (must split)

    — a fused region is profitable whenever it elides any intermediate and
    its working set fits; a region that does not fit is split at probe
    boundaries (the overflowing probe materializes, the rest stays fused).
    Constants are deliberately coarse: only the *sign* and the budget
    comparison drive planning, mirroring how Δ_net only needs relative
    ordering.
    """

    hbm_bytes_per_sec: float = 8.0e11  # ~TPU HBM stream bandwidth
    vmem_budget: int = 8 << 20  # bytes for co-resident dicts + payloads
    mask_bytes: float = 2.0  # bool intermediate: write + reread
    col_bytes: float = 8.0  # f32/int32 intermediate: write + reread
    key_bytes: float = 4.0
    lane_bytes: float = 4.0
    default_rows: float = float(1 << 16)  # unknown-source fallback
    default_cols: float = 4.0  # unknown build-side width fallback
    # -- radix-partitioned fused execution (DESIGN.md §8) -------------------
    kernel_slots: int = 1 << 16  # per-dictionary resident slot bound (the
    # fused kernel's VMEM contract; a dictionary over it must partition)
    max_partitions: int = 64  # 0 or 1 disables the partitioned mode
    partition_pass_factor: float = 1.0  # the routing pass costs ~this many
    # stream round-trips (col_bytes already counts write + reread)
    probe_random_bytes: float = 32.0  # effective HBM bytes per probe of a
    # NON-resident dictionary — random gathers are latency-bound, not
    # bandwidth-bound, so an out-of-VMEM probe costs far more than its 4-byte
    # payload; this is the TPU translation of the paper's cache-consciousness
    # argument, and the term that makes co-residing a partitioned slab worth
    # one extra routing pass over the fact stream
    # -- chained out-of-core streaming (DESIGN.md §10/§11) ------------------
    chunk_rows: float = float(1 << 16)  # mirrors storage.CHUNK_ROWS — the
    # planner's estimate of how many source rows one streamed chunk holds
    spill_budget: int = 8 << 20  # device bytes a spilled-and-decoded chained
    # intermediate may occupy: beyond it the spill-and-run-resident
    # alternative is not available and the downstream chain MUST stay fused
    # onto the pending stream

    def dict_bytes(self, capacity: float, lanes: float) -> float:
        """VMEM footprint of a resident dictionary slab."""
        return float(capacity) * (
            self.key_bytes + self.lane_bytes * max(1.0, float(lanes))
        )

    def payload_bytes(self, capacity: float, ncols: float) -> float:
        """VMEM footprint of the gather payload a fused probe keeps resident
        (build-side columns re-keyed to dictionary slots — see
        ``kernels.fused_pipeline``)."""
        return float(capacity) * self.lane_bytes * max(0.0, float(ncols))

    def delta_fuse(self, saved_bytes: float, resident_bytes: float) -> float:
        """Seconds saved by fusing the region; ``-inf`` when the region's
        resident working set cannot fit the VMEM budget."""
        if resident_bytes > self.vmem_budget:
            return float("-inf")
        return float(saved_bytes) / self.hbm_bytes_per_sec

    def delta_partition(
        self,
        saved_bytes: float,
        resident_bytes: float,
        rows: float,
        stream_cols: float,
    ) -> float:
        """Seconds saved by running the region fused-*partitioned* instead
        of materialized: the full fusion saving minus the radix routing
        pass — every streamed column (plus the live mask) is written and
        reread ``partition_pass_factor`` times while rows are routed into
        tile-aligned partition runs.  ``resident_bytes`` is the
        per-grid-step working set (one partition of the oversized slab +
        every small slab + the accumulator); over-budget is ``-inf``.  The
        planner compares this against the best split-materialized
        alternative and dispatches whichever wins (``plan._decide_region``,
        rendered by ``plan.describe``)."""
        if resident_bytes > self.vmem_budget:
            return float("-inf")
        route = (
            float(rows)
            * (self.col_bytes * float(stream_cols) + self.mask_bytes)
            * self.partition_pass_factor
        )
        return (float(saved_bytes) - route) / self.hbm_bytes_per_sec

    def delta_chained(
        self,
        inter_rows: float,
        inter_cols: float,
        state_bytes: float,
        n_chunks: float,
    ) -> float:
        """Seconds saved by CHAINING a downstream region onto a pending
        Project-terminal streamed intermediate instead of spilling the
        projection and running the consumer resident.

        Chaining re-folds a carried accumulator per source chunk, and
        because the chained intermediate has no Σ row the state is sized
        for the FULL source row count; XLA's functional update rewrites
        that whole buffer every chunk, so the chained terminal pays
        ``n_chunks × state_bytes`` of state traffic where the resident
        consumer of a spilled intermediate pays it once.  Spilling pays
        the intermediate's host round-trip (write + re-read) instead.
        Below small scales the oversized per-chunk state rewrite dominates
        (~10x measured) and this goes negative → spill; a decoded
        intermediate larger than ``spill_budget`` has no resident
        alternative, so chaining is forced (``+inf``)."""
        decoded = float(inter_rows) * 4.0 * max(1.0, float(inter_cols))
        if decoded > self.spill_budget:
            return float("inf")
        spill = (
            float(inter_rows)
            * (self.col_bytes * float(inter_cols) + self.mask_bytes)
            + float(state_bytes)
        )
        merge = max(1.0, float(n_chunks)) * float(state_bytes)
        return (spill - merge) / self.hbm_bytes_per_sec

    def delta_share(self, saved_bytes: float, resident_bytes: float) -> float:
        """Seconds saved by merging fused regions from *different* plans
        into one shared-scan pass (``plan.merge_shared_scans``):
        ``saved_bytes`` is the fact-stream traffic the batch no longer
        re-reads (each merged region streams the scan once instead of once
        per query), ``resident_bytes`` the merged region's co-resident
        working set — every branch's dictionaries, gather payloads, and
        accumulator slabs now live in VMEM at the same time.  Same budget
        rule as Δ_fuse: an over-budget merge is ``-inf`` and the planner
        drops branches until the rest fit (or declines the merge)."""
        if resident_bytes > self.vmem_budget:
            return float("-inf")
        return float(saved_bytes) / self.hbm_bytes_per_sec


# ---------------------------------------------------------------------------
# out-of-core storage: per-encoding decode + H2D transfer terms (DESIGN §10)
# ---------------------------------------------------------------------------

#: chunk encodings the storage layer can choose per column (data/storage.py)
ENCODINGS = ("plain", "dict", "rle", "bitpack", "for")


@dataclass(frozen=True)
class StorageCostModel:
    """Prices the encoded-streamed vs decoded-resident decision per column.

    A *streamed* column pays host→device transfer for its **encoded** bytes
    on every pass plus an in-register decode; a *resident* column pays the
    transfer of its **decoded** bytes once and device-memory rent forever.
    Alg. 1's storage extension scores each encoding as

        h2d_seconds(encoded_bytes) + decode_seconds(kind, rows)

    and picks the cheapest representation whose working set fits the
    explicit ``memory_budget_bytes`` (``storage_plan``).  Decode rates are
    elements/second of the vectorized shift-mask (bit-packed / FOR),
    gather (dictionary), and run-expansion (RLE) loops — decode is far
    cheaper than the transfer it elides, which is why compression wins.
    """

    h2d_bytes_per_sec: float = 2.5e10  # PCIe-ish host→device bandwidth
    device_bytes_per_sec: float = 8.0e11  # post-decode on-device traffic
    decode_plain: float = float("inf")  # elems/sec (no decode work)
    decode_bitpack: float = 2.0e10  # shift + mask unpack
    decode_for: float = 1.8e10  # unpack + reference add
    decode_dict: float = 1.2e10  # unpack + values gather
    decode_rle: float = 6.0e9  # run-boundary compare + gather
    chunk_fixed_seconds: float = 2.0e-5  # per-chunk dispatch overhead

    def h2d_seconds(self, nbytes: float) -> float:
        return float(nbytes) / self.h2d_bytes_per_sec

    def decode_seconds(self, kind: str, rows: float) -> float:
        rate = getattr(self, "decode_" + ("for" if kind == "for" else kind))
        if rate == float("inf"):
            return 0.0
        return float(rows) / rate

    def encoding_seconds(self, kind: str, encoded_bytes: float, rows: float) -> float:
        """Per-pass cost of streaming a column under ``kind``: move the
        encoded bytes over the host→device link, then decode in-register."""
        return self.h2d_seconds(encoded_bytes) + self.decode_seconds(kind, rows)

    def stream_seconds(
        self, encoded_bytes: float, rows: float, kinds: Dict[str, str],
        col_bytes: Dict[str, float], n_chunks: int = 1,
    ) -> float:
        """Whole-relation per-pass streaming cost: Σ per-column encoding
        cost + per-chunk dispatch overhead."""
        total = self.chunk_fixed_seconds * max(1, int(n_chunks))
        for col, kind in kinds.items():
            total += self.encoding_seconds(kind, col_bytes.get(col, 0.0), rows)
        return total


def encoded_bytes_estimate(
    kind: str,
    rows: float,
    distinct: float,
    lo: float,
    hi: float,
    runs: float,
    is_float: bool,
    block: int = 1024,
) -> float:
    """Estimated encoded size in bytes of one column chunk under ``kind``,
    from Σ statistics alone (the exact sizes come from data/storage.py once
    a representation is materialized; this is what Alg. 1 prices *before*
    choosing).  ``inf`` marks an inapplicable encoding (bit-packing floats,
    ranges wider than 16 bits, ...) — block-aligned padding is included so
    the estimate matches the tile form the kernel actually streams."""
    rows = max(1.0, float(rows))
    n_tiles = -(-rows // block)

    def _width(span: float) -> Optional[int]:
        bits = max(1, int(max(0.0, span)).bit_length())
        for w in (1, 2, 4, 8, 16):
            if bits <= w:
                return w
        return None

    if kind == "plain":
        return 4.0 * rows
    if kind == "bitpack":
        if is_float or lo < 0:
            return float("inf")
        w = _width(hi)
        return float("inf") if w is None else n_tiles * block * w / 8.0
    if kind == "for":
        if is_float:
            return float("inf")
        w = _width(hi - lo)
        return float("inf") if w is None else n_tiles * block * w / 8.0 + 4.0
    if kind == "dict":
        w = _width(max(0.0, distinct - 1))
        if w is None:
            return float("inf")
        return 4.0 * distinct + n_tiles * block * w / 8.0
    if kind == "rle":
        # tile form pads every tile to the worst tile's run count; estimate
        # uniform spread plus one boundary-split run per tile
        per_tile = runs / n_tiles + 1.0
        return n_tiles * per_tile * 8.0
    raise ValueError(f"unknown encoding {kind!r}")


def choose_encoding(
    rows: float,
    distinct: float,
    lo: float,
    hi: float,
    runs: float,
    is_float: bool,
    model: Optional[StorageCostModel] = None,
    block: int = 1024,
) -> str:
    """Pick the cheapest encoding for one column chunk under the storage
    cost model: minimize H2D transfer + in-register decode per pass.  Plain
    wins ties — decode work is only worth paying when it elides bytes."""
    model = model or StorageCostModel()
    best, best_s = "plain", model.encoding_seconds(
        "plain", encoded_bytes_estimate("plain", rows, distinct, lo, hi, runs, is_float, block), rows
    )
    for kind in ("rle", "bitpack", "for", "dict"):
        b = encoded_bytes_estimate(kind, rows, distinct, lo, hi, runs, is_float, block)
        if b >= 4.0 * rows:  # never pay decode for zero compression
            continue
        s = model.encoding_seconds(kind, b, rows)
        if s < best_s:
            best, best_s = kind, s
    return best


@dataclass
class StorageDecision:
    """One relation's placement under ``storage_plan``."""

    rel: str
    mode: str  # "resident" | "streamed"
    decoded_bytes: float
    encoded_bytes: float
    per_pass_seconds: float
    encodings: Dict[str, str] = field(default_factory=dict)


def storage_plan(
    sigma,
    memory_budget_bytes: int,
    model: Optional[StorageCostModel] = None,
    block: int = 1024,
    chunk_rows: int = 1 << 16,
) -> Dict[str, StorageDecision]:
    """Alg. 1's storage extension: given Σ and an explicit device
    ``memory_budget_bytes``, decide per relation whether its columns live
    decoded-resident (pay decoded H2D once, rent device memory) or
    encoded-streamed (pay encoded H2D + decode per pass, rent only the
    double-buffered chunk working set).  Relations are kept resident
    cheapest-first while they fit the budget; the rest stream with
    per-column encodings chosen by ``choose_encoding``.
    """
    model = model or StorageCostModel()
    rels = []
    for rel, st in sorted(sigma.rels.items()):
        decoded = 4.0 * st.rows * max(1, len(st.columns))
        encodings, encoded = {}, 0.0
        for c, cs in sorted(st.columns.items()):
            is_float = float(cs.lo) != float(int(cs.lo)) or float(cs.hi) != float(int(cs.hi))
            runs = st.rows if st.sorted_on[:1] != (c,) else max(1.0, cs.distinct)
            kind = choose_encoding(
                st.rows, cs.distinct, cs.lo, cs.hi, runs, is_float, model, block
            )
            encodings[c] = kind
            encoded += encoded_bytes_estimate(
                kind, st.rows, cs.distinct, cs.lo, cs.hi, runs, is_float, block
            )
        rels.append((decoded, rel, st, encodings, encoded))

    out: Dict[str, StorageDecision] = {}
    spent = 0.0
    for decoded, rel, st, encodings, encoded in sorted(rels):
        n_chunks = max(1, -(-int(st.rows) // chunk_rows))
        stream_s = model.stream_seconds(
            encoded, st.rows,
            encodings, {c: encoded / max(1, len(encodings)) for c in encodings},
            n_chunks,
        )
        if spent + decoded <= memory_budget_bytes:
            spent += decoded
            out[rel] = StorageDecision(rel, "resident", decoded, encoded, 0.0, encodings)
        else:
            out[rel] = StorageDecision(
                rel, "streamed", decoded, encoded, stream_s, encodings
            )
    return out


@dataclass
class DictMeta:
    name: str
    choice: DictChoice
    card: float = 0.0  # estimated final cardinality
    elems: float = 0.0  # total inserted elements incl. duplicates (for groups)
    nested: bool = False  # values are inner dictionaries (partition/trie dict)
    build_ordered: bool = True  # every build site saw sorted keys
    lanes: float = 1.0  # value arity (bytes on the wire for exchanges)
    build_rels: set = field(default_factory=set)  # base relations feeding builds

    @property
    def group_sz(self) -> float:
        if not self.nested or self.card <= 0:
            return 1.0
        return max(1.0, self.elems / self.card)


@dataclass
class CostItem:
    site: str  # human-readable site tag
    dict: str
    ds: str
    op: str
    n: float
    size: float
    ordered: bool
    seconds: float


@dataclass
class CostResult:
    total: float = 0.0
    items: List[CostItem] = field(default_factory=list)
    scalar_seconds: float = 0.0
    dict_meta: Dict[str, DictMeta] = field(default_factory=dict)

    def add(self, item: CostItem) -> None:
        self.items.append(item)
        self.total += item.seconds

    def add_scalar(self, seconds: float) -> None:
        self.scalar_seconds += seconds
        self.total += seconds

    def by_dict(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for it in self.items:
            out[it.dict] = out.get(it.dict, 0.0) + it.seconds
        return out

    def explain(self) -> str:
        lines = [f"total {self.total*1e3:.3f} ms (scalar {self.scalar_seconds*1e3:.3f} ms)"]
        for it in self.items:
            lines.append(
                f"  {it.site:<28} {it.dict:<8} {it.ds:<14} {it.op:<12}"
                f" n={it.n:<12.0f} size={it.size:<12.0f}"
                f" ordered={int(it.ordered)} -> {it.seconds*1e3:.3f} ms"
            )
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Environment entries for the static walk
# ---------------------------------------------------------------------------


@dataclass
class RowOf:
    rel: str  # loop variable ranges over rows of this input relation


@dataclass
class InnerRowOf:
    meta: Optional[DictMeta]  # rows of an inner (group) dictionary; None=input trie
    rel: Optional[str] = None  # for input tries: the trie's stats name


@dataclass
class DictRowOf:
    meta: DictMeta  # iterating a result dictionary's key/value pairs


@dataclass
class IterOf:
    meta: DictMeta


@dataclass
class RefVal:
    pass


@dataclass
class ScalarVal:
    pass


EnvEntry = Union[RowOf, InnerRowOf, DictRowOf, IterOf, RefVal, ScalarVal, DictMeta]

SCALAR_NS = 1.4  # per scalar op (arith/field/record), calibrated vs interp
ITER_NS = 2.0  # per-element loop overhead


# ---------------------------------------------------------------------------
# The inference engine
# ---------------------------------------------------------------------------


class _Infer:
    def __init__(
        self,
        sigma: CardModel,
        delta: DictCostModel,
        gamma_dict: GammaDict,
        vectorized: bool = VECTORIZED_DEFAULT,
        ordered_off: bool = False,
    ):
        self.sigma = sigma
        self.delta = delta
        self.gamma_dict = dict(gamma_dict)
        self.vectorized = vectorized
        # the sharded executor runs with allow_sorted=False (per-shard
        # slices lose the global sort the hinted kernels assume), so the
        # distributed pricing must not credit ordered fast paths — else
        # Alg. 1 picks hinted sort builds the executor then re-sorts
        self.ordered_off = ordered_off
        self.res = CostResult()
        # probe provenance per lookup site: (dict, rows, kind, payload,
        # whole_key) — kind "rel" carries the base relation the probe stream
        # iterates, kind "dict" the DictMeta of a scanned result dictionary.
        # The distributed pricing uses this to charge probe repartitioning
        # only where plan.legalize would actually move rows.
        self.probe_log: List[Tuple[str, float, str, Any, bool]] = []

    # -- scalar expression op counting ------------------------------------
    def _scalar_ops(self, e: L.Expr) -> float:
        n = 0.0
        for node in L.walk(e):
            if isinstance(node, (L.BinOp, L.UnOp, L.FieldAccess)):
                n += 1.0
            elif isinstance(node, L.RecordCtor):
                n += len(node.fields)
        return n

    def _charge_scalar(self, e: L.Expr, calls: float) -> None:
        self.res.add_scalar(self._scalar_ops(e) * calls * SCALAR_NS * 1e-9)

    # -- source cardinality for For loops ----------------------------------
    def _loop_info(
        self, src: L.Expr, env: Dict[str, EnvEntry], calls: float
    ) -> Tuple[float, EnvEntry, Optional[str]]:
        """Returns (iterations per invocation, env entry for loop var, rel)."""
        if isinstance(src, L.Input):
            st = self.sigma.rel(src.name)
            return st.rows, RowOf(src.name), src.name
        if isinstance(src, L.Var):
            ent = env.get(src.name)
            if isinstance(ent, DictMeta):
                return ent.card, DictRowOf(ent), None
        if isinstance(src, (L.DictLookup, L.HintedLookup)):
            # probe cost charged by the lookup rule; iterate inner group
            meta = self._dict_of(src.dict, env)
            self._lookup_cost(src, env, calls, site="probe-loop")
            if meta is not None:
                return meta.group_sz, InnerRowOf(meta), None
            # lookup into an *input* dictionary (index-nested-loop join)
            rel = src.dict.name if isinstance(src.dict, L.Input) else "?"
            st = self.sigma.rel(rel)
            grp = st.rows / max(1.0, self.sigma.dist(rel, ("*",)))
            return max(1.0, grp), InnerRowOf(None, rel), None
        if isinstance(src, L.FieldAccess) and src.name == "val":
            base = src.rec
            if isinstance(base, L.Var):
                ent = env.get(base.name)
                if isinstance(ent, RowOf):
                    st = self.sigma.rel(ent.rel)
                    return max(1.0, getattr(st, "inner_rows", 1.0)), InnerRowOf(
                        None, ent.rel
                    ), ent.rel
                if isinstance(ent, DictRowOf):
                    return ent.meta.group_sz, InnerRowOf(ent.meta), None
        raise NotImplementedError(f"cannot infer loop source {src}")

    def _dict_of(self, e: L.Expr, env: Dict[str, EnvEntry]) -> Optional[DictMeta]:
        if isinstance(e, L.Var):
            ent = env.get(e.name)
            if isinstance(ent, DictMeta):
                return ent
        return None

    # -- probe-side distinct & orderedness ---------------------------------
    def _probe_stats(
        self, keyexpr: L.Expr, env: Dict[str, EnvEntry]
    ) -> Tuple[float, bool]:
        """(distinct probe keys, probe sequence sorted?) for a key expression
        evaluated inside the current innermost relation loop."""
        for node in L.walk(keyexpr):
            if isinstance(node, L.Var) and isinstance(env.get(node.name), RowOf):
                rel = env[node.name].rel  # type: ignore[union-attr]
                cols = key_columns(keyexpr, node.name)
                dist = self.sigma.dist(rel, cols)
                ordered = self.sigma.is_sorted_on(rel, cols)
                return dist, ordered
            if isinstance(node, L.Var) and isinstance(env.get(node.name), DictRowOf):
                meta = env[node.name].meta  # type: ignore[union-attr]
                # iterating a dictionary yields sorted keys for @st families
                return meta.card, meta.choice.ds.startswith("st")
        return 1.0, False

    # -- Fig. 8 lookup rule -------------------------------------------------
    def _lookup_cost(
        self,
        e: Union[L.DictLookup, L.HintedLookup],
        env: Dict[str, EnvEntry],
        calls: float,
        site: str,
        cond: float = 1.0,
    ) -> None:
        meta = self._dict_of(e.dict, env)
        self._charge_scalar(e.keyexpr, calls)
        if meta is None:
            return  # input index: charged as memory traffic by the lowering
        # vectorized engines run every physical row through the op; masked
        # rows count as misses.  Paper mode uses the semantic count.
        C = calls if self.vectorized else calls * cond
        N = max(1.0, meta.card)
        for node in L.walk(e.keyexpr):
            if isinstance(node, L.Var):
                ent = env.get(node.name)
                if isinstance(ent, RowOf):
                    self.probe_log.append((meta.name, C, "rel", ent.rel, False))
                    break
                if isinstance(ent, DictRowOf):
                    whole = key_columns(e.keyexpr, node.name) == ("*",)
                    self.probe_log.append(
                        (meta.name, C, "dict", ent.meta, whole)
                    )
                    break
        dist, probe_sorted = self._probe_stats(e.keyexpr, env)
        sigma_hit = min(1.0, N / max(1.0, dist)) * (cond if self.vectorized else 1.0)
        H = sigma_hit * C
        M = C - H
        hinted = isinstance(e, L.HintedLookup) or meta.choice.hinted
        ordered = probe_sorted and (hinted or meta.choice.ds.startswith("ht"))
        ordered = ordered and not self.ordered_off
        ds = meta.choice.ds
        for op, n in (("lookup_hit", H), ("lookup_miss", M)):
            if n <= 0:
                continue
            sec = self.delta.op_cost(ds, op, n, N, ordered)
            self.res.add(CostItem(site, meta.name, ds, op, n, N, ordered, sec))

    # -- Fig. 8 update rule --------------------------------------------------
    def _update_cost(
        self,
        e: Union[L.DictUpdate, L.HintedUpdate],
        env: Dict[str, EnvEntry],
        calls: float,
        site: str,
        cond: float = 1.0,
    ) -> None:
        meta = self._dict_of(e.dict, env)
        self._charge_scalar(e.keyexpr, calls)
        self._charge_scalar(e.value, calls)
        if meta is None:
            raise NotImplementedError("update of non-let-bound dictionary")
        C = calls if self.vectorized else calls * cond
        C_sem = calls * cond  # semantic rows that actually insert/aggregate
        dist, probe_sorted = self._probe_stats(e.keyexpr, env)
        new = max(0.0, min(dist, C_sem) - meta.card)  # containment
        H = C - new
        N = meta.card + new
        hinted = isinstance(e, L.HintedUpdate) or meta.choice.hinted
        ordered = probe_sorted and (hinted or meta.choice.ds.startswith("ht"))
        ordered = ordered and not self.ordered_off
        # NOTE: a masked vectorized build KEEPS the sorted-input fast path —
        # masked rows become PAD holes and dicts.base.dedupe_sorted merges
        # across them — so ``ordered`` is not downgraded under a mask.
        ds = meta.choice.ds
        if self.vectorized:
            # a vectorized build is ONE batched insert of every physical row
            # (hash: probe rounds over the batch; sort: argsort + segment
            # dedupe) — the paper's find-then-emplace decomposition describes
            # per-row CPU execution, not batch execution.  The profiler
            # measures exactly this op shape (n rows collapsing into N keys).
            sec = self.delta.op_cost(ds, "insert", C, max(1.0, N), ordered)
            self.res.add(
                CostItem(site, meta.name, ds, "insert", C, max(1.0, N), ordered, sec)
            )
        else:
            for op, n in (("lookup_hit", H), ("lookup_miss", new), ("insert", new)):
                if n <= 0:
                    continue
                sec = self.delta.op_cost(ds, op, n, max(1.0, N), ordered)
                self.res.add(
                    CostItem(site, meta.name, ds, op, n, max(1.0, N), ordered, sec)
                )
        meta.card = N
        meta.elems += C
        # provenance: every enclosing loop's base relations feed this build —
        # including *transitively* through derived dictionaries (a dict built
        # while iterating another dict inherits its build relations), so the
        # distributed pricing sees that e.g. Q5's OD descends from orders
        for ent in env.values():
            if isinstance(ent, RowOf):
                meta.build_rels.add(ent.rel)
            elif isinstance(ent, DictRowOf):
                meta.build_rels |= ent.meta.build_rels
            elif isinstance(ent, InnerRowOf):
                if ent.meta is not None:
                    meta.build_rels |= ent.meta.build_rels
                elif ent.rel:
                    meta.build_rels.add(ent.rel)
        for node in L.walk(e.value):
            if isinstance(node, L.RecordCtor):
                meta.lanes = max(meta.lanes, float(len(node.fields)))
                break
        if isinstance(e.value, L.DictNew) and e.value.key is not None:
            meta.nested = True
        if not ordered and not meta.choice.ds.startswith("ht"):
            meta.build_ordered = False
        if not probe_sorted:
            meta.build_ordered = False

    # -- main walk -----------------------------------------------------------
    def infer(self, e: L.Expr, env: Dict[str, EnvEntry], calls: float, site: str, cond: float = 1.0) -> None:
        if isinstance(e, (L.Const, L.Param, L.Var, L.Input, L.Noop)):
            return
        if isinstance(e, L.Seq):
            self.infer(e.first, env, calls, site)
            self.infer(e.second, env, calls, site)
            return
        if isinstance(e, L.Let):
            v = e.value
            env2 = dict(env)
            if isinstance(v, L.DictNew):
                choice = self.gamma_dict.get(e.name) or (
                    DictChoice(v.ds) if v.ds else DictChoice()
                )
                meta = DictMeta(e.name, choice)
                self.res.dict_meta[e.name] = meta
                env2[e.name] = meta
            elif isinstance(v, L.RefNew):
                env2[e.name] = RefVal()
            elif isinstance(v, L.DictIter):
                m = self._dict_of(v.dict, env)
                env2[e.name] = IterOf(m) if m else ScalarVal()
            elif isinstance(v, (L.DictLookup, L.HintedLookup)):
                self._lookup_cost(v, env, calls, site=f"let {e.name}")
                env2[e.name] = ScalarVal()
            else:
                self.infer(v, env, calls, site)
                env2[e.name] = ScalarVal()
            self.infer(e.body, env2, calls, site)
            return
        if isinstance(e, L.If):
            # find the relation the condition ranges over for Σ_sel
            sel = 0.5
            for node in L.walk(e.cond):
                if isinstance(node, L.Var) and isinstance(env.get(node.name), RowOf):
                    sel = self.sigma.sel(e.cond, node.name, env[node.name].rel)  # type: ignore[union-attr]
                    break
            # contains-style guard: If(lookup != none) -> hit-rate selectivity
            lk = _find_lookup(e.cond)
            if lk is not None:
                meta = self._dict_of(lk.dict, env)
                if meta is not None:
                    self._lookup_cost(lk, env, calls, site=f"{site}/guard", cond=cond)
                    dist, _ = self._probe_stats(lk.keyexpr, env)
                    sel = min(1.0, max(1.0, meta.card) / max(1.0, dist))
            else:
                self._charge_scalar(e.cond, calls)
            if self.vectorized:
                # masked rows still flow through the ops; selectivity rides
                # in ``cond`` (affects hit rates and dictionary sizes only)
                self.infer(e.then, env, calls, site, cond=cond * sel)
                self.infer(e.els, env, calls, site, cond=cond * (1.0 - sel))
            else:
                self.infer(e.then, env, calls * sel, site, cond=cond)
                self.infer(e.els, env, calls * (1.0 - sel), site, cond=cond)
            return
        if isinstance(e, L.For):
            n, entry, _rel = self._loop_info(e.source, env, calls)
            env2 = dict(env)
            env2[e.var] = entry
            self.res.add_scalar(calls * n * ITER_NS * 1e-9)
            self.infer(e.body, env2, calls * n, site=f"{site}/for:{e.var}", cond=cond)
            return
        if isinstance(e, (L.DictUpdate, L.HintedUpdate)):
            if isinstance(e.value, (L.DictLookup, L.HintedLookup)):
                self._lookup_cost(e.value, env, calls, site=f"{site}/val", cond=cond)
            else:
                for sub in L.walk(e.value):
                    if isinstance(sub, (L.DictLookup, L.HintedLookup)):
                        self._lookup_cost(sub, env, calls, site=f"{site}/val", cond=cond)
            self._update_cost(e, env, calls, site=f"{site}/update", cond=cond)
            return
        if isinstance(e, (L.DictLookup, L.HintedLookup)):
            self._lookup_cost(e, env, calls, site=site, cond=cond)
            return
        if isinstance(e, L.RefAdd):
            for sub in L.walk(e.value):
                if isinstance(sub, (L.DictLookup, L.HintedLookup)):
                    self._lookup_cost(sub, env, calls, site=f"{site}/refadd")
            self._charge_scalar(e.value, calls)
            return
        if isinstance(e, (L.RecordCtor, L.BinOp, L.UnOp, L.FieldAccess)):
            self._charge_scalar(e, calls)
            return
        if isinstance(e, (L.DictNew, L.RefNew, L.DictIter)):
            return
        raise TypeError(f"cost inference: unknown node {type(e)}")  # pragma: no cover


def _find_lookup(e: L.Expr) -> Optional[Union[L.DictLookup, L.HintedLookup]]:
    for node in L.walk(e):
        if isinstance(node, (L.DictLookup, L.HintedLookup)):
            return node
    return None


def infer_cost(
    expr: L.Expr,
    sigma: CardModel,
    delta: DictCostModel,
    gamma_dict: Optional[GammaDict] = None,
    vectorized: bool = VECTORIZED_DEFAULT,
    net: Optional[NetCostModel] = None,
    sharded_rels: Optional[Tuple[str, ...]] = None,
) -> CostResult:
    """Run the Fig. 8 inference over a whole program.

    ``gamma_dict`` maps dictionary symbols to their (implementation, hinted)
    choice; unmentioned symbols fall back to their ``@ds`` annotation, then to
    ``DEFAULT_DS``.  ``vectorized=False`` recovers the paper's exact per-row
    rules (CPU engine semantics).

    ``net`` prices the *distributed* realization of the program, mirroring
    what ``plan.legalize`` will emit for each dictionary built from a sharded
    base relation (all relations when ``sharded_rels`` is None):

    * aggregate dictionaries (GroupBy/GroupJoin results) pay the per-shard
      partial + shuffle-Exchange: wire traffic (Δ_net) plus the merge
      re-build (Δ insert of the routed partial entries);
    * join indexes (nested/partition dictionaries) pay their *placement* —
      ``broadcast`` all-gathers the build rows (the replicated per-shard
      build is already in the base cost), ``partition`` hash-repartitions
      build and probe rows but builds only 1/n_shards of the dictionary per
      shard, which is credited against the base (full) build charge.  The
      placement comes from ``DictChoice.placement`` so Alg. 1 decides it
      jointly with the implementation.
    """
    eng = _Infer(
        sigma,
        delta,
        gamma_dict or {},
        vectorized=vectorized,
        ordered_off=net is not None and net.n_shards > 1,
    )
    eng.infer(expr, {}, calls=1.0, site="root")
    if net is not None and net.n_shards > 1:
        # probe rows that the co-partitioned realization actually *moves*,
        # mirroring plan.legalize's elisions: a base-relation stream moves
        # iff that relation is sharded; a dict-scan stream probing by the
        # scanned dictionary's whole key is already co-partitioned (or
        # replicated and mask-partitioned) and never moves, otherwise it
        # moves iff the scanned dictionary descends from sharded rows.
        probes: Dict[str, float] = {}
        for dname, n, kind, payload, whole in eng.probe_log:
            if kind == "rel":
                moves = sharded_rels is None or payload in sharded_rels
            else:
                moves = not whole and (
                    sharded_rels is None
                    or bool(payload.build_rels & set(sharded_rels))
                )
            if moves:
                probes[dname] = probes.get(dname, 0.0) + n
        for meta in eng.res.dict_meta.values():
            if sharded_rels is not None and not (
                meta.build_rels & set(sharded_rels)
            ):
                continue
            ds = meta.choice.ds
            size = max(1.0, meta.card)
            if meta.nested:
                placement = meta.choice.placement or "partition"
                if placement == "broadcast":
                    sec = net.broadcast_seconds(meta.elems, meta.lanes)
                else:
                    # move every build and probe row once; the per-shard
                    # build then inserts only 1/n of the rows, credited
                    # against the full build the base walk already charged
                    sec = net.repartition_seconds(meta.elems, meta.lanes)
                    sec += net.repartition_seconds(
                        probes.get(meta.name, 0.0), meta.lanes
                    )
                    full = delta.op_cost(ds, "insert", meta.elems, size, False)
                    sec -= (1.0 - 1.0 / net.n_shards) * full
                eng.res.add(
                    CostItem(
                        "placement", meta.name, ds, placement,
                        meta.elems, size, False, sec,
                    )
                )
                continue
            # each shard holds at most its own elements and at most the full
            # key set; the shuffle moves every per-shard partial entry
            entries = min(meta.elems, meta.card * net.n_shards)
            if entries <= 0:
                continue
            sec = net.shuffle_seconds(entries, meta.lanes)
            sec += delta.op_cost(ds, "insert", entries, size, False)
            eng.res.add(
                CostItem(
                    "exchange", meta.name, ds, "exchange",
                    entries, size, False, sec,
                )
            )
    return eng.res
