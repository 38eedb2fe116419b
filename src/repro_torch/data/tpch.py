"""Synthetic TPC-H-shaped data generator (the numpy generator of
``repro.data.tpch``, copied verbatim: one seed gives the same bytes in both
packages; the tables land on ``device``, the card unless another is named).

Generates the five relations used by the paper's evaluation queries
(Q1, Q3, Q5, Q9, Q18) with TPC-H-faithful structure at configurable scale:
key/foreign-key joins, compound lineitem keys ordered on (orderkey), and
value distributions that make selectivities meaningful.  All integers are
kept dense so compound keys pack exactly (``data.table.pack_keys``).

This is a *generator*, not the official dbgen: the paper's claims we test
(dictionary-choice crossovers, mixed-implementation wins) depend on the
relational shape and cardinality ratios, which we preserve: ~4:1
lineitem:orders, 10:1 orders:customer, parts/suppliers scaled alongside.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from .table import Table, from_numpy, resolve_device


@dataclass
class TPCH:
    lineitem: Table
    orders: Table
    customer: Table
    part: Table
    supplier: Table
    nation: Table

    def tables(self) -> Dict[str, Table]:
        return {
            "lineitem": self.lineitem,
            "orders": self.orders,
            "customer": self.customer,
            "part": self.part,
            "supplier": self.supplier,
            "nation": self.nation,
        }


def generate(scale: float = 0.01, seed: int = 0, device=None) -> TPCH:
    """scale=1.0 ≈ 6M lineitems (TPC-H SF1); default 0.01 → 60k (CI-sized)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_li = int(6_000_000 * scale)
    n_ord = int(1_500_000 * scale)
    n_cust = int(150_000 * scale)
    n_part = max(int(200_000 * scale), 64)
    n_supp = max(int(10_000 * scale), 16)
    n_nation = 25

    # --- orders: O_ORDERKEY dense [0, n_ord); dates uniform in [0,1)
    o_custkey = rng.integers(0, n_cust, n_ord).astype(np.int32)
    o_orderdate = rng.random(n_ord).astype(np.float32)
    orders = from_numpy(
        {
            "orderkey": np.arange(n_ord, dtype=np.int32),
            "custkey": o_custkey,
            "orderdate": o_orderdate,
            "shippriority": rng.integers(0, 5, n_ord).astype(np.int32),
            "totalprice": (rng.random(n_ord) * 1e4).astype(np.float32),
        },
        sorted_on=("orderkey",),
        device=device,
    )

    # --- lineitem: ~4 rows per order, physically ordered by orderkey
    li_order = np.sort(rng.integers(0, n_ord, n_li)).astype(np.int32)
    lineitem = from_numpy(
        {
            "orderkey": li_order,
            "partkey": rng.integers(0, n_part, n_li).astype(np.int32),
            "suppkey": rng.integers(0, n_supp, n_li).astype(np.int32),
            "quantity": rng.integers(1, 51, n_li).astype(np.float32),
            "extendedprice": (rng.random(n_li) * 1e3 + 1).astype(np.float32),
            "discount": (rng.random(n_li) * 0.1).astype(np.float32),
            "tax": (rng.random(n_li) * 0.08).astype(np.float32),
            "returnflag": rng.integers(0, 3, n_li).astype(np.int32),
            "linestatus": rng.integers(0, 2, n_li).astype(np.int32),
            "shipdate": rng.random(n_li).astype(np.float32),
        },
        sorted_on=("orderkey",),
        device=device,
    )

    customer = from_numpy(
        {
            "custkey": np.arange(n_cust, dtype=np.int32),
            "nationkey": rng.integers(0, n_nation, n_cust).astype(np.int32),
            "mktsegment": rng.integers(0, 5, n_cust).astype(np.int32),
            "acctbal": (rng.random(n_cust) * 1e4).astype(np.float32),
        },
        sorted_on=("custkey",),
        device=device,
    )

    part = from_numpy(
        {
            "partkey": np.arange(n_part, dtype=np.int32),
            "brand": rng.integers(0, 25, n_part).astype(np.int32),
            "color": rng.integers(0, 92, n_part).astype(np.int32),  # p_name LIKE
            "retailprice": (rng.random(n_part) * 2e3).astype(np.float32),
        },
        sorted_on=("partkey",),
        device=device,
    )

    supplier = from_numpy(
        {
            "suppkey": np.arange(n_supp, dtype=np.int32),
            "nationkey": rng.integers(0, n_nation, n_supp).astype(np.int32),
        },
        sorted_on=("suppkey",),
        device=device,
    )

    nation = from_numpy(
        {
            "nationkey": np.arange(n_nation, dtype=np.int32),
            "regionkey": (np.arange(n_nation, dtype=np.int32) % 5),
        },
        sorted_on=("nationkey",),
        device=device,
    )

    return TPCH(lineitem, orders, customer, part, supplier, nation)


def generate_chunked(
    scale: float = 0.22,
    seed: int = 0,
    memory_budget_bytes: int = 16 << 20,
    chunk_rows: int = 1 << 16,
    device=None,
) -> Dict[str, object]:
    """Generate at ``scale`` (whole, on ``device``) and apply the
    out-of-core storage plan: relations the ``memory_budget_bytes`` cannot
    hold decoded become host-resident compressed ``ChunkedTable``s that the
    engine streams chunk by chunk; the rest stay resident."""
    from .storage import chunk_db

    return chunk_db(
        generate(scale, seed, device=device).tables(),
        memory_budget_bytes=memory_budget_bytes,
        chunk_rows=chunk_rows,
    )
