"""The port's entry point against ``repro.connect``, its device policy, and
its independence from JAX and the reference package."""
import ast
import pathlib

import numpy as np
import pytest
import torch

import repro
from repro.data import tpch as rtpch

import repro_torch
from repro_torch.data import tpch as ttpch
from repro_torch.data.interop import from_reference
from repro_torch.data.table import from_numpy
from repro_torch.exec.queries import REGISTRY

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def sessions():
    rdb = rtpch.generate(scale=0.002, seed=7).tables()
    return repro.connect(rdb), repro_torch.connect(from_reference(rdb, device="cpu"), device="cpu")


@pytest.mark.parametrize("qname", sorted(REGISTRY))
def test_session_query_matches_reference(qname, sessions):
    rs, ts = sessions
    want = rs.query(qname)
    got = ts.query(qname)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=3e-3, atol=3e-2)
    assert ts.explain(qname)["choices"] == rs.explain(qname)["choices"]
    assert ts.report().modes().keys() == rs.report().modes().keys()


def test_generator_bytes_match_reference():
    rdb = rtpch.generate(scale=0.002, seed=11).tables()
    tdb = ttpch.generate(scale=0.002, seed=11, device="cpu").tables()
    for rel, t in rdb.items():
        assert tdb[rel].sorted_on == t.sorted_on
        for c, a in t.columns.items():
            np.testing.assert_array_equal(tdb[rel].col(c).numpy(), np.asarray(a))


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    db = ttpch.generate(scale=0.002, seed=1, device="cpu").tables()
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.connect(db)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttpch.generate(scale=0.002, seed=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        from_numpy({"a": np.arange(3)})


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {mod}"
