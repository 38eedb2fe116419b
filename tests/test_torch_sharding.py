"""The port's LM sharding (``repro_torch.sharding``, ``moe_apply_sharded``,
``compressed_psum``, ``restore(shardings=)``) against the reference's, on
the CPU.

* the spec tables: for every config at its published widths, every leaf
  of the parameters, the optimizer state (moments and error-feedback
  carry), the batch and the decode cache gets the reference's spec, its
  stacked layer axis dropped and a transposed projection's dims swapped, on
  ``AbstractMesh`` (16, 16) ``("data", "model")`` and (2, 16, 16) ``("pod",
  "data", "model")``, under the TP layout and under ``layout_overrides``
  with a global batch that divides the mesh and one that does not (no
  device is needed: the reference resolves specs on an abstract mesh);
* the rest runs the reference over 8 host devices, once, in a subprocess
  (``XLA_FLAGS``, as ``tests/test_torch_distributed.py`` does) that pickles
  its results; this process sees one device and runs the port on the CPU,
  every shard on the host:

  - ``shard`` blocks equal ``jax.device_put``'s ``addressable_shards`` bit
    for bit, and ``unshard`` gives the array back;
  - ``ring_allgather_matmul`` against the reference's at rtol 1e-5 (its
    test's tolerance) on 8 shards;
  - ``compressed_psum`` on 4 shards: equal int8 codes, sums within float
    order, equal carries;
  - ``moe_apply_sharded`` (reduced scout's top-1 with the shared expert,
    reduced jamba's top-2) on meshes (2, 4), (4,) ``"model"`` and (2, 2),
    with drops, and its three fallbacks, at ``tests/test_torch_moe.py``'s
    tolerances;
  - under ``use_mesh`` (2, 4): reduced scout's ``forward`` and
    ``decode_step``, reduced jamba's ``forward`` (float32);
  - ``restore(shardings=param_shardings(...))`` of reduced llama's
    checkpoint on (2, 2): each block equals the reference's bit for bit.
"""
import functools
import os
import pickle
import re
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import configs as rconfigs
from repro.costmodel import moe_profile as rprofile
from repro.models.registry import get_model as r_get_model
from repro.sharding import params as rparams
from repro.sharding import partition as rpartition
from repro.train import optimizer as ropt

from repro_torch import configs as tconfigs
from repro_torch.costmodel import store as tstore
from repro_torch.exec import distributed as D
from repro_torch.models import common as tcommon
from repro_torch.models import jamba as tjamba
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.models.config import SHAPES
from repro_torch.models.interop import _TRANSPOSED, params_from_reference
from repro_torch.models.registry import get_model
from repro_torch.sharding import overlap as toverlap
from repro_torch.sharding import params as tparams
from repro_torch.sharding import partition as tpartition
from repro_torch.train import checkpoint as tck
from repro_torch.train import optimizer as topt

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CPU = torch.device("cpu")
F32_TOL = 1e-4  # tests/test_torch_lm.py: float32 through both packages
MOE_RTOL, MOE_ATOL = 2e-4, 2e-5  # tests/test_torch_moe.py (tests/test_models_smoke.py:110)
RING_RTOL, RING_ATOL = 1e-5, 1e-6  # tests/test_distributed.py's ring test's rtol; the atol for entries near zero
SEED = 0

# the production meshes of the spec tables
ABSTRACT_MESHES = {"16x16": ((16, 16), ("data", "model")), "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
# global batches for layout_overrides: 512 divides both meshes, 8 neither
LAYOUT_BATCHES = (512, 8)
_STACKED = re.compile(r"(^|/)(layers|periods|enc_layers|dec_layers)/\d+(/|$)")

# placement cases: (mesh shape, axis names, specs of an [8, 16] array)
BLOCK_CASES = {
    "2x4": ((2, 4), ("data", "model"), [("data", "model"), (("data", "model"), None), (None, "model"), (),
                                        ("model", "data"), (None, ("model", "data"))]),
    "2x2x2": ((2, 2, 2), ("pod", "data", "model"), [(("pod", "data"), "model"), ("model", ("pod", "data")),
                                                     (("pod", "data", "model"),), ("data",)]),
}
# moe_apply_sharded cases: (mesh shape, axis names, experts, top-k, shared expert, capacity factor, batch,
# dispatch); the last three take the dense fallback (no "model" axis; 4 experts over 8 model shards; a
# batch of 3 over 2 data shards)
MOE_CASES = {
    "scout_2x4": ((2, 4), ("data", "model"), 4, 1, True, 1.25, 4, "scatter"),
    "scout_2x4_drops": ((2, 4), ("data", "model"), 4, 1, True, 0.5, 4, "sort"),
    "scout_model4": ((4,), ("model",), 4, 1, True, 1.25, 4, "auto"),
    "scout_2x2": ((2, 2), ("data", "model"), 4, 1, True, 1.25, 4, "scatter"),
    "jamba_2x4": ((2, 4), ("data", "model"), 4, 2, False, 1.25, 4, "sort"),
    "jamba_model4": ((4,), ("model",), 4, 2, False, 1.25, 2, "scatter"),
    "jamba_2x2_drops": ((2, 2), ("data", "model"), 4, 2, False, 0.5, 4, "auto"),
    "fallback_no_model": ((4,), ("data",), 4, 1, True, 1.25, 4, "scatter"),
    "fallback_experts": ((8,), ("model",), 4, 2, False, 1.25, 4, "sort"),
    "fallback_batch": ((2, 4), ("data", "model"), 4, 2, True, 1.25, 3, "auto"),
}
MOE_T, MOE_D, MOE_F = 16, 64, 128
SCOUT, JAMBA, LLAMA = "llama4-scout-17b-a16e", "jamba-1.5-large-398b", "llama3.2-3b"
MODEL_B, MODEL_T, DECODE_STEPS = 4, 16, 4

REFERENCE_JOB = """
import functools, pickle, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import compat, configs
from repro.costmodel import moe_profile
from repro.models import jamba, lm, moe
from repro.sharding import overlap, params as sparams
from repro.sharding.partition import use_mesh
from repro.train import checkpoint, optimizer

out_path, store, ckpt = sys.argv[1:4]
# an empty dispatch store: "auto" takes the analytic crossover
moe_profile.load_dispatch_model = functools.partial(moe_profile.load_dispatch_model, store)
npt = lambda tree: jax.tree.map(np.asarray, tree)
out = {}


def blocks(arr, mesh):
    by_dev = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    return [by_dev[d] for d in mesh.devices.flat]


rng = np.random.default_rng(%(seed)d)
A = rng.normal(size=(8, 16)).astype(np.float32)
out["A"] = A
for name, (shape, axes, specs) in %(block_cases)r.items():
    mesh = compat.make_mesh(shape, axes)
    for spec in specs:
        out[("blocks", name, spec)] = blocks(jax.device_put(jnp.asarray(A), NamedSharding(mesh, P(*spec))), mesh)

# -- the ring on 8 shards (tests/test_distributed.py's shapes)
mesh = compat.make_mesh((8,), ("tp",))
X = rng.normal(size=(64, 32)).astype(np.float32)
W = rng.normal(size=(32, 16)).astype(np.float32)
Xs = jax.device_put(jnp.asarray(X), NamedSharding(mesh, P("tp", None)))
run = lambda fn: np.asarray(compat.shard_map(functools.partial(fn, axis="tp"), mesh=mesh,
                                             in_specs=(P("tp", None), P(None, None)), out_specs=P(None, None))(Xs, W))
out["ring"] = (X, W, run(overlap.ring_allgather_matmul), run(overlap.allgather_matmul_reference))

# -- compressed_psum on 4 shards
mesh = compat.make_mesh((4,), ("data",))
G = {"w": rng.normal(size=(4 * 3, 5)).astype(np.float32), "b": rng.normal(size=(4 * 7,)).astype(np.float32)}
EF = {k: (0.01 * rng.normal(size=v.shape)).astype(np.float32) for k, v in G.items()}
spec = {"w": P("data", None), "b": P("data")}
put = lambda t: {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, spec[k])) for k, v in t.items()}
summed, new_ef = compat.shard_map(lambda g, e: optimizer.compressed_psum(g, e, "data"), mesh=mesh,
                                  in_specs=(spec, spec), out_specs=(spec, spec))(put(G), put(EF))
out["psum"] = (G, EF, {k: blocks(v, mesh) for k, v in summed.items()}, {k: blocks(v, mesh) for k, v in new_ef.items()})

# -- moe_apply_sharded
for i, (name, (shape, axes, E, k, shared, cf, B, dispatch)) in enumerate(%(moe_cases)r.items()):
    mesh = compat.make_mesh(shape, axes)
    p = moe.moe_init(jax.random.PRNGKey(i), %(d)d, %(f)d, E, shared)
    x = rng.normal(size=(B, %(t)d, %(d)d)).astype(np.float32)
    o, aux = jax.jit(functools.partial(moe.moe_apply_sharded, mesh=mesh, n_experts=E, top_k=k, capacity_factor=cf,
                                       dispatch=dispatch))(p, jnp.asarray(x))
    out[("moe", name)] = (npt(p), x, np.asarray(o), {a: float(v) for a, v in aux.items()})

# -- the models under use_mesh on (2, 4)
mesh = compat.make_mesh((2, 4), ("data", "model"))
scfg = configs.get(%(scout)r).reduce()
sp = jax.jit(functools.partial(lm.init, scfg))(jax.random.PRNGKey(1))
toks = rng.integers(0, scfg.vocab, (%(mb)d, %(mt)d)).astype(np.int32)
with use_mesh(mesh):  # traced under the mesh: the MoE layers take the region
    logits, aux = jax.jit(functools.partial(lm.forward, scfg))(sp, jnp.asarray(toks))
    cache = lm.init_cache(scfg, %(mb)d, %(mt)d, fill_len=0)
    step = jax.jit(functools.partial(lm.decode_step, scfg))
    steps = []
    for t in range(%(steps)d):
        lg, cache = step(sp, cache, jnp.asarray(toks[:, t]))
        steps.append(np.asarray(lg))
out["scout"] = (npt(sp), toks, np.asarray(logits), np.asarray(aux), steps)
jcfg = configs.get(%(jamba)r).reduce()
jp = jax.jit(functools.partial(jamba.init, jcfg))(jax.random.PRNGKey(2))
jtoks = rng.integers(0, jcfg.vocab, (%(mb)d, %(mt)d)).astype(np.int32)
with use_mesh(mesh):
    jl, _ = jax.jit(functools.partial(jamba.forward, jcfg))(jp, jnp.asarray(jtoks))
out["jamba"] = (npt(jp), jtoks, np.asarray(jl))

# -- restore(shardings=) of reduced llama on (2, 2)
mesh = compat.make_mesh((2, 2), ("data", "model"))
lcfg = configs.get(%(llama)r).reduce()
lp = lm.init(lcfg, jax.random.PRNGKey(3))
checkpoint.save(ckpt, 1, {"params": lp})
restored, _ = checkpoint.restore(ckpt, {"params": lp}, shardings={"params": sparams.param_shardings(mesh, lp)})
flat = jax.tree_util.tree_flatten_with_path(restored["params"])[0]
out["restore"] = (npt(lp), {sparams._path_str(path): blocks(leaf, mesh) for path, leaf in flat})

with open(out_path, "wb") as f:
    pickle.dump(out, f)
""" % dict(seed=SEED, block_cases=BLOCK_CASES, moe_cases=MOE_CASES, d=MOE_D, f=MOE_F, t=MOE_T, scout=SCOUT,
           jamba=JAMBA, llama=LLAMA, mb=MODEL_B, mt=MODEL_T, steps=DECODE_STEPS)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's sharded results, from one 8-device subprocess."""
    root = tmp_path_factory.mktemp("ref_sharding")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8", PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE_JOB), str(root / "ref.pkl"),
                           str(root / "store"), str(root / "ckpt")], capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(root / "ref.pkl", "rb") as f:
        return pickle.load(f)  # written by the job above


@pytest.fixture(autouse=True)
def empty_stores(tmp_path, monkeypatch):
    """Both packages' dispatch stores in an empty directory: ``auto`` takes
    the analytic crossover, as in the reference's job."""
    store = tmp_path / "store"
    monkeypatch.setattr(tstore, "default_dir", lambda device=None: str(store))
    monkeypatch.setattr(rprofile, "load_dispatch_model", functools.partial(rprofile.load_dispatch_model, str(store)))


def _mesh(shape, axes):
    return D.make_mesh(dict(zip(axes, shape)), device="cpu")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# the spec tables at full width
# ---------------------------------------------------------------------------


class _Sized:
    """The reference's ``layout_overrides`` reads ``mesh.devices.size``,
    which an ``AbstractMesh`` does not implement; its size is the same."""

    def __init__(self, mesh):
        self.devices = np.empty(mesh.size)


def _transposed(path: str) -> bool:
    parts = path.split("/")
    return len(parts) >= 2 and parts[-1] in _TRANSPOSED.get(parts[-2], ())


def _expected(path: str, ref_specs: dict, ref_shapes: dict, shape) -> tuple:
    """The port's expected spec of the leaf at ``path``: the reference leaf's
    (the list index of a layer stack dropped), its stacked axis dropped, its
    dims swapped where ``models.interop`` transposes the leaf."""
    key = _STACKED.sub(lambda m: f"{m.group(1)}{m.group(2)}{m.group(3)}", path)
    spec, rshape = list(ref_specs[key]), list(ref_shapes[key])
    spec += [None] * (len(rshape) - len(spec))
    if key != path:
        spec, rshape = spec[1:], rshape[1:]
    if _transposed(key):
        spec, rshape = spec[::-1], rshape[::-1]
    assert tuple(rshape) == tuple(shape), (path, rshape, tuple(shape))
    return tuple(spec)


def _ref_table(shardings, shapes, prefix=""):
    specs = {prefix + rparams._path_str(p): tuple(s.spec) for p, s in jax.tree_util.tree_leaves_with_path(shardings)}
    dims = {prefix + rparams._path_str(p): tuple(leaf.shape) for p, leaf in jax.tree_util.tree_leaves_with_path(shapes)}
    return specs, dims


def _check_table(port_shardings, port_shapes, ref_specs, ref_dims, what):
    leaves = list(tcommon.tree_items(port_shapes))
    got = dict(zip([p for p, _ in leaves], [tuple(s.spec) for s in tcommon.tree_leaves(port_shardings)]))
    assert len(got) == len(leaves)
    for path, leaf in leaves:
        want = _expected(path, ref_specs, ref_dims, leaf.shape)
        assert tuple(got[path]) + (None,) * (leaf.ndim - len(got[path])) == want, (what, path, got[path], want)


def _layouts(cfg, rmesh, tmesh):
    """(name, reference overrides, port overrides): the TP layout and the
    config's layout at each global batch."""
    out = [("tp", {}, {})]
    for gb in LAYOUT_BATCHES:
        r = rparams.layout_overrides(cfg, gb, _Sized(rmesh))
        t = tparams.layout_overrides(cfg, gb, tmesh)
        assert r == t, (cfg.name, gb, r, t)
        out.append((f"{cfg.layout}@{gb}", r, t))
    return out


@pytest.mark.parametrize("arch", list(rconfigs.ARCH_IDS))
def test_param_and_opt_specs_match_reference(arch):
    rcfg, tcfg = rconfigs.get(arch), tconfigs.get(arch)
    rshapes = r_get_model(rcfg).init_shapes()
    tshapes = get_model(tcfg, device=CPU).init_shapes()
    r_opt = {"m": rshapes, "v": rshapes, "ef": rshapes, "step": jax.ShapeDtypeStruct((), np.int32)}
    t_opt = {"m": tshapes, "v": tshapes, "ef": tshapes, "step": torch.empty((), dtype=torch.int32, device="meta")}
    n_sharded = 0  # leaves split over some axis, over every mesh and layout
    for mname, (shape, axes) in ABSTRACT_MESHES.items():
        rmesh, tmesh = AbstractMesh(shape, axes), _mesh(shape, axes)
        for lname, rov, tov in _layouts(rcfg, rmesh, tmesh):
            with rpartition.use_mesh(rmesh, rov):
                r_par = _ref_table(rparams.param_shardings(rmesh, rshapes), rshapes)
                r_o = _ref_table(rparams.opt_state_shardings(rmesh, r_opt), r_opt)
            with tpartition.use_mesh(tmesh, tov):
                t_par = tparams.param_shardings(tmesh, tshapes)
                t_o = tparams.opt_state_shardings(tmesh, t_opt)
            _check_table(t_par, tshapes, *r_par, f"{mname}/{lname}/params")
            _check_table(t_o, t_opt, *r_o, f"{mname}/{lname}/opt")
            n_sharded += sum(any(e is not None for e in s.spec) for s in tcommon.tree_leaves(t_par))
    assert n_sharded > 0


def _batch_shapes(cfg, shape, make):
    B, T = shape.global_batch, shape.seq_len
    out = {"tokens": make((B, T)), "labels": make((B, T))}
    if cfg.model_kind == "encdec":
        out["frames"] = make((B, cfg.enc_seq, cfg.d_model))
    elif cfg.vision_tokens:
        out["patches"] = make((B, min(cfg.vision_tokens, T // 2), cfg.d_model))
    return out


@pytest.mark.parametrize("arch", list(rconfigs.ARCH_IDS))
def test_batch_and_cache_specs_match_reference(arch):
    rcfg, tcfg = rconfigs.get(arch), tconfigs.get(arch)
    rmodel, tmodel = r_get_model(rcfg), get_model(tcfg, device="meta")
    for mname, (mshape, axes) in ABSTRACT_MESHES.items():
        rmesh, tmesh = AbstractMesh(mshape, axes), _mesh(mshape, axes)
        for lname, rov, tov in _layouts(rcfg, rmesh, tmesh):
            for shape in SHAPES:
                rb = _batch_shapes(rcfg, shape, lambda s: jax.ShapeDtypeStruct(s, np.int32))
                tb = _batch_shapes(tcfg, shape, lambda s: torch.empty(s, device="meta"))
                with rpartition.use_mesh(rmesh, rov):
                    r_b = _ref_table(rparams.batch_shardings(rmesh, rb), rb)
                with tpartition.use_mesh(tmesh, tov):
                    t_b = tparams.batch_shardings(tmesh, tb)
                _check_table(t_b, tb, *r_b, f"{mname}/{lname}/{shape.name}/batch")
                if shape.kind != "decode":
                    continue
                rc = jax.eval_shape(lambda: rmodel.init_cache(shape.global_batch, shape.seq_len))
                tc = tmodel.init_cache(shape.global_batch, shape.seq_len)
                with rpartition.use_mesh(rmesh, rov):
                    r_c = _ref_table(rparams.cache_shardings(rmesh, rc), rc)
                with tpartition.use_mesh(tmesh, tov):
                    t_c = tparams.cache_shardings(tmesh, tc)
                _check_table(t_c, tc, *r_c, f"{mname}/{lname}/{shape.name}/cache")


def test_partition_rules_match_reference():
    """``LOGICAL_RULES``, ``_resolve`` (with overrides, a tuple losing an
    absent axis), ``spec_for`` dropping a non-divisible axis and
    ``named_sharding`` with and without a shape, on a (2, 4) mesh."""
    assert tpartition.LOGICAL_RULES == rpartition.LOGICAL_RULES
    rmesh, tmesh = AbstractMesh((2, 4), ("data", "model")), _mesh((2, 4), ("data", "model"))
    cases = [(("batch", "model"), (8, 12)), (("batch", None, "vocab"), (6, 3, 8)), (("fsdp", "expert"), (2, 3)),
             (("none", "sp", "seq"), (4, 4, 4)), (("unknown",), (4,))]
    for ov in ({}, {"batch": ("pod", "data", "model"), "model": None}):
        with rpartition.use_mesh(rmesh, ov), tpartition.use_mesh(tmesh, ov):
            assert tpartition.current_overrides() == ov
            for dims, shape in cases:
                assert tuple(tpartition.spec_for(tmesh, dims, shape)) == tuple(rpartition.spec_for(rmesh, dims, shape))
                for kw in ({}, {"shape": shape}):
                    try:
                        want = tuple(rpartition.named_sharding(rmesh, *dims, **kw).spec)
                    except Exception:  # an axis on two dims (vocab and the overridden batch): both refuse it
                        with pytest.raises(ValueError):
                            tpartition.named_sharding(tmesh, *dims, **kw)
                        continue
                    got = tpartition.named_sharding(tmesh, *dims, **kw)
                    assert tuple(got.spec) == want and got.mesh is tmesh
    assert tpartition.current_mesh() is None and tpartition.current_overrides() == {}


def test_use_mesh_nests_and_shard_hint_is_a_value_noop():
    outer, inner = _mesh((2,), ("data",)), _mesh((2, 2), ("data", "model"))
    x = torch.arange(12.0).view(4, 3)
    assert tpartition.shard_hint(x, "batch", None) is x  # no mesh
    with tpartition.use_mesh(outer):
        with tpartition.use_mesh(inner, {"batch": "model"}):
            assert tpartition.current_mesh() is inner and tpartition.current_overrides() == {"batch": "model"}
            assert tpartition.shard_hint(x, "batch", "model") is x
            assert tpartition.shard_hint(x, "batch") is x  # dims do not name every dim
        assert tpartition.current_mesh() is outer and tpartition.current_overrides() == {}
    assert tpartition.current_mesh() is None
    with pytest.raises(ValueError):
        tpartition.NamedSharding(inner, tpartition.P("pod"))


# ---------------------------------------------------------------------------
# placement and collectives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", [(name, spec) for name, (_, _, specs) in BLOCK_CASES.items() for spec in specs],
                         ids=str)
def test_shard_blocks_match_reference(ref, case):
    name, spec = case
    shape, axes, _ = BLOCK_CASES[name]
    mesh = _mesh(shape, axes)
    sharding = tpartition.NamedSharding(mesh, tpartition.P(*spec))
    A = torch.from_numpy(ref["A"])
    got = tpartition.shard(A, sharding)
    want = ref[("blocks", name, spec)]
    assert len(got) == len(want) == mesh.size
    for s, (g, w) in enumerate(zip(got, want)):
        assert g.device == mesh.devices[s] and np.array_equal(g.numpy(), w), (s, spec)
    back = tpartition.unshard(got, sharding)
    assert back.dtype == A.dtype and torch.equal(back, A)


def test_unshard_checks_and_placement_errors():
    mesh = _mesh((2, 2), ("data", "model"))
    x = torch.arange(24, dtype=torch.int32).view(4, 6)
    s = tpartition.NamedSharding(mesh, tpartition.P("model", "data"))
    blocks = tpartition.shard(x, s)
    assert [tuple(b.shape) for b in blocks] == [(2, 3)] * 4
    assert torch.equal(blocks[1], x[2:, :3]) and torch.equal(blocks[2], x[:2, 3:])  # shard 1: data 0, model 1
    assert torch.equal(tpartition.unshard(blocks, s), x)
    with pytest.raises(ValueError):  # 6 columns do not split 4 ways
        tpartition.shard(x, tpartition.NamedSharding(mesh, tpartition.P(None, ("data", "model"))))
    with pytest.raises(ValueError):  # more entries than dims
        tpartition.shard(torch.zeros(4), tpartition.NamedSharding(mesh, tpartition.P("data", "model")))
    with pytest.raises(ValueError):
        tpartition.unshard(blocks[:3], s)


def test_collectives_for_the_lm_regions():
    """``all_gather`` along dims 1 and 2 (tiled, in group order), ``ppermute``
    with ``lax.ppermute``'s pairs (a shard no pair names gets zeros) and
    ``pmean``, on a (2, 4) mesh; ``all_gather`` along dim 0 unchanged."""
    mesh = _mesh((2, 4), ("data", "model"))
    vals = [torch.full((2, 3, 4), float(s)) + torch.arange(24.0).view(2, 3, 4) for s in range(8)]
    for dim in (0, 1, 2):
        got = D.all_gather(vals, mesh, "data", dim=dim)
        for s in range(8):
            group = [g for g in mesh.groups("data") if s in g][0]
            assert torch.equal(got[s], torch.cat([vals[t] for t in group], dim=dim))
    assert all(torch.equal(a, b) for a, b in zip(D.all_gather(vals, mesh, "model"),
                                                  D.all_gather(vals, mesh, "model", dim=0)))
    got = D.ppermute(vals, mesh, "model", [(0, 1), (1, 2), (2, 0)])
    for group in mesh.groups("model"):
        assert torch.equal(got[group[1]], vals[group[0]]) and torch.equal(got[group[2]], vals[group[1]])
        assert torch.equal(got[group[0]], vals[group[2]]) and torch.equal(got[group[3]], torch.zeros(2, 3, 4))
    got = D.pmean(vals, mesh, ("data", "model"))
    assert all(torch.allclose(g, sum(vals) / 8) for g in got)


def test_ring_allgather_matmul_matches_reference(ref):
    X, W, ring, want = ref["ring"]
    np.testing.assert_allclose(ring, want, rtol=RING_RTOL)  # the reference's own check
    mesh = _mesh((8,), ("tp",))
    xs = tpartition.shard(torch.from_numpy(X), tpartition.NamedSharding(mesh, tpartition.P("tp", None)))
    got = toverlap.ring_allgather_matmul(xs, torch.from_numpy(W), mesh, "tp")
    plain = toverlap.allgather_matmul_reference(xs, torch.from_numpy(W), mesh, "tp")
    assert len(got) == len(plain) == 8
    for g, p in zip(got, plain):
        assert torch.equal(g, p)  # one matmul routine: the ring's rows are the gathered product's
        # across packages XLA's and PyTorch's float32 matmuls sum K = 32 products in their own orders:
        # rtol 1e-5 with an atol of 1e-6 for the entries near zero (|X @ W| reaches ~20)
        np.testing.assert_allclose(g.numpy(), ring, rtol=RING_RTOL, atol=RING_ATOL)
        np.testing.assert_allclose(p.numpy(), want, rtol=RING_RTOL, atol=RING_ATOL)
        np.testing.assert_allclose(g.numpy(), X @ W, rtol=1e-4, atol=1e-4)


def test_compressed_psum_matches_reference(ref):
    G, EF, summed, new_ef = ref["psum"]
    mesh = _mesh((4,), ("data",))
    split = lambda t: [{k: torch.from_numpy(np.split(v, 4)[s].copy()) for k, v in t.items()} for s in range(4)]
    grads, ef = split(G), split(EF)
    got, carries = topt.compressed_psum(grads, ef, mesh, "data")
    for s in range(4):
        for k in G:
            target = grads[s][k] + ef[s][k]
            q, _ = topt._quantize(target)
            rq, _ = ropt._quantize(jax.numpy.asarray(target.numpy()))
            assert np.array_equal(q.numpy(), np.asarray(rq)), (s, k)  # equal int8 codes
            np.testing.assert_allclose(got[s][k].numpy(), summed[k][s], rtol=1e-6, atol=1e-6)
            assert np.array_equal(carries[s][k].numpy(), new_ef[k][s]), (s, k)
    want = sum(G["w"].reshape(4, 3, 5))
    err = float(np.abs(got[0]["w"].numpy() - want).max() / np.abs(want).max())
    assert err < 0.05, err  # tests/test_distributed.py:109


def test_compressed_psum_scales_a_parameter_across_layers():
    """A tree of layers (``layers/<i>/w``) shares one absmax a parameter, as
    ``compress_grads`` does: the codes equal those of the stacked leaf."""
    mesh = _mesh((2,), ("data",))
    rng = np.random.default_rng(1)
    g = [{"layers": [{"w": torch.from_numpy(rng.normal(size=(3, 4)).astype(np.float32)) * (i + 1)}
                     for i in range(2)]} for _ in range(2)]
    ef = [tcommon.tree_map(torch.zeros_like, t) for t in g]
    got, carries = topt.compressed_psum(g, ef, mesh, "data")
    for s in range(2):
        stacked = torch.stack([layer["w"] for layer in g[s]["layers"]])
        q, scale = topt._quantize(stacked)
        deq = topt._dequantize(q, scale)
        for i in range(2):
            assert torch.equal(carries[s]["layers"][i]["w"], stacked[i] - deq[i])
    total = sum(torch.stack([layer["w"] for layer in t["layers"]]) for t in g)
    assert float((torch.stack([x["w"] for x in got[0]["layers"]]) - total).abs().max()) < 0.05 * float(total.abs().max())


# ---------------------------------------------------------------------------
# the expert-parallel MoE region
# ---------------------------------------------------------------------------


def _moe_params(rp):
    tp = {"router": torch.from_numpy(np.array(rp["router"]).T.copy()),
          **{n: torch.from_numpy(np.array(rp[n])) for n in ("wi", "wg", "wo")}}
    if "shared" in rp:
        tp["shared"] = {n: torch.from_numpy(np.array(a).T.copy()) for n, a in rp["shared"].items()}
    return tp


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_apply_sharded_matches_reference(ref, case):
    shape, axes, E, k, _, cf, B, dispatch = MOE_CASES[case]
    rp, x, want, want_aux = ref[("moe", case)]
    mesh = _mesh(shape, axes)
    regions, fallbacks = tmoe.moe_apply_sharded.regions, tmoe.moe_apply_sharded.fallbacks
    got, aux = tmoe.moe_apply_sharded(_moe_params(rp), torch.from_numpy(x), mesh=mesh, n_experts=E, top_k=k,
                                      capacity_factor=cf, dispatch=dispatch)
    fell_back = case.startswith("fallback")
    assert tmoe.moe_apply_sharded.fallbacks - fallbacks == int(fell_back)
    assert tmoe.moe_apply_sharded.regions - regions == int(not fell_back)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=MOE_RTOL, atol=MOE_ATOL)
    slots = B * MOE_T * k
    assert round(float(aux["drop_fraction"]) * slots) == round(want_aux["drop_fraction"] * slots)
    for key in ("load_balance", "router_z", "drop_fraction"):
        np.testing.assert_allclose(float(aux[key]), want_aux[key], rtol=MOE_RTOL, atol=MOE_ATOL, err_msg=key)
    if case.endswith("drops"):
        assert want_aux["drop_fraction"] > 0
    if not fell_back and "data" in axes:  # the region ranks and sizes capacity per data block
        halves = [tmoe.moe_apply(_moe_params(rp), torch.from_numpy(h), n_experts=E, top_k=k, capacity_factor=cf,
                                 dispatch=dispatch)[0] for h in np.split(x, shape[0])]
        np.testing.assert_allclose(got.numpy(), torch.cat(halves).numpy(), rtol=MOE_RTOL, atol=MOE_ATOL)


def test_moe_dispatch_auto_takes_the_region_only_with_a_model_axis():
    cfg = tconfigs.get(SCOUT).reduce()
    p = tmoe.moe_init(torch.Generator().manual_seed(0), cfg.d_model, cfg.d_ff, cfg.moe_experts, True, CPU)
    x = torch.randn((2, 8, cfg.d_model), generator=torch.Generator().manual_seed(1))
    dense, _ = tmoe.moe_dispatch_auto(p, x, cfg)
    for mesh, region in ((None, 0), (_mesh((2,), ("data",)), 0), (_mesh((2,), ("model",)), 1)):
        before = tmoe.moe_apply_sharded.regions
        got, _ = tmoe.moe_dispatch_auto(p, x, cfg, mesh=mesh)
        assert tmoe.moe_apply_sharded.regions - before == region
        torch.testing.assert_close(got, dense, rtol=MOE_RTOL, atol=MOE_ATOL)


def test_scout_forward_and_decode_under_mesh_match_reference(ref):
    rp, toks, logits, aux, steps = ref["scout"]
    cfg = tconfigs.get(SCOUT).reduce()
    tp = params_from_reference(cfg, rp, device=CPU)
    mesh = _mesh((2, 4), ("data", "model"))
    before = tmoe.moe_apply_sharded.regions
    with tpartition.use_mesh(mesh):
        got, got_aux = tlm.forward(cfg, tp, torch.from_numpy(toks))
        cache = tlm.init_cache(cfg, MODEL_B, MODEL_T, fill_len=0, device=CPU)
        for t in range(DECODE_STEPS):
            step, cache = tlm.decode_step(cfg, tp, cache, torch.from_numpy(toks[:, t]))
            np.testing.assert_allclose(step.numpy(), steps[t], rtol=F32_TOL, atol=F32_TOL)
    assert tmoe.moe_apply_sharded.regions - before == cfg.n_layers * (1 + DECODE_STEPS)
    np.testing.assert_allclose(got.numpy(), logits, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got_aux.numpy(), aux, rtol=F32_TOL, atol=F32_TOL)
    dense, _ = tlm.forward(cfg, tp, torch.from_numpy(toks))  # the region drops other tokens
    assert float((dense - got).abs().max()) > 1e-3


def test_jamba_forward_under_mesh_matches_reference(ref):
    rp, toks, logits = ref["jamba"]
    cfg = tconfigs.get(JAMBA).reduce()
    tp = params_from_reference(cfg, rp, device=CPU)
    before = tmoe.moe_apply_sharded.regions
    with tpartition.use_mesh(_mesh((2, 4), ("data", "model"))):
        got, _ = tjamba.forward(cfg, tp, torch.from_numpy(toks))
    assert tmoe.moe_apply_sharded.regions - before == cfg.n_layers // 2  # MoE at odd sub-layers
    np.testing.assert_allclose(got.numpy(), logits, rtol=F32_TOL, atol=F32_TOL)


# ---------------------------------------------------------------------------
# restore onto a mesh
# ---------------------------------------------------------------------------


def test_restore_with_shardings_matches_reference(ref, tmp_path):
    rp, rblocks = ref["restore"]
    cfg = tconfigs.get(LLAMA).reduce()
    tp = params_from_reference(cfg, rp, device=CPU)
    tck.save(str(tmp_path), 1, {"params": tp})
    mesh = _mesh((2, 2), ("data", "model"))
    like = {"params": get_model(cfg, device=CPU).init_shapes()}
    shardings = {"params": tparams.param_shardings(mesh, like["params"])}
    got, meta = tck.restore(str(tmp_path), like, shardings=shardings)
    assert meta["step"] == 1
    saved, sharded = dict(tcommon.tree_items(tp)), 0
    for (path, placed), sharding in zip(tcommon.tree_items(got["params"]), tcommon.tree_leaves(shardings["params"])):
        assert isinstance(placed, tpartition.Sharded) and placed.sharding is sharding
        blocks = placed.blocks
        key = _STACKED.sub(lambda m: f"{m.group(1)}{m.group(2)}{m.group(3)}", path)
        layer = re.search(r"(layers)/(\d+)/", path)
        assert len(blocks) == mesh.size
        for s, b in enumerate(blocks):
            w = rblocks[key][s]
            if layer:
                w = w[int(layer.group(2))]
            if _transposed(key):
                w = w.T
            assert np.array_equal(b.numpy(), w), (path, s)
        sharded += any(e is not None for e in sharding.spec)
        assert torch.equal(placed.unshard(), saved[path])
    assert sharded > 0
    one = tpartition.NamedSharding(mesh, tpartition.P())
    got, _ = tck.restore(str(tmp_path), like, shardings=one)  # one sharding for every leaf: replicated
    assert all(torch.equal(b, t) for placed, t in zip(tcommon.tree_leaves(got["params"]), tcommon.tree_leaves(tp))
               for b in placed.blocks)
    with pytest.raises(ValueError):
        tck.restore(str(tmp_path), like, device=CPU, shardings=shardings)

