"""The selective-scan kernel's launch geometry and tile walk, on the CPU.

The kernel (``kernels/csrc/selective_scan.cu``) runs only on the card; what
surrounds it is Python that these tests reach:

* ``launch_geometry`` covers every (batch row, channel, state lane) exactly
  once, through ``block_lanes`` (the kernel's index map), at jamba's width,
  the reduced configs' width (d_in 64), the decode shape (4 × 1) and ragged
  widths (130, 200, 1,000) at d_state 4, 8 and 16; at jamba's width it
  gives at least 2,048 warps, 15 an SM over the H100's 132;
* the Python constants are the source's ``constexpr`` ones;
* ``pad_channels`` leaves the real channels' results as they are;
* a numpy transcription of the kernel's walk (the cp.async ring of two
  stages, the widening pass, each warp's lanes, the group's partial sums
  added in shared memory, the 16-byte chunks with zero-filled ones past the
  width) against the twin and the reference's scan body run by JAX, at a
  ragged tail after the ring wraps, a width one channel past a block, one
  decode step, T = 0 and every d_state, in float32 and bfloat16.

The kernel itself is held against its twin on the card
(``tests/test_torch_gpu.py -k selective``).
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import selective_scan as ss

H100_SMS = 132
JAMBA = (1, 16384, 16)  # B, d_in, ds at 1 × 8,192 prefill
GEOMETRY_CASES = [JAMBA, (4, 16384, 16), (2, 64, 16), (3, 64, 4), (2, 64, 8)] + [
    (2, d_in, ds) for d_in in (130, 200, 1000) for ds in (4, 8, 16)]


@pytest.mark.parametrize("case", GEOMETRY_CASES)
def test_geometry_covers_every_lane_once(case):
    B, d_in, ds = case
    geom = ss.launch_geometry(B, d_in, ds)
    assert geom.group * geom.states == ds and geom.threads % 32 == 0 and geom.channels % 32 == 0
    assert geom.width % ss.ALIGN == 0 and d_in <= geom.width < d_in + ss.ALIGN
    assert geom.blocks_y == B and (geom.blocks_x - 1) * geom.channels < geom.width <= geom.blocks_x * geom.channels
    c, first = ss.block_lanes(geom)  # every thread of the grid: batch row, channel, first state
    bx, by = np.meshgrid(np.arange(geom.blocks_x), np.arange(geom.blocks_y), indexing="ij")
    b = np.repeat(by.ravel(), geom.threads)
    ch = (bx.ravel()[:, None] * geom.channels + c).ravel()
    n0 = np.tile(first, by.size)
    real = ch < d_in
    lanes = (b[real, None] * d_in + ch[real, None]) * ds + n0[real, None] + np.arange(geom.states)
    counts = np.bincount(lanes.ravel(), minlength=B * d_in * ds)
    assert counts.shape[0] == B * d_in * ds and (counts == 1).all()


def test_geometry_fills_the_card_at_jambas_width():
    geom = ss.launch_geometry(*JAMBA)
    assert geom.group == 4 and geom.warps >= 2048
    assert geom.warps / H100_SMS >= 15


def test_constants_match_the_kernel_source():
    src = (build.CSRC / "selective_scan.cu").read_text()
    for name in ("STATES", "BLOCK", "TILE", "ALIGN"):
        assert int(re.search(rf"constexpr int {name} = (\d+);", src).group(1)) == getattr(ss, name), name


def _inputs(case, dtype, seed=0):
    B, T, d_in, ds, carried = case
    rng = np.random.default_rng(seed)
    xc = rng.normal(size=(B, T, d_in)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, T, d_in)) - 2)).astype(np.float32)
    Bt, Ct = (rng.normal(size=(B, T, ds)).astype(np.float32) for _ in range(2))
    A = -np.tile(np.arange(1, ds + 1, dtype=np.float32), (d_in, 1))
    h0 = rng.normal(size=(B, d_in, ds)).astype(np.float32) if carried else None
    tdt = getattr(torch, dtype)
    return (*(torch.from_numpy(a).to(tdt) for a in (xc, dt, Bt, Ct)), torch.from_numpy(A),
            None if h0 is None else torch.from_numpy(h0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("carried", [False, True])
def test_padded_channels_leave_the_real_ones(dtype, carried):
    xc, dt, Bt, Ct, A, h0 = _inputs((2, 21, 130, 8, carried), dtype)
    geom = ss.launch_geometry(2, 130, 8)
    assert geom.width == 136
    pxc, pdt, pA, ph0 = ss.pad_channels(geom.width, xc, dt, A, h0)
    assert pxc.shape[-1] == pdt.shape[-1] == pA.shape[0] == geom.width
    assert ph0 is None or ph0.shape[1] == geom.width
    want_y, want_h = ss.selective_scan_plain(xc, dt, Bt, Ct, A, h0)
    got_y, got_h = ss.selective_scan_plain(pxc, pdt, Bt, Ct, pA, ph0)
    torch.testing.assert_close(got_y[..., :130], want_y, rtol=0, atol=0)
    torch.testing.assert_close(got_h[:, :130], want_h, rtol=0, atol=0)
    assert not got_y[..., 130:].any() and (ph0 is not None or not got_h[:, 130:].any())


def _rnd(v, bf16):
    v = np.asarray(v, np.float32)
    return torch.from_numpy(v).bfloat16().float().numpy() if bf16 else v


def _kernel_model(xc, dt, Bm, Cm, A, h0, n_b, n_t, d, ds, bf16, geom):
    """``selective_scan_kernel``'s walk transcribed block by block: flat
    arrays stand for device and shared memory, with the source's offsets.
    Unwritten shared words are NaN, so a read before its load shows."""
    TILE, BLOCK, STATES, G = geom.tile, geom.channels, geom.states, geom.group
    esz = 2 if bf16 else 4
    E, BC = 16 // esz, 8 // esz  # elements of a 16-byte chunk of dt / x, an 8-byte chunk of B / C
    ROW, YROW = BLOCK // E, BLOCK // 4
    y = np.full(n_b * n_t * d, np.nan, np.float32)
    hT = np.full(n_b * d * ds, np.nan, np.float32)
    c, n0 = ss.block_lanes(geom)
    g = n0 // STATES
    for by in range(geom.blocks_y):
        for bx in range(geom.blocks_x):
            s_part = np.full(G * TILE * BLOCK, np.nan, np.float32)
            s_dd = np.full((TILE * BLOCK, 2), np.nan, np.float32)
            s_b, s_c = np.full(TILE * ds, np.nan, np.float32), np.full(TILE * ds, np.nan, np.float32)
            r_dt, r_x = np.full(2 * TILE * BLOCK, np.nan, np.float32), np.full(2 * TILE * BLOCK, np.nan, np.float32)
            r_b, r_c = np.full(2 * TILE * ds, np.nan, np.float32), np.full(2 * TILE * ds, np.nan, np.float32)
            ch0, row0, n_tiles = bx * BLOCK, by * n_t, -(-n_t // TILE)
            live = ch0 + c < d

            def load(k):  # one commit group: the copies it will land
                p, t0 = k & 1, k * TILE
                nt, ops = min(TILE, n_t - t0), []
                for i in range(nt * ROW):
                    r, q = divmod(i, ROW)
                    cc = ch0 + q * E
                    o = (p * TILE + r) * BLOCK + q * E
                    off = (row0 + t0 + r) * d + cc if cc < d else None  # None: zero-filled
                    ops += [(r_dt, o, dt, off, E), (r_x, o, xc, off, E)]
                for i in range(nt * ds // BC):
                    off = (row0 + t0) * ds + i * BC
                    ops += [(r_b, p * TILE * ds + i * BC, Bm, off, BC), (r_c, p * TILE * ds + i * BC, Cm, off, BC)]
                return ops

            def store_y(k):  # the group's partials added in order, 4 channels a thread
                t0 = k * TILE
                for i in range(min(TILE, n_t - t0) * YROW):
                    r, q = divmod(i, YROW)
                    cc = ch0 + q * 4
                    v = s_part[r * BLOCK + q * 4:][:4].copy()
                    for gg in range(1, G):
                        v = v + s_part[(gg * TILE + r) * BLOCK + q * 4:][:4]
                    if cc < d:
                        y[(row0 + t0 + r) * d + cc:][:4] = v

            lane0 = (ch0 + c) * ds + g * STATES
            a, h = np.zeros((geom.threads, STATES), np.float32), np.zeros((geom.threads, STATES), np.float32)
            for n in range(STATES):
                a[live, n] = A[lane0[live] + n]
                if h0 is not None:
                    h[live, n] = h0[by * d * ds + lane0[live] + n]
            ring = [load(0), load(1) if n_tiles > 1 else []]
            for k in range(n_tiles):
                p, nt = k & 1, min(TILE, n_t - k * TILE)
                for dst, o, src, off, n in ring.pop(0):  # cp.async.wait_group 1: the oldest group lands
                    dst[o:o + n] = 0.0 if off is None else src[off:off + n]
                dv, xv = r_dt[p * TILE * BLOCK:][:nt * BLOCK], r_x[p * TILE * BLOCK:][:nt * BLOCK]
                s_dd[:nt * BLOCK] = np.stack([dv, _rnd(dv * xv, bf16)], 1)
                s_b[:nt * ds], s_c[:nt * ds] = r_b[p * TILE * ds:][:nt * ds], r_c[p * TILE * ds:][:nt * ds]
                ring.append(load(k + 2) if k + 2 < n_tiles else [])
                for j in range(nt):
                    d_, dx = s_dd[j * BLOCK + c].T
                    acc = np.zeros(geom.threads, np.float32)
                    for n in range(STATES):
                        b_, c_ = s_b[j * ds + g * STATES + n], s_c[j * ds + g * STATES + n]
                        da = _rnd(np.exp(_rnd(d_ * a[:, n], bf16)), bf16)
                        h[:, n] = da * h[:, n] + _rnd(dx * b_, bf16)
                        acc = acc + h[:, n] * c_
                    s_part[(g * TILE + j) * BLOCK + c] = acc
                store_y(k)
            for n in range(STATES):
                hT[by * d * ds + lane0[live] + n] = h[live, n]
    return y.reshape(n_b, n_t, d), hT.reshape(n_b, d, ds)


def _reference_steps(xc, dt, Bt, Ct, A, h):
    """The reference's scan body (``repro/models/mamba.py:81-86``) op by op
    in JAX, each op rounding to its dtype (as ``tests/test_torch_mamba.py``
    runs it)."""
    ys = []
    with jax.disable_jit():
        for t in range(xc.shape[1]):
            da = jnp.exp(dt[:, t][..., None] * A[None])
            h = da * h + (dt[:, t] * xc[:, t])[..., None] * Bt[:, t][:, None, :]
            ys.append(jnp.einsum("bds,bs->bd", h, Ct[:, t]))
    return (jnp.stack(ys, 1) if ys else jnp.zeros((xc.shape[0], 0, xc.shape[2]), jnp.float32)), h


# (B, T, d_in, ds, carried): the ring wrapped with a ragged tail (2·TILE + 5),
# one channel past a block, one decode step, no steps, every d_state with B > 1
MODEL_CASES = [(2, 2 * ss.TILE + 5, 130, 16, True), (1, 40, ss.BLOCK + 1, 16, False), (4, 1, 200, 16, True),
               (2, 0, 72, 16, True), (3, 33, 64, 4, True), (2, 37, 136, 8, False)]


@pytest.mark.parametrize("case", MODEL_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_walk_matches_twin_and_reference(case, dtype):
    B, T, d_in, ds, carried = case
    xc, dt, Bt, Ct, A, h0 = _inputs(case, dtype, seed=T + d_in)
    geom = ss.launch_geometry(B, d_in, ds)
    pxc, pdt, pA, ph0 = ss.pad_channels(geom.width, xc, dt, A, h0)

    def flat(t):
        return None if t is None else t.float().contiguous().numpy().ravel()

    y, h = _kernel_model(flat(pxc), flat(pdt), flat(Bt), flat(Ct), flat(pA), flat(ph0), B, T, geom.width, ds,
                         dtype == "bfloat16", geom)
    assert not np.isnan(y).any() and not np.isnan(h).any()
    y, h = torch.from_numpy(y[..., :d_in]), torch.from_numpy(h[:, :d_in])
    want_y, want_h = ss.selective_scan_plain(xc, dt, Bt, Ct, A, h0)
    # the same roundings: only float32 summation order differs (SCAN_TOL on the card)
    torch.testing.assert_close(y, want_y, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h, want_h, rtol=1e-4, atol=1e-4)
    jdt = jnp.dtype(dtype)
    ref_y, ref_h = _reference_steps(*(jnp.asarray(t.float().numpy()).astype(jdt) for t in (xc, dt, Bt, Ct, A)),
                                    jnp.zeros((B, d_in, ds), jnp.float32) if h0 is None else jnp.asarray(h0.numpy()))
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y, np.float32), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(ref_h, np.float32), rtol=1e-4, atol=1e-4)
