"""The reference's LM parameters as the port's.

``params_from_reference(cfg, tree)`` takes the parameter pytree of
``repro.models.lm`` (or, by ``cfg.model_kind``, ``whisper`` / ``rwkv6`` /
``jamba``) as numpy arrays (layers stacked on a leading ``[L, ...]`` axis,
whisper's ``enc_layers`` / ``dec_layers`` each so, jamba's periods on
``[P, ...]``, projections laid out ``[d_in, d_out]`` for ``x @ W``) and
returns the port's parameters: a list of layers (of periods) for each
stack, projections transposed to ``nn.Linear``'s ``[d_out, d_in]``
(whisper's ``self_attn`` and ``cross_attn`` as ``attn``, its GELU MLP's
``wi`` / ``wo``; the MLP biases ``bi`` / ``bo`` and the layernorms kept).  rwkv's
``mu``, ``w0``, ``u`` and layernorms, and mamba's ``conv_w [K, d_in]``,
``conv_b``, ``dt_bias``, ``A_log`` and ``D`` are kept as they are.  A MoE
layer's router is transposed to ``[E, d]`` and
its shared expert as ``mlp`` is; its expert stacks keep the reference's
``[E, d, f]`` / ``[E, f, d]`` layout (``models.moe`` applies them as
batched ``x @ W``), so they are copied unchanged, and the same layout
serves their gradients and optimizer moments.  Both packages then compute
the same function.
``opt_state_from_reference(cfg, state)`` maps ``repro.train.optimizer``'s
state the same way, so that both optimizers can start from one state.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.data.table import resolve_device

from .common import Params
from .config import ArchConfig

# the leaves transposed, by the block that holds them
_TRANSPOSED = {
    "attn": {"wq", "wk", "wv", "wo"},
    "self_attn": {"wq", "wk", "wv", "wo"},
    "cross_attn": {"wq", "wk", "wv", "wo"},
    "mlp": {"wi", "wg", "wo"},
    "moe": {"router"},
    "shared": {"wi", "wg", "wo"},
    "head": {"w"},
    "mamba": {"in_proj", "x_proj", "dt_proj", "out_proj"},
    "tmix": {"wr", "wk", "wv", "wg", "ww", "wo"},
    "cmix": {"wk", "wv", "wr"},
}


def _tensor(a, device, transpose: bool = False) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: widen exactly, narrow back
        t = torch.from_numpy(np.ascontiguousarray(a.astype(np.float32))).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a writable copy
    return (t.T.contiguous() if transpose else t).to(device)


# the decoder's keys in the order ``lm.init`` builds them: the reference's
# trees come with their keys sorted, and the order of the leaves is the
# order in which the optimizer sums them.  A key not named keeps its place
_ORDER = {k: r for r, k in enumerate((
    "embed", "layers", "enc_layers", "dec_layers", "final_norm", "enc_norm", "dec_norm", "head",
    "attn_norm", "self_norm", "cross_norm", "mlp_norm", "attn", "self_attn", "cross_attn", "mlp", "moe",
    "router", "wi", "bi", "wg", "wq", "wk", "wv", "wo", "bo", "bq", "bk", "bv", "shared"))}


def _ordered(node) -> list:
    return sorted(node, key=lambda k: _ORDER.get(k, len(_ORDER)))


def _block(node, dev, i=None, transposed=frozenset()) -> Params:
    """A block of the reference's tree (entry ``i`` of it where it is
    stacked), its leaves in ``transposed`` (by the name of the block that
    holds them) transposed."""
    out = {}
    for k in _ordered(node):
        v = node[k]
        out[k] = (_block(v, dev, i, _TRANSPOSED.get(k, frozenset())) if isinstance(v, dict)
                  else _tensor(v if i is None else v[i], dev, transpose=k in transposed))
    return out


def params_from_reference(cfg: ArchConfig, tree, device=None) -> Params:
    dev = resolve_device(device)
    if cfg.model_kind == "jamba":
        stacks = {"periods": cfg.n_layers // cfg.attn_period}
    elif cfg.model_kind == "encdec":
        stacks = {"enc_layers": cfg.enc_layers, "dec_layers": cfg.n_layers}
    else:
        stacks = {"layers": cfg.n_layers}
    out = _block({k: v for k, v in tree.items() if k not in stacks}, dev)
    for stack, n in stacks.items():
        out[stack] = [_block(tree[stack], dev, i) for i in range(n)]
    return {k: out[k] for k in _ordered(out)}


def opt_state_from_reference(cfg: ArchConfig, state, device=None) -> Params:
    """The reference's AdamW state (numpy leaves): ``m``, ``v`` and, with
    compression, ``ef`` through :func:`params_from_reference` (each keeps
    its dtype), ``step`` as a 0-d int32 tensor."""
    dev = resolve_device(device)
    out = {k: params_from_reference(cfg, state[k], dev) for k in ("m", "v", "ef") if k in state}
    out["step"] = torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32, device=dev)
    return out
