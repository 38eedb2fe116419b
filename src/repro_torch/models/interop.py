"""The reference's LM parameters as the port's.

``params_from_reference(cfg, tree)`` takes ``repro.models.lm``'s parameter
pytree as numpy arrays (layers stacked on a leading ``[L, ...]`` axis,
projections laid out ``[d_in, d_out]`` for ``x @ W``) and returns the port's
parameters: a list of layers, projections transposed to ``nn.Linear``'s
``[d_out, d_in]``.  A MoE layer's router is transposed to ``[E, d]`` and
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

_PROJECTIONS = {"attn": ("wq", "wk", "wv", "wo"), "mlp": ("wi", "wg", "wo")}
_BIASES = ("bq", "bk", "bv")
_EXPERT_STACKS = ("wi", "wg", "wo")


def _tensor(a, device, transpose: bool = False) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: widen exactly, narrow back
        t = torch.from_numpy(np.ascontiguousarray(a.astype(np.float32))).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a writable copy
    return (t.T.contiguous() if transpose else t).to(device)


def params_from_reference(cfg: ArchConfig, tree, device=None) -> Params:
    dev = resolve_device(device)
    lt = tree["layers"]
    layers = []
    for i in range(cfg.n_layers):
        layer = {
            "attn_norm": {"scale": _tensor(lt["attn_norm"]["scale"][i], dev)},
            "mlp_norm": {"scale": _tensor(lt["mlp_norm"]["scale"][i], dev)},
        }
        for block, names in _PROJECTIONS.items():
            if block in lt:
                layer[block] = {n: _tensor(lt[block][n][i], dev, transpose=True) for n in names}
        for n in _BIASES:
            if n in lt["attn"]:
                layer["attn"][n] = _tensor(lt["attn"][n][i], dev)
        if "moe" in lt:
            moe = lt["moe"]
            layer["moe"] = {"router": _tensor(moe["router"][i], dev, transpose=True),
                            **{n: _tensor(moe[n][i], dev) for n in _EXPERT_STACKS}}
            if "shared" in moe:
                layer["moe"]["shared"] = {n: _tensor(moe["shared"][n][i], dev, transpose=True)
                                          for n in _PROJECTIONS["mlp"]}
        layers.append(layer)
    out = {
        "embed": {"table": _tensor(tree["embed"]["table"], dev)},
        "layers": layers,
        "final_norm": {"scale": _tensor(tree["final_norm"]["scale"], dev)},
    }
    if "head" in tree:
        out["head"] = {"w": _tensor(tree["head"]["w"], dev, transpose=True)}
    return out


def opt_state_from_reference(cfg: ArchConfig, state, device=None) -> Params:
    """The reference's AdamW state (numpy leaves): ``m``, ``v`` and, with
    compression, ``ef`` through :func:`params_from_reference` (each keeps
    its dtype), ``step`` as a 0-d int32 tensor."""
    dev = resolve_device(device)
    out = {k: params_from_reference(cfg, state[k], dev) for k in ("m", "v", "ef") if k in state}
    out["step"] = torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32, device=dev)
    return out
