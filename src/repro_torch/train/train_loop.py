"""Training loop: eager step, checkpoint/restart, straggler watchdog (the
twin of ``repro.train.train_loop``).

Fault-tolerance contract: ``run()`` interrupted at any step and restarted
from the latest checkpoint gives the same losses as an uninterrupted run —
parameters, optimizer state *and the data stream's position* live in the
checkpoint, and the stream is a pure function of (seed, step).

One step: the grads set to ``None``, ``loss = model.loss_fn(params,
batch)``, ``loss.backward()`` (through the flash-attention kernel's
forward and the reference's plain gradient route, each remat period
recomputed), ``apply_updates`` in place, and the metrics converted to
floats in one host sync (the reference's ``float(v)``).

The watchdog tracks a running median of step times; a step over
``straggler_factor ×`` the median is logged and counted (the fleet's
escalation hook; one process here).

The entry points run on the model's device: the card unless the caller
named another.
"""
from __future__ import annotations

import os
import statistics
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.data.lm_data import StreamConfig, TokenStream
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.models.registry import Model

from . import checkpoint as ckpt
from .optimizer import OptConfig, apply_updates, init_state


@dataclass
class TrainConfig:
    steps: int = 100
    ckpt_every: int = 20
    # under this process's temporary directory (TMPDIR), not a fixed path
    ckpt_dir: str = field(default_factory=lambda: os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ckpt_async: bool = True
    keep: int = 3
    opt: OptConfig = field(default_factory=OptConfig)
    straggler_factor: float = 3.0
    log_every: int = 10
    seed: int = 0


#: the profiler range of a step's ``apply_updates``
OPTIMIZER_RANGE = "optimizer"


class SimulatedFailure(RuntimeError):
    pass


def _trainable(params):
    return tree_map(lambda t: t.requires_grad_(True), params)


class Trainer:
    def __init__(self, model: Model, tcfg: TrainConfig, stream_cfg: StreamConfig):
        self.model = model
        self.tcfg = tcfg
        self.stream = TokenStream(stream_cfg, device=model.device)
        self.saver = ckpt.AsyncSaver()
        self.metrics_log: List[Dict[str, float]] = []
        self.straggler_events: List[int] = []
        self._step_times: List[float] = []
        self.params = None
        self.opt_state = None

    # -- state --------------------------------------------------------------
    def init(self, generator: Optional[torch.Generator] = None) -> None:
        """Float32 parameters from ``generator`` (by default one on the
        model's device seeded with ``tcfg.seed``), requiring grad, and a
        fresh optimizer state."""
        if generator is None:
            generator = torch.Generator(device=self.model.device).manual_seed(self.tcfg.seed)
        self.params = _trainable(self.model.init(generator))
        self.opt_state = init_state(self.params, self.tcfg.opt)

    def restore_or_init(self, generator: Optional[torch.Generator] = None) -> int:
        step = ckpt.latest_step(self.tcfg.ckpt_dir)
        if step is None:
            self.init(generator)
            return 0
        like = {"params": self.model.init_shapes()}
        like["opt"] = init_state(like["params"], self.tcfg.opt)
        tree, meta = ckpt.restore(self.tcfg.ckpt_dir, like, device=self.model.device)
        self.params, self.opt_state = _trainable(tree["params"]), tree["opt"]
        self.stream.restore(meta)
        return int(meta["step"])

    def save(self, step: int) -> None:
        tree = {"params": self.params, "opt": self.opt_state}
        meta = {**self.stream.state()}
        if self.tcfg.ckpt_async:
            self.saver.save(self.tcfg.ckpt_dir, step, tree, meta, self.tcfg.keep)
        else:
            ckpt.save(self.tcfg.ckpt_dir, step, tree, meta, self.tcfg.keep)

    # -- one step -------------------------------------------------------------
    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One optimizer step on ``batch``; the metrics as 0-d tensors."""
        leaves = tree_leaves(self.params)
        for p in leaves:
            p.grad = None
        loss = self.model.loss_fn(self.params, batch)
        loss.backward()
        grads = tree_map(lambda p: p.grad, self.params)
        with torch.profiler.record_function(OPTIMIZER_RANGE):  # a trace's optimizer time
            _, _, metrics = apply_updates(self.params, self.opt_state, grads, self.tcfg.opt)
        metrics["loss"] = loss.detach()
        return metrics

    # -- the loop -------------------------------------------------------------
    def run(
        self,
        steps: Optional[int] = None,
        fail_at: Optional[int] = None,
        on_step: Optional[Callable[[int, Dict[str, float]], None]] = None,
    ) -> List[Dict[str, float]]:
        steps = steps if steps is not None else self.tcfg.steps
        start = self.restore_or_init() if self.params is None else self.stream.step
        for step in range(start, steps):
            if fail_at is not None and step == fail_at:
                raise SimulatedFailure(f"injected failure at step {step}")
            t0 = time.perf_counter()
            batch = self.stream.next()
            out = self.train_step(batch)
            # one host sync a step
            metrics = dict(zip(out, torch.stack([v.float() for v in out.values()]).tolist()))
            dt = time.perf_counter() - t0
            metrics["step_time_s"] = dt
            self._watchdog(step, dt)
            self.metrics_log.append({"step": step, **metrics})
            if on_step:
                on_step(step, metrics)
            if (step + 1) % self.tcfg.ckpt_every == 0 or step + 1 == steps:
                self.save(step + 1)
            if step % self.tcfg.log_every == 0:
                print(
                    f"step {step:>6}  loss {metrics['loss']:.4f}"
                    f"  gnorm {metrics['grad_norm']:.3f}  {dt*1e3:.0f} ms"
                )
        self.saver.wait()
        return self.metrics_log

    # -- straggler watchdog ----------------------------------------------------
    def _watchdog(self, step: int, dt: float) -> None:
        self._step_times.append(dt)
        if len(self._step_times) < 8:
            return
        med = statistics.median(self._step_times[-50:])
        if dt > self.tcfg.straggler_factor * med:
            self.straggler_events.append(step)
            print(
                f"[watchdog] step {step}: {dt*1e3:.0f} ms vs median "
                f"{med*1e3:.0f} ms — straggler policy engaged "
                f"(fleet: re-route shard / evict host; see train_loop docstring)"
            )
