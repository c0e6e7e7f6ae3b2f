"""Train-step builder and the fault-tolerant training loop (a port of
``repro.train.trainer``).

``make_train_step`` turns ``loss_fn(params, batch) -> (loss, metrics)`` into
a step: gradients by ``torch.autograd.grad`` → global-norm clip → AdamW →
metrics.  With ``accum_steps > 1`` the batch has a leading microbatch axis;
the microbatches' gradients add up in fp32 buffers and are divided by
``accum_steps``, their losses and metrics are averaged (``repro``'s
``lax.scan``).

The step updates the parameters and the optimizer state in place (a
second copy of a large model's state may not fit beside the first), in two
parts: :meth:`TrainStep.grads` computes the loss, metrics and gradients and
changes nothing; :meth:`TrainStep.apply` runs the update.  ``repro``'s loop
throws away the new state of a step whose loss is not finite; ``TrainLoop``
here does not apply such a step, so its parameters after a skipped step
are the ones before it, as in ``repro``.

``TrainLoop`` keeps ``repro``'s behaviour: restore from the latest
checkpoint, skip a non-finite loss (raise after ``max_consecutive_bad``),
log, checkpoint every ``checkpoint_every`` steps (asynchronously) and once
more, synchronously, at the end; batches come through a bounded prefetch
thread.
"""

from __future__ import annotations

import dataclasses
import math
import queue
import threading
import time
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch

from repro_torch.checkpoint import store as ckpt_store
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.optimizer import AdamWConfig, AdamWState
from repro_torch.train.tree import leaves, tree_map, unflatten_like


class TrainStep:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``,
    in place, and its two parts :meth:`grads` and :meth:`apply`."""

    def __init__(self, loss_fn: Callable, opt_cfg: AdamWConfig, accum_steps: int = 1):
        self.loss_fn = loss_fn
        self.opt_cfg = opt_cfg
        self.accum_steps = accum_steps

    def _value_and_grad(self, params, batch):
        live = [p.detach().requires_grad_() for p in leaves(params)]
        with torch.enable_grad():
            loss, metrics = self.loss_fn(unflatten_like(params, live), batch)
            grads = torch.autograd.grad(loss, live, allow_unused=True, materialize_grads=True)
        return loss.detach(), {k: torch.as_tensor(v).detach() for k, v in metrics.items()}, grads

    def grads(self, params, batch) -> Tuple[Any, Dict[str, torch.Tensor]]:
        """(gradients, metrics with ``loss_total``); nothing is changed.
        Gradients are in the parameters' dtypes, or fp32 when accumulated."""
        if self.accum_steps == 1:
            loss, metrics, grads = self._value_and_grad(params, batch)
        else:
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in leaves(params)]
            losses, per_micro = [], []
            for i in range(self.accum_steps):
                loss_i, metrics_i, grads_i = self._value_and_grad(
                    params, tree_map(lambda x: x[i], batch))
                for a, g in zip(acc, grads_i):
                    a.add_(g)
                del grads_i
                losses.append(loss_i)
                per_micro.append(metrics_i)
            grads = [a.div_(self.accum_steps) for a in acc]
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in per_micro]).float().mean()
                       for k in per_micro[0]}
        metrics["loss_total"] = loss
        return unflatten_like(params, grads), metrics

    def apply(self, params, opt_state: AdamWState, grads,
              metrics: Dict[str, torch.Tensor]) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
        """The AdamW update of :meth:`grads`' output, in place; returns
        (params, the new state, metrics with ``grad_norm`` and ``lr``)."""
        params, opt_state, om = opt_mod.update(self.opt_cfg, grads, opt_state, params)
        out = {k: v for k, v in metrics.items() if k != "loss_total"}
        out.update(om)
        out["loss_total"] = metrics["loss_total"]
        return params, opt_state, out

    def __call__(self, params, opt_state: AdamWState, batch):
        grads, metrics = self.grads(params, batch)
        return self.apply(params, opt_state, grads, metrics)


def make_train_step(loss_fn: Callable, opt_cfg: AdamWConfig, accum_steps: int = 1) -> TrainStep:
    """Build ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``.  With ``accum_steps > 1``, ``batch`` must have a leading
    microbatch axis of that size."""
    return TrainStep(loss_fn, opt_cfg, accum_steps)


# ---------------------------------------------------------------------------
# data prefetcher (pull-based, bounded queue => backpressure)
# ---------------------------------------------------------------------------

class Prefetcher:
    def __init__(self, it: Iterator, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._done = object()

        def worker():
            try:
                for x in it:
                    self._q.put(x)
            finally:
                self._q.put(self._done)

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        x = self._q.get()
        if x is self._done:
            raise StopIteration
        return x


# ---------------------------------------------------------------------------
# fault-tolerant loop
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    log_every: int = 10
    keep_checkpoints: int = 3
    skip_nonfinite: bool = True
    max_consecutive_bad: int = 10


class TrainLoop:
    """Checkpointed training loop over a :class:`TrainStep`.  ``ckpt_dir=None``
    disables persistence.  ``run`` updates the parameters and state it is
    given in place and returns them."""

    def __init__(
        self,
        step_fn: TrainStep,
        loop_cfg: LoopConfig,
        ckpt_dir: Optional[str] = None,
        log: Callable[[str], None] = print,
    ):
        self.step_fn = step_fn
        self.cfg = loop_cfg
        self.ckpt_dir = ckpt_dir
        self.log = log

    def run(self, params, opt_state, data: Iterator, start_step: int = 0):
        if self.ckpt_dir:
            restored = ckpt_store.restore_latest(
                self.ckpt_dir, like_params=params, like_opt=opt_state
            )
            if restored is not None:
                start_step, params, opt_state = restored
                self.log(f"[trainer] restored checkpoint at step {start_step}")

        data = Prefetcher(iter(data))
        bad = 0
        t0 = time.perf_counter()
        history = []
        for step_i, batch in zip(range(start_step, self.cfg.total_steps), data):
            grads, metrics = self.step_fn.grads(params, batch)
            loss = float(metrics.get("loss_total", metrics.get("loss", math.nan)))
            if self.cfg.skip_nonfinite and not math.isfinite(loss):
                bad += 1
                del grads
                self.log(f"[trainer] step {step_i}: non-finite loss, skipping update ({bad})")
                if bad > self.cfg.max_consecutive_bad:
                    raise RuntimeError("too many consecutive non-finite steps")
                continue
            bad = 0
            params, opt_state, metrics = self.step_fn.apply(params, opt_state, grads, metrics)
            del grads
            history.append(loss)
            if step_i % self.cfg.log_every == 0:
                dt = time.perf_counter() - t0
                self.log(f"[trainer] step {step_i} loss {loss:.4f} ({dt:.1f}s)")
            if self.ckpt_dir and step_i > 0 and step_i % self.cfg.checkpoint_every == 0:
                ckpt_store.save(
                    self.ckpt_dir, step_i, params, opt_state,
                    keep=self.cfg.keep_checkpoints, async_write=True,
                )
        if self.ckpt_dir:
            ckpt_store.save(
                self.ckpt_dir, self.cfg.total_steps, params, opt_state,
                keep=self.cfg.keep_checkpoints, async_write=False,
            )
        return params, opt_state, history
