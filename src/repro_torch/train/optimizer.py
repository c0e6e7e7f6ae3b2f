"""AdamW with fp32 moments and a warmup + cosine schedule (a port of
``repro.train.optimizer``).

``repro``'s formula: gradients clipped by their fp32 global norm, bias
corrections in fp32, then ``p32 - lr · (m̂ / (√v̂ + eps) + wd · p32)`` cast
back to the parameter's dtype.  ``torch.optim.AdamW`` keeps its moments in
the parameter's dtype and applies the decay in another order, so it is not
used.

:func:`update` works leaf by leaf and in place: the moments and the
parameters are overwritten, and a leaf needs at most two fp32 temporaries
of its size (minitron-8b's embedding alone is 1.05 B parameters, 4.2 GB per
fp32 copy).  :func:`abstract_state` gives the state of a tree of
``device="meta"`` parameters as meta tensors (the registry's cells), and
:func:`state_logical` its logical axes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.train.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor  # 0-d int32
    mu: Any  # tree like params, fp32
    nu: Any  # tree like params, fp32


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_ratio * lr`` (fp32)."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init(params) -> AdamWState:
    """Zero fp32 moments beside each parameter, step 0."""
    first = leaves(params)[0]
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=first.device),
                      mu=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                        device=p.device), params),
                      nu=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                        device=p.device), params))


def abstract_state(abstract_params) -> AdamWState:
    """:func:`init`'s state as ``device="meta"`` tensors: a 0-d int32 step
    and fp32 moments of the parameters' shapes."""
    def moments():
        return tree_map(lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta"),
                        abstract_params)

    return AdamWState(step=torch.empty((), dtype=torch.int32, device="meta"),
                      mu=moments(), nu=moments())


def state_logical(param_logical) -> AdamWState:
    """The moments share the parameters' logical axes."""
    return AdamWState(step=(), mu=param_logical, nu=param_logical)


def global_norm(tree) -> torch.Tensor:
    """The fp32 L2 norm of every leaf together."""
    return torch.sqrt(sum(x.to(torch.float32, copy=True).square_().sum() for x in leaves(tree)))


def update(cfg: AdamWConfig, grads, state: AdamWState,
           params) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step, in place: ``params`` and ``state``'s moments are
    overwritten.  Returns (params, the new state, {"grad_norm", "lr"})."""
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / gnorm.clamp_min(1e-9), max=1.0)
             if cfg.grad_clip else torch.ones((), device=gnorm.device))
    step = state.step + 1
    lr = schedule(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.mu), leaves(state.nu)):
        t1 = g.to(torch.float32, copy=True).mul_(scale)  # the clipped fp32 gradient
        m.mul_(cfg.b1).add_(t1, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(t1, t1, value=1 - cfg.b2)
        denom = torch.div(v, b2c, out=t1).sqrt_().add_(cfg.eps)
        t2 = torch.div(m, b1c).div_(denom)  # m̂ / (√v̂ + eps)
        p32 = t1.copy_(p)
        t2.add_(p32, alpha=cfg.weight_decay).mul_(lr)
        p.copy_(p32.sub_(t2))
        del t1, t2, denom, p32
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu), {"grad_norm": gnorm, "lr": lr}
