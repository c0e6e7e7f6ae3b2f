"""din — embed_dim=18 seq_len=100 attn_mlp=80-40 mlp=200-80
interaction=target-attn.  [arXiv:1706.06978; paper]

Shapes:
  * ``train_batch``    batch 65,536       — BCE train step (grad + AdamW)
  * ``serve_p99``      batch 512          — online CTR scoring
  * ``serve_bulk``     batch 262,144      — offline scoring
  * ``retrieval_cand`` 1 × 1,000,000      — one user vs 1M candidates,
                       fully batched target attention (+ top-1000)

Embedding tables: 10M items / 10k categories.  ``ARCH`` registers the four
cells; their abstract parameters and batches are ``device="meta"`` tensors.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch.configs import registry
from repro_torch.configs.registry import Arch, Cell, CellBuild
from repro_torch.core.engine import resolve_device
from repro_torch.data import graphgen
from repro_torch.models.common import abstract_from_specs, init_from_specs, logical_from_specs
from repro_torch.models.recsys import din as din_mod
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.trainer import make_train_step

CFG = din_mod.DINConfig(
    embed_dim=18, seq_len=100, attn_mlp=(80, 40), mlp=(200, 80),
    n_items=10_000_000, n_cats=10_000, d_dense=8,
)
SMOKE_CFG = din_mod.DINConfig(
    embed_dim=8, seq_len=10, attn_mlp=(16, 8), mlp=(32, 16),
    n_items=1000, n_cats=50, d_dense=8,
)
OPT = opt_mod.AdamWConfig(lr=1e-3, total_steps=100000)

I32 = torch.int32
F32 = torch.float32


def _score_flops(cfg: din_mod.DINConfig, batch: int) -> float:
    de = cfg.d_emb
    dims_a = [4 * de] + list(cfg.attn_mlp) + [1]
    attn = sum(2.0 * dims_a[i] * dims_a[i + 1] for i in range(len(dims_a) - 1))
    dims_m = [2 * de + cfg.d_dense] + list(cfg.mlp) + [1]
    mlp = sum(2.0 * dims_m[i] * dims_m[i + 1] for i in range(len(dims_m) - 1))
    return batch * (cfg.seq_len * attn + 2.0 * cfg.seq_len * de + mlp)


def _batch_abstract(cfg: din_mod.DINConfig, b: int):
    args = registry.abstract_dict({
        "hist_items": ((b, cfg.seq_len), I32),
        "hist_cats": ((b, cfg.seq_len), I32),
        "hist_len": ((b,), I32),
        "target_item": ((b,), I32),
        "target_cat": ((b,), I32),
        "dense": ((b, cfg.d_dense), F32),
        "click": ((b,), I32),
    })
    logical = {
        "hist_items": ("batch", None), "hist_cats": ("batch", None),
        "hist_len": ("batch",), "target_item": ("batch",),
        "target_cat": ("batch",), "dense": ("batch", None), "click": ("batch",),
    }
    return args, logical


def _params_abstract(cfg: din_mod.DINConfig):
    specs = din_mod.param_specs(cfg)
    return abstract_from_specs(specs), logical_from_specs(specs)


def build_train(cfg: din_mod.DINConfig, batch: int) -> CellBuild:
    p_abs, p_log = _params_abstract(cfg)
    b_abs, b_log = _batch_abstract(cfg, batch)
    step = make_train_step(lambda p, b: din_mod.loss_fn(p, cfg, b), OPT)
    return CellBuild(
        fn=step, args=(p_abs, opt_mod.abstract_state(p_abs), b_abs),
        logical=(p_log, opt_mod.state_logical(p_log), b_log),
        model_flops=3.0 * _score_flops(cfg, batch), donate=(0, 1),
    )


def build_serve(cfg: din_mod.DINConfig, batch: int) -> CellBuild:
    p_abs, p_log = _params_abstract(cfg)
    b_abs, b_log = _batch_abstract(cfg, batch)
    b_abs.pop("click")
    b_log.pop("click")

    def step(params, batch):
        return din_mod.score(params, cfg, batch)

    return CellBuild(fn=step, args=(p_abs, b_abs), logical=(p_log, b_log),
                     model_flops=_score_flops(cfg, batch))


def build_retrieval(cfg: din_mod.DINConfig, n_cand: int) -> CellBuild:
    """One user against ``n_cand`` candidates, then the top 1,000 scores
    (``torch.topk``: values and indices, largest first)."""
    p_abs, p_log = _params_abstract(cfg)
    b_abs = registry.abstract_dict({
        "hist_items": ((1, cfg.seq_len), I32),
        "hist_cats": ((1, cfg.seq_len), I32),
        "hist_len": ((1,), I32),
        "cand_items": ((n_cand,), I32),
        "cand_cats": ((n_cand,), I32),
        "dense": ((1, cfg.d_dense), F32),
    })
    b_log = {
        "hist_items": (None, None), "hist_cats": (None, None), "hist_len": (None,),
        "cand_items": ("batch",), "cand_cats": ("batch",), "dense": (None, None),
    }

    def step(params, batch):
        return torch.topk(din_mod.score_candidates(params, cfg, batch), 1000)

    return CellBuild(fn=step, args=(p_abs, b_abs), logical=(p_log, b_log),
                     model_flops=_score_flops(cfg, n_cand))


def batch_tensors(cfg: din_mod.DINConfig, batch: int, seed: int = 0,
                  device=None) -> Dict[str, torch.Tensor]:
    """``graphgen.din_batch`` for ``cfg`` as tensors on ``device`` (the card
    by default)."""
    device = resolve_device(device)
    arrays = graphgen.din_batch(batch, cfg.seq_len, cfg.n_items, cfg.n_cats, cfg.d_dense,
                                seed=seed)
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def smoke(device=None) -> Dict[str, float]:
    """One train step (``OPT``) of ``SMOKE_CFG`` on 8 rows, then ``score``
    and ``score_candidates`` over 256 candidates on the updated parameters,
    on ``device`` (the card by default); asserts finite results."""
    device = resolve_device(device)
    cfg = SMOKE_CFG
    params = init_from_specs(din_mod.param_specs(cfg), 0, device)
    batch = batch_tensors(cfg, 8, device=device)
    step = make_train_step(lambda p, b: din_mod.loss_fn(p, cfg, b), OPT)
    params, _, metrics = step(params, opt_mod.init(params), batch)
    lv = float(metrics["loss_total"])
    assert math.isfinite(lv)
    with torch.no_grad():
        scores = din_mod.score(params, cfg, batch)
        assert scores.shape == (8,) and bool(torch.isfinite(scores).all())
        cand = {
            "hist_items": batch["hist_items"][:1], "hist_cats": batch["hist_cats"][:1],
            "hist_len": batch["hist_len"][:1],
            "cand_items": torch.arange(256, dtype=torch.int32, device=device) % cfg.n_items,
            "cand_cats": torch.arange(256, dtype=torch.int32, device=device) % cfg.n_cats,
            "dense": batch["dense"][:1],
        }
        s = din_mod.score_candidates(params, cfg, cand)
    assert s.shape == (256,) and bool(torch.isfinite(s).all())
    return {"loss": lv}


ARCH = registry.register(
    Arch(
        name="din",
        family="recsys",
        cfg=CFG,
        cells={
            "train_batch": Cell("din", "train_batch", "train",
                                lambda: build_train(CFG, 65536)),
            "serve_p99": Cell("din", "serve_p99", "serve",
                              lambda: build_serve(CFG, 512)),
            "serve_bulk": Cell("din", "serve_bulk", "serve",
                               lambda: build_serve(CFG, 262144)),
            "retrieval_cand": Cell("din", "retrieval_cand", "retrieval",
                                   lambda: build_retrieval(CFG, 1_000_000)),
        },
        smoke=smoke,
        notes="Embedding-bag substrate (take + segment_sum); paper technique "
        "N/A to the model math; the LPT bucket balancer shards skewed "
        "serve_bulk batches host-side (DESIGN.md §4).",
    )
)
