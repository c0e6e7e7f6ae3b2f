"""Shared cell builders for the five LM architectures (a port of
``repro.configs.lm_common``).

Shapes:
  * ``train_4k``    seq 4,096 × global batch 256   → full train step
                    (grad + clip + AdamW)
  * ``prefill_32k`` seq 32,768 × batch 32          → prefill (logits + KV cache)
  * ``decode_32k``  KV 32,768 × batch 128          → one-token decode step
  * ``long_500k``   seq 524,288 × batch 1          → skipped by every assigned
                    LM: each is pure full attention

MODEL_FLOPS convention: 6·N_active·tokens for training, 2·N_active·tokens for
inference, with N_active excluding the input embedding table (its lookup is a
gather, not a matmul) but including the LM head.
"""

from __future__ import annotations

import functools
import math
from typing import Dict

import torch

from repro_torch.configs import registry
from repro_torch.configs.registry import Arch, Cell, CellBuild
from repro_torch.core.engine import resolve_device
from repro_torch.data import graphgen
from repro_torch.models import transformer as tf
from repro_torch.models.transformer import LMConfig
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.trainer import make_train_step

TRAIN_SHAPE = dict(seq=4096, batch=256)
PREFILL_SHAPE = dict(seq=32768, batch=32)
DECODE_SHAPE = dict(seq=32768, batch=128)
LONG_SHAPE = dict(seq=524288, batch=1)

OPT = opt_mod.AdamWConfig(lr=3e-4, total_steps=100000)

LONG_SKIP = ("pure full-attention arch; long_500k requires "
             "sub-quadratic attention (skip per brief; see DESIGN.md §4 and "
             "the opt-in sliding-window variant in EXPERIMENTS.md §Beyond)")


def n_active(cfg: LMConfig) -> int:
    """Parameters a token activates, less the input embedding table."""
    return cfg.active_param_count() - cfg.vocab_size * cfg.d_model


def _meta_tokens(batch: int, seq: int) -> torch.Tensor:
    return torch.empty((batch, seq), dtype=torch.int32, device="meta")


def _batch_abstract(batch: int, seq: int):
    args = {"tokens": _meta_tokens(batch, seq), "labels": _meta_tokens(batch, seq)}
    logical = {"tokens": ("batch", None), "labels": ("batch", None)}
    return args, logical


def _lm_loss(cfg, params, batch):
    return tf.loss_fn(params, cfg, batch)


def build_train(cfg: LMConfig, batch: int, seq: int) -> CellBuild:
    step = make_train_step(functools.partial(_lm_loss, cfg), OPT)
    p_abs = tf.abstract_params(cfg)
    p_log = tf.param_logical(cfg)
    b_abs, b_log = _batch_abstract(batch, seq)
    return CellBuild(
        fn=step,
        args=(p_abs, opt_mod.abstract_state(p_abs), b_abs),
        logical=(p_log, opt_mod.state_logical(p_log), b_log),
        model_flops=6.0 * n_active(cfg) * batch * seq,
        donate=(0, 1),
    )


def build_prefill(cfg: LMConfig, batch: int, seq: int) -> CellBuild:
    def step(params, tokens):
        return tf.prefill(params, cfg, tokens, max_len=seq)

    return CellBuild(
        fn=step,
        args=(tf.abstract_params(cfg), _meta_tokens(batch, seq)),
        logical=(tf.param_logical(cfg), ("batch", None)),
        model_flops=2.0 * n_active(cfg) * batch * seq,
    )


def build_decode(cfg: LMConfig, batch: int, seq: int) -> CellBuild:
    def step(params, cache, tokens, cache_len):
        return tf.decode_step(params, cfg, cache, tokens, cache_len)

    return CellBuild(
        fn=step,
        args=(tf.abstract_params(cfg), tf.abstract_cache(cfg, batch, seq),
              _meta_tokens(batch, 1), torch.empty((), dtype=torch.int32, device="meta")),
        logical=(tf.param_logical(cfg), tf.CACHE_LOGICAL, ("batch", None), ()),
        model_flops=2.0 * n_active(cfg) * batch,
        donate=(1,),
    )


def make_lm_arch(cfg: LMConfig, smoke_cfg: LMConfig, notes: str = "") -> Arch:
    name = cfg.name
    cells = {
        "train_4k": Cell(name, "train_4k", "train",
                         lambda: build_train(cfg, **TRAIN_SHAPE)),
        "prefill_32k": Cell(name, "prefill_32k", "prefill",
                            lambda: build_prefill(cfg, **PREFILL_SHAPE)),
        "decode_32k": Cell(name, "decode_32k", "decode",
                           lambda: build_decode(cfg, **DECODE_SHAPE)),
        "long_500k": Cell(name, "long_500k", "decode", None, skip_reason=LONG_SKIP),
    }
    return registry.register(Arch(
        name=name, family="lm", cfg=cfg, cells=cells,
        smoke=functools.partial(lm_smoke, smoke_cfg), notes=notes,
    ))


def lm_smoke(cfg: LMConfig, device=None) -> Dict[str, float]:
    """One train step of ``cfg`` on 2 × 16 random tokens, then a prefill
    and a decode step on the updated parameters, on ``device`` (the card by
    default); asserts finite results of the expected shapes."""
    device = resolve_device(device)
    params = tf.init_params(cfg, 0, device)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in graphgen.lm_batch(2, 16, cfg.vocab_size, seed=0).items()}
    step = make_train_step(functools.partial(_lm_loss, cfg), OPT)
    params, _, metrics = step(params, opt_mod.init(params), batch)
    loss = float(metrics["loss_total"])
    assert math.isfinite(loss), f"non-finite loss {loss}"
    with torch.no_grad():
        logits, cache = tf.prefill(params, cfg, batch["tokens"], max_len=32)
        assert logits.shape == (2, cfg.vocab_size)
        lg, _ = tf.decode_step(params, cfg, cache, batch["tokens"][:, :1], 16)
    assert lg.shape == (2, cfg.vocab_size)
    assert bool(torch.isfinite(lg).all())
    return {"loss": loss}
