"""End-to-end training driver on the port (a port of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch minitron-8b --steps 5 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch minitron-8b --steps 20 --ckpt-dir DIR
  PYTHONPATH=src python -m repro_torch.launch.train --arch graphcast --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch sge --device cpu

``--smoke`` (on by default, as in ``repro``) trains the architecture's
reduced ``SMOKE`` config on synthetic token streams; ``--set`` overrides
its fields (`repro_torch.configs.overrides`).  With ``--ckpt-dir`` the loop
checkpoints there and a later run on the same directory resumes from its
newest checkpoint.  It runs on ``--device`` (default: the CUDA card).

``--arch`` resolves through the registry (`repro_torch.configs.registry`;
an unknown id is a ``KeyError``).  An LM id trains as above.  Every other
family runs its architecture's ``smoke(device)`` and prints ``[train] <id>
smoke: {...}``, as ``repro``'s driver does: a GNN or recsys id (``gcn-cora``,
``graphsage-reddit``, ``schnet``, ``graphcast``, ``din``) one train step on
synthetic data, the paper's own ``sge`` an enumeration checked against the
sequential oracle.
"""

from __future__ import annotations

import argparse
import importlib
import sys
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import overrides as ov
from repro_torch.configs import registry
from repro_torch.core.engine import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.trainer import LoopConfig, TrainLoop, make_train_step
from repro_torch.train.tree import tree_map


def lm_data_iterator(cfg: tf.LMConfig, batch: int, seq: int, seed: int = 0,
                     noise: float = 0.1, device=None):
    """Synthetic LM batches: per-sequence affine progressions with
    ``noise``-fraction corruption — structured enough that next-token loss
    demonstrably falls, noisy enough to be non-trivial.  The numpy stream
    of ``repro``'s for the same seed, as int32 tensors on ``device`` (the
    card by default)."""
    return _lm_batches(cfg.vocab_size, batch, seq, seed, noise, resolve_device(device))


def _lm_batches(v: int, batch: int, seq: int, seed: int, noise: float, device):
    rng = np.random.default_rng(seed)
    while True:
        stride = rng.integers(1, 7, size=(batch, 1))
        phase = rng.integers(0, v, size=(batch, 1))
        t = np.arange(seq + 1)[None, :]
        toks = (phase + stride * t) % v
        flip = rng.random((batch, seq + 1)) < noise
        toks = np.where(flip, rng.integers(0, v, toks.shape), toks)
        toks = torch.from_numpy(toks.astype(np.int32)).to(device)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def train_lm(
    cfg: tf.LMConfig,
    steps: int = 50,
    batch: int = 4,
    seq: int = 64,
    ckpt_dir=None,
    accum: int = 1,
    lr: float = 3e-4,
    log=print,
    device=None,
    seed: int = 0,
):
    """Train ``cfg`` from ``init_params(cfg, seed)`` on
    ``lm_data_iterator(seed=seed)`` for ``steps`` steps; returns (params,
    optimizer state, loss history)."""
    device = resolve_device(device)
    opt_cfg = opt_mod.AdamWConfig(lr=lr, warmup_steps=max(steps // 10, 1),
                                  total_steps=steps)
    params = tf.init_params(cfg, seed, device)
    opt_state = opt_mod.init(params)
    step_fn = make_train_step(lambda p, b: tf.loss_fn(p, cfg, b), opt_cfg, accum_steps=accum)
    loop = TrainLoop(step_fn, LoopConfig(total_steps=steps, checkpoint_every=max(steps // 2, 1),
                                         log_every=max(steps // 10, 1)),
                     ckpt_dir=ckpt_dir, log=log)
    data = lm_data_iterator(cfg, batch * accum if accum > 1 else batch, seq, seed=seed,
                            device=device)
    if accum > 1:
        base = data

        def reshaped():
            for b in base:
                yield tree_map(lambda x: x.reshape(accum, batch, *x.shape[1:]), b)

        data = reshaped()
    return loop.run(params, opt_state, data)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="config override, e.g. --set n_layers=4 --set moe.top_k=2")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)

    arch = registry.get(args.arch)
    if arch.family != "lm":  # a train step on synthetic data, or sge's enumeration
        out = arch.smoke(device=args.device)
        print(f"[train] {args.arch} smoke: {out}")
        return 0
    mod = importlib.import_module(f"repro_torch.configs.{args.arch.replace('-', '_')}")
    cfg = mod.SMOKE if args.smoke else mod.CFG
    cfg = ov.apply(cfg, args.overrides)
    _, _, history = train_lm(cfg, steps=args.steps, ckpt_dir=args.ckpt_dir, accum=args.accum,
                             device=args.device)
    improved = history[-1] < history[0]
    print(f"[train] {args.arch}: loss {history[0]:.3f} -> {history[-1]:.3f} "
          f"({'improved' if improved else 'NOT improved'})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
