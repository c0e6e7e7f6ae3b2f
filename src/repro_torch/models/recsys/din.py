"""DIN — Deep Interest Network (Zhou et al., arXiv:1706.06978), a port of
``repro.models.recsys.din``.

Target attention over the user behavior sequence:

  a_t  = MLP([h_t, e_tgt, h_t - e_tgt, h_t ⊙ e_tgt])   (attn MLP 80-40-1)
  u    = Σ_t a_t · h_t                                   (masked by hist len)
  ŷ    = MLP([u, e_tgt, dense])                          (DNN 200-80-1)

Entry points:

  * ``loss_fn``          — BCE training step input (``train_batch``)
  * ``score``            — pointwise CTR scoring (``serve_p99`` / ``serve_bulk``)
  * ``score_candidates`` — one user against ``n_candidates`` items, fully
    batched (``retrieval_cand``): the candidate axis becomes the batch axis
    of the same attention + MLP stack (``expand``); no loops.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.models.common import ParamSpec, dot
from repro_torch.models.recsys.embedding import lookup, table_spec


@dataclasses.dataclass(frozen=True)
class DINConfig:
    embed_dim: int = 18
    seq_len: int = 100
    attn_mlp: Tuple[int, ...] = (80, 40)
    mlp: Tuple[int, ...] = (200, 80)
    n_items: int = 10_000_000
    n_cats: int = 10_000
    d_dense: int = 8  # user/context dense features
    interaction: str = "target-attn"

    @property
    def d_emb(self) -> int:
        return 2 * self.embed_dim  # item ⊕ category


def param_specs(cfg: DINConfig) -> Dict[str, ParamSpec]:
    de = cfg.d_emb
    f32 = torch.float32
    specs: Dict[str, ParamSpec] = {
        "item_table": table_spec(cfg.n_items, cfg.embed_dim),
        "cat_table": table_spec(cfg.n_cats, cfg.embed_dim),
    }
    dims_a = [4 * de] + list(cfg.attn_mlp) + [1]
    for i in range(len(dims_a) - 1):
        specs[f"attn_w{i}"] = ParamSpec((dims_a[i], dims_a[i + 1]), (None, None), f32)
        specs[f"attn_b{i}"] = ParamSpec((dims_a[i + 1],), (None,), f32, init="zeros")
    dims_m = [2 * de + cfg.d_dense] + list(cfg.mlp) + [1]
    for i in range(len(dims_m) - 1):
        specs[f"mlp_w{i}"] = ParamSpec((dims_m[i], dims_m[i + 1]), (None, None), f32)
        specs[f"mlp_b{i}"] = ParamSpec((dims_m[i + 1],), (None,), f32, init="zeros")
    return specs


def _dice(x):  # PReLU-ish smooth activation used by DIN; sigmoid-gated here
    return x * torch.sigmoid(x)


def _mlp(params, prefix: str, n: int, x: torch.Tensor) -> torch.Tensor:
    for i in range(n):
        x = dot(x, params[f"{prefix}_w{i}"]) + params[f"{prefix}_b{i}"]
        if i < n - 1:
            x = _dice(x)
    return x


def _embed_pairs(params, cfg: DINConfig, item_ids: torch.Tensor,
                 cat_ids: torch.Tensor) -> torch.Tensor:
    return torch.cat([lookup(params["item_table"], item_ids),
                      lookup(params["cat_table"], cat_ids)], dim=-1)


def interest(
    params, cfg: DINConfig,
    hist: torch.Tensor,  # [B, L, 2*embed_dim] embedded history
    target: torch.Tensor,  # [B, 2*embed_dim]
    hist_len: torch.Tensor,  # [B]
) -> torch.Tensor:
    """Target attention pooling over the behavior sequence."""
    b, l, de = hist.shape
    tgt = target[:, None, :].expand(b, l, de)
    ain = torch.cat([hist, tgt, hist - tgt, hist * tgt], dim=-1)
    n_attn = len(cfg.attn_mlp) + 1
    logits = _mlp(params, "attn", n_attn, ain.reshape(b * l, -1)).reshape(b, l)
    mask = torch.arange(l, device=hist.device)[None, :] < hist_len[:, None]
    # DIN uses un-normalized sigmoid-free weights with masking (paper §4.3);
    # the weights stay softmax-free, with the padding zeroed.
    w = torch.where(mask, logits, 0.0)
    return torch.einsum("bl,bld->bd", w, hist)


def score(params, cfg: DINConfig, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """CTR logits for (user history, target item) pairs.  Batch keys:
    hist_items/hist_cats [B, L], hist_len [B], target_item/target_cat [B],
    dense [B, d_dense]."""
    hist = _embed_pairs(params, cfg, batch["hist_items"], batch["hist_cats"])
    tgt = _embed_pairs(params, cfg, batch["target_item"], batch["target_cat"])
    u = interest(params, cfg, hist, tgt, batch["hist_len"])
    x = torch.cat([u, tgt, batch["dense"]], dim=-1)
    n_mlp = len(cfg.mlp) + 1
    return _mlp(params, "mlp", n_mlp, x)[:, 0]


def loss_fn(params, cfg: DINConfig, batch):
    """Mean binary cross entropy of the click labels, in its stable form."""
    logits = score(params, cfg, batch)
    y = batch["click"].float()
    loss = (logits.clamp_min(0) - logits * y + torch.log1p(torch.exp(-logits.abs()))).mean()
    return loss, {"loss": loss}


def score_candidates(params, cfg: DINConfig, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Retrieval scoring: one user, ``n_candidates`` target items.

    Batch keys: hist_items/hist_cats [1, L], hist_len [1], cand_items [Nc],
    cand_cats [Nc], dense [1, d_dense].  Returns scores [Nc].
    """
    nc = batch["cand_items"].shape[0]
    wide = {
        "hist_items": batch["hist_items"].expand(nc, cfg.seq_len),
        "hist_cats": batch["hist_cats"].expand(nc, cfg.seq_len),
        "hist_len": batch["hist_len"].expand(nc),
        "target_item": batch["cand_items"],
        "target_cat": batch["cand_cats"],
        "dense": batch["dense"].expand(nc, cfg.d_dense),
    }
    return score(params, cfg, wide)
