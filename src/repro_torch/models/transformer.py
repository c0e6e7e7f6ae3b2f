"""Decoder-only LM transformer: GQA + RoPE + a dense or MoE FFN (a port of
``repro.models.transformer``), for all five LM configurations of
`repro_torch.configs`.

Entry points:
  * ``init_params(cfg, seed, device)``                → parameter dict
  * ``abstract_params(cfg)`` / ``param_logical(cfg)``  → meta tensors / logical axes
  * ``params_from_numpy(tree, device, dtype)``        → parameter dict
  * ``empty_cache(cfg, batch, max_len, device)``      → zero KV cache
  * ``forward(params, cfg, tokens)``                  → final hidden states
  * ``lm_loss(hidden, head, labels, chunk)``          → (mean loss, token count)
  * ``loss_fn(params, cfg, batch)``                   → (loss, metrics)
  * ``prefill(params, cfg, tokens, max_len)``         → (last-pos logits, KV cache)
  * ``decode_step(params, cfg, cache, tokens, pos)``  → (logits, cache)

Parameters are a dict in ``repro``'s tree layout: ``embed`` [V, d],
``layers`` (``g1``, ``g2``, ``wq`` [L, d, H, dh], ``wk`` / ``wv`` [L, d, KH,
dh], ``wo`` [L, H, dh, d]; dense: ``w_up``, ``w_down`` and, for ``swiglu``,
``w_gate``; MoE: ``router`` [L, d, E] in fp32 whatever ``cfg.dtype`` is,
``we_gate`` / ``we_up`` [L, E, d, F], ``we_down`` [L, E, F, d] and, with
shared experts, ``ws_gate`` / ``ws_up`` [L, d, S·F], ``ws_down``; the layer
axis first), ``final_norm`` and ``lm_head`` [d, V].
``repro`` scans the layers with ``lax.scan``; here a Python loop walks
them.  Its sharding hints (``constraint``, ``_gather_w``) have no meaning on
one card and are dropped.  Under ``cfg.remat``, a ``forward`` that records
gradients checkpoints each layer (``repro``'s ``jax.checkpoint`` with
``nothing_saveable``): the backward recomputes the layer from its input.
Both this and ``lm_loss``'s chunks use the non-reentrant
``torch.utils.checkpoint``, which fails on a recomputation whose saved
tensors differ in shape from the first pass's (a MoE layer's dispatch runs
again there and keeps the same pairs from the same input).

A MoE layer runs `repro_torch.models.moe.moe_ffn` (plus the shared
experts' SwiGLU) and adds its aux loss, which ``forward`` returns summed
over the layers.

The prefill's self-attention (a zero cache, ``cache_len == 0``, more than
one token, no window) is causal attention over the prompt's own K/V, which
is what K9 computes: it goes through ``ops.flash_attention`` on ``[B·H, S,
dh]`` with K/V expanded to H heads.  A decode step (one token) goes
through the plain grouped `repro_torch.models.attention.decode_attention`,
as in ``repro``.  The KV cache is updated in place: ``prefill`` fills a new
cache, ``decode_step`` writes its token into the cache it is given and
returns that same cache (``repro`` returns a new one).

Sliding-window attention (``attn_window > 0``) is routed as ``repro``
routes it: ``forward`` (no cache) runs the plain
`repro_torch.models.attention.windowed_attention`; ``prefill`` and
``decode_step`` attend over the cache with full causal attention, as
``repro``'s do, and a windowed config's prefill takes the plain
``blockwise_attention`` rather than K9.

Constructors take the card unless given ``device``; ``prefill`` and
``decode_step`` run where the parameters are.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.engine import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import moe as moe_mod
from repro_torch.models.attention import apply_rope, blockwise_attention, windowed_attention
from repro_torch.models.common import (  # noqa: F401  (params_from_numpy: kept under this name)
    ACTIVATIONS,
    ParamSpec,
    abstract_from_specs,
    dot,
    logical_from_specs,
    map_specs,
    params_from_numpy,
    rms_norm,
)

Cache = Tuple[torch.Tensor, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """``repro``'s LMConfig, field for field; ``dtype`` is a torch dtype."""

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0  # 0 -> d_model // n_heads
    activation: str = "swiglu"  # swiglu | gelu | squared_relu | silu | relu
    moe: Optional[moe_mod.MoEConfig] = None
    rope_theta: float = 10000.0
    max_seq_len: int = 32768
    attn_window: int = 0  # > 0: sliding-window attention in ``forward``
    dtype: torch.dtype = torch.bfloat16
    loss_chunk: int = 2048  # tokens per fp32 logits chunk in ``lm_loss``
    kv_block: int = 1024
    remat: bool = True  # checkpoint each layer when training
    aux_loss_weight: float = 0.01  # MoE load-balance loss, per layer

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def gated(self) -> bool:
        return self.activation == "swiglu"

    def _attn_params(self) -> int:
        d, h, kh, dh = self.d_model, self.n_heads, self.n_kv_heads, self.head_dim
        return d * h * dh + 2 * d * kh * dh + h * dh * d

    def param_count(self) -> int:
        """Total parameters, as ``repro`` counts them."""
        d = self.d_model
        if self.moe:
            m = self.moe
            ffn = d * m.n_experts + 3 * (m.n_experts + m.n_shared_experts) * d * m.d_ff_expert
        else:
            ffn = (3 if self.gated else 2) * d * self.d_ff
        per_layer = self._attn_params() + ffn + 2 * d
        return self.n_layers * per_layer + 2 * self.vocab_size * d + d

    def active_param_count(self) -> int:
        """Activated parameters per token (MoE: top-k + shared experts)."""
        if not self.moe:
            return self.param_count()
        d, m = self.d_model, self.moe
        ffn = d * m.n_experts + 3 * (m.top_k + m.n_shared_experts) * d * m.d_ff_expert
        per_layer = self._attn_params() + ffn + 2 * d
        return self.n_layers * per_layer + 2 * self.vocab_size * d + d


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def param_specs(cfg: LMConfig) -> Dict[str, Any]:
    """The parameter tree as ``ParamSpec``s with ``repro``'s logical axes:
    FSDP on the model dims, tensor parallel on heads, ``d_ff`` and the
    vocabulary.  MoE expert weights shard their expert axis from 64 experts
    up; below that (grok-1's 8 do not divide a 16-way model axis) the
    per-expert FFN dim is tensor-sharded instead."""
    d, h, kh, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    n, v, f = cfg.n_layers, cfg.vocab_size, cfg.d_ff
    dt = cfg.dtype
    layers: Dict[str, ParamSpec] = {
        "g1": ParamSpec((n, d), (None, None), dt, init="ones"),
        "g2": ParamSpec((n, d), (None, None), dt, init="ones"),
        "wq": ParamSpec((n, d, h, dh), (None, "fsdp", "tensor", None), dt),
        "wk": ParamSpec((n, d, kh, dh), (None, "fsdp", "tensor", None), dt),
        "wv": ParamSpec((n, d, kh, dh), (None, "fsdp", "tensor", None), dt),
        "wo": ParamSpec((n, h, dh, d), (None, "tensor", None, "fsdp"), dt),
    }
    if cfg.moe:
        e, fe = cfg.moe.n_experts, cfg.moe.d_ff_expert
        if e >= 64:
            log_gate = (None, "expert", "fsdp", None)
            log_down = (None, "expert", None, "fsdp")
        else:
            log_gate = (None, None, "fsdp", "tensor")
            log_down = (None, None, "tensor", "fsdp")
        layers["router"] = ParamSpec((n, d, e), (None, "fsdp", None), torch.float32)
        layers["we_gate"] = ParamSpec((n, e, d, fe), log_gate, dt)
        layers["we_up"] = ParamSpec((n, e, d, fe), log_gate, dt)
        layers["we_down"] = ParamSpec((n, e, fe, d), log_down, dt)
        if cfg.moe.n_shared_experts:
            fs = cfg.moe.n_shared_experts * fe
            layers["ws_gate"] = ParamSpec((n, d, fs), (None, "fsdp", "tensor"), dt)
            layers["ws_up"] = ParamSpec((n, d, fs), (None, "fsdp", "tensor"), dt)
            layers["ws_down"] = ParamSpec((n, fs, d), (None, "tensor", "fsdp"), dt)
    else:
        if cfg.gated:
            layers["w_gate"] = ParamSpec((n, d, f), (None, "fsdp", "tensor"), dt)
        layers["w_up"] = ParamSpec((n, d, f), (None, "fsdp", "tensor"), dt)
        layers["w_down"] = ParamSpec((n, f, d), (None, "tensor", "fsdp"), dt)
    return {
        "embed": ParamSpec((v, d), ("tensor", "fsdp"), dt, scale=1.0),
        "layers": layers,
        "final_norm": ParamSpec((d,), (None,), dt, init="ones"),
        "lm_head": ParamSpec((d, v), ("fsdp", "tensor"), dt),
    }


def abstract_params(cfg: LMConfig):
    """The parameters as ``device="meta"`` tensors (no storage)."""
    return abstract_from_specs(param_specs(cfg))


def param_logical(cfg: LMConfig):
    return logical_from_specs(param_specs(cfg))


def init_params(cfg: LMConfig, seed: int = 0, device=None) -> Dict[str, Any]:
    """Random parameters from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (the card by default), drawn leaf by leaf in the tree's own
    order.  Same distributions as ``repro``'s ``init_params``; not the same
    numbers."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return map_specs(lambda spec: spec.materialize(gen, device), param_specs(cfg))


def empty_cache(cfg: LMConfig, batch: int, max_len: Optional[int] = None,
                device=None) -> Cache:
    """A zero KV cache ``(k, v)``, each [L, B, S_max, KH, dh] in
    ``cfg.dtype``, on ``device`` (the card by default)."""
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len or cfg.max_seq_len, cfg.n_kv_heads, cfg.head_dim)
    return (torch.zeros(shape, dtype=cfg.dtype, device=device),
            torch.zeros(shape, dtype=cfg.dtype, device=device))


def abstract_cache(cfg: LMConfig, batch: int, max_len: Optional[int] = None) -> Cache:
    """:func:`empty_cache`'s shapes as ``device="meta"`` tensors."""
    shape = (cfg.n_layers, batch, max_len or cfg.max_seq_len, cfg.n_kv_heads, cfg.head_dim)
    return (torch.empty(shape, dtype=cfg.dtype, device="meta"),
            torch.empty(shape, dtype=cfg.dtype, device="meta"))


CACHE_LOGICAL = ((None, "batch", "seq", None, None), (None, "batch", "seq", None, None))


def layer_params(params, i: int) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s slice of the stacked layer parameters (views)."""
    return {k: w[i] for k, w in params["layers"].items()}


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _ffn_dense(x: torch.Tensor, lp: Dict[str, torch.Tensor], cfg: LMConfig) -> torch.Tensor:
    if cfg.gated:
        gate = dot(x, lp["w_gate"])
        up = dot(x, lp["w_up"])
        hidden = F.silu(gate.float()).to(x.dtype) * up
    else:
        hidden = ACTIVATIONS[cfg.activation](dot(x, lp["w_up"]).float()).to(x.dtype)
    return dot(hidden, lp["w_down"])


def _ffn_moe(x: torch.Tensor, lp: Dict[str, torch.Tensor],
             cfg: LMConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routed experts (`repro_torch.models.moe.moe_ffn`) plus the shared
    experts' SwiGLU; returns (output [B, S, d], aux loss)."""
    b, s, d = x.shape
    flat = x.reshape(b * s, d)
    out, aux = moe_mod.moe_ffn(flat, lp["router"], lp["we_gate"], lp["we_up"], lp["we_down"],
                               cfg.moe)
    if cfg.moe.n_shared_experts:
        gate = dot(flat, lp["ws_gate"])
        up = dot(flat, lp["ws_up"])
        hidden = F.silu(gate.float()).to(flat.dtype) * up
        out = out + dot(hidden, lp["ws_down"])
    return out.reshape(b, s, d), aux


def _flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal self-attention of [B, S, H, dh] q over [B, S, KH, dh] k / v
    through K9: K/V expanded to H heads, heads folded into the batch."""
    b, s, h, dh = q.shape
    g = h // k.shape[2]
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)

    def fold(x):
        return x.transpose(1, 2).reshape(b * h, s, dh).contiguous()

    out = ops.flash_attention(fold(q), fold(k), fold(v))
    return out.reshape(b, h, s, dh).transpose(1, 2)


def _attention(
    x: torch.Tensor,
    lp: Dict[str, torch.Tensor],
    cfg: LMConfig,
    positions: torch.Tensor,
    cache_kv: Optional[Cache] = None,
    cache_len: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[Cache]]:
    """GQA attention.  With ``cache_kv`` ([B, S_max, KH, dh] each) given,
    writes this call's K/V at ``cache_len`` (in place) and attends over the
    cache; a write past ``S_max`` raises (``repro`` clamps its start)."""
    q = torch.einsum("bsd,dhk->bshk", x, lp["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, lp["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, lp["wv"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    s = q.shape[1]

    new_cache = None
    if cache_kv is not None:
        ck, cv = cache_kv
        start = int(cache_len)
        if not 0 <= start <= ck.shape[1] - s:
            raise ValueError(f"cache of {ck.shape[1]} positions cannot take {s} at {start}")
        ck[:, start:start + s] = k.to(ck.dtype)
        cv[:, start:start + s] = v.to(cv.dtype)
        new_cache = (ck, cv)
        if start == 0 and s > 1 and not cfg.attn_window:
            out = _flash(q, ck[:, :s], cv[:, :s])
        else:
            out = blockwise_attention(q, ck, cv, q_offset=start, kv_valid_len=start + s,
                                      kv_block=cfg.kv_block)
    elif cfg.attn_window and s > 1:
        out = windowed_attention(q, k, v, window=cfg.attn_window,
                                 q_chunk=min(cfg.kv_block, s))
    else:
        out = blockwise_attention(q, k, v, kv_block=cfg.kv_block)
    return torch.einsum("bshk,hkd->bsd", out, lp["wo"]), new_cache


def _layer(cfg: LMConfig, h: torch.Tensor, lp: Dict[str, torch.Tensor],
           positions: torch.Tensor, layer_cache: Optional[Cache] = None,
           cache_len: Optional[int] = None
           ) -> Tuple[torch.Tensor, torch.Tensor, Optional[Cache]]:
    """One pre-norm block: ``h + attn(norm(h))``, then ``+ ffn(norm(h))``.
    Returns the new hidden state, the layer's aux loss (fp32; 0 for a dense
    FFN) and the layer's cache."""
    a, new_cache = _attention(rms_norm(h, lp["g1"]), lp, cfg, positions, layer_cache, cache_len)
    h = h + a
    m = rms_norm(h, lp["g2"])
    if cfg.moe:
        f, aux = _ffn_moe(m, lp, cfg)
    else:
        f, aux = _ffn_dense(m, lp, cfg), torch.zeros((), device=h.device)
    return h + f, aux, new_cache


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _embed(params, cfg: LMConfig, tokens) -> torch.Tensor:
    tokens = torch.as_tensor(tokens, device=params["embed"].device).long()
    return params["embed"][tokens].to(cfg.dtype)


def _logits(params, h: torch.Tensor) -> torch.Tensor:
    """Last-position logits in fp32, [B, V]."""
    h = rms_norm(h, params["final_norm"])
    return h[:, -1].float() @ params["lm_head"].float()


def _train_layer(cfg: LMConfig, h: torch.Tensor, lp: Dict[str, torch.Tensor],
                 positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    h, aux, _ = _layer(cfg, h, lp, positions)
    return h, aux


def forward(params, cfg: LMConfig, tokens, positions: Optional[torch.Tensor] = None):
    """Token ids [B, S] -> (final normed hidden states [B, S, d], aux loss
    summed over the layers, fp32).  Each layer is checkpointed when
    ``cfg.remat`` holds and gradients are being recorded."""
    h = _embed(params, cfg, tokens)
    b, s = h.shape[:2]
    if positions is None:
        positions = torch.arange(s, device=h.device).expand(b, s)
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), device=h.device)
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        if remat:
            h, aux_l = checkpoint(_train_layer, cfg, h, lp, positions, use_reentrant=False)
        else:
            h, aux_l = _train_layer(cfg, h, lp, positions)
        aux = aux + aux_l
    return rms_norm(h, params["final_norm"]), aux


def _loss_chunk(hc: torch.Tensor, yc: torch.Tensor,
                head: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk's summed cross-entropy over its labelled tokens and their
    count, from fp32 logits ``[chunk, V]``."""
    logits = hc.float() @ head.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(1, yc.clamp_min(0)[:, None])[:, 0]
    mask = (yc >= 0).float()
    return ((logz - gold) * mask).sum(), mask.sum()


def lm_loss(hidden: torch.Tensor, head: torch.Tensor, labels,
            chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked cross-entropy: mean over the tokens whose label is not -1,
    and their count (fp32).  Logits are made in fp32 ``chunk`` tokens at a
    time, each chunk checkpointed, so the backward too holds one chunk's
    ``[chunk, V]`` logits at a time; the last chunk is padded with -1
    labels.  ``repro`` takes the gold logit by a masked sum over the vocab
    (for its sharding); the gather here gives the same value."""
    b, s, d = hidden.shape
    t = b * s
    hf = hidden.reshape(t, d)
    yf = torch.as_tensor(labels, device=hidden.device).reshape(t).long()
    chunk = min(chunk, t)
    n_chunks = (t + chunk - 1) // chunk
    pad = n_chunks * chunk - t
    hf = F.pad(hf, (0, 0, 0, pad))
    yf = F.pad(yf, (0, pad), value=-1)
    sums, counts = [], []
    for i in range(0, n_chunks * chunk, chunk):
        total_c, count_c = checkpoint(_loss_chunk, hf[i:i + chunk], yf[i:i + chunk], head,
                                      use_reentrant=False)
        sums.append(total_c)
        counts.append(count_c)
    total, count = torch.stack(sums).sum(), torch.stack(counts).sum()
    return total / count.clamp_min(1.0), count


def loss_fn(params, cfg: LMConfig, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token loss of ``batch`` (``tokens`` and ``labels`` [B, S]) plus,
    for a MoE model, ``aux_loss_weight`` times the load-balance loss per
    layer.  Returns (total, {"lm_loss", "aux_loss", "tokens"})."""
    hidden, aux = forward(params, cfg, batch["tokens"])
    loss, count = lm_loss(hidden, params["lm_head"], batch["labels"], cfg.loss_chunk)
    total = loss + (cfg.aux_loss_weight * aux / cfg.n_layers if cfg.moe else 0.0)
    return total, {"lm_loss": loss, "aux_loss": aux, "tokens": count}


def prefill(params, cfg: LMConfig, tokens, max_len: Optional[int] = None):
    """Full-sequence forward that also fills a new KV cache.

    Returns (last-position logits [B, V] fp32, cache (k, v) each
    [L, B, S_max, KH, dh])."""
    h = _embed(params, cfg, tokens)
    b, s = h.shape[:2]
    cache = empty_cache(cfg, b, max_len, device=h.device)
    positions = torch.arange(s, device=h.device).expand(b, s)
    for i in range(cfg.n_layers):
        h, _, _ = _layer(cfg, h, layer_params(params, i), positions,
                         (cache[0][i], cache[1][i]), 0)
    return _logits(params, h), cache


def decode_step(params, cfg: LMConfig, cache: Cache, tokens, cache_len: int):
    """One incremental decode step.

    Args:
      cache: (k, v) each [L, B, S_max, KH, dh]; written in place.
      tokens: [B, 1] current token ids.
      cache_len: number of valid cache positions (the token's position).

    Returns: (logits [B, V] fp32, the same cache).
    """
    h = _embed(params, cfg, tokens)
    b, s = h.shape[:2]
    cache_len = int(cache_len)
    positions = torch.full((b, s), cache_len, device=h.device)
    for i in range(cfg.n_layers):
        h, _, _ = _layer(cfg, h, layer_params(params, i), positions,
                         (cache[0][i], cache[1][i]), cache_len)
    return _logits(params, h), cache
