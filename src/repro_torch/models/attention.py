"""Attention: GQA + RoPE, a port of ``repro.models.attention``.

- :func:`decode_attention` — one query token against the KV cache, grouped
  (the cache is not expanded to every head), plain PyTorch as in ``repro``;
- :func:`blockwise_attention` — the KV sequence in blocks with an
  online-softmax carry ``(m, l, acc)`` in fp32, K/V expanded to the full
  head count.  It is the plain form of every attention with more than one
  query; the LM prefill (`repro_torch.models.transformer`) runs the same
  function through K9 ``flash_attention`` instead, and the tests hold the
  two against each other;
- :func:`apply_rope` — rotary embedding in fp32.

``repro``'s sharding hints (``constraint``) have no meaning on one card and
are dropped; its ``jax.checkpoint`` around each block step (recompute in
the backward pass) has no counterpart, since the port serves and does not
train.  Sliding-window attention is not ported yet
(:func:`windowed_attention` raises).
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def rope_freqs(d_head: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32, device=device)
                            / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding.  x: [B, S, H, dh]; positions: [B, S] int."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)  # [dh/2]
    ang = positions[..., None].float() * freqs  # [B, S, dh/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_offset: int,
                     kv_valid_len: int) -> torch.Tensor:
    """Grouped attention of ``q`` [B, 1, H, dh] over the cache ``k`` / ``v``
    [B, S_kv, KH, dh]: key positions ``t <= q_offset`` and ``t <
    kv_valid_len`` count.  Returns [B, 1, H, dh] in q's dtype."""
    b, s, h, dh = q.shape
    s_kv, kh = k.shape[1], k.shape[2]
    qg = q.reshape(b, s, kh, h // kh, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * (1.0 / dh ** 0.5)
    kv_pos = torch.arange(s_kv, device=q.device)
    mask = (kv_pos <= q_offset) & (kv_pos < kv_valid_len)
    scores = torch.where(mask, scores, torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return out.reshape(b, s, h, dh).to(q.dtype)


def windowed_attention(q, k, v, *, window: int, q_chunk: int = 1024):
    """Sliding-window attention (``LMConfig.attn_window > 0``): not ported."""
    raise NotImplementedError(
        "windowed_attention (attn_window > 0) is not ported yet: ROADMAP Queue 1 item 14")


def blockwise_attention(
    q: torch.Tensor,  # [B, S, H, dh]
    k: torch.Tensor,  # [B, S_kv, KH, dh]
    v: torch.Tensor,  # [B, S_kv, KH, dh]
    *,
    q_offset: int = 0,
    kv_valid_len: Optional[int] = None,  # keys at positions >= this are masked
    kv_block: int = 1024,
) -> torch.Tensor:
    """Grouped-query causal attention in KV blocks; returns [B, S, H, dh].

    Query ``i`` sits at position ``q_offset + i`` and sees keys at positions
    up to its own.  A single query goes to :func:`decode_attention`."""
    b, s, h, dh = q.shape
    s_kv, kh = k.shape[1], k.shape[2]
    valid_len = s_kv if kv_valid_len is None else int(kv_valid_len)
    if s == 1:
        return decode_attention(q, k, v, int(q_offset), valid_len)
    g = h // kh
    if g > 1:  # expand KV to the full head count, as repro does
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    scale = 1.0 / dh ** 0.5
    qh = q.transpose(1, 2).float()  # [B, H, S, dh]
    q_pos = int(q_offset) + torch.arange(s, device=q.device)
    m = torch.full((b, h, s), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, s, dh), dtype=torch.float32, device=q.device)
    kb = min(kv_block, s_kv)
    for start in range(0, s_kv, kb):
        kx = k[:, start:start + kb].transpose(1, 2).float()  # [B, H, kb, dh]
        vx = v[:, start:start + kb].transpose(1, 2).float()
        kv_pos = torch.arange(start, start + kx.shape[2], device=q.device)
        kv_pos = torch.where(kv_pos < valid_len, kv_pos, 2**30)  # masked = "future"
        sc = torch.einsum("bhqd,bhkd->bhqk", qh, kx) * scale
        sc = torch.where(q_pos[:, None] >= kv_pos[None, :], sc,
                         torch.tensor(NEG_INF, device=q.device))
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vx)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)
