"""Attention: GQA + RoPE, a port of ``repro.models.attention``.

- :func:`decode_attention` — one query token against the KV cache, grouped
  (the cache is not expanded to every head), plain PyTorch as in ``repro``;
- :func:`blockwise_attention` — the KV sequence in blocks with an
  online-softmax carry ``(m, l, acc)`` in fp32, K/V expanded to the full
  head count.  It is the plain form of every attention with more than one
  query; the LM prefill (`repro_torch.models.transformer`) runs the same
  function through K9 ``flash_attention`` instead, and the tests hold the
  two against each other;
- :func:`windowed_attention` — causal sliding-window attention in query
  chunks, each over its ``window + q_chunk`` neighbourhood of a left-padded
  K/V, plain PyTorch as in ``repro`` (which has no Pallas kernel for it);
- :func:`apply_rope` — rotary embedding in fp32.

``repro``'s sharding hints (``constraint``) have no meaning on one card and
are dropped; its ``jax.checkpoint`` around each block step (recompute in
the backward pass) has no counterpart, since the port serves and does not
train.
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


def windowed_attention(
    q: torch.Tensor,  # [B, S, H, dh]  (self-attention over the same sequence)
    k: torch.Tensor,  # [B, S, KH, dh]
    v: torch.Tensor,
    *,
    window: int,
    q_chunk: int = 1024,
) -> torch.Tensor:
    """Causal sliding-window attention, O(S · window): query ``i`` sees the
    keys at positions ``i - window`` to ``i``.  Query chunks of ``q_chunk``
    (which must divide S) each attend their ``window + q_chunk``
    neighbourhood of K/V left-padded with ``min(window, S)`` zero rows,
    under the three-part mask (causal, inside the window, not padding);
    softmax in fp32.  Returns [B, S, H, dh] in q's dtype."""
    b, s, h, dh = q.shape
    g = h // k.shape[2]
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    cq = min(q_chunk, s)
    if s % cq:
        raise ValueError(f"q_chunk {cq} does not divide the sequence length {s}")
    win = min(window, s)
    span = win + cq  # kv neighbourhood per query chunk
    scale = 1.0 / dh ** 0.5
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, win, 0))  # left-pad history
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, win, 0))
    out = torch.empty_like(q)
    for start in range(0, s, cq):
        q_c = q[:, start:start + cq].float()
        sc = torch.einsum("bqhd,bkhd->bhqk", q_c, kp[:, start:start + span].float()) * scale
        q_pos = start + torch.arange(cq, device=q.device)
        k_pos = start - win + torch.arange(span, device=q.device)  # global kv positions
        rel = q_pos[:, None] - k_pos[None, :]
        mask = (rel >= 0) & (rel < win + 1) & (k_pos[None, :] >= 0)
        sc = torch.where(mask, sc, torch.tensor(NEG_INF, device=q.device))
        p = torch.softmax(sc, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", p, vp[:, start:start + span].float())
        out[:, start:start + cq] = o.to(q.dtype)
    return out


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
