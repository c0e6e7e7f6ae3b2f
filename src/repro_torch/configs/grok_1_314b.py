"""grok-1-314b — 64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072,
MoE 8 experts top-2.  [hf:xai-org/grok-1; unverified]

The numbers of ``repro.configs.grok_1_314b`` (``CFG`` and the CPU-sized
``SMOKE``) and its ``ARCH``, the registry's four cells.
"""

from repro_torch.configs.lm_common import make_lm_arch
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

CFG = LMConfig(
    name="grok-1-314b",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    activation="swiglu",
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32768),
    loss_chunk=65536,
    max_seq_len=32768,
)

SMOKE = LMConfig(
    name="grok-1-314b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    activation="swiglu",
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128, capacity_round=8),
    loss_chunk=16,
    max_seq_len=64,
    kv_block=8,
)

ARCH = make_lm_arch(CFG, SMOKE, notes="MoE 8e top-2; paper technique N/A "
                    "(dense regular compute); dispatch shares the scheduler's "
                    "coalesce-then-rebalance shape (DESIGN.md §4).")
