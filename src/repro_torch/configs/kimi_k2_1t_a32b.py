"""kimi-k2-1t-a32b — 61L d_model=7168 64H (GQA kv=8) d_ff=2048 (per expert)
vocab=163840, MoE 384 experts top-8 (+1 shared).  [arXiv:2501.kimi2; unverified]

The numbers of ``repro.configs.kimi_k2_1t_a32b`` (``CFG`` and the CPU-sized
``SMOKE``) and its ``ARCH``, the registry's four cells.
"""

from repro_torch.configs.lm_common import make_lm_arch
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

CFG = LMConfig(
    name="kimi-k2-1t-a32b",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=163840,
    activation="swiglu",
    moe=MoEConfig(n_experts=384, top_k=8, d_ff_expert=2048, n_shared_experts=1),
    loss_chunk=65536,
    max_seq_len=32768,
)

SMOKE = LMConfig(
    name="kimi-k2-smoke",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_ff=64,
    vocab_size=256,
    activation="swiglu",
    moe=MoEConfig(n_experts=8, top_k=4, d_ff_expert=64, n_shared_experts=1,
                  capacity_round=8),
    loss_chunk=16,
    max_seq_len=64,
    kv_block=8,
)

ARCH = make_lm_arch(CFG, SMOKE, notes="Trillion-param MoE; training memory "
                    "needs >=2048 chips (reported honestly in §Dry-run); "
                    "dry-run validates sharding at 256/512.")
