"""nemotron-4-15b — 32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000,
squared-ReLU MLP.  [arXiv:2402.16819; unverified]

The numbers of ``repro.configs.nemotron_4_15b`` (``CFG`` and the CPU-sized
``SMOKE``) and its ``ARCH``, the registry's four cells.
"""

from repro_torch.configs.lm_common import make_lm_arch
from repro_torch.models.transformer import LMConfig

CFG = LMConfig(
    name="nemotron-4-15b",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=256000,
    activation="squared_relu",
    loss_chunk=65536,
    max_seq_len=32768,
)

SMOKE = LMConfig(
    name="nemotron-4-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    activation="squared_relu",
    loss_chunk=16,
    max_seq_len=64,
    kv_block=8,
)

ARCH = make_lm_arch(CFG, SMOKE, notes="Dense GQA + squared-ReLU; paper "
                    "technique N/A (regular load; DESIGN.md §4).")
