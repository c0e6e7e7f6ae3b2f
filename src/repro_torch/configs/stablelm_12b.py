"""stablelm-12b — 40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352.
[hf:stabilityai/stablelm-2-1_6b; hf]

The numbers of ``repro.configs.stablelm_12b`` (``CFG`` and the CPU-sized
``SMOKE``) and its ``ARCH``, the registry's four cells.  Its head width
is 5120 / 32 = 160.
"""

from repro_torch.configs.lm_common import make_lm_arch
from repro_torch.models.transformer import LMConfig

CFG = LMConfig(
    name="stablelm-12b",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13824,
    vocab_size=100352,
    activation="swiglu",
    loss_chunk=65536,
    max_seq_len=32768,
)

SMOKE = LMConfig(
    name="stablelm-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=96,
    vocab_size=256,
    activation="swiglu",
    loss_chunk=16,
    max_seq_len=64,
    kv_block=8,
)

ARCH = make_lm_arch(CFG, SMOKE)
