"""minitron-8b — 32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000
(pruned nemotron).  [arXiv:2407.14679; hf]

The numbers of ``repro.configs.minitron_8b`` (``CFG`` and the CPU-sized
``SMOKE``), its ``ARCH`` (the registry's four cells), and the serving
shapes of `repro_torch.configs.lm_common` beside them.
"""

from repro_torch.configs.lm_common import DECODE_SHAPE, PREFILL_SHAPE, make_lm_arch  # noqa: F401
from repro_torch.models.transformer import LMConfig

CFG = LMConfig(
    name="minitron-8b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=256000,
    activation="squared_relu",
    loss_chunk=65536,
    max_seq_len=32768,
)

SMOKE = LMConfig(
    name="minitron-smoke",
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

ARCH = make_lm_arch(CFG, SMOKE)
