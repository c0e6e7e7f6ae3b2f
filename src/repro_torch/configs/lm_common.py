"""The LM cells' shapes and the model-FLOPs convention (the numeric half of
``repro.configs.lm_common``; its cell builders need the registry, which is
not ported yet).

Shapes:
  * ``train_4k``    seq 4,096 × global batch 256
  * ``prefill_32k`` seq 32,768 × batch 32          → prefill (logits + KV cache)
  * ``decode_32k``  KV 32,768 × batch 128          → one-token decode step
  * ``long_500k``   seq 524,288 × batch 1          → skipped by every assigned
                    LM: each is pure full attention

MODEL_FLOPS convention: 6·N_active·tokens for training, 2·N_active·tokens for
inference, with N_active excluding the input embedding table (its lookup is a
gather, not a matmul) but including the LM head.
"""

from __future__ import annotations

from repro_torch.models.transformer import LMConfig

TRAIN_SHAPE = dict(seq=4096, batch=256)
PREFILL_SHAPE = dict(seq=32768, batch=32)
DECODE_SHAPE = dict(seq=32768, batch=128)
LONG_SHAPE = dict(seq=524288, batch=1)


def n_active(cfg: LMConfig) -> int:
    """Parameters a token activates, less the input embedding table."""
    return cfg.active_param_count() - cfg.vocab_size * cfg.d_model
