"""Training of the port (a port of ``repro.train``).

  tree      — nested dicts / NamedTuples of tensors in JAX's pytree order
              and ``keystr`` paths
  optimizer — AdamW with fp32 moments, updated in place; the LR schedule
  trainer   — make_train_step (gradient accumulation in fp32), the
              prefetcher and the checkpointed, fault-tolerant TrainLoop
"""
