"""LM token data pipeline: sharded on-disk token store with resumable,
deterministic batching (a copy of ``repro.data.tokens``: numpy only).

Production shape: fixed-size ``.npy`` token shards + a JSON manifest; the
loader memory-maps shards, yields ``(tokens, labels)`` batches in a
seed-deterministic shuffled order, and exposes/accepts a cursor so a
restarted job resumes mid-epoch exactly where the checkpoint left it
(a checkpoint's ``extra_meta`` can carry the cursor,
`repro_torch.checkpoint.store.save`).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

_MANIFEST = "tokens_manifest.json"


def write_shards(tokens: np.ndarray, out_dir: str, shard_tokens: int = 1 << 20) -> int:
    """Split a flat int32 token stream into .npy shards + manifest."""
    os.makedirs(out_dir, exist_ok=True)
    tokens = np.asarray(tokens, np.int32).reshape(-1)
    n_shards = max(1, (len(tokens) + shard_tokens - 1) // shard_tokens)
    sizes = []
    for i in range(n_shards):
        chunk = tokens[i * shard_tokens:(i + 1) * shard_tokens]
        np.save(os.path.join(out_dir, f"shard_{i:05d}.npy"), chunk)
        sizes.append(int(len(chunk)))
    with open(os.path.join(out_dir, _MANIFEST), "w") as f:
        json.dump({"n_shards": n_shards, "sizes": sizes,
                   "total_tokens": int(len(tokens))}, f)
    return n_shards


@dataclasses.dataclass
class Cursor:
    epoch: int = 0
    step: int = 0

    def to_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d) -> "Cursor":
        return Cursor(int(d.get("epoch", 0)), int(d.get("step", 0)))


class TokenLoader:
    """Deterministic, resumable batch iterator over a token-shard dir."""

    def __init__(self, data_dir: str, batch: int, seq: int, seed: int = 0):
        with open(os.path.join(data_dir, _MANIFEST)) as f:
            self.manifest = json.load(f)
        self.data_dir = data_dir
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self._mmaps = [
            np.load(os.path.join(data_dir, f"shard_{i:05d}.npy"), mmap_mode="r")
            for i in range(self.manifest["n_shards"])
        ]
        total = self.manifest["total_tokens"]
        self.samples_per_epoch = max(1, (total - 1) // (seq + 1))
        self.steps_per_epoch = max(1, self.samples_per_epoch // batch)

    def _sample(self, epoch: int, idx: int) -> np.ndarray:
        order = np.random.default_rng(self.seed + epoch).permutation(
            self.samples_per_epoch
        )
        start = int(order[idx % self.samples_per_epoch]) * (self.seq + 1)
        flat = self._flat_slice(start, self.seq + 1)
        return flat

    def _flat_slice(self, start: int, n: int) -> np.ndarray:
        out = np.empty(n, np.int32)
        pos = 0
        si = 0
        acc = 0
        sizes = self.manifest["sizes"]
        while si < len(sizes) and acc + sizes[si] <= start:
            acc += sizes[si]
            si += 1
        off = start - acc
        while pos < n and si < len(sizes):
            take = min(n - pos, sizes[si] - off)
            out[pos:pos + take] = self._mmaps[si][off:off + take]
            pos += take
            off = 0
            si += 1
        if pos < n:  # wrap (last sample of the stream)
            out[pos:] = out[:n - pos]
        return out

    def batches(self, cursor: Optional[Cursor] = None) -> Iterator[Tuple[Dict, Cursor]]:
        """Yields ``(batch_dict, cursor_after)`` pairs, forever."""
        cur = cursor or Cursor()
        while True:
            rows = [
                self._sample(cur.epoch, cur.step * self.batch + b)
                for b in range(self.batch)
            ]
            arr = np.stack(rows)
            yield (
                {"tokens": arr[:, :-1].copy(), "labels": arr[:, 1:].copy()},
                Cursor(cur.epoch, cur.step + 1),
            )
            cur = Cursor(cur.epoch, cur.step + 1)
            if cur.step >= self.steps_per_epoch:
                cur = Cursor(cur.epoch + 1, 0)
