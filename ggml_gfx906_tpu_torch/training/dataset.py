"""Dataset container with shard-wise shuffling (the port's own copy of
ggml_gfx906_tpu/training/dataset.py, numpy only: equal seeds give the
reference's shuffles and batches).

ref: ggml_opt_dataset (include/ggml-opt.h:39-67, src/ggml-opt.cpp:60-180):
data + labels live in one buffer, split into shards (= granularity of
shuffling, usually one datapoint), shuffled with an RNG, and served as
batches.
"""
from __future__ import annotations

import numpy as np


class Dataset:
    def __init__(self, data: np.ndarray, labels: np.ndarray | None = None,
                 ndata_shard: int = 1):
        """data: (ndata, ...), labels: (ndata, ...) or None;
        ndata_shard: datapoints per shuffling shard."""
        self.data = np.asarray(data)
        self.labels = np.asarray(labels) if labels is not None else None
        if self.labels is not None and len(self.labels) != len(self.data):
            raise ValueError(f"{len(self.labels)} labels for {len(self.data)} datapoints")
        if len(self.data) % ndata_shard:
            raise ValueError(f"{len(self.data)} datapoints are not whole shards of {ndata_shard}")
        self.ndata_shard = ndata_shard
        self._perm = np.arange(len(self.data) // ndata_shard)

    @property
    def ndata(self) -> int:
        return len(self.data)

    def shuffle(self, rng: np.random.Generator, n: int | None = None):
        """Shuffle the first n shards (ggml_opt_dataset_shuffle: n=-1 → all;
        n < ndata → only the training split is reshuffled between epochs)."""
        nsh = len(self._perm) if n is None else n // self.ndata_shard
        head = self._perm[:nsh]
        rng.shuffle(head)
        self._perm[:nsh] = head

    def get_batch(self, ibatch: int, batch_size: int):
        """Batch of shards per the current permutation."""
        if batch_size % self.ndata_shard:
            raise ValueError(f"batch {batch_size} is not whole shards of {self.ndata_shard}")
        sh_per_batch = batch_size // self.ndata_shard
        shards = self._perm[ibatch * sh_per_batch:(ibatch + 1) * sh_per_batch]
        idx = (shards[:, None] * self.ndata_shard
               + np.arange(self.ndata_shard)[None, :]).reshape(-1)
        if self.labels is None:
            return self.data[idx], None
        return self.data[idx], self.labels[idx]
