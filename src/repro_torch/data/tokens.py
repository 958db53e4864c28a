"""Deterministic token stream for LM training.

Cursor-addressed: batch ``i`` for host ``h`` of ``H`` is a pure function
of (seed, i, h), so (a) any host can be replaced and resume mid-epoch
from the checkpointed cursor with zero skew, and (b) straggler-replaced
hosts regenerate exactly their shard.  A copy of the JAX package's
``repro/data/tokens.py`` (numpy only).

The synthetic distribution is a Zipfian unigram mixed with a small
Markov component — enough structure that a ~100M model visibly learns
(loss falls well below the unigram entropy), with no external corpora.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TokenStream:
    vocab: int
    seq_len: int
    batch_per_host: int
    seed: int = 0
    host_index: int = 0
    num_hosts: int = 1
    cursor: int = 0            # batches already served (checkpointable)

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.seed, self.host_index, step))

    def _zipf_probs(self):
        ranks = np.arange(1, self.vocab + 1)
        p = 1.0 / ranks
        return p / p.sum()

    def next_batch(self):
        rng = self._rng(self.cursor)
        p = self._zipf_probs()
        B, L = self.batch_per_host, self.seq_len
        base = rng.choice(self.vocab, size=(B, L + 1), p=p)
        # Markov component: with prob .5 next token = f(prev) (learnable)
        follow = (base[:, :-1] * 31 + 7) % self.vocab
        mask = rng.random((B, L)) < 0.5
        base[:, 1:] = np.where(mask, follow, base[:, 1:])
        self.cursor += 1
        return {"tokens": base[:, :-1].astype(np.int32),
                "targets": base[:, 1:].astype(np.int32)}

    # -- checkpoint integration -----------------------------------------

    def state_dict(self) -> dict:
        return {"cursor": self.cursor, "seed": self.seed,
                "host_index": self.host_index}

    def load_state_dict(self, d: dict):
        assert d["seed"] == self.seed, "stream seed mismatch"
        self.cursor = int(d["cursor"])
