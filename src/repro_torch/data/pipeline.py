"""Deterministic synthetic token pipeline — per-host sharded, resumable.

The port's own copy of the JAX package's ``data/pipeline.py``: numpy only,
so both packages draw the same stream byte for byte (batches are numpy
arrays; the train step moves them to its device).

Production framing: each host generates (or in a real deployment, reads) only
its shard of the global batch; the iterator state is a plain (step, seed)
pair that checkpoints with the model, so restart resumes the exact stream
(fault tolerance requirement).  The synthetic stream is a fixed-vocabulary
Markov-ish mixture that a small LM can actually learn (used by the e2e
training example to show loss descent).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass
class DataState:
    seed: int
    step: int

    def to_dict(self):
        return {"seed": self.seed, "step": self.step}

    @classmethod
    def from_dict(cls, d):
        return cls(seed=int(d["seed"]), step=int(d["step"]))


class SyntheticLM:
    """Synthetic next-token stream with learnable structure.

    Tokens follow a periodic template corrupted with noise: token t is
    ``(phase + t) % base`` with probability (1-noise), uniform otherwise.
    Perfectly learnable by any of the zoo families; loss floor ≈ the noise
    entropy.
    """

    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 *, host_count: int = 1, host_id: int = 0,
                 noise: float = 0.05, seed: int = 17):
        assert global_batch % host_count == 0
        self.vocab = vocab
        self.seq_len = seq_len
        self.local_batch = global_batch // host_count
        self.host_id = host_id
        self.noise = noise
        self.state = DataState(seed=seed, step=0)
        self.base = min(97, vocab - 1)

    def next_batch(self) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.state.seed, self.state.step, self.host_id))
        b, s = self.local_batch, self.seq_len
        phase = rng.integers(0, self.base, size=(b, 1))
        seq = (phase + np.arange(s + 1)[None, :]) % self.base
        noise_mask = rng.random((b, s + 1)) < self.noise
        noise_tok = rng.integers(0, self.vocab, size=(b, s + 1))
        seq = np.where(noise_mask, noise_tok, seq).astype(np.int32)
        self.state.step += 1
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}

    def skip_to(self, step: int):
        """Fast-forward after checkpoint restore (no data replay needed —
        the stream is a pure function of (seed, step, host))."""
        self.state.step = step
