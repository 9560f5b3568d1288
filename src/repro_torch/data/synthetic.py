"""Deterministic synthetic LM data (counterpart of
``repro.data.synthetic``).

Each (shard, step) batch is a pure function of (seed, step, shard_index):
restart-reproducible with no iterator state to checkpoint. The token
stream has the reference's structure, a hashed bigram with 25% noise, but
the port draws its random first tokens and noise from a seeded
``torch.Generator`` where the reference uses ``jax.random``, so the two
packages give different tokens for the same seed. Tests that compare them
feed the same numpy batch to both. The reference's prefetching iterator is
left out: batches are cheap next to a step, and no caller needs it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class TokenBatch:
    tokens: torch.Tensor       # (B, S) int64
    targets: torch.Tensor      # (B, S) int64 (next token)
    loss_mask: torch.Tensor    # (B, S) f32

    def as_dict(self) -> dict:
        return {"tokens": self.tokens, "targets": self.targets,
                "loss_mask": self.loss_mask}


@dataclasses.dataclass
class SyntheticLM:
    """Markov-ish synthetic token stream: structured enough that a model can
    reduce its loss (bigram structure), deterministic per (seed, step,
    shard). Batches are drawn on the CPU and moved to ``device``."""

    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    shard_index: int = 0
    num_shards: int = 1
    device: str | torch.device = "cpu"

    def __post_init__(self):
        if self.global_batch % self.num_shards:
            raise ValueError(f"global batch {self.global_batch} does not split "
                             f"over {self.num_shards} shards")
        self.local_batch = self.global_batch // self.num_shards
        r = np.random.default_rng(self.seed)
        # fixed bigram transition "table" via hashing, O(1) memory
        self._mix = int(r.integers(1, 2 ** 31 - 1))

    def batch(self, step: int) -> TokenBatch:
        """Batch for ``step`` on this shard (pure function)."""
        gen = torch.Generator().manual_seed(
            (self.seed * 1_000_003 + step) * 65_537 + self.shard_index)
        b, s, v = self.local_batch, self.seq_len, self.vocab_size
        first = torch.randint(0, v, (b,), generator=gen)
        noise = torch.randint(0, v, (s, b), generator=gen)
        prev, toks = first, []
        for n in noise:
            # deterministic bigram: next = hash(prev), with 25% noise
            tok = torch.where(n % 4 == 0, n, (prev * self._mix + 12345) % v)
            toks.append(tok)
            prev = tok
        targets = torch.stack(toks, dim=1)
        tokens = torch.cat([first[:, None], targets[:, :-1]], dim=1)
        mask = torch.ones((b, s), dtype=torch.float32)
        dev = torch.device(self.device)
        return TokenBatch(tokens.to(dev), targets.to(dev), mask.to(dev))


def eval_batch(vocab_size: int, seq_len: int, batch: int, seed: int = 1234,
               device="cpu") -> TokenBatch:
    """Fixed eval batch (for accuracy-vs-energy sweeps)."""
    return SyntheticLM(vocab_size, seq_len, batch, seed=seed, device=device).batch(0)
