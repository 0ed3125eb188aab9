"""Synthetic-token LM data (port of ``repro/data/lm_synthetic.py``, numpy
only).

Each client owns a deterministic token stream from a client-specific
2-gram process over a Zipf marginal, seeded by (seed, client_id, salt):
the same numpy draws as the JAX package, so both packages see the same
tokens, and the same stub frontend embeddings.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _client_rng(seed: int, client_id: int, salt: int = 0) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence(entropy=seed, spawn_key=(client_id, salt))
    )


@dataclass
class SyntheticLMData:
    """Federated synthetic LM corpus: ``num_clients`` stateless clients."""

    vocab_size: int
    num_clients: int
    seed: int = 0
    zipf_a: float = 1.2
    # number of "hot" tokens whose transition structure is client-specific
    hot_tokens: int = 512

    def _marginal(self) -> np.ndarray:
        ranks = np.arange(1, self.vocab_size + 1, dtype=np.float64)
        p = ranks ** (-self.zipf_a)
        return p / p.sum()

    def client_tokens(self, client_id: int, n_tokens: int,
                      salt: int = 0) -> np.ndarray:
        """Deterministic token stream for one client."""
        rng = _client_rng(self.seed, client_id, salt)
        base = rng.choice(self.vocab_size, size=n_tokens, p=self._marginal())
        # client-specific bigram habit: each hot token deterministically
        # prefers a client-specific successor half of the time
        succ = rng.integers(0, self.vocab_size, size=self.hot_tokens)
        hot = base[:-1] < self.hot_tokens
        flip = rng.random(n_tokens - 1) < 0.5
        nxt = base[1:].copy()
        idx = hot & flip
        nxt[idx] = succ[base[:-1][idx]]
        return np.concatenate([base[:1], nxt]).astype(np.int32)

    def client_batches(self, client_id: int, num_steps: int, batch: int,
                       seq_len: int, salt: int = 0) -> np.ndarray:
        """(num_steps, batch, seq_len+1) token ids: input = [:, :, :-1],
        target = [:, :, 1:]."""
        need = num_steps * batch * (seq_len + 1)
        toks = self.client_tokens(client_id, need, salt)
        return toks.reshape(num_steps, batch, seq_len + 1)

    def round_batches(self, client_ids, num_steps: int, batch: int,
                      seq_len: int, round_idx: int = 0) -> np.ndarray:
        """Stacked per-client batches for one federated round:
        (num_clients, num_steps, batch, seq_len+1)."""
        return np.stack([
            self.client_batches(cid, num_steps, batch, seq_len,
                                salt=round_idx)
            for cid in client_ids
        ])

    def frontend_embeddings(self, client_id: int, batch: int, tokens: int,
                            d_model: int, salt: int = 0) -> np.ndarray:
        """Stub modality-frontend output: deterministic pseudo-embeddings
        (batch, tokens, d_model), numpy float32, standing in for ViT patches
        / EnCodec conditioning frames (the consumer casts them)."""
        rng = _client_rng(self.seed, client_id, salt + 10_000)
        e = rng.standard_normal((batch, tokens, d_model)).astype(np.float32)
        return (e / np.sqrt(d_model)).astype(np.float32)
