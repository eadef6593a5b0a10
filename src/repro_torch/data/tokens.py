"""Synthetic token streams for the LM model zoo (numpy only).

A copy of ``src/repro/data/tokens.py``, whose outputs it equals for
fixed seeds (``tests/test_torch_lm.py``): the reference module is
numpy-only, but its package imports JAX.  Two uses:
  1. Training data for the transformer archs (``token_batch_iterator``):
     per-task Markov token sources, so that users on the same "domain"
     share a transition matrix.
  2. Per-user feature matrices for the similarity protocol on token data
     (``token_features``): mean-pooled fixed random bigram embeddings,
     which ``launch/decode_loop.py::token_signature`` turns into the
     signature that routes a serving request.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

__all__ = ["TokenTaskSpec", "sample_tokens", "token_features",
           "token_batch_iterator"]


@dataclasses.dataclass(frozen=True)
class TokenTaskSpec:
    vocab: int = 256
    order_rank: int = 8       # rank of the task's transition structure
    logit_scale: float = 3.0  # transition sharpness (higher = more domain
    seed: int = 0             # signal in the bigram statistics)


def _task_logits(spec: TokenTaskSpec) -> tuple[np.ndarray, np.ndarray]:
    """Low-rank bigram logits ``L = U V^T`` identifying the task."""
    rng = np.random.default_rng((spec.seed, 17))
    u = rng.standard_normal((spec.vocab, spec.order_rank)).astype(np.float32)
    v = rng.standard_normal((spec.vocab, spec.order_rank)).astype(np.float32)
    return u * (spec.logit_scale / np.sqrt(spec.order_rank)), v


def sample_tokens(spec: TokenTaskSpec, n_tokens: int,
                  seed: int = 0) -> np.ndarray:
    """Sample one stream from the task's bigram model (Gumbel trick)."""
    u, v = _task_logits(spec)
    rng = np.random.default_rng((seed, 19))
    out = np.empty(n_tokens, dtype=np.int32)
    tok = int(rng.integers(spec.vocab))
    for t in range(n_tokens):
        logits = u[tok] @ v.T                      # (vocab,)
        g = rng.gumbel(size=spec.vocab).astype(np.float32)
        tok = int(np.argmax(logits + g))
        out[t] = tok
    return out


def token_features(tokens: np.ndarray, d: int = 128, window: int = 16,
                   seed: int = 7, vocab: int | None = None) -> np.ndarray:
    """Phi for token data: fixed random BIGRAM embedding, mean-pooled.

    Each adjacent pair (t_i, t_{i+1}) maps to ``e1[t_i] * e2[t_{i+1}]``
    (elementwise product of two fixed random embeddings — a randomized
    bigram co-occurrence sketch), mean-pooled over short windows.  Domains
    that differ in transition structure then differ in feature
    second-moments, which is what the Gram-spectrum protocol keys on.
    The tables are seeded, hence shared across users, as required.
    """
    rng = np.random.default_rng((seed, 23))
    vocab = vocab or (int(tokens.max()) + 1)
    e1 = rng.standard_normal((vocab, d)).astype(np.float32)
    e2 = rng.standard_normal((vocab, d)).astype(np.float32)
    pair = e1[tokens[:-1]] * e2[tokens[1:]] / np.sqrt(d)
    n_win = len(pair) // window
    pair = pair[: n_win * window].reshape(n_win, window, d)
    return pair.mean(axis=1)


def token_batch_iterator(spec: TokenTaskSpec, batch: int, seq_len: int,
                         seed: int = 0) -> Iterator[dict[str, np.ndarray]]:
    """Infinite iterator of LM batches ``{tokens, labels}`` (next-token)."""
    stream_seed = 0
    while True:
        toks = np.stack([
            sample_tokens(spec, seq_len + 1, seed=(seed, stream_seed, b))
            for b in range(batch)])
        stream_seed += 1
        yield {"tokens": toks[:, :-1].astype(np.int32),
               "labels": toks[:, 1:].astype(np.int32)}
