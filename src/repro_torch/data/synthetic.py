"""Synthetic token pipeline: deterministic, seekable, shard-aware.

Generates a structured pseudo-corpus (Zipf-ish unigram mix plus copy motifs,
so tiny models can visibly learn) and serves fixed-shape batches.  Seekable
by step index -> restart-safe without data-state checkpoints.

A copy of the JAX package's ``data/synthetic.py`` (pure numpy): the same
config and step give the same arrays, bit for bit, in both packages.  The
trainer moves each batch to its device.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    embed_dim: int | None = None  # modality-stub mode: emit embeddings


class SyntheticLM:
    """Batch source; ``batch(step)`` is a pure function of (config, step)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        base = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        probs = 1.0 / np.arange(1, v + 1) ** 1.1
        self._probs = probs / probs.sum()
        self._perm = base.permutation(v)

    def _tokens(self, rng, b, s):
        toks = rng.choice(self.cfg.vocab_size, size=(b, s + 1), p=self._probs)
        toks = self._perm[toks]
        # copy motif: second half repeats the first half for 25% of rows
        rep = rng.random(b) < 0.25
        half = (s + 1) // 2
        toks[rep, half : 2 * half] = toks[rep, :half]
        return toks.astype(np.int32)

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        toks = self._tokens(rng, cfg.global_batch, cfg.seq_len)
        out = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.embed_dim is not None:  # stub-frontend architectures
            emb = rng.standard_normal(
                (cfg.global_batch, cfg.seq_len, cfg.embed_dim), dtype=np.float32
            )
            out["inputs"] = emb
        return out
