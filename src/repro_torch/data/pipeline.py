"""Synthetic token pipeline — deterministic, seeded, learnable structure.

The reference's pipeline, copied (it is pure numpy): the same config and
seed give the same batches byte for byte.

The offline container has no datasets; we generate a Zipf-distributed token
stream with a Markov bigram backbone so that a ~100M model trained for a few
hundred steps shows a *decreasing* loss (pure-uniform tokens would pin the
loss at log V).  For VLM/audio archs the pipeline also emits the stub
frontend embeddings (patch/frame) the model expects.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch: int = 8
    seq_len: int = 256
    seed: int = 0
    zipf_a: float = 1.2          # token unigram skew
    markov_states: int = 64      # bigram backbone states


class SyntheticLM:
    """Deterministic stream of {tokens, labels[, embeds, frames]} batches."""

    def __init__(self, cfg: ModelConfig, data: DataConfig):
        self.cfg, self.data = cfg, data
        rng = np.random.default_rng(data.seed)
        v = cfg.vocab_size
        k = min(data.markov_states, v)
        # static bigram transition table over k "hub" tokens scattered in V
        self.hubs = rng.choice(v, size=k, replace=False)
        self.trans = rng.dirichlet(np.ones(k) * 0.1, size=k)
        self.zipf_p = 1.0 / np.arange(1, v + 1) ** data.zipf_a
        self.zipf_p /= self.zipf_p.sum()
        self.perm = rng.permutation(v)

    def _sample_seq(self, rng, n: int) -> np.ndarray:
        k = len(self.hubs)
        out = np.empty(n, np.int64)
        state = rng.integers(k)
        for i in range(n):
            if rng.random() < 0.75:          # follow the bigram backbone
                state = rng.choice(k, p=self.trans[state])
                out[i] = self.hubs[state]
            else:                             # zipf noise (head of the dist)
                head = min(1000, len(self.zipf_p))
                out[i] = self.perm[rng.choice(
                    head, p=self.zipf_p[:head] / self.zipf_p[:head].sum())]
        return out

    def batches(self, n_steps: Optional[int] = None) -> Iterator[dict]:
        d, cfg = self.data, self.cfg
        rng = np.random.default_rng(d.seed + 1)
        step = 0
        s_text = d.seq_len
        n_front = 0
        if cfg.frontend == "vision_stub":
            n_front = cfg.n_frontend_tokens
            s_text = d.seq_len - n_front
        while n_steps is None or step < n_steps:
            toks = np.stack([self._sample_seq(rng, s_text + 1)
                             for _ in range(d.batch)])
            batch = {
                "tokens": toks[:, :-1].astype(np.int32),
                "labels": np.pad(toks[:, 1:], ((0, 0), (n_front, 0))
                                 ).astype(np.int32),
            }
            if n_front:
                batch["embeds"] = rng.standard_normal(
                    (d.batch, n_front, cfg.d_model)).astype(np.float32) * 0.02
                mask = np.ones((d.batch, d.seq_len), np.float32)
                mask[:, :n_front] = 0.0
                batch["mask"] = mask
            if cfg.frontend == "audio_stub":
                e = cfg.encoder
                batch["frames"] = rng.standard_normal(
                    (d.batch, e.n_frames, e.d_model)).astype(np.float32) * 0.02
            yield batch
            step += 1


__all__ = ["DataConfig", "SyntheticLM"]
