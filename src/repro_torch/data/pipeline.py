"""Deterministic synthetic data pipeline.

Counterpart of ``repro.data.pipeline``: the same numpy stream, bit for bit,
keyed by (seed, step, host_shard), so that a restarted or re-sharded job
regenerates exactly the same global stream.  The "dataset" is a noisy
Markov chain over the vocab.  Batches are tensors on ``device`` (``None``:
the CUDA device, raising without one): int32 tokens and targets, float32
patches or features, a bool mask.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import as_tensor
from repro_torch.configs.base import ArchConfig

__all__ = ["SyntheticTokenPipeline", "make_batch"]


def _markov_tokens(rng: np.random.Generator, batch: int, seq: int, vocab: int):
    """Noisy Markov stream: next = (3*cur + noise) mod vocab."""
    x = np.empty((batch, seq + 1), np.int32)
    x[:, 0] = rng.integers(0, vocab, batch)
    noise = rng.integers(0, 7, (batch, seq))
    for t in range(seq):
        x[:, t + 1] = (3 * x[:, t] + noise[:, t]) % vocab
    return x


def _host_batch(cfg: ArchConfig, b_local: int, seq: int,
                rng: np.random.Generator) -> dict[str, np.ndarray]:
    if cfg.modality == "audio":
        feats = rng.standard_normal((b_local, seq, cfg.d_model)).astype(np.float32)
        mask = rng.random((b_local, seq)) < 0.08
        targets = rng.integers(0, cfg.vocab, (b_local, seq)).astype(np.int32)
        targets = np.where(mask, targets, -1)  # loss only on masked frames
        return {"features": feats, "mask": mask, "targets": targets}
    if cfg.modality == "vision":
        P = cfg.n_prefix_embeds
        toks = _markov_tokens(rng, b_local, seq - P, cfg.vocab)
        patches = rng.standard_normal((b_local, P, cfg.d_model)).astype(np.float32)
        return {"tokens": toks[:, :-1], "patches": patches,
                "targets": toks[:, 1:]}
    toks = _markov_tokens(rng, b_local, seq, cfg.vocab)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def make_batch(cfg: ArchConfig, batch: int, seq: int, *, seed: int, step: int,
               host_shard: int = 0, n_hosts: int = 1,
               device: str | torch.device | None = None
               ) -> dict[str, torch.Tensor]:
    """One global-batch slice for this host.  Deterministic in (seed, step)."""
    if batch % n_hosts:
        raise ValueError(f"global batch {batch} not divisible by hosts {n_hosts}")
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, step, host_shard]))
    host = _host_batch(cfg, batch // n_hosts, seq, rng)
    return {k: as_tensor(v, device) for k, v in host.items()}


@dataclasses.dataclass
class SyntheticTokenPipeline:
    """Stateful cursor over the deterministic stream (cursor == step)."""

    cfg: ArchConfig
    batch: int
    seq: int
    seed: int = 0
    step: int = 0
    host_shard: int = 0
    n_hosts: int = 1
    device: str | torch.device | None = None

    def next(self):
        b = make_batch(self.cfg, self.batch, self.seq, seed=self.seed,
                       step=self.step, host_shard=self.host_shard,
                       n_hosts=self.n_hosts, device=self.device)
        self.step += 1
        return b

    def state_dict(self):
        return {"step": self.step, "seed": self.seed}

    def load_state_dict(self, s):
        self.step = int(s["step"])
        self.seed = int(s["seed"])
