"""Data: the JAX package's ``SyntheticLM`` stream and ``ByteCorpus``
(``data/pipeline.py``), with the same numpy generators, so a seed gives the
same tokens in both packages. ``batch_at(step)`` is a pure function of the
step index and the seed (the restart contract of the train loop); batches
are tensors on the caller's device, ``numpy_batch_at`` the same as numpy.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.utils import resolve_device


@dataclasses.dataclass
class SyntheticLM:
    """Seeded synthetic LM stream with learnable structure: a fixed random
    bigram table (8 likely successors per token, 10 % noise) generates the
    tokens, so a model can reduce its loss. With codebooks each of the CB
    streams is drawn in turn from the step's generator and stacked last,
    tokens and labels (b, seq, CB); with ``embed_input`` the batch is
    standard-normal f32 stub embeddings (b, seq, d) and uniform labels, in
    JAX's order of draws."""
    cfg: ModelConfig
    batch: int
    seq: int
    seed: int = 0
    users: int = 1
    host_id: int = 0
    n_hosts: int = 1
    device: str | torch.device = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        rng = np.random.default_rng(self.seed)
        self._succ = rng.integers(0, self.cfg.vocab_size, size=(
            self.cfg.vocab_size, 8), dtype=np.int32)

    def _gen_tokens(self, rng: np.random.Generator, b: int, s: int) -> np.ndarray:
        v = self.cfg.vocab_size
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.integers(0, v, size=b)
        choice = rng.integers(0, 8, size=(b, s))
        noise = rng.random((b, s)) < 0.1
        rand = rng.integers(0, v, size=(b, s), dtype=np.int32)
        for t in range(s):
            nxt = self._succ[toks[:, t], choice[:, t]]
            toks[:, t + 1] = np.where(noise[:, t], rand[:, t], nxt)
        return toks

    def numpy_batch_at(self, step: int) -> dict:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 7919 + self.host_id)
        b = self.batch // self.n_hosts
        if self.cfg.embed_input:
            emb = rng.standard_normal(
                (b, self.seq, self.cfg.d_model)).astype(np.float32)
            labels = rng.integers(0, self.cfg.vocab_size,
                                  size=(b, self.seq), dtype=np.int32)
            batch = {"embeds": emb, "labels": labels}
        else:
            toks = (np.stack([self._gen_tokens(rng, b, self.seq)
                              for _ in range(self.cfg.n_codebooks)], axis=-1)
                    if self.cfg.n_codebooks
                    else self._gen_tokens(rng, b, self.seq))
            batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.users > 1:
            batch["user_id"] = rng.integers(0, self.users, size=(b,),
                                            dtype=np.int32)
        return batch

    def batch_at(self, step: int) -> dict:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in self.numpy_batch_at(step).items()}


class ByteCorpus:
    """Byte-level tokenised corpus from a local text file (vocab 256 + pad),
    with the JAX package's window sampling: step ``s`` draws its windows from
    ``default_rng(seed * 1_000_003 + s)``, so both packages read the same
    windows. Batches are tensors on ``device`` (default the card)."""

    def __init__(self, path: str, batch: int, seq: int, seed: int = 0,
                 device: str | torch.device = "cuda"):
        with open(path, "rb") as f:
            self.data = np.frombuffer(f.read(), dtype=np.uint8).astype(np.int32)
        if len(self.data) <= seq + 1:
            raise ValueError(f"corpus of {len(self.data)} bytes is too small "
                             f"for windows of {seq + 1}")
        self.batch, self.seq, self.seed = batch, seq, seed
        self.device = resolve_device(device)

    def numpy_batch_at(self, step: int) -> dict:
        rng = np.random.default_rng(self.seed * 1_000_003 + step)
        starts = rng.integers(0, len(self.data) - self.seq - 1, size=self.batch)
        toks = self.data[starts[:, None] + np.arange(self.seq + 1)[None, :]]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def batch_at(self, step: int) -> dict:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in self.numpy_batch_at(step).items()}
