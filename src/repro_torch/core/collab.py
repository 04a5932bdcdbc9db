"""K-user collaboration (paper §3.2 FTaaS, Table 4), as in the JAX package's
``core/collab.py``: all K users' banks merged into the base weights for one
server pass a batch, each user's rows updating only their own bank
(per-user gradient isolation by row masking: exact, since the fit's VJP is
linear in grad_h). The server's cost is constant in K (paper Table 1, ColA
merged row). Each user ships over their own ``OffloadChannel``, so a faulted
user degrades alone (rollback, quarantine) while the round goes on with the
others.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ColaConfig, ModelConfig
from repro_torch.core import gl, merge
from repro_torch.core import taps as taps_lib
from repro_torch.core.channel import OffloadChannel
from repro_torch.core.offload import Offloader
from repro_torch.models import model as model_lib
from repro_torch.optim import optimizers as optim_lib
from repro_torch.utils import resolve_device, tree_map


def mask_user_rows(data: dict[str, tuple], user_ids: torch.Tensor,
                   k: int) -> dict:
    """Zero grad_h on rows not belonging to user k. Because the fit gradient
    is linear in grad_h, fitting on masked data gives exactly user k's
    gradient."""
    out = {}
    for tap, (x, gh) in data.items():
        b_axis = gh.dim() - 3          # (L?, B, S, d)
        shape = [1] * gh.dim()
        shape[b_axis] = gh.shape[b_axis]
        m = (user_ids.to(gh.device) == k).to(gh.dtype).reshape(shape)
        out[tap] = (x, gh * m)
    return out


def user_generator(seed: int, k: int) -> torch.Generator:
    """The CPU generator of user k's initial adapters: seeded from
    (seed, k), so a seed gives the same banks on any device."""
    state = np.random.SeedSequence((seed, k)).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(state[0]))


class CollabSession:
    """K users fine-tuning one base model collaboratively (merged training).
    ``params`` are moved to ``device`` (default the card), where the
    offloaders run too. ``telemetry`` goes to every user's channel, and
    each user's round (row mask, push and fit) opens a
    ``session.offload_round`` span.
    """

    def __init__(self, cfg: ModelConfig, cc: ColaConfig, params: dict,
                 seed: int = 0, optimizer=None, lr=1e-3,
                 families: list[str] | None = None, *,
                 injector=None, policy=None, max_update_norm: float = 1e4,
                 quarantine_after: int = 2, device="cuda",
                 telemetry=None):
        if not (cc.mode == "faithful_offload" and cc.merged):
            raise ValueError("collaboration uses merged faithful-offload "
                             "training (Alg. 1)")
        self.tm = telemetry if telemetry else None
        self.cfg, self.cc = cfg, cc
        self.device = resolve_device(device)
        self.base_params = tree_map(lambda a: a.to(self.device), params)
        self.K = cc.users
        taps = gl.select_taps(cfg, cc.taps)
        # users may choose different adapter families (paper: LowRank-Linear)
        fams = families or [cc.family] * self.K
        if len(fams) != self.K:
            raise ValueError(f"{len(fams)} families for {self.K} users")
        self.user_specs = [
            taps_lib.make_spec(family=f, taps=taps, rank=cc.rank,
                               hidden=cc.hidden, scale=cc.scale)
            for f in fams]
        self.server_spec = gl.make_spec(cfg, cc)   # inject/collect only
        optimizer = optimizer or optim_lib.adamw(lr)
        sites = model_lib.tap_sites(cfg)
        self.offloaders: list[Offloader] = []
        self.channels: list[OffloadChannel] = []
        for k in range(self.K):
            ad = taps_lib.init_adapter_vars(self.user_specs[k], sites,
                                            user_generator(seed, k))
            off = Offloader(self.user_specs[k], ad, optimizer,
                            interval=cc.interval, compress=cc.compress,
                            device=self.device)
            self.offloaders.append(off)
            self.channels.append(OffloadChannel(
                off, user=k, injector=injector, policy=policy,
                max_update_norm=max_update_norm,
                quarantine_after=quarantine_after, telemetry=self.tm))
        self._merged_cache: dict | None = None
        self.step_count = 0

    # ------------------------------------------------------------------
    def merged_model(self) -> dict:
        """The base weights with every user's committed bank folded in."""
        if self._merged_cache is None:
            p = self.base_params
            for k in range(self.K):
                p = merge.merged_params(
                    self.cfg, p, self.user_specs[k].family_map,
                    self.offloaders[k].adapters, self.cc.scale)
            self._merged_cache = p
        return self._merged_cache

    def train_step(self, batch: dict, user_ids) -> float:
        """One FTaaS iteration: a merged server pass, then each user's push
        and fit through their channel. The round always completes with the
        surviving users, and the merged model only folds in validated
        banks. ``batch`` {"tokens", "labels"} and ``user_ids`` (B,) are
        tensors or numpy arrays."""
        self.step_count += 1
        batch = {k: torch.as_tensor(v, device=self.device)
                 for k, v in batch.items() if k != "user_id"}
        user_ids = torch.as_tensor(user_ids, device=self.device)
        loss, data, _ = gl.server_step_a(self.cfg, self.server_spec,
                                         self.merged_model(), {}, batch)
        updated = False
        for k, ch in enumerate(self.channels):
            with ch.round_span():   # the mask, the push and the fit
                ch.push(mask_user_rows(data, user_ids, k))
                if ch.fit_round() is not None:
                    updated = True
        if updated:
            self._merged_cache = None
        return float(loss)

    # -- fault-tolerance surface ----------------------------------------
    def bank_versions(self) -> list[int]:
        return [ch.version for ch in self.channels]

    def channel_health(self) -> dict[int, dict]:
        return {k: ch.health() for k, ch in enumerate(self.channels)}

    def reset_channels(self) -> None:
        """Watchdog recovery hook: reset every user's channel (drop in-flight
        buffers, restore last-good banks, lift quarantine)."""
        for ch in self.channels:
            ch.reset()
        self._merged_cache = None
