"""Single-device ColA training session: the server step, the offloader,
parameter merging and the baselines, in the five modes of the JAX package's
``core/session.py`` (``ColaConfig.mode``):

- "faithful_offload": paper Alg. 1. The server computes (x, grad_h); the
  Offloader fits the adapters every I batches. ``merged=True`` folds the
  adapters into the base weights for the server pass (zero adapter FLOPs).
- "fused_fit": Mode B. Adapter gradients come from the server's backward
  pass (Prop 1: the same numbers); the optimizer still lives with the
  offloader, with interval-I accumulation.
- "lora": the classic PEFT baseline: the same gradients, on-device optimizer.
- "ft": full fine-tuning.

Mode A ships its adaptation data over an ``OffloadChannel``
(``repro_torch.core.channel``): retries, checksums, validated and versioned
commits, rollback and quarantine, with an optional ``FaultInjector``. With
no injector the channel passes every payload through and commits every fit
that is finite and bounded.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ColaConfig, ModelConfig
from repro_torch.core import adapters as adapters_lib
from repro_torch.core import gl, merge
from repro_torch.core import taps as taps_lib
from repro_torch.core.channel import OffloadChannel
from repro_torch.core.offload import Offloader
from repro_torch.models import model as model_lib
from repro_torch.optim import optimizers as optim_lib
from repro_torch.utils import resolve_device, tree_map


class ColaSession:
    """One adapter bank trained on one model. ``params`` are moved to
    ``device`` (default the card); the offloader runs on ``offload_device``
    (default: ``device``). Adapters are drawn from a ``torch.Generator``
    seeded with ``seed``, on the CPU, so a seed gives the same adapters on
    any device. Mode A's payloads and fits go through ``self.channel``
    (``injector`` and ``policy`` go to it); Mode B keeps one too, as the JAX
    package does, for ``reset_channels`` and ``channel_health``.
    ``telemetry`` goes to the channel, and each Mode A round (push and fit)
    opens a ``session.offload_round`` span."""

    def __init__(self, cfg: ModelConfig, cc: ColaConfig, params: dict,
                 seed: int = 0, optimizer=None, lr=1e-3, device="cuda",
                 offload_device=None, injector=None, policy=None,
                 telemetry=None):
        self.tm = telemetry if telemetry else None
        self.cfg, self.cc = cfg, cc
        self.device = resolve_device(device)
        self.base_params = tree_map(lambda a: a.to(self.device), params)
        self.optimizer = optimizer or optim_lib.adamw(lr)
        self.server_spec = gl.make_spec(cfg, cc)
        taps = gl.select_taps(cfg, cc.taps) if cc.mode != "ft" else ()
        self.adapter_spec = taps_lib.make_spec(
            family=cc.family, taps=taps, rank=cc.rank, hidden=cc.hidden,
            scale=cc.scale)
        self.step_count = 0

        if cc.mode == "ft":
            self.opt_state = self.optimizer.init(self.base_params)
            return
        self.adapters = gl.init_adapters(
            cfg, cc, torch.Generator().manual_seed(seed), device=self.device)
        if cc.mode in ("faithful_offload", "fused_fit"):
            self.offloader = Offloader(
                self.adapter_spec, self.adapters, self.optimizer,
                interval=cc.interval, compress=cc.compress,
                device=self.device if offload_device is None else offload_device)
            # Mode A ships payloads over the (possibly unreliable) offload
            # transport; without faults the channel is a pass-through
            self.channel = OffloadChannel(self.offloader, user=0,
                                          injector=injector, policy=policy,
                                          telemetry=self.tm)
        elif cc.mode == "lora":
            self.opt_state = self.optimizer.init(self.adapters)
        else:
            raise ValueError(f"mode {cc.mode!r} has no training step")
        self._grad_accum = None
        self._merged_cache: dict | None = None

    # ------------------------------------------------------------------
    def _effective_params(self) -> dict:
        if self.cc.mode == "faithful_offload" and self.cc.merged:
            if self._merged_cache is None:
                self._merged_cache = merge.merged_params(
                    self.cfg, self.base_params, self.adapter_spec.family_map,
                    tree_map(lambda a: a.to(self.device), self.adapters),
                    self.cc.scale)
            return self._merged_cache
        return self.base_params

    def _on_device(self, tree: dict) -> dict:
        return tree_map(lambda a: torch.as_tensor(a, device=self.device), tree)

    # ------------------------------------------------------------------
    def step(self, batch: dict) -> float:
        """One training step on ``batch`` {"tokens", "labels"} (tensors or
        numpy arrays); returns the loss."""
        self.step_count += 1
        cc = self.cc
        batch = self._on_device(batch)
        if cc.mode == "ft":
            loss, grads, _ = gl.train_step_ft(self.cfg, self.base_params, batch)
            updates, self.opt_state = self.optimizer.update(
                grads, self.opt_state, self.base_params)
            self.base_params = optim_lib.apply_updates(self.base_params,
                                                       updates)
            return float(loss)

        if cc.mode == "faithful_offload":
            adapters_in = {} if cc.merged else self.adapters
            loss, data, _ = gl.server_step_a(self.cfg, self.server_spec,
                                             self._effective_params(),
                                             adapters_in, batch)
            with self.channel.round_span():   # one round: push + fit
                self.channel.push(data)
                new = self.channel.fit_round()
            if new is not None:
                self.adapters = tree_map(lambda a: a.to(self.device), new)
                self._merged_cache = None   # re-merge from the pristine base
            return float(loss)

        loss, grads, _ = gl.train_step_b(self.cfg, self.server_spec,
                                         self.base_params, self.adapters, batch)
        if cc.mode == "fused_fit":
            # Mode B ships only adapter-gradient-sized tensors; the offload
            # device owns optimizer state and interval accumulation
            self._grad_accum = grads if self._grad_accum is None else tree_map(
                torch.add, self._grad_accum, grads)
            if self.step_count % cc.interval == 0:
                off = self.offloader
                g = tree_map(lambda a: (a / cc.interval).to(off.device),
                             self._grad_accum)
                updates, off.opt_state = self.optimizer.update(
                    g, off.opt_state, off.adapters)
                off.adapters = optim_lib.apply_updates(off.adapters, updates)
                self.adapters = tree_map(lambda a: a.to(self.device),
                                         off.adapters)
                self._grad_accum = None
            return float(loss)

        # lora baseline: on-device optimizer
        updates, self.opt_state = self.optimizer.update(
            grads, self.opt_state, self.adapters)
        self.adapters = optim_lib.apply_updates(self.adapters, updates)
        return float(loss)

    # ------------------------------------------------------------------
    def reset_channels(self) -> None:
        """Watchdog recovery hook: drop in-flight offload state, restore the
        last-good bank, lift quarantine (no-op for channel-less modes)."""
        ch = getattr(self, "channel", None)
        if ch is not None:
            ch.reset()
            self.adapters = tree_map(lambda a: a.to(self.device), ch.adapters)
            self._merged_cache = None

    def channel_health(self) -> dict:
        ch = getattr(self, "channel", None)
        return {0: ch.health()} if ch is not None else {}

    # ------------------------------------------------------------------
    def inference_params(self) -> dict:
        """Merged params for serving (PEFT merge-for-inference)."""
        if self.cc.mode == "ft":
            return self.base_params
        fams = self.adapter_spec.family_map
        if not all(adapters_lib.is_mergeable(fams[t]) for t in self.adapters):
            return self.base_params   # non-mergeable families stay unmerged
        return merge.merged_params(self.cfg, self.base_params, fams,
                                   self.adapters, self.cc.scale)

    @torch.no_grad()
    def eval_loss(self, batch: dict) -> float:
        batch = self._on_device(batch)
        params = self._effective_params()
        if self.cc.mode == "ft" or (self.cc.mode == "faithful_offload"
                                    and self.cc.merged):
            loss, _ = model_lib.loss_fn(self.cfg, params, batch)
        else:
            loss, _ = model_lib.loss_fn(
                self.cfg, params, batch, self.server_spec.with_adapters_only(),
                {"adapters": self.adapters})
        return float(loss)
