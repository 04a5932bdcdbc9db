"""Fault-tolerant training loop (the JAX package's ``runtime/train_loop.py``).

- Restartable: the state is the step counter and the adapters (or
  parameters) with their optimizer state; the data pipeline is a pure
  function of the step, so a restart resumes exactly where it stopped.
- Crash-safe checkpoints: atomic writes, asynchronous serialisation,
  retention, in the JAX package's format.
- Preemption: SIGTERM sets a flag; the loop checkpoints and stops at the
  next step boundary.
- Stragglers: the ``Watchdog`` flags slow steps; with
  ``recover_on_straggler`` the loop checkpoints and resets the session's
  offload channels. Metrics stream to ``metrics.jsonl`` with the JAX
  package's keys; with ``telemetry`` the metric registry (``train.*``,
  ``train.watchdog.*``, ``channel.u<k>.*``) streams to ``telemetry.jsonl``
  beside it, and the watchdog observes the ``train.step_s`` histogram.
"""
from __future__ import annotations

import json
import os
import signal
import time
from typing import Callable

from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.watchdog import Watchdog
from repro_torch.utils import tree_map


def _load_opt_state(tree: dict, like: dict, device) -> dict:
    """An optimizer state from a checkpoint, on ``device`` in the dtypes of
    ``like`` (the session's fresh state). ``"step"`` comes back as a Python
    int, as the port's optimizers keep it, whichever package wrote it (the
    JAX package keeps a 0-d int32): AdamW's bias correction
    ``b1 ** step`` would otherwise take another path."""
    out = {}
    for k, v in tree.items():
        if k == "step":
            out[k] = int(v)
        elif isinstance(v, dict):
            out[k] = _load_opt_state(v, like[k], device)
        else:
            out[k] = v.to(device=device, dtype=like[k].dtype)
    return out


class TrainLoop:
    """Drives ``session.step(data.batch_at(step))`` with checkpoints, a
    watchdog and metrics."""

    def __init__(self, session, data, workdir: str, *, ckpt_every: int = 50,
                 log_every: int = 10, keep: int = 3,
                 eval_fn: Callable[[int], dict] | None = None,
                 eval_every: int = 0, recover_on_straggler: bool = False,
                 telemetry=None):
        self.session = session
        self.data = data
        self.workdir = workdir
        os.makedirs(workdir, exist_ok=True)
        # telemetry: step-time histogram + straggler postmortems ride through
        # the watchdog; the metric registry streams to telemetry.jsonl next
        # to the (always-on) metrics.jsonl
        self.tm = telemetry if telemetry else None
        if self.tm:
            self.tm.registry.stream_to(
                os.path.join(workdir, "telemetry.jsonl"))
        self.ckpt = CheckpointManager(os.path.join(workdir, "ckpt"), keep=keep)
        self.watchdog = Watchdog(
            heartbeat_path=os.path.join(workdir, "heartbeat.json"),
            on_straggler=self._on_straggler if recover_on_straggler else None,
            telemetry=self.tm)
        self.ckpt_every = ckpt_every
        self.log_every = log_every
        self.eval_fn = eval_fn
        self.eval_every = eval_every
        self.metrics_path = os.path.join(workdir, "metrics.jsonl")
        self._preempted = False
        self.losses: list[float] = []
        self.recoveries = 0

    # -- straggler / hang recovery ------------------------------------------
    def _on_straggler(self, step: int, dt: float, med: float) -> None:
        """A straggling or hung step signals a sick offload round: checkpoint
        the last-good state and reset the offload channels (drop in-flight
        buffers, restore last-good banks, lift quarantine)."""
        self.recoveries += 1
        if self.tm:
            self.tm.record("train", 0, "recovery", step=step, dt=dt,
                           median=med)
        self.ckpt.save_async(step, self._state())
        reset = getattr(self.session, "reset_channels", None)
        if reset is not None:
            reset()

    # -- telemetry ----------------------------------------------------------
    def _channel_briefs(self) -> dict:
        """Per-user compact channel health (empty for channel-less modes)."""
        chs = getattr(self.session, "channels", None)
        if chs is None:
            ch = getattr(self.session, "channel", None)
            chs = [ch] if ch is not None else []
        return {ch.user: ch.health_brief() for ch in chs}

    def _emit_telemetry(self, step: int, loss: float) -> None:
        """Absorb the train-side stat dicts into the registry (``train.*`` /
        ``channel.*``) and append one snapshot to telemetry.jsonl. ``loss``
        is the Python float ``session.step`` returned: no device sync."""
        if self.tm is None:
            return
        reg = self.tm.registry
        reg.absorb("train", {"step": step, "loss": float(loss),
                             "recoveries": self.recoveries})
        reg.absorb("train.watchdog", self.watchdog.stats)
        for user, brief in self._channel_briefs().items():
            reg.absorb(f"channel.u{user}", brief)
        reg.emit(step=step)

    # -- state (de)hydration -------------------------------------------
    def _state(self) -> dict:
        s = {"step": self.session.step_count}
        if getattr(self.session, "adapters", None):
            s["adapters"] = self.session.adapters
            if hasattr(self.session, "offloader"):
                s["opt_state"] = self.session.offloader.opt_state
            elif hasattr(self.session, "opt_state"):
                s["opt_state"] = self.session.opt_state
        else:
            s["params"] = self.session.base_params
            if hasattr(self.session, "opt_state"):
                s["opt_state"] = self.session.opt_state
        return s

    def _load_state(self, tree: dict) -> None:
        """Put a restored state back into the session: tensors on the
        session's devices (the offloader's for its bank and optimizer state)
        in the dtypes the session holds."""
        sess = self.session
        sess.step_count = int(tree["step"])
        if "adapters" in tree:
            def like(new, old):
                return new.to(device=sess.device, dtype=old.dtype)
            sess.adapters = tree_map(like, tree["adapters"], sess.adapters)
            off = getattr(sess, "offloader", None)
            if off is not None:
                off.adapters = tree_map(lambda a: a.to(off.device),
                                        sess.adapters)
                off.opt_state = _load_opt_state(tree["opt_state"],
                                                off.opt_state, off.device)
                # the restored bank is the validated one: a reset() must
                # come back to it, and the norm guard measure from it
                sess.channel.last_good = off.adapters
            elif hasattr(sess, "opt_state"):
                sess.opt_state = _load_opt_state(tree["opt_state"],
                                                 sess.opt_state, sess.device)
            sess._merged_cache = None
        else:
            sess.base_params = tree_map(
                lambda new, old: new.to(device=sess.device, dtype=old.dtype),
                tree["params"], sess.base_params)
            if "opt_state" in tree and hasattr(sess, "opt_state"):
                sess.opt_state = _load_opt_state(tree["opt_state"],
                                                 sess.opt_state, sess.device)

    # -- preemption -------------------------------------------------------
    def _install_signal_handler(self):
        def handler(signum, frame):
            self._preempted = True
        try:
            signal.signal(signal.SIGTERM, handler)
        except ValueError:
            pass  # not on the main thread (tests)

    # -- run ---------------------------------------------------------------
    def run(self, steps: int, resume: bool = True) -> dict:
        self._install_signal_handler()
        if resume:
            restored = self.ckpt.restore()
            if restored is not None:
                _, tree = restored
                self._load_state(tree)
                print(f"[train] resumed from step {self.session.step_count}")

        start = self.session.step_count
        t_begin = time.time()
        with open(self.metrics_path, "a") as mf:
            for step in range(start, steps):
                self.watchdog.start_step()
                batch = self.data.batch_at(step)
                loss = self.session.step(batch)
                dt = self.watchdog.end_step(step)
                self.losses.append(loss)
                if step % self.log_every == 0 or step == steps - 1:
                    rec = {"step": step, "loss": loss, "dt": round(dt, 4),
                           "watchdog": self.watchdog.brief(),
                           "channel_health": self._channel_briefs()}
                    if self.eval_every and self.eval_fn and \
                            step % self.eval_every == 0:
                        rec.update(self.eval_fn(step))
                    mf.write(json.dumps(rec) + "\n")
                    mf.flush()
                    self._emit_telemetry(step, loss)
                if (step + 1) % self.ckpt_every == 0 or self._preempted:
                    self.ckpt.save_async(step + 1, self._state())
                if self._preempted:
                    self.ckpt.wait()
                    print(f"[train] preempted at step {step}; checkpointed")
                    break
        self.ckpt.save_async(self.session.step_count, self._state())
        self.ckpt.wait()
        out = {
            "steps": self.session.step_count - start,
            "final_loss": self.losses[-1] if self.losses else None,
            "wall_s": time.time() - t_begin,
            "stragglers": len(self.watchdog.stragglers),
            "recoveries": self.recoveries,
            "heartbeat_failures": self.watchdog.stats["heartbeat_failures"],
            "watchdog": self.watchdog.summary(),
        }
        health = getattr(self.session, "channel_health", None)
        if health is not None:
            out["channel_health"] = health()
        return out
