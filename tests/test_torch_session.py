"""``ColaSession`` of the port against the JAX package's on the CPU, in all
five modes (faithful_offload merged with interval 2, faithful_offload
unmerged with int8 transfer compression, fused_fit, lora, ft), and the
Offloader's interval buffering. Reduced f32 smollm-135m (2 layers), JAX's
weights and initial adapters carried across by ``repro_torch.convert``, the
same numpy batches fed to both.

Tolerances (f32): losses rtol = 1e-4 over three steps (XLA's CPU matmuls and
PyTorch's sum in other orders); adapters after the steps rtol = 1e-3 of the
largest entry (5e-3 with int8 compression, see the test).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import registry  # noqa: E402
from repro.configs.base import ColaConfig  # noqa: E402
from repro.core import session as jsession  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.models import model as M  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.core import gl as tgl  # noqa: E402
from repro_torch.core import offload as toffload  # noqa: E402
from repro_torch.core import session as tsession  # noqa: E402
from repro_torch.optim import optimizers as toptim  # noqa: E402


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tnp(tree):
    if isinstance(tree, dict):
        return {k: _tnp(v) for k, v in tree.items()}
    return tree.detach().numpy()


def _close(got, want, rtol, what=""):
    """Trees of arrays agree within rtol, with atol = rtol * max |want|."""
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _close(got[k], want[k], rtol, f"{what}.{k}")
        return
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()),
                               err_msg=what)


@pytest.fixture(scope="module")
def setup():
    cfg = registry.reduced_config("smollm-135m").replace(n_layers=2)
    tcfg = tregistry.reduced_config("smollm-135m").replace(n_layers=2)
    params = M.init(cfg, jax.random.PRNGKey(1))
    tparams = convert.params_from_numpy(tcfg, _np(params), device="cpu")
    stream = jpipeline.SyntheticLM(cfg, batch=2, seq=16, seed=3)
    batches = [stream.batch_at(i) for i in range(3)]
    return cfg, tcfg, params, tparams, batches


# ---------------------------------------------------------------------------
# ColaSession: loss trajectories against JAX, all five modes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,merged,interval,compress", [
    ("faithful_offload", True, 2, "none"),
    ("faithful_offload", False, 1, "int8"),
    ("fused_fit", False, 2, "none"),
    ("lora", False, 1, "none"),
    ("ft", False, 1, "none"),
])
def test_session_trajectory_matches_jax(setup, mode, merged, interval,
                                        compress):
    cfg, tcfg, params, tparams, batches = setup
    cc = ColaConfig(mode=mode, family="lowrank", taps="qv", rank=4,
                    merged=merged, interval=interval, compress=compress)
    lr = 1e-2 if mode != "ft" else 1e-3
    js = jsession.ColaSession(cfg, cc, params, jax.random.PRNGKey(3), lr=lr)
    ts = tsession.ColaSession(tcfg, tbase.ColaConfig(**dataclasses.asdict(cc)),
                              tparams, lr=lr, device="cpu")
    if mode != "ft":   # start both from JAX's adapters
        ad = convert.adapters_from_numpy(_np(js.adapters), device="cpu")
        ts.adapters = ad
        if mode == "lora":
            ts.opt_state = ts.optimizer.init(ad)
        else:
            ts.offloader.adapters = ts.channel.last_good = ad
    losses = [(ts.step(b), js.step(b)) for b in batches]
    np.testing.assert_allclose(*zip(*losses), rtol=1e-4)
    assert len({round(j, 6) for _, j in losses}) > 1   # training moved the loss
    if mode != "ft":   # int8: a code half-way between two steps may round
        # either way when x and grad_h differ in the last bit (one step is
        # 1/127 of the row's max), and Adam's first steps follow the sign
        _close(_tnp(ts.adapters), _np(js.adapters),
               rtol=5e-3 if compress == "int8" else 1e-3, what=mode)
    np.testing.assert_allclose(ts.eval_loss(batches[0]),
                               js.eval_loss(batches[0]), rtol=1e-4)


def test_offloader_fits_on_the_interval_and_force_fit(setup):
    cfg, tcfg, params, tparams, batches = setup
    tcc = tbase.ColaConfig(mode="faithful_offload", rank=4)
    tspec = tgl.make_spec(tcfg, tcc)
    tad = tgl.init_adapters(tcfg, tcc, torch.Generator().manual_seed(0))
    off = toffload.Offloader(tspec, tad, toptim.sgd(0.1), interval=2,
                             device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in batches[0].items()}
    _, data, _ = tgl.server_step_a(tcfg, tspec, tparams, tad, batch)
    off.push(data)
    assert off.maybe_fit() is None and off.stats["fits"] == 0
    new = off.force_fit()      # one batch buffered: averaged over one
    want = tgl.fit_grads(tspec, tad, data)
    _close(_tnp(new), {t: {n: tad[t][n].numpy() - 0.1 * want[t][n].numpy()
                           for n in w} for t, w in tad.items()}, rtol=1e-6)
    off.push(data)     # the second push since the start: a fit is due
    assert off.ready and off.maybe_fit() is not None and off.stats["fits"] == 2
