"""The port stands alone: no module of ``repro_torch`` pulls in JAX or the
JAX package, the card is the default device (entry points raise without one)
and ``chip_smoke.py`` fails without a card and prints no result."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith(("jax.", "jaxlib")) or n == "repro"
             or n.startswith("repro."))
print(len([n for n in sys.modules if n.startswith("repro_torch")]), bad)
"""


def _env():
    return {**os.environ, "PYTHONPATH": str(SRC)}


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=_env(),
                         capture_output=True, text=True, timeout=120, check=True)
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 20, out.stdout
    assert bad == "[]", out.stdout


def test_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    from repro_torch.configs import registry
    from repro_torch.models import model
    from repro_torch.runtime.serve_loop import ServeEngine
    cfg = registry.reduced_config("smollm-135m").replace(n_layers=1)
    params = model.init(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        ServeEngine(cfg, params)
    with pytest.raises(RuntimeError, match="cuda"):
        model.init(cfg)
    from repro_torch.configs.base import ColaConfig
    from repro_torch.core.offload import Offloader
    from repro_torch.core.session import ColaSession
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.optim import optimizers
    with pytest.raises(RuntimeError, match="cuda"):
        Offloader(None, {}, optimizers.sgd(0.1))
    with pytest.raises(RuntimeError, match="cuda"):
        ColaSession(cfg, ColaConfig(), params)
    with pytest.raises(RuntimeError, match="cuda"):
        SyntheticLM(cfg, batch=1, seq=4)
    from repro_torch.core.collab import CollabSession
    from repro_torch.data.pipeline import ByteCorpus
    with pytest.raises(RuntimeError, match="cuda"):
        CollabSession(cfg, ColaConfig(mode="faithful_offload", merged=True,
                                      users=2), params)
    (tmp_path / "corpus.txt").write_bytes(b"a tiny corpus " * 4)
    with pytest.raises(RuntimeError, match="cuda"):
        ByteCorpus(str(tmp_path / "corpus.txt"), batch=1, seq=8)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(alone, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py runs for real")
    script = ROOT / "chip_smoke.py"
    if alone:   # a directory that holds chip_smoke.py and nothing else
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    out = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         env={**os.environ, "PYTHONPATH": ""},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout


def test_head_dim_256_forward_and_decode_take_it_the_backward_refuses_it():
    """gemma2's d_head 256 and zamba2's 112: every kernel takes them now,
    the flash backward too, whose checks pass the head dim and stop at the
    device (CPU tensors here); a head dim no kernel takes (48) still raises
    by name before anything launches, on any device."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    for D in (256, 112):
        assert D in fa.FWD_HEAD_DIMS and D in da.HEAD_DIMS
        assert D in fa.BWD_HEAD_DIMS
    assert 48 not in fa.FWD_HEAD_DIMS + fa.BWD_HEAD_DIMS + da.HEAD_DIMS
    B, S, H, K = 1, 8, 2, 1
    pos = torch.arange(S, dtype=torch.int32)[None]
    stats = torch.zeros(B, H, S)
    for D, match in ((256, "CUDA"), (112, "CUDA"),
                     (48, r"head dim 48 not in \(16, 32, 64, 112, 128, "
                          r"256\)")):
        q = torch.zeros(B, S, H, D)
        k = torch.zeros(B, S, K, D)
        for name, outs in (("flash_attention_bwd_dq", (q,)),
                           ("flash_attention_bwd_dkv", (k, k))):
            with pytest.raises(ValueError, match=match):
                fa._bwd_launch(name, outs, q, k, k, q, stats, stats, pos, pos,
                               True, None, None, D ** -0.5)


def test_new_wrappers_refuse_non_cpu_tensors():
    """The ring decode wrapper and a ring chunk through ``ops`` take the
    plain version only for CPU tensors: any other device goes to the
    kernels' checks, which raise (meta tensors stand in for the card)."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    q = torch.empty(2, 1, 4, 256, device="meta")
    ring = torch.empty(2, 19, 2, 256, device="meta")
    pos = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        da.decode_attention_ring(q, ring, ring, pos, horizon=64, window=16)
    with pytest.raises(ValueError, match="CUDA"):
        ops.sdpa_decode_ring(q.expand(2, 4, 4, 256), ring, ring, pos,
                             window=16, horizon=64)
