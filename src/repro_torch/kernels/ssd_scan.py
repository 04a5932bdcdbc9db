"""Chunked SSD scan (Mamba2's state-space duality, linear in S).

The sequence is cut into chunks of ``chunk`` positions; each chunk applies
the quadratic masked form (``ref.ssd``) and hands its (H, P, N) state to
the next. A port of the JAX package's ``kernels/ssd_scan.py``, whose
``lax.scan`` over the chunks becomes a Python loop. Plain PyTorch on every
device: the JAX package has no Pallas kernel for the scan either.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                init_state: torch.Tensor | None = None, *, chunk: int = 128
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Linear-time chunked scan; exact for any S (shapes as ``ref.ssd``).

    A tail shorter than ``chunk`` is one exact-length ``ref.ssd`` call seeded
    with the carried state, never a zero-padded chunk: padding is
    state-preserving only by an accident of this discretisation (dt == 0),
    and with the tail sliced exactly the returned state is the state at
    position S.
    """
    b, S, H, P = x.shape
    N = B.shape[-1]
    nc, tail = divmod(S, chunk)
    state = (torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.to(torch.float32))
    if nc == 0:
        return ref.ssd(x, dt, a, B, C, D, init_state=state)
    ys = []
    for i in range(0, nc * chunk, chunk):
        s = slice(i, i + chunk)
        y, state = ref.ssd(x[:, s], dt[:, s], a, B[:, s], C[:, s], D,
                           init_state=state)
        ys.append(y)
    if tail:
        s = slice(nc * chunk, S)
        y, state = ref.ssd(x[:, s], dt[:, s], a, B[:, s], C[:, s], D,
                           init_state=state)
        ys.append(y)
    return torch.cat(ys, dim=1), state
