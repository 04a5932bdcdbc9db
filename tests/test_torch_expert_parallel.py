"""The MoE dispatch's cross-rank accounting (``models/moe.py``'s ``Split``,
``gshard_combine``, ``sort_slots``) on the CPU, with no process group: one
batch's routing ids are cut into the blocks of rows that the batch ranks of
a distributed step hold, and each block, with the experts of one "model"
rank, goes through the accounting with the other ranks' counts built by
hand (numpy) as the all-gather would bring them. Every (token, choice)'s
position in its expert and whether it is kept must equal the whole batch's
(one device's, the path ``moe_einsum`` / ``moe_sort`` take without a split),
exactly:

- the einsum dispatch with each rank's rows holding whole groups (no counts
  are exchanged), with groups spanning ranks (a rank's 12 tokens across two
  groups of 8; four ranks sharing one group of 32), and in row groups
  (``G = S``, the call's tokens not dividing into ``group``);
- the sort dispatch over four batch ranks.

The aux loss, which every "model" rank computes on the same tokens, is
counted once: the ranks' outputs summed equal one device's, and so do
their input and router gradients summed (``aux_grad`` on rank 0 alone);
with every rank's aux gradient flowing, the sum misses by the surplus.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.models import moe as M  # noqa: E402
from repro_torch.utils import cdiv  # noqa: E402

E, K = 8, 2


def _ids(T, seed):
    """T tokens' K distinct expert ids, skewed so that capacities bite."""
    rng = np.random.default_rng(seed)
    p = np.linspace(3.0, 1.0, E)
    ids = np.stack([rng.choice(E, K, replace=False, p=p / p.sum())
                    for _ in range(T)])
    w = rng.uniform(0.1, 1.0, (T, K)).astype(np.float32)
    return torch.from_numpy(ids), torch.from_numpy(w)


def _hand_counts(ids, ranks, expert0, experts, G):
    """Each rank's (T / G groups, K, experts) counts of its tokens'
    choices, as numpy would count them: what the all-gather brings."""
    T = ids.shape[0]
    n = T // ranks
    out = np.zeros((ranks, T // G, K, experts), np.float32)
    for t in range(T):
        for j in range(K):
            e = int(ids[t, j]) - expert0
            if 0 <= e < experts:
                out[t // n, t // G, j, e] += 1
    return torch.from_numpy(out)


class _Gather:
    """A ``Split.gather`` that hands back ``every`` and checks that the
    rank offered its own block of it."""

    def __init__(self, every, index):
        self.every, self.index, self.calls = every, index, 0

    def __call__(self, local):
        self.calls += 1
        assert torch.equal(local, self.every[self.index].to(local.dtype))
        return self.every.to(local.dtype)


# (rows, S, group, batch ranks, "model" ranks): whole groups of 16 on each
# of 2 ranks; groups of 8 tokens, a rank's 12 across two of them; one group
# of 32 over 4 ranks; row groups of 6 (24 tokens do not fill 16)
EINSUM = {"aligned": (4, 8, 16, 2, 2), "straddling": (4, 6, 8, 2, 4),
          "shared": (4, 8, 32, 4, 2), "rows": (4, 6, 16, 2, 1)}


@pytest.mark.parametrize("case", list(EINSUM))
def test_einsum_positions_across_ranks_equal_one_device(case):
    rows, S, group, ranks, experts_n = EINSUM[case]
    T = rows * S
    G = group if T % group == 0 else S
    C = max(K, cdiv(int(G * K * 1.0), E))
    ids, w = _ids(T, seed=len(case))
    whole, pad0 = M.gshard_combine(w, ids, G=G, C=C, expert0=0, experts=E)
    assert pad0 == 0 and whole.shape == (T // G, G, E, C)
    # capacities bite: some choices are dropped, most kept
    kept = int((whole > 0).sum())
    assert 0 < kept < T * K
    n = T // ranks
    El = E // experts_n
    exchanged = 0
    for r in range(ranks):
        for m in range(experts_n):
            e0 = m * El
            gather = _Gather(_hand_counts(ids, ranks, e0, El, G), r)
            split = M.Split(ranks=ranks, index=r, gather=gather, expert0=e0)
            got, pad = M.gshard_combine(w[r * n:(r + 1) * n],
                                        ids[r * n:(r + 1) * n], G=G, C=C,
                                        expert0=e0, experts=El, split=split)
            g0 = r * n // G
            want = whole[g0:g0 + got.shape[0], :, e0:e0 + El].clone()
            # the rank's positions of its groups: the others' are zero
            mine = torch.zeros(got.shape[0] * G, dtype=torch.bool)
            mine[pad:pad + n] = True
            want[~mine.reshape(got.shape[0], G)] = 0
            assert torch.equal(got, want), (case, r, m)
            exchanged += gather.calls
    # counts are exchanged only where a rank's tokens do not fill its groups
    assert (exchanged > 0) == (case in ("straddling", "shared")), case


def test_sort_slots_across_ranks_equal_one_device():
    """The sort dispatch over 4 batch ranks of 8 tokens, experts over 2
    "model" ranks: each rank's slot of every (token, choice) is the whole
    batch's slot in its expert block, or the sentinel."""
    T, ranks, experts_n = 32, 4, 2
    C = max(K, cdiv(int(T * K * 1.0), E))
    ids, _ = _ids(T, seed=5)
    order, slot = M.sort_slots(ids, E=E, C=C, expert0=0, experts=E)
    whole = torch.empty_like(slot)
    whole[order] = slot                      # by (token, choice)
    whole = whole.reshape(T, K)
    assert 0 < int((whole < E * C).sum()) < T * K
    n, El = T // ranks, E // experts_n
    for r in range(ranks):
        counts = torch.stack([torch.bincount(ids[q * n:(q + 1) * n].reshape(-1),
                                             minlength=E)
                              for q in range(ranks)])
        for m in range(experts_n):
            e0 = m * El
            gather = _Gather(counts, r)
            split = M.Split(ranks=ranks, index=r, gather=gather, expert0=e0)
            o, s = M.sort_slots(ids[r * n:(r + 1) * n], E=E, C=C,
                                expert0=e0, experts=El, split=split)
            got = torch.empty_like(s)
            got[o] = s
            got = got.reshape(n, K)
            want = whole[r * n:(r + 1) * n]
            e = ids[r * n:(r + 1) * n]
            ours = (e >= e0) & (e < e0 + El) & (want < E * C)
            want = torch.where(ours, want - e0 * C, El * C)
            assert torch.equal(got, want), (r, m)
            assert gather.calls == 1


def _params(d, F, seed):
    g = torch.Generator().manual_seed(seed)
    return {"router": {"w": torch.randn(d, E, generator=g)},
            "gate": torch.randn(E, d, F, generator=g) * d ** -0.5,
            "up": torch.randn(E, d, F, generator=g) * d ** -0.5,
            "down": torch.randn(E, F, d, generator=g) * F ** -0.5}


def _grads(params, x, r, split=None, lo=0, hi=E, coef=0.5):
    p = {"router": {"w": params["router"]["w"].clone().requires_grad_()},
         **{k: params[k][lo:hi].clone() for k in ("gate", "up", "down")}}
    xx = x.clone().requires_grad_()
    out, aux = M.moe_block(p, xx, top_k=K, impl="einsum",
                           capacity_factor=1.25, group=16, split=split)
    ((out * r).sum() + coef * aux).backward()
    return out.detach(), aux.detach(), xx.grad, p["router"]["w"].grad


@pytest.mark.parametrize("counted", ["once", "every rank"])
def test_aux_gradient_is_counted_once(counted):
    """One batch rank's tokens on 4 "model" ranks of 2 experts each: the
    ranks' outputs, input gradients and router gradients summed (the
    output's reduce, the input's and the router's gradient sums) equal one
    device's, the aux the same on every rank, where the aux's gradient
    flows from rank 0 alone; where it flows from every rank, the sums miss
    one device's."""
    d, F, n = 16, 24, 4
    params = _params(d, F, seed=3)
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(2, 16, d, generator=gen)
    r = torch.randn(2, 16, d, generator=gen)
    out1, aux1, dx1, dw1 = _grads(params, x, r)
    El = E // n
    parts = [_grads(params, x, r, M.Split(expert0=m * El,
                                          aux_grad=m == 0 or
                                          counted == "every rank"),
                    m * El, (m + 1) * El) for m in range(n)]
    out = sum(p[0] for p in parts)
    dx, dw = sum(p[2] for p in parts), sum(p[3] for p in parts)
    torch.testing.assert_close(out, out1, rtol=1e-5, atol=1e-6)
    assert all(torch.equal(p[1], aux1) for p in parts)
    if counted == "once":
        torch.testing.assert_close(dx, dx1, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(dw, dw1, rtol=1e-5, atol=1e-6)
    else:
        assert not torch.allclose(dw, dw1, rtol=1e-3, atol=1e-4)
        assert not torch.allclose(dx, dx1, rtol=1e-3, atol=1e-4)
