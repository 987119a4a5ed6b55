"""The causal flash prefill's tile schedule on the CPU: a pure-torch model of
how ``csrc/flash_prefill.cu``'s wgmma entry forms its scores.

A block owns query tile qt (64 rows) and walks key tiles 0 .. qt. Pair
(qt, kt) reads the 128 wkr rows from base = W - 64 - 64 qt + 64 kt as two
64-row chunks (lo, hi), zero outside [0, W); BD[i, j] is lo row j - i + 63
for j <= i and hi row j - i - 1 for j > i. Key tile kt's hi chunk product
is carried as kt + 1's lo one, the first lo chunk is multiplied at kt = 0,
and the diagonal pair's hi chunk is not multiplied (zeros). Keys past W are
zero (the 3-D tensor maps' fill) and flagged like padding; the diagonal
pair masks j > i. The model's masked scores are held exactly against the
plain construction (``ops/rel_attention.py``'s ``rel_shift`` skew of qv .
wkr^T, plus qu . k^T, under the causal and key-pad mask): integer-valued
inputs keep every float32 product and sum exact. The kernel itself runs
only on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import pytest
import torch

from deepmusicgeneration_tpu_torch.ops.rel_attention import NEG_INF, rel_shift

T = 64          # the kernel's tile: query rows and keys a tile pair
B, Dh = 2, 8


def _ints(gen, *shape):
    return torch.randint(-3, 4, shape, generator=gen).float()


def _band(wkr, first, n):
    """wkr rows first .. first + n - 1, zero outside [0, W)."""
    W = wkr.shape[0]
    t = torch.arange(first, first + n)
    ok = (t >= 0) & (t < W)
    rows = torch.zeros(n, wkr.shape[1])
    rows[ok] = wkr[t[ok]]
    return rows


def kernel_scores(qu, qv, k, wkr, pad):
    """The masked scores (W, W) of one batch row as the kernel's walk forms
    them; NaN on the pairs it does not visit."""
    W = qu.shape[0]
    nq = -(-W // T)
    zpad = lambda x: torch.cat([x, torch.zeros(nq * T - W, x.shape[1])])
    qu_p, qv_p, k_p = zpad(qu), zpad(qv), zpad(k)
    flags = torch.cat([pad, torch.ones(nq * T - W, dtype=torch.bool)])   # pad, or past W
    s_all = torch.full((nq * T, nq * T), float("nan"))
    i = torch.arange(T)[:, None]
    j = torch.arange(T)[None, :]
    lo_row, hi_row = (j - i + T - 1).clamp(0, T - 1), (j - i - 1).clamp(0, T - 1)
    for qt in range(nq):
        i0 = qt * T
        qu_t, qv_t = qu_p[i0:i0 + T], qv_p[i0:i0 + T]
        clo = None
        for kt in range(qt + 1):
            j0 = kt * T
            base = W - T - i0 + j0
            if kt == 0:
                clo = qv_t @ _band(wkr, base, T).T
            chi = qv_t @ _band(wkr, base + T, T).T if kt < qt else torch.zeros(T, T)
            bd = torch.where(j <= i, clo.gather(1, lo_row), chi.gather(1, hi_row))
            s = qu_t @ k_p[j0:j0 + T].T + bd
            masked = flags[j0:j0 + T][None, :] | ((kt == qt) & (j > i))
            s_all[i0:i0 + T, j0:j0 + T] = torch.where(masked, NEG_INF, s)
            clo = chi
    return s_all[:W, :W]


def plain_scores(qu, qv, k, wkr, pad):
    """qu . k^T + rel_shift(qv . wkr^T) under the causal and key-pad mask."""
    W = qu.shape[0]
    s = qu @ k.T + rel_shift(qv @ wkr.T)
    rows = torch.arange(W)
    blocked = (rows[None, :] > rows[:, None]) | pad[None, :]
    return torch.where(blocked, NEG_INF, s)


@pytest.mark.parametrize("W", [64, 96, 130, 512])
def test_band_schedule_rebuilds_the_plain_scores(W):
    gen = torch.Generator().manual_seed(W)
    pad = torch.zeros(B, W, dtype=torch.bool)
    pad[1, :2 * W // 3] = True          # left padding: rows with every key padded too
    wkr = _ints(gen, W, Dh)
    for b in range(B):
        qu, qv, k = _ints(gen, W, Dh), _ints(gen, W, Dh), _ints(gen, W, Dh)
        got = kernel_scores(qu, qv, k, wkr, pad[b])
        want = plain_scores(qu, qv, k, wkr, pad[b])
        seen = ~torch.isnan(got)
        assert torch.equal(got[seen], want[seen])
        # what the walk skips, the plain version masks
        assert bool((want[~seen] == NEG_INF).all())


@pytest.mark.parametrize("W", [1, 63, 64, 65, 96, 127, 128, 130, 200, 512, 4096])
def test_causal_walk_visits_the_pairs_with_some_j_le_i(W):
    """Pair (qt, kt) holds some real (i, j) with j <= i exactly when kt <=
    qt; the band copies the kernel makes stay in [0, W) but the first lo
    chunk (below 0 only when W % 64 != 0) and the diagonal's hi chunk (not
    copied: rows W .. W + 63)."""
    nq = -(-W // T)
    rows = torch.arange(nq * T)
    real = rows < W
    pair = ((rows[None, :] <= rows[:, None]) & real[:, None] & real[None, :])
    some = pair.reshape(nq, T, nq, T).any(3).any(1)
    assert torch.equal(some, torch.ones(nq, nq, dtype=torch.bool).tril())
    for qt in range(nq):
        for kt in range(qt + 1):
            base = W - T - T * qt + T * kt
            if kt > 0:
                assert 0 <= base and base + T <= W          # lo chunk: the carried hi one
            assert base >= 0 or (kt == 0 and W % T)
            if kt < qt:
                assert 0 <= base + T and base + 2 * T <= W  # hi chunk, copied by TMA
            else:
                assert base + T == W                        # diagonal: rows W .. W + 63
