"""The multitask train kernels' host-side plan and band schedule
(``ops/flash_train.py``: ``bidir_tile_map``, ``cross_band_classes``,
``dq_group``) and the kernels' band schedule on the CPU.

The bidirectional kernels skip a tile pair whose 64 keys are all padded,
unless its batch row has no visible key at all; the claim the skip rests on
is that the plain softmax gives exactly 0 there. The band schedule is the
one ``csrc/flash_mt.cu`` walks (``lo_src`` / ``hi_src``): a pure-torch model
of its chunk products, with the hi chunk's j <= i part carried to the next
key tile and a fresh lo chunk at a walk's start or after a skipped tile,
rebuilds the plain versions' BD exactly, and its D tiles (dS unskewed onto
each chunk, completed once) rebuild BD's gradient exactly. Integer-valued
inputs keep every float32 product and sum exact, so "exactly" holds for any
summation order. The kernels themselves run only on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from deepmusicgeneration_tpu_torch.ops import flash_train as ft

T = ft.TILE
B, H, Dh, W = 2, 2, 16, 4 * T


def _pad(kind, Bn=B, Wn=W):
    """(Bn, Wn) bool key padding: none, chip_smoke.py's leading padding
    (row b pads its first (37 b) mod (W / 2) keys), trailing padding (row b
    pads its last 70 b keys), or one fully padded batch row beside rows with
    leading padding."""
    j = torch.arange(Wn)[None, :]
    b = torch.arange(Bn)[:, None]
    if kind == "none":
        return torch.zeros(Bn, Wn, dtype=torch.bool)
    if kind == "leading":
        return j < (37 * b) % (Wn // 2)
    if kind == "trailing":
        return j >= Wn - 70 * b
    mask = j < (37 * b) % (Wn // 2)
    mask[1] = True
    return mask


def _expected(pad):
    """The classes from the (B, W, W) mask itself: padded keys blocked."""
    Bn, Wn = pad.shape
    blocked = pad[:, None, :].expand(Bn, Wn, Wn)
    t = blocked.reshape(Bn, Wn // T, T, Wn // T, T)
    all_blocked, none_blocked = t.all(-1).all(2), ~t.any(-1).any(2)
    row_blocked = blocked.all(-1).reshape(Bn, Wn // T, T).any(-1)
    want = torch.full(all_blocked.shape, ft.MIXED, dtype=torch.int32)
    want[none_blocked] = ft.VISIBLE
    want[all_blocked & ~row_blocked[:, :, None]] = ft.SKIP
    return want, row_blocked


@pytest.mark.parametrize("kind", ["none", "leading", "trailing", "full_row"])
def test_bidir_tile_map_matches_the_mask(kind):
    pad = _pad(kind, 4, 8 * T)
    got = ft.bidir_tile_map(pad.to(torch.int32))
    want, row_blocked = _expected(pad)
    assert got.dtype == torch.int32 and got.shape == (4, 8, 8)
    assert torch.equal(got, want)
    assert (got == ft.SKIP).any() == (kind in ("leading", "trailing", "full_row"))
    if kind == "full_row":
        # the fully padded row skips nothing: P is 1 / W on each of its keys
        assert row_blocked[1].all() and (got[1] == ft.MIXED).all()


def test_chip_smoke_rows_padding_skips_the_last_two_key_tiles():
    """chip_smoke.py's "rows" padding: batch row 0 fully padded (nothing
    skipped), row 1's last two key tiles skipped for every query tile."""
    inp = cs.train_inputs(4, 4 * T, 4 * T, 1, 32, torch.device("cpu"), 0, pad="rows")
    tiles = ft.bidir_tile_map(inp["pad"].to(torch.int32))
    assert (tiles[0] == ft.MIXED).all()
    assert (tiles[1, :, 2:] == ft.SKIP).all() and (tiles[1, :, :2] == ft.VISIBLE).all()
    # rows 2 and 3: leading padding of 74 and 111 keys, key tile 0 skipped
    assert (tiles[2:, :, 0] == ft.SKIP).all() and (tiles[2:, :, 1] == ft.MIXED).all()


@pytest.mark.parametrize("kind", ["leading", "trailing", "full_row"])
def test_skipped_pairs_have_zero_probability(kind):
    """The plain softmax over -1e9-filled scores is exactly 0 on every pair of
    a skipped tile, and 1 / W on every pair of a fully padded row."""
    pad = _pad(kind, 4, 8 * T)
    Wn = pad.shape[1]
    gen = torch.Generator().manual_seed(0)
    s = torch.randn(4, Wn, Wn, generator=gen) * 8.0
    p = torch.softmax(torch.where(pad[:, None, :], ft.NEG_INF, s), -1)
    skip = ft.bidir_tile_map(pad.to(torch.int32)) == ft.SKIP
    assert skip.any()
    per_pair = skip.repeat_interleave(T, 1).repeat_interleave(T, 2)
    assert (p[per_pair] == 0).all()
    rows = pad.all(-1)
    assert rows.any() == (kind == "full_row")
    assert torch.equal(p[rows], torch.full_like(p[rows], 1.0 / Wn))


@pytest.mark.parametrize("L,K", [(256, 256), (128, 256)])
def test_cross_band_classes_match_the_band(L, K):
    classes = ft.cross_band_classes(L, K)
    band = torch.arange(K)[None, :] <= torch.arange(L)[:, None] + (K - L)
    t = band.reshape(L // T, T, K // T, T)
    full, none = t.all(-1).all(1), ~t.any(-1).any(1)
    assert torch.equal(classes == ft.FULL_BD, full)
    assert torch.equal(classes == ft.NO_BD, none)
    assert torch.equal(classes == ft.BAND_EDGE, ~full & ~none)
    # the band's diagonal pairs keep j <= i, their lower triangle
    edge = t.permute(0, 2, 1, 3)[classes == ft.BAND_EDGE]
    assert torch.equal(edge, torch.tril(torch.ones(T, T, dtype=torch.bool)).expand_as(edge))
    if L == K:
        assert int((classes == ft.NO_BD).sum()) == (L // T) * (L // T - 1) // 2
    # no chunk product on a pair above the band, one chunk on its edge
    nq, nk = L // T, K // T
    for qt in range(nq):
        for kt in range(nk):
            lo, hi = band_sources(False, nq, nk, qt, kt)
            assert (lo is None) == (classes[qt, kt] == ft.NO_BD)
            assert (hi is None) == (classes[qt, kt] != ft.FULL_BD)


def test_dq_group_and_partials_at_the_multitask_shape(monkeypatch):
    """B 16, L 512, 8 heads on 132 SMs: G = 2, so the dWkr partial slots take
    67.1 MB (from 134.2 MB with one slot a batch row and query tile)."""
    assert ft.dq_group(16, 512, 8, 132) == 2
    monkeypatch.setattr(ft, "_n_sms", lambda device: 132)
    assert ft.partial_slots(16, 512, 8, "cpu") == 8 * 8
    assert ft.mt_partial_bytes(16, 512, 512, 8, 64, "cpu") == 8 * 8 * 512 * 512 * 4
    assert round(ft.mt_partial_bytes(16, 512, 512, 8, 64, "cpu") / 1e6, 1) == 67.1


# --- the band schedule --------------------------------------------------------

def band_sources(bidir: bool, nq: int, nk: int, qt: int, kt: int):
    """The multitask kernels' band schedule, as ``csrc/flash_mt.cu::lo_src``
    / ``hi_src`` walk it: for tile pair (qt, kt), the chunk whose rows land
    on its j <= i part (lo) and on its j > i part (hi), each None or (row,
    chain):
    wkr rows row .. row + 63 (a row < 0 reads zero) times qv rows i0 + chain
    .. (chain 1: the bidirectional spill's next rows). Pair (i, j)'s lo value
    is chunk row j - i + 63, its hi value chunk row j - i - 1. The hi chunk
    of kt is the lo chunk of kt + 1."""
    if bidir:
        lo = (T * (nk - 1 - qt + kt), 0) if kt <= qt else (T * (kt - qt - 1) - 1, 1)
        hi = (T * (nk - qt + kt), 0) if kt < qt else (T * (kt - qt) - 1, 1)
        return lo, hi
    lo = (T * (kt + nq - 1 - qt), 0) if kt - qt <= nk - nq else None
    hi = (T * (kt + nq - qt), 0) if kt - qt < nk - nq else None
    return lo, hi


def _ints(shape, rng, lo=-4, hi=5):
    return torch.from_numpy(rng.integers(lo, hi, size=shape).astype(np.float32))


def _inputs(L, K, seed):
    """Integer-valued float32 operands; k = 0, so the plain scores are BD."""
    rng = np.random.default_rng(seed)
    return dict(q=_ints((B, L, H * Dh), rng), k=torch.zeros(B, K, H * Dh),
                v=_ints((B, K, H * Dh), rng), wkr=_ints((K, H * Dh), rng),
                u=_ints((H, Dh), rng), vb=_ints((H, Dh), rng),
                g=_ints((B, H, L, K), rng))


def _plain_bd(bidir, inp, L, K, monkeypatch, grad=False):
    """The plain version's scores (= BD with k = 0, before scaling) as
    ``_softmax_pv`` receives them; with ``grad`` the gradients of
    sum(g * BD) for q (= that of qv) and wkr."""
    seen = {}

    def capture(score, v, *args, **kw):
        seen["bd"] = score
        return (score * inp["g"]).sum()

    monkeypatch.setattr(ft, "_softmax_pv", capture)
    leaves = [inp[n].clone().requires_grad_(grad) for n in ("q", "k", "v", "wkr", "u", "vb")]
    if bidir:
        out = ft.flash_bidir_attention_plain(*leaves, H)
    else:
        out = ft.flash_cross_attention_plain(*leaves, H)
    if not grad:
        return seen["bd"].detach()
    out.backward()
    return seen["bd"].detach(), leaves[0].grad, leaves[3].grad


def _operands(inp, L, K):
    """qv (B, H, L, Dh) and wkr (H, K, Dh), as the kernels read them."""
    qv = (inp["q"].reshape(B, L, H, Dh) + inp["vb"]).transpose(1, 2)
    return qv, inp["wkr"].reshape(K, H, Dh).transpose(0, 1)


def _chunk(wkr, row):
    """wkr rows row .. row + 63 of every head, zero outside [0, K) (TMA's
    out-of-bounds fill)."""
    K = wkr.shape[1]
    rows = torch.arange(row, row + T)
    ok = (rows >= 0) & (rows < K)
    return torch.where(ok[None, :, None], wkr[:, rows.clamp(0, K - 1)], 0.0)


def _qop(qv, qt, ch):
    """qv rows qt * 64 + ch .. of the chain ch (every head of one batch
    row), zero past L."""
    L = qv.shape[1]
    rows = torch.arange(T) + qt * T + ch
    ok = rows < L
    return torch.where(ok[:, None], qv[:, rows.clamp(max=L - 1)], 0.0)


I_, R_ = torch.meshgrid(torch.arange(T), torch.arange(T), indexing="ij")
LO_PART = R_ + I_ >= T - 1            # chunk row r of query row i lands on j <= i
J_ = (R_ + I_ + 1) % T                # at column j
UPPER = I_ < R_                       # a band tile's j > i part, indexed [i, j]


def _land(band, prod, part):
    band[:, I_[part], J_[part]] = prod[:, part]


def _walks(bidir, L, K, pad):
    """walks[b][qt]: the key tiles the kernels visit for query tile qt of
    batch row b: every one for cross, those ``bidir_tile_map`` does not
    skip for bidir."""
    nq, nk = L // T, K // T
    if not bidir:
        return [[list(range(nk)) for _ in range(nq)] for _ in range(B)]
    tiles = ft.bidir_tile_map(pad.to(torch.int32))
    return [[[kt for kt in range(nk) if tiles[b, qt, kt] != ft.SKIP] for qt in range(nq)]
            for b in range(B)]


def _walked(walks, L, K):
    """(B, L, K) bool: the pairs of the walked tiles."""
    m = torch.zeros(B, L // T, K // T, dtype=torch.bool)
    for b, row in enumerate(walks):
        for qt, walk in enumerate(row):
            m[b, qt, walk] = True
    return m.repeat_interleave(T, 1).repeat_interleave(T, 2)


def _model_bd(bidir, qv, wkr, L, K, walks):
    """BD of one batch row (H, L, K) as the forward kernel forms it, tile
    pair by tile pair along each query tile's walk."""
    nq, nk = L // T, K // T
    bd = torch.full((H, L, K), float("nan"))
    for qt, walk in enumerate(walks):
        band = torch.full((H, T, T), float("nan"))
        for n, kt in enumerate(walk):
            lo, hi = band_sources(bidir, nq, nk, qt, kt)
            if lo is None:                       # cross above the band: no BD
                bd[:, qt * T:(qt + 1) * T, kt * T:(kt + 1) * T] = 0.0
                continue
            if n == 0 or walk[n - 1] != kt - 1:  # a fresh lo chunk
                _land(band, _qop(qv, qt, lo[1]) @ _chunk(wkr, lo[0]).transpose(1, 2), LO_PART)
            if hi is None:
                band[:, UPPER] = 0.0
            else:
                c = _qop(qv, qt, hi[1]) @ _chunk(wkr, hi[0]).transpose(1, 2)
                _land(band, c, ~LO_PART)
            bd[:, qt * T:(qt + 1) * T, kt * T:(kt + 1) * T] = band
            if hi is not None:
                _land(band, c, LO_PART)          # the next pair's lo part
    return bd


def _model_grads(bidir, qv, wkr, g, L, K, walks):
    """The gradients of sum(g * BD) of one batch row for its qv (H, L, Dh)
    and for wkr (H, K, Dh) as the dQ pass forms them: g unskewed onto each
    chunk's D tile (its j > i part from the pair whose hi chunk it is, its
    j <= i part from the pair whose lo chunk it is, zero where that pair is
    not walked), each completed once: dqv += D chunk, dwkr rows += D^T qv."""
    nq, nk = L // T, K // T
    dqv, dwkr = torch.zeros_like(qv), torch.zeros_like(wkr)
    hi_part = ~LO_PART
    for qt, walk in enumerate(walks):
        tiles = {}
        for n, kt in enumerate(walk):
            lo, hi = band_sources(bidir, nq, nk, qt, kt)
            if lo is None:
                continue
            prev_ok = n > 0 and walk[n - 1] == kt - 1
            next_ok = hi is not None and n + 1 < len(walk) and walk[n + 1] == kt + 1
            gt = g[:, qt * T:(qt + 1) * T, kt * T:(kt + 1) * T]
            if not prev_ok:
                tiles[lo] = torch.zeros(H, T, T)
            tiles[lo][:, LO_PART] = gt[:, I_[LO_PART], J_[LO_PART]]
            done = [lo]
            if hi is not None:
                tiles[hi] = torch.zeros(H, T, T)
                tiles[hi][:, hi_part] = gt[:, I_[hi_part], J_[hi_part]]
                if not next_ok:
                    done.append(hi)
            for src in done:
                d = tiles.pop(src)
                (row, ch), c = src, _chunk(wkr, src[0])
                rows = torch.arange(T) + qt * T + ch
                ok = rows < L
                dqv[:, rows[ok]] += (d @ c)[:, ok]
                w = d.transpose(-1, -2) @ _qop(qv, qt, ch)
                wr = torch.arange(row, row + T)
                dwkr[:, wr[wr >= 0]] += w[:, wr >= 0]
    return dqv, dwkr


CASES = [("bidir", 256, 256, "none"), ("bidir", 256, 256, "trailing"),
         ("bidir", 256, 256, "full_row"), ("cross", 256, 256, "none"),
         ("cross", 128, 256, "none")]


@pytest.mark.parametrize("kind,L,K,pad", CASES)
def test_chunk_schedule_rebuilds_the_plain_bd(kind, L, K, pad, monkeypatch):
    bidir = kind == "bidir"
    inp = _inputs(L, K, seed=L + K)
    want = _plain_bd(bidir, inp, L, K, monkeypatch)
    qv, wkr = _operands(inp, L, K)
    walks = _walks(bidir, L, K, _pad(pad, B, L))
    walked = _walked(walks, L, K)
    assert (not walked.all()) == (pad == "trailing")
    for b in range(B):
        got = _model_bd(bidir, qv[b], wkr, L, K, walks[b])
        assert torch.equal(got[:, walked[b]], want[b][:, walked[b]])
        if bidir:     # the column j = i + 1 reads wkr row -1: zero
            i = torch.arange(L - 1)
            assert (got[:, i, i + 1][:, walked[b][i, i + 1]] == 0).all()


@pytest.mark.parametrize("kind,L,K,pad", CASES[1:2] + CASES[3:])
def test_d_tiles_rebuild_the_band_gradient(kind, L, K, pad, monkeypatch):
    """With g zero on the pairs no walk visits (their P is 0), the D tiles'
    dqv and dwkr equal autograd's through the plain version's BD."""
    bidir = kind == "bidir"
    inp = _inputs(L, K, seed=L + 2 * K)
    walks = _walks(bidir, L, K, _pad(pad, B, L))
    inp["g"] = inp["g"] * _walked(walks, L, K)[:, None]
    _, dq_want, dw_want = _plain_bd(bidir, inp, L, K, monkeypatch, grad=True)
    qv, wkr = _operands(inp, L, K)
    dqv = torch.zeros_like(qv)
    dwkr = torch.zeros_like(wkr)
    for b in range(B):
        a, w = _model_grads(bidir, qv[b], wkr, inp["g"][b], L, K, walks[b])
        dqv[b] = a
        dwkr += w
    assert torch.equal(dqv.transpose(1, 2).reshape(B, L, H * Dh), dq_want)
    assert torch.equal(dwkr.transpose(0, 1).reshape(K, H * Dh), dw_want)
