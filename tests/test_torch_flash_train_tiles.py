"""The train attention kernels' tile map (``ops/flash_train.py::tile_map``)
against the mask it is built from (``blocked_mask``), on the CPU: a tile
marked SKIP is fully blocked and its query tile holds no row whose keys are
all blocked; a tile marked VISIBLE holds no blocked pair; every other tile is
MIXED. And the claim the skip rests on: the plain softmax gives exactly 0 on
every skipped pair. The kernels that walk the map run only on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import itertools

import pytest
import torch

from deepmusicgeneration_tpu_torch.ops import flash_train as ft

T = ft.TILE
B, L = 3, 4 * T
PAD = (0, 37, 150)         # batch row b pads its first PAD[b] window keys


def _vectors(M, win_size, win_k, mem_valid, pad):
    pad_mask = None
    if pad:
        pad_mask = torch.arange(L)[None, :] < torch.tensor(PAD)[:, None]
    return ft.mask_vectors(B, L, M + L, win_size, win_k, mem_valid, pad_mask)


def _expected(vecs):
    """The classes from the (B, L, K) mask itself."""
    blocked = ft.blocked_mask(*vecs)[:, 0]
    K = blocked.shape[-1]
    t = blocked.reshape(B, L // T, T, K // T, T)
    all_blocked, none_blocked = t.all(-1).all(2), ~t.any(-1).any(2)
    row_blocked = blocked.all(-1).reshape(B, L // T, T).any(-1)
    want = torch.full(all_blocked.shape, ft.MIXED, dtype=torch.int32)
    want[none_blocked] = ft.VISIBLE
    want[all_blocked & ~row_blocked[:, :, None]] = ft.SKIP
    return want, row_blocked


CASES = [(M, ws, wk, mv, pad)
         for M, (ws, wk), mv, pad in itertools.product(
             (0, 2 * T), ((1, 1), (3, 0), (1, 0), (3, 1)), (0, 40, None), (False, True))
         if not (M == 0 and mv)]


@pytest.mark.parametrize("M,win_size,win_k,mem_valid,pad", CASES)
def test_tile_map_matches_the_mask(M, win_size, win_k, mem_valid, pad):
    vecs = _vectors(M, win_size, win_k, M if mem_valid is None else mem_valid, pad)
    got = ft.tile_map(*vecs)
    want, row_blocked = _expected(vecs)
    assert got.dtype == torch.int32 and got.shape == (B, L // T, (M + L) // T)
    assert torch.equal(got, want)
    # a query tile with a fully blocked row keeps every key tile
    assert not (got[row_blocked] == ft.SKIP).any()


def test_padded_rows_keep_their_query_tile_whole():
    """M = 0, causal, the first 150 keys of row 2 padded: its rows 0..149 see
    no key, so query tiles 0..2 keep all their key tiles, the blocked ones
    above the diagonal too; tile 3 skips above the diagonal as usual."""
    vecs = _vectors(0, 1, 1, 0, True)
    got = ft.tile_map(*vecs)
    assert (got[2, :3] == ft.MIXED).all()
    assert got[2, 3].tolist() == [ft.SKIP, ft.SKIP, ft.MIXED, ft.MIXED]
    assert got[0].tolist() == [[ft.MIXED, ft.SKIP, ft.SKIP, ft.SKIP],
                               [ft.VISIBLE, ft.MIXED, ft.SKIP, ft.SKIP],
                               [ft.VISIBLE, ft.VISIBLE, ft.MIXED, ft.SKIP],
                               [ft.VISIBLE, ft.VISIBLE, ft.VISIBLE, ft.MIXED]]


@pytest.mark.parametrize("M,pad", [(2 * T, False), (0, True)])
def test_skipped_pairs_have_zero_probability(M, pad):
    """The plain softmax over -1e9-filled scores is exactly 0 on every pair of
    a skipped tile, and 1 / K on every pair of a fully blocked row."""
    vecs = _vectors(M, 1, 1, 40 if M else 0, pad)
    K = M + L
    blocked = ft.blocked_mask(*vecs)[:, 0]
    gen = torch.Generator().manual_seed(0)
    s = torch.randn(B, L, K, generator=gen) * 8.0
    p = torch.softmax(torch.where(blocked, ft.NEG_INF, s), -1)
    skip = ft.tile_map(*vecs) == ft.SKIP
    assert skip.any()
    per_pair = skip.repeat_interleave(T, 1).repeat_interleave(T, 2)
    assert (p[per_pair] == 0).all()
    rows = blocked.all(-1)
    assert rows.any() == pad
    assert torch.equal(p[rows], torch.full_like(p[rows], 1.0 / K))


def test_kernel_plan_operands():
    vecs = _vectors(2 * T, 1, 1, 40, True)
    rt, cw, cblk, tiles = ft.kernel_plan(*vecs)
    assert all(t.dtype == torch.int32 and t.is_contiguous() for t in (rt, cw, cblk, tiles))
    assert torch.equal(cblk, ((vecs[2] != 0)[None] | (vecs[3] != 0)).to(torch.int32))
    assert torch.equal(tiles, ft.tile_map(*vecs))


@pytest.mark.parametrize("B_,L_,H,G", [(16, 512, 12, 4), (16, 512, 8, 2), (2, 128, 4, 1),
                                       (6, 512, 12, 2)])
def test_dq_group(B_, L_, H, G):
    """The flagship's shapes: G 4 (genre, 12 heads), 2 (multitask, 8 heads)."""
    assert ft.dq_group(B_, L_, H, 132) == G
