"""The plan of the tensor-core decode chain (``csrc/tc_decode.cuh``) of the
slab4_w8 and multirow_int8 steps at B >= 8, mirrored in
``ops/fused_decode.py`` and held here on the CPU: the products' tiling and
partial order, the dequantized weight tile, the attention's row clusters,
the shared memory rule and the launch count. The kernels themselves run on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import numpy as np
import pytest
import torch

from deepmusicgeneration_tpu_torch.models.config import small_test_config
from deepmusicgeneration_tpu_torch.models.txl import txl_config_41m
from deepmusicgeneration_tpu_torch.ops import fused_decode as fd

FLAGSHIP = txl_config_41m()
SMALL = small_test_config()


def _products(cfg):
    """(K, N, cluster) of a layer's four products: qkv, out, ff1 (its K
    chunks one cluster), ff2."""
    D, Dff, HD = cfg.d_model, cfg.d_inner, cfg.n_heads * cfg.d_head
    return [(D, 3 * HD, False), (HD, D, False), (D, Dff, True), (Dff, D, False)]


def tc_product_model(x, w, cluster=False):
    """The product as the kernel tiles it: rows in groups of TC_ROWS, each
    zero-padded to its 8 n8_tiles rows; columns in tiles of TC_COLS; K in
    chunks of kc rows, each brought in stages of TC_STAGE_K and multiplied
    16 rows a step (the MMA's k16), a chunk's partial summed over its steps
    in order; the partials of a column summed in chunk order by their
    consumer. float32 throughout."""
    B, K = x.shape
    N = w.shape[1]
    plan = fd.tc_product_plan(B, K, N, cluster)
    kc, rows = plan["kc"], 8 * plan["n8_tiles"]
    y = torch.zeros(B, N)
    for g in range(plan["row_groups"]):
        xg = torch.zeros(rows, K)
        part = x[g * fd.TC_ROWS:(g + 1) * fd.TC_ROWS]
        xg[:len(part)] = part
        for t in range(plan["col_tiles"]):
            cols = slice(t * fd.TC_COLS, (t + 1) * fd.TC_COLS)
            partials = []
            for kb in range(plan["k_blocks"]):
                acc = torch.zeros(rows, w[:, cols].shape[1])
                for st in range(kb * kc, min(K, (kb + 1) * kc), fd.TC_STAGE_K):
                    for k16 in range(st, min(K, st + fd.TC_STAGE_K, (kb + 1) * kc), 16):
                        acc += xg[:, k16:k16 + 16] @ w[k16:k16 + 16, cols]
                partials.append(acc)
            total = torch.zeros_like(partials[0])
            for p in partials:                        # chunk order
                total = total + p
            y[g * fd.TC_ROWS:(g + 1) * fd.TC_ROWS, cols] = total[:len(part)]
    return y


@pytest.mark.parametrize("cfg", [FLAGSHIP, SMALL], ids=["flagship", "small"])
@pytest.mark.parametrize("B", [8, 24, 64])
def test_product_tiling_equals_the_plain_product(cfg, B):
    """On integer-valued inputs (every sum exact in float32) the tiled
    product equals x @ w for every product of a layer, and the plan covers
    K and N with whole stages and no chunk past K."""
    rng = np.random.default_rng(B)
    for K, N, cluster in _products(cfg):
        plan = fd.tc_product_plan(B, K, N, cluster)
        kc = plan["kc"]
        assert kc % fd.TC_STAGE_K == 0 and (plan["k_blocks"] - 1) * kc < K <= plan["k_blocks"] * kc
        assert (plan["col_tiles"] - 1) * fd.TC_COLS < N <= plan["col_tiles"] * fd.TC_COLS
        assert 8 * plan["n8_tiles"] >= min(B, fd.TC_ROWS)
        if cluster:
            assert plan["k_blocks"] <= fd.TC_MAX_CLUSTER
        x = torch.from_numpy(rng.integers(-3, 4, (B, K)).astype(np.float32))
        w = torch.from_numpy(rng.integers(-3, 4, (K, N)).astype(np.float32))
        assert torch.equal(tc_product_model(x, w, cluster), x @ w)


def test_k_chunks_depend_on_the_widths_alone():
    """A row's partial order is fixed by K and N: every B takes the same K
    chunks, so a row's sums do not depend on its batch; the flagship's
    products split K no further than filling the card's 132 SMs needs."""
    for K, N, cluster in _products(FLAGSHIP):
        plans = [fd.tc_product_plan(B, K, N, cluster) for B in (8, 9, 24, 64, 100)]
        assert len({(p["kc"], p["k_blocks"]) for p in plans}) == 1
    got = {(K, N): (fd.tc_product_plan(64, K, N, c)["k_blocks"],
                    fd.tc_product_plan(64, K, N, c)["col_tiles"])
           for K, N, c in _products(FLAGSHIP)}
    assert got == {(512, 2304): (4, 36), (768, 512): (12, 8), (512, 3072): (3, 48),
                   (3072, 512): (16, 8)}
    for (K, N), (kb, tiles) in got.items():        # no more chunks than filling needs
        assert kb <= -(-fd.TC_TARGET_BLOCKS // tiles)


def test_row_padding_of_the_batch():
    """Rows past B are zeros in the last row group and come out of no
    product: B = 24 takes 4 n8 tiles (32 rows), B = 100 two groups of 64."""
    assert fd.tc_product_plan(24, 512, 2304)["n8_tiles"] == 4
    p = fd.tc_product_plan(100, 512, 2304)
    assert (p["row_groups"], p["n8_tiles"]) == (2, 8)
    x = torch.arange(100 * 32, dtype=torch.float32).reshape(100, 32) % 5
    w = torch.ones(32, 80)
    assert torch.equal(tc_product_model(x, w), x @ w)


def test_dequantized_tile_is_the_bf16_upcast():
    """The kernel's staged int8 tile, dequantized by its column scales and
    rounded to bf16 (columns past N scaled by 0), equals
    quantize_stacked_weights' panels upcast as the plain version does, bit
    for bit, including the ragged last column tile."""
    g = torch.Generator().manual_seed(3)
    L, D, Dff, H, Dh = 1, 64, 96, 2, 16
    HD = H * Dh
    w = lambda *s: torch.randn(*s, generator=g) * 0.05
    stacked = fd.StackedTXL(qkv_w=w(L, D, 3 * HD), out_w=w(L, HD, D), ff1_w=w(L, D, Dff),
                            ff1_b=w(L, 1, Dff), ff2_w=w(L, Dff, D), ff2_b=w(L, 1, D),
                            ln1_g=w(L, 1, D), ln1_b=w(L, 1, D), ln2_g=w(L, 1, D),
                            ln2_b=w(L, 1, D), u=w(1, HD), v=w(1, HD))
    q, w_scales = fd.quantize_stacked_weights(stacked)
    for row, panel in ((2, q.ff1_w), (0, q.qkv_w)):
        K, N = panel.shape[1:]
        plain = fd._bf(panel[0].float() * w_scales[0, row:row + 1, :N])
        for n0 in range(0, N, fd.TC_COLS):
            for k0 in range(0, K, fd.TC_STAGE_K):
                raw = torch.zeros(fd.TC_STAGE_K, fd.TC_COLS, dtype=torch.int8)
                part = panel[0, k0:k0 + fd.TC_STAGE_K, n0:n0 + fd.TC_COLS]
                raw[:part.shape[0], :part.shape[1]] = part
                sc = torch.zeros(fd.TC_COLS)
                sc[:part.shape[1]] = w_scales[0, row, n0:n0 + part.shape[1]]
                tile = (raw.float() * sc).to(torch.bfloat16)
                want = plain[k0:k0 + fd.TC_STAGE_K, n0:n0 + fd.TC_COLS].to(torch.bfloat16)
                assert torch.equal(tile[:part.shape[0], :part.shape[1]].view(torch.int16),
                                   want.view(torch.int16))
                assert not tile[:, part.shape[1]:].float().any()


@pytest.mark.parametrize("B", [8, 10, 24, 64])
def test_attention_clusters_cover_each_row_and_head_once(B):
    """The grouped attention's clusters (GROUP_ROWS consecutive rows of one
    head, a block a row) hold every (row, head) with row < B exactly once;
    rows past B occur only in a head's last cluster."""
    H = 12
    clusters = fd.tc_attention_clusters(B, H)
    assert len(clusters) == -(-B // fd.GROUP_ROWS) * H
    assert all(len(rows) == fd.GROUP_ROWS for _, rows in clusters)
    seen = [(b, h) for h, rows in clusters for b in rows if b < B]
    assert sorted(seen) == sorted((b, h) for b in range(B) for h in range(H))
    padded = [(h, b) for h, rows in clusters for b in rows if b >= B]
    assert all(b < -(-B // fd.GROUP_ROWS) * fd.GROUP_ROWS for _, b in padded)
    assert len(padded) == H * (-(-B // fd.GROUP_ROWS) * fd.GROUP_ROWS - B)


def test_tc_path_rule():
    """The chain serves slab4_w8 and multirow_int8 at B >= 8 at the
    flagship's and small widths, never another mode or B < 8, and not
    where the attention block's shared memory would pass a block's."""
    for cfg in (FLAGSHIP, SMALL):
        for mode in fd.SLAB_MODES + fd.MULTIROW_MODES + fd.STACK_MODES:
            for B in (1, 4, 7, 8, 24, 64):
                want = mode in ("slab4_w8", "multirow_int8") and B >= 8
                assert fd.tc_path(mode, cfg, B, cfg.mem_len) == want, (mode, B)
    assert fd.tc_attention_smem(64, 512, True) <= fd.MAX_SMEM
    assert not fd.tc_path("multirow_int8", FLAGSHIP, 64, 8192)
    assert not fd.tc_path("slab4_w8", FLAGSHIP, 64, 520)     # mem_len % 16


@pytest.mark.parametrize("mode", fd.SLAB_MODES + fd.MULTIROW_MODES + fd.STACK_MODES)
def test_launch_count_mirror(mode):
    """Kernels a wrapper launch makes, as the kernel library counts them
    (``*_kernels_per_step``; compared on the card): 7 a layer on the
    tensor-core chain, else the chain's 8 and the attention's 2 (4 in the
    int8-score modes)."""
    L = FLAGSHIP.n_layers
    tc = fd.tc_path(mode, FLAGSHIP, 64, FLAGSHIP.mem_len)
    want = 7 * L if tc else (12 * L if mode in fd.INT8_SCORE_MODES else 10 * L)
    assert fd.planned_kernels_per_step(L, mode, tc) == want
    assert fd.planned_kernels_per_step(L, mode, False) == (12 * L if mode in fd.INT8_SCORE_MODES
                                                           else 10 * L)
