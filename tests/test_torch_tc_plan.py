"""The plan of the tensor-core decode chain (``csrc/tc_decode.cuh``) of the
slab4_w8, slab4, slab_int8, slab, slab_ar_w8, slab_ar and multirow_int8
steps at B >= 8 and of the multirow and slab_w8 steps and row 10's
fused_stack / fused_batched steps at every B, mirrored in
``ops/fused_decode.py`` and held here on the CPU: the products' tiling and
partial order, the dequantized weight tile, the attention's row clusters,
the shared memory of each attention policy, each mode's library entry and
minimum B against the sources, the bf16 K panel's key-dot split, the
head-major V's address map, the launch count, the scratch layout, and
slab_int8's cells and the sources of its two scales.
The kernels themselves run on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""

import re
from pathlib import Path

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
@pytest.mark.parametrize("B", [1, 2, 4, 8, 24, 64, 72, 128])
def test_product_tiling_equals_the_plain_product(cfg, B):
    """On integer-valued inputs (every sum exact in float32) the tiled
    product equals x @ w for every product of a layer, and the plan covers
    K and N with whole stages and no chunk past K; B = 1, 2 and 4 (slab_w8's
    and multirow's chain below 8 rows) take one n8 tile with padded rows,
    B = 72 and 128 (the all-rows steps of generate_batch) two row groups of
    TC_ROWS."""
    rng = np.random.default_rng(B)
    for K, N, cluster in _products(cfg):
        plan = fd.tc_product_plan(B, K, N, cluster)
        kc = plan["kc"]
        assert kc % fd.TC_STAGE_K == 0 and (plan["k_blocks"] - 1) * kc < K <= plan["k_blocks"] * kc
        assert (plan["col_tiles"] - 1) * fd.TC_COLS < N <= plan["col_tiles"] * fd.TC_COLS
        assert 8 * plan["n8_tiles"] >= min(B, fd.TC_ROWS)
        if cluster:
            assert plan["k_blocks"] <= fd.TC_MAX_CLUSTER
        assert plan["row_groups"] == -(-B // fd.TC_ROWS)
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


@pytest.mark.parametrize("B", [1, 3, 8, 10, 24, 64])
def test_attention_clusters_cover_each_row_and_head_once(B):
    """The grouped attention's clusters (GROUP_ROWS consecutive rows of one
    head, a block a row) hold every (row, head) with row < B exactly once;
    rows past B occur only in a head's last cluster (at B = 1, slab_w8's
    single stream, three padded rows of one cluster a head)."""
    H = 12
    clusters = fd.tc_attention_clusters(B, H)
    assert len(clusters) == -(-B // fd.GROUP_ROWS) * H
    assert all(len(rows) == fd.GROUP_ROWS for _, rows in clusters)
    seen = [(b, h) for h, rows in clusters for b in rows if b < B]
    assert sorted(seen) == sorted((b, h) for b in range(B) for h in range(H))
    padded = [(h, b) for h, rows in clusters for b in rows if b >= B]
    assert all(b < -(-B // fd.GROUP_ROWS) * fd.GROUP_ROWS for _, b in padded)
    assert len(padded) == H * (-(-B // fd.GROUP_ROWS) * fd.GROUP_ROWS - B)


# the modes whose chain serves every B (their timing against the old chain
# set the minimum at 1), and those it serves from B = 8
EVERY_B = ("multirow", "slab_w8", "fused_stack", "fused_batched")
FROM_8 = ("slab4_w8", "slab4", "slab_int8", "slab", "slab_ar_w8", "slab_ar", "multirow_int8")


def test_tc_path_rule():
    """The chain serves slab4_w8, slab4, slab_int8, slab, slab_ar_w8, slab_ar
    and multirow_int8 at B >= 8, and multirow, slab_w8 and row 10's
    fused_stack / fused_batched at every B, at the flagship's and small
    widths; never slab_int8_w8, nor B < 8 in the first set, nor where an
    attention block's shared memory would pass a block's: at Dh 64 every
    grouped policy's limit is M = 3376 (see test_attention_smem_by_policy);
    nor at M = 520 (not a multiple of 16), where chip_smoke.py holds the old
    all-rows, slab_w8 and row-10 chains."""
    for cfg in (FLAGSHIP, SMALL):
        for mode in fd.SLAB_MODES + fd.MULTIROW_MODES + fd.STACK_MODES:
            for B in (1, 2, 4, 7, 8, 24, 64):
                want = mode in EVERY_B or (mode in FROM_8 and B >= 8)
                assert fd.tc_path(mode, cfg, B, cfg.mem_len) == want, (mode, B)
    assert {m: p.min_rows for m, p in fd.TC_POLICY.items()} == {
        "slab4_w8": 8, "multirow_int8": 8, "slab4": 8, "slab_int8": 8, "multirow": 1,
        "slab": 8, "slab_ar_w8": 8, "slab_ar": 8, "slab_w8": 1, "fused_stack": 1,
        "fused_batched": 1}
    assert fd.tc_path("slab_w8", FLAGSHIP, 1, 3376)
    assert not fd.tc_path("slab_w8", FLAGSHIP, 1, 3392)
    assert not fd.tc_path("slab_w8", FLAGSHIP, 1, 520)
    assert not fd.tc_path("slab_w8", FLAGSHIP, 64, 520)
    assert fd.tc_attention_smem(64, 512, "multirow_int8") <= fd.MAX_SMEM
    assert not fd.tc_path("multirow_int8", FLAGSHIP, 64, 8192)
    assert not fd.tc_path("slab4_w8", FLAGSHIP, 64, 520)     # mem_len % 16
    assert not fd.tc_path("slab4", FLAGSHIP, 64, 520)
    assert not fd.tc_path("slab", FLAGSHIP, 64, 520)
    for mode in ("slab_ar_w8", "slab_ar"):
        for B in (8, 64):
            assert not fd.tc_path(mode, FLAGSHIP, B, 520)
        assert fd.tc_path(mode, FLAGSHIP, 8, 512) and fd.tc_path(mode, FLAGSHIP, 128, 512)
        assert not fd.tc_path(mode, FLAGSHIP, 7, 512)
    for mode in ("fused_stack", "fused_batched"):     # row 10: the old chain at M = 520
        for B in (1, 5, 64):
            assert not fd.tc_path(mode, FLAGSHIP, B, 520)
            assert fd.tc_path(mode, FLAGSHIP, B, 512)
        assert fd.tc_path(mode, FLAGSHIP, 3, 3376)
        assert not fd.tc_path(mode, FLAGSHIP, 3, 3392)
    for mode in ("multirow", "slab", "multirow_int8", "slab4", "slab_ar_w8", "slab_ar",
                 "slab_w8"):
        assert fd.tc_path(mode, FLAGSHIP, 8, 3376)
        assert not fd.tc_path(mode, FLAGSHIP, 8, 3392)
    assert not fd.tc_path("slab", FLAGSHIP, 7, 512)
    assert fd.tc_path("multirow", FLAGSHIP, 1, 3376)
    assert not fd.tc_path("multirow", FLAGSHIP, 1, 3392)
    assert not fd.tc_path("multirow", FLAGSHIP, 1, 520)
    # slab_int8's scores block at Dh 64: 4 (9 M + 438) bytes, so M 6400
    # passes and 6416 not; its P.V block is far smaller
    assert fd.tc_scores_i8_smem(64, 512) == 4 * (4 * 64 + 128 + 1536 + 1026 + 32 + 16 + 2052)
    assert fd.tc_pv_i8_smem(64, 6416) < fd.tc_scores_i8_smem(64, 6416)
    assert fd.tc_path("slab_int8", FLAGSHIP, 64, 6400)
    assert not fd.tc_path("slab_int8", FLAGSHIP, 64, 6416)


@pytest.mark.parametrize("cfg", [FLAGSHIP, SMALL], ids=["flagship", "small"])
def test_attention_smem_by_policy(cfg):
    """Each grouped mode's policy's shared memory, against figures worked out by
    hand: floats G Dh + 3 Dh + 3 M + 2 (M + 1) + 32 + G (M + 1), rounded up
    to 4, then the larger of the work buffer (256 x 16 or 8 M floats) and,
    for the head-major panels, the quarter of the head's relative slice
    (Dh / 4 x (M + 1) bf16, rounded up to 16 bytes). Flagship (Dh 64, M
    512): 5096 floats = 20384 bytes, work 16384, stage 16416; small (Dh 16,
    M 64): 728 floats = 2912 bytes, work 16384, stage 528. Each mode's
    attention runs the policy it is mirrored with, and only the head-major
    panels' policies stage."""
    grouped = ("slab4_w8", "multirow_int8", "slab4", "multirow", "slab", "slab_ar_w8",
               "slab_ar", "slab_w8", "fused_stack", "fused_batched")
    want = {FLAGSHIP: {"slab4_w8": 36768, "multirow_int8": 36800, "slab4": 36768,
                       "multirow": 36800, "slab": 36768, "slab_ar_w8": 36768,
                       "slab_ar": 36768, "slab_w8": 36768, "fused_stack": 36800,
                       "fused_batched": 36800},
            SMALL: dict.fromkeys(grouped, 19296)}[cfg]
    got = {m: fd.tc_attention_smem(cfg.d_head, cfg.mem_len, m) for m in grouped}
    assert got == want
    assert {m: (p.attention, p.panel) for m, p in fd.TC_POLICY.items()} == {
        "slab4_w8": ("GroupI4", False), "multirow_int8": ("GroupPanelI8", True),
        "slab4": ("GroupI4", False), "slab_int8": ("ScoresI8", False),
        "multirow": ("GroupPanelBF16", True), "slab": ("GroupSlotI8", False),
        "slab_ar_w8": ("GroupSlotI8", False), "slab_ar": ("GroupSlotI8", False),
        "slab_w8": ("GroupSlotI8", False), "fused_stack": ("GroupHeadMajorBF16", True),
        "fused_batched": ("GroupHeadMajorBF16", True)}
    # at Dh 64 the largest M that fits: 4 ceil4(9 M + 486) + 32 M (+ 32 for a
    # panel's stage) bytes is 231520 (231552) at M 3376, 232608 at 3392
    assert fd.tc_attention_smem(64, 3376, "slab") == 231520
    assert fd.tc_attention_smem(64, 3376, "multirow") == 231552
    assert fd.tc_attention_smem(64, 3392, "slab") == 232608 > fd.MAX_SMEM
    with pytest.raises(ValueError):
        fd.tc_attention_smem(64, 512, "slab_int8")


CSRC = Path(fd.__file__).with_name("csrc")


def _chain_entries(source: str) -> dict:
    """The extern "C" chain entries of ``csrc/<source>.cu`` (``int
    <name>_tc_step(DECODE_STEP_ARGS(...))``) and the minimum B each one's
    ``tc_accepts`` (or ``slot_i8_tc_step``) call states, its named
    constant resolved in the sources and headers."""
    consts = {}
    for path in sorted(CSRC.glob("*.cu*")):
        consts.update((k, int(v)) for k, v in
                      re.findall(r"constexpr int (k\w+) = (\d+);", path.read_text()))
    text = (CSRC / f"{source}.cu").read_text()
    entries = {}
    for name, body in re.findall(r"^int (\w+_tc_step)\(DECODE_STEP_ARGS\([^)]*\)\) \{(.*?)^\}",
                                 text, re.S | re.M):
        (arg,) = re.findall(r"(?:tc_accepts<\w+>|slot_i8_tc_step<\w+>)\((\w+),", body)
        entries[name] = int(arg) if arg.isdigit() else consts[arg]
    return entries


@pytest.mark.parametrize("source", ["slab_decode", "multirow_decode"])
def test_chain_entries_and_minimums_match_the_sources(source):
    """Each mode's TC_POLICY names a chain entry that its source defines,
    every chain entry of the source is named by some mode (no entry for one
    function under a second name), and the minimum B the entry's tc_accepts
    call states is the smallest ``min_rows`` of the modes that bind it: so
    the library takes every B the wrapper sends it, and a mode's own
    minimum (slab_ar_w8's 8 on slab_w8's entry) is the wrapper's rule."""
    entries = _chain_entries(source)
    modes = [m for m in fd.TC_MODES if fd._source(m) == source]
    assert set(entries) == {fd.TC_POLICY[m].entry for m in modes}
    for entry, min_rows in entries.items():
        bound = [fd.TC_POLICY[m].min_rows for m in modes if fd.TC_POLICY[m].entry == entry]
        assert min_rows == min(bound), (entry, min_rows, bound)
    assert {m: fd.TC_POLICY[m].entry for m in modes} == {
        "slab_decode": {"slab4_w8": "slab4_w8_tc_step", "slab4": "slab4_tc_step",
                        "slab_int8": "slab_int8_tc_step", "slab": "slab_tc_step",
                        "slab_ar_w8": "slab_w8_tc_step", "slab_ar": "slab_tc_step",
                        "slab_w8": "slab_w8_tc_step"},
        "multirow_decode": {"multirow_int8": "multirow_int8_tc_step",
                            "multirow": "multirow_tc_step",
                            "fused_stack": "head_major_tc_step",
                            "fused_batched": "head_major_tc_step"}}[source]


def panel_bf16_key_dots(k, qu):
    """GroupPanelBF16::key_dots as the kernel splits the work, float32: the
    head's bf16 K panel ``k`` (Dh, M) and q + u ``qu`` (Dh,); warp w of the
    block's 8 takes d in [w Dh / 8, (w + 1) Dh / 8), lane l the 8-slot runs
    c = l, l + 32, ... (one 16-byte load a d), each slot's sum over the
    warp's d in order; the eight warps' sums added in warp order. Returns
    the dots and how often each (d, slot) was read."""
    Dh, M = k.shape
    warps = fd.ATTN_THREADS // 32
    DW = Dh // warps
    kp = torch.zeros(warps, M)
    seen = torch.zeros(Dh, M, dtype=torch.int32)
    for w in range(warps):
        for lane in range(32):
            for c in range(lane, M // 8, 32):
                run = slice(8 * c, 8 * c + 8)
                acc = torch.zeros(8)
                for d in range(w * DW, (w + 1) * DW):
                    acc = acc + k[d, run] * qu[d]
                    seen[d, run] += 1
                kp[w, run] = acc
    t = torch.zeros(M)
    for w in range(warps):
        t = t + kp[w]
    return t, seen


@pytest.mark.parametrize("Dh,M", [(64, 512), (16, 64), (128, 256)])
def test_panel_bf16_key_dot_split(Dh, M):
    """The split reads every (d, slot) of the head's panel exactly once and
    gives the plain key dots (q + u) . K[:, m] within float32 rounding."""
    rng = np.random.default_rng(Dh + M)
    k = torch.from_numpy(rng.normal(scale=0.5, size=(Dh, M)).astype(np.float32))
    k = k.bfloat16().float()
    qu = torch.from_numpy(rng.normal(size=Dh).astype(np.float32)).bfloat16().float()
    got, seen = panel_bf16_key_dots(k, qu)
    assert torch.equal(seen, torch.ones_like(seen))
    plain = (qu.double()[:, None] * k.double()).sum(0)
    bound = 4 * Dh * 2.0 ** -24 * (qu.double().abs()[:, None] * k.double().abs()).sum(0)
    assert bool(((got.double() - plain).abs() <= bound).all())


def head_major_v_chunk(b, h, m, c, H, Dh, M):
    """GroupHeadMajorBF16::pv's element index of 16-column chunk c of slot m
    of (row b, head h) in a head-major V (B, H, M, Dh): ((b HD + h Dh) M +
    m Dh + 16 c); the chunk is the 16 values from there on, two 16-byte
    loads. HeadMajorBF16::v_index (the slot write's) for column j = h Dh + d
    is the same map at d = 16 c + (d % 16)."""
    return (b * H * Dh + h * Dh) * M + m * Dh + 16 * c


@pytest.mark.parametrize("Dh", [16, 32, 64, 128])
def test_head_major_v_address_map(Dh):
    """The policy's V index, held against the strides of a contiguous
    (B, H, M, Dh) tensor: each (row, head, slot, chunk) reads that slot's 16
    columns of the chunk and nothing else, every element is read by exactly
    one chunk, and each chunk starts on 32 bytes (its two 16-byte loads are
    aligned)."""
    B, H, M = 3, 2, 48
    v = torch.arange(B * H * M * Dh, dtype=torch.int64).reshape(B, H, M, Dh)
    flat = v.flatten()
    seen = torch.zeros(flat.numel(), dtype=torch.int32)
    st = v.stride()
    for b in range(B):
        for h in range(H):
            for m in range(M):
                for c in range(Dh // 16):
                    at = head_major_v_chunk(b, h, m, c, H, Dh, M)
                    assert at == b * st[0] + h * st[1] + m * st[2] + 16 * c * st[3]
                    assert (2 * at) % 32 == 0
                    assert torch.equal(flat[at:at + 16], v[b, h, m, 16 * c:16 * c + 16])
                    seen[at:at + 16] += 1
    assert torch.equal(seen, torch.ones_like(seen))


@pytest.mark.parametrize("mode", fd.SLAB_MODES + fd.MULTIROW_MODES + fd.STACK_MODES)
def test_launch_count_mirror(mode):
    """Kernels a wrapper launch makes, as the kernel library counts them
    (``*_kernels_per_step``; compared on the card): 7 a layer on the
    tensor-core chain (9 for slab_int8: its attention is three kernels),
    else the chain's 8 and the attention's 2 (4 in the int8-score modes);
    at B = 7 only multirow, slab_w8 and row 10's steps take the chain (56
    kernels a step at the flagship), so the others count the old chain's (80
    a step for the all-rows steps)."""
    L = FLAGSHIP.n_layers
    tc = fd.tc_path(mode, FLAGSHIP, 64, FLAGSHIP.mem_len)
    int8 = mode in fd.INT8_SCORE_MODES
    assert tc == (mode in fd.TC_MODES)
    assert fd.tc_path(mode, FLAGSHIP, 7, FLAGSHIP.mem_len) == (mode in EVERY_B)
    assert fd.tc_path(mode, FLAGSHIP, 1, FLAGSHIP.mem_len) == (mode in EVERY_B)
    want = (9 * L if int8 else 7 * L) if tc else (12 * L if int8 else 10 * L)
    assert fd.planned_kernels_per_step(L, mode, tc) == want
    assert fd.planned_kernels_per_step(L, mode, False) == (12 * L if mode in fd.INT8_SCORE_MODES
                                                           else 10 * L)


@pytest.mark.parametrize("B,R", [(8, 8), (24, 8), (24, 24), (64, 8), (64, 32)])
def test_score_cells_hold_each_row_once(B, R):
    """slab_int8's cells on the chain are R consecutive rows each, and every
    row lies in exactly one of them."""
    cells = fd.tc_score_cells(B, R)
    assert len(cells) == B // R and all(c == list(range(c[0], c[0] + R)) for c in cells)
    assert sorted(b for c in cells for b in c) == list(range(B))


def _plain_scales(qu, ev, R):
    """The query scale per row and the P.V weight scale per row, as the plain
    version (``_step_plain``) forms them from qu (B, H, Dh) and e * v_scale
    (B, H, M)."""
    B = qu.shape[0]
    qmax = qu.abs().reshape(B // R, -1).amax(1)
    qs = (torch.clamp_min(qmax, 1e-6) * (1.0 / 127.0)).repeat_interleave(R)
    es = torch.clamp_min(ev.amax(dim=(1, 2)), 1e-9) * (1.0 / 127.0)
    return qs, es


@pytest.mark.parametrize("B,R", [(8, 8), (24, 8), (24, 24), (64, 32)])
def test_query_scale_comes_from_its_cell_only(B, R):
    """The scores block (b, h) forms its query scale from the head maxima of
    qkv_sum_i8 over b's cell's R rows and all H heads, nothing else; the max
    over those sources is the plain version's cell scale bit for bit, and
    changing another cell's queries leaves it as it was."""
    H, Dh = 12, 16
    query, _ = fd.tc_scale_sources(B, H, R)
    cell = {b: c for c in fd.tc_score_cells(B, R) for b in c}
    for (b, h), src in query.items():
        assert sorted(src) == sorted((r, g) for r in cell[b] for g in range(H))
    rng = np.random.default_rng(B + R)
    qu = torch.from_numpy(rng.normal(size=(B, H, Dh)).astype(np.float32)).bfloat16().float()
    qu[0] = 0.0                          # an all-zero row; cell 0 keeps other rows
    qs_plain, _ = _plain_scales(qu, torch.ones(B, H, 4), R)

    def kernel_scales(qu):
        hmax = qu.abs().amax(-1)         # qkv_sum_i8: one maximum a (row, head)
        return {key: torch.clamp_min(torch.stack([hmax[r, g] for r, g in src]).max(), 1e-6)
                * (1.0 / 127.0) for key, src in query.items()}
    got = kernel_scales(qu)
    for (b, h), qs in got.items():
        assert qs.view(torch.int32) == qs_plain[b].view(torch.int32), (b, h)
    other = qu.clone()
    other[R:] *= 3.0                     # every cell but the first
    again = kernel_scales(other)
    assert all(torch.equal(again[(b, h)], got[(b, h)]) for b in range(R) for h in range(H))


@pytest.mark.parametrize("B", [8, 24])
def test_pv_scale_reads_every_head_of_its_row(B):
    """The P.V block (b, h) forms its weight scale from the scores kernel's
    maxima of row b's H heads; their max is the plain version's row scale
    bit for bit, and a head's maximum moves the scale of every head of its
    row and of no other row."""
    H, M = 12, 32
    _, pv = fd.tc_scale_sources(B, H, 8)
    for (b, h), src in pv.items():
        assert sorted(src) == [(b, g) for g in range(H)]
    rng = np.random.default_rng(B)
    ev = torch.from_numpy(rng.exponential(size=(B, H, M)).astype(np.float32))
    ev[1] = 0.0                          # a row whose every weight is 0: the 1e-9 floor
    _, es_plain = _plain_scales(torch.ones(B, H, 4), ev, 8)
    emax = ev.amax(-1)                   # group_scores_i8's stats[b][h][0]

    def kernel_scales(emax):
        return {key: torch.clamp_min(torch.stack([emax[r, g] for r, g in src]).max(), 1e-9)
                * (1.0 / 127.0) for key, src in pv.items()}
    got = kernel_scales(emax)
    for (b, h), es in got.items():
        assert es.view(torch.int32) == es_plain[b].view(torch.int32), (b, h)
    bumped = emax.clone()
    bumped[2, 5] = 100.0
    again = kernel_scales(bumped)
    assert all(torch.equal(again[(b, h)], got[(b, h)]) != (b == 2)
               for b in range(B) for h in range(H))


@pytest.mark.parametrize("int8_scores", [False, True])
@pytest.mark.parametrize("cfg", [FLAGSHIP, SMALL], ids=["flagship", "small"])
def test_scratch_layout(cfg, int8_scores):
    """The mirrored scratch (TcScratch, then slab_int8's TcI8Scratch): every
    buffer starts on 16 bytes, after the end of the one before it; the
    int8-score layout is the chain's with ev, stats and hmax after it; the
    flagship's totals at B = 64, worked out by hand from the products'
    K chunks (qkv 4, out 12, ff2 16)."""
    L_, H, Dh, M = cfg.n_layers, cfg.n_heads, cfg.d_head, cfg.mem_len
    for B in (8, 24, 64):
        lay = fd.tc_scratch_layout(B, cfg.d_model, cfg.d_inner, H, Dh, M, int8_scores)
        runs = [v for k, v in lay.items() if k != "total"]
        assert all(off % 4 == 0 for off, _ in runs)
        assert all(a[0] + a[1] <= b[0] for a, b in zip(runs, runs[1:]))
        assert runs[-1][0] + runs[-1][1] <= lay["total"][0]
        base = fd.tc_scratch_layout(B, cfg.d_model, cfg.d_inner, H, Dh, M)
        if int8_scores:
            assert lay["ev"][0] == base["total"][0]
            assert (lay["ev"][1], lay["stats"][1], lay["hmax"][1]) == (B * H * M, B * H * 3, B * H)
        else:
            assert lay == base
    if cfg is FLAGSHIP:
        lay = fd.tc_scratch_layout(64, 512, 3072, 12, 64, 512, int8_scores)
        chain = (4 * 64 * 2304 + 64 * 2304 + 64 * 512 + 16 * 512 * 64 + 64 * 768 // 2
                 + 2 * 64 * 512 // 2 + 64 * 3072 // 2)
        assert lay["total"][0] == chain + (64 * 12 * 512 + 64 * 12 * 3 + 64 * 12
                                           if int8_scores else 0)


def _slab_int8_inputs(cfg, B, seed):
    """bf16 weights, an int8 ring with its scales, blocked and h_in of the
    small config, drawn with numpy."""
    rng = np.random.default_rng(seed)
    L, D, Dff, HD, M = cfg.n_layers, cfg.d_model, cfg.d_inner, cfg.n_heads * cfg.d_head, cfg.mem_len
    t = lambda *s, std=0.1: torch.from_numpy(rng.normal(scale=std, size=s).astype(np.float32))
    stacked = fd.StackedTXL(
        qkv_w=t(L, D, 3 * HD).bfloat16(), out_w=t(L, HD, D).bfloat16(),
        ff1_w=t(L, D, Dff).bfloat16(), ff1_b=t(L, 1, Dff).bfloat16(),
        ff2_w=t(L, Dff, D).bfloat16(), ff2_b=t(L, 1, D).bfloat16(),
        ln1_g=1 + t(L, 1, D), ln1_b=t(L, 1, D), ln2_g=1 + t(L, 1, D), ln2_b=t(L, 1, D),
        u=t(1, HD).bfloat16(), v=t(1, HD).bfloat16())
    wkr = t(L, M + 1, HD, std=0.3).bfloat16()
    kv = list(fd.quantize_kv_slot_major(t(L, B, M, HD, std=0.5).bfloat16(),
                                        t(L, B, M, HD, std=0.5).bfloat16()))
    blocked = torch.from_numpy((rng.random((B, M)) < 0.2).astype(np.int32))
    return stacked, wkr, kv, blocked, t(B, D, std=1.0)


@pytest.mark.parametrize("B,R", [(16, 8), (24, 8), (12, 4)])
def test_plain_slab_int8_cell_ignores_other_cells(B, R):
    """A CPU run of the port's plain slab_int8 (what the wrapper runs on CPU
    tensors) at two batch layouts that share cell 0 and differ in every
    other cell: rows of cell 0 give the same bits (h_out and the written
    slot), as the chain's rule asks: a row's result depends on its cell
    alone."""
    cfg = SMALL
    stacked, wkr, kv, blocked, h_in = _slab_int8_inputs(cfg, B, 7)
    _, _, kv2, blocked2, h_in2 = _slab_int8_inputs(cfg, B, 8)
    mix = lambda a, b, axis: torch.cat([a.narrow(axis, 0, R), b.narrow(axis, R, B - R)], axis)
    kv_b = [mix(a, b, 1) for a, b in zip(kv, kv2)]
    blocked_b, h_in_b = mix(blocked, blocked2, 0), mix(h_in, h_in2, 0)
    ptr = 5
    run = lambda h, caches, blk: fd.fused_slab_core(
        stacked, cfg, h, wkr, *[c.clone() for c in caches], blk, ptr, cfg.mem_len,
        rows_per_cell=R, score_mode="int8")
    a, b = run(h_in, kv, blocked), run(h_in_b, kv_b, blocked_b)
    assert not torch.equal(a[0][R:], b[0][R:])
    assert torch.equal(a[0][:R], b[0][:R])
    for x, y in zip(a[1:], b[1:]):
        assert torch.equal(x[:, :R], y[:, :R])
