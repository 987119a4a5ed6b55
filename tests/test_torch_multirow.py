"""The multirow decode steps (``multirow`` over bf16 head-major panels,
``multirow_int8`` over int8 panels with per-slot scales) against the JAX
package's Pallas kernels in interpret mode.

``quantize_kv_panels`` must be bit-identical to JAX's. The plain PyTorch
versions (what ``fused_multirow_core`` / ``fused_multirow_q_core`` run for
CPU tensors) are held against JAX ``fused_multirow_decode`` /
``fused_multirow_q_decode`` in interpret mode on the bf16 setup config of
``tests/test_fused_decode.py`` (2 layers, d 128, 2 x 64 heads, mem_len 128)
at 1 and 8 rows a cell, on a partly full ring and on a full one, where slot
``ptr`` holds the oldest token at distance exactly M: it is live, and both
read its old row before the fresh one is written. The CUDA kernels are held
against the plain versions in ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmusicgeneration_tpu.models import txl as jtxl
from deepmusicgeneration_tpu.models.config import TXLConfig as JConfig
from deepmusicgeneration_tpu.models.precision import cast_params_for_inference
from deepmusicgeneration_tpu.ops import fused_decode as jfd
from deepmusicgeneration_tpu_torch.models.config import TXLConfig
from deepmusicgeneration_tpu_torch.ops import fused_decode as tfd
from deepmusicgeneration_tpu_torch.train.checkpoint import params_from_numpy

SETUP = dict(vocab_size=324, n_layers=2, d_model=128, d_inner=256, n_heads=2,
             d_head=64, ctx_len=128, mem_len=128, dtype="bfloat16", bias=False)
# h_out (post-LayerNorm, entries of order 1): the same float32 arithmetic and
# bf16 cast points as the Pallas kernels in another summation order, as for
# the slab modes (tests/test_torch_slab_modes.py): float32 noise (~1e-6),
# except where a value lies at a bf16 rounding point and one cast takes the
# other side (measured 5.4e-5 in one case); 1e-4 leaves room for such a flip
# as tests/test_torch_fused_decode.py's H_ATOL does
H_ATOL = 1e-4
# the written slot: multirow writes bf16(k1), multirow_int8 quantizes it; a
# value within float32 noise of a bf16 rounding point or an int8 half-point
# moves one step (one bf16 ulp, one int8 step); at most this many a case
MAX_FLIPS = 4
SCALE_RTOL = 1e-5


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = JConfig(**SETUP), TXLConfig(**SETUP)
    jp = cast_params_for_inference(jtxl.init_txl(jax.random.PRNGKey(0), jcfg))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg)
    wkr = jtxl.precompute_wkr(jp, jcfg, jcfg.mem_len)
    L, M, HD = jcfg.n_layers, jcfg.mem_len, jcfg.n_heads * jcfg.d_head
    wkr_f = wkr.transpose(0, 1, 3, 2).reshape(L, HD, M + 1).astype(jnp.bfloat16)
    return jcfg, cfg, jfd.stack_txl_layers(jp), tfd.stack_txl_layers(tp), wkr_f


def test_quantize_kv_panels_bit_identical():
    rng = np.random.default_rng(6)
    kt = rng.normal(scale=0.7, size=(2, 3, 64, 96)).astype(np.float32)   # (L, B, HD, M)
    vc = rng.normal(scale=0.2, size=(2, 3, 96, 64)).astype(np.float32)   # (L, B, M, HD)
    kt[1, 2, :, 40] = 0.0   # an all-zero K slot column and V slot row:
    vc[0, 1, 7] = 0.0       # each takes the 1e-6 floor
    ref = jfd.quantize_kv_panels(jnp.asarray(kt, jnp.bfloat16), jnp.asarray(vc, jnp.bfloat16))
    got = tfd.quantize_kv_panels(torch.from_numpy(kt).bfloat16(),
                                 torch.from_numpy(vc).bfloat16())
    assert [tuple(t.shape) for t in got] == [(2, 3, 64, 96), (2, 3, 1, 96),
                                             (2, 3, 96, 64), (2, 3, 1, 96)]
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert got[1][1, 2, 0, 40].item() == np.float32(1e-6) / np.float32(127.0)
    assert got[3][0, 1, 0, 7].item() == np.float32(1e-6) / np.float32(127.0)


def _panels(jcfg, B, ptr, full, seed, int8):
    """Head-major K (L, B, HD, M) and slot-major V (L, B, M, HD) panels, bf16
    or quantized by JAX's panel quantizer, h_in and the blocked mask of a
    ring at ``ptr``: full (slot ptr at distance M, live) or partly full (a
    prompt of M // 3 tokens plus ptr decoded ones); row 1 has a pad slot
    more."""
    L, M, HD = jcfg.n_layers, jcfg.mem_len, jcfg.n_heads * jcfg.d_head
    rng = np.random.default_rng(seed)
    kt = jnp.asarray(rng.normal(scale=0.5, size=(L, B, HD, M)), jnp.bfloat16)
    vc = jnp.asarray(rng.normal(scale=0.5, size=(L, B, M, HD)), jnp.bfloat16)
    kv = jfd.quantize_kv_panels(kt, vc) if int8 else (kt, vc)
    slot = np.arange(M)
    if full:
        g = np.where(slot < ptr, slot, slot - M)
    else:
        g = np.where(slot < ptr, slot, jtxl.PAD_G)
        g[M - M // 3:] = np.arange(-(M // 3), 0)
    g = np.broadcast_to(g, (B, M)).copy()
    g[1, (ptr + 2) % M] = jtxl.PAD_G
    blocked = (((ptr - g) < 1) | ((ptr - g) > M)).astype(np.int32)
    h_in = rng.normal(size=(B, jcfg.d_model)).astype(np.float32)
    return [np.asarray(t) for t in kv], h_in, blocked


def _torch(a):
    """A numpy array (bf16 ones come as ml_dtypes) as a torch tensor."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    return torch.from_numpy(a.copy())


def _steps(a, b, bf16):
    """Steps between two written slots: int8 steps, or bf16 ulps read off
    the bit patterns (same-sign values of order 1)."""
    if bf16:
        a, b = (torch.from_numpy(x.astype(np.float32)).bfloat16().view(torch.int16)
                .numpy().astype(np.int32) for x in (a, b))
    return np.abs(a.astype(np.int32) - b.astype(np.int32))


@pytest.mark.parametrize("R,ptr,full", [(1, 5, False), (8, 31, True), (8, 127, True)])
@pytest.mark.parametrize("mode", ["multirow", "multirow_int8"])
def test_plain_multirow_matches_pallas_interpret(model, mode, R, ptr, full):
    jcfg, cfg, jst, tst, wkr_f = model
    M, B, int8 = jcfg.mem_len, 8, mode == "multirow_int8"
    kv, h_in, blocked = _panels(jcfg, B, ptr, full, seed=R + ptr, int8=int8)
    jfn = jfd.fused_multirow_q_decode if int8 else jfd.fused_multirow_decode
    ref = jfn(jst, jcfg, jnp.asarray(h_in), wkr_f, *[jnp.asarray(t) for t in kv],
              jnp.asarray(blocked), jnp.asarray(ptr, jnp.int32), M, rows_per_cell=R,
              interpret=True)
    ref = [np.asarray(t) for t in ref]
    core = tfd.fused_multirow_q_core if int8 else tfd.fused_multirow_core
    got = core(tst, cfg, torch.from_numpy(h_in), _torch(np.asarray(wkr_f)),
               *[_torch(t) for t in kv], torch.from_numpy(blocked), ptr, M,
               rows_per_cell=R)
    assert sum(core.launches.values()) == 0          # CPU: the plain version
    got = [t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy() for t in got]
    ref = [r.astype(np.float32) if r.dtype.name == "bfloat16" else r for r in ref]
    kv = [t.astype(np.float32) if t.dtype.name == "bfloat16" else t for t in kv]
    np.testing.assert_allclose(got[0], ref[0], atol=H_ATOL, rtol=0)
    # slot ptr on the slot axis of each cache: K panels (and their scales,
    # (L, B, 1, M)) keep it last, V panels at axis 2
    pick = lambda a, axis: np.take(a, ptr, axis=axis)
    keep = lambda a, axis: np.delete(a, ptr, axis=axis)
    axes = (3, 3, 2, 3) if int8 else (3, 2)
    flips = 0
    for i, (axis, before) in enumerate(zip(axes, kv)):
        g, r = got[1 + i], ref[1 + i]
        np.testing.assert_array_equal(keep(g, axis), keep(before, axis))
        np.testing.assert_array_equal(keep(r, axis), keep(before, axis))
        if int8 and i in (1, 3):                          # the written scales
            np.testing.assert_allclose(pick(g, axis), pick(r, axis), rtol=SCALE_RTOL)
        else:
            d = _steps(pick(g, axis), pick(r, axis), bf16=not int8)
            assert d.max() <= 1, d.max()
            flips += int((d > 0).sum())
    assert flips <= MAX_FLIPS, flips


def test_multirow_wrapper_checks(model):
    """rows_per_cell must divide the batch; the bf16 step takes any mem_len,
    shapes and dtypes are checked."""
    jcfg, cfg, _, tst, wkr_f = model
    kv, h_in, blocked = _panels(jcfg, 4, 3, True, seed=2, int8=False)
    args = [torch.from_numpy(h_in), _torch(np.asarray(wkr_f)), *[_torch(t) for t in kv],
            torch.from_numpy(blocked), 3, jcfg.mem_len]
    with pytest.raises(ValueError, match="rows_per_cell"):
        tfd.fused_multirow_core(tst, cfg, *args, rows_per_cell=8)
    L, B, M, HD = jcfg.n_layers, 4, jcfg.mem_len, 128
    scales = torch.ones((L, B, 1, M))
    with pytest.raises(TypeError, match="kt"):   # bf16 panels given to the int8 step
        tfd.fused_multirow_q_core(tst, cfg, args[0], args[1], args[2], scales,
                                  torch.zeros((L, B, M, HD), dtype=torch.int8), scales,
                                  *args[4:], rows_per_cell=4)
