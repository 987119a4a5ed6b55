"""The head-major decode steps ``fused_stack_decode`` (batch 1, the token in
row 0 of an 8-row h block) and ``fused_batched_decode`` against the JAX
package's Pallas kernels in interpret mode.

The plain PyTorch version (what the wrappers run for CPU tensors) is held
against JAX on the bf16 setup config of ``tests/test_fused_decode.py`` (2
layers, d 128, 2 x 64 heads, mem_len 128), with the weights carried across
by ``stack_txl_layers`` from JAX's parameters as numpy arrays, at B = 1 and
B = 4 (rows blocking different slots), on a partly full ring at ptr 5 and
on a full one at ptr 0 and M - 1, where slot ``ptr`` holds the oldest token
at distance exactly M: it is live, and both read its old row before the
fresh one is written. The CUDA kernels are held against the plain version
in ``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
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
# h_out (post-LayerNorm, entries of order 1): multirow's arithmetic and bf16
# cast points in another summation order, as in tests/test_torch_multirow.py:
# float32 noise, except where a value lies at a bf16 rounding point and one
# cast takes the other side
H_ATOL = 1e-4
# the written slot is bf16(k1) / bf16(v1): a value within float32 noise of a
# bf16 rounding point moves one ulp; at most this many a case
MAX_FLIPS = 4


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = JConfig(**SETUP), TXLConfig(**SETUP)
    jp = cast_params_for_inference(jtxl.init_txl(jax.random.PRNGKey(0), jcfg))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg)
    wkr_t = jtxl.precompute_wkr(jp, jcfg, jcfg.mem_len).transpose(0, 1, 3, 2) \
        .astype(jnp.bfloat16)                                   # (L, H, Dh, M+1)
    return jcfg, cfg, jfd.stack_txl_layers(jp), tfd.stack_txl_layers(tp), wkr_t


def _ring(jcfg, B, ptr, full, seed):
    """bf16 K (L, B, H, Dh, M) and head-major V (L, B, H, M, Dh), h_in (8
    rows at B = 1, the token in row 0; else B) and the blocked mask of a
    ring at ``ptr``: full (slot ptr at distance M, live) or partly full (a
    prompt of M // 3 tokens plus ptr decoded ones); row b > 0 blocks 3b
    slots more."""
    L, M, H, Dh = jcfg.n_layers, jcfg.mem_len, jcfg.n_heads, jcfg.d_head
    rng = np.random.default_rng(seed)
    k = rng.normal(scale=0.5, size=(L, B, H, M, Dh))
    v = rng.normal(scale=0.5, size=(L, B, H, M, Dh))
    kt = jnp.asarray(k, jnp.bfloat16).transpose(0, 1, 2, 4, 3)
    vc = jnp.asarray(v, jnp.bfloat16)
    slot = np.arange(M)
    if full:
        g = np.where(slot < ptr, slot, slot - M)
    else:
        g = np.where(slot < ptr, slot, jtxl.PAD_G)
        g[M - M // 3:] = np.arange(-(M // 3), 0)
    g = np.broadcast_to(g, (B, M)).copy()
    for b in range(1, B):
        g[b, (ptr + 2 + np.arange(3 * b)) % M] = jtxl.PAD_G
    blocked = (((ptr - g) < 1) | ((ptr - g) > M)).astype(np.int32)
    h_in = rng.normal(size=(8 if B == 1 else B, jcfg.d_model)).astype(np.float32)
    return np.asarray(kt), np.asarray(vc), h_in, blocked


def _torch(a):
    """A numpy array (bf16 ones come as ml_dtypes) as a torch tensor."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    return torch.from_numpy(a.copy())


def _ulps(a, b):
    """bf16 ulps between two written slots, read off the bit patterns."""
    bits = lambda x: x.view(torch.int16).numpy().astype(np.int32)
    return np.abs(bits(a) - bits(b))


@pytest.mark.parametrize("ptr,full", [(5, False), (0, True), (127, True)])
@pytest.mark.parametrize("B", [1, 4])
def test_plain_stack_matches_pallas_interpret(model, B, ptr, full):
    jcfg, cfg, jst, tst, wkr_t = model
    M = jcfg.mem_len
    kt, vc, h_in, blocked = _ring(jcfg, B, ptr, full, seed=B * 1000 + ptr)
    jfn, core = ((jfd.fused_stack_decode, tfd.fused_stack_decode) if B == 1 else
                 (jfd.fused_batched_decode, tfd.fused_batched_decode))
    ref = jfn(jst, jcfg, jnp.asarray(h_in), wkr_t, jnp.asarray(kt), jnp.asarray(vc),
              jnp.asarray(blocked), jnp.asarray(ptr, jnp.int32), M, interpret=True)
    got = core(tst, cfg, torch.from_numpy(h_in), _torch(np.asarray(wkr_t)), _torch(kt),
               _torch(vc), torch.from_numpy(blocked), ptr, M)
    assert sum(core.launches.values()) == 0              # CPU: the plain version
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=H_ATOL, rtol=0)
    if B == 1:   # rows 1-7 of the h block come back bit for bit, in both
        np.testing.assert_array_equal(got[0][1:].numpy(), h_in[1:])
        np.testing.assert_array_equal(np.asarray(ref[0])[1:], h_in[1:])
    flips = 0
    for g, r, before, axis in ((got[1], ref[1], kt, 4), (got[2], ref[2], vc, 3)):
        r, before = _torch(np.asarray(r)), _torch(before)
        keep = torch.arange(M) != ptr
        assert torch.equal(g.index_select(axis, keep.nonzero()[:, 0]).view(torch.int16),
                           before.index_select(axis, keep.nonzero()[:, 0]).view(torch.int16))
        assert torch.equal(r.index_select(axis, keep.nonzero()[:, 0]).view(torch.int16),
                           before.index_select(axis, keep.nonzero()[:, 0]).view(torch.int16))
        d = _ulps(g.select(axis, ptr).contiguous(), r.select(axis, ptr).contiguous())
        assert d.max() <= 1, d.max()
        flips += int((d > 0).sum())
    assert flips <= MAX_FLIPS, flips


def test_stack_wrappers_check_layouts(model):
    """Layouts and dtypes are checked: the single-stream step takes an
    8-row h block and one blocked row; the caches must be bf16 and
    head-major."""
    jcfg, cfg, _, tst, wkr_t = model
    M = jcfg.mem_len
    kt, vc, h_in, blocked = _ring(jcfg, 1, 3, True, seed=2)
    wkr = _torch(np.asarray(wkr_t))
    args = lambda **kw: {**dict(h_in=torch.from_numpy(h_in), wkr_t=wkr, kt=_torch(kt),
                                vc=_torch(vc), blocked=torch.from_numpy(blocked)), **kw}
    with pytest.raises(ValueError, match="h_in"):          # one row, not the 8-row block
        tfd.fused_stack_decode(tst, cfg, **args(h_in=torch.from_numpy(h_in[:1])), ptr=3,
                               mem_len=M)
    with pytest.raises(ValueError, match="vc"):            # slot-major V (multirow's)
        tfd.fused_stack_decode(tst, cfg, **args(vc=_torch(vc).transpose(2, 3)
                                                .contiguous()), ptr=3, mem_len=M)
    with pytest.raises(TypeError, match="kt"):             # int8 K
        tfd.fused_stack_decode(tst, cfg, **args(kt=_torch(kt).to(torch.int8)), ptr=3,
                               mem_len=M)
    with pytest.raises(ValueError, match="wkr_t"):         # multirow's (L, HD, M+1) panel
        tfd.fused_stack_decode(tst, cfg, **args(wkr_t=wkr.reshape(2, 128, M + 1)), ptr=3,
                               mem_len=M)
    with pytest.raises(ValueError, match="ptr"):
        tfd.fused_stack_decode(tst, cfg, **args(), ptr=M, mem_len=M)
    kt4, vc4, h4, blocked4 = _ring(jcfg, 4, 3, True, seed=3)
    with pytest.raises(ValueError, match="blocked"):       # B = 4 rows to the B = 1 step
        tfd.fused_stack_decode(tst, cfg, **args(blocked=torch.from_numpy(blocked4)), ptr=3,
                               mem_len=M)
    with pytest.raises(ValueError, match="kt"):            # B = 1 caches to a B = 4 step
        tfd.fused_batched_decode(tst, cfg, torch.from_numpy(h4), wkr, _torch(kt),
                                 _torch(vc4), torch.from_numpy(blocked4), 3, M)
    with pytest.raises(TypeError, match="h_in"):
        tfd.fused_batched_decode(tst, cfg, torch.from_numpy(h4).double(), wkr, _torch(kt4),
                                 _torch(vc4), torch.from_numpy(blocked4), 3, M)
