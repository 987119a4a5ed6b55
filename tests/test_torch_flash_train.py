"""The port's flash train attention (``ops/flash_train.py``) against the JAX
package's: the dropout hash bit for bit, the four mask vectors, and the plain
version (forward and the gradients of q, k, v, wkr, u and v) against JAX's
Pallas kernel run in interpret mode, as its own tests run it on the CPU.
Then the plain version against the port's materialized score path in the
two regimes the train step emits, and chip_smoke.py's check of the CUDA
kernels against a plain version with one fault each.

The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py
and chip_smoke.py hold them against the plain version there.
"""

import inspect
import textwrap
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from deepmusicgeneration_tpu.ops import flash_train as jft
from deepmusicgeneration_tpu_torch.ops import flash_train as ft
from deepmusicgeneration_tpu_torch.ops.rel_attention import causal_window_mask, rel_attention

# tests/test_flash_train.py's shape: XL memory (K != L), two heads of 64
B, H, Dh, L, M = 2, 2, 64, 128, 128
HD, K = H * Dh, M + L
# float32 on both sides, the same arithmetic in another summation order
# (measured: forward 7.5e-8, gradients 1.5e-7 at most)
F32_FWD_ATOL, F32_GRAD_ATOL, F32_RTOL = 1e-5, 1e-4, 1e-3
# bf16 inputs: both round q + u, q + v, the probabilities and the output to
# bf16 at the same points, so a float32 difference in the last bits can flip
# a rounding; and JAX's backward rounds dS and P to bf16 before its
# products, which the plain version's autograd does not. Measured on the
# causal case: forward max |d| 2.4e-4 on outputs up to 0.09 (one ulp),
# gradients max |d| 2.0e-3 (the v bias, values up to 0.37); every difference
# within 2^-7 |ref| + 3.5e-4.
BF16_ATOL, BF16_RTOL = 1e-3, 2 ** -7

# (win_size, win_k, mem_valid, pad, attn_p): the train step's regimes
CASES = {
    "causal": (1, 1, M, False, 0.0),
    "mem40": (1, 1, 40, False, 0.0),
    "win3": (3, 0, M, False, 0.0),
    "pad": (1, 1, M, True, 0.0),
    "dropout": (1, 1, M, False, 0.1),
}
SEED = 1234567
OUTPUTS = ("out", "q", "k", "v", "wkr", "u", "v_bias")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """In the parallel test run, torch's intra-op threads only contend with
    the other workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    r = lambda *s: (rng.normal(size=s) * 0.3).astype(np.float32)
    arrs = [r(B, L, HD), r(B, K, HD), r(B, K, HD), r(K, HD), r(H, Dh), r(H, Dh)]
    pad = np.zeros((B, L), bool)
    pad[0, :7] = True
    pad[1, :31] = True
    w = rng.normal(size=(B, L, HD)).astype(np.float32)   # dO = w
    return arrs, pad, w


def _jax_run(arrs, pad, w, case, dtype):
    ws, wk, mv, use_pad, ap = CASES[case]

    def f(*xs):
        o = jft.flash_train_attention(
            *xs, ws, wk, mv, H, pad_mask=jnp.asarray(pad) if use_pad else None,
            interpret=True, attn_p=ap, attn_seed=SEED if ap else None)
        return (o.astype(jnp.float32) * jnp.asarray(w)).sum(), o

    (_, out), grads = jax.value_and_grad(f, argnums=tuple(range(6)), has_aux=True)(
        *[jnp.asarray(a, dtype) for a in arrs])
    return [np.asarray(x.astype(jnp.float32)) for x in (out, *grads)]


def _torch_run(fn, arrs, pad, w, case, dtype=torch.float32, **kw):
    ws, wk, mv, use_pad, ap = CASES[case]
    leaves = [torch.tensor(a).to(dtype).requires_grad_(True) for a in arrs]
    out = fn(*leaves, ws, wk, mv, H, torch.from_numpy(pad) if use_pad else None, True, ap,
             SEED if ap else None, **kw)
    out.backward(torch.from_numpy(w).to(out.dtype))
    return [t.detach().float().numpy() for t in (out, *(x.grad for x in leaves))]


@pytest.fixture(scope="module")
def jax_f32():
    """JAX's interpret-mode kernel on every case (the costly part, run once)."""
    arrs, pad, w = _inputs()
    return {case: _jax_run(arrs, pad, w, case, jnp.float32) for case in CASES}


@pytest.mark.parametrize("seed", [0, 12345, 2 ** 31 - 1])
@pytest.mark.parametrize("h", [0, 11])
@pytest.mark.parametrize("LK", [(128, 256), (512, 1024)])
@pytest.mark.parametrize("p", [0.1, 0.5])
def test_hash_keep_bit_for_bit(seed, h, LK, p):
    want = np.asarray(jft._hash_keep(jnp.int32(seed), h, LK, p))
    got = ft._hash_keep(seed, h, LK, p).numpy()
    np.testing.assert_array_equal(got, want)


def test_keep_mask_rows_are_hash_keep_with_the_batch_stride():
    """The (B, H, L, K) mask of the plain version is _hash_keep of each
    batch row's seed (seed + b * _CB in int32 wraparound) and head."""
    mask = ft.keep_mask(3, 2, 16, 128, 0.3, 2 ** 31 - 5)
    for b in range(3):
        bseed = np.int64(2 ** 31 - 5 + b * ft._CB).astype(np.uint32).astype(np.int32)
        for h in range(2):
            want = np.asarray(jft._hash_keep(jnp.int32(bseed), h, (16, 128), 0.3))
            np.testing.assert_array_equal(mask[b, h].numpy(), want)


def _jax_vectors(ws, wk, mv, pad):
    """The vectors JAX's flash_train_attention hands its kernel."""
    seen = {}

    def fake_make(*args, **kwargs):
        def fn(q, k, v, wkr, u, vb, rt, cwv, cbv, kp, seed):
            seen.update(rt=rt[0], cw=cwv[0], cb=cbv[0], kp=kp[:, 0])
            return q
        return fn

    z = lambda *s: jnp.zeros(s, jnp.float32)
    with mock.patch.object(jft, "_make_flash_train", fake_make):
        jft.flash_train_attention(z(B, L, HD), z(B, K, HD), z(B, K, HD), z(K, HD), z(H, Dh),
                                  z(H, Dh), ws, wk, mv, H,
                                  pad_mask=None if pad is None else jnp.asarray(pad))
    return {k: np.asarray(v) for k, v in seen.items()}


@pytest.mark.parametrize("ws,wk,mv", [(1, 1, M), (1, 1, 0), (1, 1, 40), (3, 0, M),
                                      (4, 0, 64), (16, 0, M)])
@pytest.mark.parametrize("use_pad", [False, True])
def test_mask_vectors_match_jax(ws, wk, mv, use_pad):
    pad = _inputs()[1] if use_pad else None
    want = _jax_vectors(ws, wk, mv, pad)
    got = ft.mask_vectors(B, L, K, ws, wk, mv, None if pad is None else torch.from_numpy(pad))
    for name, t in zip(("rt", "cw", "cb", "kp"), got):
        np.testing.assert_array_equal(t.numpy(), want[name], err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("name", OUTPUTS)
def test_plain_matches_jax_interpret_kernel_f32(jax_f32, case, name):
    arrs, pad, w = _inputs()
    got = _torch_run(ft.flash_train_attention_plain, arrs, pad, w, case)
    i = OUTPUTS.index(name)
    atol = F32_FWD_ATOL if name == "out" else F32_GRAD_ATOL
    np.testing.assert_allclose(got[i], jax_f32[case][i], atol=atol, rtol=F32_RTOL)


def test_plain_matches_jax_interpret_kernel_bf16():
    arrs, pad, w = _inputs(seed=5)
    want = _jax_run(arrs, pad, w, "causal", jnp.bfloat16)
    got = _torch_run(ft.flash_train_attention_plain, arrs, pad, w, "causal",
                     dtype=torch.bfloat16)
    for name, g, r in zip(OUTPUTS, got, want):
        np.testing.assert_allclose(g, r, atol=BF16_ATOL, rtol=BF16_RTOL, err_msg=name)


def _materialized(q, k, v, wkr, u, vb, ws, wk, mv, n_heads, pad, scale, attn_p, seed):
    """The port's score path: rel_attention under causal_window_mask with its
    exact rel_shift spill, and the pad columns."""
    heads = lambda t, n: t.reshape(B, n, H, Dh).transpose(1, 2)
    mask = causal_window_mask(L, M, ws, wk, mem_valid=mv)
    if pad is not None:
        mask = mask | torch.cat([torch.zeros((B, M), dtype=torch.bool), pad],
                                dim=1)[:, None, None, :]
    out = rel_attention(heads(q, L), heads(k, K), heads(v, K),
                        wkr.reshape(K, H, Dh).transpose(0, 1), u.reshape(H, 1, Dh),
                        vb.reshape(H, 1, Dh), mask=mask, scale=scale, shift=True)
    return out.transpose(1, 2).reshape(B, L, HD)


@pytest.mark.parametrize("case", ["causal", "mem40", "win3", "pad"])
def test_plain_matches_materialized_score_path(case):
    """In the train step's regimes (win_size 1 with win_k 1, win_size > 1
    with win_k 0) the skew's wrapped entries are all masked, so the plain
    version equals the score path with the exact spill, forward and
    gradients."""
    arrs, pad, w = _inputs(seed=2)
    got = _torch_run(ft.flash_train_attention_plain, arrs, pad, w, case)
    want = _torch_run(_materialized, arrs, pad, w, case)
    for name, g, r in zip(OUTPUTS, got, want):
        np.testing.assert_allclose(g, r, atol=F32_GRAD_ATOL, rtol=F32_RTOL, err_msg=name)


def test_cpu_tensors_run_the_plain_version():
    arrs, pad, w = _inputs()
    before = dict(ft.flash_train_attention.launches)
    calls = ft.flash_train_attention_plain.calls
    got = _torch_run(ft.flash_train_attention, arrs, pad, w, "win3")
    want = _torch_run(ft.flash_train_attention_plain, arrs, pad, w, "win3")
    for g, r in zip(got, want):
        np.testing.assert_array_equal(g, r)
    assert ft.flash_train_attention.launches == before
    assert ft.flash_train_attention_plain.calls == calls + 2


def test_kernel_shape_limits():
    ok = ft.kernel_supports(16, 512, 1024, 12, 768, torch.bfloat16)
    assert ok is None
    assert "dtype" in ft.kernel_supports(16, 512, 1024, 12, 768, torch.float32)
    assert "d_head" in ft.kernel_supports(16, 512, 1024, 4, 64, torch.bfloat16)
    assert "multiples" in ft.kernel_supports(16, 96, 1024, 12, 768, torch.bfloat16)
    assert "multiples" in ft.kernel_supports(16, 64, 64, 12, 768, torch.bfloat16)
    with pytest.raises(ValueError, match="attn_seed"):
        ft.flash_train_attention(*[torch.tensor(a) for a in _inputs()[0]], 1, 1, M, H,
                                 attn_p=0.1)


# --- chip_smoke.py's check has teeth ---------------------------------------

def _mutant(old: str, new: str, extra=None, fn=None):
    """``fn`` (flash_train_attention_plain by default) recompiled with the
    one line ``old`` replaced (and ``extra`` names added to its globals)."""
    fn = fn or ft.flash_train_attention_plain
    src = textwrap.dedent(inspect.getsource(fn))
    assert src.count(old) == 1, old
    namespace = {**fn.__globals__, **(extra or {})}
    exec(compile(src.replace(old, new), "<plain version with a fault>", "exec"), namespace)
    mutant = namespace[fn.__name__]
    mutant.calls = 0
    return mutant


class _GatherWrongUnskew(torch.autograd.Function):
    """The skew's gather, whose backward scatters each query row's gradient
    one row off (a wrong unskew): the forward stays right."""

    @staticmethod
    def forward(ctx, rows, idx):
        ctx.save_for_backward(idx)
        ctx.n = rows.shape[-1]
        return torch.gather(rows, -1, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        wrong = torch.roll(idx, 1, dims=-2)
        return torch.zeros(*g.shape[:-1], ctx.n, dtype=g.dtype).scatter_add(-1, wrong, g), None


GATHER = "bd = torch.gather(bd_rows, -1, skew_index(L, K, dev).expand(B, H, L, K))"
FAULTS = {
    "dropout_mask": ("_softmax_pv(ac + bd,", "_softmax_other_seed(ac + bd,", "dropout"),
    "bd_dropped": ("_softmax_pv(ac + bd,", "_softmax_pv(ac,", "causal"),
    "wrong_unskew": (GATHER, "bd = _GatherWrongUnskew.apply(bd_rows, skew_index(L, K, dev)"
                             ".expand(B, H, L, K).contiguous())", "causal"),
}


def _smoke_case(case):
    ws, wk, mv, use_pad, ap = CASES[case]
    inputs = cs.train_inputs(B, L, K, H, Dh, torch.device("cpu"), seed=3, pad=use_pad)
    return inputs, dict(win_size=ws, win_k=wk, mem_valid=mv, attn_p=ap, attn_seed=SEED)


@pytest.mark.parametrize("fault", list(FAULTS))
def test_train_check_fails_a_faulty_kernel(fault):
    old, new, case = FAULTS[fault]
    inputs, kw = _smoke_case(case)
    other_seed = _mutant("keep_mask(B, H, L, K, attn_p, attn_seed or 0, score.device)",
                         "keep_mask(B, H, L, K, attn_p, (attn_seed or 0) + 1, score.device)",
                         fn=ft._softmax_pv)
    mutant = _mutant(old, new, {"_GatherWrongUnskew": _GatherWrongUnskew,
                                "_softmax_other_seed": other_seed})
    ok, report = cs.train_check(mutant, ft.flash_train_attention_plain, inputs, H, **kw)
    assert not ok, report
    # the true plain version, run in the kernel's place, passes the same check
    ok, report = cs.train_check(ft.flash_train_attention_plain,
                                ft.flash_train_attention_plain, inputs, H, **kw)
    assert ok, report
