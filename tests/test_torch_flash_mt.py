"""The port's multitask train attention (``ops/flash_train.py``) against
the JAX package's, bidirectional half: the dropout hash bit for bit on the
multitask grids, ``flash_bidir_attention_plain`` (forward and the gradients
of q, k, v, wkr, u and v) against JAX's Pallas kernel run in interpret
mode, as its own tests run it on the CPU, in float32 with key padding and
dropout and in bf16 without either; and chip_smoke.py's check of the CUDA
kernels against plain versions with one fault each. The cross half and the
decoder's train attention with no memory: tests/test_torch_flash_mt_cross.py
(the JAX runs are split between the two files to keep each within its
share of the parallel test run).

The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py
and chip_smoke.py hold them against the plain versions there.
"""

import functools
import inspect
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from deepmusicgeneration_tpu.ops import flash_train as jft
from deepmusicgeneration_tpu_torch.ops import flash_train as ft
from test_torch_flash_train import BF16_ATOL, BF16_RTOL, F32_FWD_ATOL, F32_GRAD_ATOL, F32_RTOL

# the JAX kernels' lane tiling needs multiples of 128: W = L = 128, and a
# cross case with K = 256 > L (tests/test_flash_train.py:249)
B, H, Dh, W, K2 = 2, 2, 32, 128, 256
HD = H * Dh
SEED = 1234567
OUTPUTS = ("out", "q", "k", "v", "wkr", "u", "v_bias")
# (kind, K, pad, attn_p, dtype): the JAX runs, each made once by its file's
# module fixture
CASES = {
    "bidir_pad_dropout": ("bidir", W, True, 0.1, "float32"),
    "bidir_bf16": ("bidir", W, False, 0.0, "bfloat16"),
    "cross_k256_dropout": ("cross", K2, False, 0.1, "float32"),
    "cross_bf16": ("cross", W, False, 0.0, "bfloat16"),
    # flash_train_attention at M = 0 with the first 40 keys of row 1 padded:
    # its first 40 query rows see no key
    "train_m0_blocked_rows": ("train", W, True, 0.0, "float32"),
}
MY_CASES = ("bidir_pad_dropout", "bidir_bf16")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(K, seed=0):
    rng = np.random.default_rng(seed)
    r = lambda *s: (rng.normal(size=s) * 0.3).astype(np.float32)
    arrs = [r(B, W, HD), r(B, K, HD), r(B, K, HD), r(K, HD), r(H, Dh), r(H, Dh)]
    pad = np.zeros((B, W), bool)
    pad[0, -9:] = True
    pad[1, :40] = True
    w = rng.normal(size=(B, W, HD)).astype(np.float32)   # dO = w
    return arrs, pad, w


def _jax_run(case):
    kind, K, use_pad, ap, dt = CASES[case]
    arrs, pad, w = _inputs(K)
    jpad = jnp.asarray(pad) if use_pad else None
    seed = SEED if ap else None

    def f(*xs):
        if kind == "bidir":
            o = jft.flash_bidir_attention(*xs, H, pad_mask=jpad, interpret=True, attn_p=ap,
                                          attn_seed=seed)
        elif kind == "cross":
            o = jft.flash_cross_attention(*xs, H, interpret=True, attn_p=ap, attn_seed=seed)
        else:
            o = jft.flash_train_attention(*xs, 1, 1, 0, H, pad_mask=jpad, interpret=True)
        return (o.astype(jnp.float32) * jnp.asarray(w)).sum(), o

    (_, out), grads = jax.value_and_grad(f, argnums=tuple(range(6)), has_aux=True)(
        *[jnp.asarray(a, jnp.dtype(dt)) for a in arrs])
    return [np.asarray(x.astype(jnp.float32)) for x in (out, *grads)]


def _torch_run(case, fn=None):
    kind, K, use_pad, ap, dt = CASES[case]
    arrs, pad, w = _inputs(K)
    leaves = [torch.tensor(a).to(getattr(torch, dt)).requires_grad_(True) for a in arrs]
    tpad = torch.from_numpy(pad) if use_pad else None
    seed = SEED if ap else None
    if kind == "bidir":
        out = (fn or ft.flash_bidir_attention_plain)(*leaves, H, pad_mask=tpad, attn_p=ap,
                                                     attn_seed=seed)
    elif kind == "cross":
        out = (fn or ft.flash_cross_attention_plain)(*leaves, H, attn_p=ap, attn_seed=seed)
    else:
        out = (fn or ft.flash_train_attention_plain)(*leaves, 1, 1, 0, H, tpad)
    out.backward(torch.from_numpy(w).to(out.dtype))
    return [t.detach().float().numpy() for t in (out, *(x.grad for x in leaves))]


def check_against_jax(got, want, case, name):
    """One output of the plain version against JAX's: float32 at the F32_*
    tolerances of test_torch_flash_train.py, bf16 at its BF16_* ones (both
    sides round q + u, q + v, the probabilities, dS and the output to bf16
    at the same points, and a last-bit difference of the float32 sums can
    flip one rounding)."""
    i = OUTPUTS.index(name)
    if CASES[case][4] == "bfloat16":
        atol, rtol = BF16_ATOL, BF16_RTOL
    else:
        atol, rtol = (F32_FWD_ATOL if name == "out" else F32_GRAD_ATOL), F32_RTOL
    np.testing.assert_allclose(got[i], want[i], atol=atol, rtol=rtol, err_msg=name)


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's interpret-mode kernel on this file's cases (the costly part, run
    once)."""
    return {case: _jax_run(case) for case in MY_CASES}


@pytest.mark.parametrize("name", OUTPUTS)
@pytest.mark.parametrize("case", MY_CASES)
def test_bidir_plain_matches_jax_interpret_kernel(jax_runs, case, name):
    check_against_jax(_torch_run(case), jax_runs[case], case, name)


@pytest.mark.parametrize("LK", [(W, W), (W, K2), (512, 512)])
@pytest.mark.parametrize("h", [0, 7])
def test_hash_keep_bit_for_bit_on_the_mt_grids(LK, h):
    """The bidirectional kernels draw on (W, W), the cross kernels on
    (L, K): the port's hash equals JAX's _hash_keep there."""
    want = np.asarray(jft._hash_keep(jnp.int32(SEED), h, LK, 0.1))
    np.testing.assert_array_equal(ft._hash_keep(SEED, h, LK, 0.1).numpy(), want)


@pytest.mark.parametrize("case", ["bidir_pad_dropout", "cross_k256_dropout"])
def test_cpu_tensors_run_the_plain_versions(case):
    wrapper, plain = cs.MT_TRAIN_FNS[CASES[case][0]]
    before, calls = dict(wrapper.launches), plain.calls
    for g, r in zip(_torch_run(case, wrapper), _torch_run(case)):
        np.testing.assert_array_equal(g, r)
    assert wrapper.launches == before
    assert plain.calls == calls + 2


def test_mt_kernel_shape_limits():
    bf = torch.bfloat16
    assert ft.mt_kernel_supports("bidir", 16, 512, 512, 8, 512, bf) is None
    assert ft.mt_kernel_supports("cross", 16, 256, 512, 8, 512, bf) is None
    assert "square" in ft.mt_kernel_supports("bidir", 16, 256, 512, 8, 512, bf)
    assert "K >= L" in ft.mt_kernel_supports("cross", 16, 512, 256, 8, 512, bf)
    assert "dtype" in ft.mt_kernel_supports("cross", 16, 512, 512, 8, 512, torch.float32)
    assert "d_head" in ft.mt_kernel_supports("bidir", 16, 512, 512, 4, 512, bf)
    assert "multiples" in ft.mt_kernel_supports("bidir", 16, 96, 96, 8, 512, bf)
    arrs = [torch.tensor(a) for a in _inputs(W)[0]]
    with pytest.raises(ValueError, match="attn_seed"):
        ft.flash_bidir_attention(*arrs, H, attn_p=0.1)
    with pytest.raises(ValueError, match="pad_mask"):
        ft.flash_bidir_attention(*arrs, H, pad_mask=torch.zeros(B, 7, dtype=torch.bool))


# --- chip_smoke.py's check has teeth ---------------------------------------

def _mutant(fn, old: str = "", new: str = "", extra=None):
    """``fn`` recompiled with the one line ``old`` replaced by ``new`` (and
    ``extra`` names in its globals)."""
    src = textwrap.dedent(inspect.getsource(fn))
    assert not old or src.count(old) == 1, old
    namespace = {**fn.__globals__, **(extra or {})}
    exec(compile(src.replace(old, new) if old else src, "<plain version with a fault>",
                 "exec"), namespace)
    mutant = namespace[fn.__name__]
    mutant.calls = 0
    return mutant


def _other_seed():
    helper = _mutant(ft._softmax_pv, "attn_p, attn_seed or 0, score.device)",
                     "attn_p, (attn_seed or 0) + 1, score.device)")
    return _mutant(ft.flash_bidir_attention_plain, extra={"_softmax_pv": helper})


# fault: (plain version with the fault, kind, K, pad, attn_p)
FAULTS = {
    "spill_from_row_i": (lambda: _mutant(
        ft.flash_bidir_attention_plain,
        "bd_next = torch.cat([bd_rows[:, :, 1:], torch.zeros_like(bd_rows[:, :, :1])], dim=2)",
        "bd_next = bd_rows"), "bidir", W, False, 0.0),
    "band_not_applied": (lambda: _mutant(
        ft.flash_cross_attention_plain,
        "skew_index(L, K, dev).expand(B, H, L, K)) * band",
        "skew_index(L, K, dev).expand(B, H, L, K))"), "cross", K2, False, 0.0),
    "pad_ignored": (lambda: _mutant(
        ft.flash_bidir_attention_plain,
        "blocked = None if pad_mask is None else pad_mask[:, None, None, :].to(torch.bool)",
        "blocked = None"), "bidir", W, True, 0.0),
    "other_dropout_seed": (_other_seed, "bidir", W, False, 0.1),
}


def check_fault(fault):
    """chip_smoke.py's check fails the plain version with ``fault`` in the
    kernel's place, and passes the true plain version there."""
    make, kind, K, pad, ap = FAULTS[fault]
    inputs = cs.train_inputs(B, W, K, H, Dh, torch.device("cpu"), seed=3, pad=pad)
    plain = cs.MT_TRAIN_FNS[kind][1]
    run = functools.partial(cs.mt_run, kind=kind)
    kw = dict(attn_p=ap, attn_seed=SEED)
    ok, report = cs.train_check(make(), plain, inputs, H, run=run, **kw)
    assert not ok, report
    ok, report = cs.train_check(plain, plain, inputs, H, run=run, **kw)
    assert ok, report


@pytest.mark.parametrize("fault", [f for f in FAULTS if FAULTS[f][1] == "bidir"])
def test_mt_train_check_fails_a_faulty_kernel(fault):
    check_fault(fault)
