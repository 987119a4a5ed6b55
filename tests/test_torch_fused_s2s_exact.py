"""The port's exact bf16 multitask decode step (``fused_s2s_step_core`` /
``fused_nw_step_core``, ``decode_kernel="fused"``) against the JAX package.

The plain PyTorch version (``s2s_fused_plain``, what the wrappers run for
CPU tensors) is held against JAX's Pallas kernel in interpret mode at
tests/test_fused_s2s.py's config (2 + 2 layers, d 128, 2 x 64 heads, M 128,
bf16), with non-zero biases, at three ring pointers, with and without
padded encoder columns, to that test's tolerances (it holds the kernel to
the exact ring step). The engines with ``decode_kernel="fused"`` follow the
port's exact ring step token for token on the demo checkpoint. The CUDA
kernel against the plain version is in the ``cuda``-marked tests.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmusicgeneration_tpu.models import multitask as jmt
from deepmusicgeneration_tpu.models.config import MultitaskConfig as JConfig
from deepmusicgeneration_tpu.models.precision import cast_params_for_inference as j_cast
from deepmusicgeneration_tpu.ops import fused_s2s as jfs
from deepmusicgeneration_tpu_torch.codec.item import MultitrackItem
from deepmusicgeneration_tpu_torch.decode import multitask_engine as tme
from deepmusicgeneration_tpu_torch.models.config import MultitaskConfig
from deepmusicgeneration_tpu_torch.ops import fused_s2s as tfs
from deepmusicgeneration_tpu_torch.train.checkpoint import multitask_params_from_numpy
from deepmusicgeneration_tpu_torch.train.learner import MultitaskLearner
from deepmusicgeneration_tpu_torch.train.synthcorpus import generate_song
from deepmusicgeneration_tpu_torch.vocab import MusicVocab

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(ROOT, "checkpoints", "demo_multitask_model")

# tests/test_fused_s2s.py's tolerances: logits, and the written caches
LOGITS_TOL = dict(atol=0.08, rtol=0.02)
CACHE_ATOL = 0.05


@pytest.fixture(scope="module")
def setup():
    jcfg = JConfig(vocab_size=324, enc_layers=2, dec_layers=2, d_model=128, d_inner=256,
                   n_heads=2, d_head=64, ctx_len=128, mem_len=128, dtype="bfloat16")
    tree = jax.tree_util.tree_map(
        np.asarray, j_cast(jmt.init_multitask(jax.random.PRNGKey(0), jcfg)))
    rng = np.random.default_rng(4)
    for lp in tree["decoder"]["layers"]:       # non-zero biases, so a dropped one shows
        for sub in (lp["mha1"], lp["mha2"], lp):
            for k in [k for k in sub if k in ("q_b", "k_b", "v_b", "ff1_b", "ff2_b")]:
                sub[k] = rng.normal(scale=0.1, size=sub[k].shape).astype(sub[k].dtype)
    cfg = MultitaskConfig.from_dict(jcfg.to_dict())
    tp = multitask_params_from_numpy(tree, cfg)
    return jcfg, jax.tree_util.tree_map(jnp.asarray, tree), cfg, tp


def _logits(embed, head_b, h):
    return h[0:1] @ embed.T.astype(np.float32) + head_b.astype(np.float32)


# (cross attention, padded encoder columns, the ring pointers): a ring of 40
# prompt slots at ptr 0, one of 64 at ptr 37 (37 tokens decoded since), a
# full one at ptr M - 1
CASES = {"s2s": (True, False, ("first", "last")), "s2s_enc_pad": (True, True, ("mid",)),
         "nw": (False, False, ("first", "mid", "last"))}


@pytest.mark.parametrize("case", list(CASES))
def test_fused_plain_matches_pallas_interpret(setup, case):
    jcfg, jp, cfg, tp = setup
    has_cross, enc_pad, rings = CASES[case]
    L, H, Dh, M, D = jcfg.dec_layers, jcfg.n_heads, jcfg.d_head, jcfg.mem_len, jcfg.d_model
    Le = 128
    rng = np.random.default_rng(len(case))
    bfa = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
    draw = lambda *s: bfa(rng.normal(scale=0.5, size=s))
    k, v = draw(L, 1, H, M, Dh), draw(L, 1, H, M, Dh)
    wkr = draw(L, H, M + 1, Dh)
    ck, cv, cwkr = draw(L, H, Le, Dh), draw(L, H, Le, Dh), draw(L, H, Le, Dh)
    cblocked = (np.arange(Le)[None] >= (100 if enc_pad else Le)).astype(np.int32)
    embed = np.asarray(jp["embed"], np.float32)
    head_b = np.asarray(jp["head_b"], np.float32)
    js, ts = jfs.stack_mt_dec_layers(jp), tfs.stack_mt_dec_layers(tp)
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)
    tb = lambda a: torch.from_numpy(a).bfloat16()
    slot = np.arange(M)
    for ptr, n_valid in (dict(first=(0, 40), mid=(37, 64), last=(M - 1, M))[r] for r in rings):
        g = np.where(slot >= M - n_valid, slot - M, jmt.PAD_G)
        g[:ptr] = np.arange(ptr)                          # ptr tokens decoded since
        blocked = (((ptr - g) < 1) | ((ptr - g) > M)).astype(np.int32)[None]
        h_in = rng.normal(size=(1, D)).astype(np.float32)
        h8 = np.zeros((8, D), np.float32)
        h8[0] = h_in[0]
        jargs = (js, jcfg, jnp.asarray(h8), jb(wkr).transpose(0, 1, 3, 2),
                 jb(k).transpose(0, 1, 2, 4, 3), jb(v))
        jtail = (jnp.asarray(blocked), jnp.asarray(ptr, jnp.int32), M)
        targs = (ts, cfg, torch.from_numpy(h_in), tb(wkr), tb(k), tb(v))
        ttail = (torch.from_numpy(blocked), ptr, M)
        if has_cross:
            ref = jfs.fused_s2s_step_core(*jargs, jb(ck).transpose(0, 1, 3, 2), jb(cv),
                                          jb(cwkr).transpose(0, 1, 3, 2), jnp.asarray(cblocked),
                                          *jtail, interpret=True)
            got = tfs.fused_s2s_step_core(*targs, tb(ck), tb(cv), tb(cwkr),
                                          torch.from_numpy(cblocked), *ttail)
        else:
            ref = jfs.fused_nw_step_core(*jargs, *jtail, interpret=True)
            got = tfs.fused_nw_step_core(*targs, *ttail)
        ref_l = _logits(embed, head_b, np.asarray(ref[0]))
        got_l = _logits(embed, head_b, got[0].numpy())
        np.testing.assert_allclose(got_l, ref_l, **LOGITS_TOL)
        assert got_l.argmax() == ref_l.argmax()
        ref_k = np.asarray(ref[1].transpose(0, 1, 2, 4, 3), np.float32)
        for g_c, r_c, before in ((got[1], ref_k, k), (got[2], np.asarray(ref[2], np.float32), v)):
            g_c = g_c.float().numpy()
            np.testing.assert_allclose(g_c, r_c, atol=CACHE_ATOL, rtol=0)
            other = slot != ptr                       # only slot ptr is written
            np.testing.assert_array_equal(g_c[:, :, :, other], before[:, :, :, other])


@pytest.fixture(scope="module")
def tracks():
    vocab = MusicVocab.create()
    multi = MultitrackItem.from_npenc(generate_song("electronic", 3), vocab)
    return (vocab, multi.first_instrument.data,
            multi.second_instrument.trim_to_beat(8).remove_eos().data)


@pytest.mark.parametrize("task", ["s2s", "nw"])
def test_fused_engines_follow_the_exact_ring_step(task, tracks):
    """Greedy tokens of S2SEngine / NWEngine with decode_kernel='fused' on
    the CPU (the plain version) equal those of the port's exact ring step
    ('xla') on the bf16 demo checkpoint."""
    vocab, inp, targ = tracks
    out = {}
    for kernel in ("fused", "xla"):
        eng = MultitaskLearner.load(DEMO, device="cpu", decode_kernel=kernel).engine(task)
        assert eng.kernel == kernel
        out[kernel] = (eng.predict_s2s(inp, targ, n_words=48, greedy=True)[len(targ):]
                       if task == "s2s" else eng.predict_nw(targ, n_words=48, greedy=True))
    assert len(out["fused"]) > 0
    np.testing.assert_array_equal(out["fused"], out["xla"])


def test_fused_refuses_what_it_does_not_take(setup):
    """'fused' is honoured on a bf16 config whose widths the kernel takes
    and raises elsewhere (never falls back); the wrappers check their
    operands and count no launch for a CPU tensor."""
    jcfg, jp, cfg, tp = setup
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert tme._pick_dec_kernel(cfg, "fused", cpu) == "fused"
    assert tme._pick_dec_kernel(cfg, "fused", cuda) == "fused"
    for bad in (cfg.replace(dtype="float32"), cfg.replace(d_head=48, d_model=96)):
        with pytest.raises(ValueError, match="fused"):
            tme._pick_dec_kernel(bad, "fused", cpu)
    ts = tfs.stack_mt_dec_layers(tp)
    L, H, Dh, M = cfg.dec_layers, cfg.n_heads, cfg.d_head, cfg.mem_len
    ring = lambda: torch.zeros((L, 1, H, M, Dh), dtype=torch.bfloat16)
    wkr = torch.zeros((L, H, M + 1, Dh), dtype=torch.bfloat16)
    h = torch.zeros((1, cfg.d_model))
    blocked = torch.zeros((1, M), dtype=torch.int32)
    before = dict(tfs.fused_nw_step_core.launches)
    tfs.fused_nw_step_core(ts, cfg, h, wkr, ring(), ring(), blocked, 3, M)
    assert tfs.fused_nw_step_core.launches == before
    with pytest.raises(ValueError, match="ptr"):
        tfs.fused_nw_step_core(ts, cfg, h, wkr, ring(), ring(), blocked, M, M)
    with pytest.raises(TypeError, match="kc"):
        tfs.fused_nw_step_core(ts, cfg, h, wkr, ring().float(), ring(), blocked, 0, M)
    with pytest.raises(ValueError, match="wkr"):
        tfs.fused_nw_step_core(ts, cfg, h, wkr[:, :, :M], ring(), ring(), blocked, 0, M)
