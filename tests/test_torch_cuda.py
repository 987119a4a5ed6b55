"""Tests of the PyTorch port that need a CUDA card (marker ``cuda``).

They import only torch, numpy and the port (the card's machine has no JAX),
so they also run without this directory's conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

Each test decides inside itself whether a card is present and skips
without one. The kernel is held against its plain PyTorch version on the
same card; ``chip_smoke.py`` repeats that at the flagship's widths.
"""

import os

import numpy as np
import pytest
import torch

from deepmusicgeneration_tpu_torch.codec.grammar import grammar_violations
from deepmusicgeneration_tpu_torch.codec.item import MusicItem
from deepmusicgeneration_tpu_torch.models import txl
from deepmusicgeneration_tpu_torch.ops import fused_decode as fd
from deepmusicgeneration_tpu_torch.tasks.generate import predict_nw_genre
from deepmusicgeneration_tpu_torch.train.learner import MusicLearner

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(ROOT, "checkpoints", "demo_genre_model")

# same arithmetic, other summation order: a value may cross a bf16 rounding
# point at the kernel's cast points (2^-8 relative) and propagate through the
# layers; h_out is post-LayerNorm (entries of order 1)
H_ATOL = 5e-2


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,ptr", [(1, 5), (1, 32), (3, 31), (3, 255)])
def test_kernel_matches_plain(B, ptr):
    dev = _card()
    learner = MusicLearner.load(DEMO)
    engine = learner.engine
    cfg, M = engine.cfg, engine.cfg.mem_len
    stacked, w_scales = engine.stacked_q()
    L, HD = cfg.n_layers, cfg.n_heads * cfg.d_head
    wkr_mt = txl.precompute_wkr(engine.params, cfg, M).permute(0, 2, 1, 3) \
        .reshape(L, M + 1, HD).to(torch.bfloat16).contiguous()
    rng = np.random.default_rng(B * 1000 + ptr)
    k, v = (torch.from_numpy(rng.normal(scale=0.5, size=(L, B, M, HD))
                             .astype(np.float32)).to(dev, torch.bfloat16)
            for _ in range(2))
    kv = fd.quantize_kv_slot_major(k, v)
    g = np.broadcast_to(np.arange(M) - M, (B, M)).copy()
    g[:, :ptr] = np.arange(ptr)
    g[0, ptr + 1:ptr + 20] = txl.PAD_G
    blocked = torch.from_numpy(((ptr - g < 1) | (ptr - g > M)).astype(np.int32)).to(dev)
    h_in = engine.params["embed"].float()[torch.from_numpy(rng.integers(12, 140, B)).to(dev)]

    ref = fd.slab_w8_plain(stacked, w_scales, cfg, h_in, wkr_mt,
                           *[t.clone() for t in kv], blocked, ptr)
    n0 = fd.fused_slab_core.launches
    got = fd.fused_slab_core(stacked, cfg, h_in, wkr_mt, *[t.clone() for t in kv],
                             blocked, ptr, M, rows_per_cell=1, weights_int8=True,
                             w_scales=w_scales)
    torch.cuda.synchronize()
    assert fd.fused_slab_core.launches == n0 + 1
    assert (got[0] - ref[0]).abs().max().item() <= H_ATOL
    other = torch.arange(M, device=dev) != ptr
    for g_t, before in zip(got[1:], kv):   # only slot ptr was written
        assert torch.equal(g_t[:, :, other], before[:, :, other])
    for i in (1, 3):   # written int8 rows: at most one quantization step apart
        d = (got[i][:, :, ptr].int() - ref[i][:, :, ptr].int()).abs()
        assert d.max().item() <= 1


@pytest.mark.cuda
def test_main_path_goes_through_the_kernel():
    """predict_nw_genre at B = 1 on the card runs slab_w8 once per step."""
    _card()
    from chip_smoke import prompt_midi
    learner = MusicLearner.load(DEMO)
    vocab = learner.vocab
    midi = prompt_midi(0, vocab)
    assert learner.engine.resolve_kernel(1) == "slab_w8"
    fd.fused_slab_core.launches = 0
    full = predict_nw_genre(learner, midi, genre="pop", max_len=32, seed=1)
    assert fd.fused_slab_core.launches == 32
    seed_item = MusicItem.from_file(midi, vocab).trim_to_beat(32) \
        .set_genre("pop").remove_eos()
    pred = full.data[len(seed_item.data):]
    back = MusicItem.from_file(full.to_midi_bytes(), vocab)
    assert len(pred) > 0 and back.data[0] == vocab.bos_idx
    assert grammar_violations(pred, vocab, prev_idx=int(seed_item.data[-1])) == 0
