"""The port's pure-Python msgpack reader against flax's, leaf for leaf, on the
committed genre checkpoints; and params_from_numpy's layout."""

import os

import numpy as np
import pytest
from flax import serialization

from deepmusicgeneration_tpu_torch.models.config import TXLConfig
from deepmusicgeneration_tpu_torch.train.checkpoint import (
    load_checkpoint, msgpack_restore, params_from_numpy)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _bits(x):
    """Leaf → (dtype name, shape, raw bytes); None stays None."""
    if x is None:
        return None
    if hasattr(x, "numpy"):            # torch tensor
        if str(x.dtype) == "torch.bfloat16":
            import torch
            return "bfloat16", tuple(x.shape), x.view(torch.int16).numpy().tobytes()
        x = x.numpy()
    x = np.asarray(x)
    return x.dtype.name, tuple(x.shape), x.tobytes()


@pytest.mark.parametrize("name", ["demo_genre_model", "synth_genre_model"])
def test_reader_matches_flax_leaf_for_leaf(name):
    path = os.path.join(ROOT, "checkpoints", name, "params.msgpack")
    with open(path, "rb") as f:
        payload = f.read()
    ref = dict(_leaves(serialization.msgpack_restore(payload)))
    got = dict(_leaves(msgpack_restore(payload)))
    assert sorted(ref) == sorted(got)
    for key in ref:  # exact: same dtype, shape and bytes
        assert _bits(got[key]) == _bits(ref[key]), key


def test_load_checkpoint_and_params_layout():
    params, cfg, vocab, manifest = load_checkpoint(
        os.path.join(ROOT, "checkpoints", "demo_genre_model"))
    assert isinstance(cfg, TXLConfig) and cfg.n_layers == 4 and cfg.d_model == 256
    assert len(vocab.itos) == cfg.vocab_size
    p = params_from_numpy(params, cfg)
    assert len(p["layers"]) == cfg.n_layers
    assert tuple(p["layers"][0]["qkv_w"].shape) == (256, 3 * 256)
    assert p["layers"][0]["qkv_b"] is None and p["head_b"] is not None
    with pytest.raises(ValueError):
        params_from_numpy(params, cfg.replace(n_layers=3))


def test_reader_rejects_truncated_payload():
    path = os.path.join(ROOT, "checkpoints", "demo_genre_model", "params.msgpack")
    with open(path, "rb") as f:
        payload = f.read(4096)
    with pytest.raises(ValueError):
        msgpack_restore(payload)
