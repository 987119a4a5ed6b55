"""Model configurations: Transformer-XL and the multitask encoder-decoder.

Mirrors the reference's fastai-derived config dicts (`app_utils.py:13-63`) as
a typed dataclass, read from and written to the checkpoint manifest's
``config`` dict. Defaults follow fastai's ``tfmerXL_lm_config`` (dropout
family 0.1, scale=True, tie_weights=True, out_bias=True, no attention bias).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class TXLConfig:
    """Transformer-XL language model (MusicTransformerXL equivalent)."""

    vocab_size: int = 324
    n_layers: int = 8
    d_model: int = 512
    d_inner: int = 3072
    n_heads: int = 12
    d_head: int = 64
    ctx_len: int = 512
    mem_len: int = 512
    act: str = "gelu"
    bias: bool = False          # attention/ff linear bias (tfmerXL default)
    out_bias: bool = True       # tied output head bias
    tie_weights: bool = True
    scale: bool = True          # 1/sqrt(d_head) attention scaling
    encode_position: bool = False  # BeatPositionEncoder on/off
    beat_len: int = 32
    max_bar_len: int = 1024
    mask_steps: int = 4         # rand_window_mask max window (training)
    embed_p: float = 0.1
    resid_p: float = 0.1
    attn_p: float = 0.1
    ff_p: float = 0.1
    output_p: float = 0.1
    transpose_range: Optional[Tuple[int, int]] = (0, 12)
    dtype: str = "bfloat16"     # activation dtype: "bfloat16" | "float32"

    @property
    def act_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def replace(self, **kw) -> "TXLConfig":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if d.get("transpose_range") is not None:
            d["transpose_range"] = list(d["transpose_range"])
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "TXLConfig":
        d = dict(d)
        if d.get("transpose_range") is not None:
            d["transpose_range"] = tuple(d["transpose_range"])
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def btp_phase1_config(vocab_size: int = 324) -> TXLConfig:
    """The genre/continuation model (app_utils.py:40-53): 8L/d512/ff3072/12h,
    ctx 512, mem 512, GeLU, no positional beat encoding. 41.1M params."""
    return TXLConfig(vocab_size=vocab_size)


def small_test_config(vocab_size: int = 324) -> TXLConfig:
    return TXLConfig(vocab_size=vocab_size, n_layers=2, d_model=64, d_inner=128,
                     n_heads=4, d_head=16, ctx_len=64, mem_len=64, dtype="float32",
                     embed_p=0.0, resid_p=0.0, attn_p=0.0, ff_p=0.0, output_p=0.0)


@dataclass(frozen=True)
class MultitaskConfig:
    """Encoder-decoder multitask model (app_utils.py:26-38,55-63).

    ``act`` defaults to relu, a reference quirk the JAX package keeps: the
    reference's multitask_config() says GeLU, but its encoder block builds
    the feed-forward without forwarding ``act``, so every model it trains
    uses ReLU there. Checkpoints carry their config, so gelu-trained
    checkpoints load unchanged."""

    vocab_size: int = 324
    enc_layers: int = 10
    dec_layers: int = 10
    d_model: int = 512
    d_inner: int = 2048
    n_heads: int = 8
    d_head: int = 64
    ctx_len: int = 512
    mem_len: int = 512
    act: str = "relu"
    bias: bool = True
    out_bias: bool = True
    scale: bool = True
    beat_len: int = 32
    max_bar_len: int = 1024
    mask_steps: int = 1
    mask_p: float = 0.3
    embed_p: float = 0.1
    resid_p: float = 0.1
    attn_p: float = 0.1
    ff_p: float = 0.1
    output_p: float = 0.1
    dtype: str = "bfloat16"

    @property
    def act_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def replace(self, **kw) -> "MultitaskConfig":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "MultitaskConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def multitask_config(vocab_size: int = 324) -> MultitaskConfig:
    """The 85M multitask flagship: 10 + 10 layers, d 512, 8 x 64 heads,
    d_inner 2048, ctx and mem 512, ReLU, biases."""
    return MultitaskConfig(vocab_size=vocab_size)


def small_multitask_config(vocab_size: int = 324) -> MultitaskConfig:
    return MultitaskConfig(vocab_size=vocab_size, enc_layers=2, dec_layers=2,
                           d_model=64, d_inner=128, n_heads=4, d_head=16,
                           ctx_len=64, mem_len=64, dtype="float32",
                           embed_p=0.0, resid_p=0.0, attn_p=0.0, ff_p=0.0, output_p=0.0)
