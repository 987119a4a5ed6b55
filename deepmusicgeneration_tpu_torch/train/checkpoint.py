"""Checkpoint loading: the JAX package's msgpack params + JSON manifest.

A checkpoint directory holds ``manifest.json`` (model config, vocab layout,
step) and ``params.msgpack``, written by flax's ``serialization.to_bytes``.
This module reads that format with a small pure-Python msgpack decoder, so
the port needs neither flax nor the ``msgpack`` package:

* maps, arrays, strings, binaries, nil, booleans, integers and floats,
* ext code 1 — an ndarray, whose payload is a msgpack array
  ``[shape, dtype name, raw little-endian bytes]``.

Lists of layers were saved as maps keyed ``"0".."n"``.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..models.config import TXLConfig
from ..vocab import MusicVocab

MANIFEST = "manifest.json"
PARAMS = "params.msgpack"

_EXT_NDARRAY = 1


def _dtype_tensor(raw: bytes, dtype: str, shape) -> torch.Tensor:
    """Raw little-endian bytes of a numpy/ml_dtypes dtype → CPU tensor."""
    if dtype == "bfloat16":
        arr = np.frombuffer(raw, dtype="<u2").copy()
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).reshape(shape)
    arr = np.frombuffer(raw, dtype=np.dtype(dtype).newbyteorder("<")).copy()
    return torch.from_numpy(arr.astype(np.dtype(dtype), copy=False)).reshape(shape)


class _Reader:
    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack payload")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}           # bin 8/16/32
        if b in sized:
            return bytes(self.take(self.unpack(sized[b])))
        ext = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}             # ext 8/16/32
        if b in ext:
            n = self.unpack(ext[b])
            return self.ext(self.unpack(">b"), n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(self.unpack(">b"), fixext[b])
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                   0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in scalars:
            return self.unpack(scalars[b])
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in strs:
            return str(self.take(self.unpack(strs[b])), "utf-8")
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def map(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        return out

    def array(self, n: int):
        return [self.obj() for _ in range(n)]

    def ext(self, code: int, n: int):
        inner = _Reader(bytes(self.take(n)))
        if code != _EXT_NDARRAY:
            raise ValueError(f"unsupported msgpack ext code {code}")
        shape, dtype, raw = inner.obj()
        return _dtype_tensor(raw, dtype, tuple(shape))


def msgpack_restore(payload: bytes) -> Any:
    """Decode a flax msgpack payload into nested dicts of CPU tensors."""
    reader = _Reader(payload)
    tree = reader.obj()
    if reader.pos != len(reader.buf):
        raise ValueError("trailing bytes after msgpack payload")
    return tree


def load_checkpoint(path: str) -> Tuple[Dict, TXLConfig, MusicVocab, Dict]:
    """Returns (params tree of CPU tensors, config, vocab, manifest)."""
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("kind") != "txl":
        raise NotImplementedError(
            f"checkpoint kind {manifest.get('kind')!r} is not ported yet; "
            "see ROADMAP.md")
    config = TXLConfig.from_dict(manifest["config"])
    vocab = MusicVocab.from_layout(manifest.get("vocab_layout", "genre"))
    with open(os.path.join(path, PARAMS), "rb") as f:
        params = msgpack_restore(f.read())
    return params, config, vocab, manifest


def _tensor(x, device) -> torch.Tensor:
    if x is None or isinstance(x, torch.Tensor):
        return None if x is None else x.to(device)
    arr = np.array(x)  # a writable copy (arrays from JAX are read-only)
    if arr.dtype.name == "bfloat16":   # ml_dtypes bfloat16 from a JAX array
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


_LAYER_KEYS = ("qkv_w", "qkv_b", "r_w", "r_b", "out_w", "out_b", "ln1_g",
               "ln1_b", "ff1_w", "ff1_b", "ff2_w", "ff2_b", "ln2_g", "ln2_b")


def params_from_numpy(tree: Dict, cfg: TXLConfig, device="cpu") -> Dict:
    """Carry a JAX parameter tree into the port's parameter dict.

    ``tree`` is the JAX package's txl params — numpy arrays (bfloat16 as
    ml_dtypes arrays) or the tensors :func:`msgpack_restore` returns — with
    ``layers`` as a list or a map keyed ``"0".."n"``. Shapes are checked
    against ``cfg``; dtypes are kept.
    """
    layers = tree["layers"]
    if isinstance(layers, dict):
        layers = [layers[str(i)] for i in range(len(layers))]
    if len(layers) != cfg.n_layers:
        raise ValueError(f"checkpoint has {len(layers)} layers, config "
                         f"{cfg.n_layers}")
    H, Dh, D, V = cfg.n_heads, cfg.d_head, cfg.d_model, cfg.vocab_size
    out = {
        "embed": _tensor(tree["embed"], device),
        "u": _tensor(tree["u"], device),
        "v": _tensor(tree["v"], device),
        "head_b": _tensor(tree.get("head_b"), device),
        "layers": [{k: _tensor(lp.get(k), device) for k in _LAYER_KEYS}
                   for lp in layers],
    }
    expect = {"embed": (V, D), "u": (H, 1, Dh), "v": (H, 1, Dh)}
    for k, shape in expect.items():
        if tuple(out[k].shape) != shape:
            raise ValueError(f"{k}: shape {tuple(out[k].shape)} != {shape}")
    for i, lp in enumerate(out["layers"]):
        for k, shape in (("qkv_w", (D, 3 * H * Dh)), ("out_w", (H * Dh, D)),
                         ("ff1_w", (D, cfg.d_inner)), ("ff2_w", (cfg.d_inner, D))):
            if tuple(lp[k].shape) != shape:
                raise ValueError(f"layers/{i}/{k}: shape {tuple(lp[k].shape)} "
                                 f"!= {shape}")
    return out
