"""Checkpoints in the JAX package's format: msgpack params + JSON manifest.

A checkpoint directory holds ``manifest.json`` (model config, vocab layout,
step) and ``params.msgpack``, as flax's ``serialization.to_bytes`` writes
it. This module reads that format, for the genre and the multitask kinds
alike, and writes it for the genre kind (:func:`save_checkpoint`), with a
small pure-Python msgpack codec, so the port needs neither flax nor the
``msgpack`` package:

* maps, arrays, strings, binaries, nil, booleans, integers and floats,
* ext code 1 — an ndarray, whose payload is a msgpack array
  ``[shape, dtype name, raw little-endian bytes]``.

Lists of layers are saved as maps keyed ``"0".."n"`` and absent biases as
nil, in the order the JAX package writes them.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.config import MultitaskConfig, TXLConfig
from ..models.precision import master_params
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


def _pack_uint(out: bytearray, n: int, fix_max: int, fix_base: int, codes) -> None:
    """A length or count: in the fixed-size byte when it fits, else in the
    smallest of ``codes`` ((code, struct format, limit), ...)."""
    if fix_max is not None and n <= fix_max:
        out.append(fix_base | n)
        return
    for code, fmt, limit in codes:
        if n < limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack object too large ({n})")


def _pack(out: bytearray, x) -> None:
    if x is None:
        out.append(0xC0)
    elif isinstance(x, bool):
        out.append(0xC3 if x else 0xC2)
    elif isinstance(x, int):
        if 0 <= x <= 0x7F:
            out.append(x)
        elif -32 <= x < 0:
            out += struct.pack(">b", x)
        elif x > 0:
            _pack_uint(out, x, None, 0, ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                         (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)))
        else:
            for code, fmt, lo in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                                  (0xD2, ">i", -(1 << 31)), (0xD3, ">q", -(1 << 63))):
                if x >= lo:
                    out.append(code)
                    out += struct.pack(fmt, x)
                    break
    elif isinstance(x, float):
        out.append(0xCB)
        out += struct.pack(">d", x)
    elif isinstance(x, str):
        raw = x.encode("utf-8")
        _pack_uint(out, len(raw), 31, 0xA0, ((0xD9, ">B", 1 << 8), (0xDA, ">H", 1 << 16),
                                             (0xDB, ">I", 1 << 32)))
        out += raw
    elif isinstance(x, (bytes, bytearray)):
        _pack_uint(out, len(x), None, 0, ((0xC4, ">B", 1 << 8), (0xC5, ">H", 1 << 16),
                                          (0xC6, ">I", 1 << 32)))
        out += x
    elif isinstance(x, (list, tuple)):
        _pack_uint(out, len(x), 15, 0x90, ((0xDC, ">H", 1 << 16), (0xDD, ">I", 1 << 32)))
        for v in x:
            _pack(out, v)
    elif isinstance(x, dict):
        _pack_uint(out, len(x), 15, 0x80, ((0xDE, ">H", 1 << 16), (0xDF, ">I", 1 << 32)))
        for k, v in x.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(x, torch.Tensor):
        _pack_ext(out, _ndarray_payload(x))
    else:
        raise TypeError(f"cannot msgpack {type(x).__name__}")


def _ndarray_payload(t: torch.Tensor) -> bytes:
    """flax's ndarray encoding: msgpack [shape, dtype name, C-order bytes]."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        name, raw = "bfloat16", t.view(torch.int16).numpy().astype("<i2").tobytes()
    else:
        arr = t.numpy()
        name, raw = arr.dtype.name, arr.astype(arr.dtype.newbyteorder("<")).tobytes()
    inner = bytearray()
    _pack(inner, [list(t.shape), name, raw])
    return bytes(inner)


def _pack_ext(out: bytearray, payload: bytes) -> None:
    n = len(payload)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        out.append(fixext[n])
    else:
        _pack_uint(out, n, None, 0, ((0xC7, ">B", 1 << 8), (0xC8, ">H", 1 << 16),
                                     (0xC9, ">I", 1 << 32)))
    out += struct.pack(">b", _EXT_NDARRAY)
    out += payload


def msgpack_serialize(tree) -> bytes:
    """Encode a parameter tree (dicts, lists, None, tensors) as the JAX
    package's ``save_checkpoint`` does: its tree map orders every dict's keys,
    then flax turns each list into a map keyed "0".."n" in list order."""
    def state_dict(node):
        if isinstance(node, dict):
            return {str(k): state_dict(node[k]) for k in sorted(node)}
        if isinstance(node, list):
            return {str(i): state_dict(v) for i, v in enumerate(node)}
        return node

    out = bytearray()
    _pack(out, state_dict(tree))
    return bytes(out)


def save_checkpoint(path: str, params, config, vocab: MusicVocab, step: int = 0,
                    extra: Optional[Dict] = None) -> str:
    """Write ``params`` and the manifest in the JAX package's format
    (``train/checkpoint.py::save_checkpoint``), so either package loads what
    the other saved. The manifest records ``step``. No optimizer state is
    written (the JAX package's trainers write none either)."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, PARAMS), "wb") as f:
        f.write(msgpack_serialize(params))
    manifest = {
        "kind": "txl" if isinstance(config, TXLConfig) else "multitask",
        "config": config.to_dict(),
        "vocab_layout": vocab.layout,
        "step": int(step),
        "format_version": 1,
    }
    if extra:
        manifest["extra"] = extra
    with open(os.path.join(path, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return path


_CONFIGS = {"txl": TXLConfig, "multitask": MultitaskConfig}


def load_checkpoint(path: str) -> Tuple[Dict, object, MusicVocab, Dict]:
    """Returns (params tree of CPU tensors, config, vocab, manifest); the
    config is a ``TXLConfig`` or a ``MultitaskConfig`` by the manifest's
    ``kind``."""
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("kind") not in _CONFIGS:
        raise ValueError(f"unknown checkpoint kind {manifest.get('kind')!r}")
    config = _CONFIGS[manifest["kind"]].from_dict(manifest["config"])
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


def params_from_numpy(tree: Dict, cfg: TXLConfig, device="cpu", master: bool = False) -> Dict:
    """Carry a JAX parameter tree into the port's parameter dict.

    ``tree`` is the JAX package's txl params — numpy arrays (bfloat16 as
    ml_dtypes arrays) or the tensors :func:`msgpack_restore` returns — with
    ``layers`` as a list or a map keyed ``"0".."n"``. Shapes are checked
    against ``cfg``; dtypes are kept, unless ``master``: then every leaf is a
    float32 master copy with ``requires_grad``, the form training takes
    (``models.precision.master_params``).
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
    return master_params(out, device) if master else out


_ATTN_KEYS = ("q_w", "q_b", "k_w", "k_b", "v_w", "v_b", "r_w", "r_b", "ln_g", "ln_b")
_MT_BLOCK_KEYS = ("ff1_w", "ff1_b", "ff2_w", "ff2_b", "ff_ln_g", "ff_ln_b")


def _layer_list(layers):
    return [layers[str(i)] for i in range(len(layers))] if isinstance(layers, dict) else layers


def multitask_params_from_numpy(tree: Dict, cfg: MultitaskConfig, device="cpu",
                                master: bool = False) -> Dict:
    """Carry a JAX multitask parameter tree into the port's parameter dict
    (the layout of :mod:`..models.multitask`).

    ``tree`` holds numpy arrays (bfloat16 as ml_dtypes arrays) or the
    tensors :func:`msgpack_restore` returns; ``layers`` are a list or a map
    keyed ``"0".."n"``; absent biases are None. Shapes are checked against
    ``cfg``; dtypes are kept, unless ``master``: then every leaf is a float32
    master copy with ``requires_grad``, the form training takes
    (``models.precision.master_params``).
    """
    H, Dh, D, V, Dff = cfg.n_heads, cfg.d_head, cfg.d_model, cfg.vocab_size, cfg.d_inner
    HD = H * Dh
    t = lambda x: _tensor(x, device)
    out = {"embed": t(tree["embed"]), "beat_enc": t(tree["beat_enc"]),
           "bar_enc": t(tree["bar_enc"]), "head_b": t(tree.get("head_b"))}
    expect = {"embed": (V, D), "beat_enc": (cfg.beat_len, D),
              "bar_enc": (cfg.max_bar_len, D), "head_b": (V,)}
    attn_shapes = {"q_w": (D, HD), "k_w": (D, HD), "v_w": (D, HD), "r_w": (D, HD),
                   "q_b": (HD,), "k_b": (HD,), "v_b": (HD,), "r_b": (HD,),
                   "ln_g": (D,), "ln_b": (D,)}
    block_shapes = {"ff1_w": (D, Dff), "ff1_b": (Dff,), "ff2_w": (Dff, D),
                    "ff2_b": (D,), "ff_ln_g": (D,), "ff_ln_b": (D,)}
    for name, n_layers in (("encoder", cfg.enc_layers), ("decoder", cfg.dec_layers)):
        layers = _layer_list(tree[name]["layers"])
        if len(layers) != n_layers:
            raise ValueError(f"{name}: checkpoint has {len(layers)} layers, config "
                             f"{n_layers}")
        out[name] = {"u": t(tree[name]["u"]), "v": t(tree[name]["v"]), "layers": [
            {**{m: {k: t(lp[m].get(k)) for k in _ATTN_KEYS} for m in ("mha1", "mha2")},
             **{k: t(lp.get(k)) for k in _MT_BLOCK_KEYS}} for lp in layers]}
        expect[f"{name}/u"] = expect[f"{name}/v"] = (H, 1, Dh)
        for i, lp in enumerate(out[name]["layers"]):
            for m in ("mha1", "mha2"):
                for k, shape in attn_shapes.items():
                    expect[f"{name}/layers/{i}/{m}/{k}"] = shape
            for k, shape in block_shapes.items():
                expect[f"{name}/layers/{i}/{k}"] = shape
    for key, shape in expect.items():
        node = out
        for part in key.split("/"):
            node = node[int(part)] if isinstance(node, list) else node[part]
        if node is not None and tuple(node.shape) != shape:
            raise ValueError(f"{key}: shape {tuple(node.shape)} != {shape}")
    return master_params(out, device) if master else out
