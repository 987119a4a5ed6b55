"""Parameter precision policy.

Inference: decode is memory-bound, every generated token reads the full
parameter set. Storing matmul weights in bfloat16 halves that traffic;
layer-norm parameters and the head bias stay float32 because they feed
float32 math.

Training: float32 master parameters that the optimizer updates; the forward
casts each weight to the activation dtype where it is used
(``models/txl.py::_linear``), so bf16 activations never round the masters.
"""

from __future__ import annotations

import torch

from .txl import tree_map

# parameters that stay fp32 even at inference
_FP32_KEYS = ("ln1_g", "ln1_b", "ln2_g", "ln2_b", "ln_g", "ln_b",
              "ff_ln_g", "ff_ln_b", "head_b")


def cast_params_for_inference(params, dtype=torch.bfloat16):
    """Cast float32 matmul-weight leaves to ``dtype``, keeping norm params
    float32. ``params`` is the port's nested dict/list of tensors."""
    def cast(name, leaf):
        if leaf is None or name in _FP32_KEYS or leaf.dtype != torch.float32:
            return leaf
        return leaf.to(dtype)

    def walk(name, node):
        if isinstance(node, dict):
            return {k: walk(k, v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(name, v) for v in node]
        return cast(name, node)

    return walk("", params)


def master_params(params, device=None):
    """Float32 master copies of a parameter tree (nested dicts / lists of
    tensors, None leaves kept), on ``device`` and with ``requires_grad``:
    the leaves the train step differentiates and the optimizer updates."""
    return tree_map(lambda t: t.detach().to(device=device, dtype=torch.float32).clone()
                    .requires_grad_(True), params)
