"""Parameter precision policy for inference.

Decode is memory-bound: every generated token reads the full parameter set.
Storing matmul weights in bfloat16 halves that traffic; layer-norm
parameters and the head bias stay float32 because they feed float32 math.
"""

from __future__ import annotations

import torch

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
