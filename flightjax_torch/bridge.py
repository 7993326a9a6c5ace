"""numpy <-> torch tree conversion: the only channel through which state and
parameters cross between the JAX package and this one (tests convert JAX
pytrees to numpy on their side)."""

import numpy as np
import torch

from flightjax_torch.core.modeling import tree_map


def tree_from_numpy(tree, device, dtype):
    """numpy (or Python scalar) leaves -> new tensors on `device`.
    Floating leaves take `dtype`; integer and bool leaves keep their numpy
    type."""
    def conv(leaf):
        a = np.asarray(leaf)
        if a.dtype.kind == "f":
            return torch.tensor(a, dtype=dtype, device=device)
        return torch.tensor(a, device=device)
    return tree_map(conv, tree)


def tree_to_numpy(tree):
    """Tensor leaves -> numpy arrays (copied to the host)."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)
