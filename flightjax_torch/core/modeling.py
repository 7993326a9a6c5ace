"""Tree helpers for nested-dict / NamedTuple state (port of
`flightjax/core/modeling.py`).

A "tree" is a nested structure of dicts, lists, tuples and NamedTuples with
tensors (or None) at the leaves. Dict children are visited in sorted-key
order, the order `jax.tree` flattens them in, so flattened leaf lists line
up with the JAX package's.
"""

import torch


def is_namedtuple(x):
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn, tree, *rest):
    """Apply `fn` leafwise over identically-structured trees. None leaves
    (in the first tree) are kept as None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves_with_path(tree, path=()):
    """[(path, leaf)] in JAX flattening order (dict keys sorted)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += tree_leaves_with_path(tree[k], path + (k,))
        return out
    if is_namedtuple(tree):
        out = []
        for name, v in zip(tree._fields, tree):
            out += tree_leaves_with_path(v, path + (name,))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += tree_leaves_with_path(v, path + (i,))
        return out
    return [(path, tree)]


def rdiv(c, x):
    """The true quotient c / x for a Python number c. PyTorch evaluates
    `c / tensor` as reciprocal(tensor) * c, one rounding more than the JAX
    reference and the CUDA kernels make."""
    return torch.full_like(x, c) / x


def divc(x, c):
    """The true quotient x / c for a Python number c. On CUDA PyTorch
    evaluates `tensor / c` as tensor * (1 / c), one rounding more than the
    JAX reference and the CUDA kernels make."""
    return x / torch.full_like(x, c)


def bscale(c, leaf):
    """`c * leaf` for a per-lane `c` ([B] or scalar) and a `[B, ...]` leaf:
    `c` is expanded on trailing axes (the JAX helper of the same name
    exists for Mosaic; here it is plain broadcasting)."""
    if isinstance(c, torch.Tensor):
        c = c.reshape(c.shape + (1,) * (leaf.dim() - c.dim()))
    return c * leaf


def bwhere(pred, a, b):
    """`torch.where` with a lower-rank `pred` expanded on trailing axes."""
    a = torch.as_tensor(a)
    b = torch.as_tensor(b)
    nd = max(a.dim(), b.dim())
    pred = pred.reshape(pred.shape + (1,) * (nd - pred.dim()))
    return torch.where(pred, a, b)


def tree_where(pred, true_tree, false_tree):
    """Select between two identically-structured trees leafwise with
    `bwhere` (`modeling.py:70-95`); a leaf that is the same object in both
    passes through unselected, as in the JAX helper."""
    def sel(t, f):
        if t is f:
            return t
        return bwhere(pred, t, f)
    return tree_map(sel, true_tree, false_tree)


def canonical(tree):
    """Every leaf a tensor: Python and numpy scalars become tensors (the
    JAX helper strips weak types, which PyTorch does not have)."""
    return tree_map(lambda l: l if isinstance(l, torch.Tensor)
                    else torch.as_tensor(l), tree)
