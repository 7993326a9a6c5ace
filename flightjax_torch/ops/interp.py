"""Multilinear interpolation on rectilinear grids (port of the corner-gather
path of `flightjax/ops/interp.Lookup.__call__`, `interp.py:361-417`).

Per axis: 'flat' clamps the cell weight to [0, 1] (Interpolations.jl
Flat()), 'line' lets it run past the edge cells (Line()). Uniform axes
index by arithmetic, the others by `searchsorted`. The JAX package's dense
hat-basis and bundle paths exist for the TPU's matrix unit and are not
ported; they agree with this path to rounding.
"""

import numpy as np
import torch

from flightjax_torch.core.modeling import divc


def _is_uniform(a):
    a = np.asarray(a, dtype=np.float64)
    if a.shape[0] < 2:
        return False
    step = (a[-1] - a[0]) / (a.shape[0] - 1)
    return bool(np.allclose(np.diff(a), step, rtol=1e-6, atol=0.0))


class Lookup:
    """axes: tuple of increasing 1-D arrays (length 1 = degenerate axis,
    ignored); values: array whose leading dims match the axes, trailing
    dims are vector outputs; extrap: 'flat' | 'line' per axis (or one for
    all)."""

    def __init__(self, axes, values, extrap="flat", *, device, dtype):
        axes_np = tuple(np.asarray(a, dtype=np.float64) for a in axes)
        self.axes = tuple(torch.as_tensor(a, dtype=dtype, device=device)
                          for a in axes_np)
        self.values = torch.as_tensor(np.asarray(values, np.float64),
                                      dtype=dtype, device=device)
        if isinstance(extrap, str):
            extrap = (extrap,) * len(axes_np)
        self.extrap = tuple(extrap)
        if len(self.extrap) != len(self.axes):
            raise ValueError("one extrapolation mode per axis")
        self.uniform = tuple(_is_uniform(a) for a in axes_np)
        # per-axis (first knot, spacing) of uniform axes, computed in the
        # table's dtype exactly as `(ax[-1] - ax[0]) / (n - 1)` is
        self._uni = tuple(
            (ax[0], (ax[-1] - ax[0]) / (ax.shape[0] - 1)) if u else None
            for ax, u in zip(self.axes, self.uniform))

    def __call__(self, *coords):
        if len(coords) != len(self.axes):
            raise ValueError("one coordinate per axis")
        ref = next(c for c in coords if isinstance(c, torch.Tensor))
        coords = torch.broadcast_tensors(*[
            c if isinstance(c, torch.Tensor)
            else torch.full_like(ref, float(c)) for c in coords])
        batch_shape = coords[0].shape

        idxs, wgts = [], []
        for x, ax, mode, uni in zip(coords, self.axes, self.extrap,
                                    self._uni):
            n = ax.shape[0]
            if n == 1:
                idxs.append(torch.zeros(batch_shape, dtype=torch.long,
                                        device=x.device))
                wgts.append(None)
                continue
            if uni is not None:
                x0, dx = uni
                i = torch.clamp(torch.floor((x - x0) / dx).long(), 0, n - 2)
                w = (x - x0) / dx - i
            else:
                i = torch.clamp(torch.searchsorted(ax, x.contiguous(),
                                                   right=True) - 1, 0, n - 2)
                xa = ax[i]
                xb = ax[i + 1]
                w = (x - xa) / (xb - xa)
            if mode == "flat":
                w = torch.clamp(w, 0.0, 1.0)
            idxs.append(i)
            wgts.append(w)

        d = len(self.axes)
        out = None
        for corner in range(1 << d):
            idx = []
            w = torch.ones(batch_shape, dtype=self.values.dtype,
                           device=self.values.device)
            skip = False
            for k in range(d):
                hi = (corner >> k) & 1
                if self.axes[k].shape[0] == 1:
                    if hi:
                        skip = True
                        break
                    idx.append(idxs[k])
                    continue
                idx.append(idxs[k] + hi)
                w = w * (wgts[k] if hi else (1.0 - wgts[k]))
            if skip:
                continue
            v = self.values[tuple(idx)]
            v = v * w.reshape(batch_shape + (1,) * (v.dim() - len(batch_shape)))
            out = v if out is None else out + v
        return out


class RowLookup:
    """Bilinear lookup on a 2-D uniform grid with flat extrapolation — the
    per-lane counterpart of `Lookup._call_rowgather` (`interp.py:330-359`):
    the same cell index and weights, reading the four cell corners instead
    of two whole grid rows. The cell coordinates are true quotients
    (`divc`), as the `geoid` kernel forms them."""

    def __init__(self, axes, values, *, device, dtype):
        a0, a1 = (np.asarray(a, dtype=np.float64) for a in axes)
        if not (_is_uniform(a0) and _is_uniform(a1)):
            raise ValueError("RowLookup requires uniform axes")
        self.values = torch.as_tensor(np.asarray(values, np.float64),
                                      dtype=dtype, device=device)
        ta0 = torch.as_tensor(a0, dtype=dtype)
        ta1 = torch.as_tensor(a1, dtype=dtype)
        self.n0, self.n1 = a0.shape[0], a1.shape[0]
        self.x0 = float(ta0[0])
        self.y0 = float(ta1[0])
        self.d0 = float((ta0[-1] - ta0[0]) / (self.n0 - 1))
        self.d1 = float((ta1[-1] - ta1[0]) / (self.n1 - 1))

    def __call__(self, x, y):
        f0 = divc(x - self.x0, self.d0)
        i0 = torch.clamp(torch.floor(f0).long(), 0, self.n0 - 2)
        w0 = torch.clamp(f0 - i0, 0.0, 1.0)
        t1 = torch.clamp(divc(y - self.y0, self.d1), 0.0, self.n1 - 1.0)
        i1 = torch.clamp(torch.floor(t1).long(), 0, self.n1 - 2)
        w1 = t1 - i1
        V = self.values
        row_a = V[i0, i1] * (1.0 - w0) + V[i0 + 1, i1] * w0
        row_b = V[i0, i1 + 1] * (1.0 - w0) + V[i0 + 1, i1 + 1] * w0
        return row_a * (1.0 - w1) + row_b * w1
