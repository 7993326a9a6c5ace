"""Control-law primitives (port of `flightjax/physics/control.py`): the
continuous PI with anti-windup the gear and engine regulators use
(`:36-87`), and the discrete integrator, lead-lag, PID and LQR tracker and
the gain schedules the C172X control laws use (`:92-316`).

They are pure step functions over (params, state) NamedTuples, as in the
reference; every leaf broadcasts, so a fleet of controllers is the scalar
controller on `[B, ...]` leaves. PI gains are Python floats; the discrete
controllers' gains may be tensors (scheduled per lane)."""

from typing import NamedTuple

import numpy as np
import torch

from flightjax_torch.core.modeling import rdiv

INF = float("inf")


class PIParams(NamedTuple):
    k_p: float
    k_i: float
    k_l: float
    beta_p: float
    bound_lo: float
    bound_hi: float


def pi_params(k_p=1.0, k_i=0.0, k_l=0.0, beta_p=1.0, bound_lo=-INF,
              bound_hi=INF):
    return PIParams(float(k_p), float(k_i), float(k_l), float(beta_p),
                    float(bound_lo), float(bound_hi))


class PIOutput(NamedTuple):
    y_p: torch.Tensor
    y_i: torch.Tensor
    out_free: torch.Tensor
    sat_out: torch.Tensor
    output: torch.Tensor
    int_halted: torch.Tensor


def saturation_status(out_free, lo, hi):
    return ((out_free >= hi).to(torch.int32)
            - (out_free <= lo).to(torch.int32))


def _halted(u_i, sat_out_0, sat_ext):
    """Integration halts where the input pushes further into the previous
    output saturation or the external one (`control.py:42-44`)."""
    return (torch.sign(u_i * sat_out_0) > 0) | (torch.sign(u_i * sat_ext)
                                                > 0)


def pi_ode(p: PIParams, x_i, inp):
    """Returns (x_i_dot, PIOutput) (`control.py:76-87`, sat_ext = 0)."""
    u_p = p.beta_p * inp
    u_i = inp
    y_p = p.k_p * u_p
    y_i = x_i
    out_free = y_p + y_i
    output = torch.clamp(out_free, p.bound_lo, p.bound_hi)
    sat_out = saturation_status(out_free, p.bound_lo, p.bound_hi)
    int_halted = torch.sign(u_i * sat_out) > 0
    x_i_dot = p.k_i * u_i * (1.0 - int_halted.to(u_i.dtype)) - p.k_l * x_i
    return x_i_dot, PIOutput(y_p, y_i, out_free, sat_out, output, int_halted)


def _f(v, like):
    """`v` as a tensor like `like` (a Python or numpy number, or a tensor)."""
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------- Integrator

class IntegratorState(NamedTuple):
    x0: torch.Tensor
    sat_out_0: torch.Tensor


def integrator_state(x0=0.0, *, dtype=torch.float64, device="cpu"):
    x0 = torch.as_tensor(x0, dtype=dtype, device=device)
    return IntegratorState(x0=x0, sat_out_0=torch.zeros_like(
        x0, dtype=torch.int32))


class IntegratorOutput(NamedTuple):
    x1: torch.Tensor
    output: torch.Tensor
    sat_out: torch.Tensor
    halted: torch.Tensor


def integrator_step(s: IntegratorState, inp, dt, bound_lo=-INF,
                    bound_hi=INF, sat_ext=0):
    """Discrete integrator with halt-on-saturation (`control.py:111-119`)."""
    halted = _halted(inp, s.sat_out_0, sat_ext)
    x1 = s.x0 + dt * inp * (1.0 - halted.to(inp.dtype))
    output = torch.clamp(x1, bound_lo, bound_hi)
    sat_out = saturation_status(x1, bound_lo, bound_hi)
    return (IntegratorState(x0=x1, sat_out_0=sat_out),
            IntegratorOutput(x1, output, sat_out, halted))


# ------------------------------------------------------------------ LeadLag

class LeadLagState(NamedTuple):
    u0: torch.Tensor  # previous input
    x0: torch.Tensor  # previous state


def leadlag_state(*, dtype=torch.float64, device="cpu"):
    z = torch.zeros((), dtype=dtype, device=device)
    return LeadLagState(u0=z, x0=z.clone())


def leadlag_step(s: LeadLagState, u1, dt, z=-1.0, p=-10.0, k=1.0):
    """Tustin-discretised lead/lag with zero z, pole p and gain k
    (`control.py:134-143`)."""
    a0 = (2 + p * dt) / (2 - p * dt)
    b1 = (2 - z * dt) / (2 - p * dt)
    b0 = (-2 - z * dt) / (2 - p * dt)
    x1 = a0 * s.x0 + b1 * u1 + b0 * s.u0
    return LeadLagState(u0=u1, x0=x1), k * x1


# ---------------------------------------------------------------------- PID

class PIDParams(NamedTuple):
    k_p: object
    k_i: object
    k_d: object
    tau_f: object      # derivative filter time constant
    beta_p: object
    beta_d: object
    bound_lo: object
    bound_hi: object


def pid_params(k_p=1.0, k_i=0.0, k_d=0.0, tau_f=0.01, beta_p=1.0,
               beta_d=1.0, bound_lo=-INF, bound_hi=INF):
    """Gains as given: tensors (scheduled) or Python floats."""
    return PIDParams(k_p, k_i, k_d, tau_f, beta_p, beta_d, bound_lo,
                     bound_hi)


class PIDState(NamedTuple):
    x_i0: torch.Tensor
    x_d0: torch.Tensor
    sat_out_0: torch.Tensor


def pid_state(shape=(), *, dtype=torch.float64, device="cpu"):
    z = torch.zeros(shape, dtype=dtype, device=device)
    return PIDState(x_i0=z, x_d0=z.clone(),
                    sat_out_0=torch.zeros(shape, dtype=torch.int32,
                                          device=device))


class PIDOutput(NamedTuple):
    y_p: torch.Tensor
    y_i: torch.Tensor
    y_d: torch.Tensor
    out_free: torch.Tensor
    sat_out: torch.Tensor
    output: torch.Tensor
    int_halted: torch.Tensor


def _clip(x, lo, hi):
    """jnp.clip with scalar or tensor bounds (NaN propagates)."""
    if isinstance(lo, torch.Tensor) or isinstance(hi, torch.Tensor):
        return torch.minimum(torch.maximum(x, _f(lo, x)), _f(hi, x))
    return torch.clamp(x, lo, hi)


def pid_step(p: PIDParams, s: PIDState, inp, dt, sat_ext=0):
    """Gain-schedulable PID: backward-Euler integral, filtered derivative
    (`control.py:190-213`)."""
    tf = p.tau_f + dt
    alpha = rdiv(1.0, tf) if isinstance(tf, torch.Tensor) else 1.0 / tf
    u_p = p.beta_p * inp
    u_d = p.beta_d * inp
    u_i = inp

    int_halted = _halted(u_i, s.sat_out_0, sat_ext)
    x_i = s.x_i0 + dt * p.k_i * u_i * (1.0 - int_halted.to(inp.dtype))
    x_d = alpha * p.tau_f * s.x_d0 + dt * alpha * p.k_d * u_d

    y_p = p.k_p * u_p
    y_i = x_i
    y_d = alpha * (-s.x_d0 + p.k_d * u_d)
    out_free = y_p + y_i + y_d
    sat_out = saturation_status(out_free, p.bound_lo, p.bound_hi)
    output = _clip(out_free, p.bound_lo, p.bound_hi)

    return (PIDState(x_i0=x_i, x_d0=x_d, sat_out_0=sat_out),
            PIDOutput(y_p, y_i, y_d, out_free, sat_out, output, int_halted))


# ---------------------------------------------------------------------- LQR

class LQRParams(NamedTuple):
    """Gains and trim point of a steady-state LQR tracker
    (`control.py:218-228`); leaves may carry a leading lane axis."""
    K_fbk: torch.Tensor      # (NU, NX)
    K_fwd: torch.Tensor      # (NU, NZ)
    K_int: torch.Tensor      # (NU, NZ)
    x_trim: torch.Tensor     # (NX,)
    u_trim: torch.Tensor     # (NU,)
    z_trim: torch.Tensor     # (NZ,)
    bound_lo: torch.Tensor   # (NU,)
    bound_hi: torch.Tensor   # (NU,)


def lqr_params(nx, nu, nz, *, dtype=torch.float64, device="cpu", **kw):
    z = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    d = dict(K_fbk=z(nu, nx), K_fwd=z(nu, nz), K_int=z(nu, nz),
             x_trim=z(nx), u_trim=z(nu), z_trim=z(nz),
             bound_lo=torch.full((nu,), -INF, dtype=dtype, device=device),
             bound_hi=torch.full((nu,), INF, dtype=dtype, device=device))
    d.update({k: torch.as_tensor(v, dtype=dtype, device=device)
              for k, v in kw.items()})
    return LQRParams(**d)


class LQRState(NamedTuple):
    int_out_0: torch.Tensor   # (NU,)
    out_sat_0: torch.Tensor   # (NU,) int32


def lqr_state(nu, *, dtype=torch.float64, device="cpu"):
    return LQRState(int_out_0=torch.zeros(nu, dtype=dtype, device=device),
                    out_sat_0=torch.zeros(nu, dtype=torch.int32,
                                          device=device))


class LQROutput(NamedTuple):
    int_in: torch.Tensor
    int_halted: torch.Tensor
    int_out: torch.Tensor
    out_free: torch.Tensor
    out_sat: torch.Tensor
    output: torch.Tensor


def _mv(M, v):
    return torch.sum(M * v[..., None, :], dim=-1)


def lqr_step(p: LQRParams, s: LQRState, x, z, z_ref, dt, sat_ext=0):
    """LQR tracker update (`control.py:271-285`)."""
    int_in = _mv(p.K_int, z_ref - z)
    int_halted = _halted(int_in, s.out_sat_0, sat_ext)
    int_out = s.int_out_0 + dt * int_in * (1.0 - int_halted.to(x.dtype))

    out_free = (p.u_trim + int_out + _mv(p.K_fwd, z_ref - p.z_trim)
                - _mv(p.K_fbk, x - p.x_trim))
    out_sat = saturation_status(out_free, p.bound_lo, p.bound_hi)
    output = _clip(out_free, p.bound_lo, p.bound_hi)
    return (LQRState(int_out_0=int_out, out_sat_0=out_sat),
            LQROutput(int_in, int_halted, int_out, out_free, out_sat,
                      output))


# ------------------------------------------------------------ gain schedules

def schedule(lookup_tree, *coords):
    """A tree of `ops.interp.Lookup`s evaluated at one query point, the
    same tree of values (`control.py:290-301`); other leaves pass
    through."""
    from flightjax_torch.ops.interp import Lookup

    def ev(node):
        if isinstance(node, Lookup):
            return node(*coords)
        if isinstance(node, dict):
            return {k: ev(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(ev(v) for v in node)
        return node
    return ev(lookup_tree)


def load_schedule(path, params_like, extrap="flat", *, dtype=torch.float64,
                  device="cpu"):
    """A gain schedule saved by the JAX package's `save_schedule` as a tree
    of Lookups shaped like `params_like` (`control.py:320-336`); the
    leaves pair with `leaf_<i>` in the tree's flattening order (dict keys
    sorted)."""
    from flightjax_torch.core.modeling import tree_leaves_with_path
    from flightjax_torch.ops.interp import Lookup

    with np.load(path) as data:
        n_axes = int(data["__axes__"])
        axes = [data[next(k for k in data.files
                          if k.startswith(f"axis_{i}_"))]
                for i in range(n_axes)]
        leaves = [Lookup(tuple(axes), data[f"leaf_{i}"], extrap=extrap,
                         dtype=dtype, device=device)
                  for i in range(len(tree_leaves_with_path(params_like)))]
    it = iter(leaves)
    order = {p: next(it) for p, _ in tree_leaves_with_path(params_like)}

    def build(node, path=()):
        if isinstance(node, dict):
            return {k: build(v, path + (k,)) for k, v in node.items()}
        if hasattr(node, "_fields"):
            return type(node)(*(build(v, path + (f,))
                                for f, v in zip(node._fields, node)))
        if isinstance(node, (list, tuple)):
            return type(node)(build(v, path + (i,))
                              for i, v in enumerate(node))
        return order[path]
    return build(params_like)
