"""Continuous PI with anti-windup (port of `pi_params`/`pi_ode` from
`flightjax/physics/control.py:36-87`). Gains are Python floats, broadcast
against the batched input."""

from typing import NamedTuple

import torch

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
