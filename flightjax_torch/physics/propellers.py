"""Table-interpolated propeller (port of the runtime `Propeller` of
`flightjax/physics/propellers.py:209-295`). The blade-element generator of
the table stays in the JAX package; this module reads its npz in place."""

import os
from typing import NamedTuple

import numpy as np
import torch

from flightjax_torch.core.modeling import divc
from flightjax_torch.ops.interp import Lookup
from flightjax_torch.ops.quaternions import cross, qrot, qrot_inv
from flightjax_torch.physics.atmosphere import get_airflow_angles
from flightjax_torch.physics.dynamics import (FrameTransform, Wrench,
                                              translate_wrench)

CW, CCW = 1, -1

PROP_TABLE_PATH = os.path.join(os.path.dirname(__file__), os.pardir,
                               os.pardir, "flightjax", "data",
                               "c172_prop_2blade.npz")


def load_prop_lookup(path=PROP_TABLE_PATH, *, device, dtype) -> Lookup:
    """The fused (J, Mt, dbeta, 6) coefficient table, flat extrapolation."""
    with np.load(path) as z:
        return Lookup((z["J"], z["Mt"], z["dbeta"]), z["values"],
                      extrap="flat", device=device, dtype=dtype)


class PropellerY(NamedTuple):
    wr_p: Wrench
    wr_b: Wrench
    hr_b: torch.Tensor


class Propeller:
    """Fixed-pitch propeller; `omega` is the signed propeller rate."""

    def __init__(self, lookup: Lookup, dbeta=0.0, sense=CW, d=2.0, J_xx=0.3,
                 r_bp=(0.0, 0.0, 0.0), *, device, dtype):
        self.lookup = lookup
        self.dbeta = float(dbeta)
        self.sense = int(sense)
        self.d = float(d)
        self.J_xx = float(J_xx)
        self.r_bp = torch.tensor(r_bp, dtype=dtype, device=device)
        self.q_bp = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype,
                                 device=device)

    def output(self, kin, air, omega) -> PropellerY:
        d, sense = self.d, self.sense
        q_bp, r_bp = self.q_bp, self.r_bp

        v_wOp_b = air.v_wb_b + cross(kin.omega_eb_b, r_bp.expand_as(
            kin.omega_eb_b))
        v_wOp_p = qrot_inv(q_bp, v_wOp_b)

        v_J = torch.sqrt(v_wOp_p[..., 0] ** 2 + v_wOp_p[..., 1] ** 2
                         + v_wOp_p[..., 2] ** 2 + 1e-12)
        omega_J = torch.clamp_min(torch.abs(omega), 1.0)
        J = 2 * np.pi * v_J / (omega_J * d)
        Mt = torch.abs(omega) * (d / 2) / air.a

        C = self.lookup(J, Mt, self.dbeta)
        C_Fx, C_Mx, C_Fz_a, C_Mz_a, C_P = (C[..., i] for i in range(5))

        alpha_p, beta_p = get_airflow_angles(v_wOp_p)

        C_F = torch.stack([C_Fx, C_Fz_a * beta_p, C_Fz_a * alpha_p], dim=-1)
        C_M = sense * torch.stack([C_Mx, C_Mz_a * beta_p, C_Mz_a * alpha_p],
                                  dim=-1)

        rho = air.rho
        f = divc(omega, 2 * np.pi)
        f2 = f * f
        d4 = d**4
        d5 = d * d4

        F_Op_p = (rho * f2 * d4)[..., None] * C_F
        tau_Op_p = (rho * f2 * d5)[..., None] * C_M

        wr_p = Wrench(F=F_Op_p, tau=tau_Op_p)
        wr_b = translate_wrench(FrameTransform(r=r_bp, q=q_bp), wr_p)

        zero = torch.zeros_like(omega)
        hr_p = torch.stack([self.J_xx * omega, zero, zero], dim=-1)
        hr_b = qrot(q_bp, hr_p)
        return PropellerY(wr_p=wr_p, wr_b=wr_b, hr_b=hr_b)
