"""Frames, wrenches, mass properties and Newton-Euler dynamics at the centre
of mass (port of `flightjax/physics/dynamics.py`)."""

from typing import NamedTuple

import torch

from flightjax_torch.ops import geodesy as geo
from flightjax_torch.ops.attitude import quat_to_matrix, skew
from flightjax_torch.ops.quaternions import cross, qrot, qrot_inv


class Wrench(NamedTuple):
    F: torch.Tensor
    tau: torch.Tensor

    def __add__(self, other):
        return Wrench(self.F + other.F, self.tau + other.tau)


class FrameTransform(NamedTuple):
    """Frame c relative to b: r = r_ObOc_b, q = q_bc."""
    r: torch.Tensor
    q: torch.Tensor


def translate_wrench(t_bc: FrameTransform, wr_c: Wrench) -> Wrench:
    F_b = qrot(t_bc.q, wr_c.F)
    tau_b = qrot(t_bc.q, wr_c.tau) + cross(t_bc.r, F_b)
    return Wrench(F=F_b, tau=tau_b)


def _mm(A, B):
    """(..., 3, 3) product as broadcast-multiply-reduce, summed in order."""
    P = A[..., :, :, None] * B[..., None, :, :]
    return P[..., 0, :] + P[..., 1, :] + P[..., 2, :]


def _mv(M, v):
    P = M * v[..., None, :]
    return P[..., 0] + P[..., 1] + P[..., 2]


class MassProps(NamedTuple):
    """m, J about Ob in b axes, r_OG in b axes."""
    m: torch.Tensor
    J: torch.Tensor
    r_OG: torch.Tensor

    def __add__(self, other):
        m = self.m + other.m
        safe_m = torch.where(m > 0, m, torch.ones_like(m))
        r = (self.m[..., None] * self.r_OG + other.m[..., None] * other.r_OG) \
            / safe_m[..., None]
        return MassProps(m=m, J=self.J + other.J, r_OG=r)


def mass_props_point(m, r_bP_b) -> MassProps:
    """Point mass m ([B] or scalar) at r_bP_b ((3,))."""
    S = skew(r_bP_b)
    SS = _mm(S, S)
    J = -(m.reshape(m.shape + (1, 1)) * SS)
    return MassProps(m=m, J=J, r_OG=torch.broadcast_to(
        r_bP_b, m.shape + (3,)))


def mass_props_rigid(m, J_G_c, t_bc: FrameTransform) -> MassProps:
    R = quat_to_matrix(t_bc.q)
    J_G_b = _mm(_mm(R, J_G_c), R.transpose(-1, -2))
    S = skew(t_bc.r)
    J_b_b = J_G_b - m.reshape(m.shape + (1, 1)) * _mm(S, S)
    return MassProps(m=m, J=J_b_b, r_OG=t_bc.r)


def translate_mass_props_pure(r, mp_c: MassProps) -> MassProps:
    """`translate_mass_props` (`dynamics.py:127-138`) for a pure
    translation t_bc = (r, identity): the rotation R is exactly I, so
    R J R^T = J is exact and skipped."""
    m = mp_c.m
    m33 = m.reshape(m.shape + (1, 1))
    Sc = skew(mp_c.r_OG)
    J_G_c = mp_c.J + m33 * _mm(Sc, Sc)
    r_bG_b = r + mp_c.r_OG
    Sb = skew(r_bG_b)
    J_b_b = J_G_c - m33 * _mm(Sb, Sb)
    return MassProps(m=m, J=J_b_b, r_OG=r_bG_b)


def solve3(A, b):
    """Closed-form 3x3 solve via the adjugate (`dynamics.py:148-169`)."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a12 * a20 - a10 * a22
    c02 = a10 * a21 - a11 * a20
    det = a00 * c00 + a01 * c01 + a02 * c02
    c10 = a02 * a21 - a01 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a01 * a20 - a00 * a21
    c20 = a01 * a12 - a02 * a11
    c21 = a02 * a10 - a00 * a12
    c22 = a00 * a11 - a01 * a10
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    x0 = (c00 * b0 + c10 * b1 + c20 * b2) / det
    x1 = (c01 * b0 + c11 * b1 + c21 * b2) / det
    x2 = (c02 * b0 + c12 * b1 + c22 * b2) / det
    return torch.stack([x0, x1, x2], dim=-1)


class DynamicsU(NamedTuple):
    mp_sum_b: MassProps
    wr_sum_b: Wrench
    ho_sum_b: torch.Tensor
    q_eb: torch.Tensor
    r_eb_e: torch.Tensor


class DynamicsY(NamedTuple):
    """The dynamics' outputs the port reads (`dynamics.py:180-198`): the
    specific force at the CoM in CoM axes, the fleet's load factor; the
    angular acceleration wrt inertial space and the summed mass properties
    at the body origin, which the IMU reads."""
    f_c_c: torch.Tensor
    alpha_ib_b: torch.Tensor = None
    mp_sum_b: MassProps = None


class VehicleDynamics:
    """Newton-Euler at the CoM (`dynamics.py:202-290`); x = {omega_eb_b,
    v_eb_b}. `f_ode` returns only x_dot, the fleet step's; `output` the
    specific force the loads read."""

    def f_ode(self, x, u: DynamicsU):
        v = self._solve(x, u)
        return {"omega_eb_b": v["omega_dot"], "v_eb_b": v["v_dot_eb_b"]}

    def output(self, x, u: DynamicsU) -> DynamicsY:
        """f_c_c = a_ic_c - G_c_c and alpha_ib_b (`dynamics.py:263-276`)."""
        v = self._solve(x, u)
        om_ie, om_ec, v_ec = v["omega_ie_c"], v["omega_ec_c"], v["v_ec_c"]
        r_ec_c = qrot_inv(u.q_eb, v["r_ec_e"])
        centripetal = cross(om_ie, cross(om_ie, r_ec_c))
        a_ic_c = (v["v_dot_ec_c"] + cross(om_ec + 2 * om_ie, v_ec)
                  + centripetal)
        G_c_c = v["g_c_c"] + centripetal
        alpha_ib_b = v["omega_dot"] - cross(x["omega_eb_b"], om_ie)
        return DynamicsY(f_c_c=a_ic_c - G_c_c, alpha_ib_b=alpha_ib_b,
                         mp_sum_b=u.mp_sum_b)

    def _solve(self, x, u: DynamicsU):
        omega_eb_b = x["omega_eb_b"]
        v_eb_b = x["v_eb_b"]
        mp_sum_b, wr_sum_b, ho_sum_b, q_eb, r_eb_e = u

        omega_ie_e = torch.zeros_like(r_eb_e)
        omega_ie_e[..., 2] = geo.omega_ie
        omega_ie_b = qrot_inv(q_eb, omega_ie_e)

        r_bc_b = mp_sum_b.r_OG
        # t_cb = (-r_bc_b, identity): the identity rotation is exact
        mp_sum_c = translate_mass_props_pure(-r_bc_b, mp_sum_b)
        F_c = wr_sum_b.F
        tau_c = wr_sum_b.tau + cross(-r_bc_b, F_c)
        m_sum = mp_sum_c.m
        J_c = mp_sum_c.J

        omega_ec_c = omega_eb_b
        v_ec_c = v_eb_b + cross(omega_ec_c, r_bc_b)
        omega_ie_c = omega_ie_b
        omega_ic_c = omega_ie_c + omega_ec_c

        r_bc_e = qrot(q_eb, r_bc_b)
        r_ec_e = r_eb_e + r_bc_e
        n_c, h_c = geo.geographic_from_cartesian(r_ec_e)

        g_mag = geo.gravity(n_c, h_c)
        g_c_c = g_mag[..., None] * qrot_inv(q_eb, -n_c)

        hc = _mv(J_c, omega_ic_c) + ho_sum_b
        rhs = (tau_c - _mv(J_c, cross(omega_ie_c, omega_ec_c))
               - cross(omega_ic_c, hc))
        omega_dot_ec_c = solve3(J_c, rhs)
        v_dot_ec_c = (F_c / m_sum[..., None] + g_c_c
                      - cross(omega_ec_c + 2 * omega_ie_c, v_ec_c))

        v_dot_eb_b = v_dot_ec_c - cross(omega_dot_ec_c, r_bc_b)
        return {"omega_dot": omega_dot_ec_c, "v_dot_eb_b": v_dot_eb_b,
                "v_dot_ec_c": v_dot_ec_c, "omega_ie_c": omega_ie_c,
                "omega_ec_c": omega_ec_c, "v_ec_c": v_ec_c,
                "r_ec_e": r_ec_e, "g_c_c": g_c_c}
