"""Wander-azimuth kinematics (port of `WA` and its helpers from
`flightjax/physics/kinematics.py:105-226`)."""

from typing import NamedTuple

import torch

from flightjax_torch.core.modeling import bwhere
from flightjax_torch.ops import attitude as att
from flightjax_torch.ops import geodesy as geo
from flightjax_torch.ops.quaternions import (dot, qdt, qmul, qmul_zpost,
                                             qmul_zpre, qrot, qrot_inv,
                                             rot2_z)
from flightjax_torch.physics.atmosphere import norm3

V_MIN_CHI_GAMMA = 0.1


class KinData(NamedTuple):
    """Kinematic snapshot (`kinematics.py:31-50`): 40 values per lane."""
    e_nb: torch.Tensor
    q_nb: torch.Tensor
    q_eb: torch.Tensor
    q_en: torch.Tensor
    lat: torch.Tensor
    lon: torch.Tensor
    n_e: torch.Tensor
    h_e: torch.Tensor
    h_o: torch.Tensor
    r_eb_e: torch.Tensor
    omega_wb_b: torch.Tensor
    omega_eb_b: torch.Tensor
    v_eb_b: torch.Tensor
    v_eb_n: torch.Tensor
    v_gnd: torch.Tensor
    chi_gnd: torch.Tensor
    gamma_gnd: torch.Tensor


def get_omega_ew_n(v_eb_n, n_e, h_e):
    R_N, R_E = geo.radii(n_e)
    return torch.stack([v_eb_n[..., 1] / (R_E + h_e),
                        -v_eb_n[..., 0] / (R_N + h_e),
                        torch.zeros_like(h_e)], dim=-1)


def _course_gamma(v_eb_n):
    v_gnd = norm3(v_eb_n)
    valid = v_gnd > V_MIN_CHI_GAMMA
    zero = torch.zeros_like(v_gnd)
    chi = torch.where(valid, att.azimuth(v_eb_n), zero)
    gamma = torch.where(valid, att.inclination(v_eb_n), zero)
    return v_gnd, chi, gamma


def _kin_data_common(q_nb, q_en, q_eb, n_e, h_e, omega_wb_b, omega_eb_b,
                     v_eb_b, v_eb_n, geoid_N):
    """`kinematics.py:113-133` with the carried geoid undulation."""
    lat, lon = geo.latlon_from_nvector(n_e)
    h_o = h_e - geoid_N
    r_eb_e = geo.cartesian_from_geographic(n_e, h_e)
    v_gnd, chi, gamma = _course_gamma(v_eb_n)
    return KinData(
        e_nb=att.quat_to_euler(q_nb), q_nb=q_nb, q_eb=q_eb, q_en=q_en,
        lat=lat, lon=lon, n_e=n_e, h_e=h_e, h_o=h_o, r_eb_e=r_eb_e,
        omega_wb_b=omega_wb_b, omega_eb_b=omega_eb_b, v_eb_b=v_eb_b,
        v_eb_n=v_eb_n, v_gnd=v_gnd, chi_gnd=chi, gamma_gnd=gamma)


def normalize_eps(dtype):
    """The renorm gate of `_normalize_block` (`kinematics.py:148-161`):
    32 ulp in float32, the reference's 1e-8 in float64."""
    return max(32 * torch.finfo(dtype).eps, 1e-8)


def _normalize_block(x):
    n = torch.sqrt(dot(x, x))[..., None]
    return bwhere(torch.abs(n - 1.0)[..., 0] > normalize_eps(x.dtype),
                  x / n, x)


class WA:
    """Wander-azimuth mechanization: x = {q_wb (4), q_ew (4), h_e};
    u = {omega_eb_b (3), v_eb_b (3)} (the dynamics state)."""

    def f_ode(self, x, u, geoid_N, t=None):
        q_wb, q_ew, h_e = x["q_wb"], x["q_ew"], x["h_e"]
        omega_eb_b, v_eb_b = u["omega_eb_b"], u["v_eb_b"]

        A, B = geo.get_psi_nw_ab(q_ew)
        n2 = A * A + B * B
        ok = n2 > 0
        hinv = torch.rsqrt(torch.clamp_min(n2, 1e-30))
        cpsi = torch.where(ok, B * hinv, torch.ones_like(n2))
        spsi = torch.where(ok, A * hinv, torch.zeros_like(n2))
        c2, s2 = att.half_angle_cs(cpsi, spsi)

        q_nb = qmul_zpre(c2, s2, q_wb)
        q_eb = qmul(q_ew, q_wb)
        q_en = qmul_zpost(q_ew, c2, -s2)

        n_e = geo.nvector_from_qew(q_ew)
        v_eb_n = qrot(q_nb, v_eb_b)
        omega_ew_n = get_omega_ew_n(v_eb_n, n_e, h_e)
        omega_ew_w = rot2_z(cpsi, -spsi, omega_ew_n)
        omega_ew_b = qrot_inv(q_wb, omega_ew_w)
        omega_wb_b = omega_eb_b - omega_ew_b

        x_dot = {"q_wb": qdt(q_wb, omega_wb_b),
                 "q_ew": qdt(q_ew, omega_ew_w),
                 "h_e": -v_eb_n[..., 2]}
        y = _kin_data_common(q_nb, q_en, q_eb, n_e, h_e, omega_wb_b,
                             omega_eb_b, v_eb_b, v_eb_n, geoid_N)
        return x_dot, y

    def f_step(self, x):
        x = dict(x)
        x["q_wb"] = _normalize_block(x["q_wb"])
        x["q_ew"] = _normalize_block(x["q_ew"])
        return x
