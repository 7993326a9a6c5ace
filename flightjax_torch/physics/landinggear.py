"""Landing gear: strut geometry and contact friction, per leg, branch-free
(port of `LandingGearUnit` and `GearSet` from
`flightjax/physics/landinggear.py:69-589`).

Every leg is evaluated on every lane: the JAX package's fleet-level gear
gate (`gear_gated`) skips the strut math when the whole fleet is airborne,
and its airborne branch is state-exact, so evaluating ungated gives the same
state (only the diagnostic `delta_h` differs, which no state carries).
"""

from typing import NamedTuple

import numpy as np
import torch

from flightjax_torch.core.modeling import bwhere, divc
from flightjax_torch.ops import attitude as att
from flightjax_torch.ops.quaternions import (cross, dot, qconj, qmul, qrot,
                                             qrot_inv)
from flightjax_torch.physics import control as C
from flightjax_torch.physics.dynamics import (FrameTransform, Wrench,
                                              translate_wrench)

ALPHA_TS_MAX = float(np.deg2rad(60.0))
XI_DOT_MAX = 10.0

_ROLL = (0.03, 0.02, 0.005, 0.01)
_SKID_MU_S = (0.75, 0.25, 0.075)
_SKID_MU_D = (0.25, 0.15, 0.025)
_SKID_V = (0.005, 0.01)


class SimpleDamper(NamedTuple):
    k_s: float = 25000.0
    k_d_ext: float = 1000.0
    k_d_cmp: float = 1000.0
    F_max: float = 50000.0


def damper_force(d: SimpleDamper, xi, xi_dot):
    k_d = torch.where(xi_dot > 0, torch.full_like(xi_dot, d.k_d_ext),
                      torch.full_like(xi_dot, d.k_d_cmp))
    return -(d.k_s * xi + k_d * xi_dot)


def _mu_blend(mu_s, mu_d, v_s, v_d, v):
    k_sd = torch.clamp(divc(v - v_s, v_d - v_s), 0.0, 1.0)
    return k_sd * mu_d + (1.0 - k_sd) * mu_s


def mu_roll(v):
    mu_s, mu_d, v_s, v_d = _ROLL
    return _mu_blend(mu_s, mu_d, v_s, v_d, v)


def mu_skid(surface, v):
    def pick(tbl):
        return torch.where(surface == 0, torch.full_like(v, tbl[0]),
                           torch.where(surface == 1, torch.full_like(v, tbl[1]),
                                       torch.full_like(v, tbl[2])))
    return _mu_blend(pick(_SKID_MU_S), pick(_SKID_MU_D), *_SKID_V, v)


class StrutY(NamedTuple):
    """The strut quantities the fleet step consumes, masked to the
    wow=false defaults."""
    wow: torch.Tensor
    xi_dot: torch.Tensor
    F_dmp_zs: torch.Tensor
    alpha_ts: torch.Tensor
    r_bc_b: torch.Tensor
    q_sc: torch.Tensor
    q_bc: torch.Tensor
    v_ec_xy: torch.Tensor


def _norm(v, eps=1e-12):
    out = v[..., 0] * v[..., 0]
    for k in range(1, v.shape[-1]):
        out = out + v[..., k] * v[..., k]
    return torch.sqrt(out + eps)


class LandingGearUnit:
    """One leg: steering + braking + strut + contact
    (`landinggear.py:169-377`); `psi_max`/`eta_br` of 0 reproduce no
    steering / no braking exactly."""

    def __init__(self, r_bs, damper: SimpleDamper, psi_max, eta_br, *,
                 device, dtype, l_0=0.0):
        self.r_bs = torch.tensor(r_bs, dtype=dtype, device=device)
        self.q_bs = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype,
                                 device=device)
        self.E1 = torch.tensor([1.0, 0.0, 0.0], dtype=dtype, device=device)
        self.E3 = torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=device)
        self.l_0 = float(l_0)
        self.damper = damper
        self.psi_max = float(psi_max)
        self.eta_br = float(eta_br)
        self.frc = C.pi_params(k_p=5.0, k_i=400.0, k_l=0.2, bound_lo=-1.0,
                               bound_hi=1.0)

    def strut_y(self, steering, kin, trn) -> StrutY:
        """`landinggear.py:200-299`."""
        l_0 = self.l_0
        B = kin.h_e.shape[0]
        q_bs = self.q_bs.expand(B, 4)
        r_bs_b = self.r_bs.expand(B, 3)
        E3 = self.E3.expand(B, 3)
        q_eb, q_nb, q_en = kin.q_eb, kin.q_nb, kin.q_en
        v_eb_b, omega_eb_b = kin.v_eb_b, kin.omega_eb_b

        q_es = qmul(q_eb, q_bs)
        ks_e = qrot(q_es, E3)
        r_bs_e = qrot(q_eb, r_bs_b)
        n_up_e = kin.n_e
        d_e = r_bs_e + l_0 * ks_e
        h_e_w0 = kin.h_e + dot(d_e, n_up_e)
        h_e_trn = trn.elevation + (kin.h_e - kin.h_o)
        delta_h = h_e_w0 - h_e_trn
        wow = delta_h <= 0

        r_st_e = l_0 * ks_e - delta_h[..., None] * n_up_e

        ut_n = trn.normal.expand(B, 3)
        ut_e = qrot(q_en, ut_n)
        ut_ks = dot(ut_e, ks_e)
        ut_ks_safe = torch.where(
            torch.abs(ut_ks) < 1e-6,
            torch.where(ut_ks < 0, torch.full_like(ut_ks, -1e-6),
                        torch.full_like(ut_ks, 1e-6)), ut_ks)
        l = dot(ut_e, r_st_e) / ut_ks_safe
        alpha_ts = torch.acos(torch.clamp(ut_ks, -1.0, 1.0))

        xi = torch.clamp_max(l - l_0, 0.0)

        r_sc_s = E3 * (l_0 + xi)[..., None]
        r_sc_b = qrot(q_bs, r_sc_s)
        r_bc_b = r_sc_b + r_bs_b

        # (the reference's castoring azimuth psi_v feeds no output)
        v_ec_b_body = v_eb_b + cross(omega_eb_b, r_bc_b)
        psi_sw = torch.clamp(steering, -1.0, 1.0) * self.psi_max

        q_sw = att.rot_z(psi_sw)
        q_ns = qmul(q_nb, q_bs)
        q_nw = qmul(q_ns, q_sw)

        kc_n = ut_n
        iw_n = qrot(q_nw, self.E1.expand(B, 3))
        iw_n_trn = iw_n - dot(iw_n, kc_n)[..., None] * kc_n
        ic_n = iw_n_trn / _norm(iw_n_trn)[..., None]
        jc_n = cross(kc_n, ic_n)
        R_nc = torch.stack([ic_n, jc_n, kc_n], dim=-1)
        q_nc = att.matrix_to_quat(R_nc)
        q_sc = qmul(qconj(q_ns), q_nc)
        q_bc = qmul(q_bs, q_sc)

        v_ec_c_body = qrot_inv(q_bc, v_ec_b_body)
        ks_c = qrot_inv(q_sc, E3)
        ks_c3 = torch.where(torch.abs(ks_c[..., 2]) < 1e-6,
                            torch.full_like(ks_c[..., 2], 1e-6), ks_c[..., 2])
        xi_dot = -v_ec_c_body[..., 2] / ks_c3

        F_dmp_zs = damper_force(self.damper, xi, xi_dot)

        v_ec_c = v_ec_c_body + ks_c * xi_dot[..., None]
        v_ec_xy = v_ec_c[..., :2]

        z = torch.zeros_like(xi)
        q1 = torch.zeros_like(q_sc)
        q1[..., 0] = 1.0
        return StrutY(
            wow=wow, xi_dot=torch.where(wow, xi_dot, z),
            F_dmp_zs=torch.where(wow, F_dmp_zs, z),
            alpha_ts=torch.where(wow, alpha_ts, z),
            r_bc_b=bwhere(wow, r_bc_b, torch.zeros_like(r_bc_b)),
            q_sc=bwhere(wow, q_sc, q1), q_bc=bwhere(wow, q_bc, q1),
            v_ec_xy=bwhere(wow, v_ec_xy, torch.zeros_like(v_ec_xy)))

    def contact_wrench(self, braking, strut: StrutY, surface,
                       frc_out: C.PIOutput) -> Wrench:
        """Contact force model (`landinggear.py:303-357`), body-frame
        wrench masked to zero off the ground."""
        wow = strut.wow
        v_ec_xy = strut.v_ec_xy
        norm_v = _norm(v_ec_xy)

        m_roll = mu_roll(norm_v)
        m_skid = mu_skid(surface, norm_v)
        kappa_br = torch.clamp(braking, 0.0, 1.0) * self.eta_br
        mu_x = m_roll + (m_skid - m_roll) * kappa_br

        small_v = norm_v < 1e-3
        psi_cv = torch.where(
            small_v, torch.full_like(norm_v, np.pi / 2),
            torch.atan2(torch.where(small_v, torch.zeros_like(norm_v),
                                    v_ec_xy[..., 1]),
                        torch.where(small_v, torch.ones_like(norm_v),
                                    v_ec_xy[..., 0])))

        psi_skid = float(np.deg2rad(10.0))
        psi_abs = torch.abs(psi_cv)
        mu_y = torch.where(
            psi_abs < psi_skid, divc(m_skid * psi_abs, psi_skid),
            torch.where(psi_abs > np.pi - psi_skid,
                        m_skid * (1.0 - divc(psi_skid + psi_abs - np.pi,
                                             psi_skid)),
                        m_skid))

        mu_max = torch.stack([mu_x, mu_y], dim=-1)
        mu_max = mu_max * torch.clamp_max(m_skid / _norm(mu_max),
                                          1.0)[..., None]
        mu_eff = frc_out.output * mu_max

        f_c = torch.stack([mu_eff[..., 0], mu_eff[..., 1],
                           -torch.ones_like(mu_eff[..., 0])], dim=-1)
        f_s = qrot(strut.q_sc, f_c)
        f_s3 = torch.where(torch.abs(f_s[..., 2]) < 1e-6,
                           torch.full_like(f_s[..., 2], -1e-6), f_s[..., 2])
        N = torch.clamp_min(-strut.F_dmp_zs / f_s3, 0.0)
        F_c = f_c * N[..., None]

        wr_b = translate_wrench(FrameTransform(r=strut.r_bc_b, q=strut.q_bc),
                                Wrench(F=F_c, tau=torch.zeros_like(F_c)))
        return Wrench(F=bwhere(wow, wr_b.F, torch.zeros_like(wr_b.F)),
                      tau=bwhere(wow, wr_b.tau, torch.zeros_like(wr_b.tau)))

    def f_ode(self, x_frc, steering, braking, kin, trn):
        """(frc_dot [B, 2], contact wrench) (`landinggear.py:361-370`)."""
        strut = self.strut_y(steering, kin, trn)
        frc_dot, frc_out = C.pi_ode(self.frc, x_frc, -strut.v_ec_xy)
        return frc_dot, self.contact_wrench(braking, strut, trn.surface,
                                            frc_out)


class GearSet:
    """Legs named and parametrized as `flightjax` `GearSet`; evaluated one
    leg at a time (`GearSet.f_ode_leg` / `strut_y_leg`)."""

    def __init__(self, names, r_bs, dampers, psi_max, eta_br, *, device,
                 dtype):
        self.names = tuple(names)
        self.n = len(self.names)
        self.legs = [LandingGearUnit(r_bs[i], SimpleDamper(
            dampers[i].k_s, dampers[i].k_d_ext, dampers[i].k_d_cmp, 50000.0),
            psi_max[i], eta_br[i], device=device, dtype=dtype)
            for i in range(self.n)]

    def f_ode_leg(self, i, x_frc, steering, braking, kin, trn):
        return self.legs[i].f_ode(x_frc, steering, braking, kin, trn)

    def strut_y_leg(self, i, steering, kin, trn) -> StrutY:
        return self.legs[i].strut_y(steering, kin, trn)
