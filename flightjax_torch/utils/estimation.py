"""State estimation: the fused 15-state INS/GPS error-state EKF and its
fault monitors (port of the parts of `flightjax/utils/estimation.py` that
the navigation avionics fly: `masked_update`, the closed-form small solves,
`attitude_error_deg`, `ned_from_geodetic`, `InsGpsState`, `InsGps`, `nis`
and `innovation_monitor`; `Ahrs`, `Ins` and the `kf_*` / `ekf_*` helpers are
not ported, ROADMAP Queue 1, P11).

Fleet-shaped: the filter state's leaves lead with the batch's shape
(`P` is `[..., 15, 15]`), and every method works on a whole fleet at once.
The innovation systems are solved in closed form (an adjugate for 3 x 3,
a reciprocal for 1 x 1, block elimination over the channel partition), as
the reference solves them; float64 on the CPU agrees with it to rounding.
"""

from typing import NamedTuple

import torch

from flightjax_torch.core.modeling import bwhere, tree_map
from flightjax_torch.ops import geodesy as geo
from flightjax_torch.ops.attitude import quat_to_matrix, skew
from flightjax_torch.ops.quaternions import qconj, qmul, qrot_inv


def qnormalize(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def rvec_to_quat(rv):
    """The unit quaternion of a rotation vector (`attitude.py:110-116`):
    [cos(mu/2), axis sin(mu/2)], the identity at mu = 0."""
    mu = torch.linalg.vector_norm(rv, dim=-1)
    pos = mu > 0
    axis = rv / torch.where(pos, mu, torch.ones_like(mu))[..., None]
    half = 0.5 * mu
    q = torch.cat([torch.cos(half)[..., None],
                   axis * torch.sin(half)[..., None]], dim=-1)
    ident = torch.zeros_like(q)
    ident[..., 0] = 1.0
    return torch.where(pos[..., None], q, ident)


def _mT(A):
    return A.transpose(-1, -2)


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device).expand(
        like.shape[:-2] + (n, n))


def masked_update(valid, updated, prior):
    """The updated filter state where `valid` (per lane), the prior
    elsewhere, leaf by leaf (`estimation.py:96-103`)."""
    return tree_map(lambda a, b: bwhere(valid, a, b), updated, prior)


def _inv3(S):
    """The inverse of 3 x 3 matrices `[..., 3, 3]` by the adjugate
    (`estimation.py:106-129`)."""
    a00, a01, a02 = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
    a10, a11, a12 = S[..., 1, 0], S[..., 1, 1], S[..., 1, 2]
    a20, a21, a22 = S[..., 2, 0], S[..., 2, 1], S[..., 2, 2]
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
    adjT = torch.stack([torch.stack([c00, c10, c20], dim=-1),
                        torch.stack([c01, c11, c21], dim=-1),
                        torch.stack([c02, c12, c22], dim=-1)], dim=-2)
    return adjT / det[..., None, None]


def _gain(P, H, S):
    """K = P Hᵀ S⁻¹ (`estimation.py:132-143`): a quotient for one row, the
    adjugate for three and the unrolled Cholesky otherwise (the last,
    ADVICE.md's m > 3 finding, is the reference's: no update of the
    navigation avionics reaches it, their stacked update solves by blocks)."""
    PHt = P @ _mT(H)
    m = S.shape[-1]
    if m == 1:
        return PHt / S[..., 0:1, 0:1]
    if m == 3:
        return PHt @ _inv3(S)
    return _mT(chol_solve(S, _mT(PHt)))


def blocked_spd_solve(S, B, sizes):
    """Solve S X = B for SPD `S` `[..., m, m]` by block Gaussian
    elimination over the static partition `sizes`, each pivot inverted in
    closed form (`estimation.py:146-186`)."""
    assert sum(sizes) == S.shape[-1], (sizes, S.shape)
    ofs = [0]
    for n in sizes:
        ofs.append(ofs[-1] + n)
    k = len(sizes)
    Sb = [[S[..., ofs[i]:ofs[i + 1], ofs[j]:ofs[j + 1]] for j in range(k)]
          for i in range(k)]
    Bb = [B[..., ofs[i]:ofs[i + 1], :] for i in range(k)]

    def inv_blk(M, n):
        if n == 1:
            return 1.0 / M
        if n == 3:
            return _inv3(M)
        return torch.linalg.inv(M)  # no shipped partition reaches it

    invs = [None] * k
    for i in range(k):
        invs[i] = inv_blk(Sb[i][i], sizes[i])
        for j in range(i + 1, k):
            Lji = Sb[j][i] @ invs[i]
            for l in range(i + 1, k):
                Sb[j][l] = Sb[j][l] - Lji @ Sb[i][l]
            Bb[j] = Bb[j] - Lji @ Bb[i]
    X = [None] * k
    for i in reversed(range(k)):
        acc = Bb[i]
        for j in range(i + 1, k):
            acc = acc - Sb[i][j] @ X[j]
        X[i] = invs[i] @ acc
    return torch.cat(X, dim=-2)


def chol_solve(S, B):
    """Solve S X = B for a small SPD `S` `[..., m, m]` by an unrolled
    Cholesky factorisation and two triangular solves
    (`estimation.py:189-222`); B is `[..., m, n]` (or `[..., m]`)."""
    m = S.shape[-1]
    L = [[None] * m for _ in range(m)]
    for i in range(m):
        for j in range(i + 1):
            acc = S[..., i, j]
            for k in range(j):
                acc = acc - L[i][k] * L[j][k]
            L[i][j] = torch.sqrt(acc) if i == j else acc / L[j][j]
    vec = B.dim() == S.dim() - 1
    rows = [B[..., i] if vec else B[..., i, :] for i in range(m)]
    col = (lambda v: v) if vec else (lambda v: v[..., None])
    Z = [None] * m
    for i in range(m):
        acc = rows[i]
        for k in range(i):
            acc = acc - col(L[i][k]) * Z[k]
        Z[i] = acc / col(L[i][i])
    X = [None] * m
    for i in reversed(range(m)):
        acc = Z[i]
        for k in range(i + 1, m):
            acc = acc - col(L[k][i]) * X[k]
        X[i] = acc / col(L[i][i])
    return torch.stack(X, dim=-1 if vec else -2)


def attitude_error_deg(q_est, q_true):
    """The total rotation angle [deg] between two unit quaternions."""
    dq = qmul(qconj(q_true), q_est)
    re = torch.clamp(torch.abs(dq[..., 0]), 0.0, 1.0)
    return torch.rad2deg(2.0 * torch.arccos(re))


def ned_from_geodetic(lat, lon, h, lat0, lon0, h0):
    """The local NED position [m] of (lat, lon, h) from the origin (lat0,
    lon0, h0), linearised through the origin's radii (`estimation.py:
    407-419`)."""
    n0 = geo.nvector_from_latlon(lat0, lon0)
    M, N = geo.radii(n0)
    dN = (lat - lat0) * (M + h0)
    dE = (lon - lon0) * (N + h0) * torch.cos(lat0)
    dD = h0 - h
    return torch.stack([dN, dE, dD], dim=-1)


# ---------------------------------------------------- fused 15-state INS/GPS

class InsGpsState(NamedTuple):
    q_nb: torch.Tensor   # [..., 4] nominal attitude, body wrt NED
    v_n: torch.Tensor    # [..., 3] NED velocity
    p_n: torch.Tensor    # [..., 3] NED position wrt the filter origin [m]
    b_g: torch.Tensor    # [..., 3] gyro bias [rad/s]
    b_a: torch.Tensor    # [..., 3] accel bias [m/s^2]
    P: torch.Tensor      # [..., 15, 15] covariance [dθ, dv, dp, dbg, dba]


def _blocks(rows, like):
    """A `[..., 15, 15]` matrix from 5 x 5 blocks of `[..., 3, 3]` tensors
    (None a zero block)."""
    z = torch.zeros(like.shape[:-2] + (3, 3), dtype=like.dtype,
                    device=like.device)
    return torch.cat([torch.cat([z if b is None else b.expand_as(z)
                                 for b in r], dim=-1) for r in rows], dim=-2)


def _diag(v):
    return torch.diag_embed(v)


class InsGps:
    """The loosely-coupled 15-state error-state EKF (`estimation.py:
    562-988`): attitude, velocity, position and both bias sets in one
    filter; Joseph-form updates, P symmetrised after each step; the
    deferred covariance propagation of the navigation avionics
    (`predict_mean`, `accum_A`, `propagate_P`) and their stacked masked
    update (`stacked_rows`, `stacked_innovation`, `update_stacked`)."""

    def __init__(self, dt, sigma_gyro=8.7e-4, rw_gyro=3.0e-5,
                 sigma_accel=0.02, rw_accel=1.0e-3, sigma_mag=150.0e-9,
                 B_n=(19.0e-6, 0.0, 45.0e-6), sigma_gps_pos=1.6,
                 sigma_gps_vel=0.06, sigma_baro=1.5, g=9.80665,
                 sigma_geo_f32=20.0, sigma_radar=0.5, sigma_mag_dir=0.015):
        self.dt = float(dt)
        dt_ = self.dt
        f64 = lambda v: torch.as_tensor(v, dtype=torch.float64)
        self.g_n = f64([0.0, 0.0, g])
        self.B_n = f64(B_n)
        self.Q_diag = torch.cat([
            torch.full((3,), (sigma_gyro * dt_) ** 2, dtype=torch.float64),
            torch.full((3,), (sigma_accel * dt_) ** 2, dtype=torch.float64),
            torch.full((3,), 1e-8, dtype=torch.float64),
            torch.full((3,), (rw_gyro ** 2) * dt_, dtype=torch.float64),
            torch.full((3,), (rw_accel ** 2) * dt_, dtype=torch.float64)])
        self.r_pos = sigma_gps_pos ** 2
        self.r_vel = sigma_gps_vel ** 2
        self.r_baro = sigma_baro ** 2
        B_mag = float(torch.linalg.vector_norm(self.B_n))
        self.r_mag_dir = max(sigma_mag / B_mag, float(sigma_mag_dir)) ** 2
        self.sigma_geo_f32 = float(sigma_geo_f32)
        self.sigma_radar = float(sigma_radar)

    def _Q(self, like, k=1.0):
        return _diag((float(k) * self.Q_diag).to(like.dtype).to(
            like.device).expand(like.shape[:-2] + (15,)))

    def r_pos_eff(self, dtype):
        """The GPS position variance for the compute dtype: the catalog's,
        plus the float32 truth's geodetic wander (sigma_geo_f32 squared)
        in float32 (`estimation.py:637-664`)."""
        r = self.r_pos
        if dtype == torch.float32:
            r = r + self.sigma_geo_f32 ** 2
        return r

    def init(self, q_nb, v_n, p_n, att_std=0.05, vel_std=0.2, pos_std=3.0,
             bg_std=5e-3, ba_std=0.05):
        """The filter at (q_nb, v_n, p_n) with zero biases and a diagonal
        P0 of the given stds (`estimation.py:666-677`); the stds are
        numbers or per-lane tensors."""
        like = v_n
        shape = like.shape[:-1]
        var = lambda s: torch.as_tensor(s, dtype=like.dtype,
                                        device=like.device).expand(
            shape)[..., None].expand(shape + (3,)) ** 2
        P0 = _diag(torch.cat([var(att_std), var(vel_std), var(pos_std),
                              var(bg_std), var(ba_std)], dim=-1))
        z = torch.zeros_like(like)
        return InsGpsState(q_nb=q_nb, v_n=v_n, p_n=p_n, b_g=z, b_a=z, P=P0)

    def identity(self, shape, device, dtype):
        """The JAX package's `init()` with no arguments: the identity
        attitude at rest at the origin, over a batch of `shape`."""
        z = torch.zeros(tuple(shape) + (3,), dtype=dtype, device=device)
        q = torch.zeros(tuple(shape) + (4,), dtype=dtype, device=device)
        q[..., 0] = 1.0
        return self.init(q, z, z.clone())

    # ------------------------------------------------------------- predict

    def _mechanize(self, st, omega_m, f_m):
        dt = self.dt
        w = omega_m - st.b_g
        f = f_m - st.b_a
        q = qnormalize(qmul(st.q_nb, rvec_to_quat(w * dt)))
        C = quat_to_matrix(st.q_nb)
        a_n = (C @ f[..., None])[..., 0] + self.g_n.to(f)
        v = st.v_n + a_n * dt
        p = st.p_n + st.v_n * dt + 0.5 * a_n * dt ** 2
        return w, f, q, C, v, p

    def predict(self, st: InsGpsState, omega_m, f_m) -> InsGpsState:
        """Strapdown mechanisation and the covariance through the first-
        order transition (`estimation.py:681-721`)."""
        dt = self.dt
        w, f, q, C, v, p = self._mechanize(st, omega_m, f_m)
        I3 = _eye(3, C)
        Cf = C @ skew(f)
        Phi = _blocks([
            [I3 - skew(w) * dt, None, None, -I3 * dt, None],
            [-Cf * dt, I3, None, None, -C * dt],
            [-0.5 * Cf * dt ** 2, I3 * dt, I3, None, -0.5 * C * dt ** 2],
            [None, None, None, I3, None],
            [None, None, None, None, I3]], C)
        P = Phi @ st.P @ _mT(Phi) + self._Q(st.P)
        P = 0.5 * (P + _mT(P))
        return InsGpsState(q_nb=q, v_n=v, p_n=p, b_g=st.b_g, b_a=st.b_a,
                           P=P)

    def predict_mean(self, st: InsGpsState, omega_m, f_m):
        """The mean-only mechanisation of the deferred covariance scheme
        (`estimation.py:725-773`): (st', (skew(w) dt, C[f x] dt, C dt))."""
        dt = self.dt
        w, f, q, C, v, p = self._mechanize(st, omega_m, f_m)
        Cf = C @ skew(f)
        return (InsGpsState(q_nb=q, v_n=v, p_n=p, b_g=st.b_g, b_a=st.b_a,
                            P=st.P), (skew(w) * dt, Cf * dt, C * dt))

    @staticmethod
    def zero_A(like):
        """The zero accumulator of the three varying 3 x 3 block-sums, over
        the batch of `like` (a `[..., 3]` tensor)."""
        z = torch.zeros(like.shape[:-1] + (3, 3), dtype=like.dtype,
                        device=like.device)
        return {"w": z, "cf": z, "c": z}

    @staticmethod
    def accum_A(A, parts):
        sw, scf, sc = parts
        return {"w": A["w"] + sw, "cf": A["cf"] + scf, "c": A["c"] + sc}

    def propagate_P(self, st: InsGpsState, A, k):
        """The covariance compounded over `k` firings: Phi = I + A + A²/2
        of the accumulated A, Q scaled by k (`estimation.py:793-818`). Its
        second-order truncation is the reference's (ADVICE.md; the
        deferred scheme's error is bounded by the reference's own test)."""
        dt = self.dt
        P0 = st.P
        Ik = _eye(3, A["w"]) * (float(k) * dt)
        Sw, Scf, Sc = A["w"], A["cf"], A["c"]
        Am = _blocks([
            [-Sw, None, None, -Ik, None],
            [-Scf, None, None, None, -Sc],
            [-0.5 * dt * Scf, Ik, None, None, -0.5 * dt * Sc],
            [None, None, None, None, None],
            [None, None, None, None, None]], Sw)
        Phi = _eye(15, P0) + Am + 0.5 * (Am @ Am)
        P = Phi @ P0 @ _mT(Phi) + self._Q(P0, k)
        P = 0.5 * (P + _mT(P))
        return st._replace(P=P)

    # -------------------------------------------------------------- updates

    def _inject(self, st, dx, P):
        q = qnormalize(qmul(st.q_nb, rvec_to_quat(dx[..., 0:3])))
        return InsGpsState(q_nb=q, v_n=st.v_n + dx[..., 3:6],
                           p_n=st.p_n + dx[..., 6:9],
                           b_g=st.b_g + dx[..., 9:12],
                           b_a=st.b_a + dx[..., 12:15], P=P)

    def update(self, st: InsGpsState, H, y, R):
        """One Joseph-form update (`estimation.py:822-837`): H `[..., m,
        15]`, y `[..., m]`, R `[..., m, m]`."""
        R = R.to(st.P)
        S = H @ st.P @ _mT(H) + R
        K = _gain(st.P, H, S)
        dx = (K @ y[..., None])[..., 0]
        IKH = _eye(15, st.P) - K @ H
        P = IKH @ st.P @ _mT(IKH) + K @ R @ _mT(K)
        P = 0.5 * (P + _mT(P))
        return self._inject(st, dx, P)

    def _rows(self, idx, like):
        H = torch.zeros(like.shape[:-2] + (3, 15), dtype=like.dtype,
                        device=like.device)
        H[..., :, idx:idx + 3] = torch.eye(3, dtype=like.dtype)
        return H

    def update_gps(self, st: InsGpsState, p_meas, v_meas, valid):
        P = st.P
        Rp = _diag(torch.full(P.shape[:-2] + (3,), self.r_pos_eff(P.dtype),
                              dtype=P.dtype, device=P.device))
        Rv = _diag(torch.full(P.shape[:-2] + (3,), self.r_vel,
                              dtype=P.dtype, device=P.device))
        upd = self.update(st, self._rows(6, P), p_meas - st.p_n, Rp)
        upd = self.update(upd, self._rows(3, P), v_meas - upd.v_n, Rv)
        return masked_update(valid, upd, st)

    # --------------------------------------------- the stacked update

    def stacked_rows(self, st: InsGpsState, p_meas, v_meas, h_baro_e,
                     h_origin, mag_m, B_n, h_radar_e=None):
        """(H `[..., m, 15]`, y `[..., m]`, r `[..., m]`) of one aiding
        epoch (`estimation.py:877-929`): rows 0:3 GPS position, 3:6 GPS
        velocity, 6 baro altitude, 7:10 the mag field's direction, and 10
        the radar altitude where `h_radar_e` is given. `B_n` the NED field
        `[..., 3]`."""
        P = st.P
        sh = P.shape[:-2]
        kw = dict(dtype=P.dtype, device=P.device)
        full = lambda n, v: torch.full(sh + (n,), v, **kw)
        H_pos = self._rows(6, P)
        H_vel = self._rows(3, P)
        H_alt = torch.zeros(sh + (1, 15), **kw)
        H_alt[..., 0, 8] = -1.0
        m = mag_m / (torch.linalg.vector_norm(mag_m, dim=-1, keepdim=True)
                     + 1e-30)
        b_dir = B_n / torch.linalg.vector_norm(B_n, dim=-1, keepdim=True)
        v_pred = qrot_inv(st.q_nb, b_dir.to(P.dtype))
        H_mag = torch.cat([skew(v_pred), torch.zeros(sh + (3, 12), **kw)],
                          dim=-1)
        Hs = [H_pos, H_vel, H_alt, H_mag]
        ys = [p_meas - st.p_n, v_meas - st.v_n,
              (h_baro_e - h_origin + st.p_n[..., 2])[..., None], m - v_pred]
        rs = [full(3, self.r_pos_eff(P.dtype)), full(3, self.r_vel),
              full(1, self.r_baro), full(3, self.r_mag_dir)]
        if h_radar_e is not None:
            Hs.append(H_alt.clone())
            ys.append((h_radar_e - h_origin + st.p_n[..., 2])[..., None])
            rs.append(full(1, self.sigma_radar ** 2))
        return (torch.cat(Hs, dim=-2), torch.cat(ys, dim=-1),
                torch.cat(rs, dim=-1))

    @staticmethod
    def stacked_innovation(st: InsGpsState, H, r):
        """(P Hᵀ, S = H P Hᵀ + diag(r)) of a stacked system, shared by the
        monitors and the update (`estimation.py:931-940`)."""
        PHt = st.P @ _mT(H)
        return PHt, H @ PHt + _diag(r)

    def update_stacked(self, st: InsGpsState, H, y, r, mask, PHt=None,
                       S=None, sizes=None):
        """One simultaneous Joseph update over the stacked system with
        per-row validity `mask` `[..., m]` (`estimation.py:942-1005`):
        masked rows zeroed in H, y, P Hᵀ and S (their diagonal reset to 1),
        which is exactly the update over the active rows alone."""
        P = st.P
        m = H.shape[-2]
        mf = mask.to(P.dtype)
        Hm = H * mf[..., :, None]
        ym = y * mf
        rm = torch.where(mask, r, torch.ones_like(mf))
        if S is None:
            PHt = P @ _mT(Hm)
            Sm = Hm @ PHt + _diag(rm)
            PHtm = PHt
        else:
            PHtm = PHt * mf[..., None, :]
            Sm = S * (mf[..., :, None] * mf[..., None, :])
            d = torch.diagonal(S, dim1=-2, dim2=-1)
            dm = torch.where(mask, d, torch.ones_like(d))
            Sm = Sm - _diag(torch.diagonal(Sm, dim1=-2, dim2=-1)) + _diag(dm)
        if sizes is None:
            sizes = ((3, 3, 1, 3) if m == 10 else
                     (3, 3, 1, 3, 1) if m == 11 else (1,) * m)
        K = _mT(blocked_spd_solve(Sm, _mT(PHtm), sizes))
        dx = (K @ ym[..., None])[..., 0]
        IKH = _eye(15, P) - K @ Hm
        P2 = IKH @ P @ _mT(IKH) + (K * rm[..., None, :]) @ _mT(K)
        P2 = 0.5 * (P2 + _mT(P2))
        return self._inject(st, dx, P2)


# ---------------------------------------------------------- fault detection

def nis(y, S):
    """The normalised innovation squared yᵀ S⁻¹ y (`estimation.py:
    990-1002`): a quotient for one row, the adjugate for three, the
    Cholesky otherwise."""
    m = S.shape[-1]
    if m == 1:
        return (y[..., 0] * y[..., 0]) / S[..., 0, 0]
    if m == 3:
        return (y[..., None, :] @ (_inv3(S) @ y[..., None]))[..., 0, 0]
    return (y[..., None, :] @ chol_solve(S, y)[..., None])[..., 0, 0]


def innovation_monitor(threshold, window=10, min_hits=5):
    """(init, update) of a persistent fault monitor (`estimation.py:
    1005-1033`): `update(state, nis, valid)` shifts one epoch's hit into a
    bit register and latches the alarm when at least `min_hits` of the last
    `window` valid epochs exceeded `threshold`. The register holds at most
    32 epochs, as the reference's uint32 does (ADVICE.md): it rides in an
    int64 here, masked to `window` bits. `init(like)` makes the state over
    the batch of the tensor `like`."""
    assert window <= 32, "bitmask register holds at most 32 epochs"
    mask = (1 << window) - 1

    def init(like):
        return {"bits": torch.zeros(like.shape, dtype=torch.int64,
                                    device=like.device),
                "alarm": torch.zeros(like.shape, dtype=torch.bool,
                                     device=like.device)}

    def update(st, nis_value, valid):
        hit = (valid & (nis_value > threshold)).to(torch.int64)
        bits = torch.where(valid, ((st["bits"] << 1) | hit) & mask,
                           st["bits"])
        count = torch.zeros_like(bits)
        for b in range(window):
            count = count + ((bits >> b) & 1)
        alarm = st["alarm"] | (count >= min_hits)
        return {"bits": bits, "alarm": alarm}, alarm

    return init, update
