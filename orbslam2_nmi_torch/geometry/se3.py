"""SO(3), SE(3) and Sim(3) operations in torch float32.

Port of `orbslam2_nmi_tpu/geometry/se3.py`. Rotations are 3x3 matrices or
quaternions [w, x, y, z] (Hamilton); poses Tcw are 4x4 world->camera
transforms; SE(3) tangents are [rho, phi] = [translation, rotation], as in
g2o; Sim(3) tangents add sigma, the log-scale.

Pose math stays in full float32: no TF32, no bf16. No small matrix product
here goes through `torch.matmul`, whose float32 path follows the process's
TF32 flags on CUDA; the JAX package pins `Precision.HIGHEST` on the same
products. There are two forms:
  * `mm`, `mv`: products rounded, then summed, in float32: a few launches a
    product, for every product held to a tolerance (the tracking step's pose
    math, the bundle adjustment's Jacobians and blocks);
  * `mm_fma`, `mv_fma`: each dot product accumulated in order as a chain of
    fused multiply-adds, the order the JAX package's compiled HIGHEST
    products use on the CPU, so the splat's coordinates, the homographies,
    the projection matrices and the poses of `so3_exp`, `se3_inverse`,
    `se3_apply`, `se3_compose`, `sim3_inverse` and `sim3_apply` are the JAX
    package's bit for bit (their tests hold them so; the renders' test holds
    the splat pixel for pixel).
    Each fused step is a float64 product and sum (exact: a product of two
    float32 fits in float64) rounded once to float32, about four launches a
    term: only for the products whose bits are tested.
Either way a caller who turns TF32 on gets the same poses, homographies and
splat coordinates. `se3_log` and `sim3_log` solve with `solve_ex`, which
does not wait on the device for an error check.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched matrix product [..., m, k] x [..., k, n] in plain float32,
    as an elementwise product summed over k (for small matrices only)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def mv(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product [..., m, k] x [..., k] in plain float32."""
    return (a * v[..., None, :]).sum(-1)


def _fma_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_k a[..., k] b[..., k] (broadcast) accumulated k = 0, 1, ... as
    float32 fused multiply-adds: acc = f32(a_k b_k + acc), the product and
    sum taken exactly in float64 and rounded once."""
    a, b = a.double(), b.double()
    acc = (a[..., 0] * b[..., 0]).float()
    for k in range(1, a.shape[-1]):
        acc = (a[..., k] * b[..., k] + acc.double()).float()
    return acc


def mm_fma(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched matrix product [..., m, k] x [..., k, n] in float32 with
    fused multiply-add accumulation (see the module docstring)."""
    return _fma_dot(a[..., :, None, :], b.transpose(-1, -2)[..., None, :, :])


def mv_fma(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product [..., m, k] x [..., k] in float32 with
    fused multiply-add accumulation."""
    return _fma_dot(a, v[..., None, :])


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of a 3-vector (batched over leading dims)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, -wz, wy], dim=-1),
            torch.stack([wz, zero, -wx], dim=-1),
            torch.stack([-wy, wx, zero], dim=-1),
        ],
        dim=-2,
    )


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: axis-angle 3-vector -> 3x3 rotation. Safe at ||w|| -> 0."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS)
    a = torch.where(theta2 > _EPS, torch.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = torch.where(theta2 > _EPS, (1.0 - torch.cos(theta)) / theta2, 0.5 - theta2 / 24.0)
    W = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * mm_fma(W, W)


def euler_zyx(angles: torch.Tensor) -> torch.Tensor:
    """[..., 3] Euler angles (ax, ay, az) -> [..., 3, 3] R = Rz(az) Ry(ay) Rx(ax):
    the rotation of the NMI search's warp homographies and of its pose snap
    (CalculateNMIRelocalization, Tracking.cc:2374-2419)."""
    eye = torch.eye(3, dtype=angles.dtype, device=angles.device)
    Rx = so3_exp(eye[0] * angles[..., 0:1])
    Ry = so3_exp(eye[1] * angles[..., 1:2])
    Rz = so3_exp(eye[2] * angles[..., 2:3])
    return mm_fma(mm_fma(Rz, Ry), Rx)


def make_se3(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble 4x4 from 3x3 R and 3-vector t. Batched."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    # [0, 0, 0, 1] made on the device: a copy from the host would wait on it
    bottom = torch.eye(4, dtype=R.dtype, device=R.device)[3:]
    return torch.cat([top, bottom.expand(batch + (1, 4))], dim=-2)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return make_se3(Rt, -mv_fma(Rt, t))


def se3_apply(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 transform to 3-points ([..., 3])."""
    return mv_fma(T[..., :3, :3], p) + T[..., :3, 3]


def se3_compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return mm_fma(A, B)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """3x3 rotation -> axis-angle 3-vector. Safe near identity and pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    # vee of the antisymmetric part; |v| = 2 sin(theta)
    v = torch.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]],
        dim=-1,
    )
    sin_theta = 0.5 * torch.sqrt(torch.sum(v * v, dim=-1) + 1e-24)
    # the atan2 form is well-conditioned over the whole range except theta ~ pi
    theta = torch.atan2(sin_theta, cos_theta)
    small = sin_theta < 1e-5
    near_pi = small & (cos_theta < 0.0)
    scale = torch.where(small, 0.5 + theta * theta / 12.0,
                        0.5 * theta / torch.where(small, torch.ones_like(sin_theta), sin_theta))
    w_generic = v * scale[..., None]
    # near pi: the axis from the diagonal, its signs from the off-diagonals
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis_sq = torch.clamp(
        (diag - cos_theta[..., None]) / torch.clamp(1.0 - cos_theta[..., None], min=_EPS), min=0.0)
    axis = torch.sqrt(axis_sq + 1e-24)
    axis = axis * torch.where(v >= 0, 1.0, -1.0)
    axis = axis / torch.clamp(torch.linalg.vector_norm(axis, dim=-1, keepdim=True), min=_EPS)
    return torch.where(near_pi[..., None], axis * theta[..., None], w_generic)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=_EPS)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion [w, x, y, z], branchless (Shepperd's
    method), with the canonical sign w >= 0."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def root(x):
        return torch.sqrt(torch.clamp(x, min=_EPS)) * 2

    s = root(tr + 1.0)
    c0 = torch.stack([0.25 * s, (m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s], dim=-1)
    s = root(1.0 + m00 - m11 - m22)
    c1 = torch.stack([(m21 - m12) / s, 0.25 * s, (m01 + m10) / s, (m02 + m20) / s], dim=-1)
    s = root(1.0 + m11 - m00 - m22)
    c2 = torch.stack([(m02 - m20) / s, (m01 + m10) / s, 0.25 * s, (m12 + m21) / s], dim=-1)
    s = root(1.0 + m22 - m00 - m11)
    c3 = torch.stack([(m10 - m01) / s, (m02 + m20) / s, (m12 + m21) / s, 0.25 * s], dim=-1)
    use0 = tr > 0
    use1 = ~use0 & (m00 >= m11) & (m00 >= m22)
    use2 = ~use0 & ~use1 & (m11 >= m22)
    q = torch.where(use0[..., None], c0,
                    torch.where(use1[..., None], c1, torch.where(use2[..., None], c2, c3)))
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=_EPS)
    return q * torch.where(q[..., 0:1] < 0, -1.0, 1.0)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def _exp_coefficients(theta2: torch.Tensor):
    """(sin t / t, (1 - cos t) / t^2, (1 - sin t / t) / t^2), Taylor-safe."""
    theta = torch.sqrt(theta2 + _EPS)
    big = theta2 > _EPS
    a = torch.where(big, torch.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = torch.where(big, (1.0 - torch.cos(theta)) / theta2, 0.5 - theta2 / 24.0)
    return theta, big, a, b


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) tangent [rho, phi] -> 4x4 (g2o SE3Quat::exp ordering: trans first)."""
    rho, phi = xi[..., :3], xi[..., 3:6]
    theta2 = torch.sum(phi * phi, dim=-1)
    _, big, a, b = _exp_coefficients(theta2)
    c = torch.where(big, (1.0 - a) / theta2, 1.0 / 6.0 - theta2 / 120.0)
    W = hat(phi)
    W2 = mm(W, W)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(W.shape)
    R = eye + a[..., None, None] * W + b[..., None, None] * W2
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    return make_se3(R, mv(V, rho))


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """4x4 -> [rho, phi]."""
    phi = so3_log(T[..., :3, :3])
    theta2 = torch.sum(phi * phi, dim=-1)
    theta, big, _, b = _exp_coefficients(theta2)
    c = torch.where(big, (1.0 - torch.sin(theta) / theta) / theta2, 1.0 / 6.0)
    W = hat(phi)
    W2 = mm(W, W)
    eye = torch.eye(3, dtype=T.dtype, device=T.device).expand(W.shape)
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    rho = torch.linalg.solve_ex(V, T[..., :3, 3:4])[0][..., 0]
    return torch.cat([rho, phi], dim=-1)


# ---------------------------------------------------------------------------
# Sim(3), for loop closing (g2o sim3.h, Sim3Solver.cc). A similarity is a 4x4
# [sR t; 0 1]; its tangent is [rho(3), phi(3), sigma(1)], s = exp(sigma).
# ---------------------------------------------------------------------------


def make_sim3(R: torch.Tensor, t: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Assemble 4x4 [sR t; 0 1]."""
    return make_se3(R * s[..., None, None], t)


def sim3_inverse(S: torch.Tensor) -> torch.Tensor:
    sR = S[..., :3, :3]
    t = S[..., :3, 3]
    s2 = torch.sum(sR[..., 0, :] * sR[..., 0, :], dim=-1)  # |s * row|^2 = s^2
    inv_s2 = 1.0 / torch.clamp(s2, min=_EPS)
    sRinv = sR.transpose(-1, -2) * inv_s2[..., None, None]  # (1/s) R^T
    return make_se3(sRinv, -mv_fma(sRinv, t))


def sim3_apply(S: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return mv_fma(S[..., :3, :3], p) + S[..., :3, 3]


def sim3_scale(S: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(S[..., :3, 0], dim=-1)


def _sim3_w_matrix(phi: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """The sim(3) 'W' matrix with t = W rho (Strasdat's closed form, the math
    behind g2o sim3.h): W = C I + A hat(phi) + B hat(phi)^2, with the
    coefficients' limits at small sigma and small theta."""
    s = torch.exp(sigma)
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta2 + _EPS)
    W = hat(phi)
    W2 = mm(W, W)

    small_sig = torch.abs(sigma) < 1e-5
    small_th = theta < 1e-5
    one = torch.ones_like(sigma)
    sig_safe = torch.where(small_sig, one, sigma)
    th_safe = torch.where(small_th, one, theta)
    t2_safe = torch.clamp(theta2, min=_EPS)

    C = torch.where(small_sig, 1.0 + sigma / 2.0, (s - 1.0) / sig_safe)
    a_ss = torch.full_like(C, 0.5)  # sigma ~ 0, theta ~ 0
    b_ss = torch.full_like(C, 1.0 / 6.0)
    a_sl = (1.0 - torch.cos(th_safe)) / t2_safe  # sigma ~ 0
    b_sl = (th_safe - torch.sin(th_safe)) / torch.clamp(theta2 * th_safe, min=_EPS)
    a_ls = ((sig_safe - 1.0) * s + 1.0) / torch.clamp(sig_safe ** 2, min=_EPS)  # theta ~ 0
    b_ls = ((0.5 * sig_safe ** 2 - sig_safe + 1.0) * s - 1.0) / torch.clamp(sig_safe ** 3,
                                                                             min=_EPS)
    aa = s * torch.sin(th_safe)
    bb = s * torch.cos(th_safe)
    cc = theta2 + sigma * sigma
    a_ll = (aa * sig_safe + (1.0 - bb) * th_safe) / torch.clamp(th_safe * cc, min=_EPS)
    b_ll = (C - ((bb - 1.0) * sig_safe + aa * th_safe) / torch.clamp(cc, min=_EPS)) / t2_safe
    A = torch.where(small_th, torch.where(small_sig, a_ss, a_ls),
                    torch.where(small_sig, a_sl, a_ll))
    B = torch.where(small_th, torch.where(small_sig, b_ss, b_ls),
                    torch.where(small_sig, b_sl, b_ll))
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(W.shape)
    return C[..., None, None] * eye + A[..., None, None] * W + B[..., None, None] * W2


def sim3_exp(xi: torch.Tensor) -> torch.Tensor:
    """sim(3) tangent [rho(3), phi(3), sigma(1)] -> 4x4 [sR t; 0 1]."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    R = so3_exp(phi)
    t = mv(_sim3_w_matrix(phi, sigma), rho)
    return make_sim3(R, t, torch.exp(sigma))


def sim3_log(S: torch.Tensor) -> torch.Tensor:
    """4x4 Sim(3) -> [rho, phi, sigma], the inverse of sim3_exp. The solve is
    `solve_ex`, which does not wait on the device for an error check."""
    s = sim3_scale(S)
    R = S[..., :3, :3] / s[..., None, None]
    t = S[..., :3, 3]
    phi = so3_log(R)
    sigma = torch.log(torch.clamp(s, min=_EPS))
    rho = torch.linalg.solve_ex(_sim3_w_matrix(phi, sigma), t[..., None])[0][..., 0]
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)
