"""The lane-change game's KKT residual, written from the game's definition
(the upstream's examples/lane_change.jl:15-55, horizon T, two players),
independent of the program.

Each player i has states X_i[t] = (px, py, vx, vy) and controls
U_i[t] = (ax, ay), t = 0..T−1, and parameters θ_i = (x0_i, lane_i). Its cost
is the mean over t of (px − lane_i)² + ½(vx² + (vy − 2)²) + 0.1‖u‖². Both
share the equality constraints X[0] = x0 and
X[t] = A X[t−1] + B U[t−1] (planar double integrator, dt = 0.1, unit mass)
and the inequalities, each ≥ 0, stacked as:
  * per t: ‖p_0[t] − p_1[t]‖² − 4 (stay 2 m apart);
  * per t, per player: the road polygon's edges (py, W − px, L − py, px);
  * per t: the control box (u + 5 for the four controls, then 3 − u);
  * per t: the velocity box (vx + 10, vy for each player, then 10 − vx,
    10 − vy).

The MCP's variables are x = [τ_0; τ_1; λ] with τ_i = [X_i flat; U_i flat]
and λ the equality multipliers, and y = μ the inequality multipliers. Its
residual is G = [∇_{τ_i}(J_i − λ·g − μ·h) for each i; g] and H = h. All
derivatives are written out by hand."""

from __future__ import annotations

import torch

SD, CD = 4, 2  # state and control size of one player


def _dynamics(cfg):
    dt = cfg["dt"]
    A = torch.tensor([[1.0, 0.0, dt, 0.0], [0.0, 1.0, 0.0, dt],
                      [0.0, 0.0, 1.0, 0.0], [0.0, 0.0, 0.0, 1.0]], dtype=torch.float64)
    h = 0.5 * dt * dt
    B = torch.tensor([[h, 0.0], [0.0, h], [dt, 0.0], [0.0, dt]], dtype=torch.float64)
    return A, B


def gh(cfg: dict, theta: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """(G (batch, n), H (batch, m)) in the dtype of the inputs."""
    T, N = cfg["horizon"], cfg["players"]
    road_w = cfg["num_lanes"] * cfg["lane_width"]
    road_l = cfg["height"]
    Bn, dev, dt = x.shape[0], x.device, x.dtype
    A, Bm = (a.to(device=dev, dtype=dt) for a in _dynamics(cfg))
    per = T * (SD + CD)
    X = torch.stack([x[:, i * per: i * per + T * SD].reshape(Bn, T, SD) for i in range(N)], 1)
    U = torch.stack([x[:, i * per + T * SD: (i + 1) * per].reshape(Bn, T, CD)
                     for i in range(N)], 1)  # (Bn, N, T, CD)
    lam = x[:, N * per:].reshape(Bn, T, N, SD)  # [t][player] blocks of the joint rows
    th = theta.reshape(Bn, N, SD + 1)
    x0, lane = th[..., :SD], th[..., SD]

    # Inequalities h and their multipliers, in the stacking order above.
    mu_c = y[:, :T]  # (Bn, T)
    o = T
    mu_e = y[:, o:o + T * N * 4].reshape(Bn, T, N, 4)
    o += T * N * 4
    mu_u = y[:, o:o + T * 2 * N * CD].reshape(Bn, T, 2, N, CD)  # [lo|hi][player][k]
    o += T * 2 * N * CD
    mu_v = y[:, o:o + T * 2 * N * 2].reshape(Bn, T, 2, N, 2)  # [lo|hi][player][vx,vy]
    p, v = X[..., :2], X[..., 2:]  # (Bn, N, T, 2)
    d = p[:, 0] - p[:, 1]  # (Bn, T, 2)
    h_c = (d * d).sum(-1) - 4.0
    px, py = p[..., 0].transpose(1, 2), p[..., 1].transpose(1, 2)  # (Bn, T, N)
    h_e = torch.stack([py, road_w - px, road_l - py, px], -1)
    Ut = U.transpose(1, 2)  # (Bn, T, N, CD)
    h_u = torch.stack([Ut + 5.0, 3.0 - Ut], 2)
    vt = v.transpose(1, 2)  # (Bn, T, N, 2)
    h_v = torch.stack([vt + torch.tensor([10.0, 0.0], dtype=dt, device=dev), 10.0 - vt], 2)
    H = torch.cat([h_c, h_e.reshape(Bn, -1), h_u.reshape(Bn, -1), h_v.reshape(Bn, -1)], 1)

    # Equalities g: the initial pin, then the defect of each step t ≥ 1.
    g0 = X[:, :, 0] - x0  # (Bn, N, SD)
    Xn = X[:, :, :-1] @ A.T + U[:, :, :-1] @ Bm.T
    gd = X[:, :, 1:] - Xn  # (Bn, N, T−1, SD)
    g_eq = torch.cat([g0[:, :, None], gd], 2).transpose(1, 2).reshape(Bn, -1)

    # ∇J_i: the mean over the T stages.
    dJx = torch.zeros_like(X)
    dJx[..., 0] = 2.0 * (X[..., 0] - lane[:, :, None])
    dJx[..., 2] = X[..., 2]
    dJx[..., 3] = X[..., 3] - 2.0
    dJx = dJx / T
    dJu = 0.2 * U / T

    # ∇(λ·g): λ_0 on X[0]; λ_t on X[t], −Aᵀλ_t on X[t−1], −Bᵀλ_t on U[t−1].
    lam_p = lam.transpose(1, 2)  # (Bn, N, T, SD)
    dgx = lam_p.clone()
    dgx[:, :, :-1] -= lam_p[:, :, 1:] @ A
    dgu = torch.zeros_like(U)
    dgu[:, :, :-1] -= lam_p[:, :, 1:] @ Bm

    # ∇(μ·h).
    dhx = torch.zeros_like(X)
    dc = 2.0 * mu_c[..., None] * d  # (Bn, T, 2)
    dhx[:, 0, :, :2] += dc
    dhx[:, 1, :, :2] -= dc
    me = mu_e.transpose(1, 2)  # (Bn, N, T, 4)
    dhx[..., 0] += me[..., 3] - me[..., 1]
    dhx[..., 1] += me[..., 0] - me[..., 2]
    mv = mu_v.permute(0, 3, 1, 2, 4)  # (Bn, N, T, 2, 2)
    dhx[..., 2:] += mv[..., 0, :] - mv[..., 1, :]
    mu_ = mu_u.permute(0, 3, 1, 2, 4)
    dhu = mu_[..., 0, :] - mu_[..., 1, :]

    Gx = dJx - dgx - dhx
    Gu = dJu - dgu - dhu
    G = torch.cat([torch.cat([Gx[:, i].reshape(Bn, -1), Gu[:, i].reshape(Bn, -1)], 1)
                   for i in range(N)] + [g_eq], 1)
    return G, H
