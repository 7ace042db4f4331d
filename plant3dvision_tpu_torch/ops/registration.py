"""Non-rigid point set registration (Coherent Point Drift EM).

Port of plant3dvision_tpu/ops/registration.py (role of the reference's
`skeleton_refinement.perform_registration`, tasks/proc3d.py:623-631):
deform skeleton nodes onto the point cloud. Small dense algebra — an
(M, M) Gaussian kernel, an (M, N) posterior and an M x M solve with
M ~ 10^2 — as float32 torch ops; the EM loop is a Python loop whose stop
test reads one scalar per iteration (at most `max_iterations`). TF32 is
switched off for the products and the solve, so the card computes in
full float32 like the CPU.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _gaussian_kernel(Y, beta):
    d2 = torch.sum((Y[:, None, :] - Y[None, :, :]) ** 2, dim=-1)
    return torch.exp(-d2 / (2.0 * beta ** 2))


def _cpd_loop(X, Y, alpha, beta, w, max_iterations, tolerance):
    N, D = X.shape
    M = Y.shape[0]
    G = _gaussian_kernel(Y, beta)
    sigma2 = torch.sum((X[None, :, :] - Y[:, None, :]) ** 2) / (D * M * N)
    prev_sigma2 = sigma2 + 2 * tolerance + 1.0
    W = torch.zeros((M, D), dtype=X.dtype, device=X.device)
    eye = torch.eye(M, dtype=X.dtype, device=X.device)
    XX = torch.sum(X * X, dim=1)
    it = 0
    # the sigma2 floor doubles as a hard stop: one more E-step at a
    # collapsed sigma2 zeroes every responsibility and snaps W back to 0
    while it < max_iterations and bool(
            (sigma2 > 1e-8) & (torch.abs(prev_sigma2 - sigma2) > tolerance)):
        TY = Y + G @ W
        d2 = torch.sum((X[None, :, :] - TY[:, None, :]) ** 2, dim=-1)  # (M, N)
        num = torch.exp(-d2 / (2.0 * sigma2))
        c = (2.0 * math.pi * sigma2) ** (D / 2.0) * (w / (1.0 - w)) * (M / N)
        # + tiny: a target point far from every node underflows the whole
        # num column to 0 in f32 — the floor gives such orphans P=0
        # instead of 0/0
        den = torch.sum(num, dim=0, keepdim=True) + c + 1e-30
        P = num / den
        P1 = torch.sum(P, dim=1)            # (M,)
        Np = torch.clamp(torch.sum(P1), min=1e-10)
        PX = P @ X                          # (M, D)
        # ridge floor keeps the solve well-posed when sigma2 bottoms out
        A = G * P1[:, None] + torch.clamp(alpha * sigma2, min=1e-6) * eye
        B = PX - P1[:, None] * Y
        W_new = torch.linalg.solve(A, B)
        TY = Y + G @ W_new
        xPx = torch.sum(torch.sum(P, dim=0) * XX)
        yPy = torch.sum(P1 * torch.sum(TY * TY, dim=1))
        trPXY = torch.sum(TY * PX)
        sigma2_new = torch.clamp((xPx - 2 * trPXY + yPy) / (Np * D), min=1e-9)
        prev_sigma2, sigma2, W = sigma2, sigma2_new, W_new
        it += 1
    return Y + G @ W


def cpd_nonrigid(target_points, source_points, alpha=5.0, beta=5.0,
                 max_iterations=100, tolerance=1e-4, w=0.0,
                 max_target_points=20000, seed=0, device="cuda"):
    """Deform `source_points` (skeleton) onto `target_points` (point cloud).

    Returns the deformed source points as numpy (M, 3).
    """
    from ..runtime.config import resolve_device

    X = np.asarray(target_points, dtype=np.float32)
    Y = np.asarray(source_points, dtype=np.float32)
    if len(X) > max_target_points:
        rng = np.random.default_rng(seed)
        X = X[rng.choice(len(X), max_target_points, replace=False)]
    dev = resolve_device(device)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = _cpd_loop(torch.from_numpy(X).to(dev),
                        torch.from_numpy(Y).to(dev), float(alpha),
                        float(beta), float(w), int(max_iterations),
                        float(tolerance))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.backends.cudnn.allow_tf32 = prev[1]
    return out.cpu().numpy().astype(np.float64)
