"""t-SNE (port of ``clustering/tsne.py``; reference
``deeplearning4j-core/.../plot/BarnesHutTsne.java:65`` and
``plot/Tsne.java``).

The default exact path computes the full [N,N] affinity and
repulsive-force matrices as matrix products on the device, one step per
iteration.  ``BarnesHutTsne`` is the reference's O(N log N) algorithm:
its kNN (``BruteForceNN``) and perplexity calibration run on the device,
its SPTree iterations on the host.  The perplexity calibration is the
JAX package's vectorized bisection (a ``lax.scan`` there, a loop of
device steps here).  The initial embedding is ``1e-4 *
jax.random.normal(PRNGKey(seed), (n, c), f32)``, drawn from the port's
threefry stream (``utils/_random``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils import _random
from ..utils.device import resolve_device
from .neighbors import BruteForceNN
from .sptree import SPTree

__all__ = ["BarnesHutTsne", "Tsne"]


@torch.no_grad()
def _calibrate_p(d2: torch.Tensor, perplexity: float,
                 iters: int = 50) -> torch.Tensor:
    """Row-wise bisection for Gaussian kernel precisions (beta = 1/2sigma^2)
    so each row's entropy == log(perplexity).  d2: [N,N] squared distances
    with +inf on the diagonal."""
    target = torch.log(torch.tensor(perplexity, dtype=d2.dtype,
                                    device=d2.device))
    n = d2.shape[0]

    def entropy_p(beta):
        p = torch.softmax(-d2 * beta[:, None], dim=1)
        h = -torch.sum(p * torch.where(p > 1e-12, torch.log(p), 0.0), dim=1)
        return h, p

    beta = torch.ones(n, dtype=d2.dtype, device=d2.device)
    lo = torch.zeros_like(beta)
    hi = torch.full_like(beta, torch.inf)
    for _ in range(iters):
        h, _ = entropy_p(beta)
        too_high = h > target          # entropy too high -> increase beta
        lo = torch.where(too_high, beta, lo)
        hi = torch.where(too_high, hi, beta)
        beta = torch.where(torch.isinf(hi), beta * 2.0, (lo + hi) / 2.0)
    _, p = entropy_p(beta)
    return p


@torch.no_grad()
def _tsne_grad_exact(y: torch.Tensor, p_sym: torch.Tensor):
    """Exact t-SNE gradient: attractive + repulsive via full Student-t kernel."""
    n = y.shape[0]
    y2 = torch.sum(y * y, dim=1)
    d2 = y2[:, None] - 2.0 * (y @ y.T) + y2[None, :]
    num = 1.0 / (1.0 + d2)
    num.fill_diagonal_(0.0)
    q = num / torch.clamp(num.sum(), min=1e-12)
    pq = (p_sym - torch.clamp(q, min=1e-12)) * num          # [N,N]
    grad = 4.0 * (torch.diag(pq.sum(1)) - pq) @ y
    kl = torch.sum(p_sym * torch.log(torch.clamp(p_sym, min=1e-12)
                                     / torch.clamp(q, min=1e-12)))
    return grad, kl


@torch.no_grad()
def _gd_update(y, grad, vel, gains, lr: float, momentum: float):
    """Delta-bar-delta gains + momentum step (reference ``Tsne.java``
    update).  Gains are capped: with Student-t attraction, an overshoot
    past the kernel tail is unrecoverable (gradient vanishes), so
    unbounded gains diverge."""
    same_sign = (grad > 0) == (vel > 0)
    gains = torch.clamp(torch.where(same_sign, gains * 0.8, gains + 0.2),
                        0.01, 10.0)
    vel = momentum * vel - lr * gains * grad
    y = y + vel
    return y - y.mean(0), vel, gains


class Tsne:
    """Exact t-SNE, one device step per iteration, on ``device``
    (default ``"cuda"``)."""

    def __init__(self, n_components: int = 2, perplexity: float = 30.0,
                 max_iter: int = 1000, learning_rate: Optional[float] = None,
                 initial_momentum: float = 0.5, final_momentum: float = 0.8,
                 switch_momentum_iteration: int = 250,
                 stop_lying_iteration: int = 250, exaggeration: float = 12.0,
                 seed: int = 42, device="cuda"):
        self.n_components = n_components
        self.perplexity = perplexity
        self.max_iter = max_iter
        self.learning_rate = learning_rate
        self.initial_momentum = initial_momentum
        self.final_momentum = final_momentum
        self.switch_momentum_iteration = switch_momentum_iteration
        self.stop_lying_iteration = stop_lying_iteration
        self.exaggeration = exaggeration
        self.seed = seed
        self.device = resolve_device(device)
        self.embedding: Optional[np.ndarray] = None
        self.kl_divergence: Optional[float] = None

    @torch.no_grad()
    def _input_probabilities(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        x2 = torch.sum(x * x, dim=1)
        d2 = x2[:, None] - 2.0 * (x @ x.T) + x2[None, :]
        d2.fill_diagonal_(torch.inf)
        p = _calibrate_p(d2, self.perplexity)
        p_sym = (p + p.T) / (2.0 * n)
        return torch.clamp(p_sym, min=1e-12)

    def _lr(self, n: int) -> float:
        """Auto learning rate: N / exaggeration / 4, floored (sklearn-style
        heuristic, scaled down — small-N embeddings overshoot the Student-t
        attraction basin at the classic lr=200)."""
        if self.learning_rate is not None:
            return self.learning_rate
        return max(n / self.exaggeration / 4.0, 5.0)

    def _initial(self, n: int) -> torch.Tensor:
        key = _random.prng_key(self.seed, device=self.device)
        return 1e-4 * _random.normal(key, (n, self.n_components))

    def fit(self, x) -> np.ndarray:
        x = torch.as_tensor(np.asarray(x, dtype=np.float32),
                            device=self.device)
        n = x.shape[0]
        lr = self._lr(n)
        p_sym = self._input_probabilities(x)
        y = self._initial(n)
        vel = torch.zeros_like(y)
        gains = torch.ones_like(y)
        kl = None
        for it in range(self.max_iter):
            lying = it < self.stop_lying_iteration
            p_eff = p_sym * self.exaggeration if lying else p_sym
            momentum = (self.initial_momentum
                        if it < self.switch_momentum_iteration
                        else self.final_momentum)
            grad, kl = _tsne_grad_exact(y, p_eff)
            y, vel, gains = _gd_update(y, grad, vel, gains, lr, momentum)
        self.embedding = y.cpu().numpy()
        self.kl_divergence = float(kl) if kl is not None else None
        return self.embedding


class BarnesHutTsne(Tsne):
    """Barnes-Hut t-SNE (reference ``plot/BarnesHutTsne.java:65``): sparse
    kNN input affinities (kNN and calibration on ``device``) + SPTree
    theta-approximated repulsion, on the host.

    ``theta=0`` falls back to the exact path (same convention as the
    reference, ``BarnesHutTsne.java`` theta field).
    """

    def __init__(self, theta: float = 0.5, n_components: int = 2,
                 perplexity: float = 30.0, max_iter: int = 1000,
                 learning_rate: Optional[float] = None, seed: int = 42, **kw):
        super().__init__(n_components=n_components, perplexity=perplexity,
                         max_iter=max_iter, learning_rate=learning_rate,
                         seed=seed, **kw)
        self.theta = theta

    def fit(self, x) -> np.ndarray:
        if self.theta <= 0.0:
            return super().fit(x)
        x_np = np.asarray(x, dtype=np.float32)
        n = len(x_np)
        k = min(int(3 * self.perplexity), n - 1)
        # kNN on the device (distance matmul), calibration on the sparse rows
        dist, idx = BruteForceNN(x_np, device=self.device).query(x_np, k + 1)
        dist, idx = dist[:, 1:], idx[:, 1:]                 # drop self
        d2 = torch.as_tensor(dist, device=self.device) ** 2
        p_cond = _calibrate_p(d2, min(self.perplexity, k / 3.0)
                              ).cpu().numpy()
        # symmetrize the sparse matrix: P = (P + P^T) / 2N as dense-of-sparse
        rows = np.repeat(np.arange(n), k)
        p_dense = np.zeros((n, n))
        p_dense[rows, idx.ravel()] = p_cond.ravel()
        p_sym = (p_dense + p_dense.T) / (2.0 * n)
        rng = np.random.default_rng(self.seed)
        lr = self._lr(n)
        y = 1e-4 * rng.standard_normal((n, self.n_components))
        vel = np.zeros_like(y)
        gains = np.ones_like(y)
        kl = None
        nz = p_sym.nonzero()
        p_vals = p_sym[nz]
        for it in range(self.max_iter):
            lying = it < self.stop_lying_iteration
            p_eff = p_vals * (self.exaggeration if lying else 1.0)
            momentum = (self.initial_momentum
                        if it < self.switch_momentum_iteration
                        else self.final_momentum)
            # attractive forces over the sparse edges
            diff = y[nz[0]] - y[nz[1]]
            w = 1.0 / (1.0 + np.sum(diff * diff, axis=1))
            attr = np.zeros_like(y)
            np.add.at(attr, nz[0], (p_eff * w)[:, None] * diff)
            # repulsive via SPTree
            tree = SPTree(y)
            neg = np.zeros_like(y)
            z = 0.0
            for i in range(n):
                f, zi = tree.compute_non_edge_forces(i, self.theta)
                neg[i] = f
                z += zi
            grad = 4.0 * (attr - neg / max(z, 1e-12))
            same = (grad > 0) == (vel > 0)
            gains = np.clip(np.where(same, gains * 0.8, gains + 0.2), 0.01, 10.0)
            vel = momentum * vel - lr * gains * grad
            y = y + vel
            y = y - y.mean(0)
        q_un = w  # reuse last attractive kernel for a cheap KL estimate
        kl = float(np.sum(p_vals * np.log(np.maximum(p_vals, 1e-12)
                                          / np.maximum(q_un / max(z, 1e-12), 1e-12))))
        self.embedding = y
        self.kl_divergence = kl
        return y
