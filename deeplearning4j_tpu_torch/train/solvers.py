"""Legacy full-batch solvers: LBFGS, ConjugateGradient and
LineGradientDescent with a backtracking line search (port of
``train/solvers.py``; reference ``optimize/Solver.java:43``,
``optimize/solvers/``, ``optimize/stepfunctions/``,
``optimize/terminations/``).

Each solver works on one flat parameter vector: the network's params
raveled in the JAX package's ``ravel_pytree`` order (layer keys sorted,
then parameter names sorted), so the vector dot products sum the same
entries in the same order.  The JAX package runs an iteration as one
jitted program (the line search as a ``lax.while_loop``, the L-BFGS
two-loop recursion as ``lax.fori_loop`` over fixed circular buffers);
here the same arithmetic runs eagerly on the network's device, with the
loop tests read on the host.  The loss is evaluated deterministically
(``train=False``), as in the JAX package: these are deterministic
full-batch methods.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

__all__ = ["Solver", "LineGradientDescent", "ConjugateGradient", "LBFGS",
           "BackTrackLineSearch", "DefaultStepFunction",
           "NegativeDefaultStepFunction", "EpsTermination",
           "Norm2Termination", "ZeroDirectionTermination"]


# --------------------------------------------------------- step functions
class DefaultStepFunction:
    """x_new = x + alpha * direction (reference DefaultStepFunction)."""
    sign = 1.0


class NegativeDefaultStepFunction:
    """x_new = x - alpha * direction (reference NegativeDefaultStepFunction)."""
    sign = -1.0


# ---------------------------------------------------- termination conditions
class EpsTermination:
    """Stop when the score improvement falls below eps * tolerance
    (reference ``optimize/terminations/EpsTermination.java``)."""

    def __init__(self, eps: float = 1e-4, tolerance: float = 1.0):
        self.eps = eps
        self.tolerance = tolerance

    def terminate(self, cost_old: float, cost_new: float, g_norm: float
                  ) -> bool:
        return abs(cost_old - cost_new) < self.eps * self.tolerance


class Norm2Termination:
    """Stop when ||grad||_2 < gradient_norm threshold (reference
    ``Norm2Termination.java``)."""

    def __init__(self, gradient_norm: float = 1e-6):
        self.gradient_norm = gradient_norm

    def terminate(self, cost_old: float, cost_new: float, g_norm: float
                  ) -> bool:
        return g_norm < self.gradient_norm


class ZeroDirectionTermination:
    """Stop when the search direction is numerically zero (reference
    ``ZeroDirection.java``)."""

    def terminate(self, cost_old: float, cost_new: float, g_norm: float
                  ) -> bool:
        return g_norm == 0.0


def _finite(t: torch.Tensor) -> bool:
    return bool(torch.isfinite(t))


# --------------------------------------------------------- line search
class BackTrackLineSearch:
    """Armijo backtracking (reference ``BackTrackLineSearch.java``): shrink
    alpha by ``rho`` until f(x + a·d) <= f(x) + c1·a·(g·d)."""

    def __init__(self, c1: float = 1e-4, rho: float = 0.5,
                 max_iterations: int = 20, min_step: float = 1e-12,
                 initial_step: float = 1.0):
        self.c1 = c1
        self.rho = rho
        self.max_iterations = max_iterations
        self.min_step = min_step
        self.initial_step = initial_step

    @torch.no_grad()
    def search(self, value_fn: Callable[[torch.Tensor], torch.Tensor],
               x: torch.Tensor, f0: torch.Tensor, g: torch.Tensor,
               direction: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns ``(alpha, f_new)`` as 0-d tensors in x's dtype."""
        gd = torch.dot(g, direction)
        alpha = torch.tensor(self.initial_step, dtype=x.dtype,
                             device=x.device)
        f_new = value_fn(x + alpha * direction)
        n = 0
        while True:
            armijo_fail = not bool(f_new <= f0 + self.c1 * alpha * gd)
            if not ((armijo_fail or not _finite(f_new))
                    and n < self.max_iterations
                    and bool(alpha > self.min_step)):
                break
            alpha = alpha * self.rho
            f_new = value_fn(x + alpha * direction)
            n += 1
        # if even the smallest step failed, take no step at all
        if bool(f_new <= f0) and _finite(f_new):
            return alpha, f_new
        return torch.zeros_like(alpha), f0


# ------------------------------------------------------------- solvers
def _flat_keys(params) -> List[Tuple[str, str]]:
    """``(layer, name)`` of every param in ``ravel_pytree``'s order."""
    return [(k, n) for k in sorted(params) for n in sorted(params[k])]


class _BaseFullBatchOptimizer:
    """The shared loop: flat loss and gradient, the iterations, params
    written back (reference ``BaseOptimizer.gradientAndScore`` :171-187 +
    per-algorithm ``optimize()``)."""

    name = "base"

    def __init__(self, max_iterations: int = 100,
                 terminations: Optional[Sequence[Any]] = None,
                 line_search: Optional[BackTrackLineSearch] = None,
                 step_function: Any = None):
        self.max_iterations = max_iterations
        self.terminations = list(terminations) if terminations is not None \
            else [EpsTermination(1e-10), Norm2Termination(1e-8)]
        self.line_search = line_search or BackTrackLineSearch()
        self.step_function = step_function or DefaultStepFunction()
        self.score_history: List[float] = []

    # subclass contract ----------------------------------------------------
    def init_state(self, flat: torch.Tensor, g: torch.Tensor):
        return ()

    def direction(self, g: torch.Tensor, state) -> Tuple[torch.Tensor, Any]:
        raise NotImplementedError

    def post_step(self, state, x_old, x_new, g_old, g_new):
        return state

    # the iterations ---------------------------------------------------------
    def optimize(self, model, data, labels=None, mask=None,
                 label_mask=None) -> float:
        """Run up to max_iterations full-batch iterations on (x, y).
        Returns the final score and updates ``model.params`` in place."""
        from ..nn.multilayer import _stack_loss_state
        x, y, m, lm = _normalize(model, data, labels, mask, label_mask)
        params = model._param_tree()
        keys = _flat_keys(params)
        shapes = [params[k][n].shape for k, n in keys]
        sizes = [params[k][n].numel() for k, n in keys]
        with torch.no_grad():
            flat0 = torch.cat([params[k][n].detach().reshape(-1)
                               for k, n in keys])
        state_tree = model.state

        def unravel(flat) -> Dict[str, Dict[str, torch.Tensor]]:
            tree: Dict[str, Dict[str, torch.Tensor]] = {k: {} for k in params}
            for (k, n), part, shape in zip(keys, flat.split(sizes), shapes):
                tree[k][n] = part.view(shape)
            return tree

        def loss_flat(flat):
            loss, _ = _stack_loss_state(model.conf, unravel(flat),
                                        state_tree, x, y, train=False,
                                        mask=m, label_mask=lm)
            return loss

        def value(flat):
            with torch.no_grad():
                return loss_flat(flat)

        def value_and_grad(flat):
            flat = flat.detach().requires_grad_(True)
            with torch.enable_grad():
                loss = loss_flat(flat)
                (g,) = torch.autograd.grad(loss, flat)
            return loss.detach(), g

        sign = self.step_function.sign
        f, g = value_and_grad(flat0)
        flat = flat0
        opt_state = self.init_state(flat0, g)
        self.score_history = [float(f)]
        for _ in range(self.max_iterations):
            f_old = float(f)
            with torch.no_grad():
                d, opt_state = self.direction(g, opt_state)
                d = sign * d
                alpha, _ = self.line_search.search(value, flat, f, g, d)
                flat_new = flat + alpha * d
            f, g_new = value_and_grad(flat_new)
            with torch.no_grad():
                opt_state = self.post_step(opt_state, flat, flat_new, g,
                                           g_new)
            flat, g = flat_new, g_new
            f_cur = float(f)
            self.score_history.append(f_cur)
            g_norm = float(torch.linalg.norm(g))
            if any(t.terminate(f_old, f_cur, g_norm)
                   for t in self.terminations):
                break
        with torch.no_grad():
            tree = unravel(flat)
            for k, n in keys:
                model.params[k][n].copy_(tree[k][n])
        model._score = float(f)
        for lst in getattr(model, "listeners", []):
            model.iteration += 1
            lst.iteration_done(model, model.iteration, model.epoch)
        return float(f)


class LineGradientDescent(_BaseFullBatchOptimizer):
    """Steepest descent + line search (reference
    ``optimize/solvers/LineGradientDescent.java``)."""

    name = "line_gradient_descent"

    def direction(self, g, state):
        return -g, state


class ConjugateGradient(_BaseFullBatchOptimizer):
    """Nonlinear Polak-Ribiere(+) conjugate gradient with automatic restart
    (reference ``optimize/solvers/ConjugateGradient.java``)."""

    name = "conjugate_gradient"

    def init_state(self, flat, g):
        return (-g, g)  # (previous direction, previous gradient)

    def direction(self, g, state):
        d_prev, g_prev = state
        beta = torch.dot(g, g - g_prev) / (torch.dot(g_prev, g_prev) + 1e-30)
        beta = torch.clamp(beta, min=0.0)   # PR+ restart
        d = -g + beta * d_prev
        # restart to steepest descent if d is not a descent direction
        if not bool(torch.dot(d, g) < 0):
            d = -g
        return d, (d, g)

    def post_step(self, state, x_old, x_new, g_old, g_new):
        d, _ = state
        return (d, g_old)


class LBFGS(_BaseFullBatchOptimizer):
    """Limited-memory BFGS (reference ``optimize/solvers/LBFGS.java``,
    default memory m=10).  The two-loop recursion runs over circular
    [m, n] S/Y buffers; unfilled slots are skipped."""

    name = "lbfgs"

    def __init__(self, max_iterations: int = 100, memory: int = 10, **kw):
        super().__init__(max_iterations=max_iterations, **kw)
        self.m = memory

    def init_state(self, flat, g):
        n, m = flat.shape[0], self.m
        z = torch.zeros((m, n), dtype=flat.dtype, device=flat.device)
        return (z, z.clone(),
                torch.zeros((m,), dtype=flat.dtype, device=flat.device), 0)

    def direction(self, g, state):
        S, Y, rho, count = state
        m = self.m
        valid_n = min(count, m)
        alphas = torch.zeros((m,), dtype=g.dtype, device=g.device)
        q = g
        for i in range(valid_n):
            idx = (count - 1 - i) % m
            a = rho[idx] * torch.dot(S[idx], q)
            q = q - a * Y[idx]
            alphas[idx] = a
        if count > 0:
            latest = (count - 1) % m
            yy = torch.dot(Y[latest], Y[latest])
            gamma = torch.dot(S[latest], Y[latest]) / (yy + 1e-30)
        else:
            gamma = 1.0
        r = gamma * q
        for i in range(valid_n):
            idx = (count - valid_n + i) % m
            b = rho[idx] * torch.dot(Y[idx], r)
            r = r + (alphas[idx] - b) * S[idx]
        d = -r
        # safeguard: fall back to steepest descent on a non-descent direction
        if not bool(torch.dot(d, g) < 0):
            d = -g
        return d, state

    def post_step(self, state, x_old, x_new, g_old, g_new):
        S, Y, rho, count = state
        s = x_new - x_old
        yv = g_new - g_old
        sy = torch.dot(s, yv)
        slot = count % self.m
        if bool(sy > 1e-10):   # curvature condition; skip the pair otherwise
            S, Y, rho = S.clone(), Y.clone(), rho.clone()
            S[slot] = s
            Y[slot] = yv
            rho[slot] = 1.0 / torch.clamp(sy, min=1e-30)
            count += 1
        return (S, Y, rho, count)


_ALGOS = {
    "line_gradient_descent": LineGradientDescent,
    "conjugate_gradient": ConjugateGradient,
    "lbfgs": LBFGS,
}


class Solver:
    """Facade mirroring ``optimize/Solver.java:43``: pick the optimizer from
    the algorithm name and drive it.  ``sgd``/``stochastic_gradient_descent``
    delegates to the network's own minibatch path."""

    def __init__(self, model, algorithm: str = "lbfgs",
                 max_iterations: int = 100, **kw):
        self.model = model
        self.algorithm = algorithm.lower()
        if self.algorithm in ("sgd", "stochastic_gradient_descent"):
            self.optimizer = None
        elif self.algorithm in _ALGOS:
            self.optimizer = _ALGOS[self.algorithm](
                max_iterations=max_iterations, **kw)
        else:
            raise ValueError(
                f"unknown optimization algorithm '{algorithm}'; available: "
                f"sgd, {', '.join(sorted(_ALGOS))}")

    def optimize(self, data, labels=None, **kw) -> float:
        if self.optimizer is None:
            self.model.fit(data, labels)
            return self.model.score()
        return self.optimizer.optimize(self.model, data, labels, **kw)


def _normalize(model, data, labels, mask, label_mask):
    if labels is not None:
        x, y, m, lm = data, labels, mask, label_mask
    else:
        x, y, m, lm = model._normalize_batch(data)
        m = mask if mask is not None else m
        lm = label_mask if label_mask is not None else lm
    return tuple(model._on_device(a) for a in (x, y, m, lm))
