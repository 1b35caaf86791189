"""Numerical gradient checking (port of ``utils/gradient_check.py``).

Analogue of ``gradientcheck/GradientCheckUtil.java``: the gradients of
the network's loss by autograd against central differences, in float64,
with per-parameter relative-error thresholds.  The loss runs with
``train=False`` (no dropout or weight noise; BatchNormalization
normalises with its running statistics), on the network's device.

The parameters are visited in the order of the JAX package's
``tree_flatten`` (group names sorted, then parameter names, a nested
group's ``fwd/W`` as ``["fwd"]["W"]``), and ``subset`` draws the same
elements from ``numpy.random.default_rng(seed)``, so both packages check
the same elements of the same network.  ``exclude`` skips the leaves
whose path names contain one of its strings (class centres, ``"centers"``,
are updated by a decoupled rule).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["check_gradients"]


def _f64_tree(tree) -> Dict[str, Dict[str, torch.Tensor]]:
    return {k: {n: t.detach().to(torch.float64) if t.is_floating_point()
                else t for n, t in g.items()} for k, g in tree.items()}


def _f64_on(a, device) -> torch.Tensor:
    """An input or label batch (array or tensor) as float64 on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(device=device, dtype=torch.float64)
    return torch.as_tensor(np.asarray(a, np.float64), device=device)


def _leaves(params) -> List[Tuple[str, str, str]]:
    """``(group, name, JAX key path)`` in the JAX package's flatten
    order."""
    out = []
    for g, group in params.items():
        for n in group:
            path = "".join(f"['{p}']" for p in (g, *n.split("/")))
            out.append(((g, *n.split("/")), g, n, path))
    out.sort(key=lambda t: t[0])
    return [(g, n, path) for _, g, n, path in out]


def check_gradients(net, x, y, *, epsilon: float = 1e-6,
                    max_rel_error: float = 1e-3, min_abs_error: float = 1e-8,
                    mask=None, label_mask=None, print_results: bool = False,
                    subset: Optional[int] = None, seed: int = 12345,
                    exclude: tuple = ("centers",)) -> bool:
    """Check d(loss)/d(params) of a MultiLayerNetwork.  ``subset``: check
    only that many randomly chosen elements of each larger parameter."""
    from ..nn.multilayer import _stack_loss_state
    if not net.params:
        net.init()
    dev = net.device
    state = _f64_tree(net.state)
    xt, yt = _f64_on(x, dev), _f64_on(y, dev)
    m = None if mask is None else torch.as_tensor(mask, device=dev)
    lm = None if label_mask is None else torch.as_tensor(label_mask,
                                                         device=dev)

    def loss_fn(p):
        return _stack_loss_state(net.conf, p, state, xt, yt, train=False,
                                 mask=m, label_mask=lm)[0]

    return check_loss_gradients(loss_fn, net._param_tree(), epsilon,
                                max_rel_error, min_abs_error, print_results,
                                subset, seed, exclude)


def check_loss_gradients(loss_fn: Callable, params, epsilon: float,
                         max_rel_error: float, min_abs_error: float,
                         print_results: bool, subset: Optional[int],
                         seed: int, exclude: tuple = ()) -> bool:
    """The check of ``loss_fn(params)`` (a float64 scalar tensor) over the
    ``{group: {name: tensor}}`` tree ``params`` (JAX
    ``_check_gradients_impl``)."""
    params = _f64_tree(params)
    order = _leaves(params)
    leaves = [params[g][n].requires_grad_(True) for g, n, _ in order]
    analytic = torch.autograd.grad(loss_fn(params), leaves,
                                   allow_unused=True)
    rng = np.random.default_rng(seed)
    fails = checked = 0
    max_err_seen = 0.0

    @torch.no_grad()
    def loss_at(li, idx, delta):
        g, n, _ = order[li]
        a = leaves[li].detach().clone()
        a.view(-1)[idx] += delta
        probe = {k: dict(v) for k, v in params.items()}
        probe[g][n] = a
        return float(loss_fn(probe))

    for li, ((_, _, path), leaf, ga) in enumerate(zip(order, leaves,
                                                      analytic)):
        if any(e in path for e in exclude):
            continue
        ga_flat = (np.zeros(leaf.numel()) if ga is None
                   else ga.detach().cpu().numpy().reshape(-1))
        n = leaf.numel()
        if subset is not None and n > subset:
            indices = rng.choice(n, subset, replace=False)
        else:
            indices = np.arange(n)
        for idx in indices:
            plus = loss_at(li, int(idx), epsilon)
            minus = loss_at(li, int(idx), -epsilon)
            numeric = (plus - minus) / (2 * epsilon)
            a = ga_flat[idx]
            abs_err = abs(a - numeric)
            denom = abs(a) + abs(numeric)
            rel_err = abs_err / denom if denom > 0 else 0.0
            checked += 1
            if rel_err > max_err_seen:
                max_err_seen = rel_err
            if rel_err > max_rel_error and abs_err > min_abs_error:
                fails += 1
                if print_results:
                    print(f"FAIL param {path}[{idx}]: analytic={a:.8e} "
                          f"numeric={numeric:.8e} relErr={rel_err:.4e}")
            elif print_results:
                print(f"ok   param {path}[{idx}]: analytic={a:.8e} "
                      f"numeric={numeric:.8e} relErr={rel_err:.4e}")
    if print_results or fails:
        print(f"gradient check: {checked - fails}/{checked} passed "
              f"(max rel err {max_err_seen:.4e})")
    return fails == 0
