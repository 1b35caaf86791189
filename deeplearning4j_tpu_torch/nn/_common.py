"""Training-step machinery shared by the network types (port of
``nn/_common.py``): the updater groups (``build_tx``), gradient
normalization, and the constraint pass.

Gradients and parameters are ``{layer_i: {name: tensor}}`` dicts, as the
JAX package's pytrees.  ``build_tx`` returns an ``UpdaterGroups`` in
place of an optax transform: one ``UpdaterConf`` per label (the network
default, a layer's own updater, a layer's bias updater, or ``None`` for a
frozen group), a label per parameter, and a step count per label.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from .conf.updaters import UpdaterConf
from .layers.base import BaseLayerConf, LayerConf

Tree = Dict[str, Dict[str, torch.Tensor]]


def hyperparam_conf(lc: Optional[LayerConf]) -> Optional[BaseLayerConf]:
    """The conf that carries hyperparams (updater/constraints/
    normalization).  The reference also looks through wrapper layers
    (Bidirectional, LastTimeStep, FrozenLayer), which are not ported."""
    return lc if isinstance(lc, BaseLayerConf) else None


def float_grad_leaves(tree: Dict[str, Any]) -> List[torch.Tensor]:
    """Floating gradient leaves of a ``{name: tensor}`` group or a
    ``{layer: {name: tensor}}`` tree, in insertion order."""
    out = []
    for v in tree.values():
        if isinstance(v, dict):
            out += float_grad_leaves(v)
        elif v is not None and v.is_floating_point():
            out.append(v)
    return out


def _map_float(fn, group: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: fn(g) if g.is_floating_point() else g
            for k, g in group.items()}


def _l2(leaves: List[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g * g) for g in leaves))


def apply_gradient_normalization(mode: Optional[str], threshold: float,
                                 grads: Dict[str, torch.Tensor]
                                 ) -> Dict[str, torch.Tensor]:
    """One layer's gradients under the reference's ``preApply`` modes."""
    if not mode or mode == "none":
        return grads
    mode = mode.lower()
    leaves = float_grad_leaves(grads)
    if mode == "renormalizel2perlayer":
        norm = _l2(leaves)
        return _map_float(lambda g: g / (norm + 1e-8), grads)
    if mode == "renormalizel2perparamtype":
        return _map_float(
            lambda g: g / (torch.linalg.norm(g.reshape(-1)) + 1e-8), grads)
    if mode == "clipelementwiseabsolutevalue":
        return _map_float(lambda g: torch.clamp(g, -threshold, threshold),
                          grads)
    if mode == "clipl2perlayer":
        scale = torch.clamp(threshold / (_l2(leaves) + 1e-8), max=1.0)
        return _map_float(lambda g: g * scale, grads)
    if mode == "clipl2perparamtype":
        def clip(g):
            n = torch.linalg.norm(g.reshape(-1))
            return g * torch.clamp(threshold / (n + 1e-8), max=1.0)
        return _map_float(clip, grads)
    raise ValueError(f"unknown gradient normalization '{mode}'")


def is_frozen(lc: Optional[LayerConf]) -> bool:
    return bool(getattr(lc, "FROZEN", False))


class UpdaterGroups:
    """The port's counterpart of the optax transform ``build_tx`` makes:
    ``transforms[label]`` (``None`` = frozen: no update, no state) and
    ``labels[layer][name]``."""

    def __init__(self, transforms: Dict[str, Optional[UpdaterConf]],
                 labels: Dict[str, Dict[str, str]]):
        self.transforms = transforms
        self.labels = labels

    def init(self, params: Tree) -> Dict[str, Any]:
        """``{"count": {label: 0}, "slots": {layer: {name: {slot:
        tensor}}}}``, zero slots shaped like each parameter."""
        slots = {}
        for layer, group in params.items():
            slots[layer] = {}
            for name, p in group.items():
                u = self.transforms[self.labels[layer][name]]
                slots[layer][name] = u.init_slots(p) if u is not None else {}
        return {"count": {lab: 0 for lab, u in self.transforms.items()
                          if u is not None},
                "slots": slots}

    @torch.no_grad()
    def step(self, params: Tree, grads: Tree, state: Dict[str, Any]) -> None:
        """Apply one update to ``params`` in place (``p += u``, as
        ``optax.apply_updates``) and advance ``state``."""
        count = state["count"]
        for layer, group in params.items():
            for name, p in group.items():
                u_conf = self.transforms[self.labels[layer][name]]
                if u_conf is None:
                    continue
                u = u_conf.update(grads[layer][name],
                                  state["slots"][layer][name],
                                  count[self.labels[layer][name]])
                p.add_(u.to(p.dtype))
        for lab in count:
            count[lab] += 1


def build_tx(default_u: UpdaterConf, confs: Dict[str, Optional[LayerConf]],
             params: Tree) -> UpdaterGroups:
    """Label every parameter: the network default, a layer's own updater
    (``{layer}/w``), its bias updater for bias-like params (``{layer}/b``),
    or ``frozen``."""
    resolved = {name: hyperparam_conf(lc) for name, lc in confs.items()}
    frozen = {name for name, lc in confs.items() if is_frozen(lc)}
    transforms: Dict[str, Optional[UpdaterConf]] = {"default": default_u}
    if frozen:
        transforms["frozen"] = None
    labels = {}
    for name, pgroup in params.items():
        lc = resolved.get(name)
        if name in frozen:
            labels[name] = {p: "frozen" for p in pgroup}
            continue
        if lc is None or (lc.updater is None and lc.bias_updater is None):
            labels[name] = {p: "default" for p in pgroup}
            continue
        wl = f"{name}/w"
        transforms[wl] = lc.updater or default_u
        lab = {}
        for pname in pgroup:
            if lc.bias_updater is not None and pname in lc._BIAS_PARAMS:
                transforms[f"{name}/b"] = lc.bias_updater
                lab[pname] = f"{name}/b"
            else:
                lab[pname] = wl
        labels[name] = lab
    return UpdaterGroups(transforms, labels)


def apply_gradient_norm_all(grads: Tree,
                            confs: Dict[str, Optional[LayerConf]],
                            gn_mode: Optional[str], gn_thr: float) -> Tree:
    """Per-layer ``preApply``; a layer's own setting replaces the
    network's."""
    for name, lc in confs.items():
        hc = hyperparam_conf(lc)
        own = getattr(hc, "gradient_normalization", None)
        m = own or gn_mode
        if m and grads.get(name):
            t = getattr(hc, "gradient_normalization_threshold", None)
            t = float(t) if t is not None and own else gn_thr
            grads[name] = apply_gradient_normalization(m, t, grads[name])
    return grads


def apply_constraints_all(params: Tree,
                          confs: Dict[str, Optional[LayerConf]]) -> Tree:
    """The reference applies layer constraints after each step.  They
    are not ported: any layer that sets them raises."""
    for name, lc in confs.items():
        hc = hyperparam_conf(lc)
        if getattr(hc, "constraints", None):
            raise NotImplementedError(
                f"layer '{getattr(hc, 'name', name)}': constraints are not "
                "ported yet")
    return params
