"""Viterbi decoder: the most likely hidden-state path (port of
``utils/viterbi.py``; reference ``util/Viterbi.java``).

The max-product recursion is a loop over time on the device, one step a
launch over every sequence of the batch, with the backpointers kept
there; the backtrace is a second loop over time.  The backpointer of a
tie is the first best state, as JAX's ``argmax`` (and torch's) gives it.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .device import resolve_device

__all__ = ["Viterbi", "viterbi_decode"]

_TINY = float(np.finfo(np.float32).tiny)


def _decode(log_e: torch.Tensor, log_tr: torch.Tensor, log_prior: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``log_e`` [b, t, s]; ``log_tr`` [s, s] (row = from, column = to);
    ``log_prior`` [s].  Returns (paths [b, t] int32, best log-probs [b])."""
    b, t, _ = log_e.shape
    alpha = log_prior[None] + log_e[:, 0]                       # [b, s]
    backs = []
    for i in range(1, t):
        scores = alpha[:, :, None] + log_tr[None]               # [b, from, to]
        backs.append(torch.argmax(scores, dim=1))               # [b, to]
        alpha = torch.amax(scores, dim=1) + log_e[:, i]
    state = torch.argmax(alpha, dim=1)                          # [b]
    best = torch.gather(alpha, 1, state[:, None])[:, 0]
    path = [state]
    for back in reversed(backs):
        state = torch.gather(back, 1, state[:, None])[:, 0]
        path.append(state)
    return torch.stack(path[::-1], dim=1).to(torch.int32), best


def _log(a, device) -> torch.Tensor:
    """float32 log with JAX's floor at float32's smallest normal."""
    a = torch.as_tensor(np.asarray(a, np.float32), device=device)
    return torch.log(torch.clamp(a, min=_TINY))


def viterbi_decode(emissions, transitions, prior=None, log_space: bool = False,
                   device="cuda") -> Tuple[np.ndarray, float]:
    """Decode one sequence.  ``emissions`` [t, s] (probabilities, or
    log-probabilities with ``log_space=True``); ``transitions`` [s, s];
    ``prior`` [s] (uniform when omitted).  Returns (state path [t],
    log-probability of the path)."""
    dev = resolve_device(device)
    s = np.asarray(emissions).shape[-1]
    p = np.full((s,), 1.0 / s, np.float32) if prior is None else prior
    if log_space:
        e, tr, lp = (torch.as_tensor(np.asarray(a, np.float32), device=dev)
                     for a in (emissions, transitions, p))
    else:
        e, tr, lp = (_log(a, dev) for a in (emissions, transitions, p))
    path, logp = _decode(e[None], tr, lp)
    return path[0].cpu().numpy(), float(logp[0])


class Viterbi:
    """Fix the label set and transitions once, decode many sequences
    (reference ``Viterbi.java``)."""

    def __init__(self, possible_labels, transitions=None, prior=None,
                 device="cuda"):
        self.labels = list(possible_labels)
        n = len(self.labels)
        if transitions is None:
            # the reference's default: a strong self-transition bias
            transitions = np.full((n, n), 0.25 / max(n - 1, 1))
            np.fill_diagonal(transitions, 0.75)
        self.transitions = np.asarray(transitions, np.float32)
        self.prior = prior
        self.device = resolve_device(device)

    def decode(self, emissions) -> Tuple[np.ndarray, float]:
        """[t, s] emissions -> (labels [t], log-probability)."""
        path, logp = viterbi_decode(emissions, self.transitions, self.prior,
                                    device=self.device)
        return np.asarray([self.labels[i] for i in path]), logp

    def decode_batch(self, emissions) -> Tuple[np.ndarray, np.ndarray]:
        """[b, t, s] emissions -> (paths [b, t] int32, log-probs [b])."""
        n = len(self.labels)
        if self.prior is None:
            lp = torch.full((n,), -float(np.log(n)), dtype=torch.float32,
                            device=self.device)
        else:
            lp = _log(self.prior, self.device)
        paths, logps = _decode(_log(emissions, self.device),
                               _log(self.transitions, self.device), lp)
        return paths.cpu().numpy(), logps.cpu().numpy()
