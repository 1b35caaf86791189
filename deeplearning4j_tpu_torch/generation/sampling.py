"""Token sampling with every knob as per-row data (port of
``generation/sampling.py``): greedy, temperature, top-k and top-p in one
function over the slot batch, each row drawing from its own raw
threefry key (``_random``), so a request's draw depends only on its own
row, never on who else is in the batch."""
from __future__ import annotations

import torch

from ..utils import _random

__all__ = ["sample_tokens"]


def sample_tokens(logp, keys, temperature, top_k, top_p) -> torch.Tensor:
    """One token per row.

    logp:        [S, V] unnormalized log-probabilities.
    keys:        [S, 2] uint32 key words (any integer dtype).
    temperature: [S]; ``<= 0`` means greedy (argmax, key unused).
    top_k:       [S]; ``<= 0`` disables the top-k filter.
    top_p:       [S]; ``>= 1`` disables the nucleus filter.

    Returns [S] int32 token ids.  Filtering happens in descending-logp
    order (a stable sort, as ``jnp.argsort``, so ties keep index order):
    top-k keeps ranks < k, top-p the shortest prefix whose
    temperature-scaled mass reaches p (the top token always survives),
    then a Gumbel-max draw picks among the survivors.
    """
    logp = logp.to(torch.float32)
    V = logp.shape[-1]
    order = torch.argsort(-logp, dim=-1, stable=True)
    sorted_lp = torch.gather(logp, -1, order)
    ranks = torch.arange(V, device=logp.device)[None, :]
    k_eff = torch.where(top_k > 0, top_k, V)[:, None]
    keep = ranks < k_eff
    t_eff = torch.where(temperature > 0, temperature,
                        1.0).to(torch.float32)[:, None]
    scaled = sorted_lp / t_eff
    probs = torch.softmax(scaled, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # keep tokens whose PRECEDING cumulative mass is still below p: the
    # first token past the threshold is included, the rest cut
    keep = keep & ((cum - probs) < top_p.to(torch.float32)[:, None])
    keep[:, 0] = True
    masked = torch.where(keep, scaled, -torch.inf)
    choice = torch.argmax(masked + _random.gumbel(keys, V), dim=-1)
    sampled = torch.gather(order, -1, choice[:, None])[:, 0]
    return torch.where(temperature > 0, sampled,
                       order[:, 0]).to(torch.int32)
