"""Unsupervised, pretrainable layers (port of ``nn/layers/pretrain.py``):
``AutoEncoder``, ``RBM`` and ``VariationalAutoencoder``.

Each declares ``PRETRAINABLE = True`` and has ``pretrain_loss(params, x,
*, key, train) -> scalar``; ``MultiLayerNetwork.pretrain`` trains such a
layer, greedily, on the features of the layers below it.  Parameter names
are the JAX package's (``W``, ``b``, ``vb``; ``e{i}_W``, ``mean_W``,
``logvar_W``, ``d{i}_W``, ``out_W``, ...), so a JAX checkpoint crosses
over unchanged.

Randomness comes from the JAX package's threefry stream
(``utils/_random``): the AutoEncoder's corruption mask with a float keep
probability (float32 uniforms, JAX's x64-off draw), the RBM's Gibbs
samples with a tensor probability (uniforms in its dtype), the VAE's
noise as ``normal(fold_in(key, s))`` per sample.  The RBM's CD-k update is
the gradient of the free-energy difference with the Gibbs sample
detached, so autograd gives the update the reference computes by hand.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, List

import torch

from ...utils import _random
from ...utils.serde import register_serde
from .. import activations as _act
from .. import losses as _losses
from ..conf.input_type import InputType
from ..conf.variational import BernoulliReconstructionDistribution
from .base import BaseLayerConf


class _FeedForwardIn:
    """``n_in`` from a feed-forward (or flattened conv) input type."""

    def set_n_in(self, itype: InputType, override: bool = False) -> None:
        if self.n_in == 0 or override:
            self.n_in = itype.flat_size() if itype.kind == "cnnflat" \
                else itype.size

    def output_type(self, itype: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)


def _visible_init(layer, generator, device, kind: str):
    if layer.n_in <= 0 or layer.n_out <= 0:
        raise ValueError(f"{kind} '{layer.name}': set n_in/n_out")
    return {"W": layer.make_weight(generator, (layer.n_in, layer.n_out),
                                   device),
            "b": layer.make_bias((layer.n_out,), device),
            "vb": layer.make_bias((layer.n_in,), device)}


@register_serde
@dataclass
class AutoEncoder(_FeedForwardIn, BaseLayerConf):
    """Denoising autoencoder: encode ``act(xW + b)``, decode through
    ``W^T``.  ``corruption_level`` zeroes that fraction of the inputs in
    pretraining; ``sparsity`` adds a KL penalty on the mean hidden
    activation."""
    n_in: int = 0
    n_out: int = 0
    corruption_level: float = 0.3
    sparsity: float = 0.0
    sparsity_target: float = 0.05
    visible_loss: str = "mse"      # "mse" | "xent"

    PRETRAINABLE = True
    INPUT_KIND = "ff"

    def init(self, generator, itype, device):
        return _visible_init(self, generator, device, "AutoEncoder")

    def apply(self, params, x, *, train=False, key=None):
        p = self.maybe_noise_weights(params, train, key)
        x = self.maybe_dropout_input(x, train, key)
        return self.act_fn(x @ p["W"] + p["b"])

    def pretrain_loss(self, params, x, *, key=None, train=True):
        p = params
        xin = x
        if train and self.corruption_level > 0 and key is not None:
            keep = _random.bernoulli(key, 1.0 - self.corruption_level,
                                     tuple(x.shape))
            xin = x * keep.to(x.dtype)
        h = self.act_fn(xin @ p["W"] + p["b"])
        z = h @ p["W"].T + p["vb"]
        loss = _losses.get(self.visible_loss)(
            x, z, "sigmoid" if self.visible_loss == "xent" else "identity",
            None)
        if self.sparsity > 0:
            rho = self.sparsity_target
            rho_hat = _act._clip(torch.mean(h, dim=0), 1e-6, 1 - 1e-6)
            kl = rho * torch.log(rho / rho_hat) + \
                (1 - rho) * torch.log((1 - rho) / (1 - rho_hat))
            loss = loss + self.sparsity * torch.sum(kl)
        return loss


@register_serde
@dataclass
class RBM(_FeedForwardIn, BaseLayerConf):
    """Restricted Boltzmann machine, CD-k pretraining: the loss is
    ``mean(F(v_data) - F(v_model))`` with the Gibbs chain's sample
    detached, ``F(v) = -v·vb - Σ softplus(vW + b)`` (minus ``|v|²/2``
    inside ``v·vb`` for Gaussian visible units)."""
    n_in: int = 0
    n_out: int = 0
    k: int = 1
    hidden_unit: str = "binary"    # "binary" | "rectified"
    visible_unit: str = "binary"   # "binary" | "gaussian"

    PRETRAINABLE = True
    INPUT_KIND = "ff"

    def init(self, generator, itype, device):
        return _visible_init(self, generator, device, "RBM")

    def apply(self, params, x, *, train=False, key=None):
        p = self.maybe_noise_weights(params, train, key)
        x = self.maybe_dropout_input(x, train, key)
        pre = x @ p["W"] + p["b"]
        return torch.relu(pre) if self.hidden_unit == "rectified" \
            else torch.sigmoid(pre)

    def free_energy(self, p, v):
        vis = v @ p["vb"]
        if self.visible_unit == "gaussian":
            vis = vis - 0.5 * torch.sum(v * v, dim=-1)
        hid = torch.sum(_act.softplus(v @ p["W"] + p["b"]), dim=-1)
        return -vis - hid

    def gibbs_step(self, p, v, key):
        """One step of the chain from ``v``: ``(h, v2)``, the hidden
        sample and the visible sample, from ``split(key)``."""
        kh, kv = _random.split(key)
        ph = torch.sigmoid(v @ p["W"] + p["b"])
        h = _random.bernoulli(kh, ph).to(v.dtype)
        pre_v = h @ p["W"].T + p["vb"]
        if self.visible_unit == "gaussian":
            v2 = pre_v + _random.normal(kv, tuple(pre_v.shape), pre_v.dtype)
        else:
            v2 = _random.bernoulli(kv, torch.sigmoid(pre_v)).to(v.dtype)
        return h, v2

    def pretrain_loss(self, params, x, *, key=None, train=True):
        if self.hidden_unit != "binary":
            raise ValueError(
                "RBM CD-k pretraining implements binary hidden units only; "
                "the free-energy objective below would not match "
                f"hidden_unit='{self.hidden_unit}' (rectified units are "
                "supported for forward feature extraction)")
        if key is None:
            key = _random.prng_key(0, x.device)
        v = x
        for i in range(max(1, self.k)):
            v = self.gibbs_step(params, v, _random.fold_in(key, i))[1]
        v_model = v.detach()
        return torch.mean(self.free_energy(params, x)
                          - self.free_energy(params, v_model))


_LOG_2PI = math.log(2 * math.pi)


@register_serde
@dataclass
class VariationalAutoencoder(_FeedForwardIn, BaseLayerConf):
    """VAE layer: encoder -> (mean, log variance) -> z -> decoder -> the
    reconstruction distribution's parameters.  The supervised forward is
    the mean of q(z|x) through ``pzx_activation``; pretraining maximises
    the ELBO with the reparameterization trick."""
    n_in: int = 0
    n_out: int = 0                               # latent size
    encoder_layer_sizes: List[int] = field(default_factory=lambda: [100])
    decoder_layer_sizes: List[int] = field(default_factory=lambda: [100])
    pzx_activation: str = "identity"
    reconstruction_distribution: Any = field(
        default_factory=BernoulliReconstructionDistribution)
    num_samples: int = 1

    PRETRAINABLE = True
    INPUT_KIND = "ff"

    def init(self, generator, itype, device):
        if self.n_in <= 0 or self.n_out <= 0:
            raise ValueError(f"VAE '{self.name}': set n_in/n_out")
        params = {}

        def dense(name, n_in, n_out):
            params[f"{name}_W"] = self.make_weight(generator, (n_in, n_out),
                                                   device)
            params[f"{name}_b"] = self.make_bias((n_out,), device)

        last = self.n_in
        for i, size in enumerate(self.encoder_layer_sizes):
            dense(f"e{i}", last, size)
            last = size
        dense("mean", last, self.n_out)
        dense("logvar", last, self.n_out)
        last = self.n_out
        for i, size in enumerate(self.decoder_layer_sizes):
            dense(f"d{i}", last, size)
            last = size
        dense("out", last,
              self.reconstruction_distribution.dist_params_size(self.n_in))
        return params

    def _encode(self, p, x):
        h = x
        for i in range(len(self.encoder_layer_sizes)):
            h = self.act_fn(h @ p[f"e{i}_W"] + p[f"e{i}_b"])
        return h @ p["mean_W"] + p["mean_b"], \
            h @ p["logvar_W"] + p["logvar_b"]

    def _decode(self, p, z):
        h = z
        for i in range(len(self.decoder_layer_sizes)):
            h = self.act_fn(h @ p[f"d{i}_W"] + p[f"d{i}_b"])
        return h @ p["out_W"] + p["out_b"]

    def apply(self, params, x, *, train=False, key=None):
        p = self.maybe_noise_weights(params, train, key)
        x = self.maybe_dropout_input(x, train, key)
        return _act.get(self.pzx_activation)(self._encode(p, x)[0])

    def pretrain_loss(self, params, x, *, key=None, train=True):
        mean, log_var = self._encode(params, x)
        log_var = _act._clip(log_var, -20.0, 20.0)
        kl = 0.5 * torch.sum(torch.exp(log_var) + mean ** 2 - 1.0 - log_var,
                             dim=-1)
        dist = self.reconstruction_distribution
        n = max(1, self.num_samples)
        recon = None
        for s in range(n):
            if key is not None and train:
                eps = _random.normal(_random.fold_in(key, s),
                                     tuple(mean.shape), mean.dtype)
            else:
                eps = torch.zeros_like(mean)
            z = mean + torch.exp(0.5 * log_var) * eps
            nlp = dist.neg_log_prob(x, self._decode(params, z), average=True)
            recon = nlp if recon is None else recon + nlp
        return recon / n + torch.mean(kl)

    # ---- generation (reference generateAtMeanGivenZ etc.) ----
    def generate_at_mean_given_z(self, params, z):
        return self.reconstruction_distribution.mean(self._decode(params, z))

    def generate_random_given_z(self, params, z, key):
        return self.reconstruction_distribution.sample(
            key, self._decode(params, z))

    def reconstruction_probability(self, params, x, key, num_samples=5):
        """Monte-Carlo estimate of log p(x) per example (reference
        ``reconstructionLogProbability``): importance-weighted samples
        ``z = mean + std·normal(fold_in(key, s))``, all ``num_samples``
        decoded in one batch."""
        mean, log_var = self._encode(params, x)
        log_var = _act._clip(log_var, -20.0, 20.0)
        std = torch.exp(0.5 * log_var)
        eps = torch.stack([_random.normal(_random.fold_in(key, s),
                                          tuple(mean.shape), mean.dtype)
                           for s in range(num_samples)])
        z = mean + std * eps                                 # [S, b, n]
        rows = z.shape[0] * z.shape[1]
        preout = self._decode(params, z.reshape(rows, -1))
        xs = x.expand(num_samples, *x.shape).reshape(rows, -1)
        log_pxz = -self.reconstruction_distribution.neg_log_prob(
            xs, preout, per_example=True).reshape(num_samples, -1)
        log_pz = -0.5 * torch.sum(z ** 2 + _LOG_2PI, dim=-1)
        log_qzx = -0.5 * torch.sum(((z - mean) / std) ** 2
                                   + 2 * torch.log(std) + _LOG_2PI, dim=-1)
        return torch.logsumexp(log_pxz + log_pz - log_qzx, dim=0) \
            - math.log(float(num_samples))
