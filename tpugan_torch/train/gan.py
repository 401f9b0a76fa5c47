"""Adversarial StyleGANv1 training (counterpart of ``tpugan/train/gan.py``).

* the losses: logistic non-saturating for G, logistic with the R1
  penalty for D, and the KL and reconstruction terms;
* :func:`generate`: mapping -> dlatent-average EMA -> style mixing ->
  truncation -> synthesis, on explicit draws (:class:`GANDraws`);
* :func:`make_gan_steps`: the alternating D and G steps on a
  :class:`GANTrainState` built by :func:`init_gan_state`;
* :func:`ema_params`: the smoothed generator's lerp;
* :class:`LODSchedule`: the progressive-growing lod, blend and batch size
  as a pure function of the epoch and iteration.

Images are NCHW. The R1 penalty differentiates D's input gradient, so its
backward runs each blur's adjoint FIR again (second order): on a CUDA
tensor every one of those is a launch of the FIR kernel.

The arithmetic on given draws is tpugan's. Two choices follow tpugan
where ALAE differs: the dlatent average is not detached inside the G step
(it is the truncation centre, so G's gradient reaches the mapping through
the batch mean of the styles), and D has no fade-in.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpugan_torch.models.stylegan1 import truncation_coefs
from tpugan_torch.runtime import resolve_device

STYLE_MIXING_PROB = 0.9  # tpugan's generate default, the draws' coin too


def generator_logistic_non_saturating(d_result_fake: torch.Tensor) -> torch.Tensor:
    """softplus(-D(G(z))).mean()."""
    return F.softplus(-d_result_fake).mean()


def discriminator_logistic_simple_gp(d_result_fake: torch.Tensor, d_result_real: torch.Tensor,
                                     r1_grads: Optional[torch.Tensor] = None,
                                     r1_gamma: float = 10.0) -> torch.Tensor:
    """softplus(fake) + softplus(-real), plus the R1 penalty
    ``sum(r1_grads^2) / N * r1_gamma / 2`` where ``r1_grads`` (dD/dx at the
    reals) is given."""
    loss = F.softplus(d_result_fake).mean() + F.softplus(-d_result_real).mean()
    if r1_grads is not None and r1_gamma != 0.0:
        r1 = r1_grads.square().sum() / d_result_real.shape[0]
        loss = loss + r1 * (r1_gamma * 0.5)
    return loss


def kl(mu: torch.Tensor, log_var: torch.Tensor) -> torch.Tensor:
    return -0.5 * (1 + log_var - mu.square() - log_var.exp()).mean(dim=1).mean()


def reconstruction(recon_x: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (recon_x - x).square().mean()


class GANDraws(NamedTuple):
    """The random inputs of one :func:`generate`: the latents z and z2 (the
    mixing latent) [N, latent], the mixing cutoff (a 0-d integer tensor in
    [1, 2 (lod + 1)]), the mixing coin (a 0-d bool tensor) and the
    generator's (n1, n2) noise pair of each block up to the lod."""

    z: torch.Tensor
    z2: torch.Tensor
    cutoff: torch.Tensor
    mix: torch.Tensor
    noise: list


def draw(gen: nn.Module, count: int, latent_size: int, lod: int, rng: torch.Generator) -> GANDraws:
    """Draws for :func:`generate` from ``rng``, on its device, the coin at
    STYLE_MIXING_PROB. z2 is drawn apart from z (tpugan draws both from one
    key, so its mixing latent equals z)."""
    dev = rng.device
    z = torch.randn(count, latent_size, generator=rng, device=dev)
    z2 = torch.randn(count, latent_size, generator=rng, device=dev)
    cutoff = torch.randint(1, 2 * (lod + 1) + 1, (), generator=rng, device=dev)
    mix = torch.rand((), generator=rng, device=dev) < STYLE_MIXING_PROB
    noise = [tuple(torch.randn(s, generator=rng, device=dev) for s in pair)
             for pair in gen.noise_shapes(count, lod)]
    return GANDraws(z, z2, cutoff, mix, noise)


def generate(gen: nn.Module, gm: nn.Module, dlatent_avg: torch.Tensor, lod: int, blend: float,
             draws: GANDraws, dlatent_avg_beta: Optional[float] = 0.995,
             style_mixing_prob: Optional[float] = STYLE_MIXING_PROB, truncation_psi: Optional[float] = 0.7,
             truncation_cutoff: Optional[int] = 8, train: bool = True):
    """Images [N, C, H, W] at ``lod`` and the updated dlatent average. In
    training the average moves towards the batch mean of the styles and
    the styles of layers from ``draws.cutoff`` on are z2's where
    ``draws.mix`` is true; the truncation pulls towards the updated
    average."""
    styles = gm(draws.z)
    if train and dlatent_avg_beta is not None:
        dlatent_avg = dlatent_avg + (styles.mean(dim=0) - dlatent_avg) * (1.0 - dlatent_avg_beta)
    if train and style_mixing_prob is not None:
        styles2 = gm(draws.z2)
        layer_idx = torch.arange(styles.shape[1], device=styles.device)[None, :, None]
        mixed = torch.where(layer_idx < draws.cutoff, styles, styles2)
        styles = torch.where(draws.mix, mixed, styles)
    if truncation_psi is not None:
        coefs = truncation_coefs(styles.shape[1], truncation_psi, truncation_cutoff).to(styles)
        styles = dlatent_avg[None] + (styles - dlatent_avg[None]) * coefs
    return gen(styles, lod, draws.noise, blend=blend), dlatent_avg


@dataclasses.dataclass
class GANTrainState:
    """The networks, their optimizers (``g_opt`` over gen's and gm's
    parameters, ``d_opt`` over disc's), the dlatent average
    [num_layers, dlatent], the draws' generator and the count of D steps."""

    gen: nn.Module
    gm: nn.Module
    disc: nn.Module
    g_opt: torch.optim.Optimizer
    d_opt: torch.optim.Optimizer
    dlatent_avg: torch.Tensor
    rng: torch.Generator
    step: int = 0


def init_gan_state(gen: nn.Module, gm: nn.Module, disc: nn.Module, g_opt: torch.optim.Optimizer,
                   d_opt: torch.optim.Optimizer, device="cuda", seed: int = 0) -> GANTrainState:
    """The state with the networks moved to ``device`` (the card unless the
    CPU is asked for; the optimizers must not have stepped yet), a zero
    dlatent average and a draws generator seeded with ``seed``."""
    dev = resolve_device(device)
    for module in (gen, gm, disc):
        module.to(dev)
    last = getattr(gm, f"block_{gm.mapping_layers}").fc
    dlatent_avg = torch.zeros(gm.num_layers, last.weight.shape[0], device=dev)
    return GANTrainState(gen, gm, disc, g_opt, d_opt, dlatent_avg, torch.Generator(device=dev).manual_seed(seed))


def _update(opt: torch.optim.Optimizer, loss: torch.Tensor) -> None:
    """One update of ``opt``'s parameters from ``loss``'s gradient; a
    parameter that the loss does not reach (a ``to_rgb`` or ``from_rgb`` of
    another lod) gets none."""
    params = [p for group in opt.param_groups for p in group["params"]]
    for p, g in zip(params, torch.autograd.grad(loss, params, allow_unused=True)):
        p.grad = g
    opt.step()
    opt.zero_grad(set_to_none=True)


def make_gan_steps(lod: int, blend: float = 1.0, latent_size: int = 512, r1_gamma: float = 10.0):
    """The alternating steps at ``lod`` and ``blend``:
    ``d_step(state, reals, draws=None)`` (reals [N, C, H, W]) and
    ``g_step(state, batch_size, draws=None)``, each returning the state,
    updated in place, and the loss. Draws absent are drawn from
    ``state.rng``. The D step generates without a graph, takes R1 from
    ``torch.autograd.grad(..., create_graph=True)`` and counts ``step``."""

    def d_step(state: GANTrainState, reals: torch.Tensor, draws: Optional[GANDraws] = None):
        if draws is None:
            draws = draw(state.gen, reals.shape[0], latent_size, lod, state.rng)
        with torch.no_grad():
            fakes, dlatent_avg = generate(state.gen, state.gm, state.dlatent_avg, lod, blend, draws)
        reals = reals.detach().requires_grad_(r1_gamma != 0.0)
        d_real = state.disc(reals, lod).squeeze(-1)
        r1_grads = None
        if r1_gamma != 0.0:
            (r1_grads,) = torch.autograd.grad(d_real.sum(), reals, create_graph=True)
        d_fake = state.disc(fakes, lod).squeeze(-1)
        loss = discriminator_logistic_simple_gp(d_fake, d_real, r1_grads, r1_gamma)
        _update(state.d_opt, loss)
        state.dlatent_avg = dlatent_avg
        state.step += 1
        return state, loss.detach()

    def g_step(state: GANTrainState, batch_size: int, draws: Optional[GANDraws] = None):
        if draws is None:
            draws = draw(state.gen, batch_size, latent_size, lod, state.rng)
        fakes, dlatent_avg = generate(state.gen, state.gm, state.dlatent_avg, lod, blend, draws)
        loss = generator_logistic_non_saturating(state.disc(fakes, lod).squeeze(-1))
        _update(state.g_opt, loss)
        state.dlatent_avg = dlatent_avg.detach()
        return state, loss.detach()

    return d_step, g_step


@torch.no_grad()
def ema_params(slow: nn.Module, fast: nn.Module, beta: float = 0.999) -> nn.Module:
    """The smoothed generator's lerp, in place: each parameter of ``slow``
    becomes ``s + (f - s) * (1 - beta)``; returns ``slow``."""
    for s, f in zip(slow.parameters(), fast.parameters()):
        s.copy_(s + (f - s) * (1.0 - beta))
    return slow


@dataclasses.dataclass(frozen=True)
class LODSchedule:
    """Progressive-growing schedule as a pure function of epoch and
    iteration: ``epochs_per_lod`` epochs a lod, the first half of each
    (past lod 0) a sinusoidal fade-in."""

    lod_2_batch: tuple = (128, 128, 128, 64, 32, 16)
    epochs_per_lod: int = 15
    dataset_size: int = 60000
    max_lod: int = 5

    def lod(self, epoch: int) -> int:
        return min(epoch // self.epochs_per_lod, self.max_lod)

    def batch_size(self, epoch: int) -> int:
        return self.lod_2_batch[min(self.lod(epoch), len(self.lod_2_batch) - 1)]

    def in_transition(self, epoch: int) -> bool:
        return (epoch % self.epochs_per_lod) < (self.epochs_per_lod // 2) and self.lod(epoch) > 0

    def blend(self, epoch: int, iteration: int) -> float:
        if not self.in_transition(epoch):
            return 1.0
        b = float((epoch % self.epochs_per_lod) * self.dataset_size + iteration)
        b /= float(max(1, self.epochs_per_lod // 2) * self.dataset_size)
        return math.sin(b * math.pi - 0.5 * math.pi) * 0.5 + 0.5
