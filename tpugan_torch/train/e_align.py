"""Encoder alignment (counterpart of ``tpugan/train/e_align.py``): the
frozen generators' synth/resynth closures (StyleGANv1, mtype 1; StyleGAN2,
mtype 2; BigGAN, mtype 4), the encode closure, and the train step of cases
1 and 2 and of the ablation ladder.

Images cross this boundary NHWC, as in ``tpugan``; the models run NCHW.
Noise and labels are explicit everywhere: the caller draws them
(:func:`draw_noise`, :func:`draw_biggan_request`) or passes ``None`` for no
noise injection.

The serving closures run under ``torch.no_grad()``. The train step takes
closures made with ``train=True``: an encode that records gradients and a
resynthesis differentiable with respect to w2, through a generator whose
parameters take no gradient, as ``jax.grad`` with respect to the encoder's
parameters computes only activation gradients there.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from tpugan_torch.losses.space_loss import SpaceLossInfo, space_loss, zero_space_info
from tpugan_torch.models.biggan import BigGAN
from tpugan_torch.models.stylegan1 import StyleGANv1Generator, StyleGANv1Mapping, truncation_coefs
from tpugan_torch.models.stylegan2 import StyleGAN2Generator
from tpugan_torch.nn.spectral import SNDense, power_iterate
from tpugan_torch.optim.lreq_adam import LREQAdam
from tpugan_torch.utils import iteration_generator, one_hot, truncated_noise_sample

# BigGAN's truncation in the encoder pipeline (E_align_cropping_s1.py:140-150)
BIGGAN_TRUNCATION = 0.4


class SynthBatch(NamedTuple):
    """A frozen-generator sample: latents, target images [N, H, W, C], the
    generator const [N, C, 4, 4] (BigGAN: the condition vector [N, 2 z_dim])
    and, for BigGAN, the one-hot class label."""

    w1: torch.Tensor
    imgs1: torch.Tensor
    const1: torch.Tensor
    label: Any = None


def nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


class Request(NamedTuple):
    """One pass's inputs: z [N, z_dim] (BigGAN: truncated), the noise of
    each pass (synthesis, encoder, resynthesis; ``None`` for BigGAN's
    generator, which has none) and BigGAN's one-hot label [N, classes]."""

    z: torch.Tensor
    noise_g: list | None
    noise_e: list
    noise_g2: list | None
    label: torch.Tensor | None = None

    def to(self, device) -> "Request":
        def move(blocks):
            if blocks is None:
                return None
            return [tuple(n.to(device) for n in block) for block in blocks]

        return Request(self.z.to(device), move(self.noise_g), move(self.noise_e),
                       move(self.noise_g2), None if self.label is None else self.label.to(device))


def draw_noise(shapes, generator: torch.Generator) -> list:
    """One standard-normal tensor per shape of a model's ``noise_shapes``,
    drawn in order on the generator's device."""
    return [
        tuple(torch.randn(s, generator=generator, device=generator.device) for s in block)
        for block in shapes
    ]


def draw_biggan_request(encoder, num_classes: int, z_dim: int, img_size: int,
                        batch_size: int, seed: int, device) -> Request:
    """The mtype-4 draws of seed ``seed % 30000`` on ``device``, in order:
    truncated zt, one class shared by the batch (``tpugan/cli/common.py:
    273-283``), E_BIG's noise. Requests and train steps draw alike."""
    g = iteration_generator(seed, device)
    zt = truncated_noise_sample(batch_size, z_dim, BIGGAN_TRUNCATION, generator=g)
    flag = torch.randint(0, num_classes, (1,), generator=g, device=device)
    label = one_hot(flag.expand(batch_size), num_classes)
    noise_e = draw_noise(encoder.noise_shapes(batch_size, img_size), g)
    return Request(zt, None, noise_e, None, label)


def build_stylegan1_pipeline(
    gen: StyleGANv1Generator,
    gm: StyleGANv1Mapping,
    lod: int,
    psi: float = 0.7,
    center: Optional[torch.Tensor] = None,
    train: bool = False,
):
    """Frozen StyleGANv1 synth/resynth closures (mtype 1):
    ``w1 = Gm(z, coefs)``, ``imgs1 = Gs(w1, lod)`` and ``imgs2 = Gs(w2, lod)``.

    ``synth(z, noise) -> SynthBatch`` and ``resynth(w2, batch, noise) ->
    images``, with ``noise`` as from ``gen.noise_shapes`` (or ``None``). With
    ``train`` the resynthesis records the graph back to w2, and G and the
    mapping take no gradient (``requires_grad_(False)``); synth never does.
    """
    coefs = truncation_coefs(gm.num_layers, psi)
    if train:
        gen.requires_grad_(False)
        gm.requires_grad_(False)

    @torch.no_grad()
    def synth(z: torch.Tensor, noise=None) -> SynthBatch:
        w1 = gm(z, coefs, center)
        imgs1 = nchw_to_nhwc(gen(w1, lod, noise))
        const1 = gen.const.expand(z.shape[0], -1, -1, -1)
        return SynthBatch(w1=w1, imgs1=imgs1, const1=const1)

    def resynth(w2: torch.Tensor, batch: SynthBatch, noise=None) -> torch.Tensor:
        return nchw_to_nhwc(gen(w2, lod, noise))

    return synth, (resynth if train else torch.no_grad()(resynth))


def build_stylegan2_pipeline(gen: StyleGAN2Generator, train: bool = False):
    """Frozen StyleGAN2 synth/resynth closures (mtype 2, as
    ``tpugan/cli/common.py:184-192``): ``imgs1 = G(z)`` truncated at psi 0.7
    in the first 8 layers, ``const1`` the synthesis const expanded to the
    batch, and ``imgs2 = G.synthesize(w2)``.

    ``synth(z, noise=None) -> SynthBatch`` and ``resynth(w2, batch=None,
    noise=None) -> images``; both read the generator's noise buffers, so any
    other ``noise`` raises. With ``train`` the resynthesis records the graph
    back to w2 and G takes no gradient (``requires_grad_(False)``); synth
    never does.
    """
    if train:
        gen.requires_grad_(False)

    def buffers_only(noise):
        if noise is not None:
            raise ValueError("StyleGAN2 reads its noise buffers: pass noise=None")

    @torch.no_grad()
    def synth(z: torch.Tensor, noise=None) -> SynthBatch:
        buffers_only(noise)
        out = gen(z, trunc_psi=0.7, trunc_layers=8)
        const1 = gen.synthesis.const.expand(z.shape[0], -1, -1, -1)
        return SynthBatch(w1=out["wp"], imgs1=nchw_to_nhwc(out["image"]), const1=const1)

    def resynth(w2: torch.Tensor, batch=None, noise=None) -> torch.Tensor:
        buffers_only(noise)
        return nchw_to_nhwc(gen.synthesize(w2)["image"])

    return synth, (resynth if train else torch.no_grad()(resynth))


def build_biggan_pipeline(model: BigGAN, train: bool = False):
    """Frozen BigGAN synth/resynth closures (mtype 4):
    ``(imgs1, cond) = G(zt, label)`` and ``imgs2 = G(w2, label)`` with the
    same label (E_align_cropping_s1.py:140-162), both at
    ``BIGGAN_TRUNCATION``, the truncation ``draw_biggan_request`` draws
    ``zt`` at.

    ``synth(zt, label) -> SynthBatch`` takes the truncated latents and the
    one-hot labels the caller drew; ``resynth(w2, batch, noise=None)``
    regenerates with ``batch.label``. BigGAN has no generator noise. With
    ``train`` the resynthesis records the graph back to w2 (the model's own
    parameters should take no gradient: ``model.requires_grad_(False)``).
    """

    @torch.no_grad()
    def synth(zt: torch.Tensor, label: torch.Tensor) -> SynthBatch:
        imgs1, cond = model(zt, label, BIGGAN_TRUNCATION)
        return SynthBatch(w1=zt, imgs1=nchw_to_nhwc(imgs1), const1=cond, label=label)

    def resynth(w2: torch.Tensor, batch: SynthBatch, noise=None) -> torch.Tensor:
        if noise is not None:
            raise ValueError("BigGAN takes no generator noise")
        imgs2, _ = model(w2, batch.label, BIGGAN_TRUNCATION)
        return nchw_to_nhwc(imgs2)

    return synth, (resynth if train else torch.no_grad()(resynth))


def make_encode_fn(encoder, conditional: bool = False, train: bool = False):
    """Encode closure: ``(batch, noise) -> (const2, w2)`` on ``batch.imgs1``;
    a ``conditional`` encoder (E_BIG) also reads the condition vector
    ``batch.const1`` (E_align_cropping_s1.py:155). With ``train`` it records
    the graph for the encoder's gradients."""

    def encode(batch: SynthBatch, noise=None):
        imgs = nhwc_to_nchw(batch.imgs1)
        if conditional:
            return encoder(imgs, batch.const1, noise)
        return encoder(imgs, noise)

    return encode if train else torch.no_grad()(encode)


# ---------------------------------------------------------------------------
# the train step (tpugan/train/e_align.py:38-97, 156-435)


class StepInfo(NamedTuple):
    loss_imgs: SpaceLossInfo
    loss_medium: SpaceLossInfo
    loss_small: SpaceLossInfo
    loss_w: SpaceLossInfo
    loss_c: SpaceLossInfo
    loss_tsa: torch.Tensor
    loss_mtv: torch.Tensor


def info_scalars(info: StepInfo) -> dict:
    """The reference's full scalar set (every SpaceLossInfo field of every
    loss group, and the totals) as floats, with one host sync."""
    names, values = [], []
    for name, val in info._asdict().items():
        if hasattr(val, "_asdict"):
            for field, v in val._asdict().items():
                names.append(f"{name}_{field}")
                values.append(v)
        else:
            names.append(name)
            values.append(val)
    host = torch.stack([v.detach().float().reshape(()) for v in values]).tolist()
    return dict(zip(names, host))


def attention_crops(imgs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """AT1/AT2 center crops for aligned data (NHWC): AT1 keeps the height
    and the middle 3/4 of the width (E_align_cropping_s1.py:188); AT2 crops
    both by 1/8 + 1/32 per side (:193-199)."""
    h, w = imgs.shape[1], imgs.shape[2]
    at1 = imgs[:, :, w // 8 : w - w // 8, :]
    dh = h // 8 + h // 32
    dw = w // 8 + w // 32
    return at1, imgs[:, dh : h - dh, dw : w - dw, :]


@dataclasses.dataclass
class EncoderTrainState:
    """The encoder (its parameters and its spectral norms' ``u``/``v``
    buffers, which the step updates in place), its optimizer and the count
    of steps taken."""

    encoder: torch.nn.Module
    optimizer: LREQAdam
    step: int = 0


def init_train_state(encoder: torch.nn.Module, optimizer: LREQAdam) -> EncoderTrainState:
    return EncoderTrainState(encoder=encoder, optimizer=optimizer)


def make_train_step(
    encode: Callable,
    synth: Callable[[Request], SynthBatch],
    resynth: Callable,
    draw: Callable[[int], Request],
    case: int = 1,
    lpips_fn=None,
    compute_image_losses: bool = True,
    image_weights: Optional[tuple] = None,
    latent_weights: Optional[tuple] = None,
    detach_image_losses: Optional[bool] = None,
    sequential_image_steps: bool = False,
):
    """Build the per-iteration train step ``step(state, iteration) ->
    (state, StepInfo)``, which updates ``state`` in place.

    ``draw(iteration)`` gives the iteration's inputs (seed ``iteration %
    30000``), ``synth(request)`` the frozen generator's batch (no
    gradient), ``encode(batch, noise)`` and ``resynth(w2, batch, noise)``
    the train-mode closures. Each step first advances the encoder's
    spectral norms by one power iteration (``tpugan/train/e_align.py:328``).

    * case 1 (E_align_cropping_s1.py): the image losses are computed without
      gradient and only logged; one update on ``0.01 * loss_w``.
    * case 2 (E_align_s2.py): ``loss_tsa = imgs + 5*AT1 + 9*AT2``; the
      gradients of loss_tsa and of ``0.01 * loss_w`` are both taken at the
      iteration's initial parameters from one forward, then applied by two
      sequential optimizer updates (:364-385).

    The ablation ladder (ablation_utils/1..8) sets ``image_weights=(full,
    at1, at2)``, ``latent_weights=(w, c)`` (each scaled by 0.01) and
    ``detach_image_losses``; ``None`` keeps the case's. With
    ``sequential_image_steps`` (ablations 7 and 8, :339-363) a case-2 step
    takes one gradient per loss group from the one forward, imgs, wm·AT1,
    ws·AT2, then the latent loss, all at the iteration's initial
    parameters, and applies them in that order, one LREQAdam update each; a
    group of weight 0 takes none. With an adaptive optimizer that is not
    one combined step.

    ``compute_image_losses=False`` is the lean case-1 step of off-tick
    iterations: no resynthesis and no image losses, their info zero; the
    parameter trajectory is the full step's, bit for bit. It needs detached
    image losses.
    """
    if case not in (1, 2):
        raise ValueError(f"case must be 1 or 2, got {case}")
    if image_weights is None:
        image_weights = (1.0, 1.0, 1.0) if case == 1 else (1.0, 5.0, 9.0)
    if latent_weights is None:
        latent_weights = (1.0, 0.0)  # loss_c is left out in both scripts (:216)
    if detach_image_losses is None:
        detach_image_losses = case == 1
    if not compute_image_losses and not detach_image_losses:
        raise ValueError(
            "compute_image_losses=False needs detached (log-only) image losses; with "
            "gradients through them (case 2, the ablations) the lean step would change the "
            "trajectory"
        )

    def image_losses(batch: SynthBatch, w2, noise_g2):
        imgs2 = resynth(w2, batch, noise_g2)
        l_imgs, i_imgs = space_loss(batch.imgs1, imgs2, lpips_fn=lpips_fn)
        at1_1, at2_1 = attention_crops(batch.imgs1)
        at1_2, at2_2 = attention_crops(imgs2)
        l_med, i_med = space_loss(at1_1, at1_2, lpips_fn=lpips_fn)
        l_small, i_small = space_loss(at2_1, at2_2, lpips_fn=lpips_fn)
        return (l_imgs, l_med, l_small), (i_imgs, i_med, i_small)

    def losses(batch: SynthBatch, request: Request):
        const2, w2 = encode(batch, request.noise_e)
        if not compute_image_losses:
            zero = torch.zeros((), device=w2.device)
            parts, infos = (zero,) * 3, (zero_space_info(w2.device),) * 3
        elif detach_image_losses:
            # the reference detaches both sides of every image-space loss
            # (E_align_cropping_s1.py:185-201): log-only, no gradient
            with torch.no_grad():
                parts, infos = image_losses(batch, w2, request.noise_g2)
        else:
            parts, infos = image_losses(batch, w2, request.noise_g2)
        weighted = [w * part for w, part in zip(image_weights, parts)]
        loss_tsa = weighted[0] + weighted[1] + weighted[2]
        l_w, i_w = space_loss(batch.w1, w2, image_space=False)
        const1 = batch.const1
        if const2.dim() == 4:
            # feature maps enter the losses NHWC, as tpugan's do: the KL's
            # softmax runs over the last axis of a 4-D input, the channels
            const1, const2 = nchw_to_nhwc(const1), nchw_to_nhwc(const2)
        l_c, i_c = space_loss(const1, const2, image_space=False)
        ww, wc = latent_weights
        loss_mtv = 0.01 * (ww * l_w + wc * l_c)
        info = StepInfo(*infos, loss_w=i_w, loss_c=i_c, loss_tsa=loss_tsa, loss_mtv=loss_mtv)
        return loss_tsa, loss_mtv, weighted, _detached(info)

    def step(state: EncoderTrainState, iteration: int):
        request = draw(iteration)
        batch = synth(request)
        power_iterate(state.encoder)
        params = list(state.encoder.parameters())
        loss_tsa, loss_mtv, weighted, info = losses(batch, request)
        if case == 1:
            groups = [loss_mtv]
        elif sequential_image_steps:
            groups = [g for g, w in zip(weighted, image_weights) if w != 0.0] + [loss_mtv]
        else:
            groups = [loss_tsa, loss_mtv]
        # every gradient from the one forward, before any update moves the
        # parameters that it saved
        grads = [_grad(loss, params, retain=i + 1 < len(groups)) for i, loss in enumerate(groups)]
        for g in grads:
            state.optimizer.step(g)
        state.step += 1
        return state, info

    return step


def _grad(loss: torch.Tensor, params: list, retain: bool):
    """The gradient of ``loss`` with respect to ``params`` (None where it
    does not reach one, and for all where the loss is detached)."""
    if not loss.requires_grad:
        return [None] * len(params)
    return torch.autograd.grad(loss, params, retain_graph=retain, allow_unused=True)


def _detached(info: StepInfo) -> StepInfo:
    def leaf(x):
        return SpaceLossInfo(*(v.detach() for v in x)) if isinstance(x, SpaceLossInfo) else x.detach()

    return StepInfo(*(leaf(x) for x in info))


def make_align_visuals(encode, synth, resynth, draw):
    """The on-tick reconstruction grid of the aligned CLI
    (E_align_cropping_s1.py:282-285): the iteration's imgs1 and imgs2 at
    the iteration's initial parameters, after the same single power
    iteration the step applies before encoding. The spectral norms' buffers
    are put back afterwards, so the step that follows starts from the same
    pair. Returns ``visuals(state, iteration) -> {"imgs1", "imgs2"}``."""

    @torch.no_grad()
    def visuals(state: EncoderTrainState, iteration: int):
        request = draw(iteration)
        batch = synth(request)
        sn = [m for m in state.encoder.modules() if isinstance(m, SNDense)]
        saved = [(m.u.clone(), m.v.clone()) for m in sn]
        power_iterate(state.encoder)
        _, w2 = encode(batch, request.noise_e)
        imgs2 = resynth(w2, batch, request.noise_g2)
        for m, (u, v) in zip(sn, saved):
            m.u.copy_(u)
            m.v.copy_(v)
        return {"imgs1": batch.imgs1, "imgs2": imgs2}

    return visuals
