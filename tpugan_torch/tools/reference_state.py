"""Random state dicts in the reference's formats, for converter checks.

Each function returns ``{reference key: numpy float32}`` with the key names
and shapes of the reference's checkpoints (StyleGANv1's ``Gs``/``Gm``/
center, StyleGAN2's and PGGAN's generators, BigGAN with ``weight_orig``/
``_u``/``_v`` triplets, E, E_PG, E_BIG, torchvision's VGG16, the official
LPIPS), filled from a numpy seed. The shapes come from this package's
modules, built on the meta device (no values, no time), renamed to the
reference's keys: the inverse of ``tpugan_torch/io/convert.py``'s maps,
which the converter tests check against ``tpugan``'s converters. :func:`save` writes one with ``torch.save``
as the reference does. Real weights are not in the repository; these stand
in for them.
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from tpugan_torch.io.convert import VGG16_CONV_IDX, VGG16_FC_IDX

# the official LPIPS slices of torchvision's VGG16 features (lpips/pretrained_networks.py)
_LPIPS_SLICES = ((0, 4), (4, 9), (9, 16), (16, 23), (23, 30))


def _shapes(make) -> dict:
    with torch.device("meta"):
        module = make()
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


def _fill(rng: np.random.Generator, key: str, shape: tuple, plain: bool = False) -> np.ndarray:
    """A random leaf: N(0, 1) kernels (He-scaled for plain layers, which
    carry no runtime scale), positive variances, small 1-D leaves."""
    if key.endswith("running_vars"):
        return rng.uniform(0.5, 1.5, shape).astype(np.float32)
    if len(shape) >= 2:
        gain = np.sqrt(2.0 / np.prod(shape[1:])) if plain else 1.0
        return (rng.standard_normal(shape, dtype=np.float32) * gain).astype(np.float32)
    return (0.1 * rng.standard_normal(shape, dtype=np.float32)).astype(np.float32)


def _chan(shape: tuple) -> tuple:
    return (1, shape[0], 1, 1)


def stylegan1(rng, startf: int, maxf: int, layer_count: int, latent: int = 512):
    """``(Gs_dict, Gm_dict, center)`` of StyleGANv1 (model/stylegan1/net.py);
    the center is ``[1, 2 * layer_count, latent]``."""
    from tpugan_torch.models import StyleGANv1Generator, StyleGANv1Mapping

    gs = {}
    for k, shape in _shapes(lambda: StyleGANv1Generator(startf=startf, maxf=maxf, layer_count=layer_count,
                                                        latent_size=latent)).items():
        ref = re.sub(r"^decode_block_(\d+)\.", r"decode_block.\1.", k)
        ref = re.sub(r"^to_rgb_(\d+)\.", r"to_rgb.\1.", ref)
        if re.search(r"\.(noise_weight|bias)_\d$", ref):
            shape = _chan(shape)
        gs[ref] = _fill(rng, ref, shape)
    gm = {k: _fill(rng, k, shape) for k, shape in _shapes(
        lambda: StyleGANv1Mapping(num_layers=2 * layer_count, mapping_layers=8, latent_size=latent,
                                  dlatent_size=latent, mapping_fmaps=latent)).items()}
    center = rng.standard_normal((1, 2 * layer_count, latent), dtype=np.float32)
    return gs, gm, center


def stylegan2(rng, make) -> dict:
    """The generator's own dict of StyleGAN2 (model/stylegan2_generator.py)
    for the module ``make()`` builds, with its ``lod`` buffer, which the
    converters skip. Wrap it as ``{"generator_smooth": state}`` or with the
    ``generator_smooth.`` prefix as the reference's files hold it."""
    state = {}
    for k, shape in _shapes(make).items():
        ref = "synthesis.early_layer.const" if k == "synthesis.const" else k
        state[ref] = _fill(rng, ref, shape)
    state["synthesis.lod"] = np.zeros((), np.float32)
    return state


def pggan(rng, make) -> dict:
    """PGGAN's generator (GenForce's model/pggan/pggan_generator.py) for the
    module ``make()`` builds: ``layer<i>``/``output<i>`` weights, N(0, 1)
    as the reference keeps them unscaled, and its ``lod`` buffer, which
    the converter skips. Wrap it as :func:`stylegan2`'s dict."""
    state = {k: _fill(rng, k, shape) for k, shape in _shapes(make).items()}
    state["lod"] = np.zeros((), np.float32)
    return state


def encoder(rng, make) -> dict:
    """E / E_Blur / E_PG (model/E/*.py) for the module ``make()`` builds;
    E_PG's ``new_final`` is drawn in the shape of the (c, h, w) flatten,
    the same as the port's."""
    state = {}
    for k, shape in _shapes(make).items():
        ref = re.sub(r"^from_rgb\.", "FromRGB.from_rgb.", k)
        ref = re.sub(r"^block_(\d+)\.", r"decode_block.\1.", ref)
        ref = ref.replace("in3_scale", "instance_norm_3.weight").replace("in3_bias", "instance_norm_3.bias")
        if re.search(r"\.(noise_weight|bias)_\d$", ref):
            shape = _chan(shape)
        state[ref] = _fill(rng, ref, shape)
    return state


def _sn_triplet(rng, state: dict, base: str, shape: tuple, u: bool = True, v: bool = True) -> None:
    """``weight_orig`` and, as a trained checkpoint holds them, its
    spectral norm's ``u``/``v`` converged by power iteration (from a random
    unit ``u``); a random pair would make sigma arbitrarily small."""
    w = _fill(rng, base, shape)
    state[base + "_orig"] = w
    w_mat = w.reshape(shape[0], -1).astype(np.float64)
    uu = rng.standard_normal(shape[0])
    for _ in range(30):
        vv = w_mat.T @ uu
        vv /= np.linalg.norm(vv)
        uu = w_mat @ vv
        uu /= np.linalg.norm(uu)
    if u:
        state[base + "_u"] = uu.astype(np.float32)
    if v:
        state[base + "_v"] = vv.astype(np.float32)


def biggan(rng, cfg) -> dict:
    """BigGAN-deep (pytorch-pretrained-BigGAN's ``G-*.pt``) for ``cfg``:
    every generator conv and linear as a spectral-norm triplet, except
    ``conv_to_rgb``, which lacks ``_u``, and ``gen_z``, which lacks ``_v``
    (:func:`~tpugan_torch.io.convert.fold_spectral_norm` makes them). The
    class embedding is a plain linear layer, He-scaled: N(0, 1) entries
    would make the condition vector [z, embedding] about 30 times z's size,
    and E_BIG's conditional batch norms, which scale by 1 + a linear map of
    it, overflow fp32 over its seven blocks."""
    from tpugan_torch.models import BigGAN

    state = {}
    for k, shape in _shapes(lambda: BigGAN(cfg)).items():
        ref = re.sub(r"^generator\.layers_(\d+)\.", r"generator.layers.\1.", k)
        if ref.startswith("generator.") and ref.endswith(".weight") and len(shape) >= 2:
            _sn_triplet(rng, state, ref, shape, u="conv_to_rgb" not in ref, v="gen_z" not in ref)
        else:
            state[ref] = _fill(rng, ref, shape, plain=ref == "embeddings.weight")
    return state


def biggan_encoder(rng, make) -> dict:
    """E_BIG (model/E/E_BIG.py) for the module ``make()`` builds: the
    conditional batch norms' linears as spectral-norm triplets, and
    ``new_final_1`` over the (c, h, w) flatten of the last map. The
    convolutions' kernels are drawn at a tenth of N(0, 1): the batch norms
    run on drawn running statistics, which do not renormalise the
    activations as a trained checkpoint's do, and at N(0, 1) each block
    grows them about a hundredfold, past fp32's range at 256 px."""
    state = {}
    for k, shape in _shapes(make).items():
        ref = re.sub(r"^from_rgb\.", "FromRGB.from_rgb.", k)
        ref = re.sub(r"^block_(\d+)\.", r"decode_block.\1.", ref)
        if re.search(r"\.(noise_weight|bias)_\d$", ref):
            shape = _chan(shape)
        if re.search(r"\.(scale|offset)\.(u|v)$", ref):
            continue
        if re.search(r"\.(scale|offset)\.weight$", ref):
            _sn_triplet(rng, state, ref, shape)
        else:
            state[ref] = _fill(rng, ref, shape) * (0.1 if re.search(r"conv_\d\.weight$", ref) else 1.0)
    return state


def vgg16(rng, num_classes: int = 1000) -> dict:
    """torchvision's VGG16 with its classifier (``features.{idx}``,
    ``classifier.{0,3,6}``)."""
    from tpugan_torch.losses.vgg import VGG16

    state = {}
    for k, shape in _shapes(lambda: VGG16(num_classes=num_classes)).items():
        if m := re.match(r"conv_(\d+)\.(weight|bias)$", k):
            ref = f"features.{VGG16_CONV_IDX[int(m.group(1))]}.{m.group(2)}"
        else:
            m = re.match(r"head\.fc_(\d)\.(weight|bias)$", k)
            ref = f"classifier.{VGG16_FC_IDX[int(m.group(1))]}.{m.group(2)}"
        state[ref] = _fill(rng, ref, shape, plain=True)
    return state


def lpips(rng) -> dict:
    """The official LPIPS (``net='vgg'``): the backbone under
    ``net.slice{1..5}.{idx}``, the heads ``lin{k}.model.1.weight`` (non-
    negative, as the published ones are)."""
    from tpugan_torch.losses.lpips import LPIPS

    state = {}
    for k, shape in _shapes(LPIPS).items():
        if m := re.match(r"backbone\.conv_(\d+)\.(weight|bias)$", k):
            idx = VGG16_CONV_IDX[int(m.group(1))]
            part = next(i for i, (a, b) in enumerate(_LPIPS_SLICES) if a <= idx < b) + 1
            ref = f"net.slice{part}.{idx}.{m.group(2)}"
            state[ref] = _fill(rng, ref, shape, plain=True)
        else:
            j = re.match(r"lin_(\d)\.weight$", k).group(1)
            state[f"lin{j}.model.1.weight"] = np.abs(_fill(rng, k, shape, plain=True))
    return state


def save(path: str, state) -> str:
    """``torch.save`` a (possibly nested) numpy state dict as tensors."""
    def tensors(x):
        return {k: tensors(v) for k, v in x.items()} if isinstance(x, dict) else torch.from_numpy(np.asarray(x))

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(tensors(state), path)
    return path
