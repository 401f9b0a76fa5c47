"""Checkpoint converters: the reference's torch state dicts -> this
package's modules (counterpart of ``tpugan/io/convert.py``).

The reference's formats (SURVEY.md §5):

* StyleGANv1's three files, ``Gs_dict.pth``, ``Gm_dict.pth`` and
  ``center_tensor.pt`` (readme.md:67-71; E_align_cropping_s1.py:30-35);
* StyleGAN2's and PGGAN's single ``.pth`` holding ``generator_smooth``
  (or ``generator``), nested or as a key prefix (:52-55, 70-74);
* BigGAN's ``.pt`` with a config JSON (:82-84), its spectral norms folded;
* torchvision's VGG16 and the official LPIPS (VGG) state dicts;
* the trained encoders' state dicts (model/E/*.py), E_BIG's spectral-norm
  ``weight_u``/``weight_v`` kept live in its ``SNDense`` buffers.

The reference and the port are both NCHW with OIHW kernels, ``[out, in]``
dense weights and ``[in, out, kh, kw]`` transposed-conv kernels (SGv1's
fused up-sampling ``conv_1``), so each converter renames the reference's
keys to the port module's own ``state_dict`` names and reshapes per-channel
leaves (``[1, C, 1, 1]`` -> ``[C]``); no kernel is transposed (PGGAN's
fused up-sampling convs stay ``[in, out, kh, kw]`` in both). Flattens:
VGG16's classifier flattens its 7x7 map (c, h, w), torchvision's order, so
``classifier.0`` is copied as it is; E_BIG's ``new_final_1`` and E_PG's
``new_final`` read the last map in ``tpugan``'s (h, w, c) order, so their
input columns are reordered from the reference's (c, h, w).

Every converter is a pure dict -> dict map over numpy arrays;
:func:`load_torch_state_dict` reads a file, :func:`load_state` copies a
converted dict into a module and :func:`built` makes one from it. This
module imports nothing of ``tpugan``.
"""

from __future__ import annotations

import pickle
import re
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

State = Dict[str, np.ndarray]


def _np(value):
    if isinstance(value, Mapping):
        return {k: _np(v) for k, v in value.items()}
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def load_torch_state_dict(path) -> dict:
    """Read a torch checkpoint file into ``{name: numpy}`` on the CPU; a
    nested dict (StyleGAN2's ``{"generator_smooth": {...}}``) stays nested.

    The file is read with ``weights_only=True``: a pickled module (the
    reference's classes on the path) is refused; save its ``state_dict()``.
    Paths only: a URL is refused here (the CLIs' ``--lpips_weights`` and
    ``--vgg_weights`` resolve one first through ``io/fetch.py``)."""
    path = str(path)
    if "://" in path:
        raise ValueError(f"{path} is a URL; pass the path of a downloaded file")
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as err:
        raise ValueError(
            f"{path} holds more than tensors (a pickled module?); it is read with "
            "weights_only=True, so save the module's state_dict() instead"
        ) from err
    if not isinstance(obj, Mapping):
        raise ValueError(f"{path} holds a {type(obj).__name__}, not a state dict")
    return _np(obj)


def load_state(module: nn.Module, state: Mapping[str, np.ndarray]) -> nn.Module:
    """Copy a converted ``{port name: numpy}`` dict into ``module`` in place
    (every parameter and buffer, shapes exact, no leaf left over) and
    return it."""
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32)) for k, v in state.items()}
    module.load_state_dict(tensors, strict=True)
    return module


def built(make, state: Mapping[str, np.ndarray]) -> nn.Module:
    """``make()``'s module built on the meta device (no random init) and
    filled from a converted dict, on the CPU."""
    with torch.device("meta"):
        module = make()
    return load_state(module.to_empty(device="cpu"), state)


def chan(w: np.ndarray) -> np.ndarray:
    """``[1, C, 1, 1]`` (or ``[C]``) -> ``[C]``."""
    return np.reshape(w, (-1,))


def fold_spectral_norm(state: State) -> State:
    """Fold torch ``spectral_norm`` triplets (``weight_orig``/``_u``/``_v``)
    into plain ``weight`` entries, with eval semantics: sigma = u . (W v).
    A missing ``u`` is power-iterated (20 steps) from
    ``np.random.RandomState(0)``'s draw, a missing ``v`` made from ``u``, as
    ``tpugan`` does."""
    out: State = {}
    for k, v in state.items():
        if k.endswith("weight_orig"):
            base = k[: -len("_orig")]
            u = state.get(base + "_u")
            vv = state.get(base + "_v")
            w_mat = v.reshape(v.shape[0], -1)
            if u is None:
                u = np.random.RandomState(0).randn(w_mat.shape[0]).astype(v.dtype)
                for _ in range(20):
                    vv = w_mat.T @ u
                    vv /= np.linalg.norm(vv) + 1e-12
                    u = w_mat @ vv
                    u /= np.linalg.norm(u) + 1e-12
            elif vv is None:
                vv = w_mat.T @ u
                vv /= np.linalg.norm(vv) + 1e-12
            sigma = float(u @ (w_mat @ vv))
            out[base] = v / sigma
        elif k.endswith("weight_u") or k.endswith("weight_v"):
            continue
        else:
            out[k] = v
    return out


# ---------------------------------------------------------------------------
# StyleGANv1 (model/stylegan1/net.py)


def stylegan1_generator(state: State, layer_count: int) -> State:
    """``Gs_dict.pth`` -> :class:`~tpugan_torch.models.StyleGANv1Generator`.
    The fused blocks' ``conv_1`` (output 128 px and up, net.py:285) is a
    transposed conv in both, ``[in, out, kh, kw]``."""
    out: State = {"const": state["const"]}
    for i in range(layer_count):
        src, dst = f"decode_block.{i}.", f"decode_block_{i}."
        for name in ("noise_weight_1", "noise_weight_2", "bias_1", "bias_2"):
            out[dst + name] = chan(state[src + name])
        for name in ("style_1.weight", "style_1.bias", "style_2.weight", "style_2.bias",
                     "conv_1.weight", "conv_2.weight"):
            if src + name in state:
                out[dst + name] = state[src + name]
        for name in ("weight", "bias"):
            out[f"to_rgb_{i}.to_rgb.{name}"] = state[f"to_rgb.{i}.to_rgb.{name}"]
    return out


def stylegan1_mapping(state: State, mapping_layers: int = 8) -> State:
    """``Gm_dict.pth`` -> :class:`~tpugan_torch.models.StyleGANv1Mapping`
    (its truncation center is :func:`center_tensor`'s)."""
    return {f"block_{i}.fc.{name}": state[f"block_{i}.fc.{name}"]
            for i in range(1, mapping_layers + 1) for name in ("weight", "bias")}


def center_tensor(path) -> np.ndarray:
    """``center_tensor.pt`` -> the truncation center ``[num_layers, latent]``."""
    t = torch.load(str(path), map_location="cpu", weights_only=True)
    t = t.detach().numpy()
    return t.reshape(t.shape[-2], t.shape[-1])


# ---------------------------------------------------------------------------
# StyleGAN2 (model/stylegan2_generator.py)


def stylegan2_state(state: Mapping) -> State:
    """The generator's own dict out of a StyleGAN2 ``.pth``: under
    ``generator_smooth`` (else ``generator``), nested or as a key prefix;
    a dict of the generator's keys is returned as it is."""
    for wrapper in ("generator_smooth", "generator"):
        if isinstance(state.get(wrapper), Mapping):
            return dict(state[wrapper])
        prefix = wrapper + "."
        inner = {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
        if inner:
            return inner
    return dict(state)


def stylegan2_generator(state: State) -> State:
    """The generator's dict (:func:`stylegan2_state`) ->
    :class:`~tpugan_torch.models.StyleGAN2Generator`: the mapping's dense
    layers, ``truncation.w_avg``, the const and the synthesis layers'
    weights, biases, styles, noise strengths and noise buffers."""
    out: State = {}
    for k, v in state.items():
        if re.match(r"mapping\.(dense\d+\.(weight|bias)|label_weight)$", k) or k == "truncation.w_avg":
            out[k] = v
        elif k == "synthesis.early_layer.const":
            out["synthesis.const"] = v
        elif m := re.match(r"synthesis\.((layer|output|skip_layer)\d+)\."
                           r"(weight|bias|style\.weight|style\.bias|noise_strength|noise)$", k):
            out[k] = v.reshape(()) if m.group(3) == "noise_strength" else v
    return out


# ---------------------------------------------------------------------------
# PGGAN (model/pggan/pggan_generator.py)


def pggan_generator(state: State) -> State:
    """The generator's dict (:func:`stylegan2_state` unwraps a ``.pth``) ->
    :class:`~tpugan_torch.models.PGGANGenerator`: ``layer<i>`` and
    ``output<i>`` weights and biases, as they are (the fused up-sampling
    convs ``[in, out, kh, kw]`` in both); the ``lod`` buffer is the
    forward's argument here."""
    return {k: v for k, v in state.items() if re.match(r"(layer|output)\d+\.(weight|bias)$", k)}


def _flatten_columns(w: np.ndarray, channels: int) -> np.ndarray:
    """A dense weight over the reference's (c, h, w) flatten of a
    ``[channels, 4, 4]`` map, reordered for the port's (h, w, c) one."""
    return w.reshape(w.shape[0], channels, 4, 4).transpose(0, 2, 3, 1).reshape(w.shape[0], -1)


# ---------------------------------------------------------------------------
# BigGAN (model/biggan_generator.py)


def biggan(state: State) -> State:
    """``G-256.pt`` (spectral norm) -> :class:`~tpugan_torch.models.BigGAN`:
    the spectral norms folded (:func:`fold_spectral_norm`), the layer list
    ``generator.layers.N`` renamed ``generator.layers_N``."""
    out: State = {}
    for k, v in fold_spectral_norm(state).items():
        k = re.sub(r"^generator\.layers\.(\d+)\.", r"generator.layers_\1.", k)
        out[k] = v.reshape(-1) if k.endswith(".gamma") else v
    return out


# ---------------------------------------------------------------------------
# Encoders (model/E/*.py)

_ENC_CHAN = ("noise_weight_1", "noise_weight_2", "bias_1", "bias_2")


def _from_rgb(state: State) -> State:
    return {f"from_rgb.{n}": state[f"FromRGB.from_rgb.{n}"] for n in ("weight", "bias")}


def encoder(state: State, layer_count: int) -> State:
    """E / E_Blur (and the ablation ladder's) state dict ->
    :class:`~tpugan_torch.models.Encoder`."""
    out = _from_rgb(state)
    for i in range(layer_count):
        src, dst = f"decode_block.{i}.", f"block_{i}."
        for name in _ENC_CHAN:
            if src + name in state:
                out[dst + name] = chan(state[src + name])
        for name in ("inver_mod1.weight", "inver_mod1.bias", "inver_mod2.weight", "inver_mod2.bias",
                     "conv_1.weight", "conv_2.weight", "conv_3.weight", "conv_3.bias"):
            if src + name in state:
                out[dst + name] = state[src + name]
        if src + "instance_norm_3.weight" in state:
            # E_v1's affine instance norm after conv_3 (Ablation_Study/E_v1.py:61-62)
            out[dst + "in3_scale"] = state[src + "instance_norm_3.weight"]
            out[dst + "in3_bias"] = state[src + "instance_norm_3.bias"]
    for name in ("weight", "bias"):
        if f"out_z.{name}" in state:  # E_Blur_Z's z head (Ablation_Study/E_Blur_Z.py:102)
            out[f"out_z.{name}"] = state[f"out_z.{name}"]
    return out


def pg_encoder(state: State, layer_count: int, maxf: int = 512) -> State:
    """E_PG state dict (model/E/E_PG.py) ->
    :class:`~tpugan_torch.models.PGEncoder`: the blocks as :func:`encoder`
    maps them (no style heads; ``instance_norm_3`` is the affine IN of the
    residual), ``new_final``'s input columns reordered from the
    reference's (c, h, w) flatten of the last ``[maxf, 4, 4]`` map to the
    port's (h, w, c)."""
    out = encoder(state, layer_count)
    out["new_final.weight"] = _flatten_columns(state["new_final.weight"], maxf)
    out["new_final.bias"] = state["new_final.bias"]
    return out


def biggan_encoder(state: State, layer_count: int, maxf: int = 512) -> State:
    """E_BIG state dict (model/E/E_BIG.py) ->
    :class:`~tpugan_torch.models.BigGANEncoder`. The conditional batch
    norms keep live spectral norm: ``weight_orig`` -> ``weight``,
    ``weight_u``/``weight_v`` -> the ``SNDense`` buffers ``u``/``v``.
    ``new_final_1`` follows the reference's (c, h, w) flatten of the last
    ``[maxf, 4, 4]`` map; the port flattens (h, w, c), so its input columns
    are reordered."""
    out = _from_rgb(state)
    for i in range(layer_count):
        src, dst = f"decode_block.{i}.", f"block_{i}."
        for name in _ENC_CHAN:
            if src + name in state:
                out[dst + name] = chan(state[src + name])
        for name in ("conv_1.weight", "conv_2.weight", "conv_3.weight", "conv_3.bias"):
            if src + name in state:
                out[dst + name] = state[src + name]
        for bn in ("batch_norm_1", "batch_norm_2", "batch_norm_3"):
            if src + bn + ".running_means" not in state:
                continue
            for name in ("running_means", "running_vars"):
                out[f"{dst}{bn}.{name}"] = state[f"{src}{bn}.{name}"]
            for lin in ("scale", "offset"):
                for ref, port in (("weight_orig", "weight"), ("weight_u", "u"), ("weight_v", "v")):
                    out[f"{dst}{bn}.{lin}.{port}"] = state[f"{src}{bn}.{lin}.{ref}"]
    out["new_final_1.weight"] = _flatten_columns(state["new_final_1.weight"], maxf)
    out["new_final_1.bias"] = state["new_final_1.bias"]
    for name in ("weight", "bias"):
        out[f"new_final_2.{name}"] = state[f"new_final_2.{name}"]
    return out


# ---------------------------------------------------------------------------
# VGG16 / LPIPS

VGG16_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
VGG16_FC_IDX = (0, 3, 6)


def vgg16(state: State, include_classifier: bool = True) -> State:
    """torchvision's VGG16 state dict -> :class:`~tpugan_torch.losses.vgg.
    VGG16`: ``features.{idx}`` -> ``conv_{j}``; with the classifier,
    ``classifier.{0,3,6}`` -> ``head.fc_{0,1,2}``, ``classifier.0`` as it is
    (both flatten (c, h, w))."""
    out: State = {}
    for j, idx in enumerate(VGG16_CONV_IDX):
        for name in ("weight", "bias"):
            out[f"conv_{j}.{name}"] = state[f"features.{idx}.{name}"]
    if include_classifier and "classifier.0.weight" in state:
        for j, idx in enumerate(VGG16_FC_IDX):
            for name in ("weight", "bias"):
                out[f"head.fc_{j}.{name}"] = state[f"classifier.{idx}.{name}"]
    return out


def lpips_vgg(state: State) -> State:
    """The official LPIPS (``net='vgg'``) state dict ->
    :class:`~tpugan_torch.losses.lpips.LPIPS`: the backbone under
    ``net.slice{1..5}.{idx}`` (torchvision's feature indices) ->
    ``backbone.conv_{j}``, the heads ``lin{k}.model.1.weight`` ([1, C, 1, 1]
    convs) -> ``lin_{k}.weight``."""
    conv_of = {idx: j for j, idx in enumerate(VGG16_CONV_IDX)}
    out: State = {}
    for k, v in state.items():
        if m := re.match(r"(?:net\.)?slice\d+\.(\d+)\.(weight|bias)$", k):
            out[f"backbone.conv_{conv_of[int(m.group(1))]}.{m.group(2)}"] = v
        elif m := re.match(r"lin(\d)\.model\.1\.weight$", k):
            out[f"lin_{m.group(1)}.weight"] = v
    return out
