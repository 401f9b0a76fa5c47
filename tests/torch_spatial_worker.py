"""The space axis's ops and steps for ``tests/test_torch_spatial_ops.py``,
``tests/test_torch_spatial_steps.py`` and ``tests/test_torch_spatial_part2.py``
(E_BIG, E_PG, VGG16 and Grad-CAM), run on row shards or whole: as a
script, one rank of a gloo group of four on the CPU (``python
tests/torch_spatial_worker.py SPEC RANK WORLD OUT``); imported, the same
cases in one process. Imports no JAX, so the spawned ranks never load it.

``SPEC`` is a ``torch.save``'d dict: ``spec["runs"]`` lists ``(name, mesh,
kind, case, dtype)`` and every run's inputs. The meshes over the group's
four ranks: "1x2" (ranks 0 and 1), "1x2b" (ranks 2 and 3, so two 1 x 2
runs go side by side), "2x2" and "1x4". An op run gives its output, its
input's gradient and its parameters' gradients, whole; a step run the
encoder's parameters after the step, every gradient handed to the
optimizer and the logged scalars (the inversion: w, the images, the
snapshot and the histories).
"""

from __future__ import annotations

import os
import pathlib
import sys
from types import SimpleNamespace

import torch
import torch.nn.functional as F

if __name__ == "__main__":
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from torch_parallel_worker import _cast, _recorded, _result, empty_vgg16  # noqa: E402
from tpugan_torch.invert import EmbeddingConfig, make_embedder  # noqa: E402
from tpugan_torch.losses import gradcam  # noqa: E402
from tpugan_torch.losses.lpips import LPIPS, make_lpips_fn  # noqa: E402
from tpugan_torch.losses.space_loss import pool_for_lpips, pooled_whole  # noqa: E402
from tpugan_torch.losses.ssim import ssim  # noqa: E402
from tpugan_torch.models import (  # noqa: E402
    BigGAN,
    BigGANConfig,
    BigGANEncoder,
    Encoder,
    PGEncoder,
    PGGANGenerator,
    StyleGANv1Generator,
    StyleGANv1Mapping,
)
from tpugan_torch.models.encoders import BigGANEncoderBlock, PGEncoderBlock, _stats  # noqa: E402
from tpugan_torch.models.stylegan2 import StyleGAN2Generator  # noqa: E402
from tpugan_torch.nn.layers import EqConv  # noqa: E402
from tpugan_torch.optim import lreq_adam  # noqa: E402
from tpugan_torch.optim.lreq_adam import LREQAdam  # noqa: E402
from tpugan_torch.parallel import mesh as mesh_mod  # noqa: E402
from tpugan_torch.parallel import spatial  # noqa: E402
from tpugan_torch.precision import bf16_encode, bf16_frozen, bf16_pipeline  # noqa: E402
from tpugan_torch.train import make_mis_align_step  # noqa: E402
from tpugan_torch.train.e_align import (  # noqa: E402
    Request,
    build_biggan_pipeline,
    build_pggan_pipeline,
    build_stylegan1_pipeline,
    build_stylegan2_pipeline,
    info_scalars,
    init_train_state,
    make_encode_fn,
    make_train_step,
)

MESHES = {"1x2": ([0, 1], 2), "1x2b": ([2, 3], 2), "2x2": ([0, 1, 2, 3], 2), "1x4": ([0, 1, 2, 3], 4)}
# ablation 8's weights and update order (tpugan/cli/e_align.py:68-101)
STEP_KW = {"case1": dict(case=1), "lean": dict(case=1, compute_image_losses=False), "case2": dict(case=2),
           "case2_lpips": dict(case=2), "remat": dict(case=2, remat=True),
           "conv_outs": dict(case=2, remat_policy="conv_outs"), "sg2": dict(case=2),
           "ablation8": dict(case=2, image_weights=(1.0, 5.0, 9.0), latent_weights=(1.0, 1.0),
                             sequential_image_steps=True)}


# ---------------------------------------------------------------------------
# the ops


def _param_grads(module, group):
    """``module``'s parameter gradients summed over ``group`` (each rank's
    share), by name."""
    out = {}
    for name, p in module.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
        out[name] = mesh_mod.all_sum(g, group)
    return out


def _op(spec, case, group, dtype):
    """One op of ``spec["ops"][case]`` on the rank's rows of its input
    (whole where ``group`` is None): ``{"out", "grad", "params"}``, each
    whole. The loss is the sum of the output times a fixed cotangent; an op
    whose output is whole on every rank adds its share of it."""
    op = _cast(spec["ops"][case], dtype)
    x, cot = op["x"].clone(), op["cot"]
    dim = op["dim"]
    n = mesh_mod.group_size(group)
    rows = spatial.Rows.even(group, x.shape[dim] // n) if group is not None else None
    xr = mesh_mod.take_rows(x, group, dim).clone().requires_grad_(True) if group is not None else x.requires_grad_(True)
    module, sharded_out = None, True
    ops = spatial.RowOps(group)
    if case in ("conv3", "fused"):
        module = EqConv(**op["kw"]).to(dtype)
        module.load_state_dict(_cast(op["state"], dtype))
        out = ops.conv(module, xr)
    elif case == "blur":
        out = ops.blur(xr)
    elif case == "instance_norm":
        out = ops.instance_norm(xr)
    elif case in ("stats", "stats_std"):
        out, sharded_out = _stats(xr, "std" if case == "stats_std" else "meanstd", ops), False
    elif case.startswith("encoder"):
        module = Encoder(**op["kw"]).to(dtype)
        module.load_state_dict(_cast(op["state"], dtype))
        const, w = module(xr, op["noise"], space=group) if group is not None else module(xr, op["noise"])
        out, sharded_out = torch.cat([const.reshape(-1)] + ([] if w is None else [w.reshape(-1)])), False
    elif case == "pool":
        out, sharded_out = pooled_whole(xr, rows) if group is not None else pool_for_lpips(xr), False
    elif case in ("ssim", "lpips"):
        yr = mesh_mod.take_rows(op["y"], group, dim) if group is not None else op["y"]
        sharded_out = False
        pa, pb = (pooled_whole(t, rows) for t in (xr, yr)) if group is not None else (xr, yr)
        out = ssim(pa, pb) if case == "ssim" else _lpips_fn(spec, dtype)(pa, pb)
    else:
        raise ValueError(case)
    if sharded_out and group is not None:
        loss = torch.sum(out * mesh_mod.take_rows(cot, group, 2))
        whole = mesh_mod.all_gather_rows(out.detach(), group)
    else:
        loss = torch.sum(out * cot) / n
        whole = out.detach()
    loss.backward()
    grad = xr.grad if group is None else mesh_mod.all_gather_rows(xr.grad, group, dim=dim)
    params = {} if module is None else _param_grads(module, group)
    return {"out": whole, "grad": grad.detach(), "params": params}


# ---------------------------------------------------------------------------
# the steps


def _sgv1(spec, encoder, dtype):
    gen = StyleGANv1Generator(**spec["gen_kw"])
    gen.load_state_dict(spec["gen"])
    gm = StyleGANv1Mapping(**spec["map_kw"])
    gm.load_state_dict(spec["gm"])
    enc = Encoder(**spec["gen_kw"], **spec["encoder_kw"][encoder])
    enc.load_state_dict(spec["encoders"][encoder])
    return gen.to(dtype), gm.to(dtype), enc.to(dtype)


def _sg2(spec, dtype):
    gen = StyleGAN2Generator(**spec["sg2_kw"])
    gen.load_state_dict(spec["sg2"])
    enc = Encoder(**spec["sg2_enc_kw"])
    enc.load_state_dict(spec["sg2_enc"])
    return gen.to(dtype), enc.to(dtype)


def _lpips_fn(spec, dtype):
    lp = LPIPS().to(dtype)
    lp.load_state_dict(_cast(spec["lpips"], dtype))
    return make_lpips_fn(lp)


def _train(spec, case, mesh, dtype):
    """One step of ``case`` on its inputs (``dtype`` "bf16": tpugan's bf16
    scheme on fp32 modules)."""
    bf16 = dtype == "bf16"
    work = torch.float32 if bf16 else dtype
    space = mesh_mod.space_group(mesh) if mesh is not None else None
    if case == "sg2":
        gen, enc = _sg2(spec, work)
        synth_fn, resynth = build_stylegan2_pipeline(bf16_frozen(gen) if bf16 else gen, train=True)
        request = Request(**_cast(spec["sg2_request"], work))

        def synth(r):
            return synth_fn(r.z)
    else:
        encoder = "E" if case in ("case1", "lean") else "E_Blur"
        gen, gm, enc = _sgv1(spec, encoder, work)
        if bf16:
            gen, gm = bf16_frozen(gen), bf16_frozen(gm)
        synth_fn, resynth = build_stylegan1_pipeline(gen, gm, spec["lod"], train=True)
        request = Request(**_cast(spec["requests"][encoder], work))

        def synth(r):
            return synth_fn(r.z, r.noise_g)
    encode = make_encode_fn(enc, train=True, space=space)
    if bf16:
        synth_fn, resynth = bf16_pipeline(synth_fn, resynth)
        encode = bf16_encode(encode, enc)
    lpips = _lpips_fn(spec, work) if case == "case2_lpips" else None
    step = make_train_step(encode, synth, resynth, lambda it: request, lpips_fn=lpips, mesh=mesh,
                           spatial=space is not None, **STEP_KW[case])
    state = init_train_state(enc, lreq_adam(enc, spec["lr"]))
    grads = _recorded(state)
    state, info = step(state, 0)
    return _result(state.encoder, grads, info_scalars(info))


def _embedding(spec, optimize_e, mesh, dtype):
    gen, _, enc = _sgv1(spec, "E", dtype)
    gen.requires_grad_(False)
    lod, embed = spec["lod"], _cast(spec["embed"], dtype)
    space = mesh_mod.space_group(mesh) if mesh is not None else None
    noise_e = mesh_mod.shard_batch(mesh, embed["noise_e"])
    noise_g = mesh_mod.shard_batch(mesh, embed["noise_g"])

    def encode(imgs):
        x = imgs.permute(0, 3, 1, 2).contiguous()
        const, w = enc(x, noise_e, space=space) if space is not None else enc(x, noise_e)
        return const.permute(0, 2, 3, 1), w

    def resynth(w):
        return gen(w, lod, noise_g).permute(0, 2, 3, 1)

    cfg = EmbeddingConfig(optimize_e=optimize_e, **embed["cfg"])
    lpips = _lpips_fn(spec, dtype) if optimize_e else None  # fine-tuning E with LPIPS: its a-feature cache
    invert = make_embedder(encode, resynth, enc, cfg, lpips_fn=lpips, mesh=mesh, spatial=space is not None)
    seen, step = [], LREQAdam.step

    def recording(self, grads=None):
        seen.append([None if g is None else g.clone() for g in grads])
        return step(self, grads)

    LREQAdam.step = recording
    try:
        result = invert(embed["imgs"])
    finally:
        LREQAdam.step = step
    info = {"w": result.w, "images": result.images, "w_best": result.w_best, "loss_best": result.loss_best,
            "msiv": result.msiv_history, "wnorm": result.wnorm_history,
            "losses": torch.stack([torch.stack(list(x)) for x in result.losses])}
    return _result(enc, seen, info)


def _zero_halo(x, above, below, group, dim=2):
    pads = [0, 0] * (x.dim() - 1 - dim) + [above, below]
    return F.pad(x, pads)


# ---------------------------------------------------------------------------
# part 2: E_BIG, E_PG, VGG16 and Grad-CAM on rows

_VGG = {}


def _vgg(spec, dtype):
    """The spec's VGG16 (tpugan's variables through the bridge, saved by
    the test) in ``dtype``, frozen; one copy a process and dtype."""
    if dtype not in _VGG:
        vgg = empty_vgg16(spec["classes"])
        vgg.load_state_dict(torch.load(spec["vgg_path"], mmap=True, weights_only=True))
        _VGG[dtype] = vgg.to(dtype).requires_grad_(False)
    return _VGG[dtype]


def _loaded(module, state, dtype):
    module.load_state_dict(_cast(state, dtype))
    return module.to(dtype)


def _op2(spec, case, group, dtype):
    """One op of ``spec["ops2"][case]`` on the rank's rows of its input
    (whole where ``group`` is None), as :func:`_op`: ``{"out", "grad",
    "params"}``, each whole. Grad-CAM's ops take NHWC images and give no
    gradient."""
    op = _cast(spec["ops2"][case], dtype)
    x, cot, dim = op["x"].clone(), op["cot"], op["dim"]
    n = mesh_mod.group_size(group)
    rows = spatial.Rows.even(group, x.shape[dim] // n) if group is not None else None
    xr = mesh_mod.take_rows(x, group, dim).clone() if group is not None else x
    differentiable = not case.startswith(("grad_cam", "guided", "mask2cam"))
    xr.requires_grad_(differentiable)
    space = {} if group is None else {"space": group}
    module, sharded_out, trained = None, True, None
    if case == "ebig":
        module = _loaded(BigGANEncoder(**op["kw"]), op["state"], dtype)
        out, sharded_out = torch.cat([t.reshape(-1) for t in module(xr, op["cond"], op["noise"], **space)]), False
    elif case == "ebig_block":
        module = _loaded(BigGANEncoderBlock(**op["kw"]), op["state"], dtype)
        out = module(xr, op["cond"], op["noise"], **space)
    elif case == "epg":
        module = _loaded(PGEncoder(**op["kw"]), op["state"], dtype)
        out, sharded_out = torch.cat([t.reshape(-1) for t in module(xr, op["noise"], **space)]), False
    elif case == "epg_block":
        module = _loaded(PGEncoderBlock(**op["kw"]), op["state"], dtype)
        out = module(xr, op["noise"], **space)
    elif case.startswith("vgg"):
        # the convolutions' parameters take gradients here, the head's not;
        # the order of the collectives is recorded (the thin-level gather)
        module = _vgg(spec, dtype)
        trained = [name for name in module.plan if name is not None]
        for name in trained:
            getattr(module, name).requires_grad_(True).zero_grad()
        events = []

        def logged(fn, event):
            def call(x, *args, **kwargs):
                events.append((event, x.shape[2]))
                return fn(x, *args, **kwargs)
            return call

        with _Patched(spatial, "halo_rows", logged(spatial.halo_rows, "halo")), \
                _Patched(spatial, "all_gather_rows", logged(spatial.all_gather_rows, "gather")):
            logits, _, conv_out = module(xr, return_conv_out=True, guided=case == "vgg_guided", **space)
        out, sharded_out = torch.cat([logits.reshape(-1), conv_out.reshape(-1)]), False
    elif case.startswith("grad_cam"):
        out = gradcam.grad_cam(_vgg(spec, dtype), xr, plus_plus=case == "grad_cam", space=rows)
    elif case == "guided_backprop":
        out = gradcam.guided_backprop(_vgg(spec, dtype), xr, space=rows)
    elif case == "mask2cam":
        mask = mesh_mod.take_rows(op["mask"], group, dim) if group is not None else op["mask"]
        out = torch.cat(gradcam.mask2cam(mask, xr, space=rows), dim=-1)
    else:
        raise ValueError(case)
    if sharded_out and group is not None:
        whole = mesh_mod.all_gather_rows(out.detach(), group, dim=dim)
    else:
        whole = out.detach()
    grad, params = None, {}
    if differentiable:
        if sharded_out and group is not None:
            loss = torch.sum(out * mesh_mod.take_rows(cot, group, dim))
        else:
            loss = torch.sum(out * cot) / n
        loss.backward()
        grad = (xr.grad if group is None else mesh_mod.all_gather_rows(xr.grad, group, dim=dim)).detach()
        if trained is None:
            params = _param_grads(module, group)
        else:
            for name in trained:
                for pname, p in getattr(module, name).named_parameters():
                    params[f"{name}.{pname}"] = mesh_mod.all_sum(p.grad.detach().clone(), group)
                getattr(module, name).requires_grad_(False).zero_grad()
    return {"out": whole, "grad": grad, "params": params, "events": events if case.startswith("vgg") else None}


def _biggan(spec, dtype):
    gen = _loaded(BigGAN(BigGANConfig(**spec["big_cfg"])), spec["big"], dtype).eval().requires_grad_(False)
    enc = _loaded(BigGANEncoder(**spec["big_enc_kw"]), spec["big_enc"], dtype).eval()
    return gen, enc


def _train2(spec, case, mesh, dtype):
    """One step of ``case`` (``big_*``: BigGAN + E_BIG; ``pg_case2``:
    PGGAN + E_PG; ``mis_*``: ``e_mis_align`` on the tiny SGv1 with E) on
    its inputs; ``dtype`` "bf16": tpugan's bf16 scheme on fp32 modules."""
    bf16 = dtype == "bf16"
    work = torch.float32 if bf16 else dtype
    space = mesh_mod.space_group(mesh) if mesh is not None else None
    sharded = dict(mesh=mesh, spatial=space is not None)
    if case.startswith("big"):
        gen, enc = _biggan(spec, work)
        synth_fn, resynth = build_biggan_pipeline(bf16_frozen(gen) if bf16 else gen, train=True)
        request = Request(**_cast(spec["big_request"], work))
        encode = make_encode_fn(enc, conditional=True, train=True, space=space)

        def synth(r):
            return synth_fn(r.z, r.label)
    elif case == "pg_case2":
        gen = _loaded(PGGANGenerator(**spec["pg_kw"]), spec["pg"], work).requires_grad_(False)
        enc = _loaded(PGEncoder(**spec["pg_enc_kw"]), spec["pg_enc"], work)
        synth_fn, resynth = build_pggan_pipeline(gen, train=True)
        request = Request(**_cast(spec["pg_request"], work))
        encode = make_encode_fn(enc, train=True, space=space)

        def synth(r):
            return synth_fn(r.z)
    else:
        gen, gm, enc = _sgv1(spec, "E", work)
        synth_fn, resynth = build_stylegan1_pipeline(gen, gm, spec["lod"], train=True)
        request = Request(**_cast(spec["requests"]["E"], work))
        encode = make_encode_fn(enc, train=True, space=space)

        def synth(r):
            return synth_fn(r.z, r.noise_g)
    if bf16:
        synth_fn, resynth = bf16_pipeline(synth_fn, resynth)
        encode = bf16_encode(encode, enc)
    closures = (encode, synth, resynth, lambda it: request)
    if case.startswith("mis"):
        step = make_mis_align_step(*closures, _vgg(spec, work), compute_attention_losses=case == "mis_full",
                                   **sharded)
    elif case == "big_lean":
        step = make_train_step(*closures, case=1, compute_image_losses=False, **sharded)
    elif case == "big_conv_outs":
        step = make_train_step(*closures, case=2, remat_policy="conv_outs", **sharded)
    else:
        step = make_train_step(*closures, case=2, **sharded)
    state = init_train_state(enc, lreq_adam(enc, spec["lr"]))
    grads = _recorded(state)
    state, info = step(state, 0)
    return _result(state.encoder, grads, info_scalars(info))


def _cam_embedding(spec, mesh, dtype):
    """``embedding --gradcam --mtype 4`` fine-tuning E_BIG (the CLI's
    closures: E_BIG on the condition of zt and the label, BigGAN's
    resynthesis with the label)."""
    gen, enc = _biggan(spec, dtype)
    space = mesh_mod.space_group(mesh) if mesh is not None else None
    embed = _cast(spec["cam_embed"], dtype)
    noise_e = mesh_mod.shard_batch(mesh, embed["noise_e"])
    label = mesh_mod.shard_batch(mesh, embed["label"])
    with torch.no_grad():
        cond = torch.cat([mesh_mod.shard_batch(mesh, embed["zt"]), gen.embeddings(label)], dim=1)
    _, resynth_g = build_biggan_pipeline(gen, train=True)
    batch = SimpleNamespace(label=label)
    rows = {} if space is None else {"space": space}

    def encode(imgs):
        return enc(imgs.permute(0, 3, 1, 2).contiguous(), cond, noise_e, **rows)

    def resynth(w):
        return resynth_g(w, batch, None)

    cfg = EmbeddingConfig(attention="gradcam", **embed["cfg"])
    invert = make_embedder(encode, resynth, enc, cfg, vgg=_vgg(spec, dtype), mesh=mesh, spatial=space is not None)
    seen, step = [], LREQAdam.step

    def recording(self, grads=None):
        seen.append([None if g is None else g.clone() for g in grads])
        return step(self, grads)

    LREQAdam.step = recording
    try:
        result = invert(embed["imgs"])
    finally:
        LREQAdam.step = step
    info = {"w": result.w, "images": result.images, "msiv": result.msiv_history,
            "losses": torch.stack([torch.stack(list(x)) for x in result.losses])}
    return _result(enc, seen, info)


class _Patched:
    """``setattr(owner, name, value)`` while entered."""

    def __init__(self, owner, name, value):
        self.owner, self.name, self.value = owner, name, value

    def __enter__(self):
        self.real = getattr(self.owner, self.name)
        setattr(self.owner, self.name, self.value)

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.real)


# negative controls of part 2: what each breaks
PART2_BROKEN = {
    "zero_halo_ebig": (spatial, "halo_rows", _zero_halo),  # every halo row zero, in E_BIG's convolutions
    "local_max": (gradcam, "all_max", lambda x, group: x),  # each image's maximum over the rank's rows alone
    "no_share": (gradcam, "group_size", lambda group: 1),  # the guided gradient without the 1/S share
}


def run2(spec, kind, case, mesh, dtype):
    """A part-2 run: an op (``op2``), a step (``step2``), the Grad-CAM
    inversion (``cam_embedding``), or one of them with :data:`PART2_BROKEN`'s
    fault in place (``kind`` its key, the run an op where ``case`` is one)."""
    if kind in PART2_BROKEN:
        with _Patched(*PART2_BROKEN[kind]):
            return run2(spec, "op2" if case in spec["ops2"] else "step2", case, mesh, dtype)
    if kind == "op2":
        return _op2(spec, case, mesh_mod.space_group(mesh) if mesh is not None else None, dtype)
    if kind == "cam_embedding":
        return _cam_embedding(spec, mesh, dtype)
    return _train2(spec, case, mesh, dtype)


def run(spec, name, mesh=None):
    """One run of ``spec["runs"]`` by name, with ``mesh`` (this rank's
    share) or without (the one-process op or step)."""
    _, _, kind, case, dtype = next(r for r in spec["runs"] if r[0] == name)
    if kind in ("op2", "step2", "cam_embedding", *PART2_BROKEN):
        return run2(spec, kind, case, mesh, dtype)
    if kind == "op":
        return _op(spec, case, mesh_mod.space_group(mesh) if mesh is not None else None, dtype)
    if kind == "embedding":
        return _embedding(spec, case == "finetune_e", mesh, dtype)
    if kind == "zero_halo":  # negative control: every halo row zero
        real, spatial.halo_rows = spatial.halo_rows, _zero_halo
        try:
            return _train(spec, case, mesh, dtype)
        finally:
            spatial.halo_rows = real
    if kind == "local_stats":  # negative control: instance-norm moments of the rank's rows alone
        real, spatial.RowOps.whole_sum = spatial.RowOps.whole_sum, lambda self: lambda sums: sums
        try:
            return _train(spec, case, mesh, dtype)
        finally:
            spatial.RowOps.whole_sum = real
    return _train(spec, case, mesh, dtype)


def main(spec_path: str, rank: int, world: int, out: str) -> None:
    from tpugan_torch.runtime import init_distributed

    torch.set_num_threads(1)
    store = pathlib.Path(out).parent / "store"
    assert init_distributed(f"file://{store}", num_processes=world, process_id=rank, backend="gloo")
    spec = torch.load(spec_path, weights_only=False)
    meshes = {name: mesh_mod.make_mesh(ranks, space=space, device_type="cpu") for name, (ranks, space) in MESHES.items()}
    results = {}
    for name, mesh_name, *_ in spec["runs"]:
        mesh = meshes[mesh_name]
        if mesh_mod.takes_part(mesh):
            results[name] = run(spec, name, mesh)
    results["_rank"] = rank
    results["_jax_loaded"] = any(n == "jax" or n.startswith("jax.") for n in sys.modules)
    torch.save(results, out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    os._exit(0)
