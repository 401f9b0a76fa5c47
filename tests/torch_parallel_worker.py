"""The steps of ``tests/test_torch_parallel.py``, run with or without a
process mesh: as a script, one rank of a gloo group on the CPU
(``python tests/torch_parallel_worker.py SPEC RANK WORLD OUT``); imported,
the same cases in one process. Imports no JAX, so the spawned ranks never
load it.

``SPEC`` is a ``torch.save``'d dict (see ``run_case``): the models' state
dicts and the kwargs they are built with, the global batch's inputs, the
cases to run and their dtypes. Each case gives the encoder's parameters
after its step(s), every gradient handed to the optimizer and the step's
logged scalars.
"""

from __future__ import annotations

import os
import pathlib
import sys

import torch

if __name__ == "__main__":
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from tpugan_torch.invert import EmbeddingConfig, make_embedder  # noqa: E402
from tpugan_torch.losses.vgg import VGG16  # noqa: E402
from tpugan_torch.models import Encoder, StyleGANv1Generator, StyleGANv1Mapping  # noqa: E402
from tpugan_torch.models.stylegan2 import update_w_avg  # noqa: E402
from tpugan_torch.optim import lreq_adam  # noqa: E402
from tpugan_torch.parallel import mesh as mesh_mod  # noqa: E402
from tpugan_torch.train import make_mis_align_step  # noqa: E402
from tpugan_torch.train.e_align import (  # noqa: E402
    Request,
    build_stylegan1_pipeline,
    info_scalars,
    init_train_state,
    make_encode_fn,
    make_train_step,
)

CASES = ("case1", "case2", "mis_align", "embedding_finetune_e", "embedding_optimize_w", "update_w_avg",
         "case2_per_rank_cosine")


def _models(spec, encoder: str, dtype):
    gen = StyleGANv1Generator(**spec["gen_kw"])
    gen.load_state_dict(spec["gen"])
    gm = StyleGANv1Mapping(**spec["map_kw"])
    gm.load_state_dict(spec["gm"])
    enc = Encoder(**spec["gen_kw"], **spec["encoder_kw"][encoder])
    enc.load_state_dict(spec["encoders"][encoder])
    return gen.to(dtype), gm.to(dtype), enc.to(dtype)


def _cast(x, dtype):
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    if isinstance(x, dict):
        return {k: _cast(v, dtype) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_cast(v, dtype) for v in x)
    return x


def empty_vgg16(classes: int) -> VGG16:
    """A VGG16 whose weights are to be loaded: built on the meta device
    (drawing fc_0's 102.8 M weights takes about 12 s on the CPU)."""
    with torch.device("meta"):
        vgg = VGG16(num_classes=classes)
    return vgg.to_empty(device="cpu")


def _recorded(state):
    """The gradients handed to the optimizer, recorded."""
    grads = []
    step = state.optimizer.step
    state.optimizer.step = lambda g=None: (grads.append([None if x is None else x.clone() for x in g]), step(g))
    return grads


def _result(encoder, grads, info):
    return {"params": {n: p.detach().clone() for n, p in encoder.named_parameters()},
            "names": [n for n, _ in encoder.named_parameters()], "grads": grads, "info": info}


def _train(spec, case: str, mesh, dtype):
    encoder = "E_Blur" if case.startswith("case2") else "E"
    gen, gm, enc = _models(spec, encoder, dtype)
    synth_fn, resynth = build_stylegan1_pipeline(gen, gm, spec["lod"], train=True)
    request = Request(**_cast(spec["requests"][encoder], dtype))
    closures = (make_encode_fn(enc, train=True), lambda r: synth_fn(r.z, r.noise_g), resynth,
                lambda it: request)
    if case == "mis_align":
        vgg = empty_vgg16(spec["classes"])
        vgg.load_state_dict(torch.load(spec["vgg_path"], mmap=True, weights_only=True))
        step = make_mis_align_step(*closures, vgg.to(dtype).requires_grad_(False), mesh=mesh)
    else:
        step = make_train_step(*closures, case=int(case[4]), mesh=mesh)
    state = init_train_state(enc, lreq_adam(enc, spec["lr"]))
    grads = _recorded(state)
    state, info = step(state, 0)
    return _result(state.encoder, grads, info_scalars(info))


def _embedding(spec, optimize_e: bool, mesh, dtype):
    gen, _, enc = _models(spec, "E", dtype)
    gen.requires_grad_(False)
    lod = spec["lod"]
    embed = _cast(spec["embed"], dtype)
    noise_e = mesh_mod.shard_batch(mesh, embed["noise_e"])
    noise_g = mesh_mod.shard_batch(mesh, embed["noise_g"])

    def encode(imgs):
        const, w = enc(imgs.permute(0, 3, 1, 2).contiguous(), noise_e)
        return const.permute(0, 2, 3, 1), w

    def resynth(w):
        return gen(w, lod, noise_g).permute(0, 2, 3, 1)

    cfg = EmbeddingConfig(optimize_e=optimize_e, **embed["cfg"])
    invert = make_embedder(encode, resynth, enc, cfg, mesh=mesh)
    from tpugan_torch.optim.lreq_adam import LREQAdam

    seen = []
    step = LREQAdam.step

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


def run_case(spec, case: str, mesh=None, dtype=torch.float32):
    """One case of :data:`CASES` on ``spec``'s models and global batch in
    ``dtype``, with ``mesh`` (this rank's share) or without (the
    one-process step)."""
    if case == "update_w_avg":
        group = mesh_mod.data_group(mesh)
        w = mesh_mod.shard_batch(mesh, spec["w"].to(dtype))
        return {"w_avg": update_w_avg(spec["w_avg"].to(dtype), w, 0.9, axis_name=group)}
    if case.startswith("embedding"):
        return _embedding(spec, case.endswith("finetune_e"), mesh, dtype)
    if case == "case2_per_rank_cosine":
        # the cosine distance's dot products left per rank (no sum over the
        # group), the gradients still averaged: what a DDP-style average of
        # per-rank losses computes
        summed = mesh_mod.all_sum_grad
        mesh_mod.all_sum_grad = lambda x, group: x
        try:
            return _train(spec, "case2", mesh, dtype)
        finally:
            mesh_mod.all_sum_grad = summed
    return _train(spec, case, mesh, dtype)


def key(case: str, dtype) -> str:
    return f"{case}@{str(dtype).replace('torch.', '')}"


def main(spec_path: str, rank: int, world: int, out: str) -> None:
    from tpugan_torch.runtime import init_distributed, is_primary_host

    torch.set_num_threads(1)
    store = pathlib.Path(out).parent / "store"
    assert init_distributed(f"file://{store}", num_processes=world, process_id=rank, backend="gloo")
    assert is_primary_host() == (rank == 0)
    spec = torch.load(spec_path, weights_only=False)
    mesh = mesh_mod.auto_mesh(spec["batch"], device_type="cpu")
    results = {key(case, dtype): run_case(spec, case, mesh, dtype) for case, dtype in spec["cases"]}
    # after every step each rank's encoder is the others' (the sum of the
    # broadcast shares is the same on every rank)
    results["_rank"] = rank
    results["_jax_loaded"] = any(name == "jax" or name.startswith("jax.") for name in sys.modules)
    torch.save(results, out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    os._exit(0)
