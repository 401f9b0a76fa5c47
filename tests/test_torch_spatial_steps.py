"""tpugan_torch's space axis on whole steps (``train/e_align.py::
make_train_step(spatial=True)``, ``invert/embedding.py::
make_embedder(spatial=True)``) against its own one-process steps and
tpugan's spatial mesh (CPU).

One gloo group of four processes on a ``FileStore``
(``tests/torch_spatial_worker.py``, which imports no JAX) runs every case
on meshes 1 x 2 and 2 x 2 (a space group of two; with 2 x 2 also the data
axis): SGv1 case 1 and its lean step (E), case 2 (E_Blur, LPIPS on),
ablation 8 (one update per loss group) and case 2 under ``--remat`` and
``--remat_policy conv_outs`` (the recompute re-issues the halo exchanges), a
tiny StyleGAN2 case-2 step (config F's architecture at 32 px, E_Blur), and
``embedding`` in both modes (2 iterations, the w-norm term and the
snapshot; fine-tuning E with LPIPS on, its a-feature cache). The models are ``tests/
test_torch_parallel.py``'s tiny SGv1 (startf 8, maxf 32, latent 32, 32 px)
with tpugan's flax-init variables through the bridge; batch 2.

Gates, after tpugan's (``__graft_entry__.py:278-290``): against the port's
one-process step in float64, every logged scalar within
``EQUIV_LOSS_RTOL`` (1e-5) of itself (of its loss group's largest for a
statistic that differences near-equal numbers), each gradient handed to
the optimizer within ``EQUIV_GRAD_TOL`` (1e-6) of its max |g|, the
parameters after the step by LREQAdam's rule
(``tests/test_torch_sgv1_train.py::_check_trajectory``: its first update
follows a near-zero gradient's last digits), the inversion's w, images and
histories within 1e-5 of their max; the ranks of the mesh bitwise equal. Against
tpugan's step on ``make_mesh(jax.devices()[:2], space=2)`` (1 x 2) or
``[:4]`` (2 x 2) in fp32 (case 2 and the inversion optimising w, LPIPS off:
tpugan compiles VGG16 into each mesh program in about 25 s more; tpugan's
case-2 step on 2 x 2 leaves its own one-device step, a fault of the
reference, so the port's is held to tpugan's 1 x 2 one there): the scalars at the whole-model tolerance (rtol
2e-3, atol 2e-4), the gradients within ``EQUIV_SPATIAL_RTOL`` (1e-2) of
their max |g|, the parameters by LREQAdam's rule
(``tests/test_torch_sgv1_train.py::_check_trajectory``). ``--bf16`` (case
2 at 1 x 2): every gradient's and scalar's distance from the float64 step
within twice the one-process bf16 step's. Negative controls on case 2 at
1 x 2 fail the float64 gradient gate: every halo row zero, and
instance-norm moments of a rank's rows alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_spatial_worker as worker
from test_torch_parallel import (
    ENCODERS,
    GEN_KW,
    IMG,
    LATENT,
    LAYERS,
    LOD,
    LR,
    MAP_KW,
    MODEL_TOL,
    _group_scale,
    _jax_closures,
    _noise,
    _port_named,
)
from test_torch_sgv1_train import _check_trajectory, _jnoise, _recording, nonzero_leaves
from test_torch_spatial_ops import spawn_group
from tpugan.invert import EmbeddingConfig as JEmbeddingConfig
from tpugan.invert import make_embedder as jmake_embedder
from tpugan.losses.lpips import random_params as jlpips_params
from tpugan.models.encoders import Encoder as JEncoder
from tpugan.models.stylegan1 import StyleGANv1Generator as JGenerator
from tpugan.models.stylegan1 import StyleGANv1Mapping as JMapping
from tpugan.ops.eq_lr import lreq_coef_tree
from tpugan.optim import lreq_adam as jlreq_adam
from tpugan.parallel.mesh import make_mesh as jmake_mesh
from tpugan.train.e_align import info_scalars as jinfo_scalars
from tpugan.train.e_align import init_train_state as jinit_train_state
from tpugan.train.e_align import make_train_step as jmake_train_step
from tpugan_torch.io.bridge import load_variables
from tpugan_torch.losses.lpips import LPIPS
from tpugan_torch.models import Encoder, StyleGANv1Generator, StyleGANv1Mapping
from tpugan_torch.models.stylegan2 import StyleGAN2Generator

BATCH = 2
EMBED_CFG = dict(iterations=2, chunk=2, lr=0.01, beta=0.002)
EQUIV_LOSS_RTOL = 1e-5  # __graft_entry__.py:289
EQUIV_GRAD_TOL = 1e-6  # __graft_entry__.py:288, of max |g|
EQUIV_SPATIAL_RTOL = 1e-2  # __graft_entry__.py:290, of max |g|
SG2_KW = dict(resolution=IMG, fmaps_base=2048, mapping_layers=2)
SG2_ENC_KW = dict(startf=64, maxf=512, layer_count=LAYERS, latent_size=512, use_blur=True)  # const2 is the synthesis const's width
STEPS = ("case1", "lean", "case2", "case2_lpips", "ablation8", "remat", "conv_outs", "sg2")
EMBEDDINGS = ("finetune_e", "optimize_w")
MESHES = ("1x2", "2x2")
JAX_DEVICES = {"1x2": 2, "2x2": 4}
TPUGAN_RUNS = (("case2", "1x2"), ("case2", "2x2"), ("optimize_w", "1x2"), ("optimize_w", "2x2"))
NEGATIVE = ("zero_halo", "local_stats")


def _kind(case):
    return "embedding" if case in EMBEDDINGS else "step"


def _runs():
    """(name, mesh, kind, case, dtype) of every run: the 1 x 2 ones shared
    between the two pairs of ranks."""
    pairs = iter(["1x2", "1x2b"] * 16)
    runs = []
    for mesh in MESHES:
        for case in STEPS + EMBEDDINGS:
            runs.append((f"{case}@{mesh}", next(pairs) if mesh == "1x2" else mesh, _kind(case), case, torch.float64))
    for case, mesh in TPUGAN_RUNS:
        runs.append((f"{case}@{mesh}@fp32", next(pairs) if mesh == "1x2" else mesh, _kind(case), case,
                     torch.float32))
    runs.append(("case2@1x2@bf16", next(pairs), "step", "case2", "bf16"))
    for kind in NEGATIVE:
        runs.append((f"{kind}@1x2", next(pairs), kind, "case2", torch.float64))
    return runs


def _build_spec():
    """tpugan's flax-init variables (constant leaves drawn), the port's
    modules loaded from them, random LPIPS variables, a tiny StyleGAN2 and
    its E_Blur, and numpy draws of every input."""
    rng = np.random.RandomState(0)
    key = jax.random.PRNGKey(0)
    g_shapes = StyleGANv1Generator(**GEN_KW).noise_shapes(BATCH)
    jgen, jgm = JGenerator(**GEN_KW), JMapping(**MAP_KW)
    gen_vars = jax.tree.map(np.asarray, jax.jit(lambda w, n: jgen.init(key, w, LOD, 1.0, n))(
        jnp.zeros((BATCH, 2 * LAYERS, LATENT)), _jnoise(_noise(g_shapes, rng))))
    gen_vars = {"params": nonzero_leaves(gen_vars["params"], rng)}
    gm_vars = jax.tree.map(np.asarray, jax.jit(jgm.init)(key, jnp.zeros((1, LATENT))))
    gen = load_variables(StyleGANv1Generator(**GEN_KW), gen_vars, unused=[f"to_rgb_{i}" for i in range(LOD)])
    gm = load_variables(StyleGANv1Mapping(**MAP_KW), gm_vars)
    enc_vars, encoders = {}, {}
    for name, kw in ENCODERS.items():
        je = JEncoder(**GEN_KW, **kw)
        shapes = Encoder(**GEN_KW, **kw).noise_shapes(BATCH, IMG)
        variables = jax.tree.map(np.asarray, jax.jit(lambda x, n: je.init(key, x, 0, n))(
            jnp.zeros((BATCH, IMG, IMG, 3)), _jnoise(_noise(shapes, rng))))
        enc_vars[name] = {**variables, "params": nonzero_leaves(variables["params"], rng)}
        encoders[name] = load_variables(Encoder(**GEN_KW, **kw), enc_vars[name]).state_dict()
    lp_vars = jax.tree.map(lambda x: (rng.randn(*x.shape) / np.sqrt(np.prod(x.shape[:-1]))).astype(np.float32),
                           jax.eval_shape(lambda: jlpips_params(jax.random.PRNGKey(7), IMG)))
    z = torch.from_numpy(rng.randn(BATCH, LATENT).astype(np.float32))
    noise_g, noise_g2 = _noise(g_shapes, rng), _noise(g_shapes, rng)
    requests = {name: dict(z=z, noise_g=noise_g, noise_g2=noise_g2,
                           noise_e=_noise(Encoder(**GEN_KW, **kw).noise_shapes(BATCH, IMG), rng))
                for name, kw in ENCODERS.items()}
    g = torch.Generator().manual_seed(0)
    sg2, sg2_enc = StyleGAN2Generator(**SG2_KW, generator=g), Encoder(**SG2_ENC_KW, generator=g)
    with torch.no_grad():
        for p in sg2_enc.parameters():
            if p.numel() and torch.all(p == p.flatten()[0]):
                p.add_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32)) * 0.1)
    sg2_request = dict(z=torch.from_numpy(rng.randn(BATCH, 512).astype(np.float32)), noise_g=None, noise_g2=None,
                       noise_e=_noise(sg2_enc.noise_shapes(BATCH, IMG), rng))
    embed = dict(imgs=torch.from_numpy(rng.uniform(-1, 1, (BATCH, IMG, IMG, 3)).astype(np.float32)),
                 noise_e=_noise(Encoder(**GEN_KW).noise_shapes(BATCH, IMG), rng),
                 noise_g=_noise(StyleGANv1Generator(**GEN_KW).noise_shapes(BATCH), rng), cfg=EMBED_CFG)
    spec = dict(gen_kw=GEN_KW, map_kw=MAP_KW, lod=LOD, lr=LR, gen=gen.state_dict(), gm=gm.state_dict(),
                encoder_kw=ENCODERS, encoders=encoders, requests=requests,
                lpips=load_variables(LPIPS(), lp_vars).state_dict(), sg2_kw=SG2_KW, sg2=sg2.state_dict(),
                sg2_enc_kw=SG2_ENC_KW, sg2_enc=sg2_enc.state_dict(), sg2_request=sg2_request, embed=embed,
                runs=_runs())
    jax_side = dict(jgen=jgen, jgm=jgm, gen_vars=gen_vars, gm_vars=gm_vars, enc_vars=enc_vars, lp_vars=lp_vars)
    return spec, jax_side


def _jax_step(spec, j, mesh):
    """tpugan's case-2 step (E_Blur) on its spatial mesh: scalars,
    the gradients handed to the optimizer and the parameters after the
    step, by the port's names."""
    encode, synth, resynth = _jax_closures(j, "E_Blur", BATCH)
    params = j["enc_vars"]["E_Blur"]["params"]
    opt = _recording(jlreq_adam(LR, coefs=lreq_coef_tree(params, j["enc_vars"]["E_Blur"]["lreq"])), keep=2)
    r = spec["requests"]["E_Blur"]
    frozen = {"gen": j["gen_vars"], "gm": j["gm_vars"], "z": jnp.asarray(r["z"].numpy()),
              "noise_g": _jnoise(r["noise_g"]), "noise_e": _jnoise(r["noise_e"]), "noise_g2": _jnoise(r["noise_g2"])}
    step = jax.jit(jmake_train_step(encode=encode, synth=synth, resynth=resynth, optimizer=opt, z_dim=LATENT,
                                    batch_size=BATCH, case=2,
                                    mesh=jmake_mesh(jax.devices()[:JAX_DEVICES[mesh]], space=2), spatial=True))
    state, info = step(jinit_train_state(params, opt), jnp.int32(0), frozen)
    port = Encoder(**GEN_KW, **ENCODERS["E_Blur"])
    return dict(info=jinfo_scalars(info), grads=[_port_named(port, g) for g in state.opt_state[-2:]],
                params=_port_named(port, state.params))


def _jax_embedding(spec, j, optimize_e, mesh):
    e = spec["embed"]
    je, jgen = JEncoder(**GEN_KW), j["jgen"]
    enc_vars = j["enc_vars"]["E"]
    extra = {k: v for k, v in enc_vars.items() if k != "params"}
    noise_e, noise_g = _jnoise(e["noise_e"]), _jnoise(e["noise_g"])

    def encode(params, imgs):
        return je.apply({**extra, "params": params}, imgs, 0, noise_e)

    def resynth(frozen, w):
        return jgen.apply(frozen, w, LOD, 1.0, noise_g)

    invert = jmake_embedder(encode, resynth, enc_vars["params"], lreq_coef_tree(enc_vars["params"], enc_vars["lreq"]),
                            JEmbeddingConfig(optimize_e=optimize_e, **EMBED_CFG),
                            frozen=j["gen_vars"],
                            mesh=jmake_mesh(jax.devices()[:JAX_DEVICES[mesh]], space=2), spatial=True)
    r = invert(jnp.asarray(e["imgs"].numpy()))
    return dict(w=np.asarray(r.w), images=np.asarray(r.images), w_best=np.asarray(r.w_best),
                loss_best=np.asarray(r.loss_best), msiv=np.asarray(r.msiv_history), wnorm=np.asarray(r.wnorm_history),
                losses=np.asarray([[float(a), float(b)] for a, b in r.losses]))


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The group runs every case; meanwhile this process runs the port's
    one-process cases and tpugan's spatial mesh steps."""
    tmp = tmp_path_factory.mktemp("spatial_steps")
    spec, j = _build_spec()
    wait = spawn_group(spec, tmp)
    one = {case: worker.run(spec, f"{case}@1x2") for case in STEPS + EMBEDDINGS}
    one["bf16"] = worker._train(spec, "case2", None, "bf16")
    tpugan = {}
    for case, mesh in TPUGAN_RUNS:
        tpugan[f"{case}@{mesh}"] = (_jax_step(spec, j, mesh) if case == "case2"
                                    else _jax_embedding(spec, j, case == "finetune_e", mesh))
    return dict(spec=spec, one=one, tpugan=tpugan, ranks=wait())


def _np(x):
    return x.detach().double().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, dtype=np.float64)


def _gradients(result):
    return [{n: _np(g) for n, g in zip(result["names"], grads) if g is not None} for grads in result["grads"]]


def _of(group, name):
    """The run's result on each rank of its mesh, checked bitwise equal
    across the ranks of each space group."""
    ranks = [r[name] for r in group["ranks"] if name in r]
    assert ranks, name
    for other in ranks[1:]:
        for p, v in ranks[0]["params"].items():
            assert torch.equal(v, other["params"][p]), f"{name}: the space group's {p} differ"
    return ranks


def _share(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), np.finfo(np.float64).tiny)


def _worst_gradient(got, want):
    worst = 0.0
    for a, b in zip(_gradients(got), _gradients(want), strict=True):
        assert a.keys() == b.keys()
        worst = max(worst, *(_share(a[n], b[n]) for n in b))
    return worst


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", STEPS)
def test_a_spatial_step_is_the_one_process_step(group, case, mesh):
    """Each rank's step on its rows: the loss and every scalar, each
    gradient and the update against the one-process step in float64."""
    want = group["one"][case]
    for got in _of(group, f"{case}@{mesh}"):
        assert _worst_gradient(got, want) <= EQUIV_GRAD_TOL
        for key, value in want["info"].items():
            np.testing.assert_allclose(got["info"][key], value, rtol=EQUIV_LOSS_RTOL,
                                       atol=EQUIV_LOSS_RTOL * _group_scale(want["info"], key), err_msg=key)
        _update_close(group, case, got, want)


def _update_close(group, case, got, want):
    """The parameters after the step by LREQAdam's rule
    (``_check_trajectory``): its first update follows a near-zero
    gradient's last digits, so an element may part by 2 lr c an update."""
    kw = SG2_ENC_KW if case == "sg2" else dict(GEN_KW, **ENCODERS["E" if case in ("case1", "lean") else "E_Blur"])
    _check_trajectory(Encoder(**kw), {n: _np(p) for n, p in got["params"].items()},
                      {n: _np(p) for n, p in want["params"].items()}, len(want["grads"]))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("mode", EMBEDDINGS)
def test_a_spatial_inversion_is_the_one_process_one(group, mode, mesh):
    """``embedding`` on row shards: the gradients handed to LREQAdam
    (fine-tuning E the encoder's; optimising w the data rank's rows of w)
    and w, the images, the snapshot and the histories of the global batch,
    against the one-process inversion in float64."""
    want = group["one"][mode]
    ranks = [r[f"{mode}@{mesh}"] for r in group["ranks"] if f"{mode}@{mesh}" in r]
    assert len(ranks) == JAX_DEVICES[mesh]
    for key in want["info"]:
        assert all(torch.equal(r["info"][key], ranks[0]["info"][key]) for r in ranks), key
        assert _share(ranks[0]["info"][key], want["info"][key]) <= EQUIV_LOSS_RTOL, key
    if mode == "finetune_e" or mesh == "1x2":
        assert _worst_gradient(ranks[0], want) <= EQUIV_GRAD_TOL
    else:
        for g0, g2, g in zip(ranks[0]["grads"], ranks[2]["grads"], want["grads"], strict=True):
            assert _share(torch.cat([g0[0], g2[0]]), g[0]) <= EQUIV_GRAD_TOL


def _tpugan_reference(case, mesh):
    """tpugan's run that the port's fp32 run is held to: its spatial mesh
    of the same shape, but for the case-2 step on 2 x 2, whose spatial step
    leaves tpugan's one-device step
    (:func:`test_tpugans_2x2_spatial_step_leaves_its_one_device_step`): its
    1 x 2 spatial step, which is its one-device step on the same batch."""
    return f"{case}@1x2" if (case, mesh) == ("case2", "2x2") else f"{case}@{mesh}"


@pytest.mark.parametrize("run", [f"{c}@{m}" for c, m in TPUGAN_RUNS])
def test_a_spatial_step_is_tpugans_spatial_mesh_step(group, run):
    """In fp32 against tpugan's spatial step or inversion on its mesh."""
    case, mesh = run.split("@")
    got, want = _of(group, f"{run}@fp32")[0], group["tpugan"][_tpugan_reference(case, mesh)]
    if case in EMBEDDINGS:
        for key, value in want.items():
            np.testing.assert_allclose(_np(got["info"][key]), value, **MODEL_TOL, err_msg=key)
        return
    for key, value in want["info"].items():
        np.testing.assert_allclose(got["info"][key], value, **MODEL_TOL, err_msg=key)
    for a, b in zip(_gradients(got), want["grads"], strict=True):
        for name in b:
            assert _share(a[name], b[name]) <= EQUIV_SPATIAL_RTOL, f"gradient of {name}"
    encoder = Encoder(**GEN_KW, **ENCODERS["E_Blur"])
    _check_trajectory(encoder, {n: _np(p) for n, p in got["params"].items()}, want["params"], len(want["grads"]))
    assert got["info"]["loss_imgs_ssim"] > 0


def test_tpugans_2x2_spatial_step_leaves_its_one_device_step(group):
    """A fault of the reference: tpugan's case-2 step on ``make_mesh(
    jax.devices()[:4], space=2)`` (data 2 x space 2, batch 2) is not its
    one-device step, which its 1 x 2 spatial step, its 2-device data mesh and
    its 2 x 2 mesh without ``spatial`` all compute: even the latent loss,
    which reads the encoder's output alone, moves by 3e-4 of itself, 30x
    tpugan's own loss gate (EQUIV_LOSS_RTOL). The port's 2 x 2 step keeps
    to the one-device step."""
    wrong, right = group["tpugan"]["case2@2x2"]["info"], group["tpugan"]["case2@1x2"]["info"]
    assert abs(wrong["loss_w_mse"] / right["loss_w_mse"] - 1) > 10 * EQUIV_LOSS_RTOL
    port = _of(group, "case2@2x2@fp32")[0]["info"]
    assert abs(port["loss_w_mse"] / right["loss_w_mse"] - 1) < EQUIV_LOSS_RTOL


def test_a_bf16_spatial_step_keeps_to_the_one_process_bf16_step(group):
    """tpugan's bf16 scheme on row shards: its distance from the float64
    step, gradient by gradient and scalar by scalar, within twice the
    one-process bf16 step's."""
    got, own, ref = _of(group, "case2@1x2@bf16")[0], group["one"]["bf16"], group["one"]["case2"]
    for a, b, r in zip(_gradients(got), _gradients(own), _gradients(ref), strict=True):
        for name in r:
            assert _share(a[name], r[name]) <= 2 * _share(b[name], r[name]) + EQUIV_GRAD_TOL, name
    for key, value in ref["info"].items():
        scale = EQUIV_LOSS_RTOL * _group_scale(ref["info"], key)
        assert abs(got["info"][key] - value) <= 2 * abs(own["info"][key] - value) + scale, key


@pytest.mark.parametrize("kind", NEGATIVE)
def test_the_gates_see_a_broken_shard(group, kind):
    """Every halo row zero, or instance-norm moments of a rank's rows alone:
    the case-2 step leaves the one-process gradient by far more than the
    gate."""
    worst = _worst_gradient(_of(group, f"{kind}@1x2")[0], group["one"]["case2"])
    assert worst > 100 * EQUIV_GRAD_TOL, worst


def test_the_ranks_never_import_jax(group):
    assert [r["_rank"] for r in group["ranks"]] == [0, 1, 2, 3]
    assert not any(r["_jax_loaded"] for r in group["ranks"])
