"""tpugan_torch's data parallelism (``parallel/mesh.py``, ``runtime.py``'s
``init_distributed`` and ``is_primary_host``, the ``mesh=`` of the step makers)
vs its own one-process steps and tpugan's mesh (CPU).

``auto_mesh``'s arithmetic and note are held to tpugan's over a grid of
batch, devices and space (tpugan's ``jax.devices()[:n]`` from conftest's 8
CPU devices). Then one group of two gloo processes on a ``FileStore``
(``tests/torch_parallel_worker.py``, which imports no JAX) runs every case
on a tiny StyleGANv1 (startf 8, maxf 32, latent 32, 32 px;
``tests/test_torch_mis_align.py``'s sizes) with tpugan's flax-init
variables through the bridge and numpy draws of the global batch: SGv1
case 1 and case 2 (E_Blur) at batch 4, ``e_mis_align`` at batch 4 (VGG16
at 10 classes), ``embedding`` at batch 2 (fine-tuning E and optimising w,
2 iterations, the w-norm term on), ``update_w_avg`` with the group.

Every case runs in fp32 and in float64. Tolerances: against the port's
one-process step in float64, where the order of the reductions is the
only difference, each gradient within 1e-5 of its max |g|, each update
within 1e-5 of its max |update|, every scalar within 1e-5 of itself or of
its loss group's largest plus 16 fp32 epsilons (the masks, overlays and
guided gradients are fp32 in both packages), the embedding's w, images and histories within 1e-5 of their
max. (In fp32, LREQAdam's update amplifies the relative rounding of a
small gradient element by up to |g| / eps: single elements of an update
part by up to 0.6% of its max.) Against tpugan's step on
``make_mesh(jax.devices()[:2])`` in fp32, the existing single-device
tests' rules (``tests/test_torch_mis_align.py``: every scalar and gradient
at the whole-model rtol 2e-3 / atol 2e-4, the parameters by
``tests/test_torch_sgv1_train.py``'s LREQAdam rule;
``tests/test_torch_invert.py``'s fp32 rule for the inversion). The two
ranks' encoders are bitwise equal after every step. A DDP-style average of
per-rank losses (the cosine distance's dot products left per rank) misses
the one-process gradient: the comparison has the power to see it.
"""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_parallel_worker as worker
from test_torch_gradcam import CLASSES, jax_variables
from test_torch_sgv1_train import _check_trajectory, _jnoise, _recording, nonzero_leaves
from tpugan.invert import EmbeddingConfig as JEmbeddingConfig
from tpugan.invert import make_embedder as jmake_embedder
from tpugan.losses.vgg import VGG16 as JVGG16
from tpugan.models.encoders import Encoder as JEncoder
from tpugan.models.stylegan1 import StyleGANv1Generator as JGenerator
from tpugan.models.stylegan1 import StyleGANv1Mapping as JMapping
from tpugan.models.stylegan1 import truncation_coefs as jtruncation_coefs
from tpugan.models.stylegan2 import update_w_avg as jupdate_w_avg
from tpugan.ops.eq_lr import lreq_coef_tree
from tpugan.optim import lreq_adam as jlreq_adam
from tpugan.parallel.mesh import auto_mesh as jauto_mesh
from tpugan.parallel.mesh import make_mesh as jmake_mesh
from tpugan.train.e_align import SynthBatch as JSynthBatch
from tpugan.train.e_align import info_scalars as jinfo_scalars
from tpugan.train.e_align import init_train_state as jinit_train_state
from tpugan.train.e_align import make_train_step as jmake_train_step
from tpugan.train.e_mis_align import make_mis_align_step as jmake_mis_align_step
from tpugan_torch.io import bridge
from tpugan_torch.io.bridge import load_variables
from tpugan_torch.models import Encoder, StyleGANv1Generator, StyleGANv1Mapping
from tpugan_torch.parallel import auto_mesh
from tpugan_torch.parallel.mesh import mesh_shape, takes_part
from tpugan_torch.runtime import init_distributed, is_primary_host

ROOT = pathlib.Path(__file__).resolve().parent.parent
LAYERS, IMG, BATCH, EMBED_BATCH, LR, LATENT = 4, 32, 4, 2, 0.0015, 32
LOD = LAYERS - 1
GEN_KW = dict(startf=8, maxf=32, layer_count=LAYERS, latent_size=LATENT)
MAP_KW = dict(num_layers=2 * LAYERS, mapping_layers=2, latent_size=LATENT, dlatent_size=LATENT,
              mapping_fmaps=LATENT)
ENCODERS = {"E": {}, "E_Blur": {"use_blur": True}}
EMBED_CFG = dict(iterations=2, chunk=2, lr=0.01, beta=0.002)
MODEL_TOL = dict(rtol=2e-3, atol=2e-4)
SHARE_TOL = 1e-5  # of max |g|, max |update|: the order of the reductions is the only difference
# the masks, overlays and guided gradients are fp32 in both packages, also in
# a float64 run: their statistics keep a few fp32 ulps of the quantities
# they difference (the cosine's 1 - dot / norms near 1)
FP32_FLOOR = 16 * float(np.finfo(np.float32).eps)
GROUP_TIMEOUT = 600
DIST_ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
TPUGAN_CASES = ("case1", "case2", "mis_align", "embedding_finetune_e", "embedding_optimize_w", "update_w_avg")
# float64 against the port's one process (LREQAdam's update amplifies the
# relative rounding of a small gradient element by up to |g| / eps, so in
# fp32 the order of the reductions moves single elements of an update by up
# to 0.6% of its max); fp32 against tpugan, as its single-device tests
GROUP_CASES = ([(case, torch.float64) for case in worker.CASES]
               + [(case, torch.float32) for case in TPUGAN_CASES])


# ---------------------------------------------------------------------------
# auto_mesh and init_distributed


@pytest.mark.parametrize("space", [1, 2])
@pytest.mark.parametrize("devices", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("batch", [1, 2, 3, 4, 5, 6, 8])
def test_auto_mesh_is_tpugans(batch, devices, space, capsys):
    """The data axis (the largest divisor of the batch that fits), None
    for one device, the note where some are left out, and the refusal of a
    space axis wider than the devices."""
    if space > devices:
        with pytest.raises(ValueError):
            jauto_mesh(batch, space, jax.devices()[:devices])
        with pytest.raises(ValueError):
            mesh_shape(batch, devices, space)
        return
    want = jauto_mesh(batch, space, jax.devices()[:devices])
    want_note = capsys.readouterr().out
    got = mesh_shape(batch, devices, space)
    assert capsys.readouterr().out == want_note
    assert got == (None if want is None else tuple(want.devices.shape))


@pytest.fixture
def no_group(monkeypatch):
    for var in DIST_ENV:
        monkeypatch.delenv(var, raising=False)
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _refused(*args, **kwargs):
    raise RuntimeError("refused")


@pytest.mark.parametrize("rule", ["single", "environment", "explicit", "one_process_group"])
def test_init_distributed_rules(no_group, monkeypatch, tmp_path, rule):
    """tpugan's failure rule: a single process that cannot start a group
    goes on quietly (False, no group); a group that the environment
    (``WORLD_SIZE`` > 1) or the caller describes raises when it cannot
    start; a group of one process starts and is not data parallel.
    ``is_primary_host`` is True without a group and on rank 0."""
    if rule == "single":
        assert init_distributed() is False and not dist.is_initialized()
    elif rule == "environment":
        monkeypatch.setenv("WORLD_SIZE", "2")
        with pytest.raises(RuntimeError, match="refusing"):
            init_distributed()
    elif rule == "explicit":
        monkeypatch.setattr(dist, "init_process_group", _refused)
        with pytest.raises(RuntimeError, match="refusing"):
            init_distributed("localhost:29500", num_processes=2, process_id=0, backend="gloo")
    else:
        assert init_distributed(f"file://{tmp_path / 'store'}", num_processes=1, process_id=0,
                                backend="gloo") is False
        assert dist.is_initialized() and dist.get_world_size() == 1
        assert auto_mesh(4) is None and takes_part(None)
    assert is_primary_host()


# ---------------------------------------------------------------------------
# the group's cases


def _noise(shapes, rng):
    return [tuple(torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in block) for block in shapes]


def _port_named(encoder, tree):
    out = {}
    bridge._walk(encoder, jax.tree.map(np.asarray, tree), "", out)
    return out


def _build_spec(tmp):
    """tpugan's flax-init variables (constant leaves drawn), the port's
    modules loaded from them, and the numpy draws of the global batch."""
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
    z = torch.from_numpy(rng.randn(BATCH, LATENT).astype(np.float32))
    noise_g, noise_g2 = _noise(g_shapes, rng), _noise(g_shapes, rng)
    requests = {name: dict(z=z, noise_g=noise_g, noise_g2=noise_g2,
                           noise_e=_noise(Encoder(**GEN_KW, **kw).noise_shapes(BATCH, IMG), rng))
                for name, kw in ENCODERS.items()}
    jvgg, vgg_vars = jax_variables()
    vgg_path = tmp / "vgg.pt"
    torch.save(load_variables(worker.empty_vgg16(CLASSES), vgg_vars).state_dict(), vgg_path)
    embed = dict(imgs=torch.from_numpy(rng.uniform(-1, 1, (EMBED_BATCH, IMG, IMG, 3)).astype(np.float32)),
                 noise_e=_noise(Encoder(**GEN_KW).noise_shapes(EMBED_BATCH, IMG), rng),
                 noise_g=_noise(StyleGANv1Generator(**GEN_KW).noise_shapes(EMBED_BATCH), rng), cfg=EMBED_CFG)
    spec = dict(gen_kw=GEN_KW, map_kw=MAP_KW, lod=LOD, lr=LR, batch=BATCH, classes=CLASSES,
                gen=gen.state_dict(), gm=gm.state_dict(), encoder_kw=ENCODERS, encoders=encoders,
                requests=requests, vgg_path=str(vgg_path), embed=embed,
                w_avg=torch.from_numpy(rng.randn(8).astype(np.float32)),
                w=torch.from_numpy(rng.randn(BATCH, 8).astype(np.float32)), cases=GROUP_CASES)
    jax_side = dict(jgen=jgen, jgm=jgm, gen_vars=gen_vars, gm_vars=gm_vars, enc_vars=enc_vars, jvgg=jvgg,
                    vgg_vars=vgg_vars)
    return spec, jax_side


def _jax_closures(j, encoder, batch):
    jgen, jgm = j["jgen"], j["jgm"]
    je = JEncoder(**GEN_KW, **ENCODERS[encoder])
    extra = {k: v for k, v in j["enc_vars"][encoder].items() if k != "params"}
    coefs = jtruncation_coefs(jgm.num_layers)

    def synth(frozen, key, z):
        w1 = jgm.apply(frozen["gm"], frozen["z"], coefs, None)
        imgs1 = jgen.apply(frozen["gen"], w1, LOD, 1.0, frozen["noise_g"])
        const1 = jnp.repeat(frozen["gen"]["params"]["const"], batch, axis=0)
        return JSynthBatch(w1=w1, imgs1=imgs1, const1=const1, label=(frozen["noise_e"], frozen["noise_g2"]))

    def resynth(frozen, w2, b, key):
        return jgen.apply(frozen["gen"], w2, LOD, 1.0, b.label[1])

    def encode(params, b, key):
        return je.apply({**extra, "params": params}, b.imgs1, 0, b.label[0])

    return encode, synth, resynth


def _jax_train(spec, j, case):
    """tpugan's make_train_step or make_mis_align_step on a 2-device mesh,
    one step: its scalars, the gradients handed to the optimizer and the
    parameters after the step, by the port's names."""
    encoder = "E_Blur" if case == "case2" else "E"
    encode, synth, resynth = _jax_closures(j, encoder, BATCH)
    params = j["enc_vars"][encoder]["params"]
    updates = 2 if case == "case2" else 1
    opt = _recording(jlreq_adam(LR, coefs=lreq_coef_tree(params, j["enc_vars"][encoder]["lreq"])), keep=updates)
    mesh = jmake_mesh(jax.devices()[:2])
    kw = dict(encode=encode, synth=synth, resynth=resynth, optimizer=opt, z_dim=LATENT, batch_size=BATCH,
              mesh=mesh)
    r = spec["requests"][encoder]
    frozen = {"gen": j["gen_vars"], "gm": j["gm_vars"], "z": jnp.asarray(r["z"].numpy()),
              "noise_g": _jnoise(r["noise_g"]), "noise_e": _jnoise(r["noise_e"]), "noise_g2": _jnoise(r["noise_g2"])}
    state = jinit_train_state(params, opt)
    if case == "mis_align":
        step = jax.jit(jmake_mis_align_step(**kw, vgg=j["jvgg"], vgg_guided=JVGG16(num_classes=CLASSES, guided=True)))
        state, info = step(state, jnp.int32(0), frozen, j["vgg_vars"])
    else:
        step = jax.jit(jmake_train_step(**kw, case=int(case[-1])))
        state, info = step(state, jnp.int32(0), frozen)
    port = Encoder(**GEN_KW, **ENCODERS[encoder])
    return dict(info=jinfo_scalars(info), grads=[_port_named(port, g) for g in state.opt_state[-updates:]],
                params=_port_named(port, state.params))


def _jax_embedding(spec, j, optimize_e):
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
                            JEmbeddingConfig(optimize_e=optimize_e, **EMBED_CFG), frozen=j["gen_vars"],
                            mesh=jmake_mesh(jax.devices()[:2]))
    r = invert(jnp.asarray(e["imgs"].numpy()))
    return dict(w=np.asarray(r.w), images=np.asarray(r.images), w_best=np.asarray(r.w_best),
                loss_best=np.asarray(r.loss_best), msiv=np.asarray(r.msiv_history), wnorm=np.asarray(r.wnorm_history),
                losses=np.asarray([[float(a), float(b)] for a, b in r.losses]))


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """One gloo group of two processes runs every case; meanwhile this
    process runs the port's one-process cases and tpugan's mesh steps."""
    tmp = tmp_path_factory.mktemp("group")
    spec, j = _build_spec(tmp)
    spec_path = tmp / "spec.pt"
    torch.save(spec, spec_path)
    env = {k: v for k, v in os.environ.items() if k not in DIST_ENV}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_parallel_worker.py"), str(spec_path),
                               str(rank), "2", str(tmp / f"rank{rank}.pt")], cwd=tmp, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in range(2)]
    try:
        one = {case: worker.run_case(spec, case, dtype=torch.float64) for case in worker.CASES
               if case != "case2_per_rank_cosine"}
        tpugan = {case: _jax_train(spec, j, case) for case in ("case1", "case2", "mis_align")}
        tpugan.update({f"embedding_{mode}": _jax_embedding(spec, j, mode == "finetune_e")
                       for mode in ("finetune_e", "optimize_w")})
        w = jnp.asarray(spec["w"].numpy()).reshape(2, BATCH // 2, -1)
        tpugan["update_w_avg"] = np.asarray(jax.pmap(
            lambda x: jupdate_w_avg(jnp.asarray(spec["w_avg"].numpy()), x, 0.9, axis_name="data"),
            axis_name="data", devices=jax.devices()[:2])(w)[0])
        logs = [p.communicate(timeout=GROUP_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(logs)
    ranks = [torch.load(tmp / f"rank{rank}.pt", weights_only=False) for rank in range(2)]
    return dict(spec=spec, one=one, tpugan=tpugan, ranks=ranks)


def _f64(case):
    return worker.key(case, torch.float64)


def _f32(case):
    return worker.key(case, torch.float32)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _gradients(result):
    """The gradients handed to the optimizer, by parameter name."""
    return [{n: _np(g) for n, g in zip(result["names"], grads) if g is not None} for grads in result["grads"]]


def _group_scale(info, key):
    """The largest |scalar| of ``key``'s loss group (``loss_mask_mse_mean``:
    the ``loss_mask_*`` scalars). A statistic that differences two
    near-equal numbers (``mse_mean`` squares the difference of the means)
    keeps the rounding of its parts, which scales with them; the masks and
    overlays are fp32 in both packages, also in a float64 run."""
    prefix = key.rsplit("_", 2)[0] if key.endswith(("_mse_mean", "_mse_std")) else key.rsplit("_", 1)[0]
    return max(abs(v) for k, v in info.items() if k.startswith(prefix + "_") or k == key)


def _assert_ranks_agree(group, key):
    r0, r1 = (ranks[key] for ranks in group["ranks"])
    for name, p in r0["params"].items():
        assert torch.equal(p, r1["params"][name]), f"the ranks' {name} differ"
    for g0, g1 in zip(r0["grads"], r1["grads"]):
        assert all((a is None and b is None) or torch.equal(a, b) for a, b in zip(g0, g1))
    return r0


def _share_close(got, want, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    bound = SHARE_TOL * max(float(np.abs(want).max()), np.finfo(np.float32).tiny)
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{what}: {err:.3e} > {bound:.3e}"


@pytest.mark.parametrize("case", ["case1", "case2", "mis_align"])
def test_a_data_parallel_step_is_the_one_process_step(group, case):
    """Each rank's step on its two rows: the encoders bitwise equal, each
    gradient and the update the one-process step's on the four rows within
    the reductions' order, every scalar the global batch's."""
    _assert_ranks_agree(group, _f32(case))
    got, want = _assert_ranks_agree(group, _f64(case)), group["one"][case]
    before = group["spec"]["encoders"]["E_Blur" if case == "case2" else "E"]
    for a, b in zip(_gradients(got), _gradients(want)):
        assert a.keys() == b.keys()
        for name in b:
            _share_close(a[name], b[name], f"gradient of {name}")
    for name, p in want["params"].items():
        _share_close(got["params"][name] - before[name].double(), p - before[name].double(), f"update of {name}")
    assert got["info"].keys() == want["info"].keys()
    for key, value in want["info"].items():
        np.testing.assert_allclose(got["info"][key], value, rtol=SHARE_TOL,
                                   atol=SHARE_TOL * _group_scale(want["info"], key) + FP32_FLOOR, err_msg=key)


@pytest.mark.parametrize("case", ["case1", "case2", "mis_align"])
def test_a_data_parallel_step_is_tpugans_mesh_step(group, case):
    """The same step in fp32 against tpugan's on a 2-device mesh: every
    scalar and gradient at the whole-model tolerance, the parameters by the
    LREQAdam rule."""
    got, want = group["ranks"][0][_f32(case)], group["tpugan"][case]
    for key, value in want["info"].items():
        np.testing.assert_allclose(got["info"][key], value, **MODEL_TOL, err_msg=key)
    for a, b in zip(_gradients(got), want["grads"]):
        for name in b:
            np.testing.assert_allclose(a[name], b[name], **MODEL_TOL, err_msg=f"gradient of {name}")
    encoder = Encoder(**GEN_KW, **ENCODERS["E_Blur" if case == "case2" else "E"])
    _check_trajectory(encoder, {n: _np(p) for n, p in got["params"].items()}, want["params"], len(want["grads"]))
    assert got["info"]["loss_w_cosine"] > 0


def test_per_rank_averaging_of_the_cosine_misses(group):
    """The comparison's power: with the cosine distance's dot products per
    rank (the average of per-rank losses that DDP computes), the case-2
    gradient leaves the one-process one by far more than the tolerance."""
    got = _assert_ranks_agree(group, _f64("case2_per_rank_cosine"))
    want = group["one"]["case2"]
    worst = 0.0
    for a, b in zip(_gradients(got), _gradients(want)):
        for name in b:
            worst = max(worst, float(np.abs(a[name] - b[name]).max() / np.abs(b[name]).max()))
    assert worst > 100 * SHARE_TOL, worst


@pytest.mark.parametrize("mode", ["finetune_e", "optimize_w"])
def test_a_data_parallel_inversion_is_the_one_process_one(group, mode):
    """``embedding`` at batch 2 (one row a rank): w, the images, the
    snapshot and the histories of the global batch, held to the port's
    one-process inversion within the reductions' order and to tpugan's on
    its mesh at the whole-model tolerance; fine-tuning E, the ranks'
    gradients are equal, and the one process's; optimising w, the ranks'
    rows of the gradient are the one process's."""
    case = f"embedding_{mode}"
    one, jax_run = group["one"][case], group["tpugan"][case]
    for dtype_key in (_f64(case), _f32(case)):
        r0, r1 = (ranks[dtype_key] for ranks in group["ranks"])
        for key in one["info"]:
            assert torch.equal(r0["info"][key], r1["info"][key]), key
    r0, r1 = (ranks[_f64(case)] for ranks in group["ranks"])
    for key, value in one["info"].items():
        _share_close(r0["info"][key], value, key)
        np.testing.assert_allclose(_np(group["ranks"][0][_f32(case)]["info"][key]), jax_run[key], **MODEL_TOL,
                                   err_msg=key)
    if mode == "finetune_e":
        _assert_ranks_agree(group, _f64(case))
        for a, b in zip(_gradients(r0), _gradients(one)):
            for name in b:
                _share_close(a[name], b[name], f"gradient of {name}")
    else:
        for g0, g1, g in zip(r0["grads"], r1["grads"], one["grads"]):
            _share_close(torch.cat([g0[0], g1[0]]), g[0], "gradient of w")


def test_update_w_avg_with_a_group_is_tpugans_pmean(group):
    """``update_w_avg(..., axis_name=group)``: the ranks' batch means
    averaged, as tpugan's ``pmean`` over a 2-device axis, and the
    one-process update on the global batch."""
    got = [ranks[_f32("update_w_avg")]["w_avg"] for ranks in group["ranks"]]
    assert torch.equal(got[0], got[1])
    np.testing.assert_allclose(got[0].numpy(), group["tpugan"]["update_w_avg"], rtol=1e-6, atol=1e-7)
    _share_close(group["ranks"][0][_f64("update_w_avg")]["w_avg"], group["one"]["update_w_avg"]["w_avg"], "w_avg")


def test_the_ranks_never_import_jax(group):
    assert [ranks["_rank"] for ranks in group["ranks"]] == [0, 1]
    assert not any(ranks["_jax_loaded"] for ranks in group["ranks"])
