"""The space axis on E_BIG (mtype 4), E_PG (mtype 3) and Grad-CAM's VGG16
stack (``e_mis_align``, ``embedding --gradcam``): each op on row shards
against the whole image's, each step against the port's one-process step
and against tpugan's spatial mesh (CPU).

One gloo group of four processes on a ``FileStore``
(``tests/torch_spatial_worker.py``, which imports no JAX) runs:

* the ops, on meshes 1 x 2 and 1 x 4, in float64: a whole E_BIG and E_PG
  at 32 px (``tests/test_torch_train.py``'s E_BIG; E_PG at startf 8, maxf
  32) and a width-changing block of each (E_BIG's third batch norm and 1x1
  residual, E_PG's affine instance-normed residual), VGG16's convolutions
  with plain and guided ReLUs (its logits and last conv's output, whole; at
  1 x 4 its 4 px stage leaves each rank one row before a pool, so the rows
  are gathered there), ``grad_cam`` (CAM++ and plain), ``guided_backprop``
  and ``mask2cam`` on NHWC images, the VGG16 at ``CLASSES`` classes
  (``tests/test_torch_gradcam.py``). Gate: output, input gradient and
  parameter gradients within ``OPS_TOL`` (1e-12) of max |ref|.
* the steps, on meshes 1 x 2 and 2 x 2, in float64 against the port's
  one-process step with part 1's gates (``tests/test_torch_spatial_steps.py``:
  every scalar within ``EQUIV_LOSS_RTOL`` of its loss group's scale, each
  gradient within ``EQUIV_GRAD_TOL`` of its max |g|, the parameters by
  LREQAdam's rule, the ranks bitwise equal): the tiny BigGAN-deep + E_BIG
  (``tests/test_torch_train.py``'s CFG, every SelfAttn gamma 1, E_BIG's z
  head scaled) case 2, its lean step and case 2 under ``--remat_policy
  conv_outs`` (1 x 2, held to the plain case-2 step), PGGAN + E_PG case 2 (narrowed as
  ``tests/test_torch_pggan.py``), ``e_mis_align`` full and lean on the tiny
  SGv1 with E, and ``embedding --gradcam`` on mtype 4 fine-tuning E_BIG (2
  iterations, lr 0.0015). ``--bf16`` on the E_BIG case-2 step at 1 x 2:
  its distance from the float64 step within twice the one-process bf16
  step's.
* against tpugan's step on ``make_mesh(jax.devices()[:2], space=2)`` in
  fp32 (LPIPS off): the E_BIG case-2 step and ``e_mis_align``; scalars at
  rtol 2e-3 / atol 2e-4, gradients within ``EQUIV_SPATIAL_RTOL`` (1e-2) of
  their max |g|, the parameters by LREQAdam's rule.
* negative controls that the gates catch: every halo row zero in E_BIG's
  case-2 step, each image's overlay maximum over the rank's rows alone
  (``mask2cam``), and the guided gradient without the 1/S share.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_spatial_worker as worker
from test_torch_biggan import draw, randomized
from test_torch_gradcam import CLASSES, jax_variables
from test_torch_parallel import GEN_KW, IMG, LATENT, LAYERS, LOD, MAP_KW, MODEL_TOL, _group_scale, _jax_closures, _noise, _port_named
from test_torch_sgv1_train import _jnoise, _recording, nonzero_leaves
from test_torch_spatial_ops import OPS_TOL, close, spawn_group
from test_torch_spatial_steps import EQUIV_GRAD_TOL, EQUIV_LOSS_RTOL, EQUIV_SPATIAL_RTOL
from test_torch_train import CFG, ENC
from tpugan.models.biggan import BigGAN as JBigGAN
from tpugan.models.biggan import BigGANConfig as JConfig
from tpugan.models.encoders import BigGANEncoder as JBigGANEncoder
from tpugan.models.encoders import Encoder as JEncoder
from tpugan.models.stylegan1 import StyleGANv1Generator as JGenerator
from tpugan.models.stylegan1 import StyleGANv1Mapping as JMapping
from tpugan.losses.vgg import VGG16 as JVGG16
from tpugan.ops.eq_lr import lreq_coef_tree
from tpugan.optim import lreq_adam as jlreq_adam
from tpugan.parallel.mesh import make_mesh as jmake_mesh
from tpugan.train.e_align import SynthBatch as JSynthBatch
from tpugan.train.e_align import info_scalars as jinfo_scalars
from tpugan.train.e_align import init_train_state as jinit_train_state
from tpugan.train.e_align import make_train_step as jmake_train_step
from tpugan.train.e_mis_align import make_mis_align_step as jmake_mis_align_step
from tpugan_torch.io.bridge import load_variables
from tpugan_torch.models import BigGAN, BigGANConfig, BigGANEncoder, Encoder, PGEncoder, PGGANGenerator
from tpugan_torch.models import StyleGANv1Generator, StyleGANv1Mapping
from tpugan_torch.models.encoders import BigGANEncoderBlock, PGEncoderBlock
from tpugan_torch.ops.eq_lr import lreq_coefs
from tpugan_torch.parallel.spatial import runs_on_rows

BATCH, LR = 2, 0.0015  # a random E_BIG diverges at lr 0.01 (tpugan_torch/tools/inversion_lr.py)
BIG_ENC_KW = dict(ENC, img_size=IMG)
PG_KW = dict(resolution=IMG, z_space_dim=16, fmaps_base=512, fmaps_max=32)  # tests/test_torch_pggan.py's NARROW
PG_ENC_KW = dict(startf=8, maxf=32, layer_count=LAYERS, latent_size=16, img_size=IMG)
CAM_EMBED_CFG = dict(iterations=2, chunk=2, lr=LR, optimize_e=True)
OPS = ("ebig", "ebig_block", "epg", "epg_block", "vgg", "vgg_guided", "grad_cam", "grad_cam_plain",
       "guided_backprop", "mask2cam")
STEPS = ("big_case2", "big_lean", "pg_case2", "mis_full", "mis_lean", "cam_embed")
TPUGAN_STEPS = ("big_case2", "mis_full")
REMAT = {"big_conv_outs": "big_case2"}  # a remat step on rows: the plain step's update
NEGATIVE = (("zero_halo_ebig", "big_case2"), ("local_max", "mask2cam"), ("no_share", "guided_backprop"))
# E_PG's conv_3.bias feeds an instance norm: its gradient is zero but for
# rounding, so LREQAdam's first update moves it by +-lr c at random
# (tests/test_torch_pggan.py): held to the per-element bound only
ROUNDING_ONLY = {"pg_case2": ("conv_3.bias",)}
# E_BIG's spectral norms read sigma in fp32 (both packages), also in a
# float64 run: the part of an SN weight's gradient that flows through sigma
# keeps fp32's rounding of its scalar coefficient
SN_WEIGHTS = (".scale.weight", ".offset.weight")
SN_TOL = 16 * float(np.finfo(np.float32).eps)  # of the module's largest gradient
# the masks, overlays and guided gradients are fp32 in both packages, also in
# a float64 run (tests/test_torch_parallel.py's FP32_FLOOR): the statistics of
# their log-only loss groups that difference two fp32 sums of N x H x W x 3
# elements (the squared differences of the means and of the stds) keep
# those sums' rounding, about sqrt(n) eps32 of each, times the ratio of the
# sums to their difference (about 10 here): held to 1e-3 of themselves
FP32_GROUPS = ("loss_mask_", "loss_gcam_", "loss_grad_")
FP32_STAT_RTOL = 1e-3


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float64))


def _f(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def _drawn(module, rng, scale=0.1):
    """``module``'s state with its constant leaves drawn around their
    constant, so that every leaf reaches the output."""
    state = {}
    for name, v in module.state_dict().items():
        v = v.clone()
        if v.numel() and v.is_floating_point() and torch.all(v == v.flatten()[0]):
            v = v + _f(rng.randn(*v.shape) * scale)
        state[name] = v
    return state


def _kind(case):
    return "cam_embedding" if case == "cam_embed" else "step2"


def _runs():
    """(name, mesh, kind, case, dtype) of every run: the 1 x 2 ones shared
    between the two pairs of ranks."""
    pairs = iter(["1x2", "1x2b"] * 32)
    runs = []
    for case in OPS:
        runs.append((f"{case}@1x2", next(pairs), "op2", case, torch.float64))
        runs.append((f"{case}@1x4", "1x4", "op2", case, torch.float64))
    for case in STEPS:
        runs.append((f"{case}@1x2", next(pairs), _kind(case), case, torch.float64))
        runs.append((f"{case}@2x2", "2x2", _kind(case), case, torch.float64))
    for case in TPUGAN_STEPS:
        runs.append((f"{case}@1x2@fp32", next(pairs), "step2", case, torch.float32))
    for case in REMAT:
        runs.append((f"{case}@1x2", next(pairs), "step2", case, torch.float64))
    runs.append(("big_case2@1x2@bf16", next(pairs), "step2", "big_case2", "bf16"))
    for kind, case in NEGATIVE:
        runs.append((f"{kind}@1x2", next(pairs), kind, case, torch.float64))
    return runs


def _sgv1(rng, key):
    """The tiny SGv1 and its E (tests/test_torch_parallel.py's), tpugan's
    flax-init variables with their constant leaves drawn."""
    g_shapes = StyleGANv1Generator(**GEN_KW).noise_shapes(BATCH)
    jgen, jgm = JGenerator(**GEN_KW), JMapping(**MAP_KW)
    gen_vars = jax.tree.map(np.asarray, jax.jit(lambda w, n: jgen.init(key, w, LOD, 1.0, n))(
        jnp.zeros((BATCH, 2 * LAYERS, LATENT)), _jnoise(_noise(g_shapes, rng))))
    gen_vars = {"params": nonzero_leaves(gen_vars["params"], rng)}
    gm_vars = jax.tree.map(np.asarray, jax.jit(jgm.init)(key, jnp.zeros((1, LATENT))))
    je = JEncoder(**GEN_KW)
    e_shapes = Encoder(**GEN_KW).noise_shapes(BATCH, IMG)
    variables = jax.tree.map(np.asarray, jax.jit(lambda x, n: je.init(key, x, 0, n))(
        jnp.zeros((BATCH, IMG, IMG, 3)), _jnoise(_noise(e_shapes, rng))))
    enc_vars = {**variables, "params": nonzero_leaves(variables["params"], rng)}
    gen = load_variables(StyleGANv1Generator(**GEN_KW), gen_vars, unused=[f"to_rgb_{i}" for i in range(LOD)])
    gm = load_variables(StyleGANv1Mapping(**MAP_KW), gm_vars)
    enc = load_variables(Encoder(**GEN_KW), enc_vars)
    request = dict(z=_f(rng.randn(BATCH, LATENT)), noise_g=_noise(g_shapes, rng), noise_g2=_noise(g_shapes, rng),
                   noise_e=_noise(e_shapes, rng))
    spec = dict(gen_kw=GEN_KW, map_kw=MAP_KW, lod=LOD, gen=gen.state_dict(), gm=gm.state_dict(),
                encoder_kw={"E": {}}, encoders={"E": enc.state_dict()}, requests={"E": request})
    return spec, dict(jgen=jgen, jgm=jgm, gen_vars=gen_vars, gm_vars=gm_vars, enc_vars={"E": enc_vars})


def _biggan(rng):
    """tests/test_torch_train.py's BigGAN-deep (drawn, every SelfAttn gamma
    1) and E_BIG (flax init drawn, its z head scaled), and a request."""
    jmodel, je = JBigGAN(JConfig(**CFG)), JBigGANEncoder(**ENC)
    shape = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8)), jnp.zeros((1, 10)), 0.4))
    gen_vars = randomized(jax.tree.map(lambda x: np.zeros(x.shape, x.dtype), shape), rng)
    for node in gen_vars["params"]["generator"].values():
        if "gamma" in node:
            node["gamma"] = np.ones_like(node["gamma"])
    shapes = BigGANEncoder(**BIG_ENC_KW).noise_shapes(BATCH, IMG)
    _, jnoise0 = draw(shapes, np.random.RandomState(1))
    enc_vars = randomized(jax.jit(je.init)({"params": jax.random.PRNGKey(0)}, jnp.zeros((BATCH, IMG, IMG, 3)),
                                           jnp.zeros((BATCH, 16)), jnoise0), rng)
    head = enc_vars["params"]["new_final_2"]
    for leaf in head:
        head[leaf] = head[leaf] * np.float32(0.03)
    zt = (0.4 * np.clip(rng.randn(BATCH, 8), -2, 2)).astype(np.float32)
    label = np.eye(10, dtype=np.float32)[[rng.randint(10)] * BATCH]
    noise, jnoise = draw(shapes, rng)
    gen = load_variables(BigGAN(BigGANConfig(**CFG)), gen_vars)
    enc = load_variables(BigGANEncoder(**BIG_ENC_KW), enc_vars)
    spec = dict(big_cfg=CFG, big=gen.state_dict(), big_enc_kw=BIG_ENC_KW, big_enc=enc.state_dict(),
                big_request=dict(z=_f(zt), noise_g=None, noise_e=noise, noise_g2=None, label=_f(label)))
    return spec, dict(jmodel=jmodel, je=je, big_vars=gen_vars, big_enc_vars=enc_vars, zt=zt, label=label,
                      jnoise=jnoise)


def _pggan(rng, g):
    gen, enc = PGGANGenerator(**PG_KW, generator=g), PGEncoder(**PG_ENC_KW, generator=g)
    return dict(pg_kw=PG_KW, pg=_drawn(gen, rng), pg_enc_kw=PG_ENC_KW, pg_enc=_drawn(enc, rng),
                pg_request=dict(z=_f(rng.randn(BATCH, 16)), noise_g=None, noise_g2=None,
                                noise_e=_noise(enc.noise_shapes(BATCH, IMG), rng)))


def _ops(rng, g, big_enc_state):
    """The ops' modules, inputs and cotangents (float64)."""
    ops = {}
    x = _t(rng.randn(BATCH, 3, IMG, IMG))
    cond = _t(rng.randn(BATCH, 16) * 0.5)
    enc = BigGANEncoder(**BIG_ENC_KW)
    noise = [tuple(_t(rng.randn(*s)) for s in block) for block in enc.noise_shapes(BATCH, IMG)]
    ops["ebig"] = dict(x=x, dim=2, kw=BIG_ENC_KW, state=big_enc_state, cond=cond, noise=noise,
                       cot=_t(rng.randn(BATCH * (16 + 8))))
    xb = _t(rng.randn(BATCH, 8, 16, 12))
    block = BigGANEncoderBlock(8, 12, cond_dim=16, generator=g)
    ops["ebig_block"] = dict(x=xb, dim=2, kw=dict(in_features=8, out_features=12, cond_dim=16),
                             state=_drawn(block, rng), cond=cond, noise=[_t(rng.randn(BATCH, 1, 16, 12))] * 2,
                             cot=_t(rng.randn(BATCH, 12, 8, 6)))
    pg = PGEncoder(**PG_ENC_KW, generator=g)
    ops["epg"] = dict(x=x, dim=2, kw=PG_ENC_KW, state=_drawn(pg, rng),
                      noise=[tuple(_t(rng.randn(*s)) for s in b) for b in pg.noise_shapes(BATCH, IMG)],
                      cot=_t(rng.randn(BATCH * (32 * 4 * 4 + 16))))
    pgb = PGEncoderBlock(8, 12, generator=g)
    ops["epg_block"] = dict(x=xb, dim=2, kw=dict(in_features=8, out_features=12), state=_drawn(pgb, rng),
                            noise=[_t(rng.randn(BATCH, 1, 16, 12)), _t(rng.randn(BATCH, 1, 16, 12))],
                            cot=_t(rng.randn(BATCH, 12, 8, 6)))
    for case in ("vgg", "vgg_guided"):
        ops[case] = dict(x=_t(rng.uniform(-1, 1, (BATCH, 3, IMG, IMG))), dim=2,
                         cot=_t(rng.randn(BATCH * (CLASSES + 512 * 2 * 2))))
    imgs = _t(rng.uniform(-1, 1, (BATCH, IMG, IMG, 3)))
    for case in ("grad_cam", "grad_cam_plain", "guided_backprop"):
        ops[case] = dict(x=imgs, dim=1, cot=None)
    ops["mask2cam"] = dict(x=imgs, dim=1, cot=None, mask=_t(rng.uniform(0, 1, (BATCH, IMG, IMG, 1))))
    return ops


def _build_spec(tmp):
    rng = np.random.RandomState(0)
    key = jax.random.PRNGKey(0)
    g = torch.Generator().manual_seed(0)
    sgv1, j = _sgv1(rng, key)
    big, jbig = _biggan(rng)
    j.update(jbig)
    jvgg, vgg_vars = jax_variables()
    vgg_path = tmp / "vgg.pt"
    torch.save(load_variables(worker.empty_vgg16(CLASSES), vgg_vars).state_dict(), vgg_path)
    j.update(jvgg=jvgg, vgg_vars=vgg_vars)
    shapes = BigGANEncoder(**BIG_ENC_KW).noise_shapes(BATCH, IMG)
    cam_embed = dict(imgs=_f(rng.uniform(-1, 1, (BATCH, IMG, IMG, 3))), noise_e=_noise(shapes, rng),
                     zt=_f((0.4 * np.clip(rng.randn(BATCH, 8), -2, 2))),
                     label=_f(np.eye(10)[[rng.randint(10)] * BATCH]), cfg=CAM_EMBED_CFG)
    spec = dict(sgv1, **big, **_pggan(rng, g), lr=LR, classes=CLASSES, vgg_path=str(vgg_path), cam_embed=cam_embed,
                ops2=_ops(rng, g, {k: v.double() if v.is_floating_point() else v for k, v in big["big_enc"].items()}),
                runs=_runs())
    return spec, j


def _jax_big_step(spec, j):
    """tpugan's E_BIG case-2 step on ``make_mesh(jax.devices()[:2],
    space=2)``: scalars, the gradients handed to the optimizer and the
    parameters after the step, by the port's names."""
    jmodel, je = j["jmodel"], j["je"]
    enc_vars = j["big_enc_vars"]
    extra = {k: v for k, v in enc_vars.items() if k not in ("params", "sn")}

    def synth(frozen, key, z):
        imgs1, cond = jmodel.apply(frozen["gen"], frozen["zt"], frozen["label"], 0.4)
        return JSynthBatch(w1=frozen["zt"], imgs1=imgs1, const1=cond, label=(frozen["label"], frozen["noise"]))

    def resynth(frozen, w2, batch, key):
        return jmodel.apply(frozen["gen"], w2, batch.label[0], 0.4)[0]

    def encode(params, batch, key, sn=None):
        return je.apply({**extra, "params": params, "sn": sn}, batch.imgs1, batch.const1, batch.label[1])

    opt = _recording(jlreq_adam(LR, coefs=lreq_coef_tree(enc_vars["params"], enc_vars["lreq"])), keep=2)
    step = jax.jit(jmake_train_step(encode=encode, synth=synth, resynth=resynth, optimizer=opt, z_dim=8,
                                    batch_size=BATCH, case=2, mesh=jmake_mesh(jax.devices()[:2], space=2),
                                    spatial=True))
    frozen = {"gen": j["big_vars"], "zt": jnp.asarray(j["zt"]), "label": jnp.asarray(j["label"]),
              "noise": j["jnoise"]}
    state, info = step(jinit_train_state(enc_vars["params"], opt, sn=enc_vars["sn"]), jnp.int32(0), frozen)
    port = BigGANEncoder(**BIG_ENC_KW)
    return dict(info=jinfo_scalars(info), grads=[_port_named(port, g) for g in state.opt_state[-2:]],
                params=_port_named(port, state.params))


def _jax_mis_step(spec, j):
    """tpugan's ``e_mis_align`` step on ``make_mesh(jax.devices()[:2],
    space=2)``."""
    encode, synth, resynth = _jax_closures(j, "E", BATCH)
    params = j["enc_vars"]["E"]["params"]
    opt = _recording(jlreq_adam(LR, coefs=lreq_coef_tree(params, j["enc_vars"]["E"]["lreq"])), keep=1)
    r = spec["requests"]["E"]
    frozen = {"gen": j["gen_vars"], "gm": j["gm_vars"], "z": jnp.asarray(r["z"].numpy()),
              "noise_g": _jnoise(r["noise_g"]), "noise_e": _jnoise(r["noise_e"]), "noise_g2": _jnoise(r["noise_g2"])}
    step = jax.jit(jmake_mis_align_step(encode=encode, synth=synth, resynth=resynth, optimizer=opt, z_dim=LATENT,
                                        batch_size=BATCH, vgg=j["jvgg"],
                                        vgg_guided=JVGG16(num_classes=CLASSES, guided=True),
                                        mesh=jmake_mesh(jax.devices()[:2], space=2), spatial=True))
    state, info = step(jinit_train_state(params, opt), jnp.int32(0), frozen, j["vgg_vars"])
    port = Encoder(**GEN_KW)
    return dict(info=jinfo_scalars(info), grads=[_port_named(port, g) for g in state.opt_state[-1:]],
                params=_port_named(port, state.params))


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The group runs every case; meanwhile this process runs the port's
    one-process cases and tpugan's spatial mesh steps."""
    tmp = tmp_path_factory.mktemp("spatial_part2")
    spec, j = _build_spec(tmp)
    wait = spawn_group(spec, tmp)
    whole = {case: worker.run(spec, f"{case}@1x4") for case in OPS}
    one = {case: worker.run(spec, f"{case}@2x2") for case in STEPS}
    one["bf16"] = worker.run2(spec, "step2", "big_case2", None, "bf16")
    tpugan = {"big_case2": _jax_big_step(spec, j), "mis_full": _jax_mis_step(spec, j)}
    return dict(spec=spec, whole=whole, one=one, tpugan=tpugan, ranks=wait())


def _np(x):
    return x.detach().double().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, dtype=np.float64)


def _of(group, name):
    """The run's result on each rank of its mesh, checked bitwise equal
    across the ranks."""
    ranks = [r[name] for r in group["ranks"] if name in r]
    assert ranks, name
    for other in ranks[1:]:
        for p, v in ranks[0]["params"].items():
            assert torch.equal(v, other["params"][p]), f"{name}: the ranks' {p} differ"
    return ranks


def _gradients(result):
    return [{n: _np(g) for n, g in zip(result["names"], grads) if g is not None} for grads in result["grads"]]


def _worst_gradient(got, want):
    """The largest distance of a gradient from the reference's, each as a
    share of its max |g| (of the update's largest max |g| times 1e-6 where
    that is larger: a gradient that is zero but for rounding)."""
    worst = 0.0
    for a, b in zip(_gradients(got), _gradients(want), strict=True):
        assert a.keys() == b.keys()
        floor = 1e-6 * max(float(np.abs(g).max()) for g in b.values())
        for n in b:
            scale = max(float(np.abs(b[n]).max()), floor, np.finfo(np.float64).tiny)
            worst = max(worst, float(np.abs(a[n] - b[n]).max()) / scale)
    return worst


def _encoder(case):
    if case.startswith(("big", "cam")):
        return BigGANEncoder(**BIG_ENC_KW)
    if case.startswith("pg"):
        return PGEncoder(**PG_ENC_KW)
    return Encoder(**GEN_KW)


def _check_update(case, got, want, updates):
    """The parameters after the update(s) by LREQAdam's rule
    (``tests/test_torch_sgv1_train.py::_check_trajectory``): an element may
    part by 2 lr c an update, a parameter by 5% of lr c on average; a
    parameter of :data:`ROUNDING_ONLY` by the per-element bound only."""
    coefs = lreq_coefs(_encoder(case))
    for name, w in want.items():
        step = LR * coefs[name]
        diff = np.abs(_np(got[name]) - _np(w))
        assert diff.max() <= 2 * step * updates, f"{name}: max |diff| {diff.max():.3e} > 2 lr c x {updates}"
        if not any(name.endswith(s) for s in ROUNDING_ONLY.get(case, ())):
            assert diff.mean() <= 0.05 * step, f"{name}: mean |diff| {diff.mean():.3e} > {0.05 * step:.3e}"


@pytest.mark.parametrize("mesh", ["1x2", "1x4"])
@pytest.mark.parametrize("case", OPS)
def test_a_part2_op_on_row_shards_is_the_whole_image_op(group, case, mesh):
    """The op's output, its input's gradient and its parameters' gradients
    on every rank, gathered, against the whole image's in float64."""
    name = f"{case}@{mesh}"
    ranks = [r[name] for r in group["ranks"] if name in r]
    assert len(ranks) == int(mesh[-1])
    want = group["whole"][case]
    for got in ranks:
        close(got["out"], want["out"], f"{name} output")
        if want["grad"] is not None:
            close(got["grad"], want["grad"], f"{name} input gradient")
        assert got["params"].keys() == want["params"].keys()
        scale = max((float(g.abs().max()) for g in want["params"].values()), default=0.0)
        for p, g in want["params"].items():
            tol = SN_TOL if p.endswith(SN_WEIGHTS) else OPS_TOL
            close(got["params"][p], g, f"{name} gradient of {p}", tol=tol, scale=scale)
    assert float(want["out"].abs().max()) > 0


def test_vgg16_shards_its_convolutions_before_the_thin_level_gather(group):
    """VGG16's convolutions run on row shards: at 1 x 2 every stage does
    and only its last conv's output is gathered; at 1 x 4 the rank's halo
    exchanges of the first three stages come before the gather of the
    4 px stage (one row a rank, then a pool), and the rest runs whole."""
    half = next(r["vgg@1x2"]["events"] for r in group["ranks"] if "vgg@1x2" in r)
    assert [e for e, _ in half] == ["halo"] * 13 + ["gather"] and half[-2] == ("halo", 1)
    quarter = group["ranks"][0]["vgg@1x4"]["events"]
    assert [e for e, _ in quarter] == ["halo"] * 7 + ["gather"]
    assert quarter[-1] == ("gather", 1) and [rows for _, rows in quarter[:7]] == [8, 8, 4, 4, 2, 2, 2]
    # the rule: a stage runs on rows with a row at least, and an even count before its pool
    assert [runs_on_rows(r, pool) for r, pool in ((8, True), (4, True), (2, True), (1, True), (1, False))] == [
        True, True, True, False, True]


def test_the_part2_ranks_never_import_jax(group):
    assert [r["_rank"] for r in group["ranks"]] == [0, 1, 2, 3]
    assert not any(r["_jax_loaded"] for r in group["ranks"])


@pytest.mark.parametrize("case,mesh", [(c, m) for c in STEPS for m in ("1x2", "2x2")]
                         + [(c, "1x2") for c in REMAT])
def test_a_part2_spatial_step_is_the_one_process_step(group, case, mesh):
    """Each rank's step (or inversion) on its rows against the one-process
    one in float64: every scalar, each gradient handed to LREQAdam and the
    parameters after the update(s); a remat step against the plain step."""
    want = group["one"][REMAT.get(case, case)]
    for got in _of(group, f"{case}@{mesh}"):
        assert _worst_gradient(got, want) <= EQUIV_GRAD_TOL
        for key, value in want["info"].items():
            if isinstance(value, torch.Tensor):  # the inversion's w, images and histories
                v = _np(value)
                assert float(np.abs(_np(got["info"][key]) - v).max()) <= EQUIV_LOSS_RTOL * float(np.abs(v).max()), key
                continue
            fp32_stat = key.startswith(FP32_GROUPS) and key.endswith(("_mse_mean", "_mse_std"))
            np.testing.assert_allclose(got["info"][key], value, rtol=FP32_STAT_RTOL if fp32_stat else EQUIV_LOSS_RTOL,
                                       atol=EQUIV_LOSS_RTOL * _group_scale(want["info"], key), err_msg=key)
        _check_update(case, got["params"], want["params"], len(want["grads"]))


def test_the_lean_steps_keep_the_full_steps_trajectory(group):
    """``e_mis_align``'s lean step on rows: the full step's update, bit
    for bit (the attention stack is log-only)."""
    for mesh in ("1x2", "2x2"):
        full, lean = _of(group, f"mis_full@{mesh}")[0], _of(group, f"mis_lean@{mesh}")[0]
        for name, p in full["params"].items():
            assert torch.equal(p, lean["params"][name]), f"{mesh}: {name}"


def test_a_bf16_part2_step_keeps_to_the_one_process_bf16_step(group):
    """``e_align --mtype 4 --bf16 --space_shards 2``: its distance from the
    float64 step, gradient by gradient and scalar by scalar, within twice
    the one-process bf16 step's."""
    got, own, ref = _of(group, "big_case2@1x2@bf16")[0], group["one"]["bf16"], group["one"]["big_case2"]
    for a, b, r in zip(_gradients(got), _gradients(own), _gradients(ref), strict=True):
        for name in r:
            share = lambda x: float(np.abs(x - r[name]).max()) / max(float(np.abs(r[name]).max()), 1e-30)  # noqa: E731
            assert share(a[name]) <= 2 * share(b[name]) + EQUIV_GRAD_TOL, name
    for key, value in ref["info"].items():
        scale = EQUIV_LOSS_RTOL * _group_scale(ref["info"], key)
        assert abs(got["info"][key] - value) <= 2 * abs(own["info"][key] - value) + scale, key


@pytest.mark.parametrize("case", TPUGAN_STEPS)
def test_a_part2_spatial_step_is_tpugans_spatial_mesh_step(group, case):
    """In fp32 against tpugan's spatial step on its 1 x 2 mesh."""
    got, want = _of(group, f"{case}@1x2@fp32")[0], group["tpugan"][case]
    for key, value in want["info"].items():
        np.testing.assert_allclose(got["info"][key], value, **MODEL_TOL, err_msg=key)
    for a, b in zip(_gradients(got), want["grads"], strict=True):
        for name in b:
            share = float(np.abs(a[name] - b[name]).max()) / max(float(np.abs(b[name]).max()), 1e-30)
            assert share <= EQUIV_SPATIAL_RTOL, f"gradient of {name}: {share:.3e}"
    _check_update(case, got["params"], want["params"], len(want["grads"]))
    assert got["info"]["loss_imgs_ssim"] > 0


@pytest.mark.parametrize("kind,case", NEGATIVE)
def test_the_part2_gates_see_a_broken_shard(group, kind, case):
    """Every halo row of E_BIG's convolutions zero (the step's gradients),
    each image's overlay maximum over the rank's rows alone, and the guided
    gradient without its 1/S share (the ops' outputs): each leaves the
    one-process result by far more than its gate."""
    got = _of(group, f"{kind}@1x2")[0]
    if case in OPS:
        want = group["whole"][case]["out"]
        share = float((got["out"] - want).abs().max()) / float(want.abs().max())
        assert share > 1e6 * OPS_TOL, share
        return
    worst = _worst_gradient(got, group["one"][case])
    assert worst > 100 * EQUIV_GRAD_TOL, worst
