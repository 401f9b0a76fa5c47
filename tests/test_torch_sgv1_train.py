"""tpugan_torch's StyleGANv1 encoder training (``e_align --mtype 1``: case 1
and its lean step, case 2 with E_Blur, the ablation ladder) vs tpugan (CPU).

Every ablation encoder is held to tpugan's ``Encoder`` through the bridge.
The train step is held to tpugan's own ``make_train_step``: the port's side
is the CLI's ``build_trainer`` (its presets, closures and optimizer), whose
generator, mapping and encoder then take tpugan's variables through the
bridge; tpugan's side is its ``make_train_step`` with its CLI's presets,
read from ``tpugan/cli/e_align.py``, and closures that apply the injected
inputs: its synth reads z and the noise from ``frozen`` (the encoder's and
the resynthesis's noise ride in ``SynthBatch.label``). The variables are
tpugan's flax init (the init law), the inputs numpy draws.
"""

import ast
import json
import pathlib
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_biggan import draw
from test_torch_train import CFG as BIGGAN_CFG
from tpugan.cli.common import _encoder_variant_kwargs as jvariant_kwargs
from tpugan.losses.lpips import make_lpips_fn as jmake_lpips_fn
from tpugan.losses.lpips import random_params as jlpips_params
from tpugan.models.encoders import Encoder as JEncoder
from tpugan.models.stylegan1 import StyleGANv1Generator as JGenerator
from tpugan.models.stylegan1 import StyleGANv1Mapping as JMapping
from tpugan.models.stylegan1 import truncation_coefs as jtruncation_coefs
from tpugan.ops.eq_lr import lreq_coef_tree
from tpugan.optim import lreq_adam as jlreq_adam
from tpugan.train.e_align import SynthBatch as JSynthBatch
from tpugan.train.e_align import info_scalars as jinfo_scalars
from tpugan.train.e_align import init_train_state as jinit_train_state
from tpugan.train.e_align import make_train_step as jmake_train_step
from torch_flag_checks import check_flag_runs
from tpugan_torch.cli import common, e_align
from tpugan_torch.io import bridge
from tpugan_torch.io.bridge import load_variables
from tpugan_torch.losses.lpips import LPIPS, make_lpips_fn
from tpugan_torch.models import BigGANConfig, Encoder
from tpugan_torch.ops import cuda
from tpugan_torch.ops.eq_lr import lreq_coefs
from tpugan_torch.train.e_align import Request

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
# tests/test_stylegan1.py:134 for whole models, as tests/test_torch_train.py
MODEL_TOL = dict(rtol=2e-3, atol=2e-4)
GRAD_TOL = dict(rtol=2e-3, atol=2e-4)

# ---------------------------------------------------------------------------
# the encoders

# tests/test_encoders.py:108's sizes
ENC_SMALL = dict(startf=4, maxf=16, layer_count=3, latent_size=8)
VARIANTS = {
    "ablation1_E_Blur_Z": jvariant_kwargs(1, 2),
    "ablation2_E_Blur_W_2": jvariant_kwargs(2, 2),
    "ablation3_E_Blur_W": jvariant_kwargs(3, 2),
    "E_Blur": jvariant_kwargs(4, 2),
    "E_v2_std": dict(style_stats="std"),
    "E_v2_std_blur": dict(style_stats="std", use_blur=True),
    "E_v1": dict(block_version=1),
    "E_v1_no_noise": dict(block_version=1, use_noise=False),
}


def nonzero_leaves(params, rng):
    """tpugan's variables with its constant-initialised leaves (biases and
    noise weights at 0, the affine IN's scale at 1) drawn around their
    constant, so that every leaf reaches the output; kernels keep the init."""
    def draw_leaf(path, x):
        x = np.asarray(x)
        if x.size and np.all(x == x.flat[0]):
            return (x + rng.randn(*x.shape) * 0.1).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(draw_leaf, params)


def _jnoise(port_noise, dtype=np.float32):
    """The port's noise for tpugan (NHWC); None for an encoder without noise,
    which E_v1's block reads whatever its use_noise."""
    if not any(port_noise):
        return None
    return [tuple(jnp.asarray(n.numpy().transpose(0, 2, 3, 1).astype(dtype)) for n in block)
            for block in port_noise]


def _encoder_pair(kw, img, start_block=0, seed=0):
    rng = np.random.RandomState(seed)
    port = Encoder(**kw)
    res = img << start_block
    noise = [tuple(torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in block)
             for block in port.noise_shapes(2, res)]
    x = rng.randn(2, img, img, 3).astype(np.float32)
    je = JEncoder(**kw)
    variables = jax.tree.map(np.asarray, je.init(jax.random.PRNGKey(seed), jnp.asarray(x), start_block,
                                                 _jnoise(noise)))
    variables = {**variables, "params": nonzero_leaves(variables["params"], rng)}
    unused = tuple(f"block_{i}" for i in range(start_block))
    load_variables(port, variables, unused=unused)
    return port, je, variables, x, noise


@pytest.mark.parametrize("name", VARIANTS)
def test_encoder_variant_matches_tpugan(name):
    kw = dict(ENC_SMALL, **VARIANTS[name])
    port, je, variables, x, noise = _encoder_pair(kw, 16)
    jconst, jw = je.apply(variables, jnp.asarray(x), 0, _jnoise(noise))
    with torch.no_grad():
        const, w = port(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), noise)
    np.testing.assert_allclose(const.numpy().transpose(0, 2, 3, 1), np.asarray(jconst), **MODEL_TOL)
    if jw is None:
        assert w is None and not kw.get("z_head")
    else:
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), **MODEL_TOL)
    block = variables["params"]["block_0"]
    noisy = kw.get("use_noise", True) or kw.get("block_version") == 1
    assert ("noise_weight_1" in block) == noisy == hasattr(port.block_0, "noise_weight_1")
    assert ("inver_mod1" in block) == (kw.get("style_mode") != "none")
    if kw.get("z_head"):
        assert w.shape == (2, kw["latent_size"])
    if not kw.get("use_noise", True):
        assert all(block_ == () for block_ in port.noise_shapes(2, 16))


def test_encoder_single_style_emits_the_post_conv_w_twice():
    port, *_ , x, noise = _encoder_pair(dict(ENC_SMALL, **VARIANTS["ablation2_E_Blur_W_2"]), 16)
    with torch.no_grad():
        _, w = port(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), noise)
    torch.testing.assert_close(w[:, 0::2], w[:, 1::2], rtol=0, atol=0)


@pytest.mark.parametrize("blur", [False, True])
def test_encoder_start_block_matches_tpugan(blur):
    """The progressive offset: blocks before ``start_block`` are skipped and
    from_rgb feeds block ``start_block`` an image of ``R >> start_block``
    pixels (from_rgb's width is that block's when startf == maxf)."""
    kw = dict(startf=16, maxf=16, layer_count=3, latent_size=8, use_blur=blur)
    port, je, variables, x, noise = _encoder_pair(kw, 8, start_block=1, seed=3)
    assert "block_0" not in variables["params"]
    jconst, jw = je.apply(variables, jnp.asarray(x), 1, _jnoise(noise))
    with torch.no_grad():
        const, w = port(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), noise, start_block=1)
    assert w.shape == (2, 4, 8)
    np.testing.assert_allclose(const.numpy().transpose(0, 2, 3, 1), np.asarray(jconst), **MODEL_TOL)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **MODEL_TOL)


@pytest.mark.parametrize("ablation", range(9))
@pytest.mark.parametrize("case", [1, 2])
def test_encoder_presets_are_tpugan_s(ablation, case):
    assert common._encoder_variant_kwargs(ablation, case) == jvariant_kwargs(ablation, case)


def _tpugan_presets():
    """tpugan's CLI tables (image_weights, latent_weights), read from its
    source: the dicts subscripted by the ablation in ``main``."""
    tree = ast.parse((ROOT / "tpugan/cli/e_align.py").read_text())
    found = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Subscript) \
                and isinstance(node.value.value, ast.Dict):
            found[node.targets[0].id] = ast.literal_eval(node.value.value)
    return found


def test_ablation_weights_are_tpugan_s():
    found = _tpugan_presets()
    assert found["image_weights"] == e_align.ABLATION_IMAGE_WEIGHTS
    assert found["latent_weights"] == e_align.ABLATION_LATENT_WEIGHTS
    assert "sequential_image_steps = ab in (7, 8)" in (ROOT / "tpugan/cli/e_align.py").read_text()
    assert tuple(e_align.SEQUENTIAL_ABLATIONS) == (7, 8)


# ---------------------------------------------------------------------------
# the train step

IMG, START_FEATURES, BATCH, LR, STEPS = 32, 64, 2, 0.0015, 3
LAYERS = 4  # log2(32) - 1
LOD = LAYERS - 1
# (case, ablation, LPIPS in the step)
STEP_FORMS = {
    "case1": (1, 0, False),
    "case2": (2, 0, True),
    "ablation1": (2, 1, True),
    "ablation7": (2, 7, True),
    "ablation8": (2, 8, True),
}
# The forms whose fp32 runs part beyond GRAD_TOL: their gradients pass back
# through the resynthesis, where the SGv1 gradient is ill-conditioned (the
# two packages' fp32 gradients of block_0.conv_1 part by 3.7e-3 of its max
# in case 2; either package's fp32 rounding of imgs1 alone moves the
# float64 gradient by 1.6e-5 to 3.1e-4 of its max), so both packages are
# held to float64 runs of both, tpugan's with x64 and the port's in float64.
# They run one step: over several the trajectories part (LREQAdam's first
# updates are about lr c sign(g)): after three ablation-8 steps the two
# packages' fp32 parameters differ by 0.07 lr c on average, over the 0.05
# that the rule allows, and tpugan's own fp32 and float64 ones by 0.04. One
# step still holds the sequential updates of ablations 7 and 8.
# Ablation 1's fp32 runs agree at GRAD_TOL and are held directly.
IMAGE_GRADIENT_FORMS = ("case2", "ablation7", "ablation8")
IMAGE_GRADIENT_STEPS = 1


def _argv(case, ablation, *extra):
    return ["--mtype", "1", "--img_size", str(IMG), "--start_features", str(START_FEATURES),
            "--random_init", "--device", "cpu", "--iterations", str(STEPS), "--case", str(case),
            "--ablation", str(ablation), "--lr", str(LR), *extra]


@pytest.fixture(scope="module")
def setup():
    """tpugan's generator and mapping (the CLI's widths at 32 px) from its
    flax init, random LPIPS variables, and each step's inputs (z and the
    three passes' noise) drawn with numpy for every encoder the forms use."""
    rng = np.random.RandomState(0)
    jgen = JGenerator(startf=START_FEATURES, maxf=512, layer_count=LAYERS, latent_size=512)
    jgm = JMapping(num_layers=2 * LAYERS, mapping_layers=8)
    gm_vars = jax.tree.map(np.asarray, jax.jit(jgm.init)(jax.random.PRNGKey(1), jnp.zeros((1, 512))))
    probe = e_align.build_trainer(e_align.make_parser().parse_args(_argv(1, 0)))
    g_shapes = probe.bundle.generator.noise_shapes(BATCH)
    noise0 = _jnoise(draw(g_shapes, np.random.RandomState(9))[0])
    gen_vars = jax.tree.map(np.asarray, jax.jit(lambda s: jgen.init(
        jax.random.PRNGKey(2), s, LOD, 1.0, noise0))(jnp.zeros((BATCH, 2 * LAYERS, 512))))
    lp_vars = jax.tree.map(
        lambda x: (rng.randn(*x.shape) / np.sqrt(np.prod(x.shape[:-1]))).astype(np.float32),
        jax.eval_shape(lambda: jlpips_params(jax.random.PRNGKey(7), IMG)))
    encoders = {}
    for form, (case, ab, _) in STEP_FORMS.items():
        kw = jvariant_kwargs(ab, case)
        je = JEncoder(startf=START_FEATURES, maxf=512, layer_count=LAYERS, latent_size=512, **kw)
        port_enc = Encoder(startf=START_FEATURES, maxf=512, layer_count=LAYERS, latent_size=512, **kw)
        shapes = port_enc.noise_shapes(BATCH, IMG)
        variables = jax.tree.map(np.asarray, jax.jit(lambda x, n: je.init(
            jax.random.PRNGKey(3), x, 0, n))(jnp.zeros((BATCH, IMG, IMG, 3)),
                                             _jnoise(draw(shapes, np.random.RandomState(9))[0])))
        inputs = []
        for _ in range(STEPS):
            z = rng.randn(BATCH, 512).astype(np.float32)
            inputs.append((z, draw(g_shapes, rng)[0], draw(shapes, rng)[0], draw(g_shapes, rng)[0]))
        encoders[form] = dict(je=je, kw=kw, variables=variables, inputs=inputs)
    return dict(jgen=jgen, jgm=jgm, gen_vars=gen_vars, gm_vars=gm_vars, lp_vars=lp_vars,
                encoders=encoders)


def _recording(inner, keep=4):
    """optax transform that keeps the last ``keep`` gradients it was handed
    in its state, to read a step's gradients back out of tpugan's jitted
    step."""
    def init(params):
        zeros = jax.tree.map(jnp.zeros_like, params)
        return (inner.init(params),) + (zeros,) * keep

    def update(grads, state, params=None):
        updates, inner_state = inner.update(grads, state[0], params)
        return updates, (inner_state,) + state[2:] + (grads,)

    return optax.GradientTransformation(init, update)


def _updates_per_step(case, ablation):
    if case == 1:
        return 1
    if ablation in e_align.SEQUENTIAL_ABLATIONS:
        return sum(w != 0.0 for w in e_align.ABLATION_IMAGE_WEIGHTS[ablation]) + 1
    return 2


def _port_named(encoder, tree):
    """A tpugan params tree as {port name: array in the port's layout}, its
    dtype kept (the bridge's walk, without its fp32 copy)."""
    out = {}
    bridge._walk(encoder, jax.tree.map(np.asarray, tree), "", out)
    return out


class Run(NamedTuple):
    """A trajectory of STEPS steps: each step's scalars, the first step's
    gradients (one per update, {port name: array}) and the final parameters."""

    infos: list
    grads: list
    params: dict


_JITTED = {}  # tpugan's jitted steps, compiled once per form, step kind and dtype


def _steps(form):
    return IMAGE_GRADIENT_STEPS if form in IMAGE_GRADIENT_FORMS else STEPS


def _tpugan_run(setup, form, lean_after_first=False, dtype=np.float32):
    """tpugan's make_train_step, with its CLI's presets for the form, on the
    setup's variables and inputs cast to ``dtype`` (float64 under x64)."""
    case, ab, with_lpips = STEP_FORMS[form]
    jgen, jgm = setup["jgen"], setup["jgm"]
    enc = setup["encoders"][form]
    je = enc["je"]
    cast = lambda tree: jax.tree.map(lambda x: np.asarray(x, dtype), tree)  # noqa: E731
    enc_vars = {**enc["variables"], "params": cast(enc["variables"]["params"])}
    gm_vars = cast(setup["gm_vars"])
    extra = {k: v for k, v in enc_vars.items() if k != "params"}
    coefs = jtruncation_coefs(jgm.num_layers)

    def synth(frozen, key, z):
        z = frozen["z"]
        w1 = jgm.apply(frozen["gm"], z, coefs, None)
        imgs1 = jgen.apply(frozen["gen"], w1, LOD, 1.0, frozen["noise_g"])
        const1 = z if ab == 1 else jnp.repeat(frozen["gen"]["params"]["const"], z.shape[0], axis=0)
        return JSynthBatch(w1=w1, imgs1=imgs1, const1=const1,
                           label=(frozen["noise_e"], frozen["noise_g2"]))

    def resynth(frozen, w2, batch, key):
        return jgen.apply(frozen["gen"], w2, LOD, 1.0, batch.label[1])

    def encode(params, batch, key):
        const2, w2 = je.apply({**extra, "params": params}, batch.imgs1, 0, batch.label[0])
        if ab == 1:  # tpugan/cli/e_align.py:95-99
            return w2, jgm.apply(gm_vars, w2, jtruncation_coefs(2 * LAYERS), None)
        return const2, w2

    presets = _tpugan_presets()
    opt = _recording(jlreq_adam(LR, coefs=lreq_coef_tree(enc_vars["params"], enc_vars.get("lreq", {}))))
    kw = dict(encode=encode, synth=synth, resynth=resynth, optimizer=opt, z_dim=512,
              batch_size=BATCH, case=case)
    if ab:
        kw.update(image_weights=presets["image_weights"][ab],
                  latent_weights=presets["latent_weights"][ab],
                  sequential_image_steps=ab in (7, 8))
    with jax.enable_x64(dtype == np.float64):
        key = (form, np.dtype(dtype).name)
        if key not in _JITTED:
            lpips = jmake_lpips_fn(cast(setup["lp_vars"])) if with_lpips else None
            _JITTED[key] = jax.jit(jmake_train_step(**kw, lpips_fn=lpips))
        if lean_after_first and "lean" not in _JITTED:
            _JITTED["lean"] = jax.jit(jmake_train_step(**kw, compute_image_losses=False))
        full, lean = _JITTED[key], _JITTED["lean"] if lean_after_first else None
        state = jinit_train_state(enc_vars["params"], opt)
        infos, grads = [], None
        n = _updates_per_step(case, ab)
        for it, (z, ng, ne, ng2) in enumerate(enc["inputs"][:_steps(form)]):
            frozen = {"gen": cast(setup["gen_vars"]), "gm": gm_vars, "z": jnp.asarray(z, dtype),
                      "noise_g": _jnoise(ng, dtype), "noise_e": _jnoise(ne, dtype) or [()] * LAYERS,
                      "noise_g2": _jnoise(ng2, dtype)}
            fn = lean if (lean is not None and it > 0) else full
            state, info = fn(state, jnp.int32(it), frozen)
            infos.append(jinfo_scalars(info))
            if it == 0:
                grads = state.opt_state[-n:]
        port = Encoder(startf=START_FEATURES, maxf=512, layer_count=LAYERS, latent_size=512, **enc["kw"])
        return Run(infos, [_port_named(port, g) for g in grads], _port_named(port, state.params))


def _port_trainer(setup, form, dtype=torch.float32):
    """The CLI's trainer for the form, on the setup's variables and inputs."""
    case, ab, with_lpips = STEP_FORMS[form]
    enc = setup["encoders"][form]
    requests = [Request(z=torch.from_numpy(z).to(dtype), noise_g=_cast(ng, dtype),
                        noise_e=_cast(ne, dtype), noise_g2=_cast(ng2, dtype))
                for z, ng, ne, ng2 in enc["inputs"]]
    lpips = make_lpips_fn(load_variables(LPIPS(), setup["lp_vars"]).to(dtype)) if with_lpips else None
    args = e_align.make_parser().parse_args(_argv(case, ab))
    trainer = e_align.build_trainer(args, lpips, draw=lambda it: requests[it])
    bundle = trainer.bundle
    load_variables(bundle.generator, setup["gen_vars"], unused=[f"to_rgb_{i}" for i in range(LOD)])
    load_variables(bundle.mapping, setup["gm_vars"])
    load_variables(bundle.encoder, enc["variables"])
    for module in (bundle.generator, bundle.mapping, bundle.encoder):
        module.to(dtype)  # in place: the optimizer keeps the same parameters
    return trainer


def _cast(blocks, dtype):
    return [tuple(n.to(dtype) for n in block) for block in blocks]


def _port_run(setup, form, lean_after_first=False, dtype=torch.float32):
    case, ab, _ = STEP_FORMS[form]
    trainer = _port_trainer(setup, form, dtype)
    frozen = [*trainer.bundle.generator.parameters(), *trainer.bundle.mapping.parameters()]
    frozen0 = [p.clone() for p in frozen]
    state = trainer.state
    recorded = []
    step_with = state.optimizer.step
    state.optimizer.step = lambda g=None: (recorded.append([None if x is None else x.clone() for x in g]),
                                           step_with(g))
    infos = []
    steps = _steps(form)
    for it in range(steps):
        fn = trainer.lean if (lean_after_first and it > 0) else trainer.step
        state, info = fn(state, it)
        infos.append(e_align.info_scalars(info))
    n = _updates_per_step(case, ab)
    assert len(recorded) == n * steps and state.step == steps
    # the frozen generator and mapping took no gradient and did not move
    assert all(p.grad is None and not p.requires_grad for p in frozen)
    assert all(torch.equal(p, p0) for p, p0 in zip(frozen, frozen0))
    params = dict(state.encoder.named_parameters())
    names = list(params)
    grads = [{name: np.zeros(tuple(params[name].shape)) if g is None else g.numpy()
              for name, g in zip(names, step)} for step in recorded[:n]]
    return trainer, Run(infos, grads, {k: v.detach().numpy() for k, v in params.items()})


def _check_trajectory(encoder, got, want, updates, own=None):
    """Parameters after the trajectory. LREQAdam's first update is about
    lr * c * sign(g), with c the parameter's equalized-LR coefficient: an
    element whose gradient is near zero, with another sign on the other
    side, moves up to 2 lr c apart in each update. So an element may differ
    by 2 lr c per update (tests/test_torch_train.py), and the mean
    difference over a parameter must stay below 5% of one update's lr c,
    or, with ``own`` (tpugan's fp32 final parameters, ``want`` being its
    float64 ones), below twice tpugan's own fp32 mean difference."""
    coefs = lreq_coefs(encoder)
    for name in want:
        step = LR * coefs[name]
        diff = np.abs(got[name] - want[name])
        mean_bound = 0.05 * step
        if own is not None:
            mean_bound = max(mean_bound, 2 * np.abs(own[name] - want[name]).mean())
        assert diff.max() <= 2 * step * updates, f"{name}: max |diff| {diff.max():.3e} > 2 lr c x {updates}"
        assert diff.mean() <= mean_bound, f"{name}: mean |diff| {diff.mean():.3e} > {mean_bound:.3e}"


def _check_same(got: Run, want: Run):
    """Every scalar of every step at MODEL_TOL and the first step's
    gradients at GRAD_TOL."""
    for it, (a, b) in enumerate(zip(got.infos, want.infos)):
        assert a.keys() == b.keys()
        for key in b:
            np.testing.assert_allclose(a[key], b[key], **MODEL_TOL, err_msg=f"step {it} {key}")
    assert len(got.grads) == len(want.grads)
    for which, (a, b) in enumerate(zip(got.grads, want.grads)):
        assert a.keys() == b.keys()
        for name in b:
            np.testing.assert_allclose(a[name], b[name], **GRAD_TOL, err_msg=f"gradient {which} of {name}")


@pytest.mark.parametrize("form", STEP_FORMS)
def test_train_step_matches_tpugan(setup, form):
    case, ab, with_lpips = STEP_FORMS[form]
    jax32 = _tpugan_run(setup, form)
    trainer, port = _port_run(setup, form)
    encoder = trainer.state.encoder
    updates = _updates_per_step(case, ab)
    assert len(port.grads) == len(jax32.grads) == updates
    assert port.infos[0]["loss_small_ssim"] > 0 and (port.infos[0]["loss_imgs_lpips"] > 0) == with_lpips
    if form not in IMAGE_GRADIENT_FORMS:
        _check_same(port, jax32)
        _check_trajectory(encoder, port.params, jax32.params, STEPS * updates)
        return
    # the step in float64, where it is well conditioned: every scalar, the
    # gradients and the parameters after it
    ref = _tpugan_run(setup, form, dtype=np.float64)
    _, port64 = _port_run(setup, form, dtype=torch.float64)
    _check_same(port64, ref)
    _check_trajectory(encoder, port64.params, ref.params, updates)
    # in fp32: every scalar, and the parameters after the step, held to
    # tpugan's fp32 run or, no farther than twice that run is, to float64
    for key in jax32.infos[0]:
        np.testing.assert_allclose(port.infos[0][key], jax32.infos[0][key], **MODEL_TOL, err_msg=key)
    _check_trajectory(encoder, port.params, ref.params, updates, own=jax32.params)
    # the image losses reach the first block through the resynthesis
    assert np.abs(port.grads[0]["block_0.conv_1.weight"]).max() > 0


def test_ablation1_trains_on_z_alone(setup):
    """Ablation 1: E_Blur_Z's z2 against z is the only latent loss that
    counts (latent weights (0, 1)): loss_mtv is 0.01 loss_c, a latent
    space_loss's 5 mse + 3 cosine, while loss_w (w1 against the re-mapped
    z2) is logged with weight 0."""
    trainer, port = _port_run(setup, "ablation1")
    enc = trainer.state.encoder
    assert enc.out_z is not None and enc.style_mode == "none"
    for info in port.infos:
        np.testing.assert_allclose(info["loss_mtv"],
                                   0.01 * (5 * info["loss_c_mse"] + 3 * info["loss_c_cosine"]), rtol=1e-5)
        assert info["loss_w_mse"] > 0


def test_detached_image_losses_give_case_2_no_image_gradient(setup):
    """detach_image_losses=True in case 2 (as tpugan's make_train_step
    takes it): the loss_tsa update gets no gradient (LREQAdam decays its
    moment and leaves the parameters), the latent update the case's."""
    from tpugan_torch.train.e_align import build_stylegan1_pipeline, make_encode_fn, make_train_step

    trainer = _port_trainer(setup, "case2")
    bundle = trainer.bundle
    synth_fn, resynth = build_stylegan1_pipeline(bundle.generator, bundle.mapping, LOD, train=True)
    enc = setup["encoders"]["case2"]
    requests = [Request(torch.from_numpy(z), ng, ne, ng2) for z, ng, ne, ng2 in enc["inputs"]]
    step = make_train_step(make_encode_fn(bundle.encoder, train=True),
                           lambda r: synth_fn(r.z, r.noise_g), resynth, lambda it: requests[it],
                           case=2, detach_image_losses=True)
    recorded = []
    step_with = trainer.state.optimizer.step
    trainer.state.optimizer.step = lambda g=None: (recorded.append(g), step_with(g))
    before = {n: p.detach().clone() for n, p in bundle.encoder.named_parameters()}
    _, info = step(trainer.state, 0)
    assert len(recorded) == 2 and all(g is None for g in recorded[0])
    assert all(g is not None for g in recorded[1])
    assert float(info.loss_tsa) > 0
    assert any(not torch.equal(p, before[n]) for n, p in bundle.encoder.named_parameters())


def test_lean_step_matches_tpugan_and_is_bitwise_the_full_trajectory(setup):
    """Case 1 with lean steps after the first: the port against tpugan's lean
    trajectory, and bit for bit the port's own all-full trajectory."""
    jlean = _tpugan_run(setup, "case1", lean_after_first=True)
    lean_trainer, lean = _port_run(setup, "case1", lean_after_first=True)
    _, full = _port_run(setup, "case1")
    _check_same(lean, jlean)
    for name, p in full.params.items():
        np.testing.assert_array_equal(lean.params[name], p, err_msg=name)
    assert lean.infos[-1]["loss_imgs_mse"] == 0.0 and lean.infos[-1]["loss_tsa"] == 0.0
    assert lean.infos[-1]["loss_mtv"] == full.infos[-1]["loss_mtv"]
    _check_trajectory(lean_trainer.state.encoder, lean.params, jlean.params, STEPS)


# ---------------------------------------------------------------------------
# the CLI

TINY = ["--mtype", "1", "--img_size", "16", "--start_features", "128", "--random_init",
        "--device", "cpu"]  # tests/test_cli.py:13 of tpugan, on the CPU


@pytest.mark.parametrize("extra", [("--case", "1"), ("--case", "2"), ("--ablation", "1"),
                                   ("--ablation", "8")], ids=lambda e: "".join(e).replace("--", ""))
def test_cli_trains_two_iterations_on_cpu(tmp_path, capsys, extra):
    cuda.reset_launches()
    out = tmp_path / "out"
    e_align.main([*TINY, *extra, "--iterations", "2", "--log_every", "1", "--experiment_dir", str(out)])
    assert not any(cuda.launches.values())
    records = [json.loads(line) for line in (out / "Loss.txt").read_text().splitlines()]
    assert [r["iteration"] for r in records] == [0, 1]
    assert all(np.isfinite(v) for r in records for v in r.values())
    assert len(records[0]) == 2 + 5 * 7 + 2
    assert (out / "imgs" / "ep0_iter1.jpg").exists()
    if extra[0] == "--ablation":
        assert records[0]["loss_imgs_mse"] > 0 and records[0]["loss_tsa"] > 0
    assert "LPIPS loss term is DISABLED" in capsys.readouterr().err


def test_cli_names_the_run_as_tpugan_does(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    e_align.main([*TINY, "--ablation", "3", "--iterations", "1"])
    assert (tmp_path / "result" / "mtype1-16-case1-ab3" / "Loss.txt").exists()


def test_cli_lean_steps_leave_the_mtype_1_trajectory_alone(tmp_path):
    """Off-tick lean steps (the default in case 1) against --eager_metrics."""
    def trained(*extra):
        args = e_align.make_parser().parse_args([*TINY, "--iterations", "3", *extra])
        trainer = e_align.build_trainer(args)
        assert (trainer.lean is None) == bool(extra)
        state = trainer.state
        for it in range(3):
            state, _ = (trainer.step if it == 0 or trainer.lean is None else trainer.lean)(state, it)
        return state.encoder.state_dict()

    lean, eager = trained(), trained("--eager_metrics")
    for a, b in zip(lean.values(), eager.values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("extra", [("--ablation", "2"), ("--case", "2")])
def test_cli_has_no_lean_step_where_images_train(extra):
    trainer = e_align.build_trainer(e_align.make_parser().parse_args([*TINY, "--iterations", "1", *extra]))
    assert trainer.lean is None


# each flag with the ROADMAP item that brought it
@pytest.mark.parametrize("extra,item", [
    (("--bf16", "--remat"), "A2"),  # --bf16 itself runs (tests/test_torch_bf16.py)
    (("--remat",), "A3"),
    (("--remat_policy", "conv_outs"), "A3"),
    (("--resume",), "slice 7"),
    (("--iterations", "6", "--checkpoint_every", "5"), "slice 7"),
])
def test_cli_mtype_1_options_of_later_slices_raise(tmp_path, extra, item):
    """Refused until their items came (A3 remat, slice 7a's io/checkpoint),
    these flags now run as tpugan's do (tests/torch_flag_checks.py)."""
    check_flag_runs(e_align.main, [*TINY, "--case", "2"], extra, tmp_path)


def _biggan_argv(tmp_path, *extra):
    config = tmp_path / "config.json"
    config.write_text(BigGANConfig(**BIGGAN_CFG).to_json_string())
    return ["--mtype", "4", "--img_size", "32", "--start_features", "16", "--z_dim", "8",
            "--random_init", "--config_dir", str(config), "--device", "cpu", "--iterations", "1",
            *extra]


def test_ablation_weights_apply_to_e_big(tmp_path):
    """On mtype 4 an ablation's weights apply and E_BIG stays E_BIG, as in
    tpugan: ablation 8 takes four updates a step."""
    trainer = e_align.build_trainer(e_align.make_parser().parse_args(
        _biggan_argv(tmp_path, "--ablation", "8")))
    assert type(trainer.state.encoder).__name__ == "BigGANEncoder" and trainer.lean is None
    calls = []
    step_with = trainer.state.optimizer.step
    trainer.state.optimizer.step = lambda g=None: (calls.append(1), step_with(g))
    trainer.step(trainer.state, 0)
    assert len(calls) == 4
    with pytest.raises(ValueError, match="StyleGANv1-only"):
        e_align.build_trainer(e_align.make_parser().parse_args(_biggan_argv(tmp_path, "--ablation", "1")))
