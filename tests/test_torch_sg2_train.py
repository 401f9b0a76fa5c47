"""tpugan_torch's StyleGAN2 encoder training (``e_align --mtype 2``: case 1
and its lean step, case 2 with E_Blur; ablation 8 in
``tests/test_torch_sg2_ablation.py``) vs tpugan (CPU).

The port's side is the CLI's ``build_trainer`` at ``--img_size 32
--start_features 64``, whose generator and encoder then take tpugan's
variables through the bridge. tpugan's side is its own ``make_train_step``
with its CLI's presets, over its own bundle's closures
(``tpugan/cli/common.py:184-192``) built from the same args: its synth reads z
from ``frozen``, and the encoder's noise rides in ``SynthBatch.label``. Both
bundles build their generator with a narrower synthesis (``NARROW``: 512
channels at 4 px, halving to 64 at 32 px, where config F keeps 512): XLA's
CPU convolutions take about 80 s for one float64 step at config F's width.
The const stays [N, 512, 4, 4], the encoder's const2 width, for loss_c. The variables are tpugan's bundle's init, with the
generator's zero-initialised leaves (biases, ``noise_strength``, ``w_avg``)
drawn at 0.1, as ``tests/test_torch_stylegan2.py`` draws them; the inputs are
numpy draws. Ablation 8 runs with ``--case 1``, so on the plain E, as
``tpugan`` builds it on mtype 2.

Tolerances, ``tests/test_torch_sgv1_train.py``'s, fixed before any run:

* case 1 and its lean step (no gradient through the images): every scalar
  of 3 steps at MODEL_TOL, the first step's gradient at GRAD_TOL, the
  parameters after the trajectory by ``_check_trajectory``'s rule;
* case 2 and ablation 8, whose gradients pass back through the
  resynthesis: one step in float64 on both sides (tpugan's under x64) at
  the same tolerances; in fp32, step 0's scalars at MODEL_TOL and the
  parameters after the step within the trajectory rule of the float64 run,
  or twice tpugan's own fp32 distance from it.
"""

import contextlib
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_biggan import draw
from test_torch_sgv1_train import (
    MODEL_TOL,
    Run,
    _cast,
    _check_same,
    _check_trajectory,
    _jnoise,
    _port_named,
    _recording,
    _tpugan_presets,
    _updates_per_step,
)
from test_torch_stylegan2 import lively
from tpugan import models as jmodels
from tpugan.cli import common as jcommon
from tpugan.losses.lpips import make_lpips_fn as jmake_lpips_fn
from tpugan.losses.lpips import random_params as jlpips_params
from tpugan.ops.eq_lr import lreq_coef_tree
from tpugan.optim import lreq_adam as jlreq_adam
from tpugan.train.e_align import info_scalars as jinfo_scalars
from tpugan.train.e_align import init_train_state as jinit_train_state
from tpugan.train.e_align import make_train_step as jmake_train_step
from torch_flag_checks import check_flag_runs
from tpugan_torch.cli import e_align
from tpugan_torch import models as pmodels
from tpugan_torch.io.bridge import load_variables
from tpugan_torch.losses.lpips import LPIPS, make_lpips_fn
from tpugan_torch.models.stylegan2 import StyleGAN2Generator
from tpugan_torch.ops import cuda, upfirdn
from tpugan_torch.train.e_align import Request, build_stylegan2_pipeline

torch.set_num_threads(1)

IMG, START_FEATURES, BATCH, LR, STEPS = 32, 64, 2, 0.0015, 3
# (--case, --ablation, LPIPS in the step)
STEP_FORMS = {
    "case1": (1, 0, False),
    "case2": (2, 0, True),
    "ablation8": (1, 8, True),
}
IMAGE_GRADIENT_FORMS = ("case2", "ablation8")
IMAGE_GRADIENT_STEPS = 1


# the synthesis of the step tests: fmaps min(2048 / res, 512)
NARROW = dict(fmaps_base=2048)


@contextlib.contextmanager
def narrow():
    """Both packages' bundles build StyleGAN2Generator with NARROW."""
    with pytest.MonkeyPatch.context() as mp:
        for module in (jmodels, pmodels):
            mp.setattr(module, "StyleGAN2Generator",
                       functools.partial(module.StyleGAN2Generator, **NARROW))
        yield


def _argv(case, ablation, *extra):
    return ["--mtype", "2", "--img_size", str(IMG), "--start_features", str(START_FEATURES),
            "--random_init", "--device", "cpu", "--iterations", str(STEPS), "--case", str(case),
            "--ablation", str(ablation), "--lr", str(LR), *extra]


def _args(case, ablation):
    return e_align.make_parser().parse_args(_argv(case, ablation))


def _step_case(form):
    case, ab, _ = STEP_FORMS[form]
    return 2 if ab else case


def _steps(form):
    return IMAGE_GRADIENT_STEPS if form in IMAGE_GRADIENT_FORMS else STEPS


@pytest.fixture(scope="module")
def setup():
    """tpugan's bundles (E and E_Blur) from the CLI's args, the generator's
    variables with its zero leaves drawn, random LPIPS variables, and each
    form's inputs (z and the encoder's noise) drawn with numpy."""
    rng = np.random.RandomState(0)
    with narrow():
        jbundles = {1: jcommon.build_bundle(_args(1, 0))}
    frozen = lively(jbundles[1].frozen, rng, scale=0.1)
    lp_vars = jax.tree.map(
        lambda x: (rng.randn(*x.shape) / np.sqrt(np.prod(x.shape[:-1]))).astype(np.float32),
        jax.eval_shape(lambda: jlpips_params(jax.random.PRNGKey(7), IMG)))
    forms = {}
    for form, (case, ab, _) in STEP_FORMS.items():
        shapes = _encoder(form).noise_shapes(BATCH, IMG)
        inputs = [(rng.randn(BATCH, 512).astype(np.float32), draw(shapes, rng)[0]) for _ in range(STEPS)]
        forms[form] = dict(inputs=inputs)
    return dict(frozen=frozen, lp_vars=lp_vars, forms=forms, jbundles=jbundles)


def _jbundle(setup, form):
    """tpugan's bundle for the form's --case (E or E_Blur), built once; the
    generator's variables are the same in each."""
    case = STEP_FORMS[form][0]
    if case not in setup["jbundles"]:
        with narrow():
            setup["jbundles"][case] = jcommon.build_bundle(_args(case, 0))
    return setup["jbundles"][case]


def _encoder(form):
    """The port's encoder of the form, as the CLI builds it."""
    case, ab, _ = STEP_FORMS[form]
    with narrow():
        return e_align.build_trainer(_args(case, ab)).state.encoder


_JITTED = {}  # tpugan's jitted steps, compiled once per form, step kind and dtype


def _tpugan_run(setup, form, lean_after_first=False, dtype=np.float32):
    """tpugan's make_train_step over its bundle's closures, with its CLI's
    presets for the form, on the setup's variables and inputs cast to
    ``dtype`` (float64 under x64)."""
    case, ab, with_lpips = STEP_FORMS[form]
    jbundle = _jbundle(setup, form)
    je = jbundle.encoder
    cast = lambda tree: jax.tree.map(lambda x: np.asarray(x, dtype), tree)  # noqa: E731
    enc_vars = jax.tree.map(np.asarray, jbundle.enc_vars)
    params = cast(enc_vars["params"])
    extra = {k: v for k, v in enc_vars.items() if k != "params"}

    def synth(frozen, key, z):
        return jbundle.synth(frozen["g"], key, frozen["z"])._replace(label=frozen["noise_e"])

    def resynth(frozen, w2, batch, key):
        return jbundle.resynth(frozen["g"], w2, batch, key)

    def encode(params, batch, key):
        return je.apply({**extra, "params": params}, batch.imgs1, 0, batch.label)

    presets = _tpugan_presets()
    opt = _recording(jlreq_adam(LR, coefs=lreq_coef_tree(params, enc_vars.get("lreq", {}))))
    kw = dict(encode=encode, synth=synth, resynth=resynth, optimizer=opt, z_dim=512,
              batch_size=BATCH, case=_step_case(form))
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
        state = jinit_train_state(params, opt)
        g = cast(setup["frozen"])
        infos, grads = [], None
        n = _updates_per_step(_step_case(form), ab)
        for it, (z, ne) in enumerate(setup["forms"][form]["inputs"][:_steps(form)]):
            frozen = {"g": g, "z": jnp.asarray(z, dtype), "noise_e": _jnoise(ne, dtype)}
            fn = lean if (lean is not None and it > 0) else full
            state, info = fn(state, jnp.int32(it), frozen)
            infos.append(jinfo_scalars(info))
            if it == 0:
                grads = state.opt_state[-n:]
    port = _encoder(form)
    return Run(infos, [_port_named(port, g) for g in grads], _port_named(port, state.params))


def _port_trainer(setup, form, dtype=torch.float32):
    """The CLI's trainer for the form, on the setup's variables and inputs."""
    case, ab, with_lpips = STEP_FORMS[form]
    inputs = setup["forms"][form]["inputs"]
    requests = [Request(z=torch.from_numpy(z).to(dtype), noise_g=None, noise_e=_cast(ne, dtype),
                        noise_g2=None) for z, ne in inputs]
    lpips = make_lpips_fn(load_variables(LPIPS(), setup["lp_vars"]).to(dtype)) if with_lpips else None
    with narrow():
        trainer = e_align.build_trainer(_args(case, ab), lpips, draw=lambda it: requests[it])
    load_variables(trainer.bundle.generator, setup["frozen"])
    load_variables(trainer.bundle.encoder, jax.tree.map(np.asarray, _jbundle(setup, form).enc_vars))
    for module in (trainer.bundle.generator, trainer.bundle.encoder):
        module.to(dtype)  # in place: the optimizer keeps the same parameters
    return trainer


def _port_run(setup, form, lean_after_first=False, dtype=torch.float32):
    trainer = _port_trainer(setup, form, dtype)
    frozen = [*trainer.bundle.generator.parameters(), *trainer.bundle.generator.buffers()]
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
    n = _updates_per_step(_step_case(form), STEP_FORMS[form][1])
    assert len(recorded) == n * steps and state.step == steps
    # the frozen generator took no gradient, and neither it nor its noise moved
    assert all(p.grad is None and not p.requires_grad for p in trainer.bundle.generator.parameters())
    assert all(torch.equal(p, p0) for p, p0 in zip(frozen, frozen0))
    params = dict(state.encoder.named_parameters())
    names = list(params)
    grads = [{name: np.zeros(tuple(params[name].shape)) if g is None else g.numpy()
              for name, g in zip(names, step)} for step in recorded[:n]]
    return trainer, Run(infos, grads, {k: v.detach().numpy() for k, v in params.items()})


def check_step_matches_tpugan(setup, form):
    """The form's step against tpugan's, at the module's tolerances."""
    case, ab, with_lpips = STEP_FORMS[form]
    jax32 = _tpugan_run(setup, form)
    trainer, port = _port_run(setup, form)
    encoder = trainer.state.encoder
    assert encoder.block_0.use_blur == (case == 2)  # the --case flag picks E_Blur, not the ablation
    updates = _updates_per_step(_step_case(form), ab)
    assert len(port.grads) == len(jax32.grads) == updates
    assert port.infos[0]["loss_small_ssim"] > 0 and (port.infos[0]["loss_imgs_lpips"] > 0) == with_lpips
    if form not in IMAGE_GRADIENT_FORMS:
        _check_same(port, jax32)
        _check_trajectory(encoder, port.params, jax32.params, STEPS * updates)
        return
    # the step in float64: every scalar, the gradients and the parameters after it
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


@pytest.mark.parametrize("form", ["case1", "case2"])
def test_train_step_matches_tpugan(setup, form):
    check_step_matches_tpugan(setup, form)


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
# the closures and the CLI

GEN_KW = dict(resolution=16, z_space_dim=8, w_space_dim=8, mapping_layers=2, mapping_fmaps=8,
              fmaps_base=64, fmaps_max=8)


def test_train_resynthesis_takes_the_gradient_to_w2_alone():
    """The train-form resynthesis records the graph back to w2 and leaves G
    without gradient; synth never records one, and both refuse noise other
    than the generator's buffers."""
    gen = StyleGAN2Generator(**GEN_KW, generator=torch.Generator().manual_seed(0))
    synth, resynth = build_stylegan2_pipeline(gen, train=True)
    batch = synth(torch.randn(2, 8, generator=torch.Generator().manual_seed(1)))
    assert not batch.imgs1.requires_grad and not batch.w1.requires_grad
    assert batch.const1.shape == (2, 8, 4, 4)
    w2 = batch.w1.clone().requires_grad_(True)
    resynth(w2, batch).square().mean().backward()
    assert w2.grad is not None and w2.grad.abs().max() > 0
    assert all(p.grad is None and not p.requires_grad for p in gen.parameters())
    _, serve = build_stylegan2_pipeline(gen)
    assert not serve(w2, batch).requires_grad
    for fn in (lambda: synth(batch.w1[:, 0], noise=[]), lambda: resynth(w2, batch, noise=[])):
        with pytest.raises(ValueError, match="noise buffers"):
            fn()


TINY = ["--mtype", "2", "--img_size", "32", "--start_features", "64", "--random_init",
        "--device", "cpu"]


@pytest.mark.parametrize("extra", [("--case", "1"), ("--case", "2"), ("--ablation", "8")],
                         ids=lambda e: "".join(e).replace("--", ""))
def test_cli_trains_two_iterations_on_cpu(tmp_path, capsys, extra):
    cuda.reset_launches()
    upfirdn.reset_layout_launches()
    out = tmp_path / "out"
    e_align.main([*TINY, *extra, "--iterations", "2", "--log_every", "1", "--experiment_dir", str(out)])
    assert not any(cuda.launches.values()) and not any(upfirdn.layout_launches.values())
    records = [json.loads(line) for line in (out / "Loss.txt").read_text().splitlines()]
    assert [r["iteration"] for r in records] == [0, 1]
    assert all(np.isfinite(v) for r in records for v in r.values())
    assert len(records[0]) == 2 + 5 * 7 + 2
    assert (out / "imgs" / "ep0_iter1.jpg").exists()
    if extra[0] == "--ablation":
        assert records[0]["loss_imgs_mse"] > 0 and records[0]["loss_tsa"] > 0
        assert records[0]["loss_c_mse"] > 0
    assert "LPIPS loss term is DISABLED" in capsys.readouterr().err


def test_cli_names_the_run_as_tpugan_does(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    e_align.main([*TINY, "--case", "2", "--iterations", "1"])
    assert (tmp_path / "result" / "mtype2-32-case2" / "Loss.txt").exists()


@pytest.mark.parametrize("extra", [("--ablation", "2"), ("--case", "2")])
def test_cli_has_no_lean_step_where_images_train(extra):
    trainer = e_align.build_trainer(e_align.make_parser().parse_args([*TINY, "--iterations", "1", *extra]))
    assert trainer.lean is None


def test_cli_ablation_1_is_stylegan1_only():
    with pytest.raises(ValueError, match="StyleGANv1-only"):
        e_align.build_trainer(e_align.make_parser().parse_args([*TINY, "--ablation", "1",
                                                                "--iterations", "1"]))


# each flag with the ROADMAP item that brought it
@pytest.mark.parametrize("extra,item", [
    (("--bf16", "--remat"), "A2"),  # --bf16 itself runs (tests/test_torch_bf16.py)
    (("--remat",), "A3"),
    (("--remat_policy", "conv_outs"), "A3"),
    (("--resume",), "slice 7"),
    (("--iterations", "6", "--checkpoint_every", "5"), "slice 7"),
])
def test_cli_mtype_2_options_of_later_work_raise(tmp_path, extra, item):
    """Refused until their items came (A3 remat, slice 7a's io/checkpoint),
    these flags now run as tpugan's do (tests/torch_flag_checks.py)."""
    check_flag_runs(e_align.main, [*TINY, "--case", "2"], extra, tmp_path)
