"""tpugan_torch's PGGAN (mtype 3) and E_PG against tpugan (CPU).

The modules take tpugan's variables through the bridge, with the
zero-initialised leaves (biases, noise weights) and the affine IN's scale
drawn; z and the noise are numpy draws injected into both. Tolerances,
fixed before any run: 1e-4 for a block, rtol 2e-3 / atol 2e-4 of max |ref|
for a whole model (tests/test_stylegan1.py:134), the train tests' rules for
the steps (tests/test_torch_sgv1_train.py), the inversion's for one
iteration (tests/test_torch_invert.py). The modules run at
tests/test_pggan.py's fmaps (``GEN_KW``). The bundles run at 32 px (LPIPS
needs it) with PGGAN narrowed in both packages to ``NARROW``, min(512 / res,
32): 16 channels at 32 px. tests/test_pggan.py's fmaps leave 2 there, and a
pixel norm over 2 channels, its moments in fp32 in both packages, parted
their float64 case-2 gradients by 2.7e-3 (8.6% of an element).
"""

import argparse
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_sgv1_train import (
    MODEL_TOL,
    Run,
    _cast,
    _check_same,
    _check_trajectory,
    _jnoise,
    _port_named,
    _recording,
    nonzero_leaves,
)
from tpugan import models as jmodels
from tpugan.cli import common as jcommon
from tpugan.invert import EmbeddingConfig as JEmbeddingConfig
from tpugan.invert import make_embedder as jmake_embedder
from tpugan.io import convert as jconvert
from tpugan.losses.lpips import make_lpips_fn as jmake_lpips_fn
from tpugan.losses.lpips import random_params as jlpips_params
from tpugan.models.encoders import PGEncoder as JPGEncoder
from tpugan.models.encoders import PGEncoderBlock as JPGEncoderBlock
from tpugan.models.pggan import PGConvBlock as JPGConvBlock
from tpugan.models.pggan import PGGANGenerator as JPGGANGenerator
from tpugan.ops.eq_lr import lreq_coef_tree
from tpugan.optim import lreq_adam as jlreq_adam
from tpugan.train.e_align import info_scalars as jinfo_scalars
from tpugan.train.e_align import init_train_state as jinit_train_state
from tpugan.train.e_align import make_train_step as jmake_train_step
from tpugan_torch import models as pmodels
from tpugan_torch.cli import baseline_i2s, common, e_align, e_mis_align, edit, embedding, infer_e, rec_real_img
from tpugan_torch.io import convert
from tpugan_torch.io.bridge import load_variables
from tpugan_torch.losses.lpips import LPIPS, make_lpips_fn
from tpugan_torch.models import PGConvBlock, PGEncoder, PGEncoderBlock, PGGANGenerator
from tpugan_torch.ops import cuda
from tpugan_torch.ops.eq_lr import lreq_coefs
from tpugan_torch.tools import reference_state
from tpugan_torch.train.e_align import Request, build_pggan_pipeline

torch.set_num_threads(1)

BLOCK_TOL = dict(rtol=1e-4, atol=1e-4)


def close(got, ref, tol=MODEL_TOL):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=tol["rtol"], atol=tol["atol"] * max(1.0, float(np.abs(ref).max())))


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def nhwc(x):
    return x.detach().numpy().transpose(0, 2, 3, 1)


def drawn(variables, rng):
    """tpugan's variables as numpy, every constant-initialised leaf drawn
    around its constant (kernels keep the init)."""
    variables = jax.tree.map(np.asarray, variables)
    return {**variables, "params": nonzero_leaves(variables["params"], rng)}


# ---------------------------------------------------------------------------
# the generator

GEN_KW = dict(resolution=32, z_space_dim=16, fmaps_base=64, fmaps_max=16)


@pytest.mark.parametrize("form", [
    dict(in_channels=16, out_channels=8, kernel_size=4, padding=3),  # the 4x4 "dense" conv
    dict(in_channels=8, out_channels=6),
    dict(in_channels=8, out_channels=6, upsample=True),
    dict(in_channels=8, out_channels=6, upsample=True, fused_scale=True),
    dict(in_channels=8, out_channels=3, kernel_size=1, padding=0, wscale_gain=1.0, activation_type="linear"),
], ids=["dense4x4", "conv", "upsample", "fused", "to_rgb"])
def test_conv_block_matches_tpugan(form, rng):
    side = 1 if form.get("kernel_size") == 4 else 6
    x = rng.randn(2, side, side, form["in_channels"]).astype(np.float32)
    jb = JPGConvBlock(**form)
    variables = drawn(jb.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    port = load_variables(PGConvBlock(**form), variables)
    close(port(nchw(x)), jb.apply(variables, jnp.asarray(x)).transpose(0, 3, 1, 2), BLOCK_TOL)


@pytest.mark.parametrize("form,lod", [
    (dict(), 0.0),
    (dict(fused_scale=True), 0.0),
    (dict(), 1.5),
    (dict(fused_scale=True), 0.25),
    (dict(), 2.0),
    (dict(label_size=3, final_tanh=True), 0.0),
], ids=["plain", "fused", "lod1.5", "fused-lod0.25", "lod2", "label-tanh"])
def test_generator_matches_tpugan(form, lod, rng):
    """Every ToRGB head exists on both sides; at a fractional lod the
    blend of two heads, at an integer one the up-scaled lower head."""
    z = rng.randn(2, GEN_KW["z_space_dim"]).astype(np.float32)
    label = jnp.asarray(np.eye(3, dtype=np.float32)[[0, 2]]) if form.get("label_size") else None
    jg = JPGGANGenerator(**GEN_KW, **form)
    variables = jg.init(jax.random.PRNGKey(0), jnp.asarray(z), label)
    variables = jax.tree.map(lambda v: (rng.randn(*v.shape) * 0.5).astype(np.float32), variables)
    want = jg.apply(variables, jnp.asarray(z), label, lod=lod)
    port = load_variables(PGGANGenerator(**GEN_KW, **form), variables)
    got = port(torch.from_numpy(z), None if label is None else torch.from_numpy(np.array(label)), lod=lod)
    assert got["image"].shape == (2, 3, 32, 32)
    close(got["image"], np.asarray(want["image"]).transpose(0, 3, 1, 2))
    close(got["z"], want["z"])


def test_generator_refuses_what_tpugan_refuses():
    gen = PGGANGenerator(**GEN_KW)
    with pytest.raises(ValueError, match="latent code"):
        gen(torch.zeros(2, 1, 16))
    with pytest.raises(ValueError, match="maximum lod"):
        gen(torch.zeros(2, 16), lod=3.5)
    with pytest.raises(ValueError, match="label"):
        PGGANGenerator(**GEN_KW, label_size=2)(torch.zeros(2, 16))


def test_pipeline_gives_z_zero_const_and_no_noise():
    gen = PGGANGenerator(**GEN_KW, generator=torch.Generator().manual_seed(0))
    synth, resynth = build_pggan_pipeline(gen, train=True)
    z = torch.randn(2, 16, generator=torch.Generator().manual_seed(1))
    batch = synth(z)
    assert torch.equal(batch.w1, z) and batch.imgs1.shape == (2, 32, 32, 3)
    assert torch.equal(batch.const1, torch.zeros(2, 1)) and not batch.imgs1.requires_grad
    z2 = z.clone().requires_grad_(True)
    resynth(z2, batch).square().mean().backward()
    assert z2.grad.abs().max() > 0 and all(p.grad is None and not p.requires_grad for p in gen.parameters())
    for fn in (lambda: synth(z, noise=[]), lambda: resynth(z2, batch, noise=[])):
        with pytest.raises(ValueError, match="no noise"):
            fn()


# ---------------------------------------------------------------------------
# E_PG

ENC_KW = dict(startf=8, maxf=32, layer_count=4, latent_size=16)


@pytest.mark.parametrize("cin,cout,second", [(8, 16, True), (16, 16, True), (16, 16, False)],
                         ids=["widening", "same-width", "last"])
def test_encoder_block_matches_tpugan(cin, cout, second, rng):
    x = rng.randn(2, 8, 8, cin).astype(np.float32)
    port = PGEncoderBlock(cin, cout, has_second_conv=second)
    noise = [torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in port.noise_shapes(2, 8)]
    jnoise = tuple(jnp.asarray(nhwc(n)) for n in noise)
    jb = JPGEncoderBlock(in_features=cin, out_features=cout, has_second_conv=second)
    variables = drawn(jb.init(jax.random.PRNGKey(0), jnp.asarray(x), jnoise), rng)
    load_variables(port, variables)
    close(port(nchw(x), noise), np.asarray(jb.apply(variables, jnp.asarray(x), jnoise)).transpose(0, 3, 1, 2),
          BLOCK_TOL)


def test_encoder_matches_tpugan(rng):
    """E_PG's features and z; ``new_final`` reads the (h, w, c) flatten, so
    its kernel crosses the bridge as it is (a (c, h, w) reader would part
    here: the last map is 4x4 with 32 distinct channels)."""
    x = rng.randn(2, 32, 32, 3).astype(np.float32)
    port = PGEncoder(**ENC_KW, img_size=32)
    noise = [tuple(torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in block)
             for block in port.noise_shapes(2, 32)]
    jnoise = _jnoise(noise)
    je = JPGEncoder(**ENC_KW)
    variables = drawn(je.init(jax.random.PRNGKey(0), jnp.asarray(x), jnoise), rng)
    load_variables(port, variables)
    feats, z = port(nchw(x), noise)
    jfeats, jz = je.apply(variables, jnp.asarray(x), jnoise)
    assert feats.shape == (2, 32, 4, 4) and z.shape == (2, 16)
    close(feats, np.asarray(jfeats).transpose(0, 3, 1, 2))
    close(z, jz)


# ---------------------------------------------------------------------------
# the converters

@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_pggan_converter_is_tpugans(fused):
    """A reference-named PGGAN state dict (with its ``lod`` buffer) through
    the port's converter, and through tpugan's and the bridge: bit for bit."""
    make = functools.partial(PGGANGenerator, **GEN_KW, fused_scale=fused)
    state = reference_state.pggan(np.random.default_rng(0), make)
    assert state["layer2.weight"].shape == ((16, 8, 3, 3) if fused else (8, 16, 3, 3))
    port = convert.load_state(make(), convert.pggan_generator(state))
    via = load_variables(make(), {"params": jconvert.pggan_generator(state, fused_scale=fused)})
    for name, value in via.state_dict().items():
        assert torch.equal(port.state_dict()[name], value), name


def test_pg_encoder_converter_is_tpugans():
    """E_PG's dict: ``new_final``'s columns reordered from the reference's
    (c, h, w) flatten, as tpugan permutes its rows; bit for bit."""
    make = functools.partial(PGEncoder, startf=8, maxf=32, layer_count=4, latent_size=16, img_size=32)
    state = reference_state.encoder(np.random.default_rng(1), make)
    assert state["new_final.weight"].shape == (16, 32 * 16) and "decode_block.1.instance_norm_3.weight" in state
    port = convert.load_state(make(), convert.pg_encoder(state, 4, maxf=32))
    via = load_variables(make(), {"params": jconvert.pg_encoder(state, 4, maxf=32)})
    for name, value in via.state_dict().items():
        assert torch.equal(port.state_dict()[name], value), name
    assert not np.array_equal(port.new_final.weight.detach().numpy(), state["new_final.weight"])


# ---------------------------------------------------------------------------
# the mtype-3 bundle, its request, the train step and the inversion

NARROW = dict(fmaps_base=512, fmaps_max=32)
IMG, START_FEATURES, BATCH, LR, STEPS = 32, 16, 2, 0.0015, 3


@contextlib.contextmanager
def narrow():
    """Both packages' bundles build PGGANGenerator with NARROW."""
    with pytest.MonkeyPatch.context() as mp:
        for module in (jmodels, pmodels):
            mp.setattr(module, "PGGANGenerator", functools.partial(module.PGGANGenerator, **NARROW))
        yield


def _argv(*extra):
    return ["--mtype", "3", "--img_size", str(IMG), "--start_features", str(START_FEATURES), "--random_init",
            "--device", "cpu", "--batch_size", str(BATCH), *extra]


def _common_args(*extra):
    return common.add_common_args(argparse.ArgumentParser(), training=True).parse_args(_argv(*extra))


@pytest.fixture(scope="module")
def setup():
    """tpugan's mtype-3 bundle (narrowed) and its variables with the
    constant leaves drawn, random LPIPS variables, and numpy inputs: z and
    E_PG's noise for each step."""
    rng = np.random.RandomState(0)
    with narrow():
        jbundle = jcommon.build_bundle(_common_args())
    frozen = drawn(jbundle.frozen, rng)
    enc_vars = drawn(jbundle.enc_vars, rng)
    lp_vars = jax.tree.map(
        lambda x: (rng.randn(*x.shape) / np.sqrt(np.prod(x.shape[:-1]))).astype(np.float32),
        jax.eval_shape(lambda: jlpips_params(jax.random.PRNGKey(7), IMG)))
    with narrow():
        shapes = common.build_bundle(_common_args()).encoder.noise_shapes(BATCH, IMG)
    inputs = [(rng.randn(BATCH, 512).astype(np.float32),
               [tuple(torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in b) for b in shapes])
              for _ in range(STEPS)]
    return dict(jbundle=jbundle, frozen=frozen, enc_vars=enc_vars, lp_vars=lp_vars, inputs=inputs)


def _port_bundle(setup, *extra):
    with narrow():
        bundle = common.build_bundle(_common_args(*extra))
    load_variables(bundle.generator, setup["frozen"])
    load_variables(bundle.encoder, setup["enc_vars"])
    return bundle


def test_bundle_builds_pggan_and_e_pg_as_tpugan():
    with narrow():
        bundle = common.build_bundle(_common_args())
    assert bundle.mtype == 3 and isinstance(bundle.generator, PGGANGenerator)
    assert isinstance(bundle.encoder, PGEncoder) and bundle.layer_count == 4 and bundle.z_dim == 512
    assert bundle.generator.get_nf(32) == 16  # the narrowed fmaps
    # full width: GenForce's fmaps, min(16384 / res, 512)
    assert [PGGANGenerator(1024).get_nf(r) for r in (4, 32, 64, 128, 1024)] == [512, 512, 256, 128, 16]


def _tpugan_request(setup, z, noise, dtype=np.float32):
    """tpugan's mtype-3 bundle closures on z and E_PG's noise, in
    ``dtype`` (float64 under x64): (imgs1, imgs2)."""
    jb = setup["jbundle"]
    cast = lambda tree: jax.tree.map(lambda x: jnp.asarray(x, dtype), tree)  # noqa: E731
    with jax.enable_x64(dtype == np.float64):
        frozen = cast(setup["frozen"])
        batch = jb.synth(frozen, None, jnp.asarray(z, dtype))
        _, jz2 = jb.encoder.apply(cast(setup["enc_vars"]), batch.imgs1, _jnoise(noise, dtype))
        return np.asarray(batch.imgs1), np.asarray(jb.resynth(frozen, jz2, batch, None))


def test_request_matches_tpugan(setup):
    """infer_e's request on the port's mtype-3 bundle against tpugan's
    bundle closures on the same z and E_PG noise, no kernel launched. In
    float64 on both sides at MODEL_TOL; in fp32 imgs1 at MODEL_TOL and
    imgs2 (G -> E_PG -> G, whose fp32 rounding moved either package by
    4e-4 to 7.5e-4 at tests/test_pggan.py's fmaps) held to the float64 run
    within MODEL_TOL or twice tpugan's own fp32 distance from it."""
    z, noise = setup["inputs"][0]
    bundle = _port_bundle(setup)
    cuda.reset_launches()
    imgs1, imgs2 = infer_e.serve(bundle, Request(torch.from_numpy(z), None, noise, None))
    assert not any(cuda.launches.values()) and imgs1.shape == (BATCH, IMG, IMG, 3)
    bundle64 = _port_bundle(setup)
    bundle64.generator.double(), bundle64.encoder.double()
    port64 = infer_e.serve(bundle64, Request(torch.from_numpy(z).double(), None, _cast(noise, torch.float64), None))
    ref = _tpugan_request(setup, z, noise, np.float64)
    for got, want in zip(port64, ref):
        close(got, want)
    jimgs1, jimgs2 = _tpugan_request(setup, z, noise)
    close(imgs1, jimgs1)
    own = np.abs(jimgs2 - ref[1]).max()
    np.testing.assert_allclose(imgs2.numpy(), ref[1], rtol=MODEL_TOL["rtol"],
                               atol=max(MODEL_TOL["atol"] * max(1.0, np.abs(ref[1]).max()), 2 * own))
    assert np.abs(ref[1]).max() > 0


def test_draw_request_is_z_and_e_pg_noise():
    with narrow():
        bundle = common.build_bundle(_common_args())
    req = infer_e.draw_request(bundle, BATCH, 30001)
    assert req.z.shape == (BATCH, 512) and req.noise_g is None and req.noise_g2 is None and req.label is None
    assert [tuple(n.shape) for b in req.noise_e for n in b] == [s for b in bundle.encoder.noise_shapes(BATCH, IMG)
                                                                for s in b]
    again = infer_e.draw_request(bundle, BATCH, 1)  # 30001 % 30000
    assert torch.equal(again.z, req.z)
    draws = common.draw_inputs(bundle, 1)
    assert draws.noise_g is None and draws.zt is None and len(draws.noise_e) == bundle.layer_count


_JITTED = {}


def _tpugan_run(setup, case, lean_after_first=False, dtype=np.float32):
    """tpugan's make_train_step over its mtype-3 bundle's closures, z and
    the noise from the setup (the noise rides in ``SynthBatch.label``)."""
    jb = setup["jbundle"]
    cast = lambda tree: jax.tree.map(lambda x: np.asarray(x, dtype), tree)  # noqa: E731
    params = cast(setup["enc_vars"]["params"])
    extra = {k: v for k, v in setup["enc_vars"].items() if k != "params"}

    def synth(frozen, key, z):
        return jb.synth(frozen["g"], key, frozen["z"])._replace(label=frozen["noise_e"])

    def resynth(frozen, w2, batch, key):
        return jb.resynth(frozen["g"], w2, batch, key)

    def encode(params, batch, key):
        return jb.encoder.apply({**extra, "params": params}, batch.imgs1, batch.label)

    opt = _recording(jlreq_adam(LR, coefs=lreq_coef_tree(params, setup["enc_vars"].get("lreq", {}))))
    kw = dict(encode=encode, synth=synth, resynth=resynth, optimizer=opt, z_dim=512, batch_size=BATCH, case=case)
    steps = STEPS if case == 1 else 1
    with jax.enable_x64(dtype == np.float64):
        key = (case, np.dtype(dtype).name)
        if key not in _JITTED:
            lpips = jmake_lpips_fn(cast(setup["lp_vars"])) if case == 2 else None
            _JITTED[key] = jax.jit(jmake_train_step(**kw, lpips_fn=lpips))
        if lean_after_first and "lean" not in _JITTED:
            _JITTED["lean"] = jax.jit(jmake_train_step(**kw, compute_image_losses=False))
        state = jinit_train_state(params, opt)
        g = cast(setup["frozen"])
        infos, grads = [], None
        n = 1 if case == 1 else 2
        for it, (z, ne) in enumerate(setup["inputs"][:steps]):
            frozen = {"g": g, "z": jnp.asarray(z, dtype), "noise_e": _jnoise(ne, dtype)}
            fn = _JITTED["lean"] if (lean_after_first and it > 0) else _JITTED[key]
            state, info = fn(state, jnp.int32(it), frozen)
            infos.append(jinfo_scalars(info))
            if it == 0:
                grads = state.opt_state[-n:]
    with narrow():
        port = e_align.build_trainer(e_align.make_parser().parse_args(_argv("--iterations", "3"))).state.encoder
    return Run(infos, [_port_named(port, g) for g in grads], _port_named(port, state.params))


def _port_run(setup, case, lean_after_first=False, dtype=torch.float32):
    requests = [Request(torch.from_numpy(z).to(dtype), None, _cast(ne, dtype), None) for z, ne in setup["inputs"]]
    lpips = make_lpips_fn(load_variables(LPIPS(), setup["lp_vars"]).to(dtype)) if case == 2 else None
    args = e_align.make_parser().parse_args(_argv("--iterations", "3", "--case", str(case), "--lr", str(LR)))
    with narrow():
        trainer = e_align.build_trainer(args, lpips, draw=lambda it: requests[it])
    load_variables(trainer.bundle.generator, setup["frozen"])
    load_variables(trainer.bundle.encoder, setup["enc_vars"])
    for module in (trainer.bundle.generator, trainer.bundle.encoder):
        module.to(dtype)
    frozen = list(trainer.bundle.generator.parameters())
    frozen0 = [p.clone() for p in frozen]
    state, recorded = trainer.state, []
    step_with = state.optimizer.step
    state.optimizer.step = lambda g=None: (recorded.append([None if x is None else x.clone() for x in g]),
                                           step_with(g))
    infos = []
    steps = STEPS if case == 1 else 1
    for it in range(steps):
        fn = trainer.lean if (lean_after_first and it > 0) else trainer.step
        state, info = fn(state, it)
        infos.append(e_align.info_scalars(info))
    n = 1 if case == 1 else 2
    assert len(recorded) == n * steps
    assert all(p.grad is None and not p.requires_grad for p in frozen)
    assert all(torch.equal(p, p0) for p, p0 in zip(frozen, frozen0))
    params = dict(state.encoder.named_parameters())
    grads = [{name: np.zeros(tuple(params[name].shape)) if g is None else g.numpy()
              for name, g in zip(params, step)} for step in recorded[:n]]
    return trainer, Run(infos, grads, {k: v.detach().numpy() for k, v in params.items()})


def _held_to_rounding(encoder, runs, updates):
    """E_PG's ``conv_3.bias`` feeds an instance norm, which removes it: its
    gradient is zero but for rounding (checked, in each run, within 1e-6 of
    the step's largest gradient), so LREQAdam's sign-like first update moves
    it by +-lr in either direction at random. Such a leaf is held to the
    per-element bound of the trajectory rule (2 lr c an update), not to its
    mean; returns a filter of the other leaves."""
    names = [n for n in runs[0].params if n.endswith("conv_3.bias")]
    assert names
    for run in runs:
        for grads in run.grads:
            top = max(np.abs(g).max() for g in grads.values())
            for name in names:
                assert np.abs(grads[name]).max() <= 1e-6 * top, name
    coefs = lreq_coefs(encoder)
    for name in names:
        assert np.abs(runs[0].params[name] - runs[1].params[name]).max() <= 2 * LR * coefs[name] * updates
    return lambda params: {k: v for k, v in params.items() if k not in names}


def test_case1_step_matches_tpugan(setup):
    """Three case-1 steps: every scalar (loss_c over the broadcast zero
    const among them), the gradient and the parameters after."""
    want = _tpugan_run(setup, 1)
    trainer, got = _port_run(setup, 1)
    assert got.infos[0]["loss_c_mse"] > 0 and got.infos[0]["loss_imgs_ssim"] > 0
    _check_same(got, want)
    _check_trajectory(trainer.state.encoder, got.params, want.params, STEPS)


def test_lean_step_matches_tpugan_and_is_bitwise_the_full_trajectory(setup):
    want = _tpugan_run(setup, 1, lean_after_first=True)
    trainer, lean = _port_run(setup, 1, lean_after_first=True)
    _, full = _port_run(setup, 1)
    _check_same(lean, want)
    for name, p in full.params.items():
        np.testing.assert_array_equal(lean.params[name], p, err_msg=name)
    assert lean.infos[-1]["loss_imgs_mse"] == 0.0 and lean.infos[-1]["loss_mtv"] == full.infos[-1]["loss_mtv"]


def test_case2_step_matches_tpugan(setup):
    """One case-2 step (the image losses with LPIPS back through PGGAN to
    E_PG) in float64 on both sides at the train tests' tolerances; in fp32
    the scalars at MODEL_TOL and the parameters by the trajectory rule
    against the float64 run, or twice tpugan's own fp32 distance."""
    ref = _tpugan_run(setup, 2, dtype=np.float64)
    trainer, got64 = _port_run(setup, 2, dtype=torch.float64)
    _check_same(got64, ref)
    moving = _held_to_rounding(trainer.state.encoder, [got64, ref], 2)
    _check_trajectory(trainer.state.encoder, moving(got64.params), moving(ref.params), 2)
    jax32 = _tpugan_run(setup, 2)
    trainer, got = _port_run(setup, 2)
    for key in jax32.infos[0]:
        np.testing.assert_allclose(got.infos[0][key], jax32.infos[0][key], **MODEL_TOL, err_msg=key)
    moving = _held_to_rounding(trainer.state.encoder, [got, ref], 2)
    _check_trajectory(trainer.state.encoder, moving(got.params), moving(ref.params), 2, own=moving(jax32.params))
    assert np.abs(got.grads[0]["block_0.conv_1.weight"]).max() > 0
    assert got.infos[0]["loss_imgs_lpips"] != 0  # LPIPS entered the step (random heads may be negative)


def test_embedding_iteration_matches_tpugan(setup, tmp_path):
    """One fine-tune-E iteration of ``embedding --mtype 3``'s inverter
    against tpugan's make_embedder over its CLI's closures (z for w, E_PG's
    noise the CLI's draws), and the CLI's files from a 2-iteration run."""
    args = embedding.make_parser().parse_args(_argv("--iterations", "1", "--batch_size", "1",
                                                    "--img_dir", str(tmp_path)))
    bundle = _port_bundle(setup)
    inverter = embedding.build_inverter(args, bundle=bundle)
    target = infer_e.serve(bundle, Request(torch.from_numpy(setup["inputs"][1][0]), None,
                                           setup["inputs"][1][1], None))[0][:1]
    noise_e = common.draw_inputs(bundle, 1, 1).noise_e
    got = inverter.invert(target)
    jb = setup["jbundle"]
    extra = {k: v for k, v in setup["enc_vars"].items() if k != "params"}
    params = setup["enc_vars"]["params"]

    def encode(params, imgs):
        return jb.encoder.apply({**extra, "params": params}, imgs, _jnoise(noise_e))

    def resynth(frozen, w):
        return jb.resynth(frozen, w, None, jax.random.PRNGKey(0))

    invert = jmake_embedder(encode, resynth, params, lreq_coef_tree(params, extra.get("lreq", {})),
                            JEmbeddingConfig(iterations=1, lr=args.lr), frozen=setup["frozen"])
    want = invert(jnp.asarray(target.numpy()))
    assert got.w.shape == (1, 512)
    close(got.w, want.w)
    close(got.images, want.images)
    close(np.asarray([[float(a), float(b)] for a, b in got.losses]),
          np.asarray([[float(a), float(b)] for a, b in want.losses]))

    from tpugan_torch.io.image import save_image

    img_dir = tmp_path / "in"
    save_image(str(img_dir / "a.png"), np.clip(target[0].numpy() * 0.5 + 0.5, 0, 1))
    out = tmp_path / "out"
    with narrow():
        embedding.main(_argv("--iterations", "2", "--batch_size", "1", "--img_dir", str(img_dir),
                             "--experiment_dir", str(out)))
    assert (out / "imgs" / "00000_rec.png").exists() and (out / "models" / "id0-i0-w.npy").exists()
    w_all = np.load(out / "models" / "w_all.npy")
    assert w_all.shape == (1, 512) and np.isfinite(w_all).all()


def test_clis_run_mtype_3(tmp_path, capsys):
    """infer_e, e_align (case 1 and 2, --bf16) and rec_real_img run on the
    CPU with files; baseline_i2s, edit and e_mis_align refuse mtype 3, as
    tpugan's fail there."""
    with narrow():
        infer_e.main(_argv("--count", "1", "--experiment_dir", str(tmp_path / "inf")))
        for case in ("1", "2"):
            e_align.main(_argv("--iterations", "2", "--log_every", "1", "--case", case,
                               "--experiment_dir", str(tmp_path / f"c{case}")))
            assert (tmp_path / f"c{case}" / "Loss.txt").read_text().count("\n") == 2
        e_align.main(_argv("--iterations", "1", "--bf16", "--case", "2", "--experiment_dir", str(tmp_path / "b")))
        rec_real_img.main(_argv("--batch_size", "1", "--img_dir", str(tmp_path / "inf" / "imgs"),
                                "--experiment_dir", str(tmp_path / "rec")))
    assert (tmp_path / "inf" / "imgs" / "infer_seed30000.png").exists()
    assert (tmp_path / "rec" / "imgs" / "00000_rec.png").exists()
    assert (tmp_path / "rec" / "models" / "00000_w.npy").exists()
    with pytest.raises(TypeError, match="PGGAN"):
        baseline_i2s.main(_argv("--img_dir", str(tmp_path)))
    with pytest.raises(TypeError, match="PGGAN"):
        edit.main(["--mtype", "3", "--random_init", "--device", "cpu", "--w_path", "w.npy", "--direction", "d.npy"])
    with pytest.raises(TypeError, match="PGGAN"):
        e_mis_align.build_trainer(e_mis_align.parse_args(_argv("--iterations", "1")))


def test_converted_files_serve_as_tpugans(tmp_path):
    """``--checkpoint_dir_GAN`` (a ``generator_smooth.``-prefixed .pth) and
    ``--checkpoint_dir_E`` at the narrowed width: the port's bundle against
    tpugan's, each loading the same files, on one request. E_PG at
    start_features 64, so that its last map is 512 x 4 x 4, the width both
    converters take ``new_final``'s flatten at."""
    rng = np.random.default_rng(3)
    with narrow():
        make_g = lambda: pmodels.PGGANGenerator(resolution=IMG)  # noqa: E731
        g_state = reference_state.pggan(rng, make_g)
    e_state = reference_state.encoder(rng, lambda: PGEncoder(startf=64, maxf=512, layer_count=4,
                                                            latent_size=512, img_size=IMG))
    g_path = reference_state.save(str(tmp_path / "pggan.pth"), {f"generator_smooth.{k}": v for k, v in g_state.items()})
    e_path = reference_state.save(str(tmp_path / "E_PG.pth"), e_state)
    flags = ["--checkpoint_dir_GAN", g_path, "--checkpoint_dir_E", e_path]
    parser = common.add_common_args(argparse.ArgumentParser(), training=True)
    argv = [a for a in _argv(*flags, "--start_features", "64") if a != "--random_init"]
    with narrow():
        bundle = common.build_bundle(parser.parse_args(argv))
        jb = jcommon.build_bundle(parser.parse_args(argv))
    z = np.random.RandomState(4).randn(BATCH, 512).astype(np.float32)
    imgs1, imgs2 = infer_e.serve(bundle, Request(torch.from_numpy(z), None, None, None))
    batch = jb.synth(jb.frozen, None, jnp.asarray(z))
    _, jz2 = jb.encoder.apply(jb.enc_vars, batch.imgs1)
    close(imgs1, batch.imgs1)
    close(imgs2, jb.resynth(jb.frozen, jz2, batch, None))
