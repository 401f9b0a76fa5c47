"""tpugan_torch's real-image inversion (``invert/``, the ``embedding``,
``rec_real_img``, ``edit`` and ``baseline_i2s`` CLIs) vs tpugan (CPU).

Both sides invert the same target with the same weights (tpugan's init,
its constant leaves drawn, through the bridge) and the same noise, drawn
with numpy and injected: tpugan's closures apply it in place of their
``PRNGKey(0)`` draws, which give the same noise on every call, as the
port's closures read the same tensors on every call. Sizes are tpugan's
``_tiny_inversion_setup`` (``tests/test_eval_invert.py``): StyleGANv1 with
layer_count 3, startf 8, maxf 32, latent 32, at 16 px, E alike.

Tolerances:

* float64 on both sides (tpugan under ``enable_x64``), 4 iterations in
  chunks of 2, in each mode: w, the images, the loss histories and the
  snapshot within rtol 1e-4 and an atol of 1e-4 of the largest value. The
  rtol 1e-6 first written here does not hold: a float64 run is not all
  float64 in either package. Both normalise in fp32 (``instance_norm``
  casts to fp32 and back), tpugan's equalized-LR coefficients are fp32
  constants and its LREQAdam's bias correction is fp32, so the two runs
  part at fp32's rounding, about 1e-7, and four updates carry that into w
  (4.7e-7 optimising w, 5.8e-6 fine-tuning E, of values about 1; ``-s``
  prints each deviation). At lr 2.0 (the snapshot's own case) the losses,
  the arm and the improvements are held, not w, which that lr scatters;
* fp32, one iteration: the whole-model tolerance, rtol 2e-3 / atol 2e-4
  (``tests/test_stylegan1.py:134``); StyleGAN2 and E_BIG (spectral norm),
  2 iterations in fp32 at the same tolerance;
* bf16 fine-tuning E: the port's bf16 no farther from tpugan's fp32 than
  twice tpugan's own bf16 is (``tests/test_torch_bf16.py``'s rule);
* the LPIPS cache bitwise the uncached run; image reading bitwise tpugan's.
"""

import functools
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from test_torch_bf16 import assert_as_close_as_tpugan, bf16_values
from test_torch_biggan import randomized
from test_torch_sgv1_train import nonzero_leaves
from test_torch_stylegan2 import lively
from test_torch_train import CFG as BIGGAN_CFG
from test_torch_train import ENC as EBIG_KW
from tpugan import precision as jprecision
from tpugan.invert import EmbeddingConfig as JEmbeddingConfig
from tpugan.invert import make_embedder as jmake_embedder
from tpugan.invert.edit import edit_latent as jedit_latent
from tpugan.io.image import load_image_dir as jload_image_dir
from tpugan.models import Encoder as JEncoder
from tpugan.models import StyleGAN2Generator as JStyleGAN2Generator
from tpugan.models import StyleGANv1Generator as JStyleGANv1Generator
from tpugan.models.biggan import BigGAN as JBigGAN
from tpugan.models.biggan import BigGANConfig as JBigGANConfig
from tpugan.models.encoders import BigGANEncoder as JBigGANEncoder
from tpugan.ops.eq_lr import lreq_coef_tree
from tpugan_torch import precision
from tpugan_torch.cli import baseline_i2s, edit, embedding, rec_real_img
from tpugan_torch.invert import EmbeddingConfig, edit_latent, load_direction, make_embedder
from tpugan_torch.io.bridge import load_variables
from tpugan_torch.io.image import load_image_dir
from tpugan_torch.losses.lpips import random_lpips_fn
from tpugan_torch.losses.space_loss import space_loss
from tpugan_torch.nn.spectral import power_iterate
from tpugan_torch.models import (
    BigGAN,
    BigGANConfig,
    BigGANEncoder,
    Encoder,
    StyleGAN2Generator,
    StyleGANv1Generator,
)
from tpugan_torch.ops import cuda
from tpugan_torch.train.e_align import attention_crops

torch.set_num_threads(1)

LAYERS, RES, LATENT = 3, 16, 32
SGV1_KW = dict(startf=8, maxf=32, layer_count=LAYERS, latent_size=LATENT)
SG2_KW = dict(resolution=RES, z_space_dim=LATENT, w_space_dim=LATENT, mapping_layers=3,
              mapping_fmaps=LATENT, fmaps_base=512, fmaps_max=32)
BIGGAN_IMG = 32
# float64 runs: rtol and atol as a share of max |ref| (see the docstring)
F64_TOL = dict(rtol=1e-4, atol_share=1e-4)
MODEL_TOL = dict(rtol=2e-3, atol=2e-4)
MODES = {"optimize_w": False, "finetune_e": True}


def nhwc(x):
    return np.asarray(x).transpose(0, 2, 3, 1)


def _noise(shapes, rng):
    """numpy draws rounded to bf16 once (so the bf16 runs read the same
    values), for the port (NCHW) and tpugan (NHWC)."""
    port = [tuple(bf16_values(rng.randn(*s).astype(np.float32)) for s in block) for block in shapes]
    return port, [tuple(nhwc(n) for n in block) for block in port]


def _port_noise(noise, dtype):
    return [tuple(torch.from_numpy(n).to(dtype) for n in block) for block in noise]


def _jax_noise(noise, dtype):
    return [tuple(jnp.asarray(n, dtype) for n in block) for block in noise]


def _init(module, rngs, *args):
    return jax.tree.map(np.asarray, jax.jit(module.init)(rngs, *args))


def _buffers_like(tree, module, prefix=""):
    """The module's buffers in the layout of a tpugan variable tree."""
    return {key: _buffers_like(value, module, f"{prefix}{key}.") if isinstance(value, dict)
            else module.get_buffer(prefix + key).numpy().copy() for key, value in tree.items()}


def _port_image(setup, w):
    """The target: the setup's generator at a w of its own, in fp32."""
    _, resynth, _ = setup.port(torch.float32)
    with torch.no_grad():
        return resynth(torch.from_numpy(w)).numpy()


# ---------------------------------------------------------------------------
# the models: each setup holds one generator/encoder pair on both sides and
# the target image; ``jax(dtype, bf16, optimize_e)`` gives ``(encode,
# resynth, base_params, coefs, frozen, sn0)`` for tpugan's make_embedder,
# ``port(dtype, bf16, optimize_e)`` gives ``(encode, resynth, encoder)`` for
# the port's


def _jbf16(encode, resynth, frozen, optimize_e):
    """tpugan's CLI's bf16 wrapping (tpugan/cli/embedding.py:129-150)."""
    def resynth16(frozen, w):
        return resynth(frozen, w.astype(jnp.bfloat16)).astype(jnp.float32)

    if optimize_e:
        encode = jprecision.bf16_encode_images(encode)
    return encode, resynth16, jprecision.bf16_frozen(frozen)


def _pbf16(encode, resynth, generator, encoder, optimize_e):
    """The port CLI's bf16 wrapping (tpugan_torch/cli/embedding.py)."""
    generator16 = precision.bf16_frozen(generator)

    def resynth16(w):
        return resynth(generator16, w.to(precision.BF16)).float()

    if optimize_e:
        encode = precision.bf16_encode_images(encode, encoder)
    return encode, resynth16


class SGv1:
    def __init__(self, rng):
        self.jg, self.je = JStyleGANv1Generator(**SGV1_KW), JEncoder(**SGV1_KW)
        key = jax.random.PRNGKey(0)
        gen_vars = _init(self.jg, {"params": key, "noise": key}, jnp.zeros((1, 2 * LAYERS, LATENT)))
        enc_vars = _init(self.je, {"params": key, "noise": key}, jnp.zeros((1, RES, RES, 3)))
        self.gen_vars = {**gen_vars, "params": nonzero_leaves(gen_vars["params"], rng)}
        self.enc_vars = {**enc_vars, "params": nonzero_leaves(enc_vars["params"], rng)}
        self.noise_g = _noise(StyleGANv1Generator(**SGV1_KW).noise_shapes(1), rng)
        self.noise_e = _noise(Encoder(**SGV1_KW).noise_shapes(1, RES), rng)
        w_true = rng.randn(1, 2 * LAYERS, LATENT).astype(np.float32)
        self.target = _port_image(self, w_true)

    def jax(self, dtype, bf16=False, optimize_e=True):
        cast = lambda t: jax.tree.map(lambda x: jnp.asarray(x, dtype), t)  # noqa: E731
        gen_vars, enc_vars = cast(self.gen_vars), cast(self.enc_vars)
        extra = {k: v for k, v in enc_vars.items() if k != "params"}
        je, jg, ne, ng = self.je, self.jg, self.noise_e[1], self.noise_g[1]

        def encode(params, imgs):
            return je.apply({**extra, "params": params}, imgs, 0, _jax_noise(ne, imgs.dtype))

        def resynth(frozen, w):
            return jg.apply(frozen, w, LAYERS - 1, 1.0, _jax_noise(ng, w.dtype))

        if bf16:
            encode, resynth, gen_vars = _jbf16(encode, resynth, gen_vars, optimize_e)
        coefs = lreq_coef_tree(enc_vars["params"], enc_vars["lreq"])
        return encode, resynth, enc_vars["params"], coefs, gen_vars, None

    def port(self, dtype, bf16=False, optimize_e=True):
        gen = load_variables(StyleGANv1Generator(**SGV1_KW), self.gen_vars,
                             unused=[f"to_rgb_{i}" for i in range(LAYERS - 1)]).to(dtype)
        gen.requires_grad_(False)
        enc = load_variables(Encoder(**SGV1_KW), self.enc_vars).to(dtype)
        ng, ne = self.noise_g[0], self.noise_e[0]

        def encode(imgs):
            const, w = enc(nchw_t(imgs), _port_noise(ne, dtype))
            return const.permute(0, 2, 3, 1), w

        def resynth(g, w):
            return g(w, LAYERS - 1, _port_noise(ng, dtype)).permute(0, 2, 3, 1)

        return _wrap_port(encode, resynth, gen, enc, bf16, optimize_e)


def nchw_t(x):
    return x.permute(0, 3, 1, 2).contiguous()


def _wrap_port(encode, resynth, gen, enc, bf16, optimize_e):
    if bf16:
        encode, resynth_w = _pbf16(encode, resynth, gen, enc, optimize_e)
    else:
        def resynth_w(w):
            return resynth(gen, w)
    return encode, resynth_w, enc


class SG2:
    """StyleGAN2 (skip, its FIRs and ToRGB up-2s) at 16 px on its noise
    buffers, with E."""

    def __init__(self, rng):
        self.jg, self.je = JStyleGAN2Generator(**SG2_KW), JEncoder(**SGV1_KW)
        key = jax.random.PRNGKey(0)
        self.gen_vars = lively(_init(self.jg, {"params": key}, jnp.zeros((1, LATENT))), rng, scale=0.1)
        enc_vars = _init(self.je, {"params": key, "noise": key}, jnp.zeros((1, RES, RES, 3)))
        self.enc_vars = {**enc_vars, "params": nonzero_leaves(enc_vars["params"], rng)}
        self.noise_e = _noise(Encoder(**SGV1_KW).noise_shapes(1, RES), rng)
        w_true = rng.randn(1, 2 * LAYERS, LATENT).astype(np.float32)
        self.target = _port_image(self, w_true)

    def jax(self, dtype, bf16=False, optimize_e=True):
        cast = lambda t: jax.tree.map(lambda x: jnp.asarray(x, dtype), t)  # noqa: E731
        gen_vars, enc_vars = cast(self.gen_vars), cast(self.enc_vars)
        extra = {k: v for k, v in enc_vars.items() if k != "params"}
        je, jg, ne = self.je, self.jg, self.noise_e[1]

        def encode(params, imgs):
            return je.apply({**extra, "params": params}, imgs, 0, _jax_noise(ne, imgs.dtype))

        def resynth(frozen, w):
            return jg.apply(frozen, w, method=jg.synthesize)["image"]

        if bf16:
            encode, resynth, gen_vars = _jbf16(encode, resynth, gen_vars, optimize_e)
        coefs = lreq_coef_tree(enc_vars["params"], enc_vars["lreq"])
        return encode, resynth, enc_vars["params"], coefs, gen_vars, None

    def port(self, dtype, bf16=False, optimize_e=True):
        gen = load_variables(StyleGAN2Generator(**SG2_KW), self.gen_vars).to(dtype)
        gen.requires_grad_(False)
        enc = load_variables(Encoder(**SGV1_KW), self.enc_vars).to(dtype)
        ne = self.noise_e[0]

        def encode(imgs):
            const, w = enc(nchw_t(imgs), _port_noise(ne, dtype))
            return const.permute(0, 2, 3, 1), w

        def resynth(g, w):
            return g.synthesize(w)["image"].permute(0, 2, 3, 1)

        return _wrap_port(encode, resynth, gen, enc, bf16, optimize_e)


class EBig:
    """BigGAN-deep at 32 px (its SelfAttn gamma 1) with E_BIG (spectral
    norms, z head scaled as tests/test_torch_train.py scales it), a fixed
    class and a truncated z in the condition."""

    def __init__(self, rng):
        self.jmodel, self.je = JBigGAN(JBigGANConfig(**BIGGAN_CFG)), JBigGANEncoder(**EBIG_KW)
        shape = jax.eval_shape(lambda: self.jmodel.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 8)), jnp.zeros((1, 10)), 0.4))
        gen_vars = randomized(jax.tree.map(lambda x: np.zeros(x.shape, x.dtype), shape), rng)
        for node in gen_vars["params"]["generator"].values():
            if "gamma" in node:
                node["gamma"] = np.ones_like(node["gamma"])
        self.gen_vars = gen_vars
        self.noise_e = _noise(BigGANEncoder(**EBIG_KW, img_size=BIGGAN_IMG).noise_shapes(1, BIGGAN_IMG), rng)
        enc_vars = randomized(jax.jit(self.je.init)(
            {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, BIGGAN_IMG, BIGGAN_IMG, 3)),
            jnp.zeros((1, 16)), _jax_noise(self.noise_e[1], jnp.float32)), rng)
        head = enc_vars["params"]["new_final_2"]
        for leaf in head:
            head[leaf] = head[leaf] * np.float32(0.03)
        # a trained E_BIG's u and v have converged: drawn at random, sigma
        # is far from W's norm and E(imgs), which optimising w starts from,
        # overflows the resynthesis
        port = load_variables(BigGANEncoder(**EBIG_KW, img_size=BIGGAN_IMG), enc_vars)
        power_iterate(port, n_iter=50)
        enc_vars["sn"] = _buffers_like(enc_vars["sn"], port)
        self.enc_vars = enc_vars
        self.label = np.eye(10, dtype=np.float32)[[3]]
        self.zt = (0.4 * np.clip(rng.randn(1, 8), -2, 2)).astype(np.float32)
        self.cond = np.concatenate(
            [self.zt, self.label @ gen_vars["params"]["embeddings"]["kernel"]], axis=1).astype(np.float32)
        z_true = (0.4 * np.clip(rng.randn(1, 8), -2, 2)).astype(np.float32)
        self.target = _port_image(self, z_true)

    def jax(self, dtype, bf16=False, optimize_e=True):
        cast = lambda t: jax.tree.map(lambda x: jnp.asarray(x, dtype), t)  # noqa: E731
        gen_vars, enc_vars = cast(self.gen_vars), cast(self.enc_vars)
        extra = {k: v for k, v in enc_vars.items() if k not in ("params", "sn")}
        je, jm, ne = self.je, self.jmodel, self.noise_e[1]
        cond, label = jnp.asarray(self.cond, dtype), jnp.asarray(self.label, dtype)

        def encode(params, imgs, sn=None):
            variables = {**extra, "params": params, "sn": sn}
            return je.apply(variables, imgs, cond.astype(imgs.dtype), _jax_noise(ne, imgs.dtype))

        def resynth(frozen, w):
            return jm.apply(frozen, w, label, 0.4)[0]

        if bf16:
            encode, resynth, gen_vars = _jbf16(encode, resynth, gen_vars, optimize_e)
        coefs = lreq_coef_tree(enc_vars["params"], enc_vars.get("lreq", {}))
        return encode, resynth, enc_vars["params"], coefs, gen_vars, enc_vars["sn"]

    def port(self, dtype, bf16=False, optimize_e=True):
        gen = load_variables(BigGAN(BigGANConfig(**BIGGAN_CFG)), self.gen_vars).eval().to(dtype)
        gen.requires_grad_(False)
        enc = load_variables(BigGANEncoder(**EBIG_KW, img_size=BIGGAN_IMG), self.enc_vars).eval().to(dtype)
        ne = self.noise_e[0]
        cond, label = torch.from_numpy(self.cond).to(dtype), torch.from_numpy(self.label).to(dtype)

        def encode(imgs):
            return enc(nchw_t(imgs), cond.to(imgs.dtype), _port_noise(ne, dtype))

        def resynth(g, w):
            return g(w, label, 0.4)[0].permute(0, 2, 3, 1)

        return _wrap_port(encode, resynth, gen, enc, bf16, optimize_e)


@functools.cache
def _setup(name):
    return {"sgv1": SGv1, "sg2": SG2, "ebig": EBig}[name](np.random.RandomState(0))


@pytest.fixture
def sgv1():
    return _setup("sgv1")


# ---------------------------------------------------------------------------
# runs


def _jax_run(setup, dtype, bf16=False, **cfg):
    """tpugan's run of ``setup`` (each run once a session: a make_embedder
    compiles anew)."""
    key = (id(setup), np.dtype(dtype).name, bf16, tuple(sorted(cfg.items())))
    if key not in _JAX_RUNS:
        _JAX_RUNS[key] = _jax_run_uncached(setup, dtype, bf16, **cfg)
    return _JAX_RUNS[key]


_JAX_RUNS = {}


def _jax_run_uncached(setup, dtype, bf16=False, lpips=None, **cfg):
    with jax.enable_x64(dtype == np.float64):
        encode, resynth, params, coefs, frozen, sn0 = setup.jax(dtype, bf16, cfg["optimize_e"])
        invert = jmake_embedder(encode, resynth, params, coefs, JEmbeddingConfig(**cfg),
                                lpips_fn=lpips, frozen=frozen, sn0=sn0)
        calls = []
        result = invert(jnp.asarray(setup.target, dtype),
                        chunk_callback=lambda i, w, im: calls.append((i, np.asarray(w), np.asarray(im))))
        return _jax_result(result), calls


def _jax_result(r):
    return dict(w=np.asarray(r.w), images=np.asarray(r.images),
                losses=np.asarray([[float(a), float(b)] for a, b in r.losses]),
                w_best=np.asarray(r.w_best), loss_best=float(r.loss_best), iter_best=int(r.iter_best),
                msiv=np.asarray(r.msiv_history), improved=np.asarray(r.improved_history),
                wnorm=np.asarray(r.wnorm_history))


def _port_run(setup, dtype, bf16=False, lpips=None, **cfg):
    encode, resynth, encoder = setup.port(dtype, bf16, cfg["optimize_e"])
    invert = make_embedder(encode, resynth, encoder, EmbeddingConfig(**cfg), lpips_fn=lpips)
    calls = []
    target = torch.from_numpy(setup.target).to(dtype)
    result = invert(target, chunk_callback=lambda i, w, im: calls.append((i, w.numpy(), im.numpy())))
    return _port_result(result), calls, encoder


def _port_result(r):
    return dict(w=r.w.numpy(), images=r.images.numpy(),
                losses=np.asarray([[float(a), float(b)] for a, b in r.losses]),
                w_best=r.w_best.numpy(), loss_best=float(r.loss_best), iter_best=int(r.iter_best),
                msiv=r.msiv_history.numpy(), improved=r.improved_history.numpy(),
                wnorm=r.wnorm_history.numpy())


def _assert_close(got, want, what, rtol, atol=0.0, atol_share=0.0):
    """assert_allclose, with an atol of its own or as a share of max |want|;
    prints the largest deviation (``-s``)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max())
    print(f"{what}: max |err| {err:.3e} (max |ref| {float(np.abs(want).max()):.3e})")
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol + atol_share * float(np.abs(want).max()),
                               err_msg=what)


def _assert_results_close(got, want, tol, keys=("w", "images", "losses", "w_best", "loss_best", "msiv",
                                                "wnorm")):
    assert got["iter_best"] == want["iter_best"]
    np.testing.assert_array_equal(got["improved"], want["improved"])
    for key in keys:
        _assert_close(got[key], want[key], key, **tol)


def _assert_calls_close(got, want, tol):
    assert [i for i, *_ in got] == [i for i, *_ in want]
    for (i, w, im), (_, jw, jim) in zip(got, want):
        _assert_close(w, jw, f"w at {i}", **tol)
        _assert_close(im, jim, f"images at {i}", **tol)


# ---------------------------------------------------------------------------
# make_embedder against tpugan's


@pytest.mark.parametrize("mode", MODES)
def test_embedder_matches_tpugan_in_float64(sgv1, mode):
    """4 iterations in chunks of 2 (the snapshot arms at iteration 2):
    every history, the snapshot, the callbacks' w and images, and the final
    w within F64_TOL of tpugan's (the module docstring's float64
    tolerance), both in float64; and the encoder is back at its base
    weights afterwards."""
    cfg = dict(iterations=4, chunk=2, optimize_e=MODES[mode])
    want, want_calls = _jax_run(sgv1, np.float64, **cfg)
    got, got_calls, encoder = _port_run(sgv1, torch.float64, **cfg)
    assert got["w"].shape == (1, 2 * LAYERS, LATENT) and got["iter_best"] >= 2
    _assert_results_close(got, want, F64_TOL)
    _assert_calls_close(got_calls, want_calls, F64_TOL)
    base = load_variables(Encoder(**SGV1_KW), sgv1.enc_vars).double().state_dict()
    assert all(torch.equal(t, base[k]) for k, t in encoder.state_dict().items())


@pytest.mark.parametrize("mode", MODES)
def test_one_fp32_iteration_matches_tpugan(sgv1, mode):
    cfg = dict(iterations=1, chunk=1, optimize_e=MODES[mode])
    want, want_calls = _jax_run(sgv1, np.float32, **cfg)
    got, got_calls, _ = _port_run(sgv1, torch.float32, **cfg)
    _assert_results_close(got, want, MODEL_TOL)
    _assert_calls_close(got_calls, want_calls, MODEL_TOL)


def test_snapshot_at_lr2_matches_tpugan(sgv1):
    """tpugan's destabilising lr 2.0 (test_inversion_best_loss_snapshot),
    6 iterations in float64: the arm at 3, the improvements after it and
    the snapshot as tpugan's."""
    cfg = dict(iterations=6, chunk=3, lr=2.0, optimize_e=False)
    want, _ = _jax_run(sgv1, np.float64, **cfg)
    got, calls, _ = _port_run(sgv1, torch.float64, **cfg)
    _assert_results_close(got, want, F64_TOL, keys=("losses", "loss_best", "msiv", "wnorm"))
    assert got["iter_best"] >= 3 and not got["improved"][:4].any()
    # the snapshot holds the iteration's initial w: at the arm (a chunk's
    # end here) the callback's w
    assert got["iter_best"] != 3 or np.array_equal(got["w_best"], dict((i, w) for i, w, _ in calls)[3])


def test_snapshot_arms_at_half_and_keeps_the_best(sgv1):
    """tpugan's snapshot properties at lr 2.0 over 30 iterations on the
    port alone: armed at 15, never before; the recorded loss is the
    history's at that iteration; no improvement before the arm, and each
    after it 5% below the running minimum; the snapshot's w scores no worse
    than the final w."""
    encode, resynth, encoder = sgv1.port(torch.float32, optimize_e=False)
    cfg = EmbeddingConfig(iterations=30, chunk=10, lr=2.0, optimize_e=False)
    result = make_embedder(encode, resynth, encoder, cfg)(torch.from_numpy(sgv1.target))
    msiv, improved = result.msiv_history.numpy(), result.improved_history.numpy()
    it_b = int(result.iter_best)
    assert msiv.shape == (30,) and it_b >= 15
    assert float(result.loss_best) == msiv[it_b]
    assert not improved[:16].any()
    running = msiv[15]
    for it in range(16, 30):
        assert improved[it] == (running > msiv[it] * 1.05)
        running = msiv[it] if improved[it] else running

    target = torch.from_numpy(sgv1.target)

    def score(w):
        with torch.no_grad():
            imgs2 = resynth(w)
            l_imgs, _ = space_loss(target, imgs2)
            (a1, a2), (b1, b2) = attention_crops(target), attention_crops(imgs2)
            return float(l_imgs + 0.125 * space_loss(a1, b1)[0] + 0.125 * space_loss(a2, b2)[0])

    assert score(result.w_best) <= score(result.w) * (1 + 1e-6)


def test_callback_cadence_runs_exactly_the_iterations(sgv1):
    """7 iterations in chunks of 5: a remainder chunk, not a round-up; the
    callback at 0, 5 and 7 with w and its reconstruction."""
    encode, resynth, encoder = sgv1.port(torch.float32, optimize_e=False)
    calls = []

    def cb(iteration, w, imgs2):
        assert w.shape == (1, 2 * LAYERS, LATENT) and imgs2.shape == sgv1.target.shape
        calls.append(iteration)

    cfg = EmbeddingConfig(iterations=7, chunk=5, optimize_e=False)
    result = make_embedder(encode, resynth, encoder, cfg)(torch.from_numpy(sgv1.target), cb)
    assert calls == [0, 5, 7] and result.msiv_history.shape == (7,) and len(result.losses) == 2


@pytest.mark.parametrize("mode", MODES)
def test_lpips_cache_is_bitwise_the_uncached_run(mode):
    """The target side's LPIPS features, computed once a batch, give the
    run an LPIPS closure without ``features`` gives, bit for bit (at 32 px:
    the AT2 crop of 16 px pools to nothing in VGG16)."""
    torch.manual_seed(0)
    kw = dict(startf=8, maxf=32, layer_count=4, latent_size=LATENT)
    gen, enc = StyleGANv1Generator(**kw).requires_grad_(False), Encoder(**kw)
    fn = random_lpips_fn("cpu")
    target = torch.tanh(torch.randn(1, 32, 32, 3))

    def run(lpips):
        def encode(imgs):
            const, w = enc(nchw_t(imgs))
            return const.permute(0, 2, 3, 1), w

        cfg = EmbeddingConfig(iterations=3, chunk=2, optimize_e=MODES[mode])
        return make_embedder(encode, lambda w: gen(w).permute(0, 2, 3, 1), enc, cfg, lpips_fn=lpips)(target)

    cached, uncached = run(fn), run(lambda a, b, a_feats=None: fn(a, b))
    assert float(cached.msiv_history[0]) > 0
    for a, b in zip(cached, uncached):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    assert all(torch.equal(x, y) for pa, pb in zip(cached.losses, uncached.losses) for x, y in zip(pa, pb))


def test_bf16_finetune_e_tracks_tpugan(sgv1):
    """bf16 fine-tuning E (the frozen G a bf16 copy, the encoder computing in
    bf16 from fp32 masters): one iteration, w, the losses and the images no
    farther from tpugan's fp32 run than twice tpugan's bf16 run is."""
    cfg = dict(iterations=1, chunk=1, optimize_e=True)  # the fp32 run of the test above
    j32, _ = _jax_run(sgv1, np.float32, **cfg)
    j16, _ = _jax_run(sgv1, np.float32, bf16=True, **cfg)
    p16, _, encoder = _port_run(sgv1, torch.float32, bf16=True, **cfg)
    assert all(p.dtype == torch.float32 for p in encoder.parameters())
    for key in ("w", "msiv", "images"):
        assert_as_close_as_tpugan(p16[key], j16[key], j32[key], key)


# ---------------------------------------------------------------------------
# editing, image reading, the baseline's Adam


def test_edit_latent_matches_tpugan(rng, tmp_path):
    w = rng.randn(2, 6, 8).astype(np.float32)
    d = rng.randn(1, 8).astype(np.float32)
    np.save(tmp_path / "d.npy", d)
    got = edit_latent(torch.from_numpy(w), load_direction(tmp_path / "d.npy"), 2.0, 1, 3)
    want = jedit_latent(jnp.asarray(w), jnp.asarray(d.reshape(-1)), 2.0, 1, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[:, 0].numpy(), w[:, 0])


@pytest.mark.parametrize("size", [None, 12])
def test_load_image_dir_is_tpugans(rng, tmp_path, size):
    """PNGs and a JPEG the test writes, unsorted names, another file
    beside them: the same [N, H, W, 3] in [0, 1], bit for bit."""
    for name in ("b.png", "a.png", "c.jpg"):
        Image.fromarray((rng.rand(20, 20, 3) * 255).astype(np.uint8)).save(tmp_path / name)
    (tmp_path / "notes.txt").write_text("not an image")
    got = load_image_dir(str(tmp_path), size)
    want = jload_image_dir(str(tmp_path), size)
    assert got.shape == (3, size or 20, size or 20, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError):
        load_image_dir(str(tmp_path / "empty"))


def test_baseline_adam_matches_optax(rng):
    """baseline_i2s's Adam against optax.adam, tpugan's: five updates of a
    w on gradients drawn here, in float64 (the same update up to float64's
    rounding)."""
    w0 = rng.randn(1, 4, 8)
    grads = [rng.randn(1, 4, 8) * 10.0 ** rng.randint(-6, 2) for _ in range(5)]
    with jax.enable_x64(True):
        opt = optax.adam(0.01)
        jw, state = jnp.asarray(w0), opt.init(jnp.asarray(w0))
        for g in grads:
            updates, state = opt.update(jnp.asarray(g), state, jw)
            jw = optax.apply_updates(jw, updates)
        jw = np.asarray(jw)
    w = torch.from_numpy(w0.copy()).requires_grad_(True)
    adam = baseline_i2s.adam(w, 0.01)
    for g in grads:
        w.grad = torch.from_numpy(g)
        adam.step()
    assert jw.dtype == np.float64
    np.testing.assert_allclose(w.detach().numpy(), jw, rtol=1e-12, atol=1e-14)


# ---------------------------------------------------------------------------
# the CLIs on the CPU


def _images(tmp_path, n=2, size=36):
    d = tmp_path / "imgs"
    d.mkdir()
    rng = np.random.RandomState(3)
    for i in range(n):
        Image.fromarray((rng.rand(size, size, 3) * 255).astype(np.uint8)).save(d / f"{i}.png")
    return str(d)


def _cli_args(mtype, tmp_path, *extra):
    return ["--mtype", str(mtype), "--img_size", "32", "--start_features", "64", "--random_init",
            "--device", "cpu", *extra]


@pytest.mark.parametrize("extra", [(), ("--optimizeE", "false"), ("--bf16",)],
                         ids=["finetune_e", "optimize_w", "bf16"])
def test_embedding_cli_writes_its_files(tmp_path, extra):
    """``embedding`` at 32 px on the CPU (StyleGANv1, 8 style layers), 3
    iterations (chunk 100: the callback at 0 and 3; the snapshot armed at
    1): every file tpugan's writes, and no kernel launch."""
    cuda.reset_launches()
    out = tmp_path / "out"
    embedding.main(_cli_args(1, tmp_path, "--img_dir", _images(tmp_path), "--iterations", "3",
                             "--experiment_dir", str(out), *extra))
    models = out / "models"
    for g in range(2):
        for name in (f"id{g}-i0-w0.npy", f"id{g}-i0-img0.npy", f"id{g}-i0-w3.npy",
                     f"id{g}-i0-img3.npy", f"id{g}-i0-w.npy"):
            assert (models / name).exists(), name
        assert np.load(models / f"id{g}-i0-w.npy").shape == (8, 512)
        assert (out / "imgs" / f"{g:05d}_rec.png").exists()
        assert (out / "imgs" / f"id{g}_ep0.jpg").exists() and (out / "imgs" / f"id{g}_ep3.jpg").exists()
        assert len(list(models.glob(f"id{g}-iter*-imgLoss-min*.npy"))) == 1
        assert len(list((out / "imgs").glob(f"id{g}_ep*-imgLoss-min*.jpg"))) == 1
    assert np.load(models / "w_all.npy").shape == (2, 8, 512)
    assert np.load(models / "img_all.npy").shape == (2, 32, 32, 3)
    assert not any(cuda.launches.values())


def test_rec_real_img_and_edit_clis(tmp_path):
    """``rec_real_img`` writes each real/reconstructed pair and w; ``edit``
    regenerates the w code with a direction added, and with bonus 0 gives
    the same image ``rec_real_img`` did (the same generator noise)."""
    out = tmp_path / "rec"
    rec_real_img.main(_cli_args(2, tmp_path, "--img_dir", _images(tmp_path), "--experiment_dir", str(out)))
    for g in range(2):
        assert (out / "imgs" / f"{g:05d}_real.png").exists() and (out / "imgs" / f"{g:05d}_rec.png").exists()
    w = np.load(out / "models" / "00000_w.npy")
    assert w.shape == (8, 512)
    np.save(tmp_path / "dir.npy", np.random.RandomState(0).randn(1, 512).astype(np.float32))
    torch.save(torch.from_numpy(w), tmp_path / "w.pt")
    for bonus, w_path, name in (("0", out / "models" / "00000_w.npy", "same.png"),
                                ("3", tmp_path / "w.pt", "edited.png")):
        edit.main(["--mtype", "2", "--img_size", "32", "--random_init", "--device", "cpu",
                   "--w_path", str(w_path), "--direction", str(tmp_path / "dir.npy"), "--bonus", bonus,
                   "--out", str(tmp_path / name)])
    same = np.asarray(Image.open(tmp_path / "same.png"))
    np.testing.assert_array_equal(same, np.asarray(Image.open(out / "imgs" / "00000_rec.png")))
    assert not np.array_equal(same, np.asarray(Image.open(tmp_path / "edited.png")))


class _NotATensor:
    """A pickled object that is not a w code."""


def test_edit_refuses_a_pickled_object(tmp_path):
    """``edit`` reads a ``.pt`` w code with torch's safe unpickler: a saved
    tensor loads, a ``.pt`` holding any other object is refused."""
    w = np.random.RandomState(0).randn(8, 512).astype(np.float32)
    torch.save(torch.from_numpy(w), tmp_path / "w.pt")
    np.testing.assert_array_equal(edit.load_w(str(tmp_path / "w.pt")), w)
    torch.save(_NotATensor(), tmp_path / "object.pt")
    with pytest.raises(pickle.UnpicklingError):
        edit.load_w(str(tmp_path / "object.pt"))


def test_baseline_i2s_cli(tmp_path):
    """One chunk of 100 iterations per image (``--iterations 50`` rounds up
    to one chunk, as tpugan's does); w from zeros [1, 8, 512]. StyleGANv1
    from w = 0 may go NaN, by the task's design (as in tpugan), so only the
    files are checked."""
    out = tmp_path / "i2s"
    baseline_i2s.main(_cli_args(1, tmp_path, "--img_dir", _images(tmp_path, n=1), "--iterations", "50",
                                "--experiment_dir", str(out)))
    assert np.load(out / "models" / "00000_w.npy").shape == (8, 512)
    assert (out / "imgs" / "00000_rec.png").exists()


@pytest.mark.parametrize("tool", [rec_real_img, edit, baseline_i2s])
def test_mtype4_raises_where_tpugan_raises(tool, tmp_path):
    """tpugan's rec_real_img, edit and baseline_i2s run BigGAN without a
    condition vector or a class label and fail; the port's refuse mtype 4."""
    argv = ["--mtype", "4", "--random_init", "--device", "cpu", "--img_dir", str(tmp_path)]
    if tool is edit:
        argv = ["--mtype", "4", "--random_init", "--device", "cpu", "--w_path", "w.npy", "--direction", "d.npy"]
    with pytest.raises(TypeError, match="mtype|BigGAN|E_BIG"):
        tool.main(argv)


def test_later_parts_raise(sgv1):
    """Grad-CAM attention (slice 6) runs now (tests/test_torch_gradcam.py);
    it needs its VGG16, and converted VGG16 weights wait for slice 7."""
    with pytest.raises(NotImplementedError, match="slice 7"):
        embedding.main(["--gradcam", "--vgg_weights", "vgg16.pth", "--mtype", "1", "--img_size", "32",
                        "--start_features", "64", "--random_init", "--device", "cpu"])
    encode, resynth, encoder = sgv1.port(torch.float32)
    with pytest.raises(ValueError, match="vgg"):
        make_embedder(encode, resynth, encoder, EmbeddingConfig(attention="gradcam"))
    with pytest.raises(NotImplementedError, match="parallelism"):
        make_embedder(encode, resynth, encoder, EmbeddingConfig(), mesh=object())
    with pytest.raises(NotImplementedError, match="parallelism"):
        make_embedder(encode, resynth, encoder, EmbeddingConfig(), spatial=True)
    with pytest.raises(NotImplementedError, match="slice 7"):
        embedding.main(["--lpips_weights", "x.pth", "--random_init", "--device", "cpu"])
