"""tpugan_torch's StyleGAN2 (config F) and the mtype-2 request vs tpugan (CPU).

The same numpy-seeded inputs go through each ``tpugan/models/stylegan2.py``
module and its port after the weight bridge. Weights keep tpugan's own init
law; the leaves that start at zero (biases, ``noise_strength``, ``w_avg``)
are set to non-zero values, the same on both sides, so the paths they gate
(noise injection, the bias scaling, truncation towards w_avg) run. Sizes are
small because the JAX side runs on the CPU.

Tolerances: 1e-4 (abs and rel) for a module, the ROADMAP's bar for layers;
rtol 2e-3 / atol 2e-4 for a whole generator and the request
(``tests/test_stylegan1.py:134``): the convolutions of both sides sum in
different orders through up to eighteen layers.
"""

import argparse
from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugan.cli import common as jcommon
from tpugan.models import stylegan2 as J
from tpugan.train.e_align import make_encode_fn as jmake_encode_fn
from tpugan_torch.cli import common, infer_e
from tpugan_torch.io.bridge import load_variables
from tpugan_torch.models import stylegan2 as P
from tpugan_torch.ops import cuda, upfirdn

torch.set_num_threads(1)

LAYER_TOL = dict(rtol=1e-4, atol=1e-4)
MODEL_TOL = dict(rtol=2e-3, atol=2e-4)
ZERO_INIT = ("bias", "noise_strength", "w_avg")


def lively(variables, rng, scale=0.5):
    """tpugan's variables as numpy, with every zero-initialised leaf
    (``ZERO_INIT``) drawn from ``rng`` at ``scale``."""

    def walk(tree):
        return {
            key: walk(value) if isinstance(value, Mapping)
            else np.asarray(rng.randn(*np.shape(value)) * scale, np.float32) if key in ZERO_INIT
            else np.asarray(value)
            for key, value in tree.items()
        }

    return walk(variables)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def nhwc(x):
    return x.detach().numpy().transpose(0, 2, 3, 1)


def randn(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


@pytest.mark.parametrize("lr_mul,additional_bias,activation", [
    (1.0, 0.0, "lrelu"), (0.01, 0.0, "lrelu"), (1.0, 1.0, "linear"),
])
def test_dense_matches(rng, lr_mul, additional_bias, activation):
    x = randn(rng, 4, 3, 8)  # flattened to [4, 24] on both sides
    kw = dict(additional_bias=additional_bias, lr_mul=lr_mul, activation_type=activation)
    jm = J.SG2Dense(20, **kw)
    variables = lively(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    ref = jm.apply(variables, jnp.asarray(x))
    got = load_variables(P.SG2Dense(24, 20, **kw), variables)(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **LAYER_TOL)


def test_mapping_matches(rng):
    kw = dict(input_space_dim=32, hidden_space_dim=40, final_space_dim=24, num_layers=3)
    z = randn(rng, 4, 32)
    jm = J.SG2Mapping(**kw)
    variables = lively(jm.init(jax.random.PRNGKey(0), jnp.asarray(z)), rng)
    ref = jm.apply(variables, jnp.asarray(z))
    got = load_variables(P.SG2Mapping(**kw), variables)(torch.from_numpy(z))
    for key in ("z", "w"):
        np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(ref[key]), **LAYER_TOL)
    with pytest.raises(ValueError, match="latent code"):
        P.SG2Mapping(**kw)(torch.zeros(4, 31))


@pytest.mark.parametrize("repeat_w,w_ndim,psi,layers", [
    (True, 2, 0.7, 4), (True, 3, 0.5, 6), (False, 2, 0.7, 3), (True, 2, None, None),
])
def test_truncation_matches(rng, repeat_w, w_ndim, psi, layers):
    num_layers, dim = 6, 8
    shape = {2: (3, dim if repeat_w else num_layers * dim), 3: (3, num_layers, dim)}[w_ndim]
    w = randn(rng, *shape)
    jm = J.SG2Truncation(dim, num_layers, repeat_w)
    variables = lively(jm.init(jax.random.PRNGKey(0), jnp.asarray(w)), rng)
    ref = jm.apply(variables, jnp.asarray(w), psi, layers)
    got = load_variables(P.SG2Truncation(dim, num_layers, repeat_w), variables)(
        torch.from_numpy(w), psi, layers)
    assert got.shape == ref.shape == (3, num_layers, dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **LAYER_TOL)


def test_update_w_avg_matches(rng):
    w_avg, w = randn(rng, 16), randn(rng, 5, 16)
    ref = J.update_w_avg(jnp.asarray(w_avg), jnp.asarray(w), 0.9)
    got = P.update_w_avg(torch.from_numpy(w_avg), torch.from_numpy(w), 0.9)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **LAYER_TOL)
    with pytest.raises(NotImplementedError, match="slice 7"):
        P.update_w_avg(torch.from_numpy(w_avg), torch.from_numpy(w), axis_name="data")


# (in, out, kernel size, scale factor, demodulate, noise: "buffer" | "explicit" | None)
MODULATED_CASES = [
    (8, 12, 3, 1, True, "buffer"),
    (8, 12, 3, 1, False, "explicit"),
    (8, 12, 3, 2, True, "buffer"),
    (8, 12, 3, 2, True, "explicit"),
    (8, 12, 3, 2, False, "buffer"),
    (12, 3, 1, 1, False, None),  # a ToRGB layer: 1x1, linear, no noise
]


@pytest.mark.parametrize("cin,cout,k,scale,demod,noise", MODULATED_CASES)
def test_modulated_conv_matches(rng, cin, cout, k, scale, demod, noise):
    n, res_in, wdim = 2, 6, 16
    res = res_in * scale
    x, w = randn(rng, n, res_in, res_in, cin), randn(rng, n, wdim)
    kw = dict(w_space_dim=wdim, kernel_size=k, scale_factor=scale, demodulate=demod,
              add_noise=noise is not None)
    if noise is None:
        kw["activation_type"] = "linear"
    jm = J.ModulatedConv(cin, cout, res, **kw)
    variables = lively(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(w)), rng)
    explicit = randn(rng, n, res, res, 1) if noise == "explicit" else None
    ref, ref_style = jm.apply(variables, jnp.asarray(x), jnp.asarray(w),
                              noise=None if explicit is None else jnp.asarray(explicit))
    port = load_variables(P.ModulatedConv(cin, cout, res, **kw), variables)
    got, style = port(nchw(x), torch.from_numpy(w), noise=None if explicit is None else nchw(explicit))
    assert nhwc(got).shape == ref.shape == (n, res, res, cout)
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), **LAYER_TOL)
    np.testing.assert_allclose(style.detach().numpy(), np.asarray(ref_style), **LAYER_TOL)
    if noise is not None:  # the noise moved the output
        assert float(np.abs(variables["params"]["noise_strength"])) > 0
        quiet = port(nchw(x), torch.from_numpy(w), noise=torch.zeros(n, 1, res, res))[0]
        assert (quiet - got).abs().max() > 1e-3


def test_modulated_conv_randomized_noise_draws_from_the_generator(rng):
    """tpugan's ``randomize_noise`` draws from its ``noise`` rng, which torch
    cannot reproduce; the port's draws from the generator it is given, one
    [N, 1, r, r] normal, and otherwise reads the buffer."""
    port = P.ModulatedConv(4, 6, 8, w_space_dim=8)
    with torch.no_grad():
        port.noise_strength.fill_(0.7)
    x, w = torch.from_numpy(randn(rng, 2, 4, 8, 8)), torch.from_numpy(randn(rng, 2, 8))
    drawn = port(x, w, randomize_noise=torch.Generator().manual_seed(5))[0]
    noise = torch.randn(2, 1, 8, 8, generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(drawn, port(x, w, noise=noise)[0], rtol=0, atol=0)
    torch.testing.assert_close(port(x, w)[0], port(x, w, noise=port.noise)[0], rtol=0, atol=0)
    assert (drawn - port(x, w)[0]).abs().max() > 1e-3


@pytest.mark.parametrize("k,scale,add_bias,activation", [
    (3, 1, True, "lrelu"), (1, 2, False, "linear"), (3, 2, True, "lrelu"),
])
def test_conv_block_matches(rng, k, scale, add_bias, activation):
    x = randn(rng, 2, 5, 5, 6)
    kw = dict(kernel_size=k, add_bias=add_bias, scale_factor=scale, activation_type=activation)
    jm = J.SG2ConvBlock(6, 10, **kw)
    variables = lively(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    ref = jm.apply(variables, jnp.asarray(x))
    got = load_variables(P.SG2ConvBlock(6, 10, **kw), variables)(nchw(x))
    assert nhwc(got).shape == ref.shape == (2, 5 * scale, 5 * scale, 10)
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), **LAYER_TOL)


GEN_KW = dict(resolution=32, z_space_dim=32, w_space_dim=32, mapping_layers=3, mapping_fmaps=32,
              fmaps_base=512, fmaps_max=64)


@pytest.mark.parametrize("architecture", ["skip", "origin", "resnet"])
def test_generator_matches(rng, architecture):
    """z -> mapping -> truncation (psi 0.7, 4 layers, towards a non-zero
    w_avg) -> synthesis at 32 px, every style and the image; then the
    synthesis alone on another wp."""
    kw = dict(GEN_KW, architecture=architecture)
    z = randn(rng, 2, 32)
    jg = J.StyleGAN2Generator(**kw)
    variables = lively(jg.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(z)), rng)
    ref = jg.apply(variables, jnp.asarray(z), trunc_psi=0.7, trunc_layers=4)
    port = load_variables(P.StyleGAN2Generator(**kw), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(z), trunc_psi=0.7, trunc_layers=4)
    assert set(got) == set(ref) - {"label"}
    assert nhwc(got["image"]).shape == ref["image"].shape == (2, 32, 32, 3)
    np.testing.assert_allclose(nhwc(got["image"]), np.asarray(ref["image"]), **MODEL_TOL)
    for key in set(got) - {"image"}:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), **MODEL_TOL, err_msg=key)
    wp = randn(rng, 2, port.num_layers, 32)
    ref = jg.apply(variables, jnp.asarray(wp), method=jg.synthesize)["image"]
    with torch.no_grad():
        got = port.synthesize(torch.from_numpy(wp))["image"]
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), **MODEL_TOL)


class _RecordedNoise:
    """Stands in for tpugan's encoder inside its encode closure and applies
    it with recorded noise in place of the rng draw."""

    def __init__(self, module, noise):
        self.module, self.noise = module, noise

    def apply(self, variables, imgs, rngs=None):
        return self.module.apply(variables, imgs, 0, self.noise)


def _args(*extra):
    parser = common.add_common_args(argparse.ArgumentParser(), training=True)
    return parser.parse_args(
        ["--mtype", "2", "--img_size", "32", "--start_features", "64", "--random_init", *extra]
    )


def test_request_matches_tpugan_bundle(rng):
    """``infer_e --mtype 2 --img_size 32 --start_features 64 --random_init``:
    the port's request against tpugan's own bundle closures (full width: 512
    channels at 4-32 px) on the same z and encoder noise, tpugan's weights
    copied through the bridge."""
    args = _args("--device", "cpu")
    jbundle = jcommon.build_bundle(args)
    frozen = lively(jbundle.frozen, rng, scale=0.1)
    enc_vars = jax.tree.map(np.asarray, jbundle.enc_vars)
    bundle = common.build_bundle(args)
    load_variables(bundle.generator, frozen)
    load_variables(bundle.encoder, enc_vars)

    request = infer_e.draw_request(bundle, 2, 30000)
    noise_j = [tuple(jnp.asarray(nhwc(n)) for n in block) for block in request.noise_e]
    key = jax.random.PRNGKey(0)
    jbatch = jbundle.synth(frozen, key, jnp.asarray(request.z.numpy()))
    encode = jmake_encode_fn(_RecordedNoise(jbundle.encoder, noise_j), {})
    jconst2, jw2 = encode(enc_vars["params"], jbatch, key)
    jimgs2 = jbundle.resynth(frozen, jw2, jbatch, key)

    batch = bundle.synth(request.z)
    const2, w2 = bundle.encode(batch, request.noise_e)
    imgs2 = bundle.resynth(w2, batch)
    assert batch.imgs1.shape == imgs2.shape == jimgs2.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(batch.w1.numpy(), np.asarray(jbatch.w1), **MODEL_TOL)
    np.testing.assert_allclose(batch.imgs1.numpy(), np.asarray(jbatch.imgs1), **MODEL_TOL)
    np.testing.assert_allclose(nhwc(batch.const1), np.asarray(jbatch.const1), **MODEL_TOL)
    np.testing.assert_allclose(nhwc(const2), np.asarray(jconst2), **MODEL_TOL)
    np.testing.assert_allclose(w2.numpy(), np.asarray(jw2), **MODEL_TOL)
    np.testing.assert_allclose(imgs2.numpy(), np.asarray(jimgs2), **MODEL_TOL)
    with pytest.raises(ValueError, match="noise buffers"):
        bundle.synth(request.z, request.noise_e)


def test_request_runs_on_cpu_without_a_launch_and_is_seeded():
    cuda.reset_launches()
    upfirdn.reset_layout_launches()
    bundle = common.build_bundle(_args("--device", "cpu"))
    assert bundle.num_style_layers == bundle.generator.num_layers == 8
    imgs1, imgs2 = infer_e.run(bundle, 2, 30000)
    assert imgs1.shape == imgs2.shape == (2, 32, 32, 3)
    assert torch.isfinite(imgs1).all() and torch.isfinite(imgs2).all()
    assert not any(cuda.launches.values()) and not any(upfirdn.layout_launches.values())
    again = infer_e.run(common.build_bundle(_args("--device", "cpu")), 2, 0)  # 30000 % 30000
    torch.testing.assert_close(again[1], imgs2, rtol=0, atol=0)


def test_cli_writes_grids_on_cpu(tmp_path):
    infer_e.main(["--mtype", "2", "--img_size", "32", "--start_features", "64", "--random_init",
                  "--device", "cpu", "--count", "1", "--experiment_dir", str(tmp_path)])
    assert (tmp_path / "imgs" / "infer_seed30000.png").exists()


def test_cli_needs_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        infer_e.main(["--mtype", "2", "--img_size", "32", "--start_features", "64",
                      "--random_init", "--experiment_dir", str(tmp_path)])


def test_converted_checkpoints_stay_refused():
    parser = common.add_common_args(argparse.ArgumentParser(), training=True)
    args = parser.parse_args(["--mtype", "2", "--img_size", "32", "--checkpoint_dir_GAN", "g.pth",
                              "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="slice 7"):
        common.build_bundle(args)
