"""tpugan_torch BigGAN-deep, E_BIG and the mtype-4 serving request vs
tpugan (CPU).

Weights go through the bridge (``tpugan_torch.io.bridge``) with every param
randomised, ``gamma`` included, so the attention reaches the output; the
running means are random and the running variances positive; the spectral
norms' ``u`` and ``v`` are random unit vectors. Noise, latents and labels
are drawn once and handed to both sides. Sizes are small because the JAX
side runs on one CPU core.
"""

import argparse
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugan.cli import common as jcommon
from tpugan.models.biggan import BigGAN as JBigGAN
from tpugan.models.biggan import BigGANBatchNorm as JBatchNorm
from tpugan.models.biggan import BigGANConfig as JConfig
from tpugan.models.biggan import GenBlock as JGenBlock
from tpugan.models.biggan import SelfAttn as JSelfAttn
from tpugan.models.encoders import BigGANEncoder as JEncoder
from tpugan.models.encoders import BigGANEncoderBlock as JEncoderBlock
from tpugan.nn.spectral import SNDense as JSNDense
from tpugan.utils import one_hot as jone_hot
from tpugan_torch import utils
from tpugan_torch.cli import common, infer_e
from tpugan_torch.io.bridge import load_variables
from tpugan_torch.models import (
    BigGAN,
    BigGANBatchNorm,
    BigGANConfig,
    BigGANEncoder,
    BigGANEncoderBlock,
    GenBlock,
    SelfAttn,
)
from tpugan_torch.nn.spectral import SNDense
from tpugan_torch.ops import cuda

torch.set_num_threads(1)

LAYER_TOL = dict(rtol=1e-4, atol=1e-4)
# tests/test_stylegan1.py:134; the convs of both sides differ in summation order
MODEL_TOL = dict(rtol=2e-3, atol=2e-4)
# tests/test_biggan.py::tiny_config
TINY = dict(
    output_dim=16, z_dim=8, class_embed_dim=8, channel_width=4, num_classes=10,
    layers=[(False, 16, 16), (True, 16, 8), (False, 8, 4), (True, 4, 2), (False, 2, 1)],
    attention_layer_position=1, eps=1e-4, n_stats=51,
)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def nhwc(x):
    return x.detach().numpy().transpose(0, 2, 3, 1)


def unit(rng, n):
    u = rng.randn(n).astype(np.float32)
    return u / np.linalg.norm(u)


def randomized(variables, rng, scale=0.1):
    """numpy variables with every param drawn at random, random running
    means, positive running variances and random unit u and v."""
    variables = jax.tree.map(np.asarray, dict(variables))
    out = dict(variables)
    out["params"] = jax.tree.map(
        lambda p: (rng.randn(*p.shape) * scale).astype(np.float32), variables["params"]
    )
    if "buffers" in variables:
        out["buffers"] = jax.tree_util.tree_map_with_path(
            lambda path, b: (rng.randn(*b.shape) * 0.3 if path[-1].key == "running_means"
                             else rng.rand(*b.shape) + 0.5).astype(np.float32),
            variables["buffers"],
        )
    if "sn" in variables:
        out["sn"] = jax.tree.map(lambda u: unit(rng, u.shape[0]), variables["sn"])
    return out


def draw(shapes, rng):
    """Port noise (NCHW) and the same values for JAX (NHWC)."""
    port = [tuple(torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in blk) for blk in shapes]
    return port, [tuple(jnp.asarray(nhwc(n)) for n in blk) for blk in port]


def test_utils_match():
    labels = np.array([3, 0, 9])
    np.testing.assert_array_equal(utils.one_hot(torch.from_numpy(labels), 10).numpy(),
                                  np.asarray(jone_hot(jnp.asarray(labels), 10)))
    z = utils.truncated_noise_sample(64, 128, 0.4, generator=torch.Generator().manual_seed(5))
    again = utils.truncated_noise_sample(64, 128, 0.4, generator=torch.Generator().manual_seed(5))
    assert z.shape == (64, 128) and z.dtype == torch.float32
    torch.testing.assert_close(z, again, rtol=0, atol=0)
    assert float(z.abs().max()) <= 0.8 and 0.1 < float(z.std()) < 0.4  # 0.4 * N(0,1) on [-2, 2]


def test_config_matches():
    for res in (128, 256, 512):
        got = dataclasses.asdict(BigGANConfig.for_resolution(res, z_dim=8))
        assert got == dataclasses.asdict(JConfig.for_resolution(res, z_dim=8))
    cfg = BigGANConfig(**TINY)
    assert cfg.to_json_string() == JConfig(**TINY).to_json_string()
    with pytest.raises(ValueError):
        BigGANConfig.for_resolution(64)


def test_config_json_roundtrip(tmp_path):
    path = tmp_path / "config.json"
    path.write_text(JConfig(**TINY).to_json_string())
    assert dataclasses.asdict(BigGANConfig.from_json_file(path)) == dataclasses.asdict(
        JConfig.from_json_file(path))


@pytest.mark.parametrize("use_bias", [False, True])
def test_sndense_eval_matches(rng, use_bias):
    """The eval forward: sigma from the stored u and v, no power iteration."""
    x = rng.randn(3, 12).astype(np.float32)
    layer = JSNDense(7, use_bias=use_bias)
    variables = randomized(layer.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    ref = layer.apply(variables, jnp.asarray(x))
    port = load_variables(SNDense(12, 7, use_bias=use_bias), variables).eval()
    np.testing.assert_allclose(port(torch.from_numpy(x)).detach().numpy(), np.asarray(ref),
                               **LAYER_TOL)
    # the training forward reads the same stored pair; train steps advance it
    # with power_iterate (tests/test_torch_losses.py)
    torch.testing.assert_close(port.train()(torch.from_numpy(x)), port.eval()(torch.from_numpy(x)),
                               rtol=0, atol=0)


BN_FORMS = {
    "conditional": dict(conditional=True),
    "conditional_sn": dict(conditional=True, sn=True, eps=1e-12),
    "unconditional": dict(conditional=False),
}


@pytest.mark.parametrize("truncation", [0.4, 0.45])
@pytest.mark.parametrize("form", sorted(BN_FORMS))
def test_batchnorm_matches(rng, form, truncation):
    kw = BN_FORMS[form]
    x = rng.randn(2, 4, 4, 8).astype(np.float32)
    cv = rng.randn(2, 16).astype(np.float32)
    jbn = JBatchNorm(8, condition_vector_dim=16, n_stats=51, **kw)
    args = (jnp.asarray(x), truncation) + ((jnp.asarray(cv),) if kw["conditional"] else ())
    variables = randomized(jbn.init(jax.random.PRNGKey(0), *args), rng)
    ref = jbn.apply(variables, *args)
    port = load_variables(BigGANBatchNorm(8, 16, n_stats=51, **kw), variables).eval()
    got = port(nchw(x), truncation, torch.from_numpy(cv) if kw["conditional"] else None)
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), **LAYER_TOL)


def test_selfattn_matches_with_nonzero_gamma(rng):
    x = rng.randn(2, 8, 8, 16).astype(np.float32)
    jattn = JSelfAttn(16)
    variables = randomized(jattn.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng, scale=0.3)
    assert abs(float(variables["params"]["gamma"][0])) > 0.01
    ref = jattn.apply(variables, jnp.asarray(x))
    port = load_variables(SelfAttn(16), variables)
    got = port(nchw(x))
    assert np.abs(nhwc(got) - x).max() > 0.01  # the attention reaches the output
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), **MODEL_TOL)


@pytest.mark.parametrize("up_sample,out_size", [(True, 8), (False, 16)])
def test_genblock_matches(rng, up_sample, out_size):
    """With upsampling and the channel-drop residual, and without either."""
    x = rng.randn(2, 4, 4, 16).astype(np.float32)
    cv = rng.randn(2, 16).astype(np.float32)
    jblk = JGenBlock(16, out_size, 16, up_sample=up_sample, n_stats=51)
    variables = randomized(jblk.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(cv), 0.4), rng)
    ref = jblk.apply(variables, jnp.asarray(x), jnp.asarray(cv), 0.4)
    port = load_variables(GenBlock(16, out_size, 16, up_sample=up_sample, n_stats=51), variables)
    got = port(nchw(x), torch.from_numpy(cv), 0.4)
    assert nhwc(got).shape == ref.shape
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), **MODEL_TOL)


def test_biggan_matches(rng):
    """tests/test_biggan.py::tiny_config end to end: the SelfAttn takes a
    layer index, so the blocks after it are numbered one on."""
    cfg = JConfig(**TINY)
    z = rng.randn(2, cfg.z_dim).astype(np.float32)
    label = np.eye(cfg.num_classes, dtype=np.float32)[[3, 7]]
    jmodel = JBigGAN(cfg)
    variables = randomized(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(z), jnp.asarray(label), 0.4), rng)
    ref_img, ref_cond = jmodel.apply(variables, jnp.asarray(z), jnp.asarray(label), 0.4)
    port = load_variables(BigGAN(BigGANConfig(**TINY)), variables).eval()
    img, cond = port(torch.from_numpy(z), torch.from_numpy(label), 0.4)
    assert nhwc(img).shape == ref_img.shape == (2, 16, 16, 3)
    assert type(port.generator.layers_1) is SelfAttn
    np.testing.assert_allclose(cond.detach().numpy(), np.asarray(ref_cond), **MODEL_TOL)
    np.testing.assert_allclose(nhwc(img), np.asarray(ref_img), **MODEL_TOL)


@pytest.mark.parametrize("has_second_conv,cout", [(True, 16), (True, 8), (False, 8)])
def test_encoder_block_matches(rng, has_second_conv, cout):
    cin, n, res = 8, 2, 8
    x = rng.randn(n, res, res, cin).astype(np.float32)
    cv = rng.randn(n, 12).astype(np.float32)
    port_noise, jax_noise = draw([((n, 1, res, res),) * 2], rng)
    jblk = JEncoderBlock(cin, cout, cond_dim=12, has_second_conv=has_second_conv)
    args = (jnp.asarray(x), jnp.asarray(cv), jax_noise[0])
    variables = randomized(jblk.init(jax.random.PRNGKey(0), *args), rng)
    ref = jblk.apply(variables, *args)
    port = load_variables(
        BigGANEncoderBlock(cin, cout, 12, has_second_conv=has_second_conv), variables
    ).eval()
    got = port(nchw(x), torch.from_numpy(cv), port_noise[0])
    assert nhwc(got).shape == ref.shape
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), **MODEL_TOL)


def _encoder_case(rng, img_size=16):
    kw = dict(startf=8, maxf=32, layer_count=3, cond_dim=16, z_dim=8)
    imgs = rng.randn(2, img_size, img_size, 3).astype(np.float32)
    cv = rng.randn(2, 16).astype(np.float32)
    port = BigGANEncoder(**kw, img_size=img_size)
    port_noise, jax_noise = draw(port.noise_shapes(2, img_size), rng)
    je = JEncoder(**kw)
    variables = randomized(
        je.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(imgs), jnp.asarray(cv), jax_noise), rng
    )
    return je, port, variables, imgs, cv, port_noise, jax_noise


def test_biggan_encoder_matches(rng):
    je, port, variables, imgs, cv, port_noise, jax_noise = _encoder_case(rng)
    ref_c, ref_z = je.apply(variables, jnp.asarray(imgs), jnp.asarray(cv), jax_noise)
    load_variables(port, variables).eval()
    c_v, z = port(nchw(imgs), torch.from_numpy(cv), port_noise)
    assert c_v.shape == ref_c.shape == (2, 16) and z.shape == ref_z.shape == (2, 8)
    np.testing.assert_allclose(c_v.detach().numpy(), np.asarray(ref_c), **MODEL_TOL)
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(ref_z), **MODEL_TOL)


@pytest.mark.parametrize("collection,leaf", [("buffers", "running_vars"), ("sn", "v")])
def test_bridge_refuses_a_missing_buffer_or_sn_leaf(rng, collection, leaf):
    _, port, variables, *_ = _encoder_case(rng)
    node = variables[collection]["block_1"]["batch_norm_2"]
    del (node if collection == "buffers" else node["scale"])[leaf]
    with pytest.raises(KeyError, match=f"block_1.batch_norm_2.*{leaf}"):
        load_variables(port, variables)
    without = {k: v for k, v in variables.items() if k != collection}
    with pytest.raises(KeyError, match="buffers differ"):
        load_variables(port, without)


def _parse(parser_module, *argv):
    return parser_module.add_common_args(argparse.ArgumentParser(), training=True).parse_args(list(argv))


def _tiny_args(config, *extra):
    return ("--mtype", "4", "--img_size", "16", "--start_features", "8", "--random_init",
            "--config_dir", str(config), *extra)


def test_mtype4_request_matches_tpugan(rng, tmp_path):
    """The whole request, z -> BigGAN -> E_BIG -> BigGAN, against tpugan's own
    mtype-4 closures (tpugan/cli/common.py:251-307): tpugan draws zt and the
    label from its key; the port gets the same ones, and both encoders get
    the same noise."""
    config = tmp_path / "config.json"
    config.write_text(JConfig(**TINY).to_json_string())
    jb = jcommon.build_bundle(_parse(jcommon, *_tiny_args(config)))
    frozen = randomized(jb.frozen, rng)
    enc_vars = randomized(jb.enc_vars, rng)
    key = jax.random.PRNGKey(11)
    jbatch = jb.synth(frozen, key, jnp.zeros((2, jb.z_dim)))

    bundle = common.build_bundle(_parse(common, *_tiny_args(config, "--device", "cpu")))
    load_variables(bundle.generator, frozen)
    load_variables(bundle.encoder, enc_vars)
    port_noise, jax_noise = draw(bundle.encoder.noise_shapes(2, 16), rng)
    # tpugan's encode closure (train/e_align.py:134-153), with the noise given
    jc2, jw2 = jb.encoder.apply(enc_vars, jbatch.imgs1, jbatch.const1, jax_noise)
    jimgs2 = jb.resynth(frozen, jw2, jbatch, key)

    zt, label = (torch.from_numpy(np.array(a)) for a in (jbatch.w1, jbatch.label))
    assert float(zt.abs().max()) <= 0.8 and bool((label.sum(0) == 2).any())
    request = infer_e.Request(zt, None, port_noise, None, label)
    imgs1, imgs2 = infer_e.serve(bundle, request)
    batch = bundle.synth(zt, label)
    c2, w2 = bundle.encode(batch, port_noise)
    np.testing.assert_allclose(imgs1.numpy(), np.asarray(jbatch.imgs1), **MODEL_TOL)
    np.testing.assert_allclose(batch.const1.numpy(), np.asarray(jbatch.const1), **MODEL_TOL)
    np.testing.assert_allclose(c2.numpy(), np.asarray(jc2), **MODEL_TOL)
    np.testing.assert_allclose(w2.numpy(), np.asarray(jw2), **MODEL_TOL)
    np.testing.assert_allclose(imgs2.numpy(), np.asarray(jimgs2), **MODEL_TOL)


def test_mtype4_request_runs_on_cpu_without_a_launch_and_is_seeded(tmp_path):
    config = tmp_path / "config.json"
    config.write_text(BigGANConfig(**TINY).to_json_string())
    cuda.reset_launches()
    bundle = common.build_bundle(_parse(common, *_tiny_args(config, "--device", "cpu")))
    request = infer_e.draw_request(bundle, 2, 30000)
    assert request.noise_g is None and request.noise_g2 is None
    assert request.label.shape == (2, 10) and bool((request.label[0] == request.label[1]).all())
    imgs1, imgs2 = infer_e.serve(bundle, request)
    assert imgs1.shape == imgs2.shape == (2, 16, 16, 3)
    assert torch.isfinite(imgs1).all() and torch.isfinite(imgs2).all()
    assert not any(cuda.launches.values())
    again = infer_e.run(common.build_bundle(_parse(common, *_tiny_args(config, "--device", "cpu"))), 2, 0)
    torch.testing.assert_close(again[1], imgs2, rtol=0, atol=0)
    with pytest.raises(ValueError, match="no generator noise"):
        bundle.resynth(request.z, bundle.synth(request.z, request.label), request.noise_e)


def test_mtype4_bundle_is_the_zoo_layout_and_checks_the_size(tmp_path):
    """Without --config_dir the layout is for_resolution(--img_size, --z_dim)
    (checked on the module tree, not run); a config of another size is refused."""
    with torch.device("meta"):
        gen = BigGAN(BigGANConfig.for_resolution(256, z_dim=128))
        enc = BigGANEncoder(startf=64, maxf=512, layer_count=7, cond_dim=256, z_dim=128,
                            img_size=256)
    assert type(gen.generator.layers_8) is SelfAttn and gen.generator.num_layers == 13
    assert gen.generator.layers_8.snconv1x1_theta.weight.shape == (64, 512, 1, 1)
    assert enc.new_final_1.weight.shape == (256, 512 * 4 * 4)
    assert [s[0][2] for s in enc.noise_shapes(2, 256)] == [256, 128, 64, 32, 16, 8, 4]
    config = tmp_path / "config.json"
    config.write_text(BigGANConfig(**TINY).to_json_string())
    with pytest.raises(ValueError, match="--img_size"):
        common.build_bundle(_parse(common, "--mtype", "4", "--img_size", "32", "--start_features",
                                   "8", "--random_init", "--config_dir", str(config), "--device", "cpu"))


def test_mtype4_cli_writes_grids_on_cpu(tmp_path):
    config = tmp_path / "config.json"
    config.write_text(BigGANConfig(**TINY).to_json_string())
    infer_e.main([*_tiny_args(config), "--device", "cpu", "--count", "1",
                  "--experiment_dir", str(tmp_path / "out")])
    assert (tmp_path / "out" / "imgs" / "infer_seed30000.png").exists()


def test_truncation_picks_the_reference_stats():
    """At truncation 0.4 with 51 stats the interpolation resolves to index 20
    with coefficient 0, by the reference's own float arithmetic."""
    coef, start = math.modf(0.4 / (1.0 / 50))
    assert (coef, int(start)) == (0.0, 20)
    bn = BigGANBatchNorm(3, conditional=False)
    with torch.no_grad():
        bn.running_means.copy_(torch.arange(51.0)[:, None].expand(51, 3))
    got = bn(torch.zeros(1, 3, 1, 1), 0.4)
    torch.testing.assert_close(got.flatten(), torch.full((3,), -20.0) / math.sqrt(1 + 1e-4))
