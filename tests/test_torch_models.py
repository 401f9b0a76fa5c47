"""tpugan_torch StyleGANv1 mapping/generator and encoder vs tpugan (CPU).

Weights go through the bridge (``tpugan_torch.io.bridge``) with every param
randomised, noise weights, biases and ``const`` included, so the paths that
start at zero are exercised; noise is drawn once and handed to both sides.
Sizes are small because the JAX side runs on one CPU core.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugan.models.encoders import Encoder as JEncoder
from tpugan.models.encoders import EncoderBlock as JEncoderBlock
from tpugan.models.stylegan1 import DecodeBlock as JDecodeBlock
from tpugan.models.stylegan1 import StyleGANv1Generator as JGenerator
from tpugan.models.stylegan1 import StyleGANv1Mapping as JMapping
from tpugan.models.stylegan1 import truncation_coefs as jtruncation_coefs
from tpugan_torch.io.bridge import load_variables
from tpugan_torch.models import (
    DecodeBlock,
    Encoder,
    EncoderBlock,
    StyleGANv1Generator,
    StyleGANv1Mapping,
    truncation_coefs,
)
from tpugan_torch.ops import eq_lr

torch.set_num_threads(1)

# tests/test_stylegan1.py:134; the convs of both sides differ in summation order
MODEL_TOL = dict(rtol=2e-3, atol=2e-4)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def nhwc(x):
    return x.detach().numpy().transpose(0, 2, 3, 1)


def randomized(variables, rng):
    """numpy variables with every param drawn at random (as
    tests/test_stylegan1.py:106-110 does); other collections kept."""
    variables = jax.tree.map(np.asarray, variables)
    params = jax.tree.map(
        lambda p: (rng.randn(*p.shape) * 0.1).astype(np.float32), variables["params"]
    )
    return {**variables, "params": params}


def draw(shapes, rng):
    """Port noise (NCHW) and the same values for JAX (NHWC)."""
    port = [tuple(torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in blk) for blk in shapes]
    jax_noise = [tuple(jnp.asarray(nhwc(n)) for n in blk) for blk in port]
    return port, jax_noise


def test_truncation_coefs_match():
    np.testing.assert_array_equal(truncation_coefs(12, 0.7).numpy(), np.asarray(jtruncation_coefs(12, 0.7)))


@pytest.mark.parametrize("with_center", [False, True])
def test_mapping_matches(rng, with_center):
    kw = dict(num_layers=6, mapping_layers=3, latent_size=32, dlatent_size=24, mapping_fmaps=40)
    z = rng.randn(4, 32).astype(np.float32)
    center = rng.randn(6, 24).astype(np.float32) if with_center else None
    jm = JMapping(**kw)
    variables = randomized(jm.init(jax.random.PRNGKey(0), jnp.asarray(z)), rng)
    coefs = jtruncation_coefs(6, 0.7)
    ref = jm.apply(variables, jnp.asarray(z), coefs, None if center is None else jnp.asarray(center))
    port = load_variables(StyleGANv1Mapping(**kw), variables)
    got = port(torch.from_numpy(z), truncation_coefs(6, 0.7),
               None if center is None else torch.from_numpy(center))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **MODEL_TOL)


@pytest.mark.parametrize(
    "fused_scale,has_first_conv", [(True, True), (False, True), (False, False)]
)
def test_decode_block_matches(rng, fused_scale, has_first_conv):
    """The fused transposed conv runs in the generator only at 128^2 and up;
    here it is held against tpugan at an 8^2 input."""
    cin, c, latent, n = 12, 8, 16, 2
    res = 8
    out_res = 2 * res if has_first_conv else res
    if not has_first_conv:
        cin = c
    x = rng.randn(n, res, res, cin).astype(np.float32)
    s1, s2 = (rng.randn(n, latent).astype(np.float32) for _ in range(2))
    port_noise, jax_noise = draw([((n, 1, out_res, out_res),) * 2], rng)
    jb = JDecodeBlock(c, has_first_conv=has_first_conv, fused_scale=fused_scale)
    variables = randomized(
        jb.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(s1), jnp.asarray(s2), jax_noise[0]),
        rng,
    )
    ref = jb.apply(variables, jnp.asarray(x), jnp.asarray(s1), jnp.asarray(s2), jax_noise[0])
    port = load_variables(
        DecodeBlock(cin, c, latent, has_first_conv=has_first_conv, fused_scale=fused_scale),
        variables,
    )
    got = port(nchw(x), torch.from_numpy(s1), torch.from_numpy(s2), port_noise[0])
    assert nhwc(got).shape == ref.shape == (n, out_res, out_res, c)
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), **MODEL_TOL)


def test_generator_decode_matches(rng):
    kw = dict(startf=16, maxf=64, layer_count=3, latent_size=32)
    styles = rng.randn(2, 6, 32).astype(np.float32)
    jg = JGenerator(**kw)
    port = StyleGANv1Generator(**kw)
    port_noise, jax_noise = draw(port.noise_shapes(2), rng)
    variables = randomized(jg.init(jax.random.PRNGKey(1), jnp.asarray(styles), 2, 1.0, jax_noise), rng)
    ref = jg.apply(variables, jnp.asarray(styles), 2, 1.0, jax_noise)
    load_variables(port, variables, unused=("to_rgb_0", "to_rgb_1"))
    got = port(torch.from_numpy(styles), 2, port_noise)
    assert nhwc(got).shape == ref.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), **MODEL_TOL)
    # no noise on either side
    ref = jg.apply(variables, jnp.asarray(styles), 2, 1.0, None)
    np.testing.assert_allclose(nhwc(port(torch.from_numpy(styles), 2, None)), np.asarray(ref), **MODEL_TOL)


def test_generator_lreq_coefs_match_jax_collection():
    """The bridge's names and each layer's recorded coefficient agree with
    tpugan's ``lreq`` collection, parameter for parameter."""
    kw = dict(startf=16, maxf=64, layer_count=3, latent_size=32)
    styles = jnp.zeros((1, 6, 32))
    variables = JGenerator(**kw).init({"params": jax.random.PRNGKey(0)}, styles)
    want = {}

    def walk(tree, prefix):
        for key, value in tree.items():
            if isinstance(value, dict):
                walk(value, f"{prefix}{key}.")
            else:
                leaf = key[: -len("_coef")]
                want[prefix + ("weight" if leaf == "kernel" else leaf)] = float(value)

    walk(jax.tree.map(np.asarray, variables["lreq"]), "")
    got = eq_lr.lreq_coefs(StyleGANv1Generator(**kw))
    for name, coef in want.items():
        assert got[name] == pytest.approx(coef, rel=1e-6), name
    for name in set(got) - set(want):  # const, noise weights, block biases; unused lods
        assert got[name] == 1.0 or name.startswith(("to_rgb_0.", "to_rgb_1.")), name


@pytest.mark.parametrize(
    "fused_scale,use_blur,has_last_conv,cout",
    [(False, False, True, 12), (True, True, True, 12), (False, False, False, 8)],
)
def test_encoder_block_matches(rng, fused_scale, use_blur, has_last_conv, cout):
    cin, latent, n, res = 8, 16, 2, 8
    x = rng.randn(n, res, res, cin).astype(np.float32)
    r2 = res // 2 if fused_scale else res
    port_noise, jax_noise = draw([((n, 1, res, res), (n, 1, r2, r2))], rng)
    jb = JEncoderBlock(cin, cout, latent, has_last_conv=has_last_conv,
                       fused_scale=fused_scale, use_blur=use_blur)
    variables = randomized(jb.init(jax.random.PRNGKey(0), jnp.asarray(x), jax_noise[0]), rng)
    ref = jb.apply(variables, jnp.asarray(x), jax_noise[0])
    port = load_variables(
        EncoderBlock(cin, cout, latent, has_last_conv=has_last_conv,
                     fused_scale=fused_scale, use_blur=use_blur),
        variables,
    )
    got = port(nchw(x), port_noise[0])
    np.testing.assert_allclose(nhwc(got[0]), np.asarray(ref[0]), **MODEL_TOL)
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r), **MODEL_TOL)


@pytest.mark.parametrize("use_blur", [False, True])
def test_encoder_matches(rng, use_blur):
    """Case 1 (no blur) and case 2 (blur + fused downsampling convs): the
    4x4 features and the reversed (w2, w1) style stack."""
    kw = dict(startf=16, maxf=64, layer_count=3, latent_size=32, use_blur=use_blur)
    imgs = rng.randn(2, 16, 16, 3).astype(np.float32)
    port = Encoder(**kw)
    port_noise, jax_noise = draw(port.noise_shapes(2, 16), rng)
    je = JEncoder(**kw)
    variables = randomized(
        je.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(imgs), 0, jax_noise), rng
    )
    const_ref, w_ref = je.apply(variables, jnp.asarray(imgs), 0, jax_noise)
    load_variables(port, variables)
    const, w = port(nchw(imgs), port_noise)
    assert w.shape == w_ref.shape == (2, 6, 32)
    np.testing.assert_allclose(nhwc(const), np.asarray(const_ref), **MODEL_TOL)
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(w_ref), **MODEL_TOL)


def test_bridge_rejects_a_mismatched_tree(rng):
    kw = dict(startf=16, maxf=64, layer_count=3, latent_size=32)
    variables = randomized(
        JGenerator(**kw).init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 6, 32))), rng
    )
    unused = ("to_rgb_0", "to_rgb_1")
    with pytest.raises(KeyError, match="to_rgb_0"):
        load_variables(StyleGANv1Generator(**kw), variables)
    with pytest.raises(ValueError, match="shape"):
        load_variables(StyleGANv1Generator(**{**kw, "latent_size": 16}), variables, unused)
    with pytest.raises(KeyError, match="decode_block_3"):
        load_variables(StyleGANv1Generator(**{**kw, "layer_count": 4}), variables, unused)


def test_bridge_keeps_a_0d_leaf_0d():
    """A 0-d leaf (StyleGAN2's ``noise_strength``) loads with shape ()."""
    from tpugan.models.stylegan2 import ModulatedConv as JModulatedConv
    from tpugan_torch.models.stylegan2 import ModulatedConv

    x, w = jnp.zeros((1, 4, 4, 2)), jnp.zeros((1, 8))
    variables = jax.tree.map(np.asarray, JModulatedConv(2, 3, 4, w_space_dim=8).init(
        jax.random.PRNGKey(0), x, w))
    variables["params"]["noise_strength"] = np.float32(0.25).reshape(())
    port = load_variables(ModulatedConv(2, 3, 4, w_space_dim=8), variables)
    assert port.noise_strength.shape == ()
    assert port.noise_strength.item() == 0.25
