"""tpugan_torch's PGGAN discriminator (``models/pggan.py``) and the Pro-GAN
stack (``models/pggan_alt.py``) against tpugan (CPU).

tpugan's variables, every parameter and batch-norm statistic drawn at
random (its biases start at zero), go through the bridge; the images,
latents and labels are numpy draws handed to both. Tolerances, fixed before
any run: 1e-4 for a block, rtol 2e-3 / atol 2e-4 x max(1, max |ref|) for a
whole model (tests/test_stylegan1.py:134). Widths are small: PGGAN's
discriminator at 32 px with ``fmaps_base`` 512 (16 to 32 channels), the
Pro-GAN stack at 32 features.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugan.models import pggan as jpggan
from tpugan.models import pggan_alt as jalt
from tpugan_torch.io.bridge import load_variables
from tpugan_torch.models import pggan, pggan_alt

torch.set_num_threads(1)

BLOCK_TOL = dict(rtol=1e-4, atol=1e-4)
PG_KW = dict(resolution=32, fmaps_base=512, fmaps_max=32)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def nhwc(x):
    return x.detach().numpy().transpose(0, 2, 3, 1)


def drawn(variables, rng, scale=0.3):
    """numpy variables with every leaf drawn (biases non-zero), batch-norm
    variances positive."""
    out = {"params": jax.tree.map(lambda p: (rng.randn(*p.shape) * scale).astype(np.float32),
                                  jax.tree.map(np.asarray, dict(variables["params"])))}
    if "batch_stats" in variables:
        out["batch_stats"] = jax.tree.map(
            lambda p: (rng.rand(*p.shape) + 0.5).astype(np.float32), jax.tree.map(np.asarray, dict(variables["batch_stats"])))
    return out


def assert_model_close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=2e-3, atol=2e-4 * max(1.0, float(np.abs(ref).max())))


def images(rng, n, size):
    return np.tanh(rng.randn(n, size, size, 3)).astype(np.float32)


def port(module, jvars):
    return load_variables(module, jvars).eval().requires_grad_(False)


# ---------------------------------------------------------------------------
# PGGAN's discriminator


@pytest.mark.parametrize("kind", ["plain", "downsample", "fused", "minibatch_std", "head"])
def test_pgd_conv_block_matches_tpugan(rng, kind):
    kw = {"plain": {}, "downsample": dict(downsample=True), "fused": dict(downsample=True, fused_scale=True),
          "minibatch_std": dict(minibatch_std_group_size=4), "head": dict(kernel_size=1, padding=0)}[kind]
    cin, cout = (3, 8) if kind == "head" else (8, 12)
    x = rng.randn(6, 8, 8, cin).astype(np.float32)
    jblock = jpggan.PGDConvBlock(in_channels=cin, out_channels=cout, **kw)
    jvars = drawn(jblock.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    ref = jblock.apply(jvars, jnp.asarray(x))
    got = port(pggan.PGDConvBlock(cin, cout, **kw), jvars)(nchw(x))
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), **BLOCK_TOL)


@pytest.mark.parametrize("flatten", [True, False])
def test_pg_dense_matches_tpugan(rng, flatten):
    """The 4x4 feature map's dense layer: tpugan flattens NHWC, the port
    NCHW, and the bridge reorders the rows (a copy of the kernel as it is
    gives other scores)."""
    x = rng.randn(3, 4, 4, 6).astype(np.float32) if flatten else rng.randn(3, 10).astype(np.float32)
    jdense = jpggan.PGDense(7)
    jvars = drawn(jdense.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    ref = np.asarray(jdense.apply(jvars, jnp.asarray(x)))
    if flatten:
        dense = port(pggan.PGDense(96, 7, in_shape=(6, 4, 4)), jvars)
        got = dense(nchw(x))
        unordered = torch.nn.functional.linear(nchw(x).reshape(3, -1),
                                               torch.from_numpy(jvars["params"]["weight"].T) * dense.wscale,
                                               dense.bias)
        assert np.abs(torch.nn.functional.leaky_relu(unordered, 0.2).numpy() - ref).max() > 1e-2
    else:
        got = port(pggan.PGDense(10, 7), jvars)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref, **BLOCK_TOL)


def _discriminators(rng, **kw):
    jd = jpggan.PGGANDiscriminator(**PG_KW, **kw)
    jvars = drawn(jd.init(jax.random.PRNGKey(0), jnp.zeros((2, 32, 32, 3))), rng)
    return jd, jvars, port(pggan.PGGANDiscriminator(**PG_KW, **kw), jvars)


@pytest.mark.parametrize("lod", [0.0, 1.0, 0.5, 2.25, 3.0])
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_pggan_discriminator_matches_tpugan(rng, lod, fused):
    """Scores at whole and fractional lods (the FromRGB heads blended), a
    batch of 5 below the minibatch-std group of 16."""
    jd, jvars, d = _discriminators(rng, fused_scale=fused)
    x = images(rng, 5, 32)
    ref = jd.apply(jvars, jnp.asarray(x), lod)
    got = d(nchw(x), lod)
    assert got.shape == (5, 1)
    assert_model_close(got.numpy(), ref)


@pytest.mark.parametrize("batch,group", [(6, 4), (3, 16), (16, 16)])
def test_pggan_discriminator_minibatch_group(rng, batch, group):
    """The minibatch-std group wraps a batch that is not a multiple of it
    (6 in groups of 4) and shrinks to a batch below it, as tpugan's does;
    with labels the scores have 1 + label_size columns."""
    jd, jvars, d = _discriminators(rng, minibatch_std_group_size=group, label_size=2)
    x = images(rng, batch, 32)
    assert_model_close(d(nchw(x), 0.0).numpy(), jd.apply(jvars, jnp.asarray(x), 0.0))


def test_pggan_discriminator_refuses_a_lod_as_tpugan_does(rng):
    jd, jvars, d = _discriminators(rng)
    x = images(rng, 2, 32)
    with pytest.raises(ValueError, match="maximum lod is 3"):
        jd.apply(jvars, jnp.asarray(x), 3.5)
    with pytest.raises(ValueError, match="maximum lod is 3"):
        d(nchw(x), 3.5)


# ---------------------------------------------------------------------------
# the Pro-GAN stack


@pytest.mark.parametrize("kind", ["conv", "deconv"])
def test_equalized_layers_match_tpugan(rng, kind):
    """EqlConv (stride 2, pad 1) and EqlDeconv (stride 2, pad 1, the
    transposed conv's weight layout)."""
    x = rng.randn(2, 6, 6, 5).astype(np.float32)
    if kind == "conv":
        jl, pl = jalt.EqlConv(7, 3, stride=2, padding=1), pggan_alt.EqlConv(5, 7, 3, stride=2, padding=1)
    else:
        jl, pl = jalt.EqlDeconv(7, 4, stride=2, padding=1), pggan_alt.EqlDeconv(5, 7, 4, stride=2, padding=1)
    jvars = drawn(jl.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    np.testing.assert_allclose(nhwc(port(pl, jvars)(nchw(x))), np.asarray(jl.apply(jvars, jnp.asarray(x))),
                               **BLOCK_TOL)


def test_gen_initial_block_starts_from_a_1x1_latent(rng):
    z = rng.randn(3, 16).astype(np.float32)
    jb = jalt.GenInitialBlock(8)
    jvars = drawn(jb.init(jax.random.PRNGKey(0), jnp.asarray(z)), rng)
    got = port(pggan_alt.GenInitialBlock(16, 8), jvars)(torch.from_numpy(z))
    assert got.shape == (3, 8, 4, 4)
    np.testing.assert_allclose(nhwc(got), np.asarray(jb.apply(jvars, jnp.asarray(z))), **BLOCK_TOL)


@pytest.mark.parametrize("depth", [0, 1, 3])
@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0])
def test_progan_generator_matches_tpugan(rng, depth, alpha):
    jg = jalt.ProGANGenerator(depth=5, latent_size=32)
    z = rng.randn(2, 32).astype(np.float32)
    jvars = drawn(jg.init(jax.random.PRNGKey(0), jnp.asarray(z)), rng)
    got = port(pggan_alt.ProGANGenerator(depth=5, latent_size=32), jvars)(torch.from_numpy(z), depth, alpha)
    assert got.shape == (2, 3, 4 << depth, 4 << depth)
    assert_model_close(nhwc(got), jg.apply(jvars, jnp.asarray(z), depth=depth, alpha=alpha))


@pytest.mark.parametrize("height", [0, 2, 4])
@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0])
def test_progan_discriminator_matches_tpugan(rng, height, alpha):
    jd = jalt.ProGANDiscriminator(height=5, feature_size=32)
    x = images(rng, 3, 4 << height)
    jvars = drawn(jd.init(jax.random.PRNGKey(0), jnp.zeros((3, 64, 64, 3))), rng)
    got = port(pggan_alt.ProGANDiscriminator(height=5, feature_size=32), jvars)(nchw(x), height, alpha)
    assert got.shape == (3,)
    assert_model_close(got.numpy(), jd.apply(jvars, jnp.asarray(x), height=height, alpha=alpha))


@pytest.mark.parametrize("height", [0, 3])
def test_conditional_discriminator_renormalises_the_embedding(rng, height):
    """The projection discriminator with an embedding row above unit norm
    (renormalised in the forward) and rows below it (kept); the port's
    embedding weight is left as it was, as tpugan writes nothing back."""
    jd = jalt.ProGANDiscriminator(height=4, feature_size=32, conditional=True, num_classes=5)
    labels = np.array([1, 3, 3, 0])
    jvars = drawn(jd.init(jax.random.PRNGKey(0), jnp.zeros((4, 32, 32, 3)), labels=jnp.asarray(labels)), rng)
    table = jvars["params"]["final_block"]["label_embedder"]["embedding"]
    table[3] *= 4.0 / np.linalg.norm(table[3])
    table[1] *= 0.5 / np.linalg.norm(table[1])
    d = port(pggan_alt.ProGANDiscriminator(height=4, feature_size=32, conditional=True, num_classes=5), jvars)
    before = d.final_block.label_embedder.embedding.detach().clone()
    x = images(rng, 4, 4 << height)
    got = d(nchw(x), height, 1.0, labels=torch.from_numpy(labels))
    assert_model_close(got.numpy(), jd.apply(jvars, jnp.asarray(x), height=height, labels=jnp.asarray(labels)))
    assert torch.equal(d.final_block.label_embedder.embedding, before)
    rows = d.final_block.label_embedder(torch.tensor([1, 3]))
    np.testing.assert_allclose(torch.linalg.vector_norm(rows, dim=-1).numpy(), [0.5, 1.0], rtol=1e-6)


@pytest.mark.parametrize("depth,alpha", [(0, 1.0), (2, 0.5), (4, 1.0)])
def test_progan_encoder_matches_tpugan(rng, depth, alpha):
    je = jalt.ProGANEncoder(height=5, feature_size=32)
    x = images(rng, 2, 4 << depth)
    jvars = drawn(je.init(jax.random.PRNGKey(0), jnp.zeros((2, 64, 64, 3))), rng)
    got = port(pggan_alt.ProGANEncoder(height=5, feature_size=32), jvars)(nchw(x), depth, alpha)
    assert got.shape == (2, 32)
    assert_model_close(got.numpy(), je.apply(jvars, jnp.asarray(x), depth=depth, alpha=alpha))


def test_small_encoder_matches_tpugan(rng):
    """On its running batch-norm statistics (drawn), at 64 px."""
    je = jalt.SmallEncoder()
    x = images(rng, 2, 64)
    jvars = drawn(je.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    got = port(pggan_alt.SmallEncoder(img_size=64), jvars)(nchw(x))
    assert got.shape == (2, 512)
    assert_model_close(got.numpy(), je.apply(jvars, jnp.asarray(x)))


@pytest.mark.parametrize("name", ["generator", "discriminator", "encoder"])
def test_progan_refuses_a_level_beyond_its_ladder(rng, name):
    """A depth or height past the ladder raises in both packages (tpugan
    asserts; the port raises ValueError)."""
    module = {"generator": pggan_alt.ProGANGenerator(depth=3, latent_size=16),
              "discriminator": pggan_alt.ProGANDiscriminator(height=3, feature_size=16),
              "encoder": pggan_alt.ProGANEncoder(height=3, feature_size=16)}[name]
    jmodule = {"generator": jalt.ProGANGenerator(depth=3, latent_size=16),
               "discriminator": jalt.ProGANDiscriminator(height=3, feature_size=16),
               "encoder": jalt.ProGANEncoder(height=3, feature_size=16)}[name]
    arg = np.zeros((2, 16), np.float32) if name == "generator" else images(rng, 2, 16)
    jvars = jmodule.init(jax.random.PRNGKey(0), jnp.asarray(arg))
    with pytest.raises(AssertionError):
        jmodule.apply(jvars, jnp.asarray(arg), 3)
    with pytest.raises(ValueError, match="must be in"):
        module(torch.from_numpy(arg) if name == "generator" else nchw(arg), 3)
