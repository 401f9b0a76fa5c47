"""tpugan_torch's random init vs tpugan's (CPU), for the mtype-4 models.

``--random_init`` has to give the port the weights' distributions that
tpugan's flax init gives, leaf by leaf, since the two draw from different
generators and cannot give the same numbers. The last two tests follow one
consequence on both sides: E_BIG's z from a random init is far wider than
the truncated z BigGAN was sampled with, and BigGAN's conditional batch
norms overflow fp32 on such a z. Run with ``-s`` to see the numbers.
"""

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from tpugan.cli import common as jcommon
from tpugan.models.biggan import BigGAN as JBigGAN
from tpugan.models.biggan import BigGANConfig as JConfig
from tpugan.models.encoders import BigGANEncoder as JEncoder
from tpugan_torch.cli import common
from tpugan_torch.io.bridge import load_variables
from tpugan_torch.models import BigGAN, BigGANConfig, BigGANEncoder
from tpugan_torch.nn.spectral import SNDense

torch.set_num_threads(1)

# tests/test_biggan.py::tiny_config
TINY = dict(
    output_dim=16, z_dim=8, class_embed_dim=8, channel_width=4, num_classes=10,
    layers=[(False, 16, 16), (True, 16, 8), (False, 8, 4), (True, 4, 2), (False, 2, 1)],
    attention_layer_position=1, eps=1e-4, n_stats=51,
)
# a two-sample Kolmogorov-Smirnov p-value below this says two leaves were
# drawn from different laws; both inits are seeded, so the test is fixed
KS_P_MIN = 1e-3
TRUNCATION = 0.4


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """The port's mtype-4 bundle with its own init, and a second one that
    holds tpugan's ``build_bundle`` init, carried over through the bridge."""
    config = tmp_path_factory.mktemp("init") / "config.json"
    config.write_text(JConfig(**TINY).to_json_string())
    argv = ["--mtype", "4", "--img_size", "16", "--start_features", "8", "--random_init",
            "--config_dir", str(config)]

    def parse(module, *extra):
        parser = module.add_common_args(argparse.ArgumentParser(), training=True)
        return parser.parse_args(argv + list(extra))

    jb = jcommon.build_bundle(parse(jcommon))
    own = common.build_bundle(parse(common, "--device", "cpu"))
    theirs = common.build_bundle(parse(common, "--device", "cpu", "--seed", "1"))
    load_variables(theirs.generator, jax.tree.map(np.asarray, jb.frozen))
    load_variables(theirs.encoder, jax.tree.map(np.asarray, jb.enc_vars))
    return own, theirs


@pytest.mark.parametrize("part", ["generator", "encoder"])
def test_init_law_matches_tpugan(bundles, part):
    """Every parameter and buffer: a constant leaf (zero biases, noise
    weights and gammas, the unconditional norm's unit gains, running means
    0 and variances 1) has tpugan's
    constant; a random leaf (lecun-normal and equalized-lr kernels, the
    spectral norms' u and v) passes a two-sample KS test against tpugan's;
    and each spectral norm's v is normalize(W^T u), as flax makes it."""
    own, theirs = (getattr(b, part) for b in bundles)
    ref = dict(theirs.state_dict())
    random_leaves = 0
    for name, value in own.state_dict().items():
        got, want = value.numpy().ravel(), ref[name].numpy().ravel()
        if np.all(want == want[0]):
            np.testing.assert_array_equal(got, want, err_msg=name)
            continue
        random_leaves += 1
        p = stats.ks_2samp(got, want).pvalue
        assert p > KS_P_MIN, (
            f"{name}: std {got.std():.4g} vs tpugan's {want.std():.4g}, KS p {p:.2e}")
    assert random_leaves > 20
    for model in (own, theirs):
        for name, m in model.named_modules():
            if isinstance(m, SNDense):
                v = m.weight.detach().t() @ m.u
                torch.testing.assert_close(m.v, v / v.norm(), msg=name)
                torch.testing.assert_close(m.u.norm(), torch.tensor(1.0), msg=name)


def _cond(rng, n, z_dim=128, num_classes=1000):
    """A condition vector as BigGAN makes one: truncated z and a class
    embedding (a one-hot row of a lecun-normal [classes, z_dim] matrix)."""
    zt = stats.truncnorm.rvs(-2, 2, size=(n, z_dim), random_state=rng) * TRUNCATION
    embed = rng.randn(n, z_dim) / np.sqrt(num_classes)
    return np.concatenate([zt, embed], axis=1).astype(np.float32)


def test_e_big_z_spread_matches_tpugan(rng):
    """E_BIG-256's blocks (startf 64, maxf 512, 7 blocks, cond 256, z 128)
    on 128-pixel images, the image cut so that this runs on the CPU: the
    std of z from four random inits on each side (tpugan's own flax init,
    as build_bundle makes it, and the port's), for the same images and
    condition vectors. Both are far wider than the truncated z's."""
    img, kw = 128, dict(startf=64, maxf=512, layer_count=7, cond_dim=256, z_dim=128)
    imgs = rng.uniform(-1, 1, (2, img, img, 3)).astype(np.float32)
    cond = _cond(rng, 2)
    je = JEncoder(**kw)
    init = jax.jit(lambda key: je.init({"params": key, "noise": key}, jnp.zeros((1, img, img, 3)),
                                       jnp.zeros((1, 256))))
    apply = jax.jit(lambda v: je.apply(v, jnp.asarray(imgs), jnp.asarray(cond))[1])
    theirs = [float(apply(init(jax.random.PRNGKey(s))).std()) for s in range(4)]
    x = torch.from_numpy(imgs.transpose(0, 3, 1, 2).copy())
    own = []
    for s in range(4):
        enc = BigGANEncoder(**kw, img_size=img, generator=torch.Generator().manual_seed(s)).eval()
        with torch.no_grad():
            own.append(float(enc(x, torch.from_numpy(cond))[1].std()))
    zt_std = float(cond[:, :128].std())
    print(f"\nE_BIG z std at {img}px, 4 inits each: tpugan {np.round(theirs, 4).tolist()}, "
          f"port {np.round(own, 4).tolist()}; truncated z std {zt_std:.4f}")
    ratio = np.mean(own) / np.mean(theirs)
    assert 2 / 3 < ratio < 3 / 2, ratio
    assert min(own + theirs) > 5 * zt_std


def test_biggan256_overflows_on_a_wide_z_in_tpugan_too(rng):
    """BigGAN-deep-256's layout (12 GenBlocks, SelfAttn at 64x64, 1000
    classes) at channel_width 4 instead of 128 so that it runs on the CPU,
    each side with its own random init: on z with the truncated spread both
    give finite images; on z with the spread a random E_BIG-256 returns on
    the card (std 9.43 against 0.36) both overflow fp32 and give NaN on
    about half the pixels."""
    cfg = dict(dataclasses.asdict(JConfig.for_resolution(256, z_dim=128)), channel_width=4)
    jmodel = JBigGAN(JConfig(**cfg))
    port = BigGAN(BigGANConfig(**cfg), generator=torch.Generator().manual_seed(0)).eval()
    variables = jax.jit(lambda key: jmodel.init(key, jnp.zeros((1, 128)), jnp.zeros((1, 1000)),
                                                TRUNCATION))(jax.random.PRNGKey(0))
    apply = jax.jit(lambda z, label: jmodel.apply(variables, z, label, TRUNCATION)[0])
    base = rng.randn(2, 128).astype(np.float32)
    label = np.eye(1000, dtype=np.float32)[[7, 7]]
    not_finite = {}
    for spread in (0.36, 9.43):
        z = base / base.std() * spread
        theirs = np.asarray(apply(jnp.asarray(z), jnp.asarray(label)))
        with torch.no_grad():
            own = port(torch.from_numpy(z), torch.from_numpy(label), TRUNCATION)[0].numpy()
        not_finite[spread] = (float(np.mean(~np.isfinite(theirs))), float(np.mean(~np.isfinite(own))))
    print(f"\nBigGAN-256 layout at channel_width 4, share of image values not finite "
          f"(tpugan, port) by z std: {not_finite}")
    assert not_finite[0.36] == (0.0, 0.0)
    theirs, own = not_finite[9.43]
    assert theirs > 0.1 and own > 0.1 and abs(theirs - own) < 0.1
