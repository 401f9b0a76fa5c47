"""tpugan_torch's GAN modules vs tpugan (CPU): minibatch_stddev, the
StyleGANv1 discriminator, decode2, decode3 with the paired DecodeBlock,
Mapping2/3/4, the GAN losses, ``generate`` on injected draws, ``ema_params``,
``LODSchedule``, the FIR's second-order gradient and the port's own draws.

Weights go through the bridge with every param randomised; the same draws
go to both sides. tpugan's ``generate`` draws z2, the mixing cutoff and
coin and the noise from its key: the adapters below hand it the port's z2
and noise, and the cutoff and coin are computed from the key's splits as
tpugan makes them. Tolerances: ``minibatch_stddev`` and the losses 1e-6,
a discriminator block 1e-4, whole networks MODEL_TOL (rtol 2e-3, atol
2e-4; the convs of both sides sum in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import MODEL_TOL, draw, nchw, nhwc, randomized
from tpugan.models.stylegan1 import DiscriminatorBlock as JDiscriminatorBlock
from tpugan.models.stylegan1 import StyleGANv1Discriminator as JDiscriminator
from tpugan.models.stylegan1 import StyleGANv1Generator as JGenerator
from tpugan.models.stylegan1 import StyleGANv1Mapping as JMapping
from tpugan.models.stylegan1 import StyleGANv1Mapping2 as JMapping2
from tpugan.models.stylegan1 import StyleGANv1Mapping3 as JMapping3
from tpugan.models.stylegan1 import StyleGANv1Mapping4 as JMapping4
from tpugan.ops.basic import minibatch_stddev as jminibatch_stddev
from tpugan.train import gan as jgan
from tpugan_torch.io.bridge import load_variables
from tpugan_torch.models import (
    DiscriminatorBlock,
    StyleGANv1Discriminator,
    StyleGANv1Generator,
    StyleGANv1Mapping,
    StyleGANv1Mapping2,
    StyleGANv1Mapping3,
    StyleGANv1Mapping4,
)
from tpugan_torch.ops import upfirdn
from tpugan_torch.ops.basic import minibatch_stddev
from tpugan_torch.train import gan

torch.set_num_threads(1)

BLOCK_TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_TOL = dict(rtol=1e-6, atol=1e-6)
LATENT = 32


def assert_close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


@pytest.mark.parametrize("n,group", [(4, 4), (6, 4), (2, 4), (8, 2)])
def test_minibatch_stddev_matches(rng, n, group):
    """Strided groups of ``group`` (of 2 at n = 2; n = 6 wraps two samples
    round), the statistic appended as the last channel."""
    x = rng.randn(n, 3, 5, 7).astype(np.float32)
    want = np.asarray(jminibatch_stddev(jnp.asarray(x), group))
    got = nhwc(minibatch_stddev(nchw(x), group))
    assert got.shape == want.shape == (n, 3, 5, 8)
    assert_close(got, want, LOSS_TOL)
    if n == 6:  # samples 0 and 2 share a group, 0 and 1 do not
        assert got[0, 0, 0, -1] == got[2, 0, 0, -1] != got[1, 0, 0, -1]


@pytest.mark.parametrize("kind", ["fused", "unfused", "last"])
def test_discriminator_block_matches(rng, kind):
    cin, c, n = 6, 10, 3
    res = 4 if kind == "last" else 8
    x = rng.randn(n, res, res, cin).astype(np.float32)
    jb = JDiscriminatorBlock(c, last=kind == "last", fused_scale=kind == "fused")
    variables = randomized(jb.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    want = np.asarray(jb.apply(variables, jnp.asarray(x)))
    port = load_variables(DiscriminatorBlock(cin, c, last=kind == "last", fused_scale=kind == "fused"),
                          variables)
    with torch.no_grad():
        got = port(nchw(x))
    got = got.numpy() if kind == "last" else nhwc(got)
    assert got.shape == want.shape
    assert_close(got, want, BLOCK_TOL)


@pytest.mark.parametrize("cin", [4, 12])
def test_dense_reads_the_nhwc_flatten(rng, cin):
    """The last block's dense over the port's 4x4 map, permuted to (h, w, c)
    before the flatten, is tpugan's; the plain NCHW flatten is not."""
    x = rng.randn(2, 4, 4, cin + 1).astype(np.float32)
    jb = JDiscriminatorBlock(8, last=True)
    variables = randomized(jb.init(jax.random.PRNGKey(0), jnp.asarray(x[..., :cin])), rng)
    port = load_variables(DiscriminatorBlock(cin, 8, last=True), variables)
    dense = variables["params"]["dense"]
    want = x[..., :cin].reshape(2, -1) @ dense["kernel"] + dense["bias"]
    with torch.no_grad():
        mapped = nchw(x[..., :cin])
        got = port.dense(mapped.permute(0, 2, 3, 1).reshape(2, -1)).numpy()
        unordered = port.dense(mapped.reshape(2, -1)).numpy()
    assert_close(got, want, BLOCK_TOL)
    assert np.abs(unordered - want).max() > 100 * np.abs(got - want).max()


def test_discriminator_matches_at_two_lods(rng):
    """flax makes only the lod's from_rgb: the trees of lods 2 and 1 are
    merged, and the port loads the merged tree with from_rgb_2 unused."""
    jd = JDiscriminator(startf=8, maxf=32, layer_count=3)
    x2 = rng.randn(3, 16, 16, 3).astype(np.float32)
    x1 = rng.randn(3, 8, 8, 3).astype(np.float32)
    v2 = jd.init(jax.random.PRNGKey(0), jnp.asarray(x2), 2)
    v1 = jd.init(jax.random.PRNGKey(1), jnp.asarray(x1), 1)
    variables = randomized({"params": {**v2["params"], "from_rgb_1": v1["params"]["from_rgb_1"]}}, rng)
    port = load_variables(StyleGANv1Discriminator(startf=8, maxf=32, layer_count=3), variables,
                          unused=("from_rgb_2",))
    for lod, x in ((2, x2), (1, x1)):
        want = np.asarray(jd.apply(variables, jnp.asarray(x), lod))
        with torch.no_grad():
            got = port(nchw(x), lod).numpy()
        assert got.shape == want.shape == (3, 1)
        assert_close(got, want, MODEL_TOL)


@pytest.fixture(scope="module")
def generator_pair():
    """tpugan's generator initialised at lod 2 with blend < 1 (so it has
    to_rgb_1 and to_rgb_2), randomised, and the port loaded from it."""
    rng = np.random.RandomState(5)
    kw = dict(startf=8, maxf=32, layer_count=3, latent_size=LATENT)
    jg = JGenerator(**kw)
    port = StyleGANv1Generator(**kw)
    _, jax_noise = draw(port.noise_shapes(2), rng)
    styles = jnp.zeros((2, 6, LATENT))
    variables = randomized(jax.jit(lambda k: jg.init(k, styles, 2, 0.5, jax_noise))(jax.random.PRNGKey(2)), rng)
    return jg, variables, load_variables(port, variables, unused=("to_rgb_0",)), rng


@pytest.mark.parametrize("blend", [0.3, 1.0])
def test_decode2_matches(generator_pair, blend):
    jg, variables, port, rng = generator_pair
    styles = rng.randn(2, 6, LATENT).astype(np.float32)
    port_noise, jax_noise = draw(port.noise_shapes(2), rng)
    want = np.asarray(jg.apply(variables, jnp.asarray(styles), 2, blend, jax_noise))
    with torch.no_grad():
        got = nhwc(port(torch.from_numpy(styles), 2, port_noise, blend=blend))
    assert got.shape == want.shape == (2, 16, 16, 3)
    assert_close(got, want, MODEL_TOL)


@pytest.mark.parametrize("layer_count,startf,maxf,threshold", [(5, 4, 16, 0.5), (9, 1, 8, 1.0)])
def test_decode3_matches(rng, layer_count, startf, maxf, threshold):
    """Blob removal at lod 4 (the channel-max preview, 64 px) and at lod 8
    (to_rgb_8, 1024 px at widths 8 down to 1); the threshold is low enough
    that the copy after block 3 has activations zeroed."""
    lod = layer_count - 1
    kw = dict(startf=startf, maxf=maxf, layer_count=layer_count, latent_size=LATENT)
    jg = JGenerator(**kw)
    port = StyleGANv1Generator(**kw)
    styles = rng.randn(1, 2 * layer_count, LATENT).astype(np.float32)
    port_noise, jax_noise = draw(port.noise_shapes(1), rng)
    init = jax.jit(lambda k: jg.init(k, jnp.asarray(styles), lod, 1.0, jax_noise))
    variables = randomized(init(jax.random.PRNGKey(3)), rng)
    load_variables(port, variables, unused=tuple(f"to_rgb_{i}" for i in range(lod)))
    decode3 = jax.jit(lambda v, s, n: jg.apply(v, s, lod, n, blob_threshold=threshold,
                                               method=lambda m, s, lod, n, **k: m.decode3(s, lod, n, **k)))
    want = np.asarray(decode3(variables, jnp.asarray(styles), jax_noise))
    s = torch.from_numpy(styles)
    with torch.no_grad():
        got = nhwc(port.decode3(s, lod, port_noise, blob_threshold=threshold))
        after3 = port.const
        for i in range(4):
            after3 = port._block(i, after3, s, port_noise)
    assert got.shape == want.shape == (1, 4 << lod, 4 << lod, 3)
    assert 0 < float((after3 > threshold).float().mean()) < 1
    assert_close(got, want, MODEL_TOL)


@pytest.mark.parametrize("inverse", [False, True])
def test_mapping2_matches(rng, inverse):
    kw = dict(num_layers=6, mapping_layers=3, latent_size=LATENT)
    x = rng.randn(3, 6, LATENT) if inverse else rng.randn(3, LATENT)
    x = x.astype(np.float32)
    jm = JMapping2(**kw, inverse=inverse)
    variables = randomized(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    port = load_variables(StyleGANv1Mapping2(**kw, inverse=inverse), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == ((3, LATENT) if inverse else (3, 6, LATENT))
    assert_close(got, want, MODEL_TOL)


@pytest.mark.parametrize("jcls,cls,shape", [(JMapping3, StyleGANv1Mapping3, (3, 16)),
                                            (JMapping4, StyleGANv1Mapping4, (3, 6, 16))])
def test_mapping3_and_4_match(rng, jcls, cls, shape):
    x = rng.randn(*shape).astype(np.float32)
    jm = jcls(num_layers=6, latent_size=16)
    variables = randomized(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    port = load_variables(cls(num_layers=6, latent_size=16), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert_close(got, want, MODEL_TOL)


def test_losses_match(rng):
    fake, real = (rng.randn(5).astype(np.float32) * 3 for _ in range(2))
    r1 = rng.randn(5, 4, 4, 3).astype(np.float32)
    mu, log_var = rng.randn(5, 7).astype(np.float32), rng.randn(5, 7).astype(np.float32)
    recon, x = rng.randn(5, 6).astype(np.float32), rng.randn(5, 6).astype(np.float32)
    t = torch.from_numpy
    pairs = [
        (gan.generator_logistic_non_saturating(t(fake)), jgan.generator_logistic_non_saturating(fake)),
        (gan.discriminator_logistic_simple_gp(t(fake), t(real)), jgan.discriminator_logistic_simple_gp(fake, real)),
        (gan.discriminator_logistic_simple_gp(t(fake), t(real), t(r1), 10.0),
         jgan.discriminator_logistic_simple_gp(fake, real, r1, 10.0)),
        (gan.discriminator_logistic_simple_gp(t(fake), t(real), t(r1), 0.0),
         jgan.discriminator_logistic_simple_gp(fake, real, r1, 0.0)),
        (gan.kl(t(mu), t(log_var)), jgan.kl(mu, log_var)),
        (gan.reconstruction(t(recon), t(x)), jgan.reconstruction(recon, x)),
    ]
    for got, want in pairs:
        assert_close(got.item(), float(want), LOSS_TOL)


class FedMapping:
    """tpugan's mapping, fed the given latents in turn in place of the ones
    its caller draws; records what the caller handed it (``seen``)."""

    def __init__(self, gm, latents):
        self.gm, self.latents, self.calls, self.seen = gm, latents, 0, []

    def apply(self, params, z, *args):
        jax.debug.callback(lambda v: self.seen.append(np.asarray(v).copy()), z)
        fed = self.latents[self.calls % len(self.latents)]
        self.calls += 1
        return self.gm.apply(params, fed, *args)


class FedGenerator:
    """tpugan's generator, fed the given noise in place of its ``noise`` rng."""

    def __init__(self, gen, noise):
        self.gen, self.noise = gen, noise

    def apply(self, params, styles, lod, blend, rngs=None):
        return self.gen.apply(params, styles, lod, blend, self.noise)


def tpugan_mixing(key, lod, prob=0.9):
    """The mixing cutoff and coin that tpugan's ``generate`` takes from
    ``key`` (its splits kz, kmix, kcut, knoise, knoise2)."""
    _, kmix, kcut, _, _ = jax.random.split(key, 5)
    cutoff = int(jax.random.randint(kcut, (), 1, 2 * (lod + 1) + 1))
    return cutoff, bool(jax.random.uniform(kmix) < prob)


def mixing_key(lod, mix):
    for seed in range(100):
        key = jax.random.PRNGKey(seed)
        if tpugan_mixing(key, lod)[1] == mix:
            return key
    raise AssertionError("no key with that coin")


def port_draws(gen, count, lod, key, seed=0):
    """The port's own draws from a seeded generator, with the cutoff and coin
    that tpugan takes from ``key``; and the noise NHWC for tpugan."""
    d = gan.draw(gen, count, LATENT, lod, torch.Generator().manual_seed(seed))
    cutoff, mix = tpugan_mixing(key, lod)
    d = d._replace(cutoff=torch.tensor(cutoff), mix=torch.tensor(mix))
    jax_noise = [tuple(jnp.asarray(nhwc(n)) for n in pair) for pair in d.noise]
    return d, jax_noise


@pytest.mark.parametrize("mix", [True, False])
def test_generate_matches_on_injected_draws(generator_pair, mix):
    jg, gen_vars, port_gen, rng = generator_pair
    lod, blend = 2, 0.3
    kw = dict(num_layers=6, mapping_layers=2, latent_size=LATENT, dlatent_size=LATENT, mapping_fmaps=LATENT)
    jm = JMapping(**kw)
    gm_vars = randomized(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, LATENT))), rng)
    port_gm = load_variables(StyleGANv1Mapping(**kw), gm_vars)
    avg = rng.randn(6, LATENT).astype(np.float32)
    key = mixing_key(lod, mix)
    draws, jax_noise = port_draws(port_gen, 3, lod, key)
    truncation = dict(truncation_psi=0.7, truncation_cutoff=4)
    fed = FedMapping(jm, [jnp.asarray(draws.z.numpy()), jnp.asarray(draws.z2.numpy())])
    images, new_avg = jgan.generate(FedGenerator(jg, jax_noise), fed, gen_vars, gm_vars, jnp.asarray(avg), key,
                                    lod, blend, count=3, latent_size=LATENT, **truncation)
    with torch.no_grad():
        got, got_avg = gan.generate(port_gen, port_gm, torch.from_numpy(avg), lod, blend, draws, **truncation)
    assert_close(nhwc(got), images, MODEL_TOL)
    assert_close(got_avg.numpy(), new_avg, LOSS_TOL)
    # the mixing changes the images when it is on (z2 is not z here)
    with torch.no_grad():
        unmixed, _ = gan.generate(port_gen, port_gm, torch.from_numpy(avg), lod, blend,
                                  draws._replace(mix=torch.tensor(False)), **truncation)
    assert torch.equal(unmixed, got) != mix


def test_ema_params_matches(rng):
    slow, fast = StyleGANv1Mapping(4, 2, 8, 8, 8), StyleGANv1Mapping(4, 2, 8, 8, 8)
    with torch.no_grad():
        for p in list(slow.parameters()) + list(fast.parameters()):
            p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32)))
    want = jgan.ema_params([p.detach().numpy().copy() for p in slow.parameters()],
                           [p.detach().numpy().copy() for p in fast.parameters()], beta=0.99)
    assert gan.ema_params(slow, fast, beta=0.99) is slow
    for got, w in zip(slow.parameters(), want):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kw", [{}, dict(epochs_per_lod=4, dataset_size=100, max_lod=3),
                                dict(max_lod=6), dict(epochs_per_lod=1, max_lod=8)])
def test_lod_schedule_matches(kw):
    port, ref = gan.LODSchedule(**kw), jgan.LODSchedule(**kw)
    for epoch in range(0, 130, 3):
        assert port.lod(epoch) == ref.lod(epoch)
        assert port.batch_size(epoch) == ref.batch_size(epoch)
        assert port.in_transition(epoch) == ref.in_transition(epoch)
        for iteration in (0, 1, 37, 999, 59999):
            assert port.blend(epoch, iteration) == ref.blend(epoch, iteration)


@pytest.mark.parametrize("up,down,pad", [(1, 1, (1, 1)), (2, 1, (2, 1)), (1, 2, (1, 1))])
def test_fir_second_order_gradient(up, down, pad):
    """The R1 penalty differentiates upfirdn2d's backward: its adjoint's own
    adjoint, on the CPU through the plain FIR, in float64 (the blur, an up-2
    and a down-2 FIR)."""
    taps = upfirdn.setup_fir_kernel((1.0, 2.0, 1.0)) if up == down == 1 else \
        upfirdn.setup_fir_kernel((1.0, 3.0, 3.0, 1.0))
    x = torch.randn(2, 3, 6, 6, dtype=torch.float64, generator=torch.Generator().manual_seed(up + 2 * down),
                    requires_grad=True)

    def fir(y):
        return upfirdn.upfirdn2d(y, taps, up=up, down=down, pad=pad, gain=float(up * up))

    assert torch.autograd.gradcheck(fir, (x,))
    assert torch.autograd.gradgradcheck(fir, (x,))


def test_r1_gradient_runs_the_adjoint_of_the_adjoint():
    """A weight after a blur gets a finite second-order gradient, and the
    backward of the R1 penalty calls the FIR's backward on the adjoint's own
    node (the launch chip_smoke counts as second order)."""
    calls = []
    real = upfirdn._UpFirDn2d.backward

    def counted(ctx, g):
        calls.append(torch.is_grad_enabled())
        return real(ctx, g)

    upfirdn._UpFirDn2d.backward = staticmethod(counted)
    try:
        w = torch.randn(4, 4, 3, 3, requires_grad=True)
        x = torch.randn(2, 4, 8, 8, requires_grad=True)
        y = torch.nn.functional.conv2d(upfirdn.blur3x3(torch.tanh(x)), w, padding=1)
        (gx,) = torch.autograd.grad(y.square().sum(), x, create_graph=True)
        (gw,) = torch.autograd.grad(gx.square().sum(), w)
    finally:
        upfirdn._UpFirDn2d.backward = staticmethod(real)
    assert bool(torch.isfinite(gw).all()) and gw.abs().max() > 0
    assert calls == [True, False]  # R1's adjoint with a graph, then that adjoint's own


def test_port_draws_are_seeded_and_mix_an_independent_latent():
    gen = StyleGANv1Generator(startf=8, maxf=32, layer_count=3, latent_size=LATENT)
    a, b = (gan.draw(gen, 4, LATENT, 2, torch.Generator().manual_seed(11)) for _ in range(2))
    c = gan.draw(gen, 4, LATENT, 2, torch.Generator().manual_seed(12))
    for x, y in zip(a[:4], b[:4]):
        assert torch.equal(x, y)
    assert all(torch.equal(x, y) for p, q in zip(a.noise, b.noise) for x, y in zip(p, q))
    assert [tuple(n.shape) for n in a.noise[2]] == [(4, 1, 16, 16)] * 2
    assert not torch.equal(a.z, c.z)
    assert not torch.allclose(a.z, a.z2)
    assert 1 <= int(a.cutoff) <= 6 and a.mix.dtype == torch.bool
