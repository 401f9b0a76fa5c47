"""tpugan_torch's GAN D and G steps vs tpugan's jitted ``make_gan_steps``
(CPU): one D step (R1, whose backward runs the FIR's adjoint of the
adjoint) and then one G step, from the same randomised weights, dlatent
average, reals and draws, under optax ``adam`` <-> ``torch.optim.Adam``
and tpugan's ``lreq_adam`` <-> the port's ``LREQAdam``.

tpugan draws z, z2, the mixing cutoff and coin and the noise from its key.
The adapters of ``test_torch_gan`` hand its mapping the port's z and z2 and
its generator the port's noise; the cutoff and coin are the ones tpugan
takes from the key. They also record the latents tpugan's own D step hands
its mapping: the same z twice (its z2 reuses z's key), so its style mixing
mixes nothing.

Both sides run in float64 (tpugan under x64): the first update of either
optimizer is about lr c sign(g) (c the equalized-LR coefficient, 1 for
Adam), so in fp32 an element whose gradient is near zero may move 2 lr c
the other way on one side. Tolerances, written before the first run:
losses rtol 1e-6; dlatent_avg rtol 1e-6, atol 1e-7; gradients rtol 1e-5
and atol 1e-6 of the network's max |g|; parameters after the update within
1e-7 (abs and rel), except an element whose float64 gradient is near zero,
which may differ by 2 lr c. Float64 runs are not all float64 (both
packages take norm moments in fp32), hence not 1e-12: G's gradients part
by up to 1.7e-7 of their max. "Near zero" was first 1e-6 of the leaf's max
|g|, and G's step failed it: elements of |g| 1e-10 to 1.4e-8 moved 1e-7 to
1.3e-5 apart. There the first update, lr c g / (|g| + eps'), is no longer
sign-like (eps' = eps for Adam, eps / sqrt(1 - beta2) for LREQAdam) and
follows the gradient's last digits. So an element is near zero below 100
eps', where a gradient within its tolerance moves the update by less than
1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from test_torch_gan import LATENT, FedGenerator, FedMapping, nchw, tpugan_mixing
from test_torch_models import randomized
from test_torch_sgv1_train import _recording
from tpugan.models.stylegan1 import StyleGANv1Discriminator as JDiscriminator
from tpugan.models.stylegan1 import StyleGANv1Generator as JGenerator
from tpugan.models.stylegan1 import StyleGANv1Mapping as JMapping
from tpugan.ops.eq_lr import lreq_coef_tree
from tpugan.optim.lreq_adam import lreq_adam as jlreq_adam
from tpugan.train import gan as jgan
from tpugan_torch.io import bridge
from tpugan_torch.models import StyleGANv1Discriminator, StyleGANv1Generator, StyleGANv1Mapping
from tpugan_torch.ops.eq_lr import lreq_coefs
from tpugan_torch.optim.lreq_adam import lreq_adam
from tpugan_torch.train import gan

torch.set_num_threads(1)

LAYERS, LOD, BATCH, LR = 3, 2, 4, 0.0015
KW_G = dict(startf=8, maxf=32, layer_count=LAYERS, latent_size=LATENT)
KW_GM = dict(num_layers=2 * LAYERS, mapping_layers=2, latent_size=LATENT, dlatent_size=LATENT,
             mapping_fmaps=LATENT)
KW_D = dict(startf=8, maxf=32, layer_count=LAYERS)
UNUSED_G = tuple(f"to_rgb_{i}" for i in range(LOD))
UNUSED_D = tuple(f"from_rgb_{i}" for i in range(1, LAYERS))
LOSS_RTOL = 1e-6
AVG_TOL = dict(rtol=1e-6, atol=1e-7)
GRAD_RTOL, GRAD_SHARE = 1e-5, 1e-6
PARAM_TOL = 1e-7
NEAR_ZERO = 100  # times the optimizer's effective epsilon
EPS = {"adam": 1e-8, "lreq_adam": 1e-8 / np.sqrt(1 - 0.99)}
OPTIMIZERS = ("adam", "lreq_adam")


@pytest.fixture(scope="module")
def setup():
    """tpugan's networks from their flax init (jitted) with every param
    randomised, a random dlatent average, reals, tpugan's keys of the two
    steps, and the port's own draws for each step with the mixing cutoff
    and coin tpugan takes from that key under x64."""
    rng = np.random.RandomState(0)
    jgen, jgm, jdisc = JGenerator(**KW_G), JMapping(**KW_GM), JDiscriminator(**KW_D)
    probe = StyleGANv1Generator(**KW_G)
    noise0 = [tuple(jnp.zeros((BATCH, s[2], s[3], 1)) for s in pair) for pair in probe.noise_shapes(BATCH)]
    gen_vars = randomized(jax.jit(lambda k: jgen.init(k, jnp.zeros((BATCH, 2 * LAYERS, LATENT)), LOD, 1.0,
                                                      noise0))(jax.random.PRNGKey(1)), rng)
    gm_vars = randomized(jax.jit(jgm.init)(jax.random.PRNGKey(2), jnp.zeros((1, LATENT))), rng)
    d_vars = randomized(jax.jit(lambda k: jdisc.init(k, jnp.zeros((1, 16, 16, 3)), LOD))(jax.random.PRNGKey(3)),
                        rng)
    keys = {"d": jax.random.split(jax.random.PRNGKey(4))[0], "g": jax.random.PRNGKey(5)}
    draws = {}
    for seed, (kind, key) in enumerate(keys.items()):
        d = gan.draw(probe, BATCH, LATENT, LOD, torch.Generator().manual_seed(seed))
        with jax.enable_x64(True):  # as the steps run: x64 draws other bits
            cutoff, mix = tpugan_mixing(key, LOD)
        draws[kind] = d._replace(cutoff=torch.tensor(cutoff), mix=torch.tensor(mix))
    return dict(jgen=jgen, jgm=jgm, jdisc=jdisc, gen_vars=gen_vars, gm_vars=gm_vars, d_vars=d_vars,
                avg=(rng.randn(2 * LAYERS, LATENT) * 0.1).astype(np.float32),
                reals=rng.randn(BATCH, 16, 16, 3).astype(np.float32),
                keys={"d": jax.random.PRNGKey(4), "g": keys["g"]}, draws=draws)


def _port_named(module, tree):
    """A tpugan params tree as {port name: array in the port's layout}, its
    dtype kept (the bridge's walk, without its fp32 copy)."""
    out = {}
    bridge._walk(module, jax.tree.map(np.asarray, tree), "", out)
    return out


_RUNS = {}  # tpugan's runs by optimizer, shared by the tests


def tpugan_run(setup, opt):
    """tpugan's jitted D step and then G step in float64: the losses, the
    dlatent average after each, the gradients and parameters after each
    update ({port name: array}) and the latents its D step handed gm."""
    if opt in _RUNS:
        return _RUNS[opt]
    port = {"gen": StyleGANv1Generator(**KW_G), "gm": StyleGANv1Mapping(**KW_GM),
            "disc": StyleGANv1Discriminator(**KW_D)}
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)  # noqa: E731
        g_params = {"gen": {"params": f64(setup["gen_vars"]["params"])},
                    "gm": {"params": f64(setup["gm_vars"]["params"])}}
        d_params = {"params": f64(setup["d_vars"]["params"])}
        if opt == "adam":
            g_opt, d_opt = optax.adam(LR), optax.adam(LR)
        else:
            coefs = {k: {"params": lreq_coef_tree(setup[f"{k}_vars"]["params"], setup[f"{k}_vars"]["lreq"])}
                     for k in ("gen", "gm")}
            g_opt = jlreq_adam(LR, coefs=coefs)
            d_opt = jlreq_adam(LR, coefs={"params": lreq_coef_tree(d_params["params"], setup["d_vars"]["lreq"])})
        g_opt, d_opt = _recording(g_opt, keep=1), _recording(d_opt, keep=1)
        steps, fed = {}, {}
        for kind, d in setup["draws"].items():
            fed[kind] = FedMapping(setup["jgm"], [jnp.asarray(d.z.double().numpy()),
                                                  jnp.asarray(d.z2.double().numpy())])
            noise = [tuple(jnp.asarray(n.double().numpy().transpose(0, 2, 3, 1)) for n in pair) for pair in d.noise]
            steps[kind] = jgan.make_gan_steps(FedGenerator(setup["jgen"], noise), fed[kind], setup["jdisc"],
                                              g_opt, d_opt, lod=LOD, latent_size=LATENT)
        state = jgan.GANTrainState(g_params=g_params, d_params=d_params, dlatent_avg=f64(setup["avg"]),
                                   g_opt=g_opt.init(g_params), d_opt=d_opt.init(d_params),
                                   step=jnp.zeros([], jnp.int32))
        state1, d_loss = jax.jit(steps["d"][0])(state, f64(setup["reals"]), setup["keys"]["d"])
        state2, g_loss = jax.jit(steps["g"][1], static_argnums=1)(state1, BATCH, setup["keys"]["g"])
        out = dict(
            d_loss=float(d_loss), g_loss=float(g_loss), step=int(state1.step),
            avg=[np.asarray(state1.dlatent_avg), np.asarray(state2.dlatent_avg)],
            d_grads=_port_named(port["disc"], state1.d_opt[-1]["params"]),
            d_params=_port_named(port["disc"], state1.d_params["params"]),
            g_grads={f"{k}.{n}": v for k in ("gen", "gm")
                     for n, v in _port_named(port[k], state2.g_opt[-1][k]["params"]).items()},
            g_params={f"{k}.{n}": v for k in ("gen", "gm")
                      for n, v in _port_named(port[k], state2.g_params[k]["params"]).items()},
            seen=fed["d"].seen)
    _RUNS[opt] = out
    return out


def _recorded_step(opt, names):
    """Wraps ``opt.step`` to keep the gradients it applies, by name."""
    grads, real = [], opt.step

    def step(*args, **kwargs):
        params = [p for group in opt.param_groups for p in group["params"]]
        grads.append({n: p.grad.detach().numpy().copy() for n, p in zip(names, params) if p.grad is not None})
        return real(*args, **kwargs)

    opt.step = step
    return grads


def port_run(setup, opt, dtype=torch.float64):
    gen = bridge.load_variables(StyleGANv1Generator(**KW_G), setup["gen_vars"], unused=UNUSED_G).to(dtype)
    gm = bridge.load_variables(StyleGANv1Mapping(**KW_GM), setup["gm_vars"]).to(dtype)
    disc = bridge.load_variables(StyleGANv1Discriminator(**KW_D), setup["d_vars"], unused=UNUSED_D).to(dtype)
    g_both = nn.ModuleDict({"gen": gen, "gm": gm})
    if opt == "adam":
        g_opt, d_opt = torch.optim.Adam(g_both.parameters(), lr=LR), torch.optim.Adam(disc.parameters(), lr=LR)
    else:
        g_opt, d_opt = lreq_adam(g_both, LR), lreq_adam(disc, LR)
    g_grads = _recorded_step(g_opt, [n for n, _ in g_both.named_parameters()])
    d_grads = _recorded_step(d_opt, [n for n, _ in disc.named_parameters()])
    state = gan.init_gan_state(gen, gm, disc, g_opt, d_opt, device="cpu")
    state.dlatent_avg = torch.from_numpy(setup["avg"]).to(dtype)
    d_step, g_step = gan.make_gan_steps(LOD, latent_size=LATENT)
    draws = {k: d._replace(z=d.z.to(dtype), z2=d.z2.to(dtype),
                           noise=[tuple(n.to(dtype) for n in pair) for pair in d.noise])
             for k, d in setup["draws"].items()}
    state, d_loss = d_step(state, nchw(setup["reals"]).to(dtype), draws["d"])
    avg1 = state.dlatent_avg.clone()
    d_params = {n: p.detach().numpy().copy() for n, p in disc.named_parameters()}
    state, g_loss = g_step(state, BATCH, draws["g"])
    assert len(d_grads) == len(g_grads) == 1
    return dict(d_loss=d_loss.item(), g_loss=g_loss.item(), step=state.step,
                avg=[avg1.numpy(), state.dlatent_avg.numpy()], d_grads=d_grads[0], d_params=d_params,
                g_grads=g_grads[0], g_params={n: p.detach().numpy() for n, p in g_both.named_parameters()},
                coefs={"d": lreq_coefs(disc), "g": lreq_coefs(g_both)})


def check_grads(got, want, label):
    assert set(got) == set(want), f"{label}: {sorted(set(got) ^ set(want))}"
    scale = max(np.abs(w).max() for w in want.values())
    assert scale > 0
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=GRAD_RTOL, atol=GRAD_SHARE * scale,
                                   err_msg=f"{label} gradient of {name}")


def check_params(got, want, grads, coefs, eps, label):
    """Parameters after the update (the module docstring's rule)."""
    for name, w in want.items():
        near_zero = np.abs(grads[name]) <= NEAR_ZERO * eps
        diff = np.abs(got[name] - w)
        assert (diff[~near_zero] <= PARAM_TOL * (1 + np.abs(w[~near_zero]))).all(), \
            f"{label} {name}: max |diff| {diff[~near_zero].max():.3e}"
        assert (diff[near_zero] <= 2 * LR * coefs[name] + PARAM_TOL).all(), f"{label} {name} near zero"


@pytest.mark.parametrize("opt", OPTIMIZERS)
def test_d_step_matches_tpugan(setup, opt):
    want, got = tpugan_run(setup, opt), port_run(setup, opt)
    np.testing.assert_allclose(got["d_loss"], want["d_loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["avg"][0], want["avg"][0], **AVG_TOL)
    assert got["step"] == want["step"] == 1
    check_grads(got["d_grads"], want["d_grads"], f"{opt} D")
    coefs = got["coefs"]["d"] if opt == "lreq_adam" else {n: 1.0 for n in want["d_params"]}
    check_params({n: got["d_params"][n] for n in want["d_params"]}, want["d_params"], want["d_grads"], coefs,
                 EPS[opt], f"{opt} D")
    # the R1 term is in the loss: a D step without it lands elsewhere
    assert got["d_loss"] > 0


@pytest.mark.parametrize("opt", OPTIMIZERS)
def test_g_step_matches_tpugan(setup, opt):
    """After the D step: the G loss, the dlatent average (whose batch mean
    carries G's gradient into the mapping), the gradients of gen and gm and
    their parameters after the update."""
    want, got = tpugan_run(setup, opt), port_run(setup, opt)
    np.testing.assert_allclose(got["g_loss"], want["g_loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["avg"][1], want["avg"][1], **AVG_TOL)
    check_grads(got["g_grads"], want["g_grads"], f"{opt} G")
    coefs = got["coefs"]["g"] if opt == "lreq_adam" else {n: 1.0 for n in want["g_params"]}
    check_params({n: got["g_params"][n] for n in want["g_params"]}, want["g_params"], want["g_grads"], coefs,
                 EPS[opt], f"{opt} G")
    assert np.abs(got["g_grads"]["gm.block_1.fc.weight"]).max() > 0


def test_g_step_gradient_reaches_gm_through_the_dlatent_average(setup):
    """tpugan's G step does not detach the updated dlatent average (the
    truncation centre), and the port, held to it above, does not either:
    with the same average detached (ALAE's no_grad lerp) the images are the
    same and gm's gradient is not."""
    gen = bridge.load_variables(StyleGANv1Generator(**KW_G), setup["gen_vars"], unused=UNUSED_G).double()
    gm = bridge.load_variables(StyleGANv1Mapping(**KW_GM), setup["gm_vars"]).double()
    disc = bridge.load_variables(StyleGANv1Discriminator(**KW_D), setup["d_vars"], unused=UNUSED_D).double()
    d = setup["draws"]["g"]
    draws = d._replace(z=d.z.double(), z2=d.z2.double(), noise=[tuple(n.double() for n in p) for p in d.noise])
    avg = torch.from_numpy(setup["avg"]).double()
    with torch.no_grad():
        detached = avg + (gm(draws.z).mean(dim=0) - avg) * (1.0 - 0.995)
    runs = [gan.generate(gen, gm, avg, LOD, 1.0, draws)[0],
            gan.generate(gen, gm, detached, LOD, 1.0, draws, dlatent_avg_beta=None)[0]]
    torch.testing.assert_close(runs[0], runs[1], rtol=1e-12, atol=1e-12)
    grads = [torch.autograd.grad(gan.generator_logistic_non_saturating(disc(f, LOD).squeeze(-1)),
                                 gm.block_1.fc.weight)[0] for f in runs]
    assert (grads[0] - grads[1]).abs().max() > 1e-6 * grads[0].abs().max()


def test_tpugan_d_step_feeds_gm_the_same_latent_twice(setup):
    """tpugan's ``generate`` draws z2 from z's key (``tpugan/train/gan.py``
    :92 and :102), so its D step hands the mapping one latent twice and its
    style mixing is a no-op; the port draws z2 apart."""
    seen = tpugan_run(setup, "adam")["seen"]
    assert len(seen) == 2 and seen[0].shape == (BATCH, LATENT)
    np.testing.assert_array_equal(seen[0], seen[1])
    d = setup["draws"]["d"]
    assert not torch.allclose(d.z, d.z2)
