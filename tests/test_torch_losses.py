"""tpugan_torch's losses, LREQAdam and spectral-norm power iteration vs
tpugan (CPU): values, and gradients with respect to the reconstruction b.

Inputs are drawn once with numpy and handed to both sides; weights (VGG16,
LPIPS, E_BIG) go through the bridge.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_biggan import draw, randomized
from tpugan.losses.lpips import make_lpips_fn as jmake_lpips_fn
from tpugan.losses.lpips import random_params as jlpips_params
from tpugan.losses.space_loss import space_loss as jspace_loss
from tpugan.losses.ssim import ssim as jssim
from tpugan.losses.vgg import VGG16 as JVGG16
from tpugan.models.encoders import BigGANEncoder as JEncoder
from tpugan.nn.spectral import power_iterate as jpower_iterate
from tpugan.ops.eq_lr import lreq_coef_tree
from tpugan.optim import lreq_adam as jlreq_adam
from tpugan_torch.io.bridge import load_variables
from tpugan_torch.losses.lpips import LPIPS, make_lpips_fn, random_lpips_fn
from tpugan_torch.losses.space_loss import pool_for_lpips, space_loss, zero_space_info
from tpugan_torch.losses.ssim import ssim
from tpugan_torch.losses.vgg import VGG16Features
from tpugan_torch.models import BigGANEncoder
from tpugan_torch.nn.spectral import SNDense, power_iterate
from tpugan_torch.ops.eq_lr import lreq_coefs
from tpugan_torch.optim import LREQAdam, lreq_adam

torch.set_num_threads(1)

# tests/test_torch_biggan.py's layer tolerance: values and gradients of one
# loss, summation orders apart
TOL = dict(rtol=1e-4, atol=1e-4)


def _images(rng, shape, scale=0.5):
    return np.tanh(rng.randn(*shape) * scale).astype(np.float32)


def _grad(jfn, tfn, a, b):
    """Value and gradient with respect to b on both sides."""
    jval, jgrad = jax.jit(jax.value_and_grad(lambda a_, b_: jfn(a_, b_), argnums=1))(
        jnp.asarray(a), jnp.asarray(b))
    bt = torch.from_numpy(b).requires_grad_()
    val = tfn(torch.from_numpy(a), bt)
    (grad,) = torch.autograd.grad(val, bt)
    return (float(val), grad.numpy()), (float(jval), np.asarray(jgrad))


@pytest.mark.parametrize("shape", [(2, 32, 32, 3), (1, 22, 18, 3)])
def test_ssim_matches(rng, shape):
    a, b = _images(rng, shape), _images(rng, shape)
    (val, grad), (jval, jgrad) = _grad(jssim, ssim, a, b)
    np.testing.assert_allclose(val, jval, **TOL)
    np.testing.assert_allclose(grad, jgrad, **TOL)
    assert 0.0 < val < 1.0


@pytest.fixture(scope="module")
def lpips_vars():
    """LPIPS weights drawn with numpy (std 1/sqrt(fan_in)) in flax's tree."""
    rng = np.random.RandomState(7)
    return jax.tree.map(
        lambda x: (rng.randn(*x.shape) / np.sqrt(np.prod(x.shape[:-1]))).astype(np.float32),
        jax.eval_shape(lambda: jlpips_params(jax.random.PRNGKey(7), 32)))


def test_vgg16_features_match(rng, lpips_vars):
    x = rng.randn(2, 32, 32, 3).astype(np.float32)
    backbone = {"params": lpips_vars["params"]["backbone"]}
    _, want = JVGG16(include_classifier=False).apply(backbone, jnp.asarray(x))
    got = load_variables(VGG16Features(), backbone)(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(want) == 13
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().permute(0, 2, 3, 1).numpy(), np.asarray(w), **TOL)


def test_lpips_matches_with_gradient_and_cached_features(rng, lpips_vars):
    a, b = _images(rng, (2, 32, 32, 3)), _images(rng, (2, 32, 32, 3))
    jfn = jmake_lpips_fn(lpips_vars)
    fn = make_lpips_fn(load_variables(LPIPS(), lpips_vars))
    (val, grad), (jval, jgrad) = _grad(lambda x, y: jfn(x, y).sum(), lambda x, y: fn(x, y).sum(), a, b)
    np.testing.assert_allclose(val, jval, **TOL)
    np.testing.assert_allclose(grad, jgrad, **TOL)
    per_sample = fn(torch.from_numpy(a), torch.from_numpy(b))
    assert per_sample.shape == (2,)
    cached = fn(torch.from_numpy(a), torch.from_numpy(b), a_feats=fn.features(torch.from_numpy(a)))
    torch.testing.assert_close(cached, per_sample, rtol=0, atol=0)
    assert all(not p.requires_grad for p in fn.features.__self__.parameters())


def test_random_lpips_has_the_architecture(rng):
    fn = random_lpips_fn("cpu")
    x = torch.from_numpy(_images(rng, (1, 32, 32, 3)))
    assert fn(x, x).abs().max() == 0.0
    state = fn.features.__self__.state_dict()
    assert state["lin_4.weight"].shape == (1, 512, 1, 1)
    assert state["backbone.conv_12.weight"].shape == (512, 512, 3, 3)


SPACE_CASES = {
    "image_with_lpips": ((2, 32, 32, 3), True, True),
    "image_pooled_ladder": ((1, 264, 264, 3), True, False),
    "latent_2d": ((2, 16), False, False),  # KL over dim 1
    "latent_3d": ((2, 6, 8), False, False),  # KL over dim 0
}


@pytest.mark.parametrize("name", sorted(SPACE_CASES))
def test_space_loss_matches(rng, lpips_vars, name):
    shape, image_space, with_lpips = SPACE_CASES[name]
    a, b = (_images(rng, shape) if image_space else rng.randn(*shape).astype(np.float32)
            for _ in range(2))
    jfn = jmake_lpips_fn(lpips_vars) if with_lpips else None
    fn = make_lpips_fn(load_variables(LPIPS(), lpips_vars)) if with_lpips else None
    got = space_loss(torch.from_numpy(a), torch.from_numpy(b), image_space, lpips_fn=fn)
    want = jspace_loss(jnp.asarray(a), jnp.asarray(b), image_space, lpips_fn=jfn)
    np.testing.assert_allclose(float(got[0]), float(want[0]), **TOL)
    for field, g, w in zip(got[1]._fields, got[1], want[1]):
        np.testing.assert_allclose(float(g), float(w), **TOL, err_msg=field)
    (_, grad), (_, jgrad) = _grad(lambda x, y: jspace_loss(x, y, image_space, lpips_fn=jfn)[0],
                                  lambda x, y: space_loss(x, y, image_space, lpips_fn=fn)[0], a, b)
    np.testing.assert_allclose(grad, jgrad, **TOL)
    if with_lpips:
        assert float(got[1].lpips) != 0  # random heads: either sign


def test_space_loss_kl_guards_and_zero_input(rng):
    """The KL's inf guard (a softmax that underflows) and the cosine's eps
    inside the sqrt, which keeps the gradient of an all-zero input finite."""
    a = (rng.randn(2, 16) * 200).astype(np.float32)
    b = np.zeros_like(a)
    got = space_loss(torch.from_numpy(a), torch.from_numpy(b), image_space=False)
    want = jspace_loss(jnp.asarray(a), jnp.asarray(b), image_space=False)
    assert float(want[1].kl) == float(got[1].kl)
    for field, g, w in zip(got[1]._fields, got[1], want[1]):
        np.testing.assert_allclose(float(g), float(w), **TOL, err_msg=field)
    (val, grad), (jval, jgrad) = _grad(
        lambda x, y: jspace_loss(x, y, image_space=False)[0],
        lambda x, y: space_loss(x, y, image_space=False)[0], a, b)
    assert np.isfinite(grad).all() and np.isfinite(jgrad).all()
    np.testing.assert_allclose(grad, jgrad, **TOL)
    assert all(float(x) == 0.0 for x in zero_space_info())
    big = torch.zeros(1, 520, 300, 3)
    assert pool_for_lpips(big).shape == (1, 130, 75, 3)


ENC = dict(startf=8, maxf=32, layer_count=3, cond_dim=16, z_dim=8)


@pytest.fixture(scope="module")
def e_big():
    rng = np.random.RandomState(3)
    shapes = BigGANEncoder(**ENC, img_size=16).noise_shapes(2, 16)
    _, jnoise = draw(shapes, rng)
    je = JEncoder(**ENC)
    variables = jax.jit(je.init)({"params": jax.random.PRNGKey(0)}, jnp.zeros((2, 16, 16, 3)),
                                 jnp.zeros((2, 16)), jnoise)
    return randomized(variables, rng)


def test_lreq_coefs_cover_every_e_big_parameter(e_big):
    port = load_variables(BigGANEncoder(**ENC, img_size=16), e_big)
    want = {}

    def walk(node, coefs, prefix):
        for key, value in node.items():
            if isinstance(value, dict):
                walk(value, coefs[key], f"{prefix}{key}.")
            else:
                want[prefix + ("weight" if key == "kernel" else key)] = coefs[key]

    walk(e_big["params"], lreq_coef_tree(e_big["params"], e_big["lreq"]), "")
    got = lreq_coefs(port)
    assert got.keys() == want.keys()
    for name in want:
        assert got[name] == pytest.approx(want[name], rel=1e-6), name
    # EqConv/EqLinear weights carry gain / sqrt(fan_in); biases, noise weights,
    # the plain from_rgb and the SNDense weights carry 1
    assert got["block_0.conv_1.weight"] == pytest.approx(np.sqrt(2 / (9 * 8)))
    assert got["new_final_1.weight"] == pytest.approx(1 / np.sqrt(32 * 4 * 4))
    assert got["from_rgb.weight"] == got["block_0.batch_norm_1.scale.weight"] == 1.0
    assert got["block_0.noise_weight_1"] == got["block_0.bias_1"] == 1.0


def test_lreq_adam_matches_over_three_updates(e_big):
    port = load_variables(BigGANEncoder(**ENC, img_size=16), e_big)
    params = e_big["params"]
    opt = jlreq_adam(0.0015, coefs=lreq_coef_tree(params, e_big["lreq"]))
    jstate = opt.init(params)
    port_opt = lreq_adam(port, 0.0015)
    rng = np.random.RandomState(5)
    jparams = jax.tree.map(jnp.asarray, params)
    update = jax.jit(opt.update)
    for _ in range(3):
        grads = jax.tree.map(lambda p: rng.randn(*p.shape).astype(np.float32), params)
        updates, jstate = update(jax.tree.map(jnp.asarray, grads), jstate, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, updates)
        as_port = dict(load_variables(BigGANEncoder(**ENC, img_size=16),
                                      {**e_big, "params": grads}).named_parameters())
        port_opt.step([as_port[n].detach() for n, _ in port.named_parameters()])
    want = dict(load_variables(BigGANEncoder(**ENC, img_size=16),
                               {**e_big, "params": jax.tree.map(np.asarray, jparams)}).named_parameters())
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].detach().numpy(), **TOL, err_msg=name)


def test_lreq_adam_applies_grad_or_handed_gradients():
    p = torch.nn.Parameter(torch.ones(3))
    opt = LREQAdam([p], lr=0.1, coefs=[2.0])
    p.grad = torch.tensor([1.0, -1.0, 0.0])
    opt.step()
    # first update: lr * sqrt(1 - 0.99) * c * g / (sqrt(0.01 g^2) + eps) = lr * c * sign(g)
    torch.testing.assert_close(p.detach(), torch.tensor([0.8, 1.2, 1.0]), rtol=0, atol=1e-6)
    opt.step([None])  # a zero gradient leaves p where it is
    torch.testing.assert_close(p.detach(), torch.tensor([0.8, 1.2, 1.0]), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="gradients for"):
        opt.step([None, None])
    with pytest.raises(ValueError, match="coefficients"):
        LREQAdam([p], lr=0.1, coefs=[1.0, 2.0])


@pytest.mark.parametrize("n_iter", [1, 3])
def test_power_iterate_matches(e_big, n_iter):
    port = load_variables(BigGANEncoder(**ENC, img_size=16), e_big)
    want = jpower_iterate(e_big["params"], e_big["sn"], n_iter=n_iter)
    power_iterate(port, n_iter=n_iter)
    as_port = dict(load_variables(BigGANEncoder(**ENC, img_size=16),
                                  {**e_big, "sn": jax.tree.map(np.asarray, want)}).named_buffers())
    count = 0
    for name, buf in port.named_buffers():
        if name.endswith((".u", ".v")):
            np.testing.assert_allclose(buf.numpy(), as_port[name].numpy(), **TOL, err_msg=name)
            count += 1
    assert count == 2 * sum(isinstance(m, SNDense) for m in port.modules()) > 0
    before = [p.clone() for p in port.parameters()]
    power_iterate(port)
    assert all(torch.equal(a, b) for a, b in zip(before, port.parameters()))


def test_sndense_gradient_flows_through_sigma(rng):
    layer = SNDense(6, 4)
    x = torch.from_numpy(rng.randn(3, 6).astype(np.float32))
    layer(x).sum().backward()
    w = layer.weight.detach().clone().requires_grad_()
    sigma = layer.u @ w @ layer.v
    (x @ (w / sigma).t()).sum().backward()
    torch.testing.assert_close(layer.weight.grad, w.grad)
    assert layer.u.grad is None and layer.v.grad is None
