"""The FIR's gradient: tpugan_torch's upfirdn2d adjoint vs tpugan (CPU).

The same seeded numpy inputs and output gradients go through ``jax.vjp`` of
tpugan's ``upfirdn2d`` (its custom VJP: the adjoint FIR, through its XLA
form or, in one group, the Pallas kernels in interpret mode as
tests/test_pallas_kernels.py runs them) and through ``torch.autograd`` of
the port's, within the FIR's own 1e-5 (tests/test_pallas_kernels.py:28).
Kernels with kh != kw are held to autograd of the plain version instead:
tpugan's VJP takes the front pad of both axes from kh, which is wrong there
(shown below). The CUDA route runs with the kernel's launch swapped for its
plain version after its checks (``on_card``), and one slice-level case
takes an MSE's gradient through SGv1 G -> E_Blur -> G.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_attention_bwd import on_card  # noqa: F401 (a fixture)
from test_torch_models import draw, nchw, nhwc, randomized
from tpugan.models.encoders import Encoder as JEncoder
from tpugan.models.stylegan1 import StyleGANv1Generator as JGenerator
from tpugan.ops import upfirdn as jfir
from tpugan_torch.io.bridge import load_variables
from tpugan_torch.models import Encoder, StyleGANv1Generator
from tpugan_torch.ops import cuda, upfirdn

torch.set_num_threads(1)

FIR_TOL = dict(rtol=1e-5, atol=1e-5)  # tests/test_pallas_kernels.py:28
# tests/test_stylegan1.py:134, through two generator passes and the encoder
SLICE_TOL = dict(rtol=2e-3, atol=2e-4)

TAPS = {1: (1,), 3: (1, 2, 1), 4: (1, 3, 3, 1), 8: (1, 7, 21, 35, 35, 21, 7, 1)}
SHAPES = {"odd_h_non_square": (2, 7, 10, 3), "even_square": (1, 8, 8, 2)}


def jax_grad(x, ct, fir):
    out, vjp = jax.vjp(fir, jnp.asarray(x))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(ct))[0])


def port_grad(x, ct, fir):
    xt = nchw(x).requires_grad_()
    y = fir(xt)
    assert type(y.grad_fn).__name__ == "_UpFirDn2dBackward"
    (gx,) = torch.autograd.grad(y, xt, nchw(ct))
    return nhwc(y), nhwc(gx)


def check_against_tpugan(rng, shape, taps, up, down, pad, gain, use_pallas=False):
    x = rng.randn(*shape).astype(np.float32)
    k = jfir.setup_fir_kernel(taps)
    n, h, w, c = shape
    ho = (h * up + sum(pad) - k.shape[0]) // down + 1
    wo = (w * up + sum(pad) - k.shape[1]) // down + 1
    ct = rng.randn(n, ho, wo, c).astype(np.float32)
    ref, want = jax_grad(x, ct, lambda a: jfir.upfirdn2d(a, k, up, down, pad, gain, use_pallas=use_pallas))
    out, got = port_grad(x, ct, lambda a: upfirdn.upfirdn2d(a, k, up, down, pad, gain))
    np.testing.assert_allclose(out, ref, **FIR_TOL)
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, **FIR_TOL)
    return got


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("ntaps", sorted(TAPS))
@pytest.mark.parametrize("up,down", [(1, 1), (2, 1), (1, 2), (2, 2)])
def test_grad_matches_jax_vjp(rng, up, down, ntaps, shape):
    """Every (up, down), 1- to 8-tap square kernels, gain 1 (same size,
    down 2) and 4 (up 2, as upsample_fir), odd and even, square and
    non-square images; pads as upsample_fir and downsample_fir give."""
    p = ntaps - max(up, down)
    pad = ((p + 1) // 2 + up - 1, p // 2) if p >= 0 else (0, 0)
    check_against_tpugan(rng, SHAPES[shape], TAPS[ntaps], up, down, pad, float(up * up))


# pads past the taps: the adjoint's front pad kh - 1 - pad0 is negative.
# XLA's CPU convolution returns values near 1e30 for some negative pads of
# tpugan's VJP and of its own autodiff (4 taps at pad (5, 0) with up 2, 3
# taps at (3, 0) with up 2), where the port agrees with plain autograd; the
# pads here are ones it computes.
@pytest.mark.parametrize("up,down", [(1, 1), (2, 1), (1, 2), (2, 2)])
@pytest.mark.parametrize("ntaps,pad", [(1, (2, 1)), (3, (4, 3)), (4, (5, 3)), (8, (9, 7))],
                         ids=["1_tap", "3_taps", "4_taps", "8_taps"])
def test_grad_with_negative_adjoint_pad_matches_jax_vjp(rng, up, down, ntaps, pad):
    assert ntaps - 1 - pad[0] < 0
    check_against_tpugan(rng, (1, 9, 6, 2), TAPS[ntaps], up, down, pad, 1.0)


@pytest.mark.parametrize("kernel,up,down,taps,pad,shape", [
    ("B1", 1, 1, (1, 2, 1), (1, 1), (1, 8, 8, 128)),
    ("B1", 1, 2, (1, 3, 3, 1), (1, 1), (1, 8, 8, 128)),
    ("B2", 1, 1, (1, 2, 1), (1, 1), (2, 8, 8, 16)),
])
def test_grad_matches_jax_vjp_through_pallas(rng, monkeypatch, kernel, up, down, taps, pad, shape):
    """tpugan's forward and its adjoint both through the Pallas kernel its
    dispatch picks, in interpret mode; the port's adjoint is counted under
    the same kernel."""
    from tpugan.ops.pallas import upfirdn2d as mod

    took = []
    for name, key in (("upfirdn2d_pallas", "B1"), ("upfirdn2d_pallas_small_c", "B2")):
        real = functools.partial(getattr(mod, name), interpret=True)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _k=key, **kw: took.append(_k) or _r(*a, **kw))
    check_against_tpugan(rng, shape, taps, up, down, pad, 1.0, use_pallas=True)
    assert took == [kernel, kernel]


# kh != kw: (taps, up, down, pad), NHWC (2, 9, 7, 3)
RECT_CASES = {
    "3x2_up2": (((1, 2), (3, 1), (0, 2)), 2, 1, (1, 1)),
    "2x5_down2": (((1, 2, 0, -1, 3), (2, 4, 1, 0, 1)), 1, 2, (2, 1)),
    "3x5": (((1, 2, 0, -1, 3), (2, 4, 1, 0, 1), (0, 1, 5, 2, 1)), 1, 1, (2, 3)),
    "1x4_up2_down2": (((1, 3, 3, 1),), 2, 2, (2, 1)),
    "4x1_pad_past_taps": (((1,), (3,), (3,), (1,)), 1, 1, (5, 2)),
}


@pytest.mark.parametrize("name", sorted(RECT_CASES))
def test_grad_with_kh_unlike_kw_matches_plain_autograd(rng, name):
    """Held to torch.autograd of upfirdn2d_plain and to jax.vjp of tpugan's
    _upfirdn2d_xla (plain autodiff, no custom VJP): tpugan's own VJP is
    wrong for these kernels (next test)."""
    taps, up, down, pad = RECT_CASES[name]
    k = np.asarray(taps, np.float32) / np.sum(taps)
    x = rng.randn(2, 9, 7, 3).astype(np.float32)
    ref = upfirdn.upfirdn2d_plain(nchw(x), k, up, down, pad, 4.0)
    ct = rng.randn(*nhwc(ref).shape).astype(np.float32)
    xr = nchw(x).requires_grad_()
    (want,) = torch.autograd.grad(upfirdn.upfirdn2d_plain(xr, k, up, down, pad, 4.0), xr, nchw(ct))
    out, got = port_grad(x, ct, lambda a: upfirdn.upfirdn2d(a, k, up, down, pad, 4.0))
    np.testing.assert_allclose(out, nhwc(ref), **FIR_TOL)
    np.testing.assert_allclose(got, nhwc(want), **FIR_TOL)
    _, autodiff = jax_grad(x, ct, lambda a: jfir._upfirdn2d_xla(a, k, up, down, pad, 4.0))
    np.testing.assert_allclose(got, autodiff, **FIR_TOL)


def test_tpugan_vjp_is_wrong_where_kh_unlike_kw():
    """A fault of the reference, logged in ROADMAP.md: tpugan's custom VJP
    (tpugan/ops/upfirdn.py:115-139) pads W's front with kh - 1 - pad0, not
    kw - 1 - pad0. With a 3x2 kernel at up 2 its gradient is far from
    autodiff of its own XLA form, which the port matches (test above)."""
    rng = np.random.RandomState(0)
    k = rng.rand(3, 2).astype(np.float32)
    x = rng.randn(1, 9, 9, 2).astype(np.float32)
    fir = functools.partial(jfir.upfirdn2d, kernel=k, up=2, pad=(1, 1), use_pallas=False)
    ct = rng.randn(*fir(jnp.asarray(x)).shape).astype(np.float32)
    _, tpugan_vjp = jax_grad(x, ct, lambda a: fir(a))
    _, autodiff = jax_grad(x, ct, lambda a: jfir._upfirdn2d_xla(a, k, 2, 1, (1, 1), 1.0))
    assert np.abs(tpugan_vjp - autodiff).max() > 1.0
    _, port = port_grad(x, ct, lambda a: upfirdn.upfirdn2d(a, k, 2, 1, (1, 1)))
    np.testing.assert_allclose(port, autodiff, **FIR_TOL)


# (label, taps, up, down, pad, NHWC shape, forward's TPU kernel, adjoint's)
ROUTE_CASES = [
    ("blur_B1", (1, 2, 1), 1, 1, (1, 1), (1, 8, 8, 128), "B1", "B1"),
    ("blur_B2_non_square", (1, 2, 1), 1, 1, (1, 1), (2, 9, 6, 16), "B2", "B2"),
    ("down2_back_pads_differ", (1, 3, 3, 1), 1, 2, (1, 1), (2, 9, 8, 128), "B1", "XLA"),
    ("up2_4_taps", (1, 3, 3, 1), 2, 1, (2, 1), (2, 5, 7, 3), "XLA", "XLA"),
    ("down2_B1", (1, 3, 3, 1), 1, 2, (1, 1), (1, 8, 8, 128), "B1", "B1"),
    ("pad_past_taps", (1, 2, 1), 1, 1, (4, 3), (1, 6, 6, 16), "B2", "XLA"),
    ("taps_3x2_up2", ((1, 2), (3, 1), (0, 2)), 2, 1, (1, 1), (1, 5, 6, 3), "XLA", "XLA"),
]


@pytest.mark.parametrize("case", ROUTE_CASES, ids=lambda c: c[0])
def test_cuda_route_carries_the_gradient(rng, on_card, case):  # noqa: F811
    """Through the CUDA route the FIR's output has a graph, x gets the
    plain autograd gradient, and the adjoint is one more launch of the
    kernel, counted under the TPU kernel tpugan's VJP runs (its own FIR when
    the pads of H and W agree and none is negative, else its XLA form)."""
    _, taps, up, down, pad, shape, fwd_key, adj_key = case
    k = np.asarray(taps, np.float32)
    k = np.outer(k, k) if k.ndim == 1 else k
    k = k / k.sum()
    x = rng.randn(*shape).astype(np.float32)
    xt = nchw(x).requires_grad_()
    y = upfirdn.upfirdn2d(xt, k, up, down, pad, 4.0)
    assert y.requires_grad and cuda.launches["upfirdn2d"] == 1
    ct = torch.from_numpy(rng.randn(*y.shape).astype(np.float32))
    (got,) = torch.autograd.grad(y, xt, ct)
    xr = nchw(x).requires_grad_()
    (want,) = torch.autograd.grad(upfirdn.upfirdn2d_plain(xr, k, up, down, pad, 4.0), xr, ct)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **FIR_TOL)
    assert cuda.launches["upfirdn2d"] == 2 and sum(cuda.launches.values()) == 2
    keys = {"B1": 0, "B2": 0, "XLA": 0}
    keys[fwd_key] += 1
    keys[adj_key] += 1
    assert upfirdn.layout_launches == keys


def test_cuda_route_blur_needs_no_copy(rng, on_card, monkeypatch):  # noqa: F811
    """The 3x3 blur at pad (1, 1) is its own adjoint: the gradient goes to
    the kernel as it is (up 1, front pad 1, its own size), with no
    stuffing or padding in torch."""
    launched = []
    real = upfirdn._launch
    monkeypatch.setattr(upfirdn, "_launch", lambda x, *a: launched.append((x.shape, a[1:5])) or real(x, *a))
    xt = nchw(rng.randn(2, 16, 16, 8).astype(np.float32)).requires_grad_()
    upfirdn.blur3x3(xt).square().sum().backward()
    assert xt.grad.shape == xt.shape and cuda.launches["upfirdn2d"] == 2
    assert launched == [(xt.shape, (1, 1, 1, 16))] * 2  # (up, down, front pad, rows out)


def test_slice_gradient_matches_jax_grad(rng):
    """The gradient of an MSE through SGv1 G -> E_Blur (use_blur=True, the
    case-2 encoder: a blur in every block) -> G, with respect to the
    encoder's parameters and the first pass's styles, against jax.grad of
    tpugan's same modules."""
    kw = dict(startf=16, maxf=64, layer_count=3, latent_size=32)
    styles = rng.randn(2, 6, 32).astype(np.float32)
    target = rng.randn(2, 16, 16, 3).astype(np.float32)
    gen, enc = StyleGANv1Generator(**kw), Encoder(**kw, use_blur=True)
    ng1, ng1_j = draw(gen.noise_shapes(2), rng)
    ng2, ng2_j = draw(gen.noise_shapes(2), rng)
    ne, ne_j = draw(enc.noise_shapes(2, 16), rng)
    jg, je = JGenerator(**kw), JEncoder(**kw, use_blur=True)
    gv = randomized(jg.init(jax.random.PRNGKey(1), jnp.asarray(styles), 2, 1.0, ng1_j), rng)
    ev = randomized(je.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(target), 0, ne_j), rng)

    def jloss(eparams, s):
        img1 = jg.apply(gv, s, 2, 1.0, ng1_j)
        _, w = je.apply({**ev, "params": eparams}, img1, 0, ne_j)
        img2 = jg.apply(gv, w, 2, 1.0, ng2_j)
        return jnp.mean((img2 - target) ** 2)

    jgp, jgs = jax.jit(jax.grad(jloss, argnums=(0, 1)))(ev["params"], jnp.asarray(styles))
    load_variables(gen, gv, unused=("to_rgb_0", "to_rgb_1"))
    load_variables(enc, ev)
    for p in gen.parameters():
        p.requires_grad_(False)
    st = torch.from_numpy(styles).requires_grad_()
    _, w = enc(gen(st, 2, ng1), ne)
    loss = (gen(w, 2, ng2) - nchw(target)).square().mean()
    loss.backward()
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(jgs), **SLICE_TOL)
    want = dict(load_variables(Encoder(**kw, use_blur=True),
                               {**ev, "params": jax.tree.map(np.asarray, jgp)}).named_parameters())
    for name, p in enc.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].detach().numpy(), **SLICE_TOL, err_msg=name)
    assert float(enc.from_rgb.weight.grad.abs().max()) > 0
