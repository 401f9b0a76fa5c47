"""tpugan_torch's SAGAN attention backward vs tpugan (CPU), and the gradient
routes of the CUDA entry points.

The plain flash backward is held to the Pallas backward kernel in interpret
mode on tests/test_attention.py's case, and the differentiable
``sagan_attention`` to ``jax.vjp`` of tpugan's XLA form, at
tests/test_attention.py:78's 2e-4. The CUDA entry points cannot run here, so
the route tests swap each kernel wrapper for its plain version, after the
wrapper's own argument checks, with an output that carries no gradient, as
the kernels' outputs do; the dispatchers are told the tensors are on the
card. That is the route a CUDA tensor takes. The kernels' 3xTF32 arithmetic
is emulated here and held to the backward's contract.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_biggan import nchw, nhwc, randomized
from tpugan.models.biggan import SelfAttn as JSelfAttn
from tpugan.ops.attention import _attention_xla
from tpugan.ops.pallas.attention import sagan_attention_bwd_pallas, sagan_attention_pallas
from tpugan_torch.io.bridge import load_variables
from tpugan_torch.models import SelfAttn
from tpugan_torch.ops import attention, cuda, upfirdn

torch.set_num_threads(1)

BWD_TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_attention.py:78


def qkv(rng, q_shape, k_shape, v_shape, scale=1.0):
    q = rng.randn(*q_shape).astype(np.float32) * scale
    k = rng.randn(*k_shape).astype(np.float32) * scale
    v = rng.randn(*v_shape).astype(np.float32)
    return q, k, v


def test_plain_backward_matches_pallas_backward(rng):
    """tests/test_attention.py:59-80's case: several q and k tiles, a
    non-trivial upstream gradient."""
    q, k, v = qkv(rng, (2, 256, 16), (2, 384, 16), (2, 384, 32), scale=2.0)
    do = rng.randn(2, 256, 32).astype(np.float32)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    out, lse = sagan_attention_pallas(jq, jk, jv, block_q=128, block_k=128, interpret=True,
                                      return_lse=True)
    want = sagan_attention_bwd_pallas(jq, jk, jv, out, lse, jdo, block_q=128, block_k=128,
                                      interpret=True)
    t = [torch.from_numpy(np.asarray(x)) for x in (q, k, v, out, lse, do)]
    got = attention.sagan_attention_bwd_plain(*t)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **BWD_TOL, err_msg=name)


# the contract case, lengths that are not multiples of 128, one key, widths
# that are not multiples of 4, and dk 128 with dv 256
GRAD_CASES = [
    ((2, 256, 16), (2, 384, 16), (2, 384, 32), 2.0),
    ((1, 37, 8), (1, 19, 8), (1, 19, 24), 2.0),
    ((1, 5, 4), (1, 1, 4), (1, 1, 4), 1.0),
    ((1, 50, 13), (1, 33, 13), (1, 33, 30), 1.0),
    ((1, 20, 128), (1, 9, 128), (1, 9, 256), 0.3),
]


@pytest.mark.parametrize("shapes", GRAD_CASES, ids=lambda s: "x".join(map(str, s[0][1:] + s[2][1:])))
def test_function_grads_match_jax_vjp(rng, shapes):
    q, k, v = qkv(rng, *shapes[:3], scale=shapes[3])
    do = rng.randn(q.shape[0], q.shape[1], v.shape[2]).astype(np.float32)
    ref, vjp = jax.vjp(_attention_xla, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = attention.sagan_attention(*t)
    assert out.grad_fn is not None and type(out.grad_fn).__name__ == "_SaganAttentionBackward"
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)
    got = torch.autograd.grad(out, t, torch.from_numpy(do))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **BWD_TOL, err_msg=name)


def test_selfattn_grads_match_with_nonzero_gamma(rng):
    """Gradients of a SelfAttn with gamma 1.0 with respect to its input and
    its four convs, against tpugan's."""
    x = rng.randn(2, 8, 8, 16).astype(np.float32)
    ct = rng.randn(2, 8, 8, 16).astype(np.float32)
    jattn = JSelfAttn(16)
    variables = randomized(jattn.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng, scale=0.3)
    variables["params"]["gamma"] = np.ones(1, np.float32)

    def loss(params, x_):
        return jnp.sum(jattn.apply({"params": params}, x_) * ct)

    jgp, jgx = jax.grad(loss, argnums=(0, 1))(variables["params"], jnp.asarray(x))
    port = load_variables(SelfAttn(16), variables)
    xt = nchw(x).requires_grad_()
    (port(xt) * nchw(ct)).sum().backward()
    np.testing.assert_allclose(nhwc(xt.grad), np.asarray(jgx), **BWD_TOL)
    want = dict(load_variables(SelfAttn(16), {"params": jax.tree.map(np.asarray, jgp)}).named_parameters())
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].detach().numpy(), **BWD_TOL, err_msg=name)
    assert float(port.snconv1x1_theta.weight.grad.abs().max()) > 1e-3


def _detached_plain(check, plain):
    """A kernel wrapper's stand-in: the wrapper's own argument checks, then
    the plain version computed without a graph, as a kernel writes its
    result into a fresh tensor."""

    def fake(*args, **kwargs):
        check(*args[:6] if check is attention.check_attention_bwd_args else args[:3])
        with torch.no_grad():
            return plain(*args, **kwargs)

    return fake


def _plain_fir_launch(x, taps, up, down, pad0, ho, wo, key):
    """The FIR kernel's launch, swapped for the plain version after the
    launch's own checks: ho x wo outputs from front pad ``pad0`` (the back
    pads follow from ho and wo, as in the kernel), counted as the launch
    counts them."""
    upfirdn.check_launch(x, taps, up, down, pad0, ho, wo)
    (h, w), (kh, kw) = x.shape[2:], taps.shape
    pads = (pad0, (ho - 1) * down + kh - h * up - pad0, pad0, (wo - 1) * down + kw - w * up - pad0)
    with torch.no_grad():
        y = upfirdn._fir_plain(x, taps, up, down, pads)
    cuda.launches["upfirdn2d"] += 1
    upfirdn.layout_launches[key] += 1
    return y


@pytest.fixture
def on_card(monkeypatch):
    """Route CPU tensors the way CUDA tensors go: the dispatchers take the
    kernel wrappers (the FIR's launch), which are swapped for their plain
    versions and count their launches."""
    cuda.reset_launches()

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            out = fn(*args, **kwargs)
            cuda.launches[name] += 1
            return out

        return wrapper

    monkeypatch.setattr(attention, "_on_card", lambda x: True)
    monkeypatch.setattr(upfirdn, "_on_card", lambda x: True)
    monkeypatch.setattr(upfirdn, "_launch", _plain_fir_launch)
    upfirdn.reset_layout_launches()
    monkeypatch.setattr(attention, "sagan_attention_cuda", counted(
        "sagan_attention", _detached_plain(attention.check_attention_args, attention.sagan_attention_plain)))
    monkeypatch.setattr(attention, "sagan_attention_bwd_cuda", counted(
        "sagan_attention_bwd_dkv", _detached_plain(attention.check_attention_bwd_args,
                                                   attention.sagan_attention_bwd_plain)))
    yield
    cuda.reset_launches()


def test_cuda_route_carries_q_k_v_gradients(rng, on_card):
    """Through the CUDA entry points the attention's output has a graph and
    its q, k and v gradients are the plain autograd ones: the forward keeps
    the logsumexp and the backward is the flash backward. (A dispatcher that
    hands back the kernel's output directly leaves q, k and v without a
    gradient.)"""
    q, k, v = qkv(rng, (2, 40, 8), (2, 10, 8), (2, 10, 16), scale=2.0)
    do = torch.from_numpy(rng.randn(2, 40, 16).astype(np.float32))
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = attention.sagan_attention(*t)
    assert out.requires_grad
    got = torch.autograd.grad(out, t, do)
    ref = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(attention.sagan_attention_plain(*ref), ref, do)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **BWD_TOL, err_msg=name)
    assert cuda.launches["sagan_attention"] == 1 and cuda.launches["sagan_attention_bwd_dkv"] == 1
    with torch.no_grad():
        attention.sagan_attention(*t)  # no gradient wanted: the forward without lse
    assert cuda.launches["sagan_attention"] == 2 and cuda.launches["sagan_attention_bwd_dkv"] == 1


@pytest.mark.parametrize("route", ["cpu", "cuda"])
@pytest.mark.parametrize("wanted", ["q", "k", "v"])
def test_lse_form_refuses_a_gradient(rng, monkeypatch, route, wanted):
    """The ``(out, lse)`` form has no autograd graph, so when any one input
    wants a gradient it raises on either route instead of handing back
    outputs without one; under no_grad the same call runs."""
    if route == "cuda":
        monkeypatch.setattr(attention, "_on_card", lambda x: True)
        monkeypatch.setattr(attention, "sagan_attention_cuda",
                            _detached_plain(attention.check_attention_args, attention.sagan_attention_plain))
    t = dict(zip("qkv", (torch.from_numpy(a) for a in qkv(rng, (2, 12, 8), (2, 5, 8), (2, 5, 16)))))
    t[wanted].requires_grad_()
    with pytest.raises(ValueError, match="no gradient"):
        attention.sagan_attention(t["q"], t["k"], t["v"], return_lse=True)
    with torch.no_grad():
        out, lse = attention.sagan_attention(t["q"], t["k"], t["v"], return_lse=True)
    assert out.shape == (2, 12, 16) and lse.shape == (2, 12, 1) and out.grad_fn is None


def test_cuda_route_reaches_selfattn_weights(rng, on_card):
    """A SelfAttn on the CUDA route: theta, phi and g get the gradient they
    get from plain autograd on the CPU."""
    x = nchw(rng.randn(2, 8, 8, 16).astype(np.float32))
    layer = SelfAttn(16, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        layer.gamma.fill_(1.0)
    layer(x).square().sum().backward()
    routed = {n: p.grad.clone() for n, p in layer.named_parameters()}
    layer.zero_grad()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(attention, "_on_card", lambda x: False)
        layer(x).square().sum().backward()
    for name, p in layer.named_parameters():
        np.testing.assert_allclose(routed[name].numpy(), p.grad.numpy(), **BWD_TOL, err_msg=name)
    assert float(routed["snconv1x1_phi.weight"].abs().max()) > 1e-3


REFUSED = {
    "fp16_do": (lambda a: {**a, "do": a["do"].half()}, TypeError, "float32"),
    "non_contiguous_o": (lambda a: {**a, "o": a["o"].transpose(0, 1)}, ValueError, "contiguous"),
    "lse_width": (lambda a: {**a, "lse": a["lse"].expand(2, 8, 2).contiguous()}, ValueError, "do not fit"),
    "do_length": (lambda a: {**a, "do": a["do"][:, :4].contiguous()}, ValueError, "do not fit"),
    "dk_129": (lambda a: {**a, "q": a["q"].new_zeros(2, 8, 129), "k": a["k"].new_zeros(2, 4, 129)},
               ValueError, "dk 129"),
    "dv_257": (lambda a: {**a, "v": a["v"].new_zeros(2, 4, 257), "o": a["o"].new_zeros(2, 8, 257),
                          "do": a["do"].new_zeros(2, 8, 257)}, ValueError, "dv 257"),
    "empty": (lambda a: {**a, "q": a["q"][:, :0]}, ValueError, "empty"),
    "cpu_tensor": (lambda a: a, ValueError, "CUDA tensors"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_backward_wrapper_refuses_out_of_contract_input(rng, name):
    """The checks run before the device check, so they hold here too; a
    valid CPU tensor is refused last, for not being on the card."""
    q, k, v = (torch.from_numpy(a) for a in qkv(rng, (2, 8, 8), (2, 4, 8), (2, 4, 16)))
    o, lse = attention.sagan_attention_plain(q, k, v, return_lse=True)
    args = dict(q=q, k=k, v=v, o=o, lse=lse, do=torch.randn(2, 8, 16))
    change, error, match = REFUSED[name]
    with pytest.raises(error, match=match):
        attention.sagan_attention_bwd_cuda(**change(args))
    assert not any(cuda.launches.values())


def test_backward_kernels_are_registered_for_sm90a():
    names = ("sagan_attention_bwd_pack", "sagan_attention_bwd_dq", "sagan_attention_bwd_dkv")
    pack, dq, dkv = (cuda.KERNELS[name] for name in names)
    workspace = cuda.HELPERS["sagan_attention_bwd_workspace"]
    assert pack[0] == dq[0] == dkv[0] == workspace[0] == "sagan_attention_bwd.cu"
    assert len({cuda.library_path(name) for name in names + ("sagan_attention_bwd_workspace",)}) == 1
    assert cuda.library_path("sagan_attention_bwd_dq").name.startswith("libsagan_attention_bwd-")
    text = (cuda.CSRC / dq[0]).read_text()
    for symbol in (pack[1], dq[1], dkv[1]):
        assert f'extern "C" int {symbol}' in text
    assert f'extern "C" int64_t {workspace[1]}' in text
    assert f"kMaxDk = {attention.MAX_DK}" in text and f"kMaxDv = {attention.MAX_DV}" in text
    shared = (cuda.CSRC / "tf32_wgmma.cuh").read_text()  # the wgmma and 3xTF32 pieces B3 shares
    assert '#include "tf32_wgmma.cuh"' in text and "wgmma.mma_async" in shared
    assert "sagan_attention_bwd_pallas" in text and "mma.sync" not in text + shared
    assert f"kDkvKeys = {attention.SCRATCH_KEYS};" in text and f"kDkvRows = {attention.SCRATCH_ROWS};" in text
    # pointers (5, 6, 3), 6 ints and the stream; the workspace's size from 5 ints
    assert (len(pack[2]), len(dq[2]), len(dkv[2]), len(workspace[2])) == (12, 13, 10, 5)
    assert "sagan_attention_bwd_workspace" not in cuda.launches


# ---- the kernels' 3xTF32 arithmetic, emulated ---------------------------------
#
# csrc/sagan_attention_bwd.cu forms every product on the tensor cores as
# lo_a hi_b + hi_a lo_b + hi_a hi_b, with hi = x rounded to TF32 to nearest
# (ties away from zero, as cvt.rna.tf32.f32) and lo = x - hi, of which the
# tensor cores read the top 10 mantissa bits (toward zero). The emulation
# forms the split products exactly (float64) so that what it shows is the
# split's precision: that it holds the backward's contract against the plain
# version, where one TF32 pass does not.


def _tf32(x: torch.Tensor, nearest: bool) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits): to nearest with ties away from
    zero (half a TF32 ulp added to the magnitude, the 13 low bits cleared),
    or toward zero (the low bits cleared)."""
    bits = x.contiguous().view(torch.int32)
    if nearest:
        bits = bits + 0x1000
    return (bits & ~0x1FFF).view(torch.float32)


def _mm(a, b, passes, lo_nearest):
    """a @ b (fp32 [N, M, K] @ [N, K, P]) from TF32 products: one pass
    (hi hi) or three (lo hi + hi lo + hi hi), each exact, summed in float64
    and rounded to fp32."""
    hi_a, hi_b = _tf32(a, True), _tf32(b, True)
    mm = lambda x, y: torch.bmm(x.double(), y.double())  # noqa: E731
    if passes == 1:
        return mm(hi_a, hi_b).float()
    lo_a, lo_b = _tf32(a - hi_a, lo_nearest), _tf32(b - hi_b, lo_nearest)
    return (mm(lo_a, hi_b) + mm(hi_a, lo_b) + mm(hi_a, hi_b)).float()


def _tf32_bwd(q, k, v, o, lse, do, passes=3, lo_nearest=False):
    """The backward as the kernels compute it: the five products in TF32
    passes, exp, delta and the masks in fp32."""
    mm = lambda a, b: _mm(a, b, passes, lo_nearest)  # noqa: E731
    p = torch.exp(mm(q, k.transpose(1, 2)) - lse)
    delta = (do * o).sum(-1, keepdim=True)
    ds = p * (mm(do, v.transpose(1, 2)) - delta)
    return mm(ds, k), mm(ds.transpose(1, 2), q), mm(p.transpose(1, 2), do)


def _bwd_errors(rng, shapes):
    """(emulated, plain, summed terms) per gradient, as chip_smoke.py's
    compare_attention_bwd holds them."""
    q, k, v = (torch.from_numpy(a) for a in qkv(rng, *shapes[:3], scale=shapes[3]))
    do = torch.from_numpy(rng.randn(q.shape[0], q.shape[1], v.shape[2]).astype(np.float32))
    o, lse = attention.sagan_attention_plain(q, k, v, return_lse=True)
    p = torch.exp(torch.bmm(q, k.transpose(1, 2)) - lse)
    ds_terms = p * (torch.bmm(do.abs(), v.abs().transpose(1, 2)) + (do * o).sum(-1, keepdim=True).abs())
    terms = (torch.bmm(ds_terms, k.abs()), torch.bmm(ds_terms.transpose(1, 2), q.abs()),
             torch.bmm(p.transpose(1, 2), do.abs()))
    return (q, k, v, o, lse, do), attention.sagan_attention_bwd_plain(q, k, v, o, lse, do), terms


BWD_MAX_SHARE = 1e-3  # chip_smoke.py: max |err| of a gradient over the size of its summed terms
# tests/test_attention.py:59-80's case, odd lengths, and BigGAN-128's attention
# layer (64 x 64 positions, keys max-pooled to 32 x 32; dk 32, dv 128)
TF32_CASES = [
    ((2, 256, 16), (2, 384, 16), (2, 384, 32), 2.0),
    ((1, 37, 8), (1, 19, 8), (1, 19, 24), 2.0),
    ((1, 50, 13), (1, 33, 13), (1, 33, 30), 1.0),
    ((1, 4096, 32), (1, 1024, 32), (1, 1024, 128), 1.0),
]


@pytest.mark.parametrize("lo_nearest", [False, True], ids=["lo_toward_zero", "lo_nearest"])
@pytest.mark.parametrize("shapes", TF32_CASES, ids=lambda s: "x".join(map(str, s[0][1:] + s[2][1:])))
def test_3xtf32_products_hold_the_backward_contract(rng, shapes, lo_nearest):
    """Three TF32 passes meet BWD_TOL and BWD_MAX_SHARE against the plain
    version, with lo read toward zero (as the kernels feed it) or rounded
    to nearest (cvt.rna.tf32.f32)."""
    args, want, terms = _bwd_errors(rng, shapes)
    got = _tf32_bwd(*args, passes=3, lo_nearest=lo_nearest)
    for name, g, w, t in zip(("dq", "dk", "dv"), got, want, terms):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **BWD_TOL, err_msg=name)
        assert float((g - w).abs().max()) <= BWD_MAX_SHARE * float(t.max()), name


def test_one_tf32_pass_misses_the_backward_contract(rng):
    """The same comparison has teeth: one TF32 pass (hi hi only) misses
    BWD_TOL at BigGAN-128's widths."""
    args, want, _ = _bwd_errors(rng, TF32_CASES[-1])
    got = _tf32_bwd(*args, passes=1)
    worst = max(float(((g - w).abs() - BWD_TOL["rtol"] * w.abs()).max()) for g, w in zip(got, want))
    assert worst > 10 * BWD_TOL["atol"]


def test_tf32_rounding_is_cvt_rna():
    """_tf32's nearest rounding: ties away from zero, carries into the
    exponent, leaves TF32 values alone."""
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2.0 ** -23, 2 - ulp / 2, 1 + ulp, 0.0])
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 2.0, 1 + ulp, 0.0])
    assert torch.equal(_tf32(x, True), want)
    assert torch.equal(_tf32(x[:1], False), torch.tensor([1.0]))
