"""tpugan_torch's bf16 scheme (``tpugan_torch/precision.py``, ``e_align
--bf16``) against tpugan's (``tpugan/precision.py``) on the CPU.

* The FIR's bf16 form: the plain version against tpugan's Pallas kernels in
  interpret mode on the same bf16 input, at ``tests/test_pallas_kernels.py``'s
  contract cases, and its adjoint against ``jax.vjp`` of tpugan's upfirdn2d
  in bf16: exact, or within one bf16 ulp where the fp32 sums are taken in
  another order (``assert_within_one_bf16_ulp``); the card's route on bf16
  tensors (the launch swapped for the plain version after its checks).
* The wrappers: fp32 outputs, fp32 gradients on the fp32 master parameters.
* The bf16 SGv1 and SG2 pipelines and one bf16 case-2 step at
  ``tests/test_bf16.py``'s ``_sg2_setup`` sizes, against tpugan's bf16 run
  on the same bridged weights and injected inputs, tpugan's side under
  ``jax.jit`` as its CLI and train step run it (XLA rewrites a jitted
  program, e.g. a scaled weight's scale moved past its matmul, so its bf16
  roundings differ from an op-by-op run's, by as much as the port's differ
  from either). Stated tolerance
  (``assert_as_close_as_tpugan``): the port's bf16 error from tpugan's fp32
  run is at most twice tpugan's own bf16 error from it. tpugan's gates hold
  on the port too: images within 0.05 (SG2) and 0.08 (SGv1) of their scale,
  the step's loss_tsa within 3% of fp32.
* The CLI at a tiny size (mtype 4's bf16 against tpugan in
  tests/test_torch_attention_bf16.py).

Injected noise is drawn with numpy and rounded to bf16 once, so that every
run reads the same values: tpugan draws noise in the activations' dtype,
the port casts the noise it is given into it.
"""

import copy
import inspect
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fir_plan import assert_within_one_bf16_ulp
from test_torch_sgv1_train import _recording, nonzero_leaves
from test_torch_stylegan2 import lively
from test_torch_train import CFG as BIGGAN_CFG
from tpugan import precision as jprecision
from tpugan.losses.lpips import make_lpips_fn as jmake_lpips_fn
from tpugan.losses.lpips import random_params as jlpips_params
from tpugan.models import Encoder as JEncoder
from tpugan.models import StyleGAN2Generator as JStyleGAN2Generator
from tpugan.models import StyleGANv1Generator as JStyleGANv1Generator
from tpugan.models import StyleGANv1Mapping as JStyleGANv1Mapping
from tpugan.ops import upfirdn as jfir
from tpugan.ops.eq_lr import lreq_coef_tree
from tpugan.ops.pallas.upfirdn2d import upfirdn2d_pallas, upfirdn2d_pallas_small_c
from tpugan.optim import lreq_adam as jlreq_adam
from tpugan.train.e_align import SynthBatch as JSynthBatch
from tpugan.train.e_align import info_scalars as jinfo_scalars
from tpugan.train.e_align import init_train_state as jinit_train_state
from tpugan.train.e_align import make_train_step as jmake_train_step
from tpugan_torch import precision
from tpugan_torch.cli import e_align
from tpugan_torch.io.bridge import load_variables
from tpugan_torch.losses.lpips import LPIPS, make_lpips_fn, random_lpips_fn
from tpugan_torch.models import (
    BigGANConfig,
    Encoder,
    StyleGAN2Generator,
    StyleGANv1Generator,
    StyleGANv1Mapping,
)
from tpugan_torch.ops import cuda, upfirdn
from tpugan_torch.optim import lreq_adam
from tpugan_torch.train.e_align import (
    Request,
    SynthBatch,
    build_stylegan1_pipeline,
    build_stylegan2_pipeline,
    init_train_state,
    info_scalars,
    make_encode_fn,
    make_train_step,
)

torch.set_num_threads(1)

BF = jnp.bfloat16


def bf16_values(x):
    """numpy draws rounded to bf16 once, kept as float32."""
    return np.array(jnp.asarray(x, BF).astype(jnp.float32))


def to_np(x):
    return np.asarray(x.detach().float().numpy() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x).astype(jnp.float32))


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def nhwc(x):
    return np.asarray(x).transpose(0, 2, 3, 1)


def assert_as_close_as_tpugan(port16, jax16, jax32, what, factor=2.0):
    """The port's bf16 result is no farther from tpugan's fp32 one than
    ``factor`` times tpugan's own bf16 result is (max |err| over the
    arrays); returns both errors."""
    port16, jax16, jax32 = (np.asarray(a, np.float64) for a in (port16, jax16, jax32))
    assert port16.shape == jax32.shape == jax16.shape
    mine = float(np.abs(port16 - jax32).max())
    theirs = float(np.abs(jax16 - jax32).max())
    assert theirs > 0, f"{what}: tpugan's bf16 run equals its fp32 run"
    assert mine <= factor * theirs, f"{what}: port bf16 {mine:.3e} from tpugan fp32, tpugan bf16 {theirs:.3e}"
    return mine, theirs


# ---------------------------------------------------------------------------
# (a) the FIR's bf16 form

B1_CASES = [  # tests/test_pallas_kernels.py
    (1, 1, (1, 2, 1), (1, 1), (2, 8, 8, 4)),
    (1, 1, (1, 2, 1), (1, 1), (1, 16, 12, 8)),
    (2, 1, (1, 3, 3, 1), (3, 1), (2, 8, 8, 4)),
    (1, 2, (1, 3, 3, 1), (1, 1), (2, 16, 16, 4)),
    (1, 1, (1, 3, 3, 1), (2, 1), (1, 8, 8, 4)),
    (2, 1, (1, 2, 1), (2, 0), (1, 6, 6, 2)),
]
B2_CASES = [
    ((1, 2, 1), (1, 1), (2, 16, 16, 16)),
    ((1, 3, 3, 1), (2, 1), (1, 32, 24, 8)),
    ((1, 2, 1), (1, 1), (2, 9, 11, 4)),
]


def _bf16_input(rng, shape):
    """A bf16 NHWC input for tpugan and the same values NCHW for the port."""
    xj = jnp.asarray(rng.randn(*shape).astype(np.float32), BF)
    return xj, nchw(np.asarray(xj.astype(jnp.float32))).bfloat16()


@pytest.mark.parametrize("up,down,taps,pad,shape", B1_CASES)
def test_fir_bf16_plain_matches_pallas(rng, up, down, taps, pad, shape):
    xj, xt = _bf16_input(rng, shape)
    k = jfir.setup_fir_kernel(taps)
    ref = upfirdn2d_pallas(xj, k, up=up, down=down, pad=pad, interpret=True)
    got = upfirdn.upfirdn2d_plain(xt, k, up, down, pad)
    assert ref.dtype == BF and got.dtype == torch.bfloat16
    assert_within_one_bf16_ulp(got, nchw(to_np(ref)))


def test_fir_bf16_plain_matches_pallas_tiled(rng):
    """Several row tiles (tests/test_pallas_kernels.py's tiled case)."""
    from tpugan.ops.pallas import upfirdn2d as mod

    xj, xt = _bf16_input(rng, (1, 32, 8, 4))
    k = jfir.setup_fir_kernel((1, 3, 3, 1))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, "_pick_tile_h", lambda *a, **kw: 4)
        ref = upfirdn2d_pallas(xj, k, up=2, down=1, pad=(3, 1), interpret=True)
    assert_within_one_bf16_ulp(upfirdn.upfirdn2d_plain(xt, k, 2, 1, (3, 1)), nchw(to_np(ref)))


@pytest.mark.parametrize("taps,pad,shape", B2_CASES)
def test_fir_bf16_plain_matches_pallas_small_c(rng, taps, pad, shape):
    xj, xt = _bf16_input(rng, shape)
    k = jfir.setup_fir_kernel(taps)
    ref = upfirdn2d_pallas_small_c(xj, k, pad=pad, interpret=True)
    assert ref.dtype == BF
    assert_within_one_bf16_ulp(upfirdn.upfirdn2d_plain(xt, k, 1, 1, pad), nchw(to_np(ref)))


@pytest.mark.parametrize("up,down,taps,pad,shape", B1_CASES)
def test_fir_bf16_is_the_fp32_fir_rounded_once(rng, up, down, taps, pad, shape):
    """fp32 taps and sums, one rounding: the bf16 FIR is the fp32 FIR of
    the same values, rounded to bf16, exactly."""
    _, xt = _bf16_input(rng, shape)
    k = jfir.setup_fir_kernel(taps)
    got = upfirdn.upfirdn2d_plain(xt, k, up, down, pad, gain=4.0)
    want = upfirdn.upfirdn2d_plain(xt.float(), k, up, down, pad, gain=4.0).bfloat16()
    assert torch.equal(got, want)


@pytest.mark.parametrize("up,down,taps,pad,shape", B1_CASES + [(1, 1, (1, 3, 3, 1), (1, 1), (2, 9, 9, 3))])
def test_fir_bf16_adjoint_matches_jax_vjp(rng, up, down, taps, pad, shape):
    """The gradient of a bf16 FIR (its adjoint, in the cotangent's dtype)
    against jax.vjp of tpugan's upfirdn2d in bf16, and the forward too."""
    xj, xt = _bf16_input(rng, shape)
    k = jfir.setup_fir_kernel(taps)
    out, vjp = jax.vjp(lambda a: jfir.upfirdn2d(a, k, up, down, pad, gain=4.0), xj)
    gj = jnp.asarray(rng.randn(*out.shape).astype(np.float32), BF)
    (dxj,) = vjp(gj)
    xt.requires_grad_(True)
    y = upfirdn.upfirdn2d(xt, k, up, down, pad, gain=4.0)
    (dxt,) = torch.autograd.grad(y, xt, nchw(to_np(gj)).bfloat16())
    assert y.dtype == dxt.dtype == torch.bfloat16 and dxj.dtype == BF
    assert_within_one_bf16_ulp(y.detach(), nchw(to_np(out)))
    assert_within_one_bf16_ulp(dxt, nchw(to_np(dxj)))


@pytest.fixture
def card_route(monkeypatch):
    """CPU tensors routed as CUDA ones: ``upfirdn._launch`` swapped for the
    plain version after the launch's own checks, counted under the C entry
    point of the tensor's dtype; ``calls["plain"]`` counts the plain
    version's calls from anywhere else (a CUDA tensor must never reach it)."""
    plain = upfirdn._fir_plain
    calls = {"plain": 0, "dtypes": set()}

    def launch(x, taps, up, down, pad0, ho, wo, key):
        upfirdn.check_launch(x, taps, up, down, pad0, ho, wo)
        (h, w), (kh, kw) = x.shape[2:], taps.shape
        pads = (pad0, (ho - 1) * down + kh - h * up - pad0, pad0, (wo - 1) * down + kw - w * up - pad0)
        with torch.no_grad():
            y = plain(x, taps, up, down, pads)
        cuda.launches[upfirdn.KERNEL_OF_DTYPE[x.dtype]] += 1
        upfirdn.layout_launches[key] += 1
        calls["dtypes"].add(x.dtype)
        return y

    def counted_plain(*args):
        calls["plain"] += 1
        return plain(*args)

    monkeypatch.setattr(upfirdn, "_on_card", lambda x: True)
    monkeypatch.setattr(upfirdn, "_launch", launch)
    monkeypatch.setattr(upfirdn, "_fir_plain", counted_plain)
    cuda.reset_launches()
    upfirdn.reset_layout_launches()
    yield calls
    cuda.reset_launches()
    upfirdn.reset_layout_launches()


def test_fir_bf16_card_route_launches_the_bf16_kernel(rng, card_route):
    """On the card a bf16 FIR and its adjoint (here the kh != kw, unequal
    front pad case, stuffed and padded in torch first) launch the bf16 entry
    point, and agree with the plain version within one bf16 ulp."""
    x = torch.from_numpy(rng.randn(2, 3, 9, 7).astype(np.float32)).bfloat16().requires_grad_(True)
    taps = np.array([[1, 2], [3, 1], [0, 2]], np.float32) / 9
    y = upfirdn.upfirdn2d(x, taps, up=2, pad=(1, 1), gain=4.0)
    g = torch.from_numpy(rng.randn(*y.shape).astype(np.float32)).bfloat16()
    (dx,) = torch.autograd.grad(y, x, g)
    assert cuda.launches == {**{k: 0 for k in cuda.KERNELS}, "upfirdn2d_bf16": 2}
    assert card_route["plain"] == 0 and card_route["dtypes"] == {torch.bfloat16}
    assert y.dtype == dx.dtype == torch.bfloat16
    xr = x.detach().float().requires_grad_(True)
    yr = upfirdn.upfirdn2d_plain(xr, taps, up=2, pad=(1, 1), gain=4.0)
    (dxr,) = torch.autograd.grad(yr, xr, g.float())
    assert_within_one_bf16_ulp(y.detach(), yr.detach().bfloat16())
    assert_within_one_bf16_ulp(dx, dxr.bfloat16())


# ---------------------------------------------------------------------------
# (b) the wrappers


def test_cast_floating_keeps_structure_and_non_floats():
    batch = SynthBatch(w1=torch.ones(2, 3), imgs1=torch.ones(2, 4, 4, 3), const1=torch.ones(2, 1),
                       label=torch.arange(2))
    tree = {"b": batch, "l": [torch.ones(1, dtype=torch.float64), None, 3], "t": (torch.ones(1),)}
    out = precision.cast_floating(tree, torch.bfloat16)
    assert isinstance(out["b"], SynthBatch) and out["b"].imgs1.dtype == torch.bfloat16
    assert out["b"].label.dtype == torch.int64 and out["l"][1] is None and out["l"][2] == 3
    assert out["l"][0].dtype == torch.bfloat16 and isinstance(out["t"], tuple)


def test_bf16_frozen_is_a_bf16_copy():
    gen = StyleGAN2Generator(resolution=16, z_space_dim=8, w_space_dim=8, mapping_layers=2,
                             mapping_fmaps=8, fmaps_base=64, fmaps_max=8,
                             generator=torch.Generator().manual_seed(0)).requires_grad_(False)
    copy = precision.bf16_frozen(gen)
    assert copy is not gen and all(p.dtype == torch.float32 for p in gen.parameters())
    assert all(t.dtype == torch.bfloat16 for t in [*copy.parameters(), *copy.buffers()])
    assert copy.truncation.w_avg.dtype == copy.synthesis.layer1.noise.dtype == torch.bfloat16
    assert not any(p.requires_grad for p in copy.parameters())


ENC_IMAGES = dict(startf=16, maxf=64, layer_count=4, latent_size=64, use_blur=True)


def _encoder_images_pair(rng):
    """tpugan's test_bf16_encode_images_close_and_sn_signature encoder with
    its biases and noise weights drawn, bridged to the port; images and
    bf16-valued noise."""
    je = JEncoder(**ENC_IMAGES)
    port = Encoder(**ENC_IMAGES)
    shapes = port.noise_shapes(2, 32)
    noise = [tuple(torch.from_numpy(bf16_values(rng.randn(*s).astype(np.float32))) for s in b)
             for b in shapes]
    jnoise = [tuple(jnp.asarray(nhwc(n.numpy())) for n in b) for b in noise]
    imgs = np.tanh(rng.randn(2, 32, 32, 3)).astype(np.float32)
    variables = jax.tree.map(np.asarray, je.init(jax.random.PRNGKey(3), jnp.asarray(imgs), 0, jnoise))
    variables = {**variables, "params": nonzero_leaves(variables["params"], rng)}
    load_variables(port, variables)
    return je, port, variables, imgs, noise, jnoise


def test_bf16_encode_images_close_and_sn_signature(rng):
    """tpugan's test of the same name on the port: outputs fp32 and close
    to the fp32 encoder (its tolerances), as close to tpugan's fp32 encoder
    as tpugan's bf16 one is (the rule above), and the wrapper keeps the
    inner closure's signature, so an ``sn`` parameter is seen and passed."""
    je, port, variables, imgs, noise, jnoise = _encoder_images_pair(rng)
    extra = {k: v for k, v in variables.items() if k != "params"}

    def jencode(params, x):
        cast = [tuple(n.astype(x.dtype) for n in b) for b in jnoise]
        return je.apply({**extra, "params": params}, x, 0, cast)

    j32 = jax.jit(jencode)(variables["params"], jnp.asarray(imgs))
    j16 = jax.jit(jprecision.bf16_encode_images(jencode))(variables["params"], jnp.asarray(imgs))

    def encode(x):
        return port(x, noise)

    x = nchw(imgs)
    with torch.no_grad():
        const32, w32 = encode(x)
        wrapped = precision.bf16_encode_images(encode, port)
        const16, w16 = wrapped(x)
    assert const16.dtype == w16.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in port.parameters())
    np.testing.assert_allclose(w16.numpy(), w32.numpy(), atol=0.05)
    np.testing.assert_allclose(const16.numpy(), const32.numpy(), rtol=0.1, atol=0.05)
    assert_as_close_as_tpugan(w16.numpy(), to_np(j16[1]), to_np(j32[1]), "w")
    assert_as_close_as_tpugan(nhwc(const16.numpy()), to_np(j16[0]), to_np(j32[0]), "const")

    def encode_sn(x, sn=None):
        assert sn == "the sn pair"
        return encode(x)

    wrapped_sn = precision.bf16_encode_images(encode_sn, port)
    assert "sn" in inspect.signature(wrapped_sn).parameters
    assert "sn" not in inspect.signature(wrapped).parameters
    with torch.no_grad():
        _, w2 = wrapped_sn(x, "the sn pair")
    assert torch.equal(w2, w16)


def test_bf16_encode_gradients_are_fp32_on_the_masters(rng):
    """bf16_encode: fp32 outputs; the gradients of a loss of them land fp32
    on the fp32 parameters, as close to tpugan's fp32 gradients as tpugan's
    bf16_encode's are."""
    je, port, variables, imgs, noise, jnoise = _encoder_images_pair(rng)
    extra = {k: v for k, v in variables.items() if k != "params"}
    proj = rng.randn(2, 8, 64).astype(np.float32)

    def jencode(params, batch, key):
        cast = [tuple(n.astype(batch.imgs1.dtype) for n in b) for b in jnoise]
        return je.apply({**extra, "params": params}, batch.imgs1, 0, cast)

    jbatch = JSynthBatch(w1=None, imgs1=jnp.asarray(imgs), const1=jnp.zeros((2, 4, 4, 64)))

    def jloss(fn):
        def loss(params):
            const, w = fn(params, jbatch, None)
            return jnp.sum(w * proj) + jnp.sum(jnp.square(const)) * 1e-3
        return jax.jit(jax.grad(loss))(variables["params"])

    jg32 = jloss(jencode)
    jg16 = jloss(jprecision.bf16_encode(jencode))

    batch = SynthBatch(w1=None, imgs1=torch.from_numpy(imgs), const1=torch.zeros(2, 64, 4, 4))
    encode = precision.bf16_encode(make_encode_fn(port, train=True), port)
    const, w = encode(batch, noise)
    assert const.dtype == w.dtype == torch.float32 and w.requires_grad
    loss = (w * torch.from_numpy(proj)).sum() + const.square().sum() * 1e-3
    names, params = zip(*port.named_parameters())
    grads = torch.autograd.grad(loss, params)
    assert all(p.dtype == g.dtype == torch.float32 for p, g in zip(params, grads))
    from test_torch_sgv1_train import _port_named

    want32, want16 = _port_named(port, jg32), _port_named(port, jg16)
    for name, g in zip(names, grads):
        assert_as_close_as_tpugan(g.numpy(), want16[name], want32[name], name)


def test_bf16_lpips_matches_tpugan(rng):
    """The bf16 LPIPS (bf16 VGG weights, fp32 distances) against tpugan's
    bf16_lpips on the same random weights, and within tpugan's 2% of fp32
    (tests/test_bf16.py::test_bf16_lpips_tracks_fp32)."""
    params = jax.tree.map(np.asarray, jlpips_params(jax.random.PRNGKey(7), 32))
    a = np.tanh(rng.randn(2, 32, 32, 3)).astype(np.float32)
    b = np.tanh(rng.randn(2, 32, 32, 3)).astype(np.float32)
    j32 = jax.jit(jmake_lpips_fn(params))(jnp.asarray(a), jnp.asarray(b))
    j16 = jax.jit(jprecision.bf16_lpips(jmake_lpips_fn(jprecision.cast_floating(params, BF))))(
        jnp.asarray(a), jnp.asarray(b))
    model = load_variables(LPIPS(), params)
    fn16 = precision.bf16_lpips(make_lpips_fn(copy.deepcopy(model).to(torch.bfloat16)))
    fn32 = make_lpips_fn(model)
    with torch.no_grad():
        d32 = fn32(torch.from_numpy(a), torch.from_numpy(b))
        d16 = fn16(torch.from_numpy(a), torch.from_numpy(b))
        feats = fn16.features(torch.from_numpy(a))
        again = fn16(torch.from_numpy(a), torch.from_numpy(b), a_feats=feats)
    assert d16.dtype == torch.float32 and feats[0].dtype == torch.bfloat16
    assert torch.equal(again, d16)
    rel = (d16 - d32).abs() / d32.abs().clamp_min(1e-6)
    assert float(rel.max()) < 0.02
    assert_as_close_as_tpugan(d16.numpy(), to_np(j16), to_np(j32), "lpips")
    rand = random_lpips_fn("cpu", dtype=torch.bfloat16)
    assert rand(torch.from_numpy(a), torch.from_numpy(b)).dtype == torch.float32


# ---------------------------------------------------------------------------
# (c) the pipelines and a case-2 step

SG2 = dict(resolution=64, fmaps_base=1024, fmaps_max=64)  # tests/test_bf16.py::_sg2_setup
ENC_STEP = dict(startf=16, maxf=64, layer_count=5, latent_size=512, use_blur=True)
BATCH = 2


@pytest.fixture(scope="module")
def sg2():
    """_sg2_setup's generator and E_Blur from tpugan's init (the
    generator's zero leaves drawn at 0.1, the encoder's biases and noise
    weights too), bridged to the port; z and the encoder's bf16-valued
    noise from numpy."""
    rng = np.random.RandomState(0)
    jgen, jenc = JStyleGAN2Generator(**SG2), JEncoder(**ENC_STEP)
    key = jax.random.PRNGKey(0)
    gvars = lively(jax.jit(jgen.init)({"params": key}, jnp.zeros((1, 512))), rng, scale=0.1)
    port_enc = Encoder(**ENC_STEP)
    shapes = port_enc.noise_shapes(BATCH, SG2["resolution"])
    noise = [tuple(torch.from_numpy(bf16_values(rng.randn(*s).astype(np.float32))) for s in b)
             for b in shapes]
    jnoise = [tuple(jnp.asarray(nhwc(n.numpy())) for n in b) for b in noise]
    evars = jax.tree.map(np.asarray, jax.jit(lambda x: jenc.init({"params": key, "noise": key}, x))(
        jnp.zeros((1, 64, 64, 3))))
    evars = {**evars, "params": nonzero_leaves(evars["params"], rng)}
    z = rng.randn(BATCH, 512).astype(np.float32)
    return dict(jgen=jgen, jenc=jenc, gvars=gvars, evars=evars, noise=noise, jnoise=jnoise, z=z)


def _jsg2_closures(s):
    """tpugan's SG2 closures (test_bf16.py's _sg2_setup) on injected inputs:
    z (in the dtype the wrapper hands in) from ``frozen["z"]`` where given,
    else the setup's, and the encoder's noise (in the images' dtype) from
    ``frozen["noise"]``, which rides to the encoder in ``batch.label``."""
    jgen, jenc = s["jgen"], s["jenc"]
    extra = {k: v for k, v in s["evars"].items() if k != "params"}

    def synth(frozen, k, z):
        g, zz = (frozen["g"], frozen["z"]) if "g" in frozen else (frozen, jnp.asarray(s["z"]))
        out = jgen.apply(g, zz.astype(z.dtype), trunc_psi=0.7, trunc_layers=8)
        const1 = jnp.repeat(g["params"]["synthesis"]["const"], BATCH, axis=0)
        return JSynthBatch(w1=out["wp"], imgs1=out["image"], const1=const1,
                           label=frozen.get("noise", s["jnoise"]) if "g" in frozen else None)

    def resynth(frozen, w, b, k):
        g = frozen["g"] if "g" in frozen else frozen
        return jgen.apply(g, w, method=jgen.synthesize)["image"]

    def encode(params, batch, key):
        noise = s["jnoise"] if batch.label is None else batch.label
        cast = [tuple(n.astype(batch.imgs1.dtype) for n in b) for b in noise]
        return jenc.apply({**extra, "params": params}, batch.imgs1, 0, cast)

    return synth, resynth, encode


def _port_sg2(s, bf16):
    """The port's generator (bf16_frozen under bf16) and encoder on the
    setup's variables, and the train-form closures, wrapped under bf16."""
    gen = load_variables(StyleGAN2Generator(**SG2), s["gvars"])
    enc = load_variables(Encoder(**ENC_STEP), s["evars"])
    gen.requires_grad_(False)
    if bf16:
        gen = precision.bf16_frozen(gen)
    synth, resynth = build_stylegan2_pipeline(gen, train=True)
    encode = make_encode_fn(enc, train=True)
    if bf16:
        synth, resynth = precision.bf16_pipeline(synth, resynth)
        encode = precision.bf16_encode(encode, enc)
    return gen, enc, synth, resynth, encode


def test_bf16_sg2_pipeline_matches_tpugan(sg2):
    """imgs1 = G(z) and the resynthesis G.synthesize(w1) in bf16: fp32 at
    the boundary, within 0.05 of the images' scale of fp32 (tpugan's gate),
    and as close to tpugan's fp32 images as tpugan's bf16 ones."""
    jsynth, jresynth, _ = _jsg2_closures(sg2)
    js16, jr16 = (jax.jit(f) for f in jprecision.bf16_pipeline(jsynth, jresynth))
    jsynth, jresynth = jax.jit(jsynth), jax.jit(jresynth)
    g16 = jprecision.bf16_frozen(sg2["gvars"])
    zj = jnp.asarray(sg2["z"])
    jb32, jb16 = jsynth(sg2["gvars"], None, zj), js16(g16, None, zj)
    jr32 = jresynth(sg2["gvars"], jb32.w1, jb32, None)
    jrr16 = jr16(g16, jb32.w1, jb32, None)
    _, _, synth, resynth, _ = _port_sg2(sg2, bf16=True)
    with torch.no_grad():
        batch = synth(torch.from_numpy(sg2["z"]))
        re = resynth(torch.from_numpy(np.asarray(jb32.w1)), batch)
    assert batch.imgs1.dtype == batch.w1.dtype == batch.const1.dtype == re.dtype == torch.float32
    for what, port16, j16, j32 in (("imgs1", batch.imgs1, jb16.imgs1, jb32.imgs1),
                                   ("w1", batch.w1, jb16.w1, jb32.w1),
                                   ("resynthesis", re, jrr16, jr32)):
        mine, _ = assert_as_close_as_tpugan(port16.numpy(), to_np(j16), to_np(j32), what)
        if what != "w1":
            assert mine / (np.abs(to_np(j32)).max() + 1e-6) < 0.05, what


SG1 = dict(layer_count=4, startf=8, latent=64)  # tests/test_bf16.py::test_bf16_sg1_pipeline_runs


@pytest.mark.parametrize("leaves", ["init", "drawn"])
def test_bf16_sgv1_pipeline_matches_tpugan(rng, leaves):
    """StyleGANv1's synth and resynth in bf16 (test_bf16_sg1_pipeline_runs's
    sizes, injected bf16-valued noise): fp32 out, as close to tpugan's fp32
    images as tpugan's bf16 ones; on tpugan's own weights for the gate
    (flax's init, its biases and noise weights 0) within 0.08 of scale of
    fp32 (tpugan's gate). With those constant leaves drawn, so that the
    noise and biases count, the 2x rule holds; the gate does not hold there
    for tpugan's own bf16 images either (0.088 of scale)."""
    lc, startf, latent = SG1["layer_count"], SG1["startf"], SG1["latent"]
    jgen = JStyleGANv1Generator(startf=startf, maxf=64, layer_count=lc, latent_size=latent)
    jgm = JStyleGANv1Mapping(num_layers=2 * lc, mapping_layers=4, latent_size=latent,
                             dlatent_size=latent, mapping_fmaps=latent)
    gen = StyleGANv1Generator(startf=startf, maxf=64, layer_count=lc, latent_size=latent)
    gm = StyleGANv1Mapping(num_layers=2 * lc, mapping_layers=4, latent_size=latent,
                           dlatent_size=latent, mapping_fmaps=latent)
    shapes = gen.noise_shapes(BATCH)
    noise = [tuple(torch.from_numpy(bf16_values(rng.randn(*s).astype(np.float32))) for s in b)
             for b in shapes]
    jnoise = [tuple(jnp.asarray(nhwc(n.numpy())) for n in b) for b in noise]
    key = jax.random.PRNGKey(0)
    gm_vars = jax.tree.map(np.asarray, jgm.init(key, jnp.zeros((1, latent))))
    gvars = jax.tree.map(np.asarray, jgen.init(key, jnp.zeros((BATCH, 2 * lc, latent)), lc - 1, 1.0,
                                               jnoise))
    if leaves == "drawn":
        gvars = {"params": nonzero_leaves(gvars["params"], rng)}
        gm_vars = {"params": nonzero_leaves(gm_vars["params"], rng)}
    load_variables(gen, gvars, unused=[f"to_rgb_{i}" for i in range(lc - 1)])  # flax made the lod's alone
    load_variables(gm, gm_vars)
    z = rng.randn(BATCH, latent).astype(np.float32)
    w2 = rng.randn(BATCH, 2 * lc, latent).astype(np.float32)

    def jsynth(frozen, k, zz):
        w1 = jgm.apply(frozen["gm"], zz)
        cast = [tuple(n.astype(w1.dtype) for n in b) for b in jnoise]
        return JSynthBatch(w1=w1, imgs1=jgen.apply(frozen["gen"], w1, lc - 1, noise=cast),
                           const1=jnp.repeat(frozen["gen"]["params"]["const"], BATCH, axis=0))

    def jresynth(frozen, w, b, k):
        cast = [tuple(n.astype(w.dtype) for n in bb) for bb in jnoise]
        return jgen.apply(frozen["gen"], w, lc - 1, noise=cast)

    frozen = {"gen": gvars, "gm": gm_vars}
    js16, jr16 = (jax.jit(f) for f in jprecision.bf16_pipeline(jsynth, jresynth))
    jsynth, jresynth = jax.jit(jsynth), jax.jit(jresynth)
    f16 = jprecision.bf16_frozen(frozen)
    jb32, jb16 = jsynth(frozen, key, jnp.asarray(z)), js16(f16, key, jnp.asarray(z))
    jr32, jrr16 = jresynth(frozen, jnp.asarray(w2), jb32, key), jr16(f16, jnp.asarray(w2), jb32, key)

    synth, resynth = build_stylegan1_pipeline(precision.bf16_frozen(gen), precision.bf16_frozen(gm),
                                              lc - 1)
    synth, resynth = precision.bf16_pipeline(synth, resynth)
    with torch.no_grad():
        batch = synth(torch.from_numpy(z), noise)
        re = resynth(torch.from_numpy(w2), batch, noise)
    assert batch.imgs1.dtype == re.dtype == torch.float32
    assert np.isfinite(batch.imgs1.numpy()).all()
    for what, port16, j16, j32 in (("imgs1", batch.imgs1, jb16.imgs1, jb32.imgs1),
                                   ("resynthesis", re, jrr16, jr32)):
        mine, theirs = assert_as_close_as_tpugan(port16.numpy(), to_np(j16), to_np(j32), what)
        scale = np.abs(to_np(j32)).max() + 1e-6
        print(f"SGv1 {what}, {leaves} leaves: bf16 max |err| over fp32's max |value|: port "
              f"{mine / scale:.4f}, tpugan {theirs / scale:.4f}")
        if leaves == "init":
            assert mine / (np.abs(to_np(j32)).max() + 1e-6) < 0.08, what


TRAJECTORY_STEPS = 10  # tests/test_bf16.py::test_bf16_training_trajectory_close


@pytest.fixture(scope="module")
def trajectories(sg2):
    """Ten case-2 steps (no LPIPS, as tests/test_bf16.py's trajectory gate)
    of each package in fp32 and in bf16, from the setup's variables, on one
    z and one bf16-valued noise draw per step from numpy: loss_tsa of every
    step, the first step's two gradients, and (the port) the encoder."""
    rng = np.random.RandomState(5)
    zs = [rng.randn(BATCH, 512).astype(np.float32) for _ in range(TRAJECTORY_STEPS)]
    noises = [[tuple(torch.from_numpy(bf16_values(rng.randn(*n.shape).astype(np.float32))) for n in b)
               for b in sg2["noise"]] for _ in range(TRAJECTORY_STEPS)]
    return {("tpugan", bf16): _jtrajectory(sg2, zs, noises, bf16) for bf16 in (False, True)} | \
        {("port", bf16): _port_trajectory(sg2, zs, noises, bf16) for bf16 in (False, True)}


def _jtrajectory(s, zs, noises, bf16):
    synth, resynth, encode = _jsg2_closures(s)
    g = s["gvars"]
    if bf16:
        synth, resynth = jprecision.bf16_pipeline(synth, resynth)
        encode = jprecision.bf16_encode(encode)
        g = jprecision.bf16_frozen(g)
    params = s["evars"]["params"]
    opt = _recording(jlreq_adam(0.0015, coefs=lreq_coef_tree(params, s["evars"]["lreq"])), keep=2)
    step = jax.jit(jmake_train_step(encode=encode, synth=synth, resynth=resynth, optimizer=opt,
                                    z_dim=512, batch_size=BATCH, case=2))
    state, losses, grads = jinit_train_state(params, opt), [], None
    for it, (z, noise) in enumerate(zip(zs, noises)):
        frozen = {"g": g, "z": jnp.asarray(z), "noise": [tuple(jnp.asarray(nhwc(n.numpy())) for n in b)
                                                          for b in noise]}
        state, info = step(state, jnp.int32(it), frozen)
        losses.append(jinfo_scalars(info)["loss_tsa"])
        grads = grads or state.opt_state[-2:]
    return dict(losses=np.array(losses), grads=grads)


def _port_trajectory(s, zs, noises, bf16):
    gen, enc, synth_fn, resynth, encode = _port_sg2(s, bf16)
    requests = [Request(z=torch.from_numpy(z), noise_g=None, noise_e=n, noise_g2=None)
                for z, n in zip(zs, noises)]
    step = make_train_step(encode, lambda r: synth_fn(r.z), resynth, lambda it: requests[it], case=2)
    state = init_train_state(enc, lreq_adam(enc, 0.0015))
    grads = []
    inner = state.optimizer.step
    state.optimizer.step = lambda g=None: (grads.append([x.clone() for x in g]), inner(g))
    frozen0 = [t.clone() for t in [*gen.parameters(), *gen.buffers()]]
    losses = []
    for it in range(len(requests)):
        state, info = step(state, it)
        losses.append(info_scalars(info)["loss_tsa"])
    assert all(torch.equal(a, b) for a, b in zip([*gen.parameters(), *gen.buffers()], frozen0))
    assert all(p.dtype == torch.float32 for p in enc.parameters())
    assert all(g_.dtype == torch.float32 for g in grads for g_ in g)
    names = [n for n, _ in enc.named_parameters()]
    return dict(losses=np.array(losses), grads=[dict(zip(names, g)) for g in grads[:2]], encoder=enc)


def test_bf16_case2_step_matches_tpugan(trajectories):
    """The first case-2 step in bf16 (generator, E_Blur's forward and
    backward) against tpugan's: loss_tsa within 3% of fp32 (tpugan's gate,
    test_bf16_case2_train_step_close, on both packages' fp32), and each
    gradient as close to tpugan's fp32 one as tpugan's bf16 one is; the
    master parameters and gradients fp32."""
    from test_torch_sgv1_train import _port_named

    j32, j16 = trajectories["tpugan", False], trajectories["tpugan", True]
    p32, p16 = trajectories["port", False], trajectories["port", True]
    loss = p16["losses"][0]
    assert np.isfinite(loss)
    for ref in (j32["losses"][0], p32["losses"][0]):
        assert abs(loss - ref) / abs(ref) < 0.03, (loss, ref)
    assert abs(j16["losses"][0] - j32["losses"][0]) / abs(j32["losses"][0]) < 0.03
    enc = p16["encoder"]
    for k, (g16, g32) in enumerate(zip(j16["grads"], j32["grads"])):
        want16, want32 = _port_named(enc, g16), _port_named(enc, g32)
        mine = np.concatenate([p16["grads"][k][n].numpy().ravel() for n in want32])
        theirs16 = np.concatenate([np.asarray(want16[n], np.float32).ravel() for n in want32])
        theirs32 = np.concatenate([np.asarray(want32[n], np.float32).ravel() for n in want32])
        assert_as_close_as_tpugan(mine, theirs16, theirs32, f"gradient {k}")


def test_bf16_case2_trajectory_tracks_tpugan(trajectories):
    """Ten case-2 steps: the port's fp32 loss_tsa within MODEL_TOL of
    tpugan's at every step, and the port's bf16 trajectory no farther from
    tpugan's fp32 one, at its farthest step (relative), than twice tpugan's
    own bf16 trajectory is. Both packages' bf16 runs leave fp32 by a few
    percent and more as Adam's updates compound (``-s`` prints them):
    tpugan's 5% trajectory gate is a property of its test's own weights and
    draws, not of the scheme."""
    from test_torch_sgv1_train import MODEL_TOL

    j32, j16 = trajectories["tpugan", False]["losses"], trajectories["tpugan", True]["losses"]
    p32, p16 = trajectories["port", False]["losses"], trajectories["port", True]["losses"]
    np.testing.assert_allclose(p32, j32, **MODEL_TOL)
    assert np.isfinite(p16).all()
    mine, theirs = np.abs(p16 - j32) / np.abs(j32), np.abs(j16 - j32) / np.abs(j32)
    print(f"loss_tsa, relative to tpugan's fp32, per step: port bf16 {np.round(mine, 4).tolist()}, "
          f"tpugan bf16 {np.round(theirs, 4).tolist()}")
    assert mine.max() <= 2 * theirs.max(), (mine.max(), theirs.max())


# ---------------------------------------------------------------------------
# (d) the CLI

TINY = ["--img_size", "32", "--start_features", "64", "--random_init", "--device", "cpu"]


@pytest.mark.parametrize("mtype,extra", [("2", ("--case", "2")), ("2", ("--ablation", "8")),
                                         ("1", ("--case", "2")), ("1", ("--ablation", "1")),
                                         ("4", ("--case", "2")), ("4", ("--case", "1"))],
                         ids=["mtype2-case2", "mtype2-ablation8", "mtype1-case2", "mtype1-ablation1",
                              "mtype4-case2", "mtype4-case1"])
def test_cli_bf16_trains_on_cpu(tmp_path, mtype, extra):
    """``e_align --bf16`` takes steps with finite losses; the step runs a
    bf16 copy of the generator, which stays frozen, and the encoder's
    parameters and optimizer state stay fp32 and move; no kernel launches
    on the CPU. mtype 4 runs tests/test_torch_train.py's 32 px BigGAN-deep."""
    cuda.reset_launches()
    out = tmp_path / "out"
    if mtype == "4":
        config = tmp_path / "config.json"
        config.write_text(BigGANConfig(**BIGGAN_CFG).to_json_string())
        extra = (*extra, "--z_dim", "8", "--config_dir", str(config))
    argv = ["--mtype", mtype, *TINY, "--bf16", *extra, "--iterations", "2", "--log_every", "1",
            "--experiment_dir", str(out)]
    e_align.main(argv)
    assert not any(cuda.launches.values())
    records = [json.loads(line) for line in (out / "Loss.txt").read_text().splitlines()]
    assert [r["iteration"] for r in records] == [0, 1]
    assert all(np.isfinite(v) for r in records for v in r.values())
    args = e_align.make_parser().parse_args(argv)
    trainer = e_align.build_trainer(args)
    gen = trainer.bundle.generator
    assert all(t.dtype == torch.bfloat16 for t in [*gen.parameters(), *gen.buffers()])
    if mtype == "1":
        assert next(trainer.bundle.mapping.parameters()).dtype == torch.bfloat16
    before = {n: p.clone() for n, p in trainer.state.encoder.named_parameters()}
    frozen = [t.clone() for t in gen.parameters()]
    state, info = trainer.step(trainer.state, 0)
    assert all(torch.equal(a, b) for a, b in zip(gen.parameters(), frozen))
    assert all(p.dtype == torch.float32 for p in state.encoder.parameters())
    assert all(v.dtype == torch.float32 for st in state.optimizer.state.values() for v in st.values()
               if isinstance(v, torch.Tensor))
    assert any(not torch.equal(p, before[n]) for n, p in state.encoder.named_parameters())
    assert info.loss_tsa.dtype == torch.float32 and info.loss_tsa > 0


def test_cli_bf16_ablation1_remaps_through_the_fp32_mapping():
    """Ablation 1 re-maps the bf16 encoder's z through the fp32 mapping, as
    tpugan's remap reads the fp32 tree: its w+ is the fp32 mapping's of the
    bf16 z's pixel norm, not the bf16 copy's."""
    args = e_align.make_parser().parse_args(["--mtype", "1", *TINY, "--bf16", "--ablation", "1",
                                             "--iterations", "1"])
    trainer = e_align.build_trainer(args)
    z2 = torch.randn(2, 512, generator=torch.Generator().manual_seed(1)).bfloat16()
    with torch.no_grad():
        w = trainer.bundle.remap(z2)
    assert w.dtype == torch.float32
    assert next(trainer.bundle.mapping.parameters()).dtype == torch.bfloat16  # the synthesis's copy
    from tpugan_torch.ops.basic import pixel_norm

    # the fp32 mapping that remap closes over, run on the bf16 z's pixel norm
    gm32 = next(c.cell_contents for c in trainer.bundle.remap.__closure__
                if isinstance(c.cell_contents, StyleGANv1Mapping))
    assert next(gm32.parameters()).dtype == torch.float32
    with torch.no_grad():
        x = pixel_norm(z2, dim=-1).float()
        for i in range(gm32.mapping_layers):
            x = getattr(gm32, f"block_{i + 1}")(x)
    assert torch.equal(w[:, 0], x)


def test_cli_bf16_lean_step_is_bitwise_the_full_trajectory():
    """Case 1 in bf16: lean steps after the first leave the parameters
    bitwise where the full steps put them, as in fp32."""
    argv = ["--mtype", "2", *TINY, "--bf16", "--case", "1", "--iterations", "3"]
    runs = []
    for lean in (False, True):
        trainer = e_align.build_trainer(e_align.make_parser().parse_args(argv))
        state = trainer.state
        for it in range(3):
            state, info = (trainer.lean if lean and it else trainer.step)(state, it)
        runs.append({n: p.detach().clone() for n, p in state.encoder.named_parameters()})
    assert all(torch.equal(runs[0][n], runs[1][n]) for n in runs[0])


def test_cli_bf16_runs_every_fir_through_the_bf16_kernel(card_route):
    """On the card route a bf16 case-2 step launches the bf16 kernel where
    the fp32 step launches the fp32 one, forward and adjoint, by TPU kernel
    alike, and never calls the plain version."""
    argv = ["--mtype", "2", *TINY, "--case", "2", "--iterations", "1"]
    counts = []
    for extra in ((), ("--bf16",)):
        trainer = e_align.build_trainer(e_align.make_parser().parse_args(argv + list(extra)))
        cuda.reset_launches()
        upfirdn.reset_layout_launches()
        trainer.step(trainer.state, 0)
        counts.append((dict(cuda.launches), dict(upfirdn.layout_launches)))
    (fp32, layout32), (bf16, layout16) = counts
    assert fp32["upfirdn2d"] > 0 and fp32["upfirdn2d_bf16"] == 0
    assert bf16["upfirdn2d_bf16"] == fp32["upfirdn2d"] and bf16["upfirdn2d"] == 0
    assert layout16 == layout32 and card_route["plain"] == 0


@pytest.mark.parametrize("extra,match", [
    (("--mtype", "2", "--remat"), "A3"),
    (("--mtype", "1", "--remat_policy", "conv_outs"), "A3"),
])
def test_cli_bf16_forms_of_later_work_raise(tmp_path, extra, match):
    with pytest.raises(NotImplementedError, match=match):
        e_align.main([*TINY, "--bf16", "--iterations", "1", "--experiment_dir", str(tmp_path), *extra])
