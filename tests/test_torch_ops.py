"""tpugan_torch ops vs tpugan (CPU): FIR, basic ops, eq_lr, Eq layers.

The same seeded numpy inputs go through the JAX function and its port; the
port runs NCHW, so NHWC inputs and outputs are transposed at the edges.
The port's plain FIR is held against both the XLA path and the Pallas
kernels in interpret mode, as tests/test_pallas_kernels.py runs them.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugan.nn.layers import EqConv as JEqConv
from tpugan.nn.layers import EqLinear as JEqLinear
from tpugan.ops import basic as jbasic
from tpugan.ops import eq_lr as jeq
from tpugan.ops import upfirdn as jfir
from tpugan.ops.pallas.upfirdn2d import upfirdn2d_pallas, upfirdn2d_pallas_small_c
from tpugan_torch.io.bridge import load_variables
from tpugan_torch.nn.layers import EqConv, EqLinear
from tpugan_torch.ops import basic, cuda, eq_lr, upfirdn

torch.set_num_threads(1)

FIR_TOL = dict(rtol=1e-5, atol=1e-5)  # the Pallas kernels' own contract
OP_TOL = dict(rtol=1e-4, atol=1e-4)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def nhwc(x):
    return x.detach().numpy().transpose(0, 2, 3, 1)


# tests/test_pallas_kernels.py:11-20
B1_CASES = [
    (1, 1, (1, 2, 1), (1, 1), (2, 8, 8, 4)),
    (1, 1, (1, 2, 1), (1, 1), (1, 16, 12, 8)),
    (2, 1, (1, 3, 3, 1), (3, 1), (2, 8, 8, 4)),
    (1, 2, (1, 3, 3, 1), (1, 1), (2, 16, 16, 4)),
    (1, 1, (1, 3, 3, 1), (2, 1), (1, 8, 8, 4)),
    (2, 1, (1, 2, 1), (2, 0), (1, 6, 6, 2)),
]
# tests/test_pallas_kernels.py:47-53
B2_CASES = [
    ((1, 2, 1), (1, 1), (2, 16, 16, 16)),
    ((1, 3, 3, 1), (2, 1), (1, 32, 24, 8)),
    ((1, 2, 1), (1, 1), (2, 9, 11, 4)),
]


@pytest.mark.parametrize(
    "up,down,taps,pad,shape,gain",
    [c + (1.0,) for c in B1_CASES]
    + [
        (2, 2, (1, 3, 3, 1), (2, 2), (1, 7, 7, 3), 1.0),
        (2, 1, (1, 3, 3, 1), (2, 1), (2, 5, 5, 3), 4.0),
        (1, 1, (1, 2, 1), (1, 1), (2, 4, 4, 128), 1.0),
        (1, 1, (1, 7, 21, 35, 35, 21, 7, 1), (4, 3), (1, 12, 10, 5), 1.0),
    ],
)
def test_plain_fir_matches_xla(rng, up, down, taps, pad, shape, gain):
    x = rng.randn(*shape).astype(np.float32)
    k = jfir.setup_fir_kernel(taps)
    ref = jfir._upfirdn2d_xla(jnp.asarray(x), k, up, down, pad, gain)
    got = upfirdn.upfirdn2d(nchw(x), k, up, down, pad, gain)
    assert nhwc(got).shape == ref.shape
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), **FIR_TOL)


@pytest.mark.parametrize("up,down,taps,pad,shape", B1_CASES)
def test_plain_fir_matches_b1_pallas(rng, up, down, taps, pad, shape):
    x = rng.randn(*shape).astype(np.float32)
    k = jfir.setup_fir_kernel(taps)
    ref = upfirdn2d_pallas(jnp.asarray(x), k, up=up, down=down, pad=pad, interpret=True)
    got = upfirdn.upfirdn2d_plain(nchw(x), k, up, down, pad)
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), **FIR_TOL)


def test_plain_fir_matches_b1_pallas_tiled(rng, monkeypatch):
    """The multi-tile case of tests/test_pallas_kernels.py:31-44."""
    from tpugan.ops.pallas import upfirdn2d as mod

    monkeypatch.setattr(mod, "_pick_tile_h", lambda *a, **kw: 4)
    x = rng.randn(1, 32, 8, 4).astype(np.float32)
    k = jfir.setup_fir_kernel((1, 3, 3, 1))
    ref = upfirdn2d_pallas(jnp.asarray(x), k, up=2, down=1, pad=(3, 1), interpret=True)
    got = upfirdn.upfirdn2d_plain(nchw(x), k, 2, 1, (3, 1))
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), **FIR_TOL)


@pytest.mark.parametrize("taps,pad,shape", B2_CASES)
def test_plain_fir_matches_b2_pallas(rng, taps, pad, shape):
    x = rng.randn(*shape).astype(np.float32)
    k = jfir.setup_fir_kernel(taps)
    ref = upfirdn2d_pallas_small_c(jnp.asarray(x), k, pad=pad, interpret=True)
    got = upfirdn.upfirdn2d_plain(nchw(x), k, 1, 1, pad)
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), **FIR_TOL)


@pytest.mark.parametrize("name", ["blur3x3", "upsample_fir", "downsample_fir"])
def test_fir_wrappers_match(rng, name):
    x = rng.randn(2, 8, 8, 3).astype(np.float32)
    if name == "blur3x3":
        ref, got = jfir.blur3x3(jnp.asarray(x)), upfirdn.blur3x3(nchw(x))
    else:
        k = jfir.setup_fir_kernel((1, 3, 3, 1))
        ref = getattr(jfir, name)(jnp.asarray(x), k)
        got = getattr(upfirdn, name)(nchw(x), k)
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), **FIR_TOL)


def test_cpu_tensor_takes_plain_version_without_launch(rng):
    cuda.reset_launches()
    x = nchw(rng.randn(1, 8, 8, 4).astype(np.float32))
    upfirdn.blur3x3(x)
    upfirdn.upfirdn2d(x, upfirdn.setup_fir_kernel((1, 3, 3, 1)), up=2, pad=(2, 1))
    assert not any(cuda.launches.values())
    with pytest.raises(ValueError, match="CUDA tensor"):
        upfirdn.upfirdn2d_cuda(x, upfirdn.setup_fir_kernel((1, 2, 1)), pad=(1, 1))
    assert not any(cuda.launches.values())


# (channels, up, down, kernel shape): both sides of each of tpugan's tests
LAYOUT_CASES = [
    (512, 1, 1, (3, 3)), (256, 2, 1, (4, 4)), (128, 1, 2, (4, 4)), (128, 2, 2, (4, 4)),
    (64, 1, 1, (3, 3)), (16, 1, 1, (4, 4)), (3, 1, 1, (3, 3)), (64, 2, 1, (4, 4)),
    (128, 1, 1, (3, 5)), (32, 1, 1, (2, 4)),
]


@pytest.mark.parametrize("c,up,down,kshape", LAYOUT_CASES)
def test_tpu_layout_is_tpugan_dispatch(monkeypatch, c, up, down, kshape):
    """A launch is counted in layout_launches under the TPU kernel that
    tpugan's _dispatch runs for the same FIR."""
    from tpugan.ops.pallas import upfirdn2d as mod

    took = []
    monkeypatch.setattr(mod, "upfirdn2d_pallas", lambda x, *a, **kw: took.append("B1") or x)
    monkeypatch.setattr(mod, "upfirdn2d_pallas_small_c", lambda x, *a, **kw: took.append("B2") or x)
    monkeypatch.setattr(jfir, "_upfirdn2d_xla", lambda x, *a: took.append("XLA") or x)
    jfir._dispatch(jnp.zeros((1, 4, 4, c)), np.ones(kshape, np.float32), up, down, (1, 1), 1.0, True)
    assert took == [upfirdn.tpu_layout(c, up, down, *kshape)]


REFUSED = {
    # bf16 is in the contract: a CPU bf16 tensor is refused only for its device
    "bf16": (lambda x: dict(x=x.bfloat16()), ValueError, "CUDA tensor"),
    "fp16": (lambda x: dict(x=x.half()), TypeError, "float32 or bfloat16"),
    "non_contiguous": (lambda x: dict(x=x.transpose(2, 3)), ValueError, "contiguous"),
    "up3": (lambda x: dict(up=3), ValueError, "up and down"),
    "9_taps": (lambda x: dict(kernel=upfirdn.setup_fir_kernel([1.0] * 9)), ValueError, "exceeds"),
    "negative_pad": (lambda x: dict(pad=(-1, 1)), ValueError, "non-negative"),
    "empty_output": (lambda x: dict(down=2, pad=(0, 0), kernel=np.ones((8, 8))), ValueError, "empty"),
    "cpu_tensor": (lambda x: {}, ValueError, "CUDA tensor"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_kernel_wrapper_refuses_out_of_contract_input(rng, name):
    """The checks run before the device check, so they hold here too; a
    valid CPU tensor is refused last, for not being on the card."""
    x = nchw(rng.randn(1, 5, 5, 4).astype(np.float32))
    change, error, match = REFUSED[name]
    kw = dict(x=x, kernel=upfirdn.setup_fir_kernel((1, 2, 1)), pad=(1, 1)) | change(x)
    with pytest.raises(error, match=match):
        upfirdn.upfirdn2d_cuda(**kw)


def test_cuda_build_is_keyed_by_source_and_flags():
    path = cuda.library_path("upfirdn2d")
    assert path.parent == cuda.BUILD_DIR and path.name.startswith("libupfirdn2d-")
    assert (cuda.CSRC / cuda.KERNELS["upfirdn2d"][0]).exists()
    assert "arch=compute_90a,code=sm_90a" in cuda.NVCC_FLAGS


BASIC_CASES = {
    "pixel_norm": lambda m, x: m.pixel_norm(x, **({"axis": -1} if m is jbasic else {"dim": 1})),
    "upscale2d": lambda m, x: m.upscale2d(x),
    "downscale2d": lambda m, x: m.downscale2d(x),
    "instance_norm": lambda m, x: m.instance_norm(x),
    "leaky_relu": lambda m, x: m.leaky_relu(x, 0.2),
}


@pytest.mark.parametrize("name", sorted(BASIC_CASES))
def test_basic_ops_match(rng, name):
    x = rng.randn(2, 8, 8, 6).astype(np.float32)
    ref = BASIC_CASES[name](jbasic, jnp.asarray(x))
    got = BASIC_CASES[name](basic, nchw(x))
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), **OP_TOL)


def test_instance_moments_style_mod_noise_inject_match(rng):
    x = rng.randn(2, 8, 8, 6).astype(np.float32) * 3 + 1
    mean_j, std_j = jbasic.instance_moments(jnp.asarray(x))
    mean_t, std_t = basic.instance_moments(nchw(x))
    np.testing.assert_allclose(mean_t.numpy(), np.asarray(mean_j), **OP_TOL)
    np.testing.assert_allclose(std_t.numpy(), np.asarray(std_j), **OP_TOL)

    style = rng.randn(2, 12).astype(np.float32)
    ref = jbasic.style_mod(jnp.asarray(x), jnp.asarray(style))
    got = basic.style_mod(nchw(x), torch.from_numpy(style))
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), **OP_TOL)

    nw = rng.randn(6).astype(np.float32)
    noise = rng.randn(2, 8, 8, 1).astype(np.float32)
    ref = jbasic.noise_inject(jnp.asarray(x), jnp.asarray(nw), None, jnp.asarray(noise))
    got = basic.noise_inject(nchw(x), torch.from_numpy(nw), nchw(noise))
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), **OP_TOL)
    xt = nchw(x)
    assert basic.noise_inject(xt, torch.from_numpy(nw), None) is xt  # no noise, no injection


@pytest.mark.parametrize("average", [True, False])
def test_eq_lr_matches(rng, average):
    assert eq_lr.eq_lr_std(72, 1.0, 0.01) == jeq.eq_lr_std(72, 1.0, 0.01)
    w = rng.randn(3, 3, 4, 5).astype(np.float32)  # HWIO
    ref = np.asarray(jeq.transform_kernel_2d(jnp.asarray(w), average))
    got = eq_lr.transform_kernel_2d(torch.from_numpy(w.transpose(3, 2, 0, 1)), average)
    np.testing.assert_allclose(got.numpy().transpose(2, 3, 1, 0), ref, **OP_TOL)


def _randomized(variables, rng):
    """Every param (biases included) drawn at random, as
    tests/test_stylegan1.py:106-110 does."""
    params = jax.tree.map(
        lambda p: np.asarray(rng.randn(*p.shape).astype(np.float32) * 0.1), variables["params"]
    )
    return {**variables, "params": params}


def _lreq_by_name(lreq, prefix=""):
    out = {}
    for key, value in lreq.items():
        if isinstance(value, dict):
            out.update(_lreq_by_name(value, f"{prefix}{key}."))
        else:
            leaf = key[: -len("_coef")]
            out[prefix + ("weight" if leaf == "kernel" else leaf)] = float(value)
    return out


@pytest.mark.parametrize("lrmul,gain", [(1.0, math.sqrt(2.0)), (0.01, math.sqrt(2.0)), (1.0, 1.0)])
def test_eq_linear_matches(rng, lrmul, gain):
    x = rng.randn(3, 12).astype(np.float32)
    jmod = JEqLinear(7, gain=gain, lrmul=lrmul)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = _randomized(variables, rng) | {"lreq": variables["lreq"]}
    ref = jmod.apply(variables, jnp.asarray(x))
    port = load_variables(EqLinear(12, 7, gain=gain, lrmul=lrmul), variables)
    np.testing.assert_allclose(port(torch.from_numpy(x)).detach().numpy(), np.asarray(ref), **OP_TOL)
    want = _lreq_by_name(jax.tree.map(float, variables["lreq"]))
    got = eq_lr.lreq_coefs(port)
    assert got.keys() == want.keys()
    np.testing.assert_allclose([got[k] for k in want], list(want.values()), rtol=1e-6)


CONV_CASES = {
    "3x3": dict(features=6, kernel_size=3, padding=1, use_bias=False),
    "1x1_bias": dict(features=6, kernel_size=1),
    "stride2_transform": dict(features=6, kernel_size=3, stride=2, padding=1, use_bias=False,
                              transform_kernel=True),
    "transposed_fused": dict(features=6, kernel_size=3, stride=2, padding=1, use_bias=False,
                             transpose=True, transform_kernel=True),
}


@pytest.mark.parametrize("name", sorted(CONV_CASES))
def test_eq_conv_matches(rng, name):
    kw = CONV_CASES[name]
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    jmod = JEqConv(**kw)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = _randomized(variables, rng) | {"lreq": variables["lreq"]}
    ref = jmod.apply(variables, jnp.asarray(x))
    port_kw = {k: v for k, v in kw.items() if k != "features"}
    port = load_variables(EqConv(4, kw["features"], **port_kw), variables)
    got = port(nchw(x))
    assert nhwc(got).shape == ref.shape
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), **OP_TOL)
    want = _lreq_by_name(jax.tree.map(float, variables["lreq"]))
    assert eq_lr.lreq_coefs(port) == pytest.approx(want, rel=1e-6)
