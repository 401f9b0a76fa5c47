"""tpugan_torch's VGG16 with its classifier, Grad-CAM(++), guided
backpropagation and the CAM overlays (``losses/vgg.py``,
``losses/gradcam.py``) vs tpugan (CPU).

Both sides run tpugan's VGG16 variables (its flax init at 10 classes, as
tpugan's own tests build it, with the zero-initialised biases drawn so that
they reach the output), carried across by the bridge, on the same numpy
draws. Tolerances:

* ops (the guided ReLU's gradient, the resize, mask2cam on one mask): 1e-4;
* whole models (logits, features, masks, gradients): rtol 2e-3 / atol 2e-4
  of the largest value, ``tests/test_stylegan1.py:134``'s;
* bf16 (``cam_bf16``): a CAM is a sum over 512 channels that nearly
  cancels, so bf16's rounding moves a mask by about 0.02 on average in
  either package (up to 0.19 at a pixel), each by its own rounding. The
  port's bf16 masks are held to tpugan's fp32 ones by twice tpugan's own
  bf16 distance, as a mean |err| over ``BF16_BATCHES`` batches, and the bf16
  VGG16's conv_out by twice tpugan's max |err|;
* the colormap: bitwise on the same values. On masks the two packages
  computed, ``255 * mask`` can sit at an integer on one side and a rounding
  below it on the other, so their colormap indices may differ by one step
  at up to ``HEATMAP_SHARE`` of the pixels, never by more.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bf16 import assert_as_close_as_tpugan
from tpugan import precision as jprecision
from tpugan.losses import gradcam as jgradcam
from tpugan.losses.vgg import VGG16 as JVGG16
from tpugan.losses.vgg import guided_relu as jguided_relu
from tpugan_torch.io.bridge import load_variables
from tpugan_torch.losses import gradcam
from tpugan_torch.losses.vgg import VGG16, VGG16Features, GuidedReLU
from tpugan_torch.precision import bf16_frozen

torch.set_num_threads(2)

CLASSES = 10
OP_TOL = dict(rtol=1e-4, atol=1e-4)
MODEL_TOL = dict(rtol=2e-3, atol_share=2e-4)
HEATMAP_SHARE = 0.01
BF16_BATCHES = 8


def assert_close(got, want, what, rtol, atol_share):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, f"{what}: shape {got.shape} against {want.shape}"
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_share * scale, err_msg=what)


def jax_variables(seed=7, classes=CLASSES):
    """tpugan's VGG16 variables (flax init), its zero biases drawn around 0."""
    rng = np.random.RandomState(seed)
    jvgg = JVGG16(num_classes=classes)
    variables = jax.tree.map(np.asarray, jax.jit(jvgg.init)(jax.random.PRNGKey(seed), jnp.zeros((1, 32, 32, 3))))

    def bias(path, x):
        if path[-1].key == "bias":
            return (rng.randn(*x.shape) * 0.05).astype(np.float32)
        return x

    return jvgg, {"params": jax.tree_util.tree_map_with_path(bias, variables["params"])}


@pytest.fixture(scope="module")
def vggs():
    jvgg, variables = jax_variables()
    port = load_variables(VGG16(num_classes=CLASSES), variables).requires_grad_(False)
    return jvgg, variables, port


def images(n, size, seed=0):
    return (np.random.RandomState(seed).randn(n, size, size, 3) * 0.5).astype(np.float32)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


# ---------------------------------------------------------------------------
# VGG16


@pytest.mark.parametrize("size", [32, 64, 256])
def test_vgg16_matches_tpugan(vggs, size):
    """Logits, the 13 post-ReLU features and the last conv's pre-ReLU output.
    At 64 px and up the classifier's 7x7 map comes from a map larger than
    1x1, where a wrong flatten order of fc_0 shows."""
    jvgg, variables, port = vggs
    x = images(2 if size < 256 else 1, size)
    jlogits, jfeats, jconv = jvgg.apply(variables, jnp.asarray(x), return_conv_out=True)
    with torch.no_grad():
        logits, feats, conv = port(nchw(x), return_conv_out=True)
    assert logits.shape == (x.shape[0], CLASSES) and len(feats) == 13
    assert_close(logits, jlogits, "logits", **MODEL_TOL)
    for j, (f, jf) in enumerate(zip(feats, jfeats)):
        assert_close(f.numpy().transpose(0, 2, 3, 1), jf, f"feature {j}", **MODEL_TOL)
    assert_close(conv.numpy().transpose(0, 2, 3, 1), jconv, "conv_out", **MODEL_TOL)
    assert float(conv.min()) < 0  # pre-ReLU


def test_fc0_rows_follow_the_nchw_flatten(vggs):
    """fc_0 of the port over a (c, h, w) flatten is tpugan's over an (h, w, c)
    flatten of the same map; the plain transpose (no reordering) is not."""
    _, variables, port = vggs
    x = np.random.RandomState(1).randn(2, 512, 7, 7).astype(np.float32)
    fc = variables["params"]["head"]["fc_0"]
    want = x.transpose(0, 2, 3, 1).reshape(2, -1) @ fc["kernel"] + fc["bias"]
    with torch.no_grad():
        got = port.head.fc_0(torch.from_numpy(x).flatten(1)).numpy()
    assert_close(got, want, "fc_0", **MODEL_TOL)
    unordered = x.reshape(2, -1) @ fc["kernel"] + fc["bias"]
    assert np.abs(unordered - want).max() > 100 * np.abs(got - want).max()


def test_head_from_conv_is_the_forward_past_conv_out(vggs):
    _, _, port = vggs
    x = nchw(images(2, 64))
    with torch.no_grad():
        logits, _, conv = port(x, return_conv_out=True)
        torch.testing.assert_close(port.head_from_conv(conv), logits, rtol=0, atol=0)


def test_features_backbone_is_the_classifier_free_vgg16(vggs):
    """LPIPS's backbone computes VGG16's features, from the same random
    init as before the classifier came (its draws start with conv_0)."""
    _, variables, port = vggs
    feats = load_variables(VGG16Features(), {"params": {k: v for k, v in variables["params"].items()
                                                         if k != "head"}})
    assert not hasattr(feats, "head")
    x = nchw(images(1, 32))
    with torch.no_grad():
        for a, b in zip(feats(x), port(x)[1]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    a = VGG16Features(torch.Generator().manual_seed(3))
    b = VGG16(include_classifier=False, generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(a.conv_12.weight, b.conv_12.weight, rtol=0, atol=0)


def test_guided_relu_gradient_matches_tpugan():
    rng = np.random.RandomState(2)
    x, g = rng.randn(4, 64).astype(np.float32), rng.randn(4, 64).astype(np.float32)
    x[0, :4] = 0.0  # the boundary: no gradient at x == 0
    _, vjp = jax.vjp(jguided_relu, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = GuidedReLU.apply(xt)
    (got,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
    np.testing.assert_allclose(y.detach().numpy(), np.maximum(x, 0), **OP_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(vjp(jnp.asarray(g))[0]), **OP_TOL)
    assert (got.numpy() >= 0).all() and (got.numpy()[x <= 0] == 0).all()


# ---------------------------------------------------------------------------
# Grad-CAM and guided backpropagation


def heatmap_index_steps(got_mask, want_mask):
    """The colormap indices of two masks: the share of pixels that differ
    and the largest difference, in LUT steps."""
    a = (255.0 * np.asarray(got_mask, np.float32)).astype(np.uint8).astype(int)
    b = np.asarray((255.0 * jnp.asarray(want_mask)).astype(jnp.uint8)).astype(int)
    return float((a != b).mean()), int(np.abs(a - b).max())


@pytest.mark.parametrize("index", [None, 3])
@pytest.mark.parametrize("guided", [True, False])
@pytest.mark.parametrize("plus_plus", [True, False])
def test_grad_cam_matches_tpugan(vggs, plus_plus, guided, index):
    jvgg, variables, port = vggs
    x = images(2, 64, seed=4)
    want = jgradcam.grad_cam(jvgg, variables, jnp.asarray(x), index=index, plus_plus=plus_plus, guided=guided)
    got = gradcam.grad_cam(port, torch.from_numpy(x), index=index, plus_plus=plus_plus, guided=guided)
    assert got.shape == (2, 64, 64, 1) and float(got.min()) >= 0 and float(got.max()) <= 1
    assert_close(got, want, "mask", **MODEL_TOL)
    share, steps = heatmap_index_steps(got.numpy(), want)
    assert share <= HEATMAP_SHARE and steps <= 1, f"heatmap indices: {share:.2%} differ, by up to {steps}"


def test_grad_cam_bf16_as_close_as_tpugan(vggs):
    """cam_bf16's arithmetic: the bf16 VGG16 (its parameters cast) on bf16
    images, CAM++ masks at the batch's majority class, against tpugan's
    jitted bf16 run, both measured from tpugan's fp32 masks."""
    jvgg, variables, port = vggs
    port16, vars16 = bf16_frozen(port), jprecision.cast_floating(variables, jnp.bfloat16)
    jcam = jax.jit(lambda v, x: jgradcam.grad_cam(jvgg, v, x, plus_plus=True))
    mine, theirs = [], []
    for seed in range(BF16_BATCHES):
        x = np.random.RandomState(seed).uniform(-1, 1, (5, 32, 32, 3)).astype(np.float32)
        want = np.asarray(jcam(variables, jnp.asarray(x)))
        got = gradcam.grad_cam(port16, torch.from_numpy(x).bfloat16(), plus_plus=True)
        assert got.dtype == torch.bfloat16
        mine.append(np.abs(got.float().numpy() - want).mean())
        theirs.append(np.abs(np.asarray(jcam(vars16, jnp.asarray(x, jnp.bfloat16)), np.float32) - want).mean())
        if seed == 0:
            with torch.no_grad():
                conv = port16(torch.from_numpy(x).bfloat16().permute(0, 3, 1, 2), return_conv_out=True)[2]
            assert_as_close_as_tpugan(conv.float().numpy().transpose(0, 2, 3, 1),
                                      jvgg.apply(vars16, jnp.asarray(x, jnp.bfloat16), return_conv_out=True)[2],
                                      jvgg.apply(variables, jnp.asarray(x), return_conv_out=True)[2], "conv_out")
    print(f"bf16 masks' mean |err| from fp32: port {np.mean(mine):.4f}, tpugan {np.mean(theirs):.4f}")
    assert np.mean(mine) <= 2 * np.mean(theirs)


def test_grad_cam_leaves_the_images_graph_alone(vggs):
    """The CAM's own backward does not reach a graph the images carry: the
    mask takes no gradient and the caller's graph keeps its grads at None."""
    _, _, port = vggs
    src = torch.from_numpy(images(2, 32)).requires_grad_(True)
    imgs = src * 1.5
    mask = gradcam.grad_cam(port, imgs.detach(), plus_plus=True)
    assert not mask.requires_grad and src.grad is None
    assert all(p.grad is None for p in port.parameters())


@pytest.mark.parametrize("index", [None, 7])
def test_guided_backprop_matches_tpugan(vggs, index):
    jvgg, variables, port = vggs
    x = images(2, 64, seed=5)
    want = jgradcam.guided_backprop(JVGG16(num_classes=CLASSES, guided=True), variables, jnp.asarray(x),
                                    index=index)
    got = gradcam.guided_backprop(port, torch.from_numpy(x), index=index)
    assert float(np.abs(want).max()) > 0
    assert_close(got, want, "guided backprop", **MODEL_TOL)


@pytest.mark.parametrize("picks,want", [
    ([2, 2, 5, 5, 1], 2),  # a tie of counts: the smallest class
    ([5, 5, 2, 2, 1], 2),
    ([9, 0, 9, 0, 9], 9),
    ([4, 3, 2, 1, 0], 0),  # all distinct
    ([6, 6, 6, 6, 6], 6),
])
def test_majority_class_matches_tpugan(picks, want):
    logits = np.random.RandomState(0).rand(len(picks), CLASSES).astype(np.float32)
    logits[np.arange(len(picks)), picks] = 2.0
    got = int(gradcam.majority_class(torch.from_numpy(logits)))
    assert got == want == int(jgradcam.majority_class(jnp.asarray(logits)))


def test_majority_class_ties_within_an_image_go_to_the_first():
    logits = np.zeros((2, CLASSES), np.float32)
    logits[:, [3, 6]] = 1.0
    assert int(gradcam.majority_class(torch.from_numpy(logits))) == 3 == int(
        jgradcam.majority_class(jnp.asarray(logits)))


# ---------------------------------------------------------------------------
# the colormap, the overlays and the resize


def _boundary_values():
    k = np.arange(256, dtype=np.float32)
    exact = k / 255.0
    below = np.nextafter(exact, np.float32(-1.0))
    above = np.nextafter(exact, np.float32(2.0))
    return np.clip(np.concatenate([exact, below, above, [0.0, 1.0, 0.5, 0.999999]]), 0, 1).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jet_colormap_is_bitwise_tpugan_s(dtype):
    """Every entry of the table (the values k / 255) and each one ulp below
    and above, in fp32 and in bf16, where 255 * x is computed and truncated
    in the input's dtype."""
    x = _boundary_values()
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    got, want = gradcam.jet_colormap(tx), jgradcam.jet_colormap(jx)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(gradcam._JET_LUT.numpy(), np.asarray(jgradcam._JET_LUT))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mask2cam_matches_tpugan(dtype):
    rng = np.random.RandomState(6)
    mask = jnp.asarray(rng.rand(2, 32, 32, 1).astype(np.float32), dtype)
    imgs = jnp.asarray((rng.randn(2, 32, 32, 3) * 0.5).astype(np.float32), dtype)
    torch_of = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))).to(getattr(torch, dtype))  # noqa: E731
    heat, cam = gradcam.mask2cam(torch_of(mask), torch_of(imgs))
    jheat, jcam = jgradcam.mask2cam(mask, imgs)
    assert cam.dtype == torch.float32 and jcam.dtype == jnp.float32
    np.testing.assert_array_equal(heat.numpy(), np.asarray(jheat))
    np.testing.assert_allclose(cam.numpy(), np.asarray(jcam), **OP_TOL)
    assert float(cam.min()) == 0.0 and np.allclose(cam.amax(dim=(1, 2, 3)).numpy(), 1.0)


@pytest.mark.parametrize("src,dst", [(16, 256), (2, 32), (1, 16), (8, 64)])
def test_normalize_resize_matches_tpugan(src, dst):
    cam = np.random.RandomState(src).randn(2, src, src).astype(np.float32)
    got = gradcam._normalize_resize(torch.from_numpy(cam), dst, dst)
    want = jgradcam._normalize_resize(jnp.asarray(cam), dst, dst)
    assert got.shape == (2, dst, dst, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)


# ---------------------------------------------------------------------------
# Grad-CAM inversion (make_embedder(attention="gradcam"))


def _jax_gradcam_run(setup, jvgg, variables, dtype, **cfg):
    from test_torch_invert import _jax_result
    from tpugan.invert import EmbeddingConfig as JEmbeddingConfig
    from tpugan.invert import make_embedder as jmake_embedder

    with jax.enable_x64(dtype == np.float64):
        encode, resynth, params, coefs, frozen, sn0 = setup.jax(dtype, False, cfg["optimize_e"])
        cast = jax.tree.map(lambda x: jnp.asarray(x, dtype), variables)
        invert = jmake_embedder(encode, resynth, params, coefs, JEmbeddingConfig(attention="gradcam", **cfg),
                                vgg=jvgg, vgg_vars=cast, frozen=frozen, sn0=sn0)
        calls = []
        result = invert(jnp.asarray(setup.target, dtype),
                        chunk_callback=lambda i, w, im: calls.append((i, np.asarray(w), np.asarray(im))))
        return _jax_result(result), calls


@pytest.mark.parametrize("mode", ["optimize_w", "finetune_e"])
def test_gradcam_embedder_matches_tpugan(vggs, mode):
    """The BigGAN inversion (tests/test_torch_invert.py's E_BIG at 32 px)
    with Grad-CAM attention, 2 iterations, both packages in float64 (the
    inversion tests' F64_TOL): the histories, the snapshot, the callbacks
    and w. Fine-tuning E, w and the images are held to tpugan's float64
    run by twice tpugan's own fp32 distance from it, as
    tests/test_torch_invert_models.py holds E_BIG (LREQAdam's first update
    is sign-like)."""
    import copy

    from test_torch_invert import F64_TOL, _assert_calls_close, _assert_results_close, _port_result, _setup
    from tpugan_torch.invert import EmbeddingConfig, make_embedder

    jvgg, variables, port_vgg = vggs
    setup = _setup("ebig")
    cfg = dict(iterations=2, chunk=1, optimize_e=mode == "finetune_e")
    want, want_calls = _jax_gradcam_run(setup, jvgg, variables, np.float64, **cfg)
    encode, resynth, encoder = setup.port(torch.float64, False, cfg["optimize_e"])
    vgg64 = copy.deepcopy(port_vgg).double()
    invert = make_embedder(encode, resynth, encoder, EmbeddingConfig(attention="gradcam", **cfg), vgg=vgg64)
    calls = []
    got = _port_result(invert(torch.from_numpy(setup.target).double(),
                              chunk_callback=lambda i, w, im: calls.append((i, w.numpy(), im.numpy()))))
    assert np.isfinite(got["msiv"]).all() and not np.array_equal(calls[0][1], calls[-1][1])
    if cfg["optimize_e"]:
        _assert_results_close(got, want, F64_TOL, keys=("losses", "loss_best", "msiv", "wnorm"))
        fp32, fp32_calls = _jax_gradcam_run(setup, jvgg, variables, np.float32, **cfg)
        for key in ("w", "w_best", "images"):
            assert_as_close_as_tpugan(got[key], fp32[key], want[key], key)
        for (i, w, im), (_, w32, im32), (_, w64, im64) in zip(calls, fp32_calls, want_calls):
            assert_as_close_as_tpugan(w, w32, w64, f"w at {i}")
    else:
        _assert_results_close(got, want, F64_TOL)
        _assert_calls_close(calls, want_calls, F64_TOL)


def test_gradcam_attention_terms_carry_no_gradient(vggs):
    """loss_msiv's gradient is l_imgs' alone: the mask and overlay terms
    come from the detached reconstruction (embedding_v2_BigGAN.py:134-151)."""
    from test_torch_invert import _setup
    from tpugan_torch.losses.space_loss import space_loss

    _, _, port_vgg = vggs
    setup = _setup("ebig")
    encode, resynth, encoder = setup.port(torch.float32, False, False)
    target = torch.from_numpy(setup.target)
    w = encode(target)[1].detach().requires_grad_(True)
    imgs2 = resynth(w)
    i2 = imgs2.detach()
    m1, m2 = gradcam.grad_cam(port_vgg, target, plus_plus=True), gradcam.grad_cam(port_vgg, i2, plus_plus=True)
    l_mask = space_loss(m1.expand(-1, -1, -1, 3), m2.expand(-1, -1, -1, 3))[0]
    l_cam = space_loss(gradcam.mask2cam(m1, target)[1], gradcam.mask2cam(m2, i2)[1])[0]
    assert not l_mask.requires_grad and not l_cam.requires_grad and float(l_mask) > 0
    (g_all,) = torch.autograd.grad(space_loss(target, imgs2)[0] + l_mask + l_cam, w, retain_graph=True)
    (g_imgs,) = torch.autograd.grad(space_loss(target, imgs2)[0], w)
    torch.testing.assert_close(g_all, g_imgs, rtol=0, atol=0)
