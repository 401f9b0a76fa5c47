"""The attention kernels' bf16 forms and ``e_align --mtype 4 --bf16`` (E_BIG
on BigGAN-deep in tpugan's bf16 scheme) against tpugan on the CPU.

* B3 and B4 on bf16: the plain versions (fp32 sums, results in the inputs'
  dtype) against tpugan's Pallas kernels in interpret mode on the same bf16
  values; the forward within one bf16 ulp, its logsumexp within
  tests/test_attention.py's 1e-5, the gradients within one bf16 ulp plus
  the fp32 backward's 2e-4 (each side sums in fp32 in its own order, then
  rounds once), through the plain backward and through the differentiable
  ``sagan_attention``.
* The card's route: the CUDA wrappers run on CPU tensors with each C entry
  point replaced by a stand-in that computes the plain version on the
  memory it is handed (read through the addresses, as the kernel reads
  them) and records the call: bf16 tensors reach the bf16 entry points
  themselves, with no cast copy, and delta is fp32.
* BigGAN-deep's bf16 synthesis and a bf16 E_BIG case-2 step against
  tpugan's bf16 runs on the same bridged weights and inputs, held by
  ``assert_as_close_as_tpugan`` (twice tpugan's own bf16 distance from its
  fp32 run); tpugan's side under ``jax.jit``, as its CLI runs it.
* The CLI's bf16 lean steps.
"""

import ctypes
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_attention import LSE_TOL, PALLAS_CASES, qkv
from test_torch_attention_bwd import BWD_TOL
from test_torch_bf16 import assert_as_close_as_tpugan
from test_torch_biggan import nhwc, randomized
from test_torch_fir_plan import assert_within_one_bf16_ulp
from test_torch_train import BATCH, CFG, LR, _as_port, _port_encoder, _recording, _tiny_argv, setup  # noqa: F401
from tpugan import precision as jprecision
from tpugan.models import BigGAN as JBigGAN
from tpugan.models import BigGANConfig as JBigGANConfig
from tpugan.ops.eq_lr import lreq_coef_tree
from tpugan.ops.pallas.attention import sagan_attention_bwd_pallas, sagan_attention_pallas
from tpugan.optim import lreq_adam as jlreq_adam
from tpugan.train.e_align import SynthBatch as JSynthBatch
from tpugan.train.e_align import info_scalars as jinfo_scalars
from tpugan.train.e_align import init_train_state as jinit_train_state
from tpugan.train.e_align import make_train_step as jmake_train_step
from tpugan_torch import precision
from tpugan_torch.cli import e_align
from tpugan_torch.io.bridge import load_variables
from tpugan_torch.models import BigGAN, BigGANConfig
from tpugan_torch.ops import attention, cuda
from tpugan_torch.optim import lreq_adam
from tpugan_torch.train.e_align import (
    Request,
    build_biggan_pipeline,
    info_scalars,
    init_train_state,
    make_encode_fn,
    make_train_step,
)

torch.set_num_threads(1)

BF = jnp.bfloat16


def bf16_qkv(rng, q_shape, k_shape, v_shape, scale=1.0):
    """bf16 q, k, v for both packages: jax arrays and the same values as torch tensors."""
    arrays = [jnp.asarray(x, BF) for x in qkv(rng, q_shape, k_shape, v_shape, scale)]
    return arrays, [to_torch(a) for a in arrays]


def to_torch(a):
    """A jax array as a torch tensor of the same dtype and values."""
    t = torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32)))
    return t.bfloat16() if a.dtype == BF else t


def assert_within_one_ulp_and_tol(got, want, rtol, atol):
    """bf16 results of fp32 sums of two orders that meet the fp32
    contract (rtol, atol) before each rounds once: within one bf16 ulp of
    the larger magnitude plus that contract."""
    g, w = got.float(), want.float()
    assert g.shape == w.shape
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(torch.finfo(torch.bfloat16).tiny)
    ulp = torch.finfo(torch.bfloat16).eps * torch.exp2(torch.floor(torch.log2(mag)))
    err = (g - w).abs()
    bad = err > ulp + atol + rtol * w.abs()
    assert not bool(bad.any()), f"{int(bad.sum())} of {bad.numel()} out; max |err| {float(err.max()):.3e}"


# ---------------------------------------------------------------------------
# (a) B3 and B4 on bf16


@pytest.mark.parametrize("name", sorted(PALLAS_CASES))
def test_bf16_plain_forward_matches_pallas(rng, name):
    q_shape, k_shape, v_shape, scale, _, _ = PALLAS_CASES[name]
    (jq, jk, jv), (q, k, v) = bf16_qkv(rng, q_shape, k_shape, v_shape, scale)
    ref, ref_lse = sagan_attention_pallas(jq, jk, jv, block_q=128, block_k=128, interpret=True,
                                          return_lse=True)
    out, lse = attention.sagan_attention(q, k, v, return_lse=True)
    assert ref.dtype == BF and out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert_within_one_bf16_ulp(out, to_torch(ref))
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), **LSE_TOL)
    # fp32 sums, one rounding: the fp32 plain version on the same values, rounded
    assert torch.equal(out, attention.sagan_attention(q.float(), k.float(), v.float()).bfloat16())


# tests/test_attention.py:59-80's case, and the path's widths (dk 64, dv 256)
BWD_CASES = {
    "contract": ((2, 256, 16), (2, 384, 16), (2, 384, 32), 2.0),
    "path_widths": ((1, 256, 64), (1, 128, 64), (1, 128, 256), 0.5),
}


@pytest.mark.parametrize("route", ["plain", "function"])
@pytest.mark.parametrize("name", sorted(BWD_CASES))
def test_bf16_backward_matches_pallas(rng, name, route):
    """The plain backward on bf16 inputs, and the gradients of a bf16
    ``sagan_attention`` with requires_grad inputs, against tpugan's Pallas
    backward on the same bf16 values (q, k, v, the forward's o and lse, do):
    fp32 sums, gradients in the inputs' dtype."""
    q_shape, k_shape, v_shape, scale = BWD_CASES[name]
    (jq, jk, jv), (q, k, v) = bf16_qkv(rng, q_shape, k_shape, v_shape, scale)
    jdo = jnp.asarray(rng.randn(q_shape[0], q_shape[1], v_shape[2]).astype(np.float32), BF)
    do = to_torch(jdo)
    with torch.no_grad():
        o, lse = attention.sagan_attention(q, k, v, return_lse=True)
    want = sagan_attention_bwd_pallas(jq, jk, jv, jnp.asarray(o.float().numpy(), BF), jnp.asarray(lse.numpy()),
                                      jdo, block_q=128, block_k=128, interpret=True)
    if route == "plain":
        got = attention.sagan_attention_bwd_plain(q, k, v, o, lse, do)
    else:
        t = [x.clone().requires_grad_() for x in (q, k, v)]
        out = attention.sagan_attention(*t)
        assert type(out.grad_fn).__name__ == "_SaganAttentionBackward" and torch.equal(out.detach(), o)
        got = torch.autograd.grad(out, t, do)
    for label, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and w.dtype == BF, label
        assert_within_one_ulp_and_tol(g, to_torch(w), **BWD_TOL)


def test_plain_backward_keeps_float64():
    """The plain backward computes in fp32 from bf16 and in float64 from
    float64 (chip_smoke.py's reference), never below its inputs."""
    rng = np.random.RandomState(3)
    t = [torch.from_numpy(x).double().requires_grad_() for x in qkv(rng, (1, 16, 8), (1, 8, 8), (1, 8, 8))]
    s = torch.bmm(t[0], t[1].transpose(1, 2))
    o = torch.bmm(torch.softmax(s, -1), t[2])
    do = torch.randn(1, 16, 8, dtype=torch.float64)
    want = torch.autograd.grad(o, t, do)
    got = attention.sagan_attention_bwd_plain(*(x.detach() for x in t), o.detach(),
                                              torch.logsumexp(s, -1, keepdim=True).detach(), do)
    assert all(g.dtype == torch.float64 for g in got)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# (b) the card's route through the C entry points


def _view(address, shape, dtype):
    """The memory at ``address`` as a tensor (a view, as a kernel reads it)."""
    size = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    return torch.frombuffer((ctypes.c_byte * size).from_address(address), dtype=dtype).view(shape)


class FakeEntryPoints:
    """Stand-ins for the attention kernels' C entry points: each reads the
    tensors it is handed through their addresses, in its entry point's
    element type (lse and delta fp32), computes the plain version and writes
    its outputs there; every call is recorded with its arguments."""

    def __init__(self):
        self.calls = []
        self.packed = {}

    def kernel(self, name):
        dtype = torch.bfloat16 if name.endswith("_bf16") else torch.float32
        part = name.removesuffix("_bf16").removeprefix("sagan_attention")

        def fn(*args):
            self.calls.append((name, args))
            *ptrs, n, lq, lk, dk, dv, _, _ = args
            shapes = {"q": (n, lq, dk), "k": (n, lk, dk), "v": (n, lk, dv), "o": (n, lq, dv)}
            if part == "":
                q, k, v, o = (_view(p, shapes[x], dtype) for p, x in zip(ptrs, "qkvo"))
                out, lse = attention.sagan_attention_plain(q, k, v, return_lse=True)
                o.copy_(out)
                if ptrs[4] is not None:
                    _view(ptrs[4], (n, lq, 1), torch.float32).copy_(lse)
            elif part == "_bwd_pack":
                q, k, v, do = (_view(p, shapes[x], dtype).float() for p, x in zip(ptrs, "qkvo"))
                self.packed[ptrs[4]] = dict(q=q, k=k, v=v, do=do)
            elif part == "_bwd_dq":
                w = self.packed[ptrs[5]]
                lse = _view(ptrs[2], (n, lq, 1), torch.float32)
                w["delta"] = delta = _view(ptrs[3], (n, lq), torch.float32).clone()
                w["p"] = p = torch.exp(torch.bmm(w["q"], w["k"].transpose(1, 2)) - lse)
                w["ds"] = ds = p * (torch.bmm(w["do"], w["v"].transpose(1, 2)) - delta[..., None])
                _view(ptrs[4], shapes["q"], dtype).copy_(torch.bmm(ds, w["k"]))
            else:
                w = self.packed[ptrs[0]]
                _view(ptrs[1], shapes["k"], dtype).copy_(torch.bmm(w["ds"].transpose(1, 2), w["q"]))
                _view(ptrs[2], shapes["v"], dtype).copy_(torch.bmm(w["p"].transpose(1, 2), w["do"]))
            return 0

        return fn


@pytest.fixture
def fake_card(monkeypatch):
    """CPU tensors take the CUDA route: the dispatchers and the device check
    let them through, the stream is 0, and the entry points are
    :class:`FakeEntryPoints`."""
    fake = FakeEntryPoints()
    monkeypatch.setattr(attention, "_on_card", lambda x: True)
    monkeypatch.setattr(attention, "_check_device", lambda tensors, name: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(cuda, "kernel", fake.kernel)
    monkeypatch.setattr(cuda, "helper", lambda name: lambda *dims: 4)
    cuda.reset_launches()
    yield fake
    cuda.reset_launches()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_card_route_hands_the_callers_tensors_to_the_entry_point_of_their_dtype(rng, fake_card, dtype):
    """A differentiable call and its gradient: the forward with the lse and
    pack, dq and dkv of the inputs' dtype, each once, and none of the other
    dtype; the entry points read q, k, v and do where the caller's tensors
    lie (no cast copy); delta is fp32, ``rowsum(do o)`` summed in fp32; the
    output and gradients in the inputs' dtype, the plain version's."""
    q, k, v = (torch.from_numpy(x).to(dtype).requires_grad_() for x in qkv(rng, (2, 24, 8), (2, 12, 8),
                                                                           (2, 12, 16), 2.0))
    do = torch.from_numpy(rng.randn(2, 24, 16).astype(np.float32)).to(dtype)
    out = attention.sagan_attention(q, k, v)
    got = torch.autograd.grad(out, (q, k, v), do)
    names = attention.BWD_KERNELS_OF_DTYPE[dtype]
    assert [name for name, _ in fake_card.calls] == [attention.KERNEL_OF_DTYPE[dtype], *names]
    assert cuda.launches == {**{name: 0 for name in cuda.KERNELS},
                             **{name: 1 for name in (attention.KERNEL_OF_DTYPE[dtype], *names)}}
    (_, fwd), (_, pack), (_, dq), _ = fake_card.calls
    ptrs = [x.data_ptr() for x in (q, k, v)]
    assert list(fwd[:3]) == ptrs and fwd[4] is not None  # the lse form, for the backward
    assert list(pack[:4]) == ptrs + [do.data_ptr()] and dq[:2] == (ptrs[0], do.data_ptr())
    delta = fake_card.packed[pack[4]]["delta"]
    assert torch.equal(delta, (do.float() * out.detach().float()).sum(-1))
    assert out.dtype == dtype and all(g.dtype == dtype for g in got)
    with torch.no_grad():
        o, lse = attention.sagan_attention_plain(q, k, v, return_lse=True)
    assert torch.equal(out.detach(), o)
    for g, w in zip(got, attention.sagan_attention_bwd_plain(q.detach(), k.detach(), v.detach(), o, lse, do)):
        assert_within_one_bf16_ulp(g, w)


def test_bf16_entry_points_are_registered_for_sm90a():
    """The four bf16 entry points, beside their fp32 ones: the same sources
    and libraries (built for sm_90a), symbols exported with the fp32 ones'
    arguments, and counted apart."""
    assert "arch=compute_90a,code=sm_90a" in cuda.NVCC_FLAGS
    pairs = [(f32, bf16) for dtype in (torch.float32,) for f32, bf16 in zip(
        (attention.KERNEL_OF_DTYPE[dtype], *attention.BWD_KERNELS_OF_DTYPE[dtype]),
        (attention.KERNEL_OF_DTYPE[torch.bfloat16], *attention.BWD_KERNELS_OF_DTYPE[torch.bfloat16]))]
    assert [bf16 for _, bf16 in pairs] == ["sagan_attention_bf16", "sagan_attention_bwd_pack_bf16",
                                           "sagan_attention_bwd_dq_bf16", "sagan_attention_bwd_dkv_bf16"]
    for f32, bf16 in pairs:
        source, symbol, argtypes = cuda.KERNELS[bf16]
        assert source == cuda.KERNELS[f32][0] and argtypes == cuda.KERNELS[f32][2]
        assert symbol == cuda.KERNELS[f32][1].replace("_f32", "_bf16")
        assert cuda.library_path(bf16) == cuda.library_path(f32)
        text = (cuda.CSRC / source).read_text()
        declaration = f'extern "C" int {symbol}('
        assert declaration in text and "__nv_bfloat16*" in text.split(declaration)[1].split(")")[0]
        assert bf16 in cuda.launches


# ---------------------------------------------------------------------------
# (c) BigGAN-deep and E_BIG in bf16

# tests/test_bf16.py::test_bf16_biggan_synthesis_close
SYNTH_CFG = dict(output_dim=32, z_dim=16, class_embed_dim=16, channel_width=8, num_classes=10,
                 layers=[(False, 16, 16), (True, 16, 8), (True, 8, 4), (True, 4, 2), (True, 2, 1)],
                 attention_layer_position=2)
BF16_IMAGE_GATE = 0.05  # tests/test_bf16.py::test_bf16_biggan_synthesis_close


@pytest.mark.parametrize("weights", ["init", "drawn"])
def test_bf16_biggan_synthesis_matches_tpugan(rng, weights):
    """BigGAN-deep's images and condition vector from a bf16 copy of the
    generator (z and the label bf16), against tpugan's: as close to
    tpugan's fp32 run as tpugan's bf16 run is, twice over; on flax's init
    (gamma 0, tpugan's own test) and with every parameter drawn and gamma
    1, so that the attention counts. tpugan's fixed gate is printed."""
    jmodel = JBigGAN(JBigGANConfig(**SYNTH_CFG))
    z = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (2, SYNTH_CFG["z_dim"])))
    label = np.eye(10, dtype=np.float32)[[1, 7]]
    variables = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0), jnp.asarray(z), jnp.asarray(label),
                                                     0.4))
    if weights == "drawn":
        variables = randomized(variables, rng)
        for node in variables["params"]["generator"].values():
            if "gamma" in node:
                node["gamma"] = np.ones_like(node["gamma"])
    apply = jax.jit(jmodel.apply, static_argnums=3)
    j32 = apply(variables, jnp.asarray(z), jnp.asarray(label), 0.4)
    j16 = apply(jprecision.cast_floating(variables, BF), jnp.asarray(z, BF), jnp.asarray(label, BF), 0.4)
    port = load_variables(BigGAN(BigGANConfig(**SYNTH_CFG)), variables).eval().requires_grad_(False)
    with torch.no_grad():
        img, cond = precision.bf16_frozen(port)(torch.from_numpy(z).bfloat16(),
                                                torch.from_numpy(label).bfloat16(), 0.4)
    assert img.dtype == cond.dtype == torch.bfloat16
    for what, mine, theirs16, theirs32 in (("image", nhwc(img.float()), j16[0], j32[0]),
                                           ("condition", cond.float().numpy(), j16[1], j32[1])):
        port_err, jax_err = assert_as_close_as_tpugan(mine, np.asarray(theirs16, np.float32),
                                                      np.asarray(theirs32), what)
        if what == "image":
            print(f"BigGAN bf16 images, {weights} weights: max |err| from tpugan's fp32 images: port "
                  f"{port_err:.4f}, tpugan {jax_err:.4f}; tpugan's gate {BF16_IMAGE_GATE}: "
                  f"{'held' if port_err < BF16_IMAGE_GATE else 'not held'}")


def _tpugan_first_step(setup, bf16):
    """tpugan's case-2 step on the tiny config (no LPIPS, as the CLI without
    --lpips_weights), fp32 or in its bf16 scheme (bf16_pipeline,
    bf16_encode, bf16_frozen): loss_tsa and the step's two gradients. z and
    the encoder's noise follow the dtype the wrappers hand in, as tpugan
    draws them."""
    jmodel, je = setup["jmodel"], setup["je"]
    enc_vars = setup["enc_vars"]
    # jax arrays, as tpugan's CLI holds them (numpy's bf16 promotes against
    # a Python float, where jax's does not)
    enc_extra = {k: jax.tree.map(jnp.asarray, v) for k, v in enc_vars.items() if k not in ("params", "sn")}

    def synth(frozen, key, z):
        zt = frozen["zt"].astype(z.dtype)
        imgs1, cond = jmodel.apply(frozen["gen"], zt, frozen["label"], 0.4)
        return JSynthBatch(w1=zt, imgs1=imgs1, const1=cond, label=(frozen["label"], frozen["noise"]))

    def resynth(frozen, w2, batch, key):
        return jmodel.apply(frozen["gen"], w2, batch.label[0], 0.4)[0]

    def encode(params, batch, key, sn=None):
        noise = [tuple(n.astype(batch.imgs1.dtype) for n in b) for b in batch.label[1]]
        return je.apply({**enc_extra, "params": params, "sn": sn}, batch.imgs1, batch.const1, noise)

    gen = setup["gen_vars"]
    if bf16:
        synth, resynth = jprecision.bf16_pipeline(synth, resynth)
        encode = jprecision.bf16_encode(encode)
        gen = jprecision.bf16_frozen(gen)
    opt = _recording(jlreq_adam(LR, coefs=lreq_coef_tree(enc_vars["params"], enc_vars["lreq"])))
    step = jax.jit(jmake_train_step(encode=encode, synth=synth, resynth=resynth, optimizer=opt, z_dim=8,
                                    batch_size=BATCH, case=2))
    zt, label, _, jnoise = setup["inputs"][0]
    frozen = {"gen": gen, "zt": jnp.asarray(zt), "label": jnp.asarray(label), "noise": jnoise}
    state, info = step(jinit_train_state(enc_vars["params"], opt, sn=enc_vars["sn"]), jnp.int32(0), frozen)
    return jinfo_scalars(info)["loss_tsa"], state.opt_state[1:]


def _port_first_step(setup, bf16):
    """The port's case-2 step on the same weights and inputs, fp32 or bf16:
    loss_tsa, the two gradients, the encoder and the generator the step ran."""
    gen = load_variables(BigGAN(BigGANConfig(**CFG)), setup["gen_vars"]).eval().requires_grad_(False)
    enc = _port_encoder(setup)
    if bf16:
        gen = precision.bf16_frozen(gen)
    synth_fn, resynth = build_biggan_pipeline(gen, train=True)
    encode = make_encode_fn(enc, conditional=True, train=True)
    if bf16:
        synth_fn, resynth = precision.bf16_pipeline(synth_fn, resynth)
        encode = precision.bf16_encode(encode, enc)
    zt, label, noise, _ = setup["inputs"][0]
    request = Request(torch.from_numpy(zt), None, noise, None, torch.from_numpy(label))
    step = make_train_step(encode, lambda r: synth_fn(r.z, r.label), resynth, lambda it: request, case=2)
    state = init_train_state(enc, lreq_adam(enc, LR))
    grads = []
    step_with = state.optimizer.step
    state.optimizer.step = lambda g=None: (grads.append([x.clone() for x in g]), step_with(g))
    frozen = [t.clone() for t in [*gen.parameters(), *gen.buffers()]]
    state, info = step(state, 0)
    assert all(torch.equal(a, b) for a, b in zip([*gen.parameters(), *gen.buffers()], frozen))
    return info_scalars(info)["loss_tsa"], grads, state.encoder, gen


def test_bf16_case2_step_matches_tpugan(setup):
    """A bf16 E_BIG case-2 step (the bf16 BigGAN with every gamma 1, so
    that the attention's backward reaches E_BIG; the z head scaled) against
    tpugan's: loss_tsa within 3% of fp32 (tpugan's gate), each of the two
    gradients as close to tpugan's fp32 one as tpugan's bf16 one is, twice
    over; the masters, their gradients and the spectral-norm pair fp32, the
    generator bf16 and frozen."""
    j32_loss, j32_grads = _tpugan_first_step(setup, bf16=False)
    j16_loss, j16_grads = _tpugan_first_step(setup, bf16=True)
    p32_loss, _, _, _ = _port_first_step(setup, bf16=False)
    loss, grads, enc, gen = _port_first_step(setup, bf16=True)
    np.testing.assert_allclose(p32_loss, j32_loss, rtol=2e-3)
    for ref in (j32_loss, p32_loss):
        assert abs(loss - ref) / abs(ref) < 0.03, (loss, ref)
    assert abs(j16_loss - j32_loss) / abs(j32_loss) < 0.03
    assert all(t.dtype == torch.bfloat16 for t in [*gen.parameters(), *gen.buffers()])
    assert all(p.dtype == torch.float32 for p in enc.parameters())
    assert all(b.dtype == torch.float32 for n, b in enc.named_buffers() if n.endswith((".u", ".v")))
    assert len(grads) == 2 and all(g.dtype == torch.float32 for gs in grads for g in gs)
    names = [n for n, _ in enc.named_parameters()]
    for k, (g16, g32) in enumerate(zip(j16_grads, j32_grads)):
        want16 = dict(_as_port(setup, {"params": g16}).named_parameters())
        want32 = dict(_as_port(setup, {"params": g32}).named_parameters())
        mine = np.concatenate([grads[k][names.index(n)].numpy().ravel() for n in names])
        theirs16 = np.concatenate([want16[n].detach().numpy().ravel() for n in names])
        theirs32 = np.concatenate([want32[n].detach().numpy().ravel() for n in names])
        assert_as_close_as_tpugan(mine, theirs16, theirs32, f"gradient {k}")
    assert float(grads[0][names.index("block_0.conv_1.weight")].abs().max()) > 0


def test_bf16_step_on_the_card_route_launches_only_the_bf16_forms(fake_card, tmp_path):
    """The CLI's bf16 trainer (mtype 4, the tiny config) on the card's
    route: a case-2 step launches the bf16 forward twice (the synthesis
    without lse, the resynthesis with it) and pack, dq and dkv once, a
    case-1 step the forward twice, a lean step once; no fp32 attention."""
    want = {"2": {"sagan_attention_bf16": 2, "sagan_attention_bwd_pack_bf16": 1,
                  "sagan_attention_bwd_dq_bf16": 1, "sagan_attention_bwd_dkv_bf16": 1},
            "1": {"sagan_attention_bf16": 2}, "lean": {"sagan_attention_bf16": 1}}
    for case in ("2", "1"):
        args = e_align.make_parser().parse_args(_tiny_argv(tmp_path, "--bf16", "--case", case, "--iterations", "1"))
        trainer = e_align.build_trainer(args)
        for label, step in ((case, trainer.step), ("lean", trainer.lean)):
            if step is None:
                continue
            cuda.reset_launches()
            _, info = step(trainer.state, 0)
            assert cuda.launches == {**{name: 0 for name in cuda.KERNELS}, **want[label]}, label
            assert math.isfinite(info_scalars(info)["loss_mtv"])


def test_cli_bf16_lean_steps_leave_the_trajectory_alone(tmp_path):
    """mtype 4 in bf16, case 1: lean steps after the first leave E_BIG
    bitwise where full steps put it."""
    runs = []
    for lean in (False, True):
        args = e_align.make_parser().parse_args(_tiny_argv(tmp_path, "--bf16", "--case", "1", "--iterations", "3"))
        trainer = e_align.build_trainer(args)
        state = trainer.state
        for it in range(3):
            state, _ = (trainer.lean if lean and it else trainer.step)(state, it)
        runs.append(state.encoder.state_dict())
    assert all(torch.equal(runs[0][n], runs[1][n]) for n in runs[0])
