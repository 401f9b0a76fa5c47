"""The kernels as PyTorch operators, ``io/export.py`` and
``cli/export_model.py`` (CPU).

* ``torch.library.opcheck`` on each operator in fp32 and bf16, and their
  CPU route bitwise the plain versions: forward and, through the autograd
  wrappers, the gradient and the FIR's second order.
* tpugan's three export tests (tests/test_export.py) as parity cases: a
  tiny StyleGANv1 synthesis and an E_Blur encoder exported, reloaded
  bitwise, and held to tpugan's ``apply`` through the bridge on numpy-drawn
  w, images and noise (rtol 2e-3 / atol 2e-4, tests/test_stylegan1.py:134);
  a call with another batch refused. The graphs hold one operator node per
  FIR and attention call derived from the modules, and an artifact loads in
  a fresh process that imports neither JAX nor the port's models.
* ``export_model``'s ``main`` on every mtype, synthesis and encode, with
  ``--check`` and ``--platforms cpu`` (``--bf16`` on synthesis); two
  platforms refused.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import draw, nchw, nhwc, randomized
from tpugan.models.encoders import Encoder as JEncoder
from tpugan.models.stylegan1 import StyleGANv1Generator as JGenerator
from tpugan_torch.cli import export_model
from tpugan_torch.io import export
from tpugan_torch.io.bridge import load_variables
from tpugan_torch.models import BigGANConfig, Encoder, StyleGANv1Generator
from tpugan_torch.models.stylegan2 import ModulatedConv, SG2ConvBlock
from tpugan_torch.ops import attention, cuda, upfirdn

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
MODEL_TOL = dict(rtol=2e-3, atol=2e-4)  # tests/test_stylegan1.py:134
KW = dict(startf=8, maxf=32, layer_count=3, latent_size=32)  # tests/test_export.py's widths
DTYPES = [torch.float32, torch.bfloat16]
DTYPE_IDS = ["fp32", "bf16"]


def _t(rng, *shape, dtype=torch.float32):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype)


# ---------------------------------------------------------------------------
# the operators


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("up,down,pads", [(1, 1, [1, 1, 1, 1]), (2, 1, [2, 1, 2, 1]), (1, 2, [1, 1, 1, 1])])
def test_fir_operator_passes_opcheck(rng, dtype, up, down, pads):
    taps = upfirdn.setup_fir_kernel((1, 3, 3, 1))
    x = _t(rng, 2, 3, 7, 9, dtype=dtype)
    torch.library.opcheck(torch.ops.tpugan_torch.upfirdn2d, (x, taps.ravel().tolist(), 4, 4, up, down, pads, "B2"))


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("name", ["sagan_attention", "sagan_attention_lse", "sagan_attention_bwd"])
def test_attention_operators_pass_opcheck(rng, dtype, name):
    q, k, v = _t(rng, 2, 12, 8, dtype=dtype), _t(rng, 2, 5, 8, dtype=dtype), _t(rng, 2, 5, 16, dtype=dtype)
    args = (q, k, v)
    if name == "sagan_attention_bwd":
        o, lse = attention.sagan_attention_plain(q, k, v, return_lse=True)
        args = (q, k, v, o, lse, _t(rng, 2, 12, 16, dtype=dtype))
    torch.library.opcheck(getattr(torch.ops.tpugan_torch, name), args)


FIR_CASES = {
    "blur": dict(taps=(1, 2, 1), up=1, down=1, pad=(1, 1), gain=1.0),
    "up2": dict(taps=(1, 3, 3, 1), up=2, down=1, pad=(2, 1), gain=4.0),
    "down2": dict(taps=(1, 3, 3, 1), up=1, down=2, pad=(1, 1), gain=1.0),
    "negative_pad": dict(taps=(1, 3, 3, 1), up=1, down=1, pad=(-1, 2), gain=1.0),
}


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("case", sorted(FIR_CASES))
def test_fir_cpu_route_is_the_plain_version_bitwise(rng, case, dtype):
    """The operator's CPU route gives the plain version's bits: the output,
    the gradient (the adjoint through ``_UpFirDn2d``) and the second order
    (the adjoint's adjoint, as the R1 penalty takes it); no launch."""
    c = FIR_CASES[case]
    k = upfirdn.setup_fir_kernel(c["taps"])
    cuda.reset_launches()
    x = _t(rng, 2, 3, 8, 8, dtype=dtype).requires_grad_()
    y = upfirdn.upfirdn2d(x, k, c["up"], c["down"], c["pad"], c["gain"])
    with torch.no_grad():
        assert torch.equal(y, upfirdn.upfirdn2d_plain(x, k, c["up"], c["down"], c["pad"], c["gain"]))
    g = _t(rng, *y.shape, dtype=dtype).requires_grad_()
    (gx,) = torch.autograd.grad(y, x, g, create_graph=True)
    taps = upfirdn._taps(k, c["gain"])
    p0, p1 = c["pad"]
    adj = upfirdn.adjoint(8, 8, y.shape[2], y.shape[3], taps, c["up"], c["down"], (p0, p1, p0, p1))
    assert torch.equal(gx.detach(), upfirdn._fir_plain(g.detach(), *adj))
    cx = _t(rng, *x.shape, dtype=dtype)
    (gg,) = torch.autograd.grad(gx, g, cx)
    second = upfirdn.adjoint(y.shape[2], y.shape[3], 8, 8, *adj)
    assert torch.equal(gg, upfirdn._fir_plain(cx, *second))
    assert not any(cuda.launches.values())


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_attention_cpu_route_is_the_plain_version_bitwise(rng, dtype):
    q, k, v = (_t(rng, *s, dtype=dtype).requires_grad_() for s in ((2, 12, 8), (2, 5, 8), (2, 5, 16)))
    cuda.reset_launches()
    out = attention.sagan_attention(q, k, v)
    with torch.no_grad():
        o, lse = attention.sagan_attention_plain(q, k, v, return_lse=True)
        assert torch.equal(out, o)
        got_o, got_lse = attention.sagan_attention(q, k, v, return_lse=True)
        assert torch.equal(got_o, o) and torch.equal(got_lse, lse)
    do = _t(rng, 2, 12, 16, dtype=dtype)
    got = torch.autograd.grad(out, (q, k, v), do)
    want = attention.sagan_attention_bwd_plain(q.detach(), k.detach(), v.detach(), o, lse, do)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not any(cuda.launches.values())


def test_operators_trace_without_a_launch(rng):
    """Under torch.export the operators run their fake implementations: no
    launch is counted, and the graph holds one node per call."""
    x = _t(rng, 2, 8, 8, 8)
    q, k, v = _t(rng, 2, 16, 4), _t(rng, 2, 4, 4), _t(rng, 2, 4, 8)

    def fn(x, q, k, v):
        y = upfirdn.upfirdn2d(upfirdn.blur3x3(x), upfirdn.setup_fir_kernel((1, 3, 3, 1)), down=2, pad=(1, 1))
        return y, attention.sagan_attention(q, k, v), attention.sagan_attention(q, k, v, return_lse=True)

    cuda.reset_launches()
    upfirdn.reset_layout_launches()
    program = export.load_program(export.export_jit(fn, x, q, k, v))
    assert not any(cuda.launches.values()) and not any(upfirdn.layout_launches.values())
    assert export.operator_nodes(program) == {"upfirdn2d": 2, "sagan_attention": 1, "sagan_attention_lse": 1}


# ---------------------------------------------------------------------------
# io/export.py: tpugan's tests/test_export.py as parity cases


def _synthesis(rng):
    """tpugan's tiny StyleGANv1 synthesis and the port's through the bridge,
    on the same numpy noise."""
    styles = rng.randn(2, 6, 32).astype(np.float32)
    gen = StyleGANv1Generator(**KW)
    noise, jnoise = draw(gen.noise_shapes(2), rng)
    jg = JGenerator(**KW)
    gv = randomized(jg.init(jax.random.PRNGKey(0), jnp.asarray(styles), 2, 1.0, jnoise), rng)
    load_variables(gen, gv, unused=("to_rgb_0", "to_rgb_1")).requires_grad_(False)
    holder = export_model.NoiseBuffers(noise)
    return styles, gen, holder, lambda w: gen(w, 2, holder.blocks()), lambda s: jg.apply(gv, s, 2, 1.0, jnoise)


def test_export_synthesis_roundtrip(rng, tmp_path):
    """The frozen synthesis exports and reloads with its live outputs,
    bitwise, from bytes and from a file, and is held to tpugan's; its graph
    holds one FIR node per blur of the generator (every block but the
    first), and its weights and noise are the program's state."""
    styles, gen, holder, synth, jsynth = _synthesis(rng)
    w = torch.from_numpy(styles)
    blob = export.export_jit(synth, w, modules=[gen, holder])
    assert isinstance(blob, bytes) and len(blob) > 0
    program = export.load_program(blob)
    blurs = sum(getattr(gen, f"decode_block_{i}").has_first_conv for i in range(KW["layer_count"]))
    assert export.operator_nodes(program) == {"upfirdn2d": blurs} and blurs == 2
    assert not program.constants, f"constants lifted out of the trace: {list(program.constants)}"
    assert set(program.state_dict) == {f"held.0.{n}" for n, _ in gen.named_parameters()} | {
        f"held.1.{n}" for n, _ in holder.named_buffers()}
    with torch.no_grad():
        ref = synth(w)
    assert torch.equal(export.load_exported(blob)(w), ref)
    path = str(tmp_path / "synth.pt2")
    export.save_exported(path, synth, w, modules=[gen, holder])
    assert torch.equal(export.load_exported_file(path)(w), ref)
    np.testing.assert_allclose(nhwc(ref), np.asarray(jsynth(jnp.asarray(styles))), **MODEL_TOL)


def test_export_encoder_roundtrip(rng):
    """E_Blur's forward (tuple outputs) survives export, bitwise, and is held
    to tpugan's; one FIR node per blur."""
    x = np.tanh(rng.randn(2, 16, 16, 3)).astype(np.float32)
    enc = Encoder(**KW, use_blur=True)
    noise, jnoise = draw(enc.noise_shapes(2, 16), rng)
    je = JEncoder(**KW, use_blur=True)
    ev = randomized(je.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x), 0, jnoise), rng)
    load_variables(enc, ev).requires_grad_(False)
    holder = export_model.NoiseBuffers(noise)
    blob = export.export_jit(lambda imgs: enc(imgs, holder.blocks()), nchw(x), modules=[enc, holder])
    blocks = [getattr(enc, f"block_{i}") for i in range(enc.layer_count)]
    blurs = sum(b.use_blur and b.has_last_conv and b.block_version == 2 for b in blocks)
    program = export.load_program(blob)
    assert export.operator_nodes(program) == {"upfirdn2d": blurs} and blurs > 0
    with torch.no_grad():
        c_ref, w_ref = enc(nchw(x), holder.blocks())
    c, w = export.load_exported(blob)(nchw(x))
    assert torch.equal(c, c_ref) and torch.equal(w, w_ref)
    jc, jw = je.apply(ev, jnp.asarray(x), 0, jnoise)
    np.testing.assert_allclose(nhwc(c), np.asarray(jc), **MODEL_TOL)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **MODEL_TOL)


def test_export_shape_check():
    """Artifacts are shape-specialised: another batch raises."""
    f = export.load_exported(export.export_jit(lambda x: x * 2.0, torch.zeros(2, 4)))
    assert torch.equal(f(torch.ones(2, 4)), torch.full((2, 4), 2.0))
    with pytest.raises(Exception):
        f(torch.zeros(3, 4))


@pytest.mark.parametrize("platforms,match", [(("cuda", "cpu"), "one platform"), (("tpu",), "unknown platform"),
                                             (("cuda",), "example inputs lie on cpu")])
def test_export_refuses_platforms(platforms, match):
    with pytest.raises(ValueError, match=match):
        export.export_jit(lambda x: x + 1.0, torch.zeros(2), platforms=platforms)


def test_artifact_loads_in_a_fresh_process_without_the_models(rng, tmp_path):
    """A process that imports ``tpugan_torch.io.export`` alone loads and
    runs the synthesis artifact, bitwise the parent's output, with neither
    JAX nor the port's models, training or CLIs imported."""
    styles, gen, holder, synth, _ = _synthesis(rng)
    w = torch.from_numpy(styles)
    export.save_exported(str(tmp_path / "synth.pt2"), synth, w, modules=[gen, holder])
    torch.save(w, tmp_path / "w.pt")
    code = (
        "import sys, json, torch\n"
        "torch.set_num_threads(1)  # as here: the CPU's convolutions sum by thread\n"
        "from tpugan_torch.io.export import load_exported_file\n"
        f"f = load_exported_file({str(tmp_path / 'synth.pt2')!r})\n"
        f"torch.save(f(torch.load({str(tmp_path / 'w.pt')!r})), {str(tmp_path / 'out.pt')!r})\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'tpugan') or "
        "m.startswith(('tpugan_torch.models', 'tpugan_torch.train', 'tpugan_torch.cli')))))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    assert json.loads(done.stdout.strip().splitlines()[-1]) == []
    with torch.no_grad():
        assert torch.equal(torch.load(tmp_path / "out.pt"), synth(w))


# ---------------------------------------------------------------------------
# cli/export_model.py

BIGGAN_CFG = dict(
    output_dim=32, z_dim=8, class_embed_dim=8, channel_width=4, num_classes=10,
    layers=[(False, 16, 16), (True, 16, 8), (True, 8, 4), (True, 4, 2), (False, 2, 1)],
    attention_layer_position=2, eps=1e-4, n_stats=51,
)  # tests/test_torch_train.py::CFG


def _argv(tmp_path, mtype):
    common = ["--img_size", "32", "--random_init", "--batch_size", "2"]
    if mtype == 4:
        config = tmp_path / "config.json"
        config.write_text(BigGANConfig(**BIGGAN_CFG).to_json_string())
        return ["--mtype", "4", "--start_features", "16", "--z_dim", "8", "--config_dir", str(config), *common]
    return ["--mtype", str(mtype), "--start_features", "64", *common]


def _derived_nodes(mtype, what, module):
    """The operator calls of one artifact call, from its generator or
    encoder: SGv1's blurs (every generator block but the first), StyleGAN2's
    up-sampling FIRs and skip up-2s, BigGAN's SelfAttn, E_Blur's blurs."""
    if what == "encode":
        blocks = [getattr(module, f"block_{i}") for i in range(module.layer_count)]
        n = sum(getattr(b, "use_blur", False) and b.has_last_conv and b.block_version == 2 for b in blocks)
        return {"upfirdn2d": n} if n else {}
    if mtype == 1:
        return {"upfirdn2d": sum(getattr(module, f"decode_block_{i}").has_first_conv
                                 for i in range(module.layer_count))}
    if mtype == 2:
        synthesis = module.synthesis
        n = sum(isinstance(m, (ModulatedConv, SG2ConvBlock)) and m.scale_factor == 2 for m in synthesis.modules())
        n += sum(name.startswith("output") for name, _ in synthesis.named_children()) - 1
        return {"upfirdn2d": n}
    if mtype == 4:
        return {"sagan_attention": sum(type(m).__name__ == "SelfAttn" for m in module.modules())}
    return {}


@pytest.mark.parametrize("what", ["synthesis", "encode"])
@pytest.mark.parametrize("mtype", [1, 2, 3, 4])
def test_export_model_main_checks_its_artifact(tmp_path, capsys, mtype, what):
    """``main`` writes the artifact, reloads it and matches the live function
    bitwise (``--check``); synthesis with the bf16 generator baked in; the
    graph's operator nodes are the calls derived from the modules; nothing
    launches."""
    extra = ["--bf16"] if what == "synthesis" else ["--ablation", "8"] if mtype == 1 else []
    cuda.reset_launches()
    out = export_model.main(_argv(tmp_path, mtype) + ["--what", what, "--out", str(tmp_path / "a.pt2"),
                                                     "--platforms", "cpu", "--check", *extra])
    assert "check ok" in capsys.readouterr().out
    assert not any(cuda.launches.values())
    assert out.nodes == _derived_nodes(mtype, what, out.modules[0])
    assert bool(out.nodes) == ((mtype, what) in ((1, "synthesis"), (2, "synthesis"), (4, "synthesis"),
                                                 (1, "encode")))
    if what == "synthesis":
        assert {p.dtype for p in out.modules[0].parameters()} == {torch.bfloat16}
    result = export.load_exported_file(out.path)(*out.example)
    assert all(torch.isfinite(t).all() for t in (result if isinstance(result, tuple) else (result,)))


def test_export_model_refuses_two_platforms(tmp_path):
    with pytest.raises(ValueError, match="one platform"):
        export_model.main(_argv(tmp_path, 1) + ["--out", str(tmp_path / "a.pt2"), "--platforms", "cuda",
                                                "--platforms", "cpu"])
    assert not (tmp_path / "a.pt2").exists()
