"""tpugan_torch's Grad-CAM mis-aligned training (``train/e_mis_align.py``,
``cli/e_mis_align.py``) and the other Grad-CAM entry points (``infer_e
--gradcam``, ``embedding --gradcam``) vs tpugan (CPU).

The step is held to tpugan's own ``make_mis_align_step`` on tpugan's tiny
StyleGANv1 of ``tests/test_train.py:207-240`` (startf 8, maxf 32, latent 32)
with one more block, at 32 px: at tpugan's 16 px VGG16's last max pool has a
1x1 map to pool, which torch refuses and tpugan's head averages over nothing
(NaN logits). Both sides take tpugan's flax-init variables (constant leaves
drawn) through the bridge and the same numpy draws: tpugan's closures read
z and the noise from ``frozen`` (the encoder's and the resynthesis's noise
ride in ``SynthBatch.label``), the port's ``draw`` hands them in. VGG16 is
``tests/test_torch_gradcam.py``'s, at 10 classes; batch 5, the CLI's.

Tolerances: every logged scalar at the whole-model rtol 2e-3 / atol 2e-4
(``tests/test_stylegan1.py:134``), the first step's gradient alike, the
parameters after three steps by ``tests/test_torch_sgv1_train.py``'s
LREQAdam rule; the lean step's and ``cam_bf16``'s parameters bitwise the
full fp32 step's.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_gradcam import CLASSES, heatmap_index_steps, jax_variables
from test_torch_sgv1_train import _check_trajectory, _jnoise, _recording, nonzero_leaves
from tpugan.losses.vgg import VGG16 as JVGG16
from tpugan.models.encoders import Encoder as JEncoder
from tpugan.models.stylegan1 import StyleGANv1Generator as JGenerator
from tpugan.models.stylegan1 import StyleGANv1Mapping as JMapping
from tpugan.models.stylegan1 import truncation_coefs as jtruncation_coefs
from tpugan.ops.eq_lr import lreq_coef_tree
from tpugan.optim import lreq_adam as jlreq_adam
from tpugan.train.e_align import SynthBatch as JSynthBatch
from tpugan.train.e_align import info_scalars as jinfo_scalars
from tpugan.train.e_align import init_train_state as jinit_train_state
from tpugan.train.e_mis_align import make_mis_align_step as jmake_mis_align_step
from tpugan.train.e_mis_align import make_mis_align_visuals as jmake_mis_align_visuals
from tpugan_torch.cli import e_mis_align, embedding, infer_e
from tpugan_torch.io.bridge import load_variables
from tpugan_torch.losses.gradcam import grad_cam
from tpugan_torch.losses.vgg import VGG16
from tpugan_torch.models import Encoder, StyleGANv1Generator, StyleGANv1Mapping
from tpugan_torch.ops import cuda
from tpugan_torch.optim import lreq_adam
from tpugan_torch.precision import bf16_frozen
from tpugan_torch.train import MisAlignInfo, make_mis_align_step, make_mis_align_visuals
from tpugan_torch.train.e_align import Request, build_stylegan1_pipeline, info_scalars, init_train_state
from tpugan_torch.train.e_align import make_encode_fn

torch.set_num_threads(2)

LAYERS, IMG, BATCH, LR, STEPS = 4, 32, 5, 0.0015, 3
LOD = LAYERS - 1
GEN_KW = dict(startf=8, maxf=32, layer_count=LAYERS, latent_size=32)
MAP_KW = dict(num_layers=2 * LAYERS, mapping_layers=2, latent_size=32, dlatent_size=32, mapping_fmaps=32)
MODEL_TOL = dict(rtol=2e-3, atol=2e-4)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(0)
    gen, enc = StyleGANv1Generator(**GEN_KW), Encoder(**GEN_KW)
    g_shapes, e_shapes = gen.noise_shapes(BATCH), enc.noise_shapes(BATCH, IMG)

    def noise(shapes):
        return [tuple(rng.randn(*s).astype(np.float32) for s in block) for block in shapes]

    jgen, jgm, je = JGenerator(**GEN_KW), JMapping(**MAP_KW), JEncoder(**GEN_KW)
    key = jax.random.PRNGKey(0)
    gen_vars = jax.tree.map(np.asarray, jax.jit(lambda w, n: jgen.init(key, w, LOD, 1.0, n))(
        jnp.zeros((BATCH, 2 * LAYERS, 32)), _jnoise(_torch_noise(noise(g_shapes)))))
    gm_vars = jax.tree.map(np.asarray, jax.jit(jgm.init)(key, jnp.zeros((1, 32))))
    enc_vars = jax.tree.map(np.asarray, jax.jit(lambda x, n: je.init(key, x, 0, n))(
        jnp.zeros((BATCH, IMG, IMG, 3)), _jnoise(_torch_noise(noise(e_shapes)))))
    gen_vars = {"params": nonzero_leaves(gen_vars["params"], rng)}
    enc_vars = {**enc_vars, "params": nonzero_leaves(enc_vars["params"], rng)}
    inputs = [(rng.randn(BATCH, 32).astype(np.float32), noise(g_shapes), noise(e_shapes), noise(g_shapes))
              for _ in range(STEPS)]
    jvgg, vgg_vars = jax_variables()
    return dict(jgen=jgen, jgm=jgm, je=je, gen_vars=gen_vars, gm_vars=gm_vars, enc_vars=enc_vars,
                inputs=inputs, jvgg=jvgg, vgg_vars=vgg_vars,
                vgg=load_variables(VGG16(num_classes=CLASSES), vgg_vars).requires_grad_(False))


def _torch_noise(blocks):
    return [tuple(torch.from_numpy(n) for n in block) for block in blocks]


# ---------------------------------------------------------------------------
# the two packages' steps


def _jax_closures(setup):
    jgen, jgm, je = setup["jgen"], setup["jgm"], setup["je"]
    extra = {k: v for k, v in setup["enc_vars"].items() if k != "params"}
    coefs = jtruncation_coefs(jgm.num_layers)

    def synth(frozen, key, z):
        w1 = jgm.apply(frozen["gm"], frozen["z"], coefs, None)
        imgs1 = jgen.apply(frozen["gen"], w1, LOD, 1.0, frozen["noise_g"])
        const1 = jnp.repeat(frozen["gen"]["params"]["const"], BATCH, axis=0)
        return JSynthBatch(w1=w1, imgs1=imgs1, const1=const1, label=(frozen["noise_e"], frozen["noise_g2"]))

    def resynth(frozen, w2, batch, key):
        return jgen.apply(frozen["gen"], w2, LOD, 1.0, batch.label[1])

    def encode(params, batch, key):
        return je.apply({**extra, "params": params}, batch.imgs1, 0, batch.label[0])

    return encode, synth, resynth


def _frozen(setup, it):
    z, ng, ne, ng2 = setup["inputs"][it]
    return {"gen": setup["gen_vars"], "gm": setup["gm_vars"], "z": jnp.asarray(z),
            "noise_g": _jnoise(_torch_noise(ng)), "noise_e": _jnoise(_torch_noise(ne)),
            "noise_g2": _jnoise(_torch_noise(ng2))}


def _jax_run(setup):
    """tpugan's make_mis_align_step over STEPS steps: each step's scalars,
    the first step's gradient and the final parameters."""
    encode, synth, resynth = _jax_closures(setup)
    params = setup["enc_vars"]["params"]
    opt = _recording(jlreq_adam(LR, coefs=lreq_coef_tree(params, setup["enc_vars"]["lreq"])), keep=1)
    step = jax.jit(jmake_mis_align_step(
        encode=encode, synth=synth, resynth=resynth, optimizer=opt, vgg=setup["jvgg"], z_dim=32,
        batch_size=BATCH, vgg_guided=JVGG16(num_classes=CLASSES, guided=True)))
    vgg_vars = setup["vgg_vars"]
    state = jinit_train_state(params, opt)
    infos, grad = [], None
    for it in range(STEPS):
        state, info = step(state, jnp.int32(it), _frozen(setup, it), vgg_vars)
        infos.append(jinfo_scalars(info))
        if it == 0:
            grad = _port_named(state.opt_state[-1])
    return infos, grad, _port_named(state.params)


def _port_named(tree):
    from tpugan_torch.io import bridge

    out = {}
    bridge._walk(Encoder(**GEN_KW), jax.tree.map(np.asarray, tree), "", out)
    return out


def _port_models(setup):
    gen = load_variables(StyleGANv1Generator(**GEN_KW), setup["gen_vars"],
                         unused=[f"to_rgb_{i}" for i in range(LOD)])
    gm = load_variables(StyleGANv1Mapping(**MAP_KW), setup["gm_vars"])
    enc = load_variables(Encoder(**GEN_KW), setup["enc_vars"])
    synth_fn, resynth = build_stylegan1_pipeline(gen, gm, LOD, train=True)
    requests = [Request(torch.from_numpy(z), _torch_noise(ng), _torch_noise(ne), _torch_noise(ng2))
                for z, ng, ne, ng2 in setup["inputs"]]
    return dict(gen=gen, gm=gm, enc=enc, encode=make_encode_fn(enc, train=True),
                synth=lambda r: synth_fn(r.z, r.noise_g), resynth=resynth, draw=lambda it: requests[it])


def _port_run(setup, kinds=("full",) * STEPS, cam_bf16=False):
    """The port's steps of ``kinds`` ("full" or "lean"): each step's scalars,
    the gradients taken and the final parameters."""
    m = _port_models(setup)
    vgg = bf16_frozen(setup["vgg"]) if cam_bf16 else setup["vgg"]
    closures = (m["encode"], m["synth"], m["resynth"], m["draw"], vgg)
    steps = {"full": make_mis_align_step(*closures, cam_bf16=cam_bf16),
             "lean": make_mis_align_step(*closures, cam_bf16=cam_bf16, compute_attention_losses=False)}
    state = init_train_state(m["enc"], lreq_adam(m["enc"], LR))
    grads = []
    opt_step = state.optimizer.step
    state.optimizer.step = lambda g=None: (grads.append([x.clone() for x in g]), opt_step(g))
    frozen = [p.clone() for p in (*m["gen"].parameters(), *m["gm"].parameters(), *vgg.parameters())]
    infos = []
    for it, kind in enumerate(kinds):
        state, info = steps[kind](state, it)
        assert isinstance(info, MisAlignInfo)
        infos.append(info_scalars(info))
    after = [*m["gen"].parameters(), *m["gm"].parameters(), *vgg.parameters()]
    assert all(torch.equal(a, b) and a.grad is None for a, b in zip(after, frozen))
    names = [n for n, _ in state.encoder.named_parameters()]
    grad = {n: g.numpy() for n, g in zip(names, grads[0])}
    return infos, grad, {n: p.detach().numpy().copy() for n, p in state.encoder.named_parameters()}


def test_mis_align_step_matches_tpugan(setup):
    """Three full steps: every MisAlignInfo scalar of every step, the first
    step's gradient, the parameters after the three updates."""
    want_infos, want_grad, want_params = _jax_run(setup)
    infos, grad, params = _port_run(setup)
    for it, (got, want) in enumerate(zip(infos, want_infos)):
        assert got.keys() == want.keys()
        assert got["loss_mask_mse"] > 0 and got["loss_gcam_ssim"] > 0 and got["loss_grad_cosine"] > 0
        for key in want:
            np.testing.assert_allclose(got[key], want[key], **MODEL_TOL, err_msg=f"step {it} {key}")
    assert grad.keys() == want_grad.keys()
    for name in want_grad:
        np.testing.assert_allclose(grad[name], want_grad[name], **MODEL_TOL, err_msg=f"gradient of {name}")
    _check_trajectory(Encoder(**GEN_KW), params, want_params, STEPS)


def test_lean_steps_are_bitwise_the_full_trajectory(setup):
    """Full, lean, lean against three full steps: the parameters bit for
    bit; the lean steps' attention scalars zero and their latent ones the
    full steps'."""
    full_infos, _, full = _port_run(setup)
    lean_infos, _, lean = _port_run(setup, ("full", "lean", "lean"))
    for name in full:
        np.testing.assert_array_equal(lean[name], full[name], err_msg=name)
    for got, want in zip(lean_infos[1:], full_infos[1:]):
        assert got["loss_tsa"] == got["loss_mask_mse"] == got["loss_grad_mse"] == got["loss_imgs_ssim"] == 0.0
        assert got["loss_mtv"] == want["loss_mtv"] and got["loss_w_mse"] == want["loss_w_mse"]
        assert got["loss_c_mse"] == want["loss_c_mse"]


def test_cam_bf16_leaves_the_trajectory_bitwise(setup):
    """cam_bf16 runs the VGG16 stack in bf16: the parameters are fp32's bit
    for bit (tpugan's test_mis_align_cam_bf16_close) and the latent scalars
    too; the attention scalars are finite. They are not held to tpugan's
    bf16 ones step by step: a CAM is a sum over 512 channels that nearly
    cancels, so bf16's rounding moves a mask by about 0.02 on average in
    either package, and one scalar's distance is a draw of that noise
    (tests/test_torch_gradcam.py holds the bf16 masks over several
    batches)."""
    infos32, _, fp32 = _port_run(setup)
    infos16, _, bf16 = _port_run(setup, cam_bf16=True)
    for name in fp32:
        np.testing.assert_array_equal(bf16[name], fp32[name], err_msg=name)
    for got, want in zip(infos16, infos32):
        assert all(np.isfinite(v) for v in got.values()) and got["loss_mask_ssim"] > 0
        for key in ("loss_mtv", "loss_w_mse", "loss_c_mse", "loss_imgs_mse", "loss_imgs_ssim"):
            assert got[key] == want[key], key


def test_visuals_match_tpugan(setup):
    """The on-tick dumps at iteration 0: imgs1 and imgs2, the heatmaps (at
    most one colormap step apart at 1% of the pixels), the CAM overlays
    where the heatmaps agree, the guided gradients."""
    encode, synth, resynth = _jax_closures(setup)
    jvis = jax.jit(jmake_mis_align_visuals(encode, synth, resynth, setup["jvgg"],
                                           JVGG16(num_classes=CLASSES, guided=True), 32, BATCH))(
        setup["enc_vars"]["params"], None, jnp.int32(0), _frozen(setup, 0), setup["vgg_vars"])
    m = _port_models(setup)
    state = init_train_state(m["enc"], lreq_adam(m["enc"], LR))
    vis = make_mis_align_visuals(m["encode"], m["synth"], m["resynth"], m["draw"], setup["vgg"])(state, 0)
    assert vis.keys() == jvis.keys()
    for key in ("imgs1", "imgs2", "gb"):
        scale = float(np.abs(jvis[key]).max())
        np.testing.assert_allclose(vis[key].numpy(), np.asarray(jvis[key]), rtol=2e-3, atol=2e-4 * scale,
                                   err_msg=key)
    assert vis["heatmap"].shape == (2 * BATCH, IMG, IMG, 3)
    same = (vis["heatmap"].numpy() == np.asarray(jvis["heatmap"])).all(axis=-1)
    assert same.mean() >= 0.99
    np.testing.assert_allclose(vis["cam"].numpy()[same], np.asarray(jvis["cam"])[same], **MODEL_TOL)


# ---------------------------------------------------------------------------
# the CLIs on the CPU

TINY = ["--mtype", "1", "--img_size", "32", "--start_features", "64", "--random_init", "--device", "cpu"]


@pytest.fixture
def setup_vgg(setup, monkeypatch):
    """The CLIs' VGG16 builder replaced by a copy of the setup's: building
    VGG16's 1000-class init takes about 12 s here, and fc_0 is as large at
    10 classes. test_e_mis_align_cli_trains_and_writes_its_files[fp32] runs
    the CLI's own builder."""
    import copy

    for cli in (e_mis_align, embedding, infer_e):
        monkeypatch.setattr(cli, "build_vgg16", lambda args: copy.deepcopy(setup["vgg"]))


@pytest.mark.parametrize("bf16", [False, True])
def test_e_mis_align_cli_trains_and_writes_its_files(tmp_path, capsys, request, bf16):
    if bf16:
        request.getfixturevalue("setup_vgg")
    cuda.reset_launches()
    out = tmp_path / "out"
    e_mis_align.main(TINY + ["--iterations", "3", "--log_every", "2", "--experiment_dir", str(out)]
                     + (["--bf16"] if bf16 else []))
    assert not any(cuda.launches.values())
    records = [json.loads(line) for line in (out / "Loss.txt").read_text().splitlines()]
    assert [r["iteration"] for r in records] == [0, 2]
    fields = [f"{name}_{k}" for name in MisAlignInfo._fields[:6] for k in
              ("mse", "mse_mean", "mse_std", "kl", "cosine", "ssim", "lpips")] + ["loss_tsa", "loss_mtv"]
    assert set(records[0]) == {"iteration", "epoch", *fields}
    assert all(np.isfinite(v) for r in records for v in r.values()) and records[0]["loss_mask_ssim"] > 0
    for it in (0, 2):
        assert (out / "imgs" / f"ep0_iter{it}.png").exists()
        for kind in ("heatmap", "cam", "gb"):
            # a grid of 2 x 5 images: imgs1's batch of five, then imgs2's
            assert Image.open(out / "grad_cam" / f"{kind}_{it}.png").size == (5 * 34 + 2, 2 * 34 + 2)
    assert bf16 or "VGG16 (Grad-CAM/GBP) weights are RANDOM" in capsys.readouterr().err


def test_e_mis_align_cli_lean_steps_and_defaults(setup, tmp_path):
    args = e_mis_align.parse_args(TINY + ["--iterations", "3"])
    assert args.batch_size == 5 and args.lr == 0.0015
    vgg = setup["vgg"]
    trainer = e_mis_align.build_trainer(args, vgg=vgg)
    assert trainer.lean is not None and not trainer.bundle.encoder.block_0.use_blur
    eager = e_mis_align.build_trainer(e_mis_align.parse_args(TINY + ["--iterations", "3", "--eager_metrics"]),
                                      vgg=vgg)
    assert eager.lean is None
    # refused until slice 7a: --resume and runs past --checkpoint_every build as
    # others do (tests/test_torch_checkpoint.py resumes them), and
    # --vgg_weights loads the converted torchvision VGG16 (a reference-named
    # state dict from a seed, handed over in place of the file)
    for flags in (["--resume"], ["--iterations", "5001"]):
        assert e_mis_align.build_trainer(e_mis_align.parse_args(TINY + flags), vgg=vgg).lean is not None
    from tpugan_torch.io import convert
    from tpugan_torch.tools import reference_state

    state = reference_state.vgg16(np.random.default_rng(0))
    with pytest.MonkeyPatch.context() as mp:
        # the flag names a file, which must exist (io/fetch.py's rule)
        mp.chdir(tmp_path)
        (tmp_path / "vgg16.pth").touch()
        mp.setattr(convert, "load_torch_state_dict", lambda path: state if path == "vgg16.pth" else None)
        loaded = e_mis_align.build_trainer(e_mis_align.parse_args(TINY + ["--vgg_weights", "vgg16.pth"]))
    assert torch.equal(loaded.vgg.head.fc_2.weight, torch.from_numpy(state["classifier.6.weight"]))
    assert torch.equal(loaded.vgg.conv_0.weight, torch.from_numpy(state["features.0.weight"]))


def test_infer_e_gradcam_writes_the_cam_dump(tmp_path, setup_vgg):
    infer_e.main(TINY + ["--gradcam", "--count", "1", "--experiment_dir", str(tmp_path)])
    assert (tmp_path / "imgs" / "cam_seed30000.png").exists()
    assert (tmp_path / "imgs" / "infer_seed30000.png").exists()


def test_infer_e_cam_overlay_is_mask2cam_of_grad_cam(setup):
    from tpugan.losses import gradcam as jgradcam

    x = np.random.RandomState(3).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    got = infer_e.cam_overlay(setup["vgg"], torch.from_numpy(x))
    mask = jgradcam.grad_cam(setup["jvgg"], setup["vgg_vars"], jnp.asarray(x), plus_plus=True)
    _, want = jgradcam.mask2cam(mask, jnp.asarray(x))
    share, steps = heatmap_index_steps(grad_cam(setup["vgg"], torch.from_numpy(x), plus_plus=True).numpy(), mask)
    assert share <= 0.01 and steps <= 1
    if share == 0:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


@pytest.mark.parametrize("bf16", [False, True])
def test_embedding_gradcam_cli_writes_its_files(tmp_path, setup_vgg, bf16):
    img_dir = tmp_path / "img"
    img_dir.mkdir()
    Image.fromarray((np.random.RandomState(0).rand(32, 32, 3) * 255).astype(np.uint8)).save(img_dir / "a.png")
    out = tmp_path / "out"
    embedding.main(TINY + ["--gradcam", "--img_dir", str(img_dir), "--iterations", "2",
                           "--experiment_dir", str(out)] + (["--bf16"] if bf16 else []))
    assert (out / "models" / "id0-i0-w.npy").exists() and (out / "imgs" / "00000_rec.png").exists()
    assert np.isfinite(np.load(out / "models" / "w_all.npy")).all()
