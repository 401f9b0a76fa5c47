"""tpugan_torch's E_BIG train step (cases 1 and 2, and the lean step) vs
tpugan's own ``make_train_step`` (CPU).

Both sides train the same E_BIG against the same frozen BigGAN (weights
through the bridge, every SelfAttn gamma at 1 so the attention's gradient
reaches the encoder). tpugan's closures are built to return the injected
batch and apply the injected noise: its synth reads zt, the label and the
encoder's noise from ``frozen`` (the noise rides in ``SynthBatch.label``).
The port's step gets the same inputs through ``draw``. LPIPS has the same
random weights on both sides, in case 2.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_biggan import draw, randomized
from tpugan.losses.lpips import make_lpips_fn as jmake_lpips_fn
from tpugan.losses.lpips import random_params as jlpips_params
from tpugan.models.biggan import BigGAN as JBigGAN
from tpugan.models.biggan import BigGANConfig as JConfig
from tpugan.models.encoders import BigGANEncoder as JEncoder
from tpugan.ops.eq_lr import lreq_coef_tree
from tpugan.optim import lreq_adam as jlreq_adam
from tpugan.train.e_align import SynthBatch as JSynthBatch
from tpugan.train.e_align import info_scalars as jinfo_scalars
from tpugan.train.e_align import init_train_state as jinit_train_state
from tpugan.train.e_align import make_train_step as jmake_train_step
from tpugan_torch.cli import e_align
from tpugan_torch.io.bridge import load_variables
from tpugan_torch.losses.lpips import LPIPS, make_lpips_fn
from tpugan_torch.models import BigGAN, BigGANConfig, BigGANEncoder
from tpugan_torch.ops import cuda
from tpugan_torch.ops.eq_lr import lreq_coefs
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

# a 32 px BigGAN-deep (tests/test_biggan.py::tiny_config's widths, one more
# upsampling block) with its SelfAttn at 8x8, and E_BIG at startf 16, maxf 64
CFG = dict(
    output_dim=32, z_dim=8, class_embed_dim=8, channel_width=4, num_classes=10,
    layers=[(False, 16, 16), (True, 16, 8), (True, 8, 4), (True, 4, 2), (False, 2, 1)],
    attention_layer_position=2, eps=1e-4, n_stats=51,
)
ENC = dict(startf=16, maxf=64, layer_count=4, cond_dim=16, z_dim=8)
IMG, BATCH, LR, STEPS = 32, 2, 0.0015, 3
# tests/test_stylegan1.py:134 for whole models; a step's losses and
# gradients run through two generator passes, the encoder and LPIPS
MODEL_TOL = dict(rtol=2e-3, atol=2e-4)
GRAD_TOL = dict(rtol=2e-3, atol=2e-4)


def _recording(inner):
    """optax transform that keeps the last two gradients it was handed in
    its state, to read a step's gradients back out of tpugan's jitted step."""

    def init(params):
        zeros = jax.tree.map(jnp.zeros_like, params)
        return inner.init(params), zeros, zeros

    def update(grads, state, params=None):
        updates, inner_state = inner.update(grads, state[0], params)
        return updates, (inner_state, state[2], grads)

    return optax.GradientTransformation(init, update)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(0)
    jmodel, je = JBigGAN(JConfig(**CFG)), JEncoder(**ENC)
    # BigGAN's and LPIPS's variables are all drawn here, so only their
    # structure is taken from flax (no init to compile)
    shape = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8)), jnp.zeros((1, 10)), 0.4))
    gen_vars = randomized(jax.tree.map(lambda x: np.zeros(x.shape, x.dtype), shape), rng)
    for name, node in gen_vars["params"]["generator"].items():
        if "gamma" in node:
            node["gamma"] = np.ones_like(node["gamma"])  # the attention reaches the images
    port_enc = BigGANEncoder(**ENC, img_size=IMG)
    shapes = port_enc.noise_shapes(BATCH, IMG)
    _, jnoise0 = draw(shapes, np.random.RandomState(1))
    enc_vars = randomized(jax.jit(je.init)({"params": jax.random.PRNGKey(0)},
                                           jnp.zeros((BATCH, IMG, IMG, 3)), jnp.zeros((BATCH, 16)),
                                           jnoise0), rng)
    # E_BIG's z head scaled so z2 has about zt's spread, as a trained E_BIG's
    # has: unscaled, z2's std is 14-19 and the resynthesis's attention
    # scores reach 1e8-1e11, where an fp32 logsumexp cannot hold log(sum)
    # and the flash backward (tpugan's too) parts from softmax's
    head = enc_vars["params"]["new_final_2"]
    for leaf in head:
        head[leaf] = head[leaf] * np.float32(0.03)
    lp_vars = jax.tree.map(
        lambda x: (rng.randn(*x.shape) / np.sqrt(np.prod(x.shape[:-1]))).astype(np.float32),
        jax.eval_shape(lambda: jlpips_params(jax.random.PRNGKey(7), IMG)))
    inputs = []
    for _ in range(STEPS):
        zt = (0.4 * np.clip(rng.randn(BATCH, 8), -2, 2)).astype(np.float32)
        label = np.eye(10, dtype=np.float32)[[rng.randint(10)] * BATCH]
        port_noise, jax_noise = draw(shapes, rng)
        inputs.append((zt, label, port_noise, jax_noise))
    return dict(jmodel=jmodel, je=je, gen_vars=gen_vars, enc_vars=enc_vars, lp_vars=lp_vars,
                inputs=inputs)


_JITTED = {}  # tpugan's jitted steps, compiled once per module


def _tpugan_run(setup, case, lean_after_first=False):
    jmodel, je = setup["jmodel"], setup["je"]
    enc_vars = setup["enc_vars"]
    enc_extra = {k: v for k, v in enc_vars.items() if k not in ("params", "sn")}

    def synth(frozen, key, z):
        imgs1, cond = jmodel.apply(frozen["gen"], frozen["zt"], frozen["label"], 0.4)
        return JSynthBatch(w1=frozen["zt"], imgs1=imgs1, const1=cond,
                           label=(frozen["label"], frozen["noise"]))

    def resynth(frozen, w2, batch, key):
        return jmodel.apply(frozen["gen"], w2, batch.label[0], 0.4)[0]

    def encode(params, batch, key, sn=None):
        variables = {**enc_extra, "params": params, "sn": sn}
        return je.apply(variables, batch.imgs1, batch.const1, batch.label[1])

    opt = _recording(jlreq_adam(LR, coefs=lreq_coef_tree(enc_vars["params"], enc_vars["lreq"])))
    kw = dict(encode=encode, synth=synth, resynth=resynth, optimizer=opt, z_dim=8,
              batch_size=BATCH, case=case)
    if case not in _JITTED:
        _JITTED[case] = jax.jit(jmake_train_step(**kw, lpips_fn=_lpips(setup, case, jmake_lpips_fn)))
    if lean_after_first and "lean" not in _JITTED:
        _JITTED["lean"] = jax.jit(jmake_train_step(**kw, compute_image_losses=False))
    full, lean = _JITTED[case], _JITTED["lean"] if lean_after_first else None
    state = jinit_train_state(enc_vars["params"], opt, sn=enc_vars["sn"])
    infos, grads = [], None
    for it, (zt, label, _, jnoise) in enumerate(setup["inputs"]):
        frozen = {"gen": setup["gen_vars"], "zt": jnp.asarray(zt), "label": jnp.asarray(label),
                  "noise": jnoise}
        fn = lean if (lean is not None and it > 0) else full
        state, info = fn(state, jnp.int32(it), frozen)
        infos.append(jinfo_scalars(info))
        if it == 0:
            grads = state.opt_state[1:]  # (first, second) gradient of the step
    return state, infos, grads


def _lpips(setup, case, make):
    """LPIPS in case 2, where the step differentiates through it; case 1's
    log-only image losses run without it (tests/test_torch_losses.py holds
    LPIPS itself to tpugan)."""
    return make(setup["lp_vars"]) if case == 2 else None


def _port_encoder(setup):
    return load_variables(BigGANEncoder(**ENC, img_size=IMG), setup["enc_vars"]).eval()


def _port_run(setup, case, lean_after_first=False):
    gen = load_variables(BigGAN(BigGANConfig(**CFG)), setup["gen_vars"]).eval().requires_grad_(False)
    enc = _port_encoder(setup)
    synth_fn, resynth = build_biggan_pipeline(gen, train=True)
    encode = make_encode_fn(enc, conditional=True, train=True)
    requests = [Request(torch.from_numpy(zt), None, noise, None, torch.from_numpy(label))
                for zt, label, noise, _ in setup["inputs"]]
    lpips = _lpips(setup, case, lambda v: make_lpips_fn(load_variables(LPIPS(), v)))
    kw = dict(encode=encode, synth=lambda r: synth_fn(r.z, r.label), resynth=resynth,
              draw=lambda it: requests[it], case=case)
    full = make_train_step(**kw, lpips_fn=lpips)
    lean = make_train_step(**kw, compute_image_losses=False) if lean_after_first else None
    state = init_train_state(enc, lreq_adam(enc, LR))
    recorded = []
    step_with = state.optimizer.step
    state.optimizer.step = lambda g=None: (recorded.append([x.clone() for x in g]), step_with(g))
    infos = []
    for it in range(STEPS):
        fn = lean if (lean is not None and it > 0) else full
        state, info = fn(state, it)
        infos.append(info_scalars(info))
    n_first = 2 if case == 2 else 1
    return state, infos, recorded[:n_first]


def _as_port(setup, tree):
    """A tpugan params tree (and the live sn) in the port's layout, by name."""
    variables = {**setup["enc_vars"], **tree}
    return load_variables(BigGANEncoder(**ENC, img_size=IMG), jax.tree.map(np.asarray, variables))


@pytest.mark.parametrize("case", [1, 2])
def test_train_step_matches_tpugan(setup, case):
    jstate, jinfos, jgrads = _tpugan_run(setup, case)
    state, infos, grads = _port_run(setup, case)
    # every scalar of every step
    for it, (got, want) in enumerate(zip(infos, jinfos)):
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_allclose(got[key], want[key], **MODEL_TOL, err_msg=f"step {it} {key}")
    assert infos[0]["loss_small_ssim"] > 0 and (infos[0]["loss_imgs_lpips"] > 0) == (case == 2)
    # the first step's gradients: case 1 one (0.01 loss_w), case 2 two (loss_tsa, then 0.01 loss_w)
    names = [n for n, _ in state.encoder.named_parameters()]
    jg = jgrads[-len(grads):]
    moved_by_images = 0.0
    for which, (port_g, tree) in enumerate(zip(grads, jg)):
        want = dict(_as_port(setup, {"params": tree}).named_parameters())
        for name, g in zip(names, port_g):
            np.testing.assert_allclose(g.numpy(), want[name].detach().numpy(), **GRAD_TOL,
                                       err_msg=f"gradient {which} of {name}")
        if case == 2 and which == 0:
            moved_by_images = float(port_g[names.index("block_0.conv_1.weight")].abs().max())
    if case == 2:
        assert moved_by_images > 0  # loss_tsa reaches the first block through the resynthesis
    # params and u/v after the trajectory. LREQAdam's first update is about
    # lr * c * g / (0.1 |g|), i.e. lr * c * sign(g), with c the parameter's
    # equalized-LR coefficient, whatever the size of g: an element whose
    # gradient is near zero, with another sign on the other side, moves up to
    # 2 lr c apart, in each of the trajectory's updates. So an element may
    # differ by 2 lr c per update, and the mean difference over a parameter
    # must stay below 5% of one update's lr c
    final = _as_port(setup, {"params": jstate.params, "sn": jstate.sn})
    coefs = lreq_coefs(state.encoder)
    updates = STEPS * case
    want = dict(final.named_parameters())
    for name, p in state.encoder.named_parameters():
        step = LR * coefs[name]
        diff = np.abs(p.detach().numpy() - want[name].detach().numpy())
        bound = 2 * step * updates
        assert diff.max() <= bound, f"{name}: max |diff| {diff.max():.3e} > 2 lr c x {updates}"
        assert diff.mean() <= 0.05 * step, f"{name}: mean |diff| {diff.mean():.3e} > {0.05 * step:.3e}"
    for name, b in dict(final.named_buffers()).items():
        if name.endswith((".u", ".v")):
            np.testing.assert_allclose(dict(state.encoder.named_buffers())[name].numpy(), b.numpy(),
                                       **MODEL_TOL, err_msg=name)
    assert state.step == STEPS


def test_lean_step_matches_tpugan_and_is_bitwise_the_full_trajectory(setup):
    """Case 1 with lean steps after the first: the port against tpugan's lean
    trajectory, and bit for bit the port's own all-full trajectory."""
    jstate, jinfos, _ = _tpugan_run(setup, 1, lean_after_first=True)
    lean_state, lean_infos, _ = _port_run(setup, 1, lean_after_first=True)
    full_state, full_infos, _ = _port_run(setup, 1)
    for got, want in zip(lean_infos, jinfos):
        for key in want:
            np.testing.assert_allclose(got[key], want[key], **MODEL_TOL, err_msg=key)
    for a, b in zip(lean_state.encoder.state_dict().values(), full_state.encoder.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert lean_infos[-1]["loss_imgs_mse"] == 0.0 and lean_infos[-1]["loss_tsa"] == 0.0
    assert lean_infos[-1]["loss_mtv"] == full_infos[-1]["loss_mtv"]
    assert lean_infos[-1]["loss_w_mse"] == full_infos[-1]["loss_w_mse"]
    with pytest.raises(ValueError, match="detached"):
        make_train_step(None, None, None, None, case=2, compute_image_losses=False)


def _tiny_argv(tmp_path, *extra):
    config = tmp_path / "config.json"
    config.write_text(BigGANConfig(**CFG).to_json_string())
    return ["--mtype", "4", "--img_size", str(IMG), "--start_features", "16", "--z_dim", "8",
            "--random_init", "--config_dir", str(config), "--device", "cpu",
            "--experiment_dir", str(tmp_path / "out"), *extra]


@pytest.mark.parametrize("case", [1, 2])
def test_cli_trains_two_iterations_on_cpu(tmp_path, capsys, case):
    cuda.reset_launches()
    e_align.main(_tiny_argv(tmp_path, "--case", str(case), "--iterations", "2", "--log_every", "1"))
    assert not any(cuda.launches.values())
    records = [json.loads(line) for line in (tmp_path / "out" / "Loss.txt").read_text().splitlines()]
    assert [r["iteration"] for r in records] == [0, 1]
    assert all(np.isfinite(v) for r in records for v in r.values())
    assert len(records[0]) == 2 + 5 * 7 + 2
    assert (tmp_path / "out" / "imgs" / "ep0_iter1.jpg").exists()
    assert "LPIPS loss term is DISABLED" in capsys.readouterr().err


def test_cli_lean_steps_leave_the_trajectory_alone(tmp_path):
    """Off-tick lean steps (the default in case 1) against --eager_metrics."""
    def trained(*extra):
        parser = e_align.make_parser()
        args = parser.parse_args(_tiny_argv(tmp_path, "--iterations", "3", *extra))
        trainer = e_align.build_trainer(args)
        state = trainer.state
        for it in range(3):
            state, _ = (trainer.step if it == 0 or trainer.lean is None else trainer.lean)(state, it)
        return state.encoder.state_dict()

    lean, eager = trained(), trained("--eager_metrics")
    for a, b in zip(lean.values(), eager.values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("case", [1, 2])
def test_cli_bf16_trains_two_iterations_on_cpu(tmp_path, case):
    """--bf16 on mtype 4, refused until the attention kernels had bf16
    forms, now trains (tests/test_torch_attention_bf16.py holds it to
    tpugan): finite losses, no launches on the CPU."""
    cuda.reset_launches()
    e_align.main(_tiny_argv(tmp_path, "--bf16", "--case", str(case), "--iterations", "2", "--log_every", "1"))
    assert not any(cuda.launches.values())
    records = [json.loads(line) for line in (tmp_path / "out" / "Loss.txt").read_text().splitlines()]
    assert [r["iteration"] for r in records] == [0, 1]
    assert all(np.isfinite(v) for r in records for v in r.values())


@pytest.mark.parametrize("extra,error,match", [
    (("--remat",), NotImplementedError, "A3"),
    (("--remat_policy", "conv_outs"), NotImplementedError, "A3"),
    (("--resume",), NotImplementedError, "slice 7"),
    (("--iterations", "6", "--checkpoint_every", "5"), NotImplementedError, "slice 7"),
    (("--lpips_weights", "lpips.pth"), NotImplementedError, "slice 7"),
])
def test_cli_options_of_later_slices_raise(tmp_path, extra, error, match):
    with pytest.raises(error, match=match):
        e_align.main(_tiny_argv(tmp_path, "--iterations", "1", *extra))


def test_cli_trains_mtype_1_which_slice_2_brought(tmp_path):
    """--mtype 1, refused until slice 2, now trains (tests/test_torch_sgv1_train.py
    holds it to tpugan)."""
    cuda.reset_launches()
    e_align.main(_tiny_argv(tmp_path, "--iterations", "1", "--mtype", "1", "--start_features", "64"))
    records = [json.loads(line) for line in (tmp_path / "out" / "Loss.txt").read_text().splitlines()]
    assert [r["iteration"] for r in records] == [0] and np.isfinite(records[0]["loss_mtv"])
    assert not any(cuda.launches.values())


def test_cli_trains_mtype_2_which_slice_3_brought(tmp_path):
    """--mtype 2, refused until slice 3's training half, now trains
    (tests/test_torch_sg2_train.py holds it to tpugan)."""
    cuda.reset_launches()
    e_align.main(_tiny_argv(tmp_path, "--iterations", "1", "--mtype", "2", "--start_features", "64"))
    records = [json.loads(line) for line in (tmp_path / "out" / "Loss.txt").read_text().splitlines()]
    assert [r["iteration"] for r in records] == [0] and np.isfinite(records[0]["loss_mtv"])
    assert not any(cuda.launches.values())


def test_cli_needs_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in _tiny_argv(tmp_path, "--iterations", "1") if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        e_align.main(argv)
