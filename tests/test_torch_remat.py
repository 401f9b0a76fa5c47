"""Remat (A3) in tpugan_torch's train step (CPU).

``--remat`` and ``--remat_policy conv_outs`` run encode and resynth under
``torch.utils.checkpoint``; the update must be the plain step's. Each form's
gradients (one per update), parameters, spectral-norm buffers and optimizer
state after a step are held bitwise to the plain step's, on SGv1 (case 2,
ablation 8), StyleGAN2 (case 2) and E_BIG (case 2, live spectral norm), with
the FIR's launches counted on the card route: each gradient group runs its
own forward and each backward through a region recomputes its forward, so a
case-2 step launches the synthesis's FIRs, twice encode's and resynth's for
the image group and twice encode's for the latent one. The port's remat step
is held to tpugan's remat step, after
``tests/test_train.py::test_remat_policy_conv_outs_numerics``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bf16 import card_route  # noqa: F401 (a fixture)
from test_torch_train import CFG as BIGGAN_CFG
from tpugan.models.encoders import Encoder as JEncoder
from tpugan.models.stylegan1 import StyleGANv1Generator as JGenerator
from tpugan.models.stylegan1 import StyleGANv1Mapping as JMapping
from tpugan.ops.eq_lr import lreq_coef_tree
from tpugan.optim import lreq_adam as jlreq_adam
from tpugan.train.e_align import SynthBatch as JSynthBatch
from tpugan.train.e_align import init_train_state as jinit_train_state
from tpugan.train.e_align import make_train_step as jmake_train_step
from tpugan_torch.cli import e_align
from tpugan_torch.io.bridge import load_variables
from tpugan_torch.models import BigGANConfig, Encoder, StyleGANv1Generator, StyleGANv1Mapping
from tpugan_torch.ops import upfirdn
from tpugan_torch.optim import lreq_adam
from tpugan_torch.ops.eq_lr import lreq_coefs
from tpugan_torch.train.e_align import (
    Request,
    build_stylegan1_pipeline,
    init_train_state,
    make_encode_fn,
    make_train_step,
)

torch.set_num_threads(1)

FORMS = {
    "sgv1_case2": ["--mtype", "1", "--case", "2"],
    "sgv1_ablation8": ["--mtype", "1", "--ablation", "8"],
    "sg2_case2": ["--mtype", "2", "--case", "2"],
    "ebig_case2": ["--mtype", "4", "--case", "2", "--start_features", "16", "--z_dim", "8"],
}
REMATS = {"remat": ["--remat"], "conv_outs": ["--remat_policy", "conv_outs"]}


def _argv(tmp_path, form, *extra):
    argv = ["--img_size", "32", "--start_features", "64", "--random_init", "--device", "cpu",
            "--iterations", "1", *FORMS[form], *extra]
    if form.startswith("ebig"):
        config = tmp_path / "config.json"
        config.write_text(BigGANConfig(**BIGGAN_CFG).to_json_string())
        argv += ["--config_dir", str(config)]
    return e_align.make_parser().parse_args(argv)


class _AdjointCount:
    def __init__(self, monkeypatch):
        self.n = 0
        backward = upfirdn._UpFirDn2d.backward

        def counted(ctx, g):
            self.n += 1
            return backward(ctx, g)

        monkeypatch.setattr(upfirdn._UpFirDn2d, "backward", staticmethod(counted))


def _step(args, launches):
    """One step of the CLI's trainer: its gradients (recorded at the
    optimizer), the encoder's state dict and the optimizer's state after it,
    and the FIR launches, forward (all) and adjoint."""
    trainer = e_align.build_trainer(args)
    state = trainer.state
    recorded = []
    step_with = state.optimizer.step
    state.optimizer.step = lambda g=None: (recorded.append([None if x is None else x.clone() for x in g]),
                                           step_with(g))
    launches["count"].n = 0
    upfirdn.reset_layout_launches()
    state, _ = trainer.step(state, 0)
    total = sum(upfirdn.layout_launches.values())
    adjoint = launches["count"].n
    return recorded, state.encoder.state_dict(), state.optimizer.state_dict(), (total - adjoint, adjoint)


def _same(a, b, what):
    if a is None or b is None:
        assert a is None and b is None, what
        return
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True, msg=what)


def _fir_parts(args):
    """Forward FIR launches of one synthesis (the frozen G; resynth runs the
    same decode) and of one encode, on the card route."""
    pipeline = e_align.build_pipeline(args)
    request = pipeline.draw(0)
    upfirdn.reset_layout_launches()
    batch = pipeline.synth(request)
    synth = sum(upfirdn.layout_launches.values())
    upfirdn.reset_layout_launches()
    with torch.no_grad():
        pipeline.encode(batch, request.noise_e)
    return synth, sum(upfirdn.layout_launches.values())


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("form", FORMS)
def test_remat_update_is_the_plain_steps(tmp_path, monkeypatch, card_route, form, remat):
    launches = {"count": _AdjointCount(monkeypatch)}
    plain = _step(_argv(tmp_path, form), launches)
    got = _step(_argv(tmp_path, form, *REMATS[remat]), launches)
    assert len(got[0]) == len(plain[0]) >= 2
    for i, (ga, gb) in enumerate(zip(got[0], plain[0])):
        for j, (a, b) in enumerate(zip(ga, gb)):
            _same(a, b, f"gradient {i}, parameter {j}")
    assert got[1].keys() == plain[1].keys()
    for name in plain[1]:  # the parameters and the spectral norms' u and v
        _same(got[1][name], plain[1][name], name)
    for (pa, sa), (pb, sb) in zip(got[2]["state"].items(), plain[2]["state"].items()):
        assert pa == pb and sa["step"] == sb["step"] == len(plain[0])
        _same(sa["nu"], sb["nu"], f"nu of {pa}")
    assert card_route["plain"] == 0
    if form.startswith("ebig"):
        return  # E_BIG runs no FIR
    synth, encode = _fir_parts(_argv(tmp_path, form))
    (forward, adjoint), (plain_forward, plain_adjoint) = got[3], plain[3]
    image_groups = len(plain[0]) - 1
    assert encode > 0 and plain_forward == synth + encode + synth
    assert forward == synth + image_groups * 2 * (encode + synth) + 2 * encode
    assert adjoint == plain_adjoint


def test_remat_flags_are_mutually_exclusive_and_known(tmp_path):
    args = _argv(tmp_path, "sgv1_case2", "--remat", "--remat_policy", "conv_outs")
    with pytest.raises(ValueError, match="mutually exclusive"):
        e_align.build_trainer(args)
    pipeline = e_align.build_pipeline(_argv(tmp_path, "sgv1_case2"))
    with pytest.raises(ValueError, match="unknown remat_policy"):
        make_train_step(pipeline.encode, pipeline.synth, pipeline.resynth, pipeline.draw, case=2,
                        remat_policy="dots")


def test_remat_runs_with_bf16(tmp_path):
    """--bf16 with either form, as tpugan allows: the update is the plain
    bf16 step's."""
    runs = [_bf16_params(tmp_path, extra) for extra in ([], ["--remat"], ["--remat_policy", "conv_outs"])]
    for other in runs[1:]:
        for name in runs[0]:
            _same(other[name], runs[0][name], name)


def _bf16_params(tmp_path, extra):
    trainer = e_align.build_trainer(_argv(tmp_path, "sg2_case2", "--bf16", *extra))
    state, _ = trainer.step(trainer.state, 0)
    return {k: v.clone() for k, v in state.encoder.state_dict().items()}


# tests/test_train.py::_tiny_setup: SGv1 at 16 px, layer_count 3, startf 8, latent 32
LAYERS, STARTF, LATENT, BATCH, IMG, LR = 3, 8, 32, 2, 16, 0.0015


@pytest.mark.parametrize("remat", ["remat", "conv_outs"])
def test_remat_step_matches_tpugans_remat_step(remat):
    """tpugan's make_train_step with ``remat``/``remat_policy`` (case 2,
    E_Blur) on its flax init, and the port's on the same variables (the
    bridge) and inputs: tpugan's closures read z and the noise from
    ``frozen``. Every scalar at rtol 2e-3 / atol 2e-4, and the parameters
    after the step within 2 lr c of each other (LREQAdam's first update is
    about lr c sign(g): an element whose gradient is near zero may move
    either way)."""
    kw = dict(remat=True) if remat == "remat" else dict(remat_policy="conv_outs")
    rng = np.random.RandomState(0)
    jgen = JGenerator(startf=STARTF, maxf=32, layer_count=LAYERS, latent_size=LATENT)
    jgm = JMapping(num_layers=2 * LAYERS, mapping_layers=2, latent_size=LATENT, dlatent_size=LATENT,
                   mapping_fmaps=LATENT)
    je = JEncoder(startf=STARTF, maxf=32, layer_count=LAYERS, latent_size=LATENT, use_blur=True)
    key = jax.random.PRNGKey(0)
    gm_vars = jax.tree.map(np.asarray, jgm.init(key, jnp.zeros((BATCH, LATENT))))
    gen_vars = jax.tree.map(np.asarray, jgen.init({"params": key, "noise": key},
                                                  jnp.zeros((BATCH, 2 * LAYERS, LATENT))))
    enc_vars = jax.tree.map(np.asarray, je.init({"params": key, "noise": key}, jnp.zeros((BATCH, IMG, IMG, 3))))

    gen = load_variables(StyleGANv1Generator(startf=STARTF, maxf=32, layer_count=LAYERS, latent_size=LATENT),
                         gen_vars, unused=[f"to_rgb_{i}" for i in range(LAYERS - 1)])
    gm = load_variables(StyleGANv1Mapping(num_layers=2 * LAYERS, mapping_layers=2, latent_size=LATENT,
                                          dlatent_size=LATENT, mapping_fmaps=LATENT), gm_vars)
    enc = load_variables(Encoder(startf=STARTF, maxf=32, layer_count=LAYERS, latent_size=LATENT, use_blur=True),
                         enc_vars)
    z = rng.randn(BATCH, LATENT).astype(np.float32)

    def noise(shapes):
        return [tuple(torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in blk) for blk in shapes]

    request = Request(z=torch.from_numpy(z), noise_g=noise(gen.noise_shapes(BATCH)),
                      noise_e=noise(enc.noise_shapes(BATCH, IMG)), noise_g2=noise(gen.noise_shapes(BATCH)))
    jnoise = {k: [tuple(jnp.asarray(n.numpy().transpose(0, 2, 3, 1)) for n in blk)
                  for blk in getattr(request, k)] for k in ("noise_g", "noise_e", "noise_g2")}

    synth, resynth = build_stylegan1_pipeline(gen, gm, LAYERS - 1, train=True)
    step = make_train_step(make_encode_fn(enc, train=True), lambda r: synth(r.z, r.noise_g), resynth,
                           lambda it: request, case=2, **kw)
    state, info = step(init_train_state(enc, lreq_adam(enc, LR)), 3)

    from tpugan.models.stylegan1 import truncation_coefs as jtruncation_coefs

    extra = {k: v for k, v in enc_vars.items() if k != "params"}

    def jsynth(frozen, k, zz):
        w1 = jgm.apply(frozen["gm"], frozen["z"], jtruncation_coefs(2 * LAYERS), None)
        imgs1 = jgen.apply(frozen["gen"], w1, LAYERS - 1, 1.0, frozen["noise_g"])
        const1 = jnp.repeat(frozen["gen"]["params"]["const"], BATCH, axis=0)
        return JSynthBatch(w1=w1, imgs1=imgs1, const1=const1, label=(frozen["noise_e"], frozen["noise_g2"]))

    def jresynth(frozen, w2, batch, k):
        return jgen.apply(frozen["gen"], w2, LAYERS - 1, 1.0, batch.label[1])

    def jencode(params, batch, k):
        return je.apply({**extra, "params": params}, batch.imgs1, 0, batch.label[0])

    opt = jlreq_adam(LR, coefs=lreq_coef_tree(enc_vars["params"], enc_vars["lreq"]))
    jstep = jmake_train_step(encode=jencode, synth=jsynth, resynth=jresynth, optimizer=opt, z_dim=LATENT,
                             batch_size=BATCH, case=2, **kw)
    frozen = {"gen": gen_vars, "gm": gm_vars, "z": jnp.asarray(z), **jnoise}
    jstate, jinfo = jax.jit(jstep)(jinit_train_state(enc_vars["params"], opt), jnp.int32(3), frozen)

    np.testing.assert_allclose(float(info.loss_tsa), float(jinfo.loss_tsa), rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(float(info.loss_mtv), float(jinfo.loss_mtv), rtol=2e-3, atol=2e-4)
    want = Encoder(startf=STARTF, maxf=32, layer_count=LAYERS, latent_size=LATENT, use_blur=True)
    load_variables(want, {**enc_vars, "params": jax.tree.map(np.asarray, jstate.params)})
    coefs = lreq_coefs(enc)
    got = dict(enc.named_parameters())
    for name, p in want.named_parameters():
        diff = (got[name] - p).abs().max().item()
        assert diff <= 2 * LR * coefs[name] * 2, f"{name}: {diff:.3e}"
