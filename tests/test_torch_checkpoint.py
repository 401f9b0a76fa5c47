"""tpugan_torch.io.checkpoint and the training CLIs' saves and ``--resume``
(CPU).

A checkpoint round-trips the encoder (parameters and spectral-norm
buffers), LREQAdam's state and the step; a save is atomic. Through the
CLIs' own ``main``, 2k iterations equal k iterations, a save, a resume and k
more, bit for bit (the port against itself: float64 runs are not all
float64, so tpugan is no bitwise reference), for ``e_align`` case 2, case 1
with its lean steps, E_BIG with live spectral norm, and ``e_mis_align``.
With tpugan's defaults (``--iterations 210000 --checkpoint_every 5000``)
each training CLI starts and saves ``step_5000``; the steps are stubbed to
get there.
"""

import json
import os

import numpy as np
import pytest
import torch

from test_torch_train import CFG as BIGGAN_CFG
from tpugan_torch.cli import e_align, e_mis_align
from tpugan_torch.io import checkpoint
from tpugan_torch.losses.vgg import VGG16
from tpugan_torch.models import BigGANConfig, BigGANEncoder
from tpugan_torch.nn.spectral import power_iterate
from tpugan_torch.optim import lreq_adam
from tpugan_torch.train.e_align import init_train_state

torch.set_num_threads(1)


def _state(seed=0):
    enc = BigGANEncoder(startf=8, maxf=16, layer_count=3, cond_dim=16, z_dim=8, img_size=16,
                        generator=torch.Generator().manual_seed(seed))
    return init_train_state(enc, lreq_adam(enc, 0.0015))


def _advance(state):
    """One update from a made-up gradient and one power iteration, so that
    the optimizer has state and the spectral norms' buffers moved."""
    power_iterate(state.encoder)
    grads = [torch.full_like(p, 0.5) for p in state.encoder.parameters()]
    state.optimizer.step(grads)
    state.step += 1
    return state


def _equal(a, b):
    sa, sb = a.encoder.state_dict(), b.encoder.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    for (ka, va), (kb, vb) in zip(oa["state"].items(), ob["state"].items()):
        assert ka == kb and va["step"] == vb["step"] and torch.equal(va["nu"], vb["nu"])
    assert a.step == b.step


def test_save_latest_step_and_load(tmp_path):
    models = tmp_path / "models"
    assert checkpoint.latest_step(str(models)) is None
    state = _advance(_advance(_state()))
    assert checkpoint.save_checkpoint(str(models), state, 2) == str(models / "step_2")
    _advance(state)
    checkpoint.save_checkpoint(str(models), state, 10)
    (models / "step_99").write_text("not a directory")
    (models / "step_x").mkdir()
    assert checkpoint.latest_step(str(models)) == 10
    fresh = _state(seed=1)
    restored, step = checkpoint.load_checkpoint(str(models), fresh)
    assert step == 10 and restored is fresh and any(k.endswith(".u") for k in fresh.encoder.state_dict())
    _equal(fresh, state)
    older, step = checkpoint.load_checkpoint(str(models), _state(seed=1), step=2)
    assert step == 2 and older.step == 2
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        checkpoint.load_checkpoint(str(tmp_path / "none"), _state())


def test_a_save_replaces_its_step_and_an_interrupted_one_leaves_none(tmp_path, monkeypatch):
    models = tmp_path / "models"
    state = _advance(_state())
    checkpoint.save_checkpoint(str(models), state, 5)
    _advance(state)
    checkpoint.save_checkpoint(str(models), state, 5)  # as orbax's force=True
    restored, _ = checkpoint.load_checkpoint(str(models), _state(seed=1))
    _equal(restored, state)
    assert sorted(os.listdir(models)) == ["step_5"]

    def interrupted(obj, path):
        with open(path, "wb") as f:
            f.write(b"partial")
        raise KeyboardInterrupt

    monkeypatch.setattr(checkpoint.torch, "save", interrupted)
    with pytest.raises(KeyboardInterrupt):
        checkpoint.save_checkpoint(str(models), state, 7)
    assert sorted(os.listdir(models)) == ["step_5"]
    # a process killed mid-save leaves its staging directory, which no reader takes
    (models / ".step_9.abc").mkdir()
    assert checkpoint.latest_step(str(models)) == 5


def _biggan_config(tmp_path):
    config = tmp_path / "config.json"
    config.write_text(BigGANConfig(**BIGGAN_CFG).to_json_string())
    return str(config)


SGV1 = ["--mtype", "1", "--img_size", "32", "--start_features", "64", "--random_init", "--device", "cpu"]
ALIGN_FORMS = {
    "case2": SGV1 + ["--case", "2", "--log_every", "2"],
    "case1_lean": SGV1 + ["--case", "1", "--log_every", "2"],
    "ebig_case2": ["--mtype", "4", "--img_size", "32", "--start_features", "16", "--z_dim", "8", "--random_init",
                   "--device", "cpu", "--case", "2", "--log_every", "2"],
}


def _records(out):
    return [json.loads(line) for line in (out / "Loss.txt").read_text().splitlines()]


def _resumed_equals_unbroken(tmp_path, main, argv, k=2):
    """2k iterations against k + 1, then ``--resume`` to 2k; the run writes
    step_k. Returns the two final states and the two experiment dirs."""
    whole, parts = tmp_path / "whole", tmp_path / "parts"
    common = argv + ["--checkpoint_every", str(k)]
    a = main(common + ["--iterations", str(2 * k), "--experiment_dir", str(whole)])
    main(common + ["--iterations", str(k + 1), "--experiment_dir", str(parts)])
    assert checkpoint.latest_step(str(parts / "models")) == k
    b = main(common + ["--iterations", str(2 * k), "--experiment_dir", str(parts), "--resume"])
    assert a.step == b.step == 2 * k and b is not a
    _equal(a, b)
    assert _records(parts) == _records(whole)  # Loss.txt is appended to
    return a, b


@pytest.mark.parametrize("form", ALIGN_FORMS)
def test_e_align_resume_is_bitwise_the_unbroken_run(tmp_path, capsys, form):
    argv = list(ALIGN_FORMS[form])
    if form.startswith("ebig"):
        argv += ["--config_dir", _biggan_config(tmp_path)]
    a, _ = _resumed_equals_unbroken(tmp_path, e_align.main, argv)
    assert any(k.endswith(".u") for k in a.encoder.state_dict()) == form.startswith("ebig")
    assert f"resumed from {tmp_path / 'parts' / 'models'}/step_2 (next iteration 3)" in capsys.readouterr().out


def test_resume_without_a_checkpoint_starts_fresh(tmp_path, capsys):
    out = tmp_path / "out"
    state = e_align.main(SGV1 + ["--iterations", "1", "--resume", "--experiment_dir", str(out)])
    assert state.step == 1 and [r["iteration"] for r in _records(out)] == [0]
    assert f"--resume: no step_<N> checkpoint under {out / 'models'}, starting fresh" in capsys.readouterr().out


@pytest.fixture(scope="module")
def vgg():
    return VGG16(generator=torch.Generator().manual_seed(0)).requires_grad_(False)


def test_e_mis_align_resume_is_bitwise_the_unbroken_run(tmp_path, monkeypatch, vgg):
    monkeypatch.setattr(e_mis_align, "build_vgg16", lambda args: vgg)
    _resumed_equals_unbroken(tmp_path, e_mis_align.main, SGV1 + ["--log_every", "2"])


class _Saved(Exception):
    pass


@pytest.mark.parametrize("cli,extra", [
    (e_align, ["--mtype", "1", "--img_size", "32", "--start_features", "64"]),
    (e_align, ["--mtype", "2", "--img_size", "32", "--start_features", "64"]),
    (e_align, ["--mtype", "4", "--img_size", "32", "--start_features", "16", "--z_dim", "8"]),
    (e_mis_align, ["--mtype", "1", "--img_size", "32", "--start_features", "64"]),
], ids=["e_align-mtype1", "e_align-mtype2", "e_align-mtype4", "e_mis_align"])
def test_tpugans_defaults_start_and_save_step_5000(tmp_path, monkeypatch, vgg, cli, extra):
    """``--iterations`` and ``--checkpoint_every`` at tpugan's defaults
    (210000 and 5000): the run starts and saves step_5000 with the state of
    its 5001 steps. The steps after the first are stubbed (they only count
    the step) and the run stops once step_5000 is written."""
    args = cli.make_parser().parse_args([])
    assert (args.iterations, args.checkpoint_every) == (210000, 5000)
    monkeypatch.setattr(e_mis_align, "build_vgg16", lambda args: vgg)
    build, save = cli.build_trainer, checkpoint.save_checkpoint

    def stubbed(*a, **kw):
        trainer = build(*a, **kw)
        first = trainer.step

        def step(state, iteration):
            if iteration == 0:
                state, step.info = first(state, iteration)
            else:
                state.step += 1
            return state, step.info

        return trainer._replace(step=step, lean=None if trainer.lean is None else step)

    def save_and_stop(path, state, step):
        save(path, state, step)
        raise _Saved(step)

    monkeypatch.setattr(cli, "build_trainer", stubbed)
    monkeypatch.setattr(cli, "save_checkpoint", save_and_stop)
    config = ["--config_dir", _biggan_config(tmp_path)] if "4" in extra else []
    out = tmp_path / "out"
    argv = extra + config + ["--random_init", "--device", "cpu", "--log_every", "5000", "--experiment_dir", str(out)]
    with pytest.raises(_Saved, match="5000"):
        cli.main(argv)
    assert checkpoint.latest_step(str(out / "models")) == 5000
    parse = getattr(cli, "parse_args", None) or cli.make_parser().parse_args
    restored, _ = checkpoint.load_checkpoint(str(out / "models"), build(parse(argv)).state)
    assert restored.step == 5001
    records = _records(out)
    assert [r["iteration"] for r in records] == [0, 5000] and np.isfinite(records[0]["loss_mtv"])
