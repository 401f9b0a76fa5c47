"""Checks that the training CLIs' flags which later ROADMAP items brought
(``--remat``, ``--remat_policy``, ``--resume``, saves past
``--checkpoint_every``) run as tpugan runs them. The refusal tests of
earlier slices call these with their own parameters."""

import torch

from tpugan_torch.io import checkpoint

REMAT_FLAGS = ("--remat", "--remat_policy", "conv_outs")


def check_flag_runs(main, argv, extra, tmp_path):
    """``main(argv + extra)`` runs and does what tpugan does: a remat form
    gives the update of the same run without it (bit for bit); ``--resume``
    with no checkpoint starts fresh; a run past ``--checkpoint_every``
    saves ``step_<N>`` with the state after iteration N."""
    extra = list(extra)
    out = tmp_path / "flag"
    if "--resume" in extra:
        state = main(argv + ["--iterations", "1", "--experiment_dir", str(out), *extra])
        assert state.step == 1 and checkpoint.latest_step(str(out / "models")) is None
        return
    if "--checkpoint_every" in extra:
        state = main(argv + ["--log_every", "100", "--experiment_dir", str(out), *extra])
        every = int(extra[extra.index("--checkpoint_every") + 1])
        assert checkpoint.latest_step(str(out / "models")) == every and state.step == every + 1
        return
    plain = [f for f in extra if f not in REMAT_FLAGS]
    assert plain != extra
    want = main(argv + ["--iterations", "1", "--experiment_dir", str(out / "plain"), *plain])
    got = main(argv + ["--iterations", "1", "--experiment_dir", str(out / "remat"), *extra])
    a, b = got.encoder.state_dict(), want.encoder.state_dict()
    for name in b:
        torch.testing.assert_close(a[name], b[name], rtol=0, atol=0, equal_nan=True, msg=name)
