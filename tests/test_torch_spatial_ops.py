"""The space axis's ops on row shards (``parallel/spatial.py``,
``parallel/mesh.py``'s ``halo_rows`` and ``all_gather_rows``, the row forms
of ``ops/basic.py``'s moments, ``ops/upfirdn.py``'s ``blur3x3_rows``,
``losses/space_loss.py``'s ``pool_for_lpips`` and ``pooled_whole``) against
the same ops on whole images (CPU).

One gloo group of four processes on a ``FileStore``
(``tests/torch_spatial_worker.py``, which imports no JAX) runs each op on
meshes 1 x 2 and 1 x 4: a 3x3 conv, E_Blur's fused 4x4 stride-2 conv, the
blur (its backward is the FIR's adjoint), instance norm, the encoder's
style statistics (mean and std, and E_v2_std's unbiased std), SSIM and
LPIPS (on the pooled images gathered whole), ``pool_for_lpips`` at 512
rows (the ladder counts the whole height: a shard's own 256 or 128 rows
would pool too few times) and a whole E_Blur at 32 px of five blocks,
whose 4 px block leaves each of four ranks one row before its stride-2
conv, so the rows are gathered there (the thin-level rule), and E,
E_Blur_Z (a z head alone), E_Blur_W_2 (one w a block, no noise), E_v2_std
and E_v1 of four blocks (E_Blur_Z's stride-2 3x3 head needs the last
block's 4 x 4 map). Each op's
output, its input's gradient and its parameters' gradients (the loss: the
output times a fixed cotangent), gathered, equal the whole-image op's in
float64 within 1e-12 of their max |ref|: a halo reassociates a conv's sums
and the all-reduces the moments' (float64 moments for float64 inputs).
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_spatial_worker as worker
from tpugan_torch.losses.lpips import LPIPS
from tpugan_torch.models import Encoder
from tpugan_torch.nn.layers import EqConv

ROOT = pathlib.Path(__file__).resolve().parent.parent
OPS_TOL = 1e-12  # of max |ref|, float64
GROUP_TIMEOUT = 600
DIST_ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
ENCODER_KW = dict(startf=8, maxf=32, layer_count=5, latent_size=32, use_blur=True)
# the ablation ladder's encoders and tpugan's E variants (tests/test_torch_sgv1_train.py's VARIANTS)
ENCODER_VARIANTS = {"encoder": {}, "encoder_E": dict(use_blur=False),
                    "encoder_z": dict(style_mode="none", z_head=True), "encoder_single": dict(style_mode="single",
                                                                                              use_noise=False),
                    "encoder_std": dict(style_stats="std"), "encoder_v1": dict(use_blur=False, block_version=1)}
OPS = ("conv3", "fused", "blur", "instance_norm", "stats", "stats_std", "ssim", "lpips", "pool") + tuple(ENCODER_VARIANTS)
IMG = 32


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float64))


def _drawn(module, rng):
    """``module``'s state with its constant leaves (zero biases and noise
    weights) drawn around their constant, so that every leaf reaches the
    output."""
    state = {}
    for name, v in module.state_dict().items():
        v = v.double()
        if v.numel() and torch.all(v == v.flatten()[0]):
            v = v + _t(rng.randn(*v.shape) * 0.1)
        state[name] = v
    return state


def _spec():
    rng = np.random.RandomState(0)
    g = torch.Generator().manual_seed(0)
    ops = {}
    x = _t(rng.randn(2, 6, 16, 12))
    for case, kw in (("conv3", dict(in_features=6, out_features=5, kernel_size=3, padding=1)),
                     ("fused", dict(in_features=6, out_features=5, kernel_size=3, stride=2, padding=1,
                                    use_bias=False, transform_kernel=True))):
        conv = EqConv(**kw, generator=g).double()
        out = conv(x)
        ops[case] = dict(x=x, dim=2, kw=kw, state=_drawn(conv, rng), cot=_t(rng.randn(*out.shape)))
    for case in ("blur", "instance_norm"):
        ops[case] = dict(x=x, dim=2, cot=_t(rng.randn(*x.shape)))
    ops["stats"] = dict(x=x, dim=2, cot=_t(rng.randn(2, 12)))
    ops["stats_std"] = dict(x=x, dim=2, cot=_t(rng.randn(2, 6)))
    xe = _t(rng.randn(2, 3, IMG, IMG))
    for case, variant in ENCODER_VARIANTS.items():
        kw = dict(ENCODER_KW, **variant) if case == "encoder" else dict(ENCODER_KW, layer_count=4, **variant)
        enc = Encoder(**kw, generator=g).double()
        noise = [tuple(_t(rng.randn(*s)) for s in block) for block in enc.noise_shapes(2, IMG)]
        const, w = enc(xe, noise)
        ops[case] = dict(x=xe, dim=2, kw=kw, state=_drawn(enc, rng), noise=noise,
                         cot=_t(rng.randn(const.numel() + (0 if w is None else w.numel()))))
    a, b = _t(rng.uniform(-1, 1, (2, 32, 16, 3))), _t(rng.uniform(-1, 1, (2, 32, 16, 3)))
    ops["ssim"] = dict(x=a, y=b, dim=1, cot=_t(rng.randn()))
    ops["lpips"] = dict(x=_t(rng.uniform(-1, 1, (1, IMG, IMG, 3))), y=_t(rng.uniform(-1, 1, (1, IMG, IMG, 3))),
                        dim=1, cot=_t(rng.randn(1)))
    ops["pool"] = dict(x=_t(rng.uniform(-1, 1, (1, 512, 8, 3))), y=None, dim=1, cot=_t(rng.randn(1, 256, 4, 3)))
    lpips = LPIPS(generator=g).double()
    runs = []
    for case in OPS:
        runs.append((f"{case}@1x2", "1x2" if len(runs) % 2 == 0 else "1x2b", "op", case, torch.float64))
        runs.append((f"{case}@1x4", "1x4", "op", case, torch.float64))
    return dict(ops=ops, lpips=_drawn(lpips, rng), runs=runs)


def spawn_group(spec, tmp, script="torch_spatial_worker.py", world=4):
    """Start ``world`` gloo ranks of ``script`` on ``spec``; returns
    ``wait()``, which gives each rank's results."""
    spec_path = tmp / "spec.pt"
    torch.save(spec, spec_path)
    env = {k: v for k, v in os.environ.items() if k not in DIST_ENV}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / script), str(spec_path), str(rank), str(world),
                               str(tmp / f"rank{rank}.pt")], cwd=tmp, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for rank in range(world)]

    def wait():
        try:
            logs = [p.communicate(timeout=GROUP_TIMEOUT)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        assert [p.returncode for p in procs] == [0] * world, "\n".join(logs)
        return [torch.load(tmp / f"rank{rank}.pt", weights_only=False) for rank in range(world)]

    return wait


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The group runs every op on both meshes; meanwhile this process runs
    each on the whole image."""
    tmp = tmp_path_factory.mktemp("spatial_ops")
    spec = _spec()
    wait = spawn_group(spec, tmp)
    whole = {case: worker.run(spec, f"{case}@1x4") for case in OPS}
    return dict(spec=spec, whole=whole, ranks=wait())


def close(got, want, what, tol=OPS_TOL, scale=0.0):
    """``got`` within ``tol`` of max |want| (or of ``scale``, where larger)."""
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, f"{what}: shape {got.shape} against {want.shape}"
    bound = tol * max(float(np.abs(want).max()), scale, np.finfo(np.float64).tiny)
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{what}: {err:.3e} > {bound:.3e}"


@pytest.mark.parametrize("mesh", ["1x2", "1x4"])
@pytest.mark.parametrize("case", OPS)
def test_an_op_on_row_shards_is_the_whole_image_op(group, case, mesh):
    """The op's output, its input's gradient and its parameters' gradients
    on every rank of the space group, gathered, against the whole image's
    in float64; each parameter's gradient on the module's scale (E_v1's
    ``conv_3.bias`` feeds an instance norm: its gradient is zero but for
    rounding)."""
    name = f"{case}@{mesh}"
    ranks = [r for r in group["ranks"] if name in r]
    assert len(ranks) == int(mesh[-1])
    want = group["whole"][case]
    for r in ranks:
        got = r[name]
        close(got["out"], want["out"], f"{name} output")
        close(got["grad"], want["grad"], f"{name} input gradient")
        assert got["params"].keys() == want["params"].keys()
        scale = max((float(g.abs().max()) for g in want["params"].values()), default=0.0)
        for p, g in want["params"].items():
            close(got["params"][p], g, f"{name} gradient of {p}", scale=scale)


def test_the_thin_level_rule_gathers_at_1x4():
    """At 1 x 4 the encoder's 4 px block leaves each rank one row before its
    stride-2 conv, so the encoder gathers the rows there; at 1 x 2 every
    block runs on shards."""
    enc = Encoder(**ENCODER_KW)
    blocks = [getattr(enc, f"block_{i}") for i in range(ENCODER_KW["layer_count"])]
    assert [b.runs_on_rows((IMG // 4) >> i) for i, b in enumerate(blocks)] == [True, True, True, False, False]
    assert all(b.runs_on_rows((IMG // 2) >> i) for i, b in enumerate(blocks))


def test_the_ladder_pools_by_the_whole_height(group):
    """pool_for_lpips on 512 rows pools once, also on shards of 256 and 128
    rows."""
    assert group["whole"]["pool"]["out"].shape == (1, 256, 4, 3)


def test_the_ranks_never_import_jax(group):
    assert [r["_rank"] for r in group["ranks"]] == [0, 1, 2, 3]
    assert not any(r["_jax_loaded"] for r in group["ranks"])
