"""tpugan_torch.eval and its CLIs (``compare``, ``synthesize``) against
tpugan (CPU).

The same numpy images (or PNGs the test writes) go through both packages'
metrics: rtol 1e-5, as tests/test_eval_invert.py holds tpugan's to skimage
and scipy; SSIM's uniform filter is also held to scipy's at even and odd
window sizes. ``synthesize_grids`` runs a small PGGAN and E_PG with tpugan's
z (drawn as its synthesize_grids draws it) injected into the port's; the
CLIs write their files at 32 px.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage
import torch

from tpugan.cli import compare as jcompare_cli
from tpugan.eval import metrics as jmetrics
from tpugan.eval.compare import compare_dirs as jcompare_dirs
from tpugan.eval.synthesize import synthesize_grids as jsynthesize_grids
from tpugan.losses.lpips import make_lpips_fn as jmake_lpips_fn
from tpugan.losses.lpips import random_params as jlpips_params
from tpugan.models.encoders import PGEncoder as JPGEncoder
from tpugan.models.pggan import PGGANGenerator as JPGGANGenerator
from tpugan.utils import iteration_key
from tpugan_torch.cli import common, compare, infer_e, synthesize
from tpugan_torch.eval import metrics
from tpugan_torch.eval.compare import compare_dirs
from tpugan_torch.eval.synthesize import synthesize_grids
from tpugan_torch.io.bridge import load_variables
from tpugan_torch.io.image import load_image, save_image
from tpugan_torch.losses.lpips import LPIPS, make_lpips_fn
from tpugan_torch.models import PGEncoder, PGGANGenerator
from tpugan_torch.ops import cuda
from tpugan_torch.tools import reference_state

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=0.0)  # tests/test_eval_invert.py


def _pair(rng, h, w, c=3):
    a = rng.rand(h, w, c).astype(np.float32)
    b = np.clip(a + 0.1 * rng.randn(h, w, c), 0, 1).astype(np.float32)
    return a, b


def test_psnr_matches_tpugan(rng):
    a, b = _pair(rng, 24, 20)
    got = metrics.psnr(torch.from_numpy(a * 255), torch.from_numpy(b * 255))
    np.testing.assert_allclose(float(got), float(jmetrics.psnr(jnp.asarray(a * 255), jnp.asarray(b * 255))), **TOL)


@pytest.mark.parametrize("size", [7, 6, 3])
@pytest.mark.parametrize("shape", [(16, 16), (15, 17)], ids=["even", "odd"])
def test_uniform_filter_is_scipys_and_tpugans(size, shape, rng):
    """scipy's 'reflect' boundary (np.pad 'symmetric') with an even window's
    one-less pad after, against scipy and tpugan, per channel."""
    x = rng.rand(*shape, 3).astype(np.float32)
    got = metrics._uniform_filter(torch.from_numpy(x), size).numpy()
    want = np.stack([scipy.ndimage.uniform_filter(x[..., c].astype(np.float64), size) for c in range(3)], -1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(jmetrics._uniform_filter(jnp.asarray(x), size)), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", [(32, 32), (31, 29)], ids=["even", "odd"])
@pytest.mark.parametrize("win", [7, 8])
def test_ssim_matches_tpugan(shape, win, rng):
    a, b = _pair(rng, *shape)
    got = metrics.ssim_uniform(torch.from_numpy(a * 255), torch.from_numpy(b * 255), win_size=win)
    want = jmetrics.ssim_uniform(jnp.asarray(a * 255), jnp.asarray(b * 255), win_size=win)
    np.testing.assert_allclose(float(got), float(want), **TOL)
    same = metrics.ssim_uniform(torch.from_numpy(a * 255), torch.from_numpy(a * 255))
    np.testing.assert_allclose(float(same), 1.0, rtol=1e-6)


@pytest.fixture(scope="module")
def lpips_pair():
    """tpugan's random LPIPS variables and the port's LPIPS on them."""
    variables = jax.tree.map(np.asarray, jlpips_params(jax.random.PRNGKey(7), 32))
    return jmake_lpips_fn(variables), make_lpips_fn(load_variables(LPIPS(), variables))


@pytest.mark.parametrize("with_lpips", [False, True], ids=["no-lpips", "lpips"])
def test_pair_metrics_match_tpugan(with_lpips, lpips_pair, rng):
    a, b = _pair(rng, 32, 32)
    jfn, pfn = lpips_pair if with_lpips else (None, None)
    got = metrics.pair_metrics(torch.from_numpy(a), torch.from_numpy(b), lpips_fn=pfn)
    want = jmetrics.pair_metrics(jnp.asarray(a), jnp.asarray(b), lpips_fn=jfn)
    assert got._fields == want._fields
    for name in want._fields:
        np.testing.assert_allclose(float(getattr(got, name)), float(getattr(want, name)), **TOL, err_msg=name)
    assert (float(got.lpips) != 0.0) == with_lpips


def _write_pairs(tmp_path, rng, n=3, size=40):
    d1, d2 = tmp_path / "d1", tmp_path / "d2"
    for i in range(n):
        a, b = _pair(rng, size, size)
        save_image(str(d1 / f"{i:03d}.png"), a)
        save_image(str(d2 / f"{i:03d}.png"), b)
    (d1 / "notes.txt").write_text("not an image")
    return str(d1), str(d2)


def test_compare_dirs_matches_tpugan(tmp_path, rng, lpips_pair, capsys):
    """PNGs written here, resized to 32 by PIL in both, with LPIPS; the
    progress lines are tpugan's, line for line."""
    d1, d2 = _write_pairs(tmp_path, rng)
    jfn, pfn = lpips_pair
    want = jcompare_dirs(d1, d2, 32, lpips_fn=jfn)
    want_out = capsys.readouterr().out
    got = compare_dirs(d1, d2, 32, lpips_fn=pfn, device="cpu")
    got_out = capsys.readouterr().out
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)
    assert len(got_out.splitlines()) == len(want_out.splitlines()) == 3
    assert [line.split("--")[0] for line in got_out.splitlines()] == ["img_num:1", "img_num:2", "img_num:3"]
    with pytest.raises(FileNotFoundError, match="no paired images"):
        compare_dirs(str(tmp_path / "d1"), str(tmp_path), 32, device="cpu")


def test_compare_cli_matches_tpugans(tmp_path, rng, capsys):
    """Both CLIs on the same directories and the same converted LPIPS file
    (a reference-named state dict from a seed): the JSON dicts agree; and
    without --lpips_weights LPIPS is 0, with tpugan's warning."""
    d1, d2 = _write_pairs(tmp_path, rng, n=2)
    weights = reference_state.save(str(tmp_path / "lpips.pth"), reference_state.lpips(np.random.default_rng(0)))
    for extra in ((), ("--lpips_weights", weights)):
        argv = ["--dir1", d1, "--dir2", d2, "--img_size", "32", *extra]
        jcompare_cli.main(argv)
        want = json.loads(capsys.readouterr().out.splitlines()[-1])
        got = compare.main(argv + ["--device", "cpu"])
        out = capsys.readouterr()
        assert json.loads(out.out.splitlines()[-1]) == got
        for k in want:
            np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)
        assert (got["lpips"] == 0.0) == (not extra)
        assert ("LPIPS loss term is DISABLED" in out.err) == (not extra)


def test_synthesize_grids_matches_tpugan(tmp_path, rng):
    """PGGAN (16 px) and E_PG with the same variables on both sides; the
    port's z is tpugan's draw for each seed; the PNGs agree within one
    8-bit level."""
    gkw = dict(resolution=16, z_space_dim=16, fmaps_base=64, fmaps_max=16)
    ekw = dict(startf=8, maxf=16, layer_count=3, latent_size=16)
    jg, je = JPGGANGenerator(**gkw), JPGEncoder(**ekw)
    gvars = jax.tree.map(lambda v: (rng.randn(*v.shape) * 0.5).astype(np.float32),
                         jg.init(jax.random.PRNGKey(0), jnp.zeros((1, 16))))
    evars = jax.tree.map(np.asarray, je.init(jax.random.PRNGKey(1), jnp.zeros((1, 16, 16, 3))))
    gen = load_variables(PGGANGenerator(**gkw), gvars)
    enc = load_variables(PGEncoder(**ekw, img_size=16), evars)
    want = jsynthesize_grids(lambda key, z: (z, jg.apply(gvars, z)["image"]),
                             lambda imgs: je.apply(evars, imgs)[1],
                             lambda z: jg.apply(gvars, z)["image"],
                             str(tmp_path / "j"), batch_size=2, z_dim=16, start_seed=30000, count=2)

    def draw_z(seed):  # tpugan's draw (tpugan/eval/synthesize.py:42-43)
        key = iteration_key(jnp.int32(seed))
        return torch.from_numpy(np.array(jax.random.normal(jax.random.fold_in(key, 0), (2, 16))))

    got = synthesize_grids(lambda z: (z, gen(z)["image"].permute(0, 2, 3, 1)),
                           lambda imgs: enc(imgs.permute(0, 3, 1, 2))[1],
                           lambda z: gen(z)["image"].permute(0, 2, 3, 1),
                           str(tmp_path / "p"), batch_size=2, z_dim=16, count=2, device="cpu", draw_z=draw_z)
    assert [p.split("/")[-1] for p in got] == [p.split("/")[-1] for p in want] == ["seed30000.png", "seed30001.png"]
    for g, w in zip(got, want):
        a, b = load_image(g), load_image(w)
        assert a.shape == b.shape == (2 * 16 + 3 * 2, 2 * 16 + 3 * 2, 3)
        assert np.abs(a - b).max() <= 1.0 / 255 + 1e-6
    # the default draw: N(0, 1) from the seed's generator, the same on each call
    z_of = []
    synthesize_grids(lambda z: (z_of.append(z) or z, gen(z)["image"].permute(0, 2, 3, 1)),
                     lambda imgs: enc(imgs.permute(0, 3, 1, 2))[1], lambda z: gen(z)["image"].permute(0, 2, 3, 1),
                     str(tmp_path / "d"), z_dim=16, start_seed=30001, count=1, device="cpu")
    assert torch.equal(z_of[0], torch.randn(2, 16, generator=torch.Generator().manual_seed(1)))


def test_eval_functions_run_on_the_card_unless_asked(tmp_path, rng, monkeypatch):
    """compare_dirs and synthesize_grids default to the card and raise
    where there is none, as the CLIs do; nothing is written then."""
    d1, d2 = _write_pairs(tmp_path, rng, n=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compare_dirs(d1, d2, 32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthesize_grids(None, None, None, str(tmp_path / "grids"), serve_seed=lambda seed: 1 / 0)
    assert not (tmp_path / "grids").exists()


SYNTH = ["--img_size", "32", "--start_features", "64", "--random_init", "--device", "cpu", "--count", "2"]


@pytest.mark.parametrize("mtype", ["1", "3"])
def test_synthesize_cli_writes_infer_e_requests(tmp_path, capsys, mtype):
    """Each seed's grid is the infer_e request of that seed (imgs1 over
    imgs2), written to mtype<m>-synth/imgs; on the CPU in fp32 with or
    without --fp32, with no kernel launched and no bf16 note."""
    cuda.reset_launches()
    paths = synthesize.main(["--mtype", mtype, *SYNTH, "--experiment_dir", str(tmp_path / "a")])
    out = capsys.readouterr().out
    assert synthesize.BF16_NOTE not in out and paths == out.split()
    assert [p.split("/")[-1] for p in paths] == ["seed30000.png", "seed30001.png"]
    assert not any(cuda.launches.values())
    again = synthesize.main(["--mtype", mtype, *SYNTH, "--fp32", "--experiment_dir", str(tmp_path / "b")])
    args = synthesize.make_parser().parse_args(["--mtype", mtype, *SYNTH])
    imgs1, imgs2 = infer_e.run(common.build_bundle(args), 2, 30001)
    grid = np.concatenate([imgs1.numpy(), imgs2.numpy()], axis=0) * 0.5 + 0.5
    got = load_image(paths[1])
    assert np.array_equal(got, load_image(again[1]))
    cells = [got[2 + r * 34:2 + r * 34 + 32, 2 + c * 34:2 + c * 34 + 32] for r in range(2) for c in range(2)]
    for cell, want in zip(cells, grid):
        assert np.abs(cell - np.clip(want, 0, 1)).max() <= 0.5 / 255 + 1e-6


def test_synthesize_bf16_form_tracks_fp32(monkeypatch):
    """The card's default form, bf16 generator copies (``bf16_bundle``),
    run here on the CPU: the images come back fp32 and within bf16's reach
    of the fp32 request, not equal to it, and the fp32 bundle is untouched."""
    args = synthesize.make_parser().parse_args(["--mtype", "3", *SYNTH])
    bundle = common.build_bundle(args)
    fp32 = infer_e.run(bundle, 2, 30000)
    bf16 = infer_e.run(synthesize.bf16_bundle(bundle), 2, 30000)
    for a, b in zip(bf16, fp32):
        assert a.dtype == torch.float32
        err = (a - b).abs().max().item() / b.abs().max().item()
        assert 0 < err < 0.1, err
    assert next(bundle.generator.parameters()).dtype == torch.float32
    assert torch.equal(infer_e.run(bundle, 2, 30000)[1], fp32[1])


def test_synthesize_on_the_card_defaults_to_bf16(monkeypatch, capsys, tmp_path):
    """Where the bundle is on the card, the CLI prints tpugan's note and runs
    the bf16 form; --fp32 keeps fp32 (the device check faked on the CPU)."""
    calls = []
    real = synthesize.bf16_bundle
    monkeypatch.setattr(synthesize, "bf16_bundle", lambda b: calls.append(b) or real(b))
    monkeypatch.setattr(synthesize, "_on_card", lambda bundle: True)
    synthesize.main(["--mtype", "3", *SYNTH, "--count", "1", "--experiment_dir", str(tmp_path / "a")])
    assert synthesize.BF16_NOTE in capsys.readouterr().out and len(calls) == 1
    synthesize.main(["--mtype", "3", *SYNTH, "--count", "1", "--fp32", "--experiment_dir", str(tmp_path / "b")])
    assert synthesize.BF16_NOTE not in capsys.readouterr().out and len(calls) == 1
