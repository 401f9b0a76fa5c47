"""The tpugan_torch serving slice (z -> Mapping -> G -> E -> G) vs tpugan,
end to end on the CPU, plus the port's boundary rules: no JAX or tpugan
import anywhere in the package or in chip_smoke.py, no silent CPU fallback,
and no kernel launch for CPU tensors.
"""

import argparse
import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugan.models.encoders import Encoder as JEncoder
from tpugan.models.stylegan1 import StyleGANv1Generator as JGenerator
from tpugan.models.stylegan1 import StyleGANv1Mapping as JMapping
from tpugan.train.e_align import build_stylegan1_pipeline as jbuild_pipeline
from tpugan.train.e_align import make_encode_fn as jmake_encode_fn
from tpugan_torch.cli import common, infer_e
from tpugan_torch.io.bridge import load_variables
from tpugan_torch.models import Encoder, StyleGANv1Generator, StyleGANv1Mapping
from tpugan_torch.ops import cuda
from tpugan_torch.runtime import resolve_device
from tpugan_torch.train.e_align import build_stylegan1_pipeline, make_encode_fn

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
# tests/test_stylegan1.py:134, through two generator passes and the encoder
SLICE_TOL = dict(rtol=2e-3, atol=2e-4)


def nhwc(x):
    return x.detach().numpy().transpose(0, 2, 3, 1)


def randomized(variables, rng):
    variables = jax.tree.map(np.asarray, variables)
    params = jax.tree.map(
        lambda p: (rng.randn(*p.shape) * 0.1).astype(np.float32), variables["params"]
    )
    return {**variables, "params": params}


class _RecordedNoise:
    """Stands in for a flax module inside tpugan's closures and applies it
    with recorded noise in place of the rng draw, one set per call."""

    def __init__(self, module, noises, call):
        self.module, self.noises, self.call = module, list(noises), call

    def apply(self, variables, *args, rngs=None):
        return self.call(self.module, variables, args, self.noises.pop(0))


def test_slice_matches_tpugan_pipeline(rng):
    layer_count, latent, batch, res = 3, 32, 2, 16
    gkw = dict(startf=16, maxf=64, layer_count=layer_count, latent_size=latent)
    mkw = dict(num_layers=2 * layer_count, mapping_layers=3, latent_size=latent,
               dlatent_size=latent, mapping_fmaps=latent)
    ekw = dict(startf=16, maxf=64, layer_count=layer_count, latent_size=latent)
    gen, gm, enc = StyleGANv1Generator(**gkw), StyleGANv1Mapping(**mkw), Encoder(**ekw)

    def noise(shapes):
        port = [tuple(torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in b) for b in shapes]
        return port, [tuple(jnp.asarray(nhwc(n)) for n in b) for b in port]

    z = rng.randn(batch, latent).astype(np.float32)
    center = rng.randn(2 * layer_count, latent).astype(np.float32)
    ng, ng_j = noise(gen.noise_shapes(batch))
    ne, ne_j = noise(enc.noise_shapes(batch, res))
    ng2, ng2_j = noise(gen.noise_shapes(batch))

    # tpugan side: its own pipeline closures, with the noise recorded above
    jg, jm, je = JGenerator(**gkw), JMapping(**mkw), JEncoder(**ekw)
    gen_vars = randomized(jg.init(jax.random.PRNGKey(0), jnp.zeros((1, 6, latent))), rng)
    gm_vars = randomized(jm.init(jax.random.PRNGKey(1), jnp.zeros((1, latent))), rng)
    enc_vars = randomized(je.init(jax.random.PRNGKey(2), jnp.zeros((1, res, res, 3))), rng)
    lod = layer_count - 1
    jgen = _RecordedNoise(jg, [ng_j, ng2_j], lambda m, v, a, n: m.apply(v, a[0], a[1], 1.0, n))
    jenc = _RecordedNoise(je, [ne_j], lambda m, v, a, n: m.apply(v, a[0], 0, n))
    synth, resynth, frozen = jbuild_pipeline(jgen, jm, gen_vars, gm_vars, lod, center=jnp.asarray(center))
    key = jax.random.PRNGKey(3)
    jbatch = synth(frozen, key, jnp.asarray(z))
    jconst2, jw2 = jmake_encode_fn(jenc, {})(enc_vars["params"], jbatch, key)
    jimgs2 = resynth(frozen, jw2, jbatch, key)

    # port side
    load_variables(gen, gen_vars, unused=("to_rgb_0", "to_rgb_1"))
    load_variables(gm, gm_vars)
    load_variables(enc, enc_vars)
    psynth, presynth = build_stylegan1_pipeline(gen, gm, lod, center=torch.from_numpy(center))
    batch_t = psynth(torch.from_numpy(z), ng)
    const2, w2 = make_encode_fn(enc)(batch_t, ne)
    imgs2 = presynth(w2, batch_t, ng2)

    np.testing.assert_allclose(batch_t.w1.numpy(), np.asarray(jbatch.w1), **SLICE_TOL)
    assert batch_t.imgs1.shape == jbatch.imgs1.shape == (batch, res, res, 3)
    np.testing.assert_allclose(batch_t.imgs1.numpy(), np.asarray(jbatch.imgs1), **SLICE_TOL)
    np.testing.assert_allclose(nhwc(batch_t.const1), np.asarray(jbatch.const1), **SLICE_TOL)
    np.testing.assert_allclose(nhwc(const2), np.asarray(jconst2), **SLICE_TOL)
    np.testing.assert_allclose(w2.numpy(), np.asarray(jw2), **SLICE_TOL)
    np.testing.assert_allclose(imgs2.numpy(), np.asarray(jimgs2), **SLICE_TOL)


def _args(*extra):
    parser = common.add_common_args(argparse.ArgumentParser(), training=True)
    return parser.parse_args(
        ["--mtype", "1", "--img_size", "32", "--start_features", "64", "--random_init", *extra]
    )


def test_request_runs_on_cpu_without_a_launch_and_is_seeded():
    cuda.reset_launches()
    bundle = common.build_bundle(_args("--device", "cpu"))
    imgs1, imgs2 = infer_e.run(bundle, 2, 30000)
    assert imgs1.shape == imgs2.shape == (2, 32, 32, 3)
    assert torch.isfinite(imgs1).all() and torch.isfinite(imgs2).all()
    assert not any(cuda.launches.values())
    again = infer_e.run(common.build_bundle(_args("--device", "cpu")), 2, 0)  # 30000 % 30000
    torch.testing.assert_close(again[1], imgs2, rtol=0, atol=0)


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        common.build_bundle(_args())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        infer_e.main(["--mtype", "1", "--img_size", "32", "--start_features", "64",
                      "--random_init", "--experiment_dir", str(tmp_path)])
    assert resolve_device("cpu") == torch.device("cpu")


def test_cli_writes_grids_on_cpu(tmp_path):
    infer_e.main(["--mtype", "1", "--img_size", "32", "--start_features", "64", "--random_init",
                  "--device", "cpu", "--count", "1", "--experiment_dir", str(tmp_path)])
    assert (tmp_path / "imgs" / "infer_seed30000.png").exists()


@pytest.mark.parametrize(
    "extra,match",
    [
        (("--mtype", "3"), "slice 7"),
        (("--checkpoint_dir_E", "e.pth"), "checkpoints"),
        (("--space_shards", "2"), "parallelism"),
        (("--multihost",), "parallelism"),
    ],
)
def test_later_slices_raise(tmp_path, monkeypatch, extra, match):
    """The space axis on mtypes 3 and 4 waits for ROADMAP A 1's part 2; a converted encoder
    (``--checkpoint_dir_E``, slice 7a) now loads: a reference-named E state
    dict from a seed, written to the file the flag names; PGGAN (mtype 3,
    slice 7b) now builds on the CPU with E_PG and answers a request
    (tests/test_torch_pggan.py holds it to tpugan); ``--multihost`` (slice
    7e) starts a process group where one is described and is a no-op for a
    single process, as tpugan's (tests/test_torch_parallel.py runs a
    2-rank group)."""
    if extra[0] == "--mtype":
        bundle = common.build_bundle(_args("--device", "cpu", *extra))
        assert bundle.mtype == 3 and type(bundle.generator).__name__ == "PGGANGenerator"
        assert type(bundle.encoder).__name__ == "PGEncoder"
        imgs1, imgs2 = infer_e.run(bundle, 2, 30000)
        assert imgs1.shape == imgs2.shape == (2, 32, 32, 3)
        assert torch.isfinite(imgs1).all() and torch.isfinite(imgs2).all()
        return
    if extra[0] == "--checkpoint_dir_E":
        from tpugan_torch.io import convert
        from tpugan_torch.tools import reference_state

        monkeypatch.chdir(tmp_path)
        state = reference_state.encoder(np.random.default_rng(0), lambda: Encoder(
            startf=64, maxf=512, layer_count=4, latent_size=512))
        reference_state.save(extra[1], state)
        bundle = common.build_bundle(_args("--device", "cpu", *extra))
        want = convert.load_state(Encoder(startf=64, maxf=512, layer_count=4, latent_size=512),
                                  convert.encoder(state, 4))
        for name, value in want.state_dict().items():
            assert torch.equal(bundle.encoder.state_dict()[name], value), name
        return
    if extra[0] == "--space_shards":
        # the space axis runs mtypes 1 and 2 (tests/test_torch_spatial_steps.py);
        # mtypes 3 and 4 wait for ROADMAP A 1's part 2
        assert common.build_bundle(_args("--device", "cpu", *extra)).mtype == 1
        with pytest.raises(NotImplementedError, match=match):
            common.build_bundle(_args("--device", "cpu", *extra, "--mtype", "4"))
        return
    if extra[0] == "--multihost":
        import torch.distributed as dist

        for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
            monkeypatch.delenv(var, raising=False)
        bundle = common.build_bundle(_args("--device", "cpu", *extra))
        assert not dist.is_initialized() and bundle.mtype == 1
        return
    with pytest.raises(NotImplementedError, match=match):
        common.build_bundle(_args("--device", "cpu", *extra))


@pytest.mark.parametrize("ablation", [2, 3, 8])
def test_ablation_encoders_serve(ablation):
    """--ablation, refused until slice 2, now builds the ladder's encoder
    (E_Blur_W_2, E_Blur_W, E_Blur), which answers a request on the CPU."""
    bundle = common.build_bundle(_args("--device", "cpu", "--ablation", str(ablation)))
    assert bundle.encoder.block_0.use_blur and bundle.encoder.block_0.use_noise == (ablation > 3)
    imgs1, imgs2 = infer_e.run(bundle, 2, 0)
    assert imgs2.shape == (2, 32, 32, 3) and torch.isfinite(imgs2).all()


def test_gradcam_raises_until_its_slice(tmp_path, monkeypatch):
    """--gradcam, refused until slice 6, now runs (tests/test_torch_mis_align.py
    writes its CAM dumps), and since slice 7a with converted VGG16 weights:
    a reference-named torchvision state dict from a seed, handed over in
    place of the file."""
    from tpugan_torch.io import convert
    from tpugan_torch.tools import reference_state

    state = reference_state.vgg16(np.random.default_rng(0))
    monkeypatch.chdir(tmp_path)
    (tmp_path / "vgg16.pth").touch()  # the flag names a file, which must exist (io/fetch.py's rule)
    monkeypatch.setattr(convert, "load_torch_state_dict", {"vgg16.pth": state}.get)
    infer_e.main(["--gradcam", "--vgg_weights", "vgg16.pth", "--mtype", "1", "--img_size", "32",
                  "--start_features", "64", "--random_init", "--device", "cpu", "--count", "1",
                  "--experiment_dir", str(tmp_path)])
    assert (tmp_path / "imgs" / "cam_seed30000.png").exists()


FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "tpugan"}


def _imported(nodes):
    for node in nodes:
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize(
    "path",
    sorted((ROOT / "tpugan_torch").rglob("*.py"))
    + [ROOT / "chip_smoke.py", ROOT / "tests" / "torch_parallel_worker.py", ROOT / "tests" / "torch_spatial_worker.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_port_imports_no_jax_and_no_tpugan(path):
    """Neither the package, chip_smoke.py nor the data-parallel test's
    worker (the spawned ranks) imports JAX, flax, optax or the JAX package
    anywhere; triton, where a kernel needs it, is imported inside the
    launching function, never at module level."""
    tree = ast.parse(path.read_text(), filename=str(path))
    found = set(_imported(ast.walk(tree))) & FORBIDDEN
    assert not found, f"{path} imports {found}"
    assert "triton" not in set(_imported(tree.body))


@pytest.mark.parametrize("module", ["config.py", "profiling.py", "io/export.py", "cli/export_model.py",
                                    "models/pggan_alt.py", "tools/operator_overhead.py"])
def test_slice_7d_modules_are_read_by_the_ast_test(module):
    """Slice 7d's modules exist and are among the files
    ``test_port_imports_no_jax_and_no_tpugan`` reads."""
    path = ROOT / "tpugan_torch" / module
    assert path in set((ROOT / "tpugan_torch").rglob("*.py"))
    test_port_imports_no_jax_and_no_tpugan(path)


@pytest.mark.parametrize("module", ["parallel/__init__.py", "parallel/mesh.py", "io/native.py", "io/fetch.py",
                                    "runtime.py", "../tests/torch_parallel_worker.py"])
def test_slice_7e_modules_are_read_by_the_ast_test(module):
    """Slice 7e's modules (and the spawned ranks' worker) exist and are among
    the files ``test_port_imports_no_jax_and_no_tpugan`` reads."""
    path = (ROOT / "tpugan_torch" / module).resolve()
    assert path in {p.resolve() for p in (ROOT / "tpugan_torch").rglob("*.py")} | {
        ROOT / "tests" / "torch_parallel_worker.py"}
    test_port_imports_no_jax_and_no_tpugan(path)


@pytest.mark.parametrize("module", ["parallel/spatial.py", "parallel/mesh.py", "models/encoders.py",
                                    "losses/space_loss.py", "../tests/torch_spatial_worker.py"])
def test_slice_7f_modules_are_read_by_the_ast_test(module):
    """The space axis's modules (and the spatial tests' spawned ranks'
    worker) exist and are among the files
    ``test_port_imports_no_jax_and_no_tpugan`` reads."""
    path = (ROOT / "tpugan_torch" / module).resolve()
    assert path in {p.resolve() for p in (ROOT / "tpugan_torch").rglob("*.py")} | {
        ROOT / "tests" / "torch_spatial_worker.py"}
    test_port_imports_no_jax_and_no_tpugan(path)
