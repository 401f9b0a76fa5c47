"""tpugan_torch.io.convert against tpugan.io.convert (CPU).

Random state dicts with the reference's key names and shapes
(``tpugan_torch/tools/reference_state.py``, from a numpy seed) go through
the port's converter into a port module, and through tpugan's converter and
the weight bridge into another: the two must be equal bit for bit. The
port's module must then match the tpugan module built from tpugan's
conversion, forward, on the same numpy inputs, within rtol 2e-3 and atol
2e-4 of max |ref|. The CLI's loading goes through files in ``tmp_path``.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugan.io import convert as jconvert
from tpugan.losses.lpips import LPIPS as JLPIPS
from tpugan.losses.vgg import VGG16 as JVGG16
from tpugan.models.biggan import BigGAN as JBigGAN
from tpugan.models.biggan import BigGANConfig as JConfig
from tpugan.models.encoders import BigGANEncoder as JBigGANEncoder
from tpugan.models.encoders import Encoder as JEncoder
from tpugan.models.stylegan1 import StyleGANv1Generator as JGenerator
from tpugan.models.stylegan1 import StyleGANv1Mapping as JMapping
from tpugan.models.stylegan1 import truncation_coefs as jtruncation_coefs
from tpugan.models.stylegan2 import StyleGAN2Generator as JStyleGAN2
from tpugan_torch.cli import common
from tpugan_torch.io import convert
from tpugan_torch.io.bridge import load_variables
from tpugan_torch.losses.lpips import LPIPS
from tpugan_torch.losses.vgg import VGG16
from tpugan_torch.models import (
    BigGAN,
    BigGANConfig,
    BigGANEncoder,
    Encoder,
    StyleGAN2Generator,
    StyleGANv1Generator,
    StyleGANv1Mapping,
    truncation_coefs,
)
from tpugan_torch.tools import reference_state

torch.set_num_threads(1)

# tests/test_stylegan1.py:134, as a share of the reference's largest value
RTOL, ATOL = 2e-3, 2e-4


def close(got, ref):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL * max(1.0, float(np.abs(ref).max())))


def bitwise(a: torch.nn.Module, b: torch.nn.Module):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def nhwc(x):
    return x.detach().numpy().transpose(0, 2, 3, 1)


def jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def seeded(seed=0):
    return np.random.default_rng(seed)


def draw(shapes, rng):
    """Port noise (NCHW) and the same values for tpugan (NHWC)."""
    port = [tuple(torch.from_numpy(rng.standard_normal(s, dtype=np.float32)) for s in blk) for blk in shapes]
    return port, [tuple(jnp.asarray(nhwc(n)) for n in blk) for blk in port]


SGV1 = dict(startf=8, maxf=32, layer_count=6, latent=16)  # 128 px: block 5 is a fused one


def test_stylegan1_generator_with_a_fused_block():
    k = SGV1
    gs, _, _ = reference_state.stylegan1(seeded(), k["startf"], k["maxf"], k["layer_count"], k["latent"])
    assert gs["decode_block.5.conv_1.weight"].shape == (16, 8, 3, 3)  # [in, out, kh, kw]
    make = lambda: StyleGANv1Generator(startf=k["startf"], maxf=k["maxf"], layer_count=k["layer_count"],
                                       latent_size=k["latent"])
    port = convert.load_state(make(), convert.stylegan1_generator(gs, k["layer_count"]))
    jparams = jconvert.stylegan1_generator(gs, k["layer_count"])
    bitwise(port, load_variables(make(), {"params": jparams}))

    rng = seeded(1)
    styles = rng.standard_normal((2, 2 * k["layer_count"], k["latent"]), dtype=np.float32)
    noise, jnoise = draw(port.noise_shapes(2), rng)
    jgen = JGenerator(startf=k["startf"], maxf=k["maxf"], layer_count=k["layer_count"], latent_size=k["latent"])
    lod = k["layer_count"] - 1
    ref = jgen.apply({"params": jtree(jparams)}, jnp.asarray(styles), lod, 1.0, jnoise)
    with torch.no_grad():
        got = port(torch.from_numpy(styles), lod, noise)
    close(nhwc(got), ref)


def test_stylegan1_mapping_and_center(tmp_path):
    k = SGV1
    _, gm, center = reference_state.stylegan1(seeded(), k["startf"], k["maxf"], k["layer_count"], k["latent"])
    kw = dict(num_layers=2 * k["layer_count"], mapping_layers=8, latent_size=k["latent"],
              dlatent_size=k["latent"], mapping_fmaps=k["latent"])
    port = convert.load_state(StyleGANv1Mapping(**kw), convert.stylegan1_mapping(gm))
    jparams = jconvert.stylegan1_mapping(gm)
    bitwise(port, load_variables(StyleGANv1Mapping(**kw), {"params": jparams}))
    path = reference_state.save(str(tmp_path / "center_tensor.pt"), center)
    c = convert.center_tensor(path)
    assert np.array_equal(c, jconvert.center_tensor(path)) and c.shape == (2 * k["layer_count"], k["latent"])
    z = seeded(2).standard_normal((3, k["latent"]), dtype=np.float32)
    n = 2 * k["layer_count"]
    ref = JMapping(**kw).apply({"params": jtree(jparams)}, jnp.asarray(z), jtruncation_coefs(n), jnp.asarray(c))
    with torch.no_grad():
        got = port(torch.from_numpy(z), truncation_coefs(n), torch.from_numpy(c))
    close(got, ref)


SG2_KW = dict(resolution=32, z_space_dim=32, w_space_dim=32, mapping_layers=3, mapping_fmaps=32,
              fmaps_base=512, fmaps_max=64)


@pytest.mark.parametrize("form", ["nested", "prefixed"])
def test_stylegan2_generator_in_both_generator_smooth_forms(form):
    inner = reference_state.stylegan2(seeded(), lambda: StyleGAN2Generator(**SG2_KW))
    if form == "nested":
        state = {"generator_smooth": inner, "discriminator": {"x.weight": np.ones((2, 2), np.float32)}}
    else:
        state = {**{f"generator_smooth.{k}": v for k, v in inner.items()},
                 **{f"generator.{k}": 2 * v for k, v in inner.items()}}
    unwrapped = convert.stylegan2_state(state)
    assert unwrapped.keys() == inner.keys() and all(np.array_equal(unwrapped[k], inner[k]) for k in inner)
    port = convert.load_state(StyleGAN2Generator(**SG2_KW), convert.stylegan2_generator(unwrapped))
    jvars = jconvert.stylegan2_generator(inner)
    bitwise(port, load_variables(StyleGAN2Generator(**SG2_KW), jvars))

    z = seeded(3).standard_normal((2, 32), dtype=np.float32)
    ref = JStyleGAN2(**SG2_KW).apply(jtree(jvars), jnp.asarray(z), trunc_psi=0.7, trunc_layers=8)
    with torch.no_grad():
        got = port(torch.from_numpy(z), trunc_psi=0.7, trunc_layers=8)
    close(nhwc(got["image"]), ref["image"])


def test_stylegan2_state_falls_back_to_generator():
    inner = {"truncation.w_avg": np.zeros(4, np.float32)}
    assert convert.stylegan2_state({"generator": inner}) == inner
    assert convert.stylegan2_state(inner) == inner


@pytest.mark.parametrize("missing", [None, "u", "v"])
def test_fold_spectral_norm_matches_tpugans_draw(missing):
    rng = seeded(4)
    state = {"m.weight_orig": rng.standard_normal((6, 3, 2, 2), dtype=np.float32),
             "m.weight_u": rng.standard_normal(6, dtype=np.float32),
             "m.weight_v": rng.standard_normal(12, dtype=np.float32),
             "m.bias": rng.standard_normal(6, dtype=np.float32)}
    if missing:
        del state[f"m.weight_{missing}"]
    got, ref = convert.fold_spectral_norm(state), jconvert.fold_spectral_norm(state)
    assert got.keys() == ref.keys() == {"m.weight", "m.bias"}
    for k in got:
        assert np.array_equal(got[k], ref[k]), k


# tests/test_biggan.py::tiny_config (tests/test_torch_biggan.py)
TINY_BIGGAN = dict(
    output_dim=16, z_dim=8, class_embed_dim=8, channel_width=4, num_classes=10,
    layers=[(False, 16, 16), (True, 16, 8), (False, 8, 4), (True, 4, 2), (False, 2, 1)],
    attention_layer_position=1, eps=1e-4, n_stats=51,
)


def test_biggan_folds_every_spectral_norm():
    cfg = BigGANConfig(**TINY_BIGGAN)
    state = reference_state.biggan(seeded(), cfg)
    assert "generator.conv_to_rgb.weight_u" not in state and "generator.gen_z.weight_v" not in state
    assert "generator.layers.1.gamma" in state
    port = convert.load_state(BigGAN(cfg), convert.biggan(state)).eval()
    jvars = jconvert.biggan(state)
    bitwise(port, load_variables(BigGAN(cfg), jvars))

    rng = seeded(5)
    z = rng.standard_normal((2, 8), dtype=np.float32)
    label = np.eye(10, dtype=np.float32)[[3, 7]]
    ref_img, ref_cond = JBigGAN(JConfig(**TINY_BIGGAN)).apply(jtree(jvars), jnp.asarray(z), jnp.asarray(label), 0.4)
    with torch.no_grad():
        img, cond = port(torch.from_numpy(z), torch.from_numpy(label), 0.4)
    close(cond, ref_cond)
    close(nhwc(img), ref_img)


def test_encoder():
    kw = dict(startf=8, maxf=32, layer_count=3, latent_size=16, use_blur=True)
    state = reference_state.encoder(seeded(), lambda: Encoder(**kw))
    assert state["decode_block.0.noise_weight_1"].shape == (1, 8, 1, 1)
    port = convert.load_state(Encoder(**kw), convert.encoder(state, 3))
    jparams = jconvert.encoder(state, 3)
    bitwise(port, load_variables(Encoder(**kw), {"params": jparams}))

    rng = seeded(6)
    imgs = rng.standard_normal((2, 16, 16, 3), dtype=np.float32)
    noise, jnoise = draw(port.noise_shapes(2, 16), rng)
    ref = JEncoder(**kw).apply({"params": jtree(jparams)}, jnp.asarray(imgs), 0, jnoise)
    with torch.no_grad():
        got = port(nchw(imgs), noise)
    for g, r in zip(got, ref):
        close(nhwc(g) if g.dim() == 4 else g, r)


EBIG = dict(startf=8, maxf=32, layer_count=3, cond_dim=16, z_dim=8)  # 16 px: the last map is [32, 4, 4]


def test_biggan_encoder_keeps_live_spectral_norm_and_reorders_new_final_1():
    state = reference_state.biggan_encoder(seeded(), lambda: BigGANEncoder(**EBIG, img_size=16))
    assert state["new_final_1.weight"].shape == (16, 32 * 4 * 4)
    port = convert.load_state(BigGANEncoder(**EBIG, img_size=16), convert.biggan_encoder(state, 3, maxf=32)).eval()
    jvars = jconvert.biggan_encoder(state, 3, maxf=32)
    bitwise(port, load_variables(BigGANEncoder(**EBIG, img_size=16), jvars))
    assert torch.equal(port.block_0.batch_norm_1.scale.u,
                       torch.from_numpy(state["decode_block.0.batch_norm_1.scale.weight_u"]))

    rng = seeded(7)
    imgs = rng.standard_normal((2, 16, 16, 3), dtype=np.float32)
    cv = rng.standard_normal((2, 16), dtype=np.float32)
    noise, jnoise = draw(port.noise_shapes(2, 16), rng)
    ref_c, ref_z = JBigGANEncoder(**EBIG).apply(jtree(jvars), jnp.asarray(imgs), jnp.asarray(cv), jnoise)
    with torch.no_grad():
        c_v, z = port(nchw(imgs), torch.from_numpy(cv), noise)
    close(c_v, ref_c)
    close(z, ref_z)


@pytest.fixture(scope="module")
def vgg_state():
    return reference_state.vgg16(seeded(8), num_classes=10)


def test_vgg16_with_its_classifier_keeps_the_nchw_flatten(vgg_state):
    with torch.device("meta"):
        metas = VGG16(num_classes=10), VGG16(num_classes=10)
    port = convert.load_state(metas[0].to_empty(device="cpu"), convert.vgg16(vgg_state))
    jparams = jconvert.vgg16(vgg_state)
    bitwise(port, load_variables(metas[1].to_empty(device="cpu"), {"params": jparams}))
    assert torch.equal(port.head.fc_0.weight, torch.from_numpy(vgg_state["classifier.0.weight"]))

    x = seeded(9).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    ref_logits, ref_feats = JVGG16(num_classes=10).apply({"params": jtree(jparams)}, jnp.asarray(x))
    with torch.no_grad():
        logits, feats = port(nchw(x))
    close(logits, ref_logits)
    close(nhwc(feats[-1]), ref_feats[-1])


def test_lpips():
    state = reference_state.lpips(seeded(10))
    assert state["net.slice3.14.weight"].shape == (256, 256, 3, 3) and state["lin4.model.1.weight"].shape == (1, 512, 1, 1)
    port = convert.load_state(LPIPS(), convert.lpips_vgg(state))
    jparams = jconvert.lpips_vgg(state)
    bitwise(port, load_variables(LPIPS(), {"params": jparams}))
    rng = seeded(11)
    a, b = (rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32) for _ in range(2))
    ref = JLPIPS().apply({"params": jtree(jparams)}, jnp.asarray(a), jnp.asarray(b))
    with torch.no_grad():
        got = port(torch.from_numpy(a), torch.from_numpy(b))
    close(got, ref)


def test_a_url_and_a_pickled_module_are_refused(tmp_path):
    with pytest.raises(ValueError, match="URL"):
        convert.load_torch_state_dict("https://example.com/G.pth")
    path = tmp_path / "module.pth"
    torch.save(torch.nn.Linear(2, 2), path)
    with pytest.raises(ValueError, match="state_dict"):
        convert.load_torch_state_dict(path)
    torch.save({"w": torch.ones(2), "inner": {"b": torch.zeros(1)}}, tmp_path / "ok.pth")
    got = convert.load_torch_state_dict(tmp_path / "ok.pth")
    assert np.array_equal(got["w"], np.ones(2)) and np.array_equal(got["inner"]["b"], np.zeros(1))


def _parse(*argv):
    return common.add_common_args(argparse.ArgumentParser(), training=True).parse_args(
        [*argv, "--device", "cpu"])


def test_cli_loads_stylegan1_and_its_encoder_from_files(tmp_path):
    """--checkpoint_dir_GAN (the three files) and --checkpoint_dir_E at 32 px
    (layer_count 4): the bundle's modules are the converters', and a request
    truncates towards the loaded center, as tpugan's closures do."""
    gs, gm, center = reference_state.stylegan1(seeded(12), 64, 512, 4)
    for name, state in (("Gs_dict.pth", gs), ("Gm_dict.pth", gm), ("center_tensor.pt", center)):
        reference_state.save(str(tmp_path / "gan" / name), state)
    e_state = reference_state.encoder(seeded(13), lambda: Encoder(startf=64, maxf=512, layer_count=4,
                                                                    latent_size=512))
    reference_state.save(str(tmp_path / "E.pth"), e_state)
    bundle = common.build_bundle(_parse("--mtype", "1", "--img_size", "32", "--start_features", "64",
                                        "--checkpoint_dir_GAN", str(tmp_path / "gan"),
                                        "--checkpoint_dir_E", str(tmp_path / "E.pth")))
    gen = StyleGANv1Generator(startf=64, maxf=512, layer_count=4, latent_size=512)
    bitwise(bundle.generator, load_variables(gen, {"params": jconvert.stylegan1_generator(gs, 4)}))
    enc = Encoder(startf=64, maxf=512, layer_count=4, latent_size=512)
    bitwise(bundle.encoder, load_variables(enc, {"params": jconvert.encoder(e_state, 4)}))
    assert np.array_equal(bundle.center.numpy(), center[0])
    z = torch.from_numpy(seeded(14).standard_normal((2, 512), dtype=np.float32))
    w = bundle.synth(z, None).w1
    ref = bundle.mapping(z, truncation_coefs(8), torch.from_numpy(center[0]))
    assert torch.equal(w, ref) and not torch.equal(w, bundle.mapping(z, truncation_coefs(8)))
    assert torch.equal(bundle.remap(z), ref)


@pytest.mark.parametrize("form", ["nested", "prefixed"])
def test_cli_loads_stylegan2_from_its_pth(tmp_path, form):
    inner = reference_state.stylegan2(seeded(15), lambda: StyleGAN2Generator(resolution=32))
    state = {"generator_smooth": inner} if form == "nested" else {f"generator_smooth.{k}": v
                                                                    for k, v in inner.items()}
    reference_state.save(str(tmp_path / "G.pth"), state)
    bundle = common.build_bundle(_parse("--mtype", "2", "--img_size", "32", "--start_features", "64",
                                        "--checkpoint_dir_GAN", str(tmp_path / "G.pth")))
    bitwise(bundle.generator, load_variables(StyleGAN2Generator(resolution=32),
                                             jconvert.stylegan2_generator(inner)))


# tests/test_torch_train.py::CFG, a 32 px BigGAN-deep
CFG32 = dict(
    output_dim=32, z_dim=8, class_embed_dim=8, channel_width=4, num_classes=10,
    layers=[(False, 16, 16), (True, 16, 8), (True, 8, 4), (True, 4, 2), (False, 2, 1)],
    attention_layer_position=2, eps=1e-4, n_stats=51,
)


def test_cli_loads_biggan_with_its_config_and_e_big(tmp_path):
    """--checkpoint_dir_GAN with --config_dir, and E_BIG from
    --checkpoint_dir_E (start_features 64 at 32 px: the last block is 512
    wide on a 4x4 map, the layout tpugan's converter assumes)."""
    cfg = BigGANConfig(**CFG32)
    (tmp_path / "config.json").write_text(cfg.to_json_string())
    g_state = reference_state.biggan(seeded(16), cfg)
    make_e = lambda: BigGANEncoder(startf=64, maxf=512, layer_count=4, cond_dim=16, z_dim=8, img_size=32)
    e_state = reference_state.biggan_encoder(seeded(17), make_e)
    reference_state.save(str(tmp_path / "G.pt"), g_state)
    reference_state.save(str(tmp_path / "E.pth"), e_state)
    bundle = common.build_bundle(_parse("--mtype", "4", "--img_size", "32", "--start_features", "64",
                                        "--config_dir", str(tmp_path / "config.json"),
                                        "--checkpoint_dir_GAN", str(tmp_path / "G.pt"),
                                        "--checkpoint_dir_E", str(tmp_path / "E.pth")))
    bitwise(bundle.generator, load_variables(BigGAN(cfg), jconvert.biggan(g_state)))
    bitwise(bundle.encoder, load_variables(make_e(), jconvert.biggan_encoder(e_state, 4)))
    assert not bundle.generator.training and not bundle.encoder.training


def test_cli_builds_lpips_and_vgg16_from_files(tmp_path, vgg_state, capsys):
    """--lpips_weights (fp32, and bf16 under --bf16 unless --fp32_lpips) and
    --vgg_weights (1000 classes, the CLI's VGG16) from files."""
    lpips_state = reference_state.lpips(seeded(18))
    reference_state.save(str(tmp_path / "lpips.pth"), lpips_state)
    rng = seeded(19)
    vgg_1000 = {**vgg_state, "classifier.6.weight": rng.standard_normal((1000, 4096), dtype=np.float32) * 0.02,
                "classifier.6.bias": rng.standard_normal(1000, dtype=np.float32) * 0.1}
    reference_state.save(str(tmp_path / "vgg16.pth"), vgg_1000)
    args = _parse("--lpips_weights", str(tmp_path / "lpips.pth"), "--vgg_weights", str(tmp_path / "vgg16.pth"))
    a, b = (rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32) for _ in range(2))
    ref = JLPIPS().apply({"params": jtree(jconvert.lpips_vgg(lpips_state))}, jnp.asarray(a), jnp.asarray(b))
    with torch.no_grad():
        close(common.build_lpips_fn(args)(torch.from_numpy(a), torch.from_numpy(b)), ref)
        args.bf16 = True
        bf16 = common.build_lpips_fn(args)(torch.from_numpy(a), torch.from_numpy(b))
        args.fp32_lpips = True
        fp32 = common.build_lpips_fn(args)(torch.from_numpy(a), torch.from_numpy(b))
    assert bf16.dtype == torch.float32 and not torch.equal(bf16, fp32)
    close(fp32, ref)
    vgg = common.build_vgg16(args)
    assert not any(p.requires_grad for p in vgg.parameters())
    assert torch.equal(vgg.head.fc_2.weight, torch.from_numpy(vgg_1000["classifier.6.weight"]))
    assert torch.equal(vgg.conv_12.weight, torch.from_numpy(vgg_1000["features.28.weight"]))
    assert "RANDOM" not in capsys.readouterr().err
