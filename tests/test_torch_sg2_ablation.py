"""tpugan_torch's StyleGAN2 ablation 8 (``e_align --mtype 2 --ablation 8``:
one update per loss group, loss_c weighted) vs tpugan (CPU), on the setup
and at the tolerances of ``tests/test_torch_sg2_train.py``, a file of its own
so that its compiles run beside that file's."""

import numpy as np
import torch

from test_torch_sg2_train import BATCH, _port_run, _port_trainer, check_step_matches_tpugan
from test_torch_sg2_train import setup  # noqa: F401 (the module's fixture)
from tpugan_torch.losses.space_loss import _kl_quirk
from tpugan_torch.nn.spectral import power_iterate
from tpugan_torch.train.e_align import build_stylegan2_pipeline, nchw_to_nhwc

torch.set_num_threads(1)


def test_ablation8_step_matches_tpugan(setup):  # noqa: F811
    """Three image groups and the latent one, one update each, on the plain
    E (``--case 1``), held to float64 runs of both packages."""
    check_step_matches_tpugan(setup, "ablation8")


def test_ablation8_weights_the_const_loss(setup):  # noqa: F811
    """Ablation 8 weights loss_c by 1 (latent weights (1, 1)): StyleGAN2's
    const [N, 512, 4, 4] against E's const2 enters the losses NHWC, so the
    logged KL takes its softmax over the channels, as tpugan's does."""
    trainer, port = _port_run(setup, "ablation8")
    info = port.infos[0]
    np.testing.assert_allclose(info["loss_mtv"], 0.01 * (5 * info["loss_w_mse"] + 3 * info["loss_w_cosine"]
                                                         + 5 * info["loss_c_mse"] + 3 * info["loss_c_cosine"]),
                               rtol=1e-5)
    # const2 from the step's encoder as the step saw it: a fresh trainer,
    # one power iteration, the same inputs
    trainer = _port_trainer(setup, "ablation8")
    z, ne = setup["forms"]["ablation8"]["inputs"][0]
    synth, _ = build_stylegan2_pipeline(trainer.bundle.generator)
    batch = synth(torch.from_numpy(z))
    power_iterate(trainer.state.encoder)
    with torch.no_grad():
        const2, _ = trainer.bundle.encoder(batch.imgs1.permute(0, 3, 1, 2), ne)
    assert batch.const1.shape == const2.shape == (BATCH, 512, 4, 4)
    kl = _kl_quirk(nchw_to_nhwc(batch.const1), nchw_to_nhwc(const2)).item()
    np.testing.assert_allclose(info["loss_c_kl"], kl, rtol=1e-5)
