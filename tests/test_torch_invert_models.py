"""tpugan_torch's ``make_embedder`` on StyleGAN2 and on BigGAN with E_BIG
vs tpugan's (CPU), in both modes: the FIR adjoints of StyleGAN2's
up-sampling FIRs and ToRGB up-2s, and E_BIG's spectral norms (two power
iterations an iteration against the live E when fine-tuning, one against
the base E when optimising w) and BigGAN's attention backward. The setups
and the rules are ``tests/test_torch_invert.py``'s; a file of its own so
that the two run on two workers.

Tolerances: float64 on both sides, 2 iterations, ``F64_TOL`` (rtol 1e-4,
atol 1e-4 of the largest value). Fine-tuning E_BIG, w and the images leave
it (3.8e-4 of 0.79 for w): LREQAdam's first update is about lr * c *
sign(g), so an element whose gradient is near zero moves with the sign of
fp32's rounding, which both packages keep inside their float64 runs (norm
moments, the attention's scores). There the losses are held to
``F64_TOL`` and w, the snapshot and the images by the rule of
``tests/test_torch_bf16.py``: no farther from tpugan's float64 run than
twice tpugan's own fp32 run is.
"""

import numpy as np
import pytest
import torch

from test_torch_bf16 import assert_as_close_as_tpugan
from test_torch_invert import (
    BIGGAN_IMG,
    EBIG_KW,
    F64_TOL,
    MODES,
    _assert_calls_close,
    _assert_results_close,
    _jax_run,
    _port_run,
    _setup,
)
from tpugan_torch.io.bridge import load_variables
from tpugan_torch.models import BigGANEncoder

torch.set_num_threads(1)

SIGN_KEYS = ("w", "w_best", "images")


@pytest.mark.parametrize("model,mode", [(m, mode) for m in ("sg2", "ebig") for mode in MODES])
def test_stylegan2_and_ebig_match_tpugan(model, mode):
    setup = _setup(model)
    cfg = dict(iterations=2, chunk=1, optimize_e=MODES[mode])
    want, want_calls = _jax_run(setup, np.float64, **cfg)
    got, got_calls, encoder = _port_run(setup, torch.float64, **cfg)
    if model == "ebig" and MODES[mode]:
        _assert_results_close(got, want, F64_TOL, keys=("losses", "loss_best", "msiv", "wnorm"))
        fp32, fp32_calls = _jax_run(setup, np.float32, **cfg)
        for key in SIGN_KEYS:
            assert_as_close_as_tpugan(got[key], fp32[key], want[key], key)
        for (i, w, im), (_, w32, im32), (_, w64, im64) in zip(got_calls, fp32_calls, want_calls):
            assert_as_close_as_tpugan(w, w32, w64, f"w at {i}")
            assert_as_close_as_tpugan(im, im32, im64, f"images at {i}")
    else:
        _assert_results_close(got, want, F64_TOL)
        _assert_calls_close(got_calls, want_calls, F64_TOL)
    if model == "ebig":  # the base E's u and v are back after the run
        base = load_variables(BigGANEncoder(**EBIG_KW, img_size=BIGGAN_IMG), setup.enc_vars).double()
        state = encoder.state_dict()
        assert all(torch.equal(state[k], b) for k, b in base.state_dict().items() if k.endswith((".u", ".v")))
