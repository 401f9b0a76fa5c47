"""tpugan_torch SAGAN attention vs tpugan (CPU).

The port's plain version is held to the Pallas forward kernel in interpret
mode on tests/test_attention.py's cases (output and logsumexp, the same
tolerances), and to tpugan's XLA form on lengths the Pallas kernel does not
take. The CUDA wrapper's argument checks run before its device check, so
they are exercised here too; the kernel itself runs only on the card
(chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugan.ops.attention import _attention_xla
from tpugan.ops.pallas.attention import sagan_attention_pallas
from tpugan_torch.ops import attention, cuda

torch.set_num_threads(1)

# tests/test_attention.py: (q, k, v shapes, input scale, rtol, atol)
PALLAS_CASES = {
    "contract": ((2, 256, 32), (2, 128, 32), (2, 128, 64), 1.0, 2e-5, 2e-5),
    "multi_tile": ((1, 512, 16), (1, 512, 16), (1, 512, 32), 3.0, 2e-4, 2e-5),
    "lse": ((2, 256, 16), (2, 256, 16), (2, 256, 32), 2.0, 2e-5, 2e-5),
}
LSE_TOL = dict(rtol=1e-5, atol=1e-5)  # tests/test_attention.py:54


def qkv(rng, q_shape, k_shape, v_shape, scale=1.0):
    q = rng.randn(*q_shape).astype(np.float32) * scale
    k = rng.randn(*k_shape).astype(np.float32) * scale
    v = rng.randn(*v_shape).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("name", sorted(PALLAS_CASES))
def test_plain_matches_pallas_forward(rng, name):
    q_shape, k_shape, v_shape, scale, rtol, atol = PALLAS_CASES[name]
    q, k, v = qkv(rng, q_shape, k_shape, v_shape, scale)
    ref, ref_lse = sagan_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=128, block_k=128,
        interpret=True, return_lse=True,
    )
    out, lse = attention.sagan_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), return_lse=True
    )
    assert out.shape == ref.shape and lse.shape == ref_lse.shape == (q_shape[0], q_shape[1], 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=rtol, atol=atol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), **LSE_TOL)
    alone = attention.sagan_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    torch.testing.assert_close(alone, out, rtol=0, atol=0)


# lengths that are not multiples of 128 (tpugan leaves them to XLA), one key,
# and BigGAN-128's head widths (dk 32, dv 128)
ODD_CASES = [
    ((1, 37, 8), (1, 19, 8), (1, 19, 24)),
    ((2, 100, 16), (2, 25, 16), (2, 25, 40)),
    ((1, 5, 4), (1, 1, 4), (1, 1, 4)),
    ((2, 64, 32), (2, 16, 32), (2, 16, 128)),
]


@pytest.mark.parametrize("shapes", ODD_CASES, ids=lambda s: "x".join(map(str, s[0][1:] + s[2][1:])))
def test_plain_matches_xla_on_odd_lengths(rng, shapes):
    q, k, v = qkv(rng, *shapes, scale=2.0)
    ref = _attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref_lse = jax.scipy.special.logsumexp(jnp.einsum("nqc,nkc->nqk", q, k), axis=-1)
    out, lse = attention.sagan_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), return_lse=True
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse.numpy()[..., 0], np.asarray(ref_lse), **LSE_TOL)


def test_cpu_tensor_takes_plain_version_without_launch(rng):
    cuda.reset_launches()
    q, k, v = (torch.from_numpy(a) for a in qkv(rng, (1, 16, 8), (1, 4, 8), (1, 4, 8)))
    attention.sagan_attention(q, k, v)
    attention.sagan_attention(q, k, v, return_lse=True)
    assert not any(cuda.launches.values())
    with pytest.raises(ValueError, match="CUDA tensors"):
        attention.sagan_attention_cuda(q, k, v)
    assert not any(cuda.launches.values())


REFUSED = {
    "fp16": (lambda q, k, v: (q.half(), k, v), TypeError, "float32"),
    "bf16_v": (lambda q, k, v: (q, k, v.bfloat16()), TypeError, "float32"),
    "non_contiguous": (lambda q, k, v: (q.transpose(0, 1), k, v), ValueError, "contiguous"),
    "two_dims": (lambda q, k, v: (q[0], k[0], v[0]), ValueError, r"\[N, L, d\]"),
    "dk_129": (lambda q, k, v: (q.new_zeros(2, 8, 129), k.new_zeros(2, 4, 129), v), ValueError, "dk 129"),
    "dv_257": (lambda q, k, v: (q, k, v.new_zeros(2, 4, 257)), ValueError, "dv 257"),
    "k_width": (lambda q, k, v: (q, k[..., :4].contiguous(), v), ValueError, "do not fit"),
    "v_length": (lambda q, k, v: (q, k, v[:, :3].contiguous()), ValueError, "do not fit"),
    "empty": (lambda q, k, v: (q[:, :0], k, v), ValueError, "empty"),
    "cpu_tensor": (lambda q, k, v: (q, k, v), ValueError, "CUDA tensors"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_kernel_wrapper_refuses_out_of_contract_input(rng, name):
    """The checks run before the device check, so they hold here too; a
    valid CPU tensor is refused last, for not being on the card."""
    q, k, v = (torch.from_numpy(a) for a in qkv(rng, (2, 8, 8), (2, 4, 8), (2, 4, 16)))
    change, error, match = REFUSED[name]
    with pytest.raises(error, match=match):
        attention.sagan_attention_cuda(*change(q, k, v))


def test_attention_kernel_is_registered_for_sm90a():
    path = cuda.library_path("sagan_attention")
    assert path.parent == cuda.BUILD_DIR and path.name.startswith("libsagan_attention-")
    source = cuda.CSRC / cuda.KERNELS["sagan_attention"][0]
    assert source.exists()
    text = source.read_text()
    assert "extern \"C\" int tpugan_sagan_attention_f32" in text
    # the record of the launched instance that chip_smoke.py reads, from the same library
    helper = cuda.HELPERS["sagan_attention_last_instance"]
    assert helper[0] == "sagan_attention.cu" and f'extern "C" void {helper[1]}(int* out)' in text
    assert cuda.library_path("sagan_attention_last_instance") == path
    assert f"kMaxDk = {attention.MAX_DK}" in text and f"kMaxDv = {attention.MAX_DV}" in text
