"""The attention forward kernel's arithmetic (csrc/sagan_attention.cu),
emulated on the CPU and held to the forward's contract.

The kernel forms both products on the tensor cores in 3xTF32 over tiles of
kBK keys: s = q k^T as chains of kChainK columns of hi hi products, each
summed in fp32, plus the corrections (lo hi + hi lo) of the whole
contraction; an online softmax in fp32; and for each key tile one chain of
p v hi hi products and its corrections, added to the running output as
o = alpha o + (chain + corrections). p feeds p v from its accumulator
fragment, so v^T's keys of each 8 are laid out in the order 0, 2, 4, 6, 1,
3, 5, 7; the fragment test runs the kernel's own index formulas. The
emulation forms every TF32 product exactly (float64), with hi rounded to
nearest and lo as the tensor cores read it (truncated), so what it shows is
the split's precision, held to the plain version and to tpugan's XLA
attention at chip_smoke.py's ATTENTION_CASES tolerances and LSE_TOL; one
TF32 pass misses them.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_attention_bwd import _mm, _tf32
from tpugan.ops.attention import _attention_xla
from tpugan_torch.ops import attention, cuda

torch.set_num_threads(1)

SOURCE = (cuda.CSRC / cuda.KERNELS["sagan_attention"][0]).read_text()


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


KEYS = _constant("kBK")  # keys per tile
CHAIN = _constant("kChainK")  # contraction length of one chain of hi hi products
LSE_TOL = dict(rtol=1e-5, atol=1e-5)  # tests/test_attention.py:54, chip_smoke.py's LSE_TOL


def _corrections(a, b):
    """lo_a hi_b + hi_a lo_b exact, rounded to fp32 (lo truncated to TF32)."""
    hi_a, hi_b = _tf32(a, True), _tf32(b, True)
    lo_a, lo_b = _tf32(a - hi_a, False), _tf32(b - hi_b, False)
    return (torch.bmm(lo_a.double(), hi_b.double()) + torch.bmm(hi_a.double(), lo_b.double())).float()


def _forward_emulated(q, k, v, passes=3):
    """The kernel's forward on fp32 [N, L, d] inputs: (out, lse [N, Lq, 1])."""
    n, lq, _ = q.shape
    acc = torch.zeros(n, lq, v.shape[2])
    m = torch.full((n, lq, 1), -torch.inf)
    l = torch.zeros(n, lq, 1)  # noqa: E741
    for j0 in range(0, k.shape[1], KEYS):
        kt, vt = k[:, j0:j0 + KEYS], v[:, j0:j0 + KEYS]
        s = torch.zeros(n, lq, kt.shape[1])
        for c0 in range(0, q.shape[2], CHAIN):
            s = s + _mm(q[..., c0:c0 + CHAIN], kt[..., c0:c0 + CHAIN].transpose(1, 2), 1, False)
        if passes == 3:
            s = s + _corrections(q, kt.transpose(1, 2))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)  # noqa: E741
        m = m_new
        chain = _mm(p, vt, 1, False)
        if passes == 3:
            chain = chain + _corrections(p, vt)
        acc = (acc.double() * alpha.double() + chain.double()).float()  # one fma
    return acc / l, m + torch.log(l)


def _inputs(rng, q_shape, k_shape, v_shape, scale):
    q = rng.randn(*q_shape).astype(np.float32) * scale
    k = rng.randn(*k_shape).astype(np.float32) * scale
    v = rng.randn(*v_shape).astype(np.float32)
    return [torch.from_numpy(x) for x in (q, k, v)]


# chip_smoke.py's ATTENTION_CASES (q, k, v shapes, input scale, rtol, atol):
# the x3 multi-tile case, the odd widths (dk 8, 13, 20, 128; dv 24, 30, 130,
# 256), and the BigGAN-256 path's widths at a reduced query length (dk 64,
# dv 256; 1024 keys, 32 tiles)
EMULATED_CASES = [
    ((1, 512, 16), (1, 512, 16), (1, 512, 32), 3.0, 2e-4, 2e-5),
    ((1, 37, 8), (1, 19, 8), (1, 19, 24), 2.0, 2e-5, 2e-5),
    ((1, 50, 13), (1, 33, 13), (1, 33, 30), 1.0, 2e-5, 2e-5),
    ((2, 70, 20), (2, 45, 20), (2, 45, 130), 1.0, 2e-5, 2e-5),
    ((1, 130, 128), (1, 70, 128), (1, 70, 256), 0.3, 2e-5, 2e-5),
    ((1, 256, 64), (1, 1024, 64), (1, 1024, 256), 1.0, 2e-5, 2e-5),
]


@pytest.mark.parametrize("case", EMULATED_CASES, ids=lambda c: "x".join(map(str, c[0][1:] + c[2][1:])))
def test_3xtf32_forward_holds_the_contract(rng, case):
    """The kernel's arithmetic meets ATTENTION_CASES' tolerance and LSE_TOL
    against the plain version and against tpugan's XLA attention."""
    q, k, v = _inputs(rng, *case[:4])
    want, want_lse = attention.sagan_attention_plain(q, k, v, return_lse=True)
    got, got_lse = _forward_emulated(q, k, v)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=case[4], atol=case[5])
    np.testing.assert_allclose(got_lse.numpy(), want_lse.numpy(), **LSE_TOL)
    qj, kj, vj = (jnp.asarray(x.numpy()) for x in (q, k, v))
    ref = _attention_xla(qj, kj, vj)
    ref_lse = jax.scipy.special.logsumexp(jnp.einsum("nqc,nkc->nqk", qj, kj), axis=-1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=case[4], atol=case[5])
    np.testing.assert_allclose(got_lse.numpy()[..., 0], np.asarray(ref_lse), **LSE_TOL)


def test_one_tf32_pass_misses_the_forward_contract(rng):
    """The same comparison has teeth: one TF32 pass (hi hi only) misses the
    2e-5 tolerance at the path's widths by more than ten times."""
    q, k, v = _inputs(rng, *EMULATED_CASES[-1][:4])
    want, want_lse = attention.sagan_attention_plain(q, k, v, return_lse=True)
    got, got_lse = _forward_emulated(q, k, v, passes=1)
    worst = float(((got - want).abs() - 2e-5 * want.abs()).max())
    assert worst > 10 * 2e-5
    assert float((got_lse - want_lse).abs().max()) > 10 * LSE_TOL["atol"]


def _key_order(kk: int) -> int:
    """The key that v^T's column kk of a tile holds, by the kernel's split:
    column group cg = kk / 4 holds keys 8 (cg / 2) + (cg % 2) + 2 e."""
    cg, e = divmod(kk, 4)
    return 8 * (cg >> 1) + (cg & 1) + 2 * e


@pytest.mark.parametrize("width", [32, 64, 128])
def test_fragment_and_panel_layout_pair_p_with_its_keys(rng, width):
    """Runs the kernel's index formulas for one key tile: p's accumulator
    fragments (thread (w, g, t), element e at row 16 w + g + 8 ((e / 2) % 2),
    column 8 (e / 4) + 2 t + e % 2) become A fragments (register r at row
    16 w + g + 8 (r % 2), contraction index t + 4 (r / 2) of step j, from
    elements 4 j + (0, 2, 1, 3)[r]); v^T's panel of `width` rows is written
    as the split writes it (row r, column group cg at 4 width cg + 4 r) and
    read as the descriptor reads it. A @ B must be p @ v."""
    p = torch.from_numpy(rng.rand(64, KEYS).astype(np.float64))
    v = torch.from_numpy(rng.randn(KEYS, width))
    a = torch.full((64, KEYS), torch.nan, dtype=torch.float64)
    for w in range(4):
        for lane in range(32):
            g, t = divmod(lane, 4)
            frag = {}
            for e in range(KEYS // 2):
                row, col = 16 * w + g + 8 * ((e >> 1) & 1), 8 * (e >> 2) + 2 * t + (e & 1)
                frag[e] = p[row, col]
            for j in range(KEYS // 8):
                for r, e in enumerate((0, 2, 1, 3)):
                    a[16 * w + g + 8 * (r & 1), 8 * j + t + 4 * (r >> 1)] = frag[4 * j + e]
    panel = torch.full((width * KEYS,), torch.nan, dtype=torch.float64)
    for r in range(width):
        for cg in range(KEYS // 4):
            for e in range(4):
                panel[cg * 4 * width + 4 * r + e] = v[_key_order(4 * cg + e), r]
    # the no-swizzle K-major layout: element (row n, column kk) of a panel
    # of `width` rows at ((kk / 4) (width / 8) + n / 8) 32 + (n % 8) 4 + kk % 4
    b = torch.empty(KEYS, width, dtype=torch.float64)
    for n in range(width):
        for kk in range(KEYS):
            b[kk, n] = panel[((kk // 4) * (width // 8) + n // 8) * 32 + (n % 8) * 4 + kk % 4]
    assert not a.isnan().any() and not b.isnan().any()
    assert [_key_order(kk) for kk in range(8)] == [0, 2, 4, 6, 1, 3, 5, 7]
    torch.testing.assert_close(a @ b, p @ v, rtol=1e-12, atol=1e-12)


def test_kernel_source_matches_the_emulation():
    """The constants and formulas the emulation and the fragment test take
    from the kernel are the kernel's."""
    assert KEYS == CHAIN == 32
    assert "const int key0 = 8 * (cg >> 1) + (cg & 1);" in SOURCE
    assert "vals[e] = to_float(sv[(key0 + 2 * e) * CV + r]);" in SOURCE
    assert "split4(vals, vh + cg * 4 * CV + 4 * r, vl + cg * 4 * CV + 4 * r);" in SOURCE
    for r, e in enumerate((0, 2, 1, 3)):
        assert f"split(s[4 * j + {e}], a_hi[j][{r}], a_lo[j][{r}]);" in SOURCE
    assert "x = fmaf(x, alpha[(e >> 1) & 1], d[e] + c[e]);" in SOURCE
    shared = (cuda.CSRC / "tf32_wgmma.cuh").read_text()
    assert '#include "tf32_wgmma.cuh"' in SOURCE and "wgmma.mma_async" in shared
    assert "mma.sync" not in SOURCE + shared
    assert not re.search(r"atomic[A-Z]|\batom\.|\bred\.", SOURCE)  # no atomics


def test_library_name_follows_the_shared_header(tmp_path, monkeypatch):
    """Both attention sources include tf32_wgmma.cuh, so an edited header
    names (and so builds) a new library, as an edited source does."""
    for name in (cuda.KERNELS["sagan_attention"][0], "tf32_wgmma.cuh"):
        (tmp_path / name).write_text((cuda.CSRC / name).read_text())
    monkeypatch.setattr(cuda, "CSRC", tmp_path)
    before = cuda.library_path("sagan_attention")
    (tmp_path / "tf32_wgmma.cuh").write_text((tmp_path / "tf32_wgmma.cuh").read_text() + "\n")
    assert cuda.library_path("sagan_attention") != before
