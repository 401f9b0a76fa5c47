"""The FIR kernel's launch plan (tpugan_torch/ops/upfirdn.py::fir_plan),
executed tile by tile on the CPU.

``csrc/upfirdn2d.cu`` runs only on the card, so its index arithmetic is
held here: ``run_plan`` does what each block of the kernel does, with the
kernel's own formulas (the block's tile from its index, the staged input
slice with its halo, zero fill and 16-byte lead, each thread's strip and
each output phase's taps), and raises if a strip reads outside its staged
slice or a tile writes an output twice or misses one. Its result is held to
``upfirdn2d_plain``, and the plain version to tpugan's ``_upfirdn2d_xla``.
The plans for 2-byte (bf16) elements, whose 16-byte copies hold 8 elements,
run the same way on bf16 input, held to the plain bf16 FIR within one bf16
ulp (:func:`assert_within_one_bf16_ulp`).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugan.ops import upfirdn as jfir
from tpugan_torch.ops import cuda, upfirdn

torch.set_num_threads(1)

FIR_TOL = dict(rtol=1e-5, atol=1e-5)  # the Pallas kernels' own contract
H100_MIN_BLOCKS = 2 * 132  # upfirdn.min_blocks on an H100 SXM (132 SMs)


def run_plan(x, taps, up, down, pad0, ho, wo, plan):
    """x [planes, h, w] through ``plan`` block by block, as the kernel runs
    it: x float32, or bfloat16 for a plan of 2-byte elements, whose staged
    elements are widened to fp32 where they are read and whose outputs are
    rounded once to bf16."""
    planes, h, w = x.shape
    kh, kw = taps.shape
    rh, rw = plan.rh, plan.rw
    v = upfirdn.VEC_BYTES // plan.elem_bytes  # elements of a 16-byte copy
    assert x.element_size() == plan.elem_bytes
    assert rh * down % up == 0 and rw * down % up == 0  # strips start on even stuffed samples
    assert plan.tile_rows % rh == 0 and plan.tile_cols % rw == 0
    groups = -(-planes // plan.planes_per_block)
    assert plan.blocks == groups * plan.tiles_y * plan.tiles_x
    assert plan.shared_bytes == plan.planes_per_block * plan.in_rows * plan.in_stride * plan.elem_bytes
    assert plan.shared_bytes <= upfirdn.MAX_SHARED_BYTES and plan.threads <= upfirdn.THREADS
    dtype, x = x.dtype, x.float()
    y = torch.zeros(planes, ho, wo)
    written = torch.zeros(planes, ho, wo, dtype=torch.int32)
    strip_cols = plan.tile_cols // rw
    per_plane = strip_cols * (plan.tile_rows // rh)
    for block in range(plan.blocks):
        b = block
        tile_x = b % plan.tiles_x
        b //= plan.tiles_x
        tile_y = b % plan.tiles_y
        plane0 = (b // plan.tiles_y) * plan.planes_per_block
        n = min(plan.planes_per_block, planes - plane0)
        oy0, ox0 = tile_y * plan.tile_rows, tile_x * plan.tile_cols
        assert (oy0 * down - pad0 - plan.phase) % up == 0 and (ox0 * down - pad0 - plan.phase) % up == 0
        iy0 = (oy0 * down - pad0 - plan.phase) // up
        ix0 = (ox0 * down - pad0 - plan.phase) // up
        gx0 = ix0 - ix0 % v if plan.vec else ix0
        lead = ix0 - gx0
        if plan.vec:
            assert w % v == 0 and gx0 % v == 0 and plan.in_stride % v == 0  # whole 16-byte chunks
        # the staged slice: rows and columns outside the plane are the copies' zero fill
        tile = torch.zeros(n, plan.in_rows, plan.in_stride)
        rows = torch.arange(plan.in_rows) + iy0
        cols = torch.arange(plan.in_stride) + gx0
        r_ok, c_ok = (rows >= 0) & (rows < h), (cols >= 0) & (cols < w)
        tile[:, r_ok.nonzero()[:, 0, None], c_ok.nonzero()[:, 0]] = \
            x[plane0:plane0 + n, rows[r_ok][:, None], cols[c_ok]]
        # one strip per thread
        assert n * per_plane <= plan.threads
        tid = torch.arange(n * per_plane)
        p, rest = tid // per_plane, tid % per_plane
        sr, sc = rest // strip_cols, rest % strip_cols
        row0 = sr * (rh * down // up)
        col0 = lead + sc * (rw * down // up)
        for da in range(rh):
            for db in range(rw):
                acc = torch.zeros(len(tid))
                for ty in range(kh):
                    sy = plan.phase + da * down + ty
                    if sy % up:
                        continue
                    for tx in range(kw):
                        sx = plan.phase + db * down + tx
                        if sx % up:
                            continue
                        r, c = row0 + sy // up, col0 + sx // up
                        assert int(r.max()) < plan.in_rows and int(c.max()) < plan.in_stride
                        acc += taps[ty, tx] * tile[p, r, c]
                oy, ox = oy0 + sr * rh + da, ox0 + sc * rw + db
                keep = (oy < ho) & (ox < wo)
                y[plane0 + p[keep], oy[keep], ox[keep]] = acc[keep]
                written[plane0 + p[keep], oy[keep], ox[keep]] += 1
    assert bool((written == 1).all()), "an output was written twice or not at all"
    return y.to(dtype)


def assert_within_one_bf16_ulp(got, want, atol=FIR_TOL["atol"]):
    """bf16 results of fp32 sums taken in two orders: equal, or one bf16
    ulp apart where the two sums fall on either side of a rounding
    boundary (the ulp of the larger magnitude); near zero, where
    cancellation leaves a sum below the scale of its terms, within the fp32
    contract's ``atol``."""
    g, w = got.float(), want.float()
    assert g.shape == w.shape
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(torch.finfo(torch.bfloat16).tiny)
    ulp = torch.finfo(torch.bfloat16).eps * torch.exp2(torch.floor(torch.log2(mag)))
    err = (g - w).abs()
    bad = err > torch.maximum(ulp, torch.full_like(ulp, atol))
    assert not bool(bad.any()), (f"{int(bad.sum())} of {bad.numel()} outside one bf16 ulp; "
                                 f"max |err| {float(err.max()):.3e}")


def _case(planes, h, w, up, down, kshape, pad, aligned=True, min_blocks=None, gain=1.0,
          taps=None, rw=None):
    """``min_blocks`` stands in for the card's (upfirdn.min_blocks), so that
    a few small planes share blocks as the path's hundreds do; ``rw``
    overrides the strip width as chip_smoke.py's timing of the other width
    does."""
    return dict(planes=planes, h=h, w=w, up=up, down=down, kshape=kshape, pad=pad,
                aligned=aligned, min_blocks=min_blocks, gain=gain, taps=taps, rw=rw)


CASES = {
    # the path's blur at small planes, several to a block with a ragged last block
    "blur_8x8_planes_ragged": _case(8, 8, 8, 1, 1, (3, 3), (1, 1), min_blocks=3, taps=(1, 2, 1)),
    "blur_16x16_planes": _case(6, 16, 16, 1, 1, (3, 3), (1, 1), min_blocks=2, taps=(1, 2, 1)),
    # rows and plane bases off 16-byte boundaries: 4-byte copies
    "blur_9x11_unaligned": _case(5, 9, 11, 1, 1, (3, 3), (1, 1), min_blocks=2, taps=(1, 2, 1)),
    "blur_5x7_unaligned": _case(7, 5, 7, 1, 1, (3, 3), (1, 1), min_blocks=3, taps=(1, 2, 1)),
    "blur_aligned_base_off": _case(3, 8, 12, 1, 1, (3, 3), (1, 1), aligned=False),
    # a plane cut into row bands; a tall narrow one; a wide short one (2-D tiles)
    "blur_64x64_bands": _case(2, 64, 64, 1, 1, (3, 3), (1, 1), taps=(1, 2, 1)),
    "blur_128x40_bands": _case(2, 128, 40, 1, 1, (3, 3), (1, 1), taps=(1, 2, 1)),
    "tall_narrow_300x20": _case(1, 300, 20, 1, 1, (3, 3), (1, 1)),
    "wide_short_3x1030": _case(2, 3, 1030, 1, 1, (3, 3), (1, 1)),
    "wide_20x600_tiles": _case(1, 20, 600, 1, 1, (4, 4), (2, 1)),
    # 8x8 taps, the widest halo, with up 2 (both pad parities) and down 2
    "up2_8x8_pad43": _case(3, 7, 9, 2, 1, (8, 8), (4, 3)),
    "up2_8x8_pad34": _case(2, 12, 8, 2, 1, (8, 8), (3, 4), gain=4.0),
    "down2_8x8_odd": _case(3, 13, 11, 1, 2, (8, 8), (3, 3)),
    "up2_down2_8x8": _case(2, 9, 7, 2, 2, (8, 8), (3, 4)),
    "up2_down2_odd_pad": _case(2, 6, 10, 2, 2, (3, 3), (1, 2)),
    # pads past the taps: outputs whose rows read only padding
    "pad54_3taps": _case(3, 6, 8, 1, 1, (3, 3), (5, 4)),
    "pad5_up2_2taps": _case(2, 5, 6, 2, 1, (2, 2), (5, 0)),
    "pad5_down2_1tap": _case(2, 7, 9, 1, 2, (1, 1), (5, 5)),
    # kh != kw, non-separable
    "taps_2x5": _case(2, 10, 12, 1, 1, (2, 5), (1, 3)),
    "taps_7x1_up2": _case(2, 6, 5, 2, 1, (7, 1), (3, 2)),
    "taps_1x6_down2": _case(2, 9, 16, 1, 2, (1, 6), (2, 2)),
    # slice 3's FIRs at reduced sizes: the 4-tap FIR after SG2's transposed
    # conv, the ToRGB skip's up-2, E_Blur's blur, the down-2 FIR
    "sg2_fir_4tap_33": _case(4, 33, 33, 1, 1, (4, 4), (1, 1), gain=4.0, taps=(1, 3, 3, 1)),
    "sg2_torgb_up2": _case(3, 16, 16, 2, 1, (4, 4), (2, 1), gain=4.0, taps=(1, 3, 3, 1)),
    "eblur_64x64": _case(4, 64, 64, 1, 1, (3, 3), (1, 1), taps=(1, 2, 1)),
    "down2_4tap_32": _case(3, 32, 32, 1, 2, (4, 4), (1, 1), taps=(1, 3, 3, 1)),
    # strips of 4 columns (same-size FIRs on rows of 32 or more): several
    # planes to a block with a ragged last one, 4-byte copies and a row
    # that ends inside a strip, 4 and 7x5 taps
    "rw4_planes_16x32_ragged": _case(7, 16, 32, 1, 1, (3, 3), (1, 1), min_blocks=2),
    "rw4_unaligned_9x35": _case(3, 9, 35, 1, 1, (3, 3), (1, 1)),
    "rw4_4tap_wide": _case(1, 5, 530, 1, 1, (4, 4), (2, 1)),
    "rw4_7x5_pad": _case(2, 12, 40, 1, 1, (7, 5), (5, 2)),
    # the other strip width at the path's blur: 1 column on wide rows, 4 on
    # narrow ones with several planes to a block
    "rw1_blur_64x64": _case(2, 64, 64, 1, 1, (3, 3), (1, 1), taps=(1, 2, 1), rw=1),
    "rw4_blur_8x8_planes": _case(9, 8, 8, 1, 1, (3, 3), (1, 1), min_blocks=2, taps=(1, 2, 1), rw=4),
}


def _random_cases(count, seed=20261016):
    """Seeded draws over the whole contract: every (up, down), taps 1-8 on
    each side, pads 0-5, sizes 1-23, 1-7 planes, both copy widths."""
    rng = np.random.RandomState(seed)
    cases = {}
    while len(cases) < count:
        up, down = rng.randint(1, 3), rng.randint(1, 3)
        kh, kw = rng.randint(1, 9), rng.randint(1, 9)
        pad = (int(rng.randint(0, 6)), int(rng.randint(0, 6)))
        h, w = rng.randint(1, 24), rng.randint(1, 24)
        if (h * up + sum(pad) - kh) // down + 1 < 1 or (w * up + sum(pad) - kw) // down + 1 < 1:
            continue
        cases[f"random_{len(cases):02d}"] = _case(
            int(rng.randint(1, 8)), h, w, up, down, (kh, kw), pad, aligned=bool(rng.randint(0, 2)),
            min_blocks=int(rng.randint(1, 5)))
    return cases


CASES |= _random_cases(24)


def _inputs(case, rng):
    x = rng.randn(case["planes"], case["h"], case["w"]).astype(np.float32)
    if case["taps"] is not None:
        k = upfirdn.setup_fir_kernel(case["taps"])
    else:
        k = (rng.randn(*case["kshape"]) / np.sqrt(np.prod(case["kshape"]))).astype(np.float32)
    return x, k


def _plan(case, elem_bytes=4):
    kh, kw = case["kshape"]
    up, down, (p0, p1), h, w = case["up"], case["down"], case["pad"], case["h"], case["w"]
    ho, wo = (h * up + p0 + p1 - kh) // down + 1, (w * up + p0 + p1 - kw) // down + 1
    plan = upfirdn.fir_plan(case["planes"], h, w, up, down, p0, kh, kw, ho, wo,
                            min_blocks=case["min_blocks"] or H100_MIN_BLOCKS, aligned=case["aligned"],
                            rw=case["rw"], elem_bytes=elem_bytes)
    return plan, ho, wo


@pytest.mark.parametrize("name", sorted(CASES))
def test_plan_tile_by_tile_matches_plain(rng, name):
    case = CASES[name]
    x, k = _inputs(case, rng)
    up, down, (p0, p1) = case["up"], case["down"], case["pad"]
    assert k.shape == case["kshape"]
    plan, ho, wo = _plan(case)
    got = run_plan(torch.from_numpy(x), torch.from_numpy(upfirdn._taps(k, case["gain"])),
                   up, down, p0, ho, wo, plan)
    want = upfirdn.upfirdn2d_plain(torch.from_numpy(x)[None], k, up, down, (p0, p1), case["gain"])[0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), **FIR_TOL)
    ref = jfir._upfirdn2d_xla(jnp.asarray(x.transpose(1, 2, 0)[None]), k, up, down, (p0, p1),
                              case["gain"])
    np.testing.assert_allclose(want.numpy(), np.asarray(ref)[0].transpose(2, 0, 1), **FIR_TOL)


# bf16 rows whose width is a multiple of 4 but not of 8: 16-byte copies
# in fp32, one element a copy in bf16
BF16_CASES = CASES | {
    "bf16_w12_one_element_copies": _case(3, 10, 12, 1, 1, (3, 3), (1, 1), taps=(1, 2, 1)),
    "bf16_w36_rw4": _case(2, 9, 36, 1, 1, (4, 4), (1, 2), min_blocks=1),
    "bf16_w40_up2": _case(2, 6, 20, 2, 1, (4, 4), (2, 1), gain=4.0, taps=(1, 3, 3, 1)),
}


@pytest.mark.parametrize("name", sorted(BF16_CASES))
def test_bf16_plan_tile_by_tile_matches_plain(rng, name):
    """The plan for 2-byte elements on bf16 input, block by block: within
    one bf16 ulp of the plain bf16 FIR (fp32 sums of the same taps in
    another order, each rounded once)."""
    case = BF16_CASES[name]
    x, k = _inputs(case, rng)
    xb = torch.from_numpy(x).bfloat16()
    up, down, (p0, p1) = case["up"], case["down"], case["pad"]
    plan, ho, wo = _plan(case, elem_bytes=2)
    got = run_plan(xb, torch.from_numpy(upfirdn._taps(k, case["gain"])), up, down, p0, ho, wo, plan)
    want = upfirdn.upfirdn2d_plain(xb[None], k, up, down, (p0, p1), case["gain"])[0]
    assert got.dtype == want.dtype == torch.bfloat16
    assert_within_one_bf16_ulp(got, want)


def test_bf16_plans_copy_8_elements_and_halve_the_tile():
    """A bf16 plan copies 16 bytes (8 elements) where w % 8 == 0 and the
    base is aligned, rounds its staged row stride to 8 elements, and at the
    same tiles stages half the bytes of the fp32 plan; rows of w % 8 != 0
    (or an unaligned base) copy one element at a time."""
    for name in ("blur_64x64_bands", "sg2_fir_4tap_33", "bf16_w12_one_element_copies",
                 "bf16_w36_rw4", "bf16_w40_up2", "eblur_64x64", "blur_aligned_base_off"):
        case = BF16_CASES[name]
        p32, p16 = _plan(case)[0], _plan(case, elem_bytes=2)[0]
        assert p16.elem_bytes == 2 and p32.elem_bytes == 4
        assert p16.vec == int(case["aligned"] and case["w"] % 8 == 0), name
        assert p32.vec == int(case["aligned"] and case["w"] % 4 == 0), name
        if p16.vec:
            assert p16.in_stride % 8 == 0
        if (p16.tile_rows, p16.tile_cols, p16.planes_per_block) == \
                (p32.tile_rows, p32.tile_cols, p32.planes_per_block) and p16.vec == p32.vec:
            assert p16.in_stride <= p32.in_stride + 8 and p16.shared_bytes < p32.shared_bytes
    with pytest.raises(ValueError, match="2 \\(bf16\\)"):
        upfirdn.fir_plan(1, 8, 8, 1, 1, 1, 3, 3, 8, 8, min_blocks=1, elem_bytes=8)


def test_plan_covers_what_the_name_says():
    """The named cases reach the layouts they are named for."""
    def plan(name):
        return _plan(CASES[name])[0]

    ragged = plan("blur_8x8_planes_ragged")
    assert ragged.planes_per_block == 3 and CASES["blur_8x8_planes_ragged"]["planes"] % 3 != 0
    assert plan("blur_9x11_unaligned").vec == 0 and plan("blur_aligned_base_off").vec == 0
    assert plan("blur_64x64_bands").tiles_y > 1 and plan("tall_narrow_300x20").tiles_y > 1
    assert plan("blur_128x40_bands").tiles_y > 1 and plan("blur_128x40_bands").rw == 4
    assert plan("wide_short_3x1030").tiles_x > 1 and plan("wide_20x600_tiles").tiles_x > 1
    assert plan("up2_8x8_pad43").phase == 0 and plan("up2_8x8_pad34").phase == 1
    assert plan("tall_narrow_300x20").tiles_y * plan("tall_narrow_300x20").tile_rows != 300
    ragged4 = plan("rw4_planes_16x32_ragged")
    assert ragged4.rw == 4 and ragged4.planes_per_block > 1 and 7 % ragged4.planes_per_block != 0
    assert plan("rw4_unaligned_9x35").rw == 4 and plan("rw4_unaligned_9x35").vec == 0
    assert plan("tall_narrow_300x20").rw == 1 and plan("rw4_7x5_pad").rw == 4
    assert plan("rw1_blur_64x64").rw == 1 and plan("rw1_blur_64x64").tiles_y > 1
    assert plan("rw4_blur_8x8_planes").rw == 4 and plan("rw4_blur_8x8_planes").planes_per_block > 1


@pytest.mark.parametrize("channels,side", [(512, 8), (512, 16), (512, 32), (256, 64), (128, 128),
                                           (64, 256)])
def test_path_blur_plans(channels, side):
    """The SGv1 decode's six blurs at batch 2: 16-byte copies, blocks of at
    most 128 threads and 48 KB, 4-column strips from 32 x 32 on, several
    planes to a block up to 32 x 32, row bands from 64 x 64 on, and
    enough blocks for every SM."""
    plan = upfirdn.fir_plan(2 * channels, side, side, 1, 1, 1, 3, 3, side, side,
                            min_blocks=H100_MIN_BLOCKS)
    assert plan.vec == 1 and plan.threads <= upfirdn.THREADS
    assert plan.shared_bytes <= upfirdn.MAX_SHARED_BYTES
    assert plan.blocks >= 256
    assert plan.rw == (4 if side >= 32 else 1)
    assert (plan.planes_per_block > 1) == (side <= 32)
    assert (plan.tiles_y > 1) == (side >= 64)


def test_plan_constants_match_the_kernel_source():
    text = (cuda.CSRC / cuda.KERNELS["upfirdn2d"][0]).read_text()
    assert f"kMaxThreads = {upfirdn.THREADS};" in text
    assert f"kStripRows = {upfirdn.STRIP_ROWS};" in text
    assert f"kMaxSharedBytes = {upfirdn.MAX_SHARED_BYTES // 1024} * 1024;" in text
    assert f"kMaxTaps = {upfirdn.MAX_TAPS};" in text
    assert f"VEC_BYTES" not in text and "16 / static_cast<int>(sizeof(T))" in text
    assert f"cp.async.cg.shared.global [%0], [%1], {upfirdn.VEC_BYTES}, %2;" in text
    for symbol in (cuda.KERNELS["upfirdn2d"][1], cuda.KERNELS["upfirdn2d_bf16"][1]):
        assert f'extern "C" int {symbol}(' in text
    # a strip row of rw outputs is one store of rw elements where the output
    # rows allow it (16 or 8 bytes of fp32, 8 or 4 of bf16), else rw scalar ones
    assert "rw > 1 && wo % rw == 0 && reinterpret_cast<uintptr_t>(y) % (sizeof(T) * rw) == 0" in text
    for elem in ("float", "__nv_bfloat16"):
        for width in (4, 2):
            assert f"void store_wide({elem}* row, const float (&a)[{width}])" in text
    fields = re.search(r"enum PlanField \{([^}]*)\}", text).group(1)
    names = [f.strip() for f in fields.split(",") if f.strip()]
    want = ["k" + "".join(p.capitalize() for p in f.split("_")) for f in upfirdn.FirPlan.__dataclass_fields__]
    assert names == want + ["kPlanFields"]
