"""The FIR kernel's launch plan (tpugan_torch/ops/upfirdn.py::fir_plan),
executed tile by tile on the CPU.

``csrc/upfirdn2d.cu`` runs only on the card, so its index arithmetic is
held here: ``run_plan`` does what each block of the kernel does, with the
kernel's own formulas: the block's tile, its staged rows (16-byte copies
from the tile's first column rounded down where every row is 16-byte
aligned; fp32 one element a copy otherwise; bf16 each row's own 16-byte
window from the boundary below its own address, the chunk across the
row's end copied up to it and zero-filled, the chunk that starts before
the row loaded element by element, chunks in the padding zero), each
thread's strip and each output phase's taps read through
the row's lead, and the stores of 16-byte strips into rows that are not 16-byte aligned, lane by
lane and warp by warp (each lane's aligned chunk across its tail and its
right neighbour's head, a scalar head and tail where no neighbour covers
them). It raises if a copy leaves the input, a strip reads outside its
staged slice, a staged row differs from the input or zero padding, or a
tile writes an output twice or misses one. Its result is held to
``upfirdn2d_plain``'s FIR, and the plain version to tpugan's
``_upfirdn2d_xla``. The plans for 2-byte (bf16) elements, whose 16-byte
copies hold 8 elements, run the same way on bf16 input, held to the plain
bf16 FIR within one bf16 ulp (:func:`assert_within_one_bf16_ulp`).
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


def _cdiv(a, b):
    return -(-a // b)


def run_plan(x, taps, up, down, pad0, ho, wo, plan, pad_x0=None, x_lead=0, y_lead=0, stats=None):
    """x [planes, h, w] through ``plan`` block by block, as the kernel runs
    it, from front pads ``pad0`` (H) and ``pad_x0`` (W, by default H's): x
    float32, or bfloat16 for a plan of 2-byte elements, whose staged
    elements are widened to fp32 where they are read and whose outputs are
    rounded once to bf16. ``x_lead`` and ``y_lead``: how many elements past
    a 16-byte boundary x's and y's first elements lie (``plan.vec`` needs
    an aligned x and rows of whole copies). ``stats``, a dict,
    gets counts of what the run took: copies, chunks loaded element by
    element, zero chunks, rows whose last copy was zero-filled past the
    row's end, and shuffled stores of whole 16-byte chunks and of parts."""
    planes, h, w = x.shape
    kh, kw = taps.shape
    pad_y0, pad_x0 = pad0, pad0 if pad_x0 is None else pad_x0
    rh, rw, eb = plan.rh, plan.rw, plan.elem_bytes
    v = upfirdn.COPY_BYTES // eb  # elements of a 16-byte copy
    ppb, in_rows, in_stride = plan.planes_per_block, plan.in_rows, plan.in_stride
    tile_rows, tile_cols = plan.tile_rows, plan.tile_cols
    assert x.element_size() == eb and 0 <= x_lead < v and 0 <= y_lead < v
    assert rh * down % up == 0 and rw * down % up == 0  # strips start on even stuffed samples
    assert tile_rows % rh == 0 and tile_cols % rw == 0
    assert plan.phase == -pad_y0 % up == -pad_x0 % up and min(pad_y0, pad_x0) >= 0
    assert plan.blocks == _cdiv(planes, ppb) * plan.tiles_y * plan.tiles_x
    assert ppb * h * w < 2**31 and ppb * ho * wo < 2**31  # a block's planes in 32-bit offsets
    assert plan.vec in (0, 1) and (not plan.vec or (x_lead == 0 and w % v == 0))
    # elements a copy: 16 bytes (aligned rows, or bf16's per-row windows) or one fp32
    sv = 1 if eb == 4 and not plan.vec else v
    assert in_stride % sv == 0
    assert in_stride >= (plan.phase + (tile_cols - 1) * down + kw - 1) // up + sv
    assert plan.shared_bytes == ppb * in_rows * in_stride * eb <= upfirdn.MAX_SHARED_BYTES
    strip_cols = tile_cols // rw
    per_plane = strip_cols * (tile_rows // rh)
    assert ppb * per_plane <= plan.threads <= upfirdn.THREADS and plan.threads % 32 == 0
    stats = {} if stats is None else stats
    for key in ("copies", "element_chunks", "zero_chunks", "filled", "whole_stores", "part_stores"):
        stats.setdefault(key, 0)
    dtype, flat = x.dtype, x.float().reshape(-1)  # the input allocation
    y = torch.zeros(planes * ho * wo)
    written = torch.zeros(planes * ho * wo, dtype=torch.int32)
    q = torch.arange(in_stride)

    def stage(buf, plane0, n, iy0, ix0):
        """stage_rows() or stage_windows(): each staged row's copies, chunk
        by chunk, none reading outside its row; after it every staged row is
        the input's row or zero padding"""
        for p in range(n):
            for r in range(in_rows):
                row = buf[(p * in_rows + r) * in_stride:(p * in_rows + r + 1) * in_stride]
                iy = iy0 + r
                if not 0 <= iy < h:
                    row.zero_()
                    stats["zero_chunks"] += in_stride // sv
                    continue
                e0 = ((plane0 + p) * h + iy) * w + ix0  # column ix0 of the row in x
                # the first staged column: ix0 rounded down to a copy (with
                # vec every row's elements share x's alignment)
                ax = ix0 - (x_lead + e0) % sv
                chunk_col = ax + q // sv * sv  # each position's chunk's first column
                chunk_at = e0 - ix0 + chunk_col  # and its first element in x
                assert bool(((x_lead + chunk_at) % sv == 0).all())  # aligned copies
                zero = (chunk_col + sv <= 0) | (chunk_col >= w)
                col = ax + q
                at = e0 - ix0 + col  # each position's element of x
                # a chunk from the row's first column on copies the row's
                # elements (cp.async fills the rest of it with zeros); one
                # that starts before the row loads its elements one by one
                from_row = ~zero & (chunk_col >= 0)
                copied = from_row & (col < w)
                loaded = ~zero & ~from_row & (col >= 0) & (col < w)
                assert bool(((at >= e0 - ix0) & (at < e0 - ix0 + w))[copied | loaded].all()), \
                    "a copy read outside its row"
                row.zero_()
                row[copied] = flat[at[copied]]
                row[loaded] = flat[at[loaded]]
                stats["copies"] += int(from_row.sum()) // sv
                stats["element_chunks"] += int((~zero & ~from_row).sum()) // sv
                stats["zero_chunks"] += int(zero.sum()) // sv
                stats["filled"] += int((from_row & (col >= w)).any())
                ok = (col >= 0) & (col < w)
                want = torch.zeros(in_stride)
                want[ok] = flat[at[ok]]
                assert torch.equal(row, want), f"staged row {iy} of plane {plane0 + p} is not the input's row"

    buf = torch.empty(ppb * in_rows * in_stride)
    # the kernel's store path: vector stores where rows are aligned, else
    # 16-byte strips through warp shuffles, else element by element
    wide = rw > 1 and wo % rw == 0 and y_lead % rw == 0
    shuffled = rw == v and not wide
    for block in range(plan.blocks):
        b = block
        tile_x = b % plan.tiles_x
        b //= plan.tiles_x
        tile_y = b % plan.tiles_y
        plane0 = (b // plan.tiles_y) * ppb
        n = min(ppb, planes - plane0)
        oy0, ox0 = tile_y * tile_rows, tile_x * tile_cols
        assert (oy0 * down - pad_y0 - plan.phase) % up == 0 and (ox0 * down - pad_x0 - plan.phase) % up == 0
        iy0 = (oy0 * down - pad_y0 - plan.phase) // up
        ix0 = (ox0 * down - pad_x0 - plan.phase) // up
        buf.fill_(float("nan"))  # what an earlier block left there: every position is staged anew
        stage(buf, plane0, n, iy0, ix0)
        # the tile's strips, a thread each in turn
        tid = torch.arange(n * per_plane)
        p, rest = tid // per_plane, tid % per_plane
        sr, sc = rest // strip_cols, rest % strip_cols
        row0 = sr * (rh * down // up)
        col0 = sc * (rw * down // up)
        values = torch.zeros(len(tid), rh, rw)
        for da in range(rh):
            for db in range(rw):
                acc = torch.zeros(len(tid))
                for ty in range(kh):
                    sy = plan.phase + da * down + ty
                    if sy % up:
                        continue
                    r = row0 + sy // up
                    lead = (x_lead + ((plane0 + p) * h + iy0 + r) * w + ix0) % sv  # that row's lead
                    for tx in range(kw):
                        sx = plan.phase + db * down + tx
                        if sx % up:
                            continue
                        c = lead + col0 + sx // up
                        assert int(r.max()) < in_rows and int(c.max()) < in_stride
                        acc += taps[ty, tx] * buf[(p * in_rows + r) * in_stride + c]
                values[:, da, db] = acc
        if shuffled:
            shuffle_stores(values, torch.stack([p, sr, sc], 1), plane0, oy0, ox0, ho, wo, v, y_lead, strip_cols,
                           plan.threads, y, written, stats)
            continue
        for da in range(rh):
            for db in range(rw):
                oy, ox = oy0 + sr * rh + da, ox0 + sc * rw + db
                keep = (oy < ho) & (ox < wo)
                at = (((plane0 + p) * ho + oy) * wo + ox)[keep]
                y[at] = values[keep, da, db]
                written.index_add_(0, at, torch.ones_like(at, dtype=torch.int32))
    assert bool((written == 1).all()), "an output was written twice or not at all"
    return y.reshape(planes, ho, wo).to(dtype)


def shuffle_stores(values, keys, plane0, oy0, ox0, ho, wo, v, y_lead, strip_cols, threads, y, written, stats):
    """The kernel's stores of 16-byte strips into output rows that are not
    16-byte aligned, warp by warp: ``values`` [strips, 4, v] the strips'
    outputs, ``keys`` [strips] their (plane, strip row, strip column). Each
    lane stores the aligned chunk across its tail and its right neighbour's
    head (a shuffle), its head where no left neighbour covers it and its
    tail where no right neighbour does, element by element."""
    n = len(values)
    for base in range(0, n, threads):
        k = torch.arange(base, base + threads)
        active = k < n
        lane = torch.arange(threads) % 32
        key = torch.where(active, k, torch.full_like(k, -2))
        kk = k.clamp(max=n - 1)
        p, sr, sc = (keys[kk, i] for i in range(3))
        up = torch.cat([key[:1] * 0 - 9, key[:-1]])
        down = torch.cat([key[1:], key[:1] * 0 - 9])
        left = active & (lane > 0) & (sc > 0) & (up == key - 1)
        right = active & (lane < 31) & (sc + 1 < strip_cols) & (down == key + 1)
        for t in range(threads):
            if not active[t]:
                continue
            for da in range(4):
                oy = oy0 + int(sr[t]) * 4 + da
                if oy >= ho:
                    continue
                ox = ox0 + int(sc[t]) * v
                at = ((plane0 + int(p[t])) * ho + oy) * wo + ox
                m, limit = (y_lead + at) % v, wo - ox
                row = values[int(kk[t]), da]

                def put(lo, hi, whole=False):
                    if hi <= lo:  # a strip past the row's end stores nothing
                        return
                    y[at + lo:at + hi] = row[lo:hi] if hi <= v else torch.cat([row[lo:], nxt[:hi - v]])
                    written[at + lo:at + hi] += 1
                    stats["whole_stores" if whole else "part_stores"] += 1

                nxt = values[int(kk[t]) + 1, da] if right[t] else None
                if m == 0:
                    put(0, min(v, limit), limit >= v)
                    continue
                split = v - m
                if not (left[t] and limit >= split):
                    put(0, min(split, limit))
                if right[t] and limit >= v + split:
                    assert (y_lead + at + split) % v == 0  # an aligned 16-byte store
                    put(split, split + v, True)
                elif split < min(v, limit):
                    put(split, min(v, limit))


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


def _case(planes, h, w, up, down, kshape, pad, pad_x=None, x_lead=0, y_lead=0, min_blocks=None,
          gain=1.0, taps=None, rw=None):
    """``pad``: H's front and back pads, ``pad_x`` W's (by default H's).
    ``x_lead``, ``y_lead``: elements of x and y past a 16-byte boundary
    (taken modulo a copy's elements). ``min_blocks`` stands in for the
    card's (upfirdn.min_blocks), so that a few small planes share blocks and
    tiles as the path's hundreds do; ``rw`` overrides the strip width as
    chip_smoke.py's timing of the other width does."""
    return dict(planes=planes, h=h, w=w, up=up, down=down, kshape=kshape, pad=pad,
                pad_x=pad if pad_x is None else pad_x, x_lead=x_lead, y_lead=y_lead,
                min_blocks=min_blocks, gain=gain, taps=taps, rw=rw)


CASES = {
    # the path's blur at small planes, several to a block with a ragged last block
    "blur_8x8_planes_ragged": _case(8, 8, 8, 1, 1, (3, 3), (1, 1), min_blocks=3, taps=(1, 2, 1)),
    "blur_16x16_planes": _case(6, 16, 16, 1, 1, (3, 3), (1, 1), min_blocks=2, taps=(1, 2, 1)),
    # rows and plane bases off 16-byte boundaries
    "blur_9x11_unaligned": _case(5, 9, 11, 1, 1, (3, 3), (1, 1), min_blocks=2, taps=(1, 2, 1)),
    "blur_5x7_unaligned": _case(7, 5, 7, 1, 1, (3, 3), (1, 1), min_blocks=3, taps=(1, 2, 1)),
    "blur_aligned_base_off": _case(3, 8, 12, 1, 1, (3, 3), (1, 1), x_lead=1),
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
    # 16-byte strips (same-size FIRs on rows of 128 bytes or more): several
    # planes to a block with a ragged last one, a row that ends inside a
    # strip, 4 and 7x5 taps
    "rw4_planes_16x32_ragged": _case(7, 16, 32, 1, 1, (3, 3), (1, 1), min_blocks=2),
    "rw4_unaligned_9x35": _case(3, 9, 35, 1, 1, (3, 3), (1, 1)),
    "rw4_4tap_wide": _case(1, 5, 530, 1, 1, (4, 4), (2, 1)),
    "rw4_7x5_pad": _case(2, 12, 40, 1, 1, (7, 5), (5, 2)),
    # the other strip width at the path's blur: 1 column on wide rows, 16
    # bytes on narrow ones with several planes to a block
    "rw1_blur_64x64": _case(2, 64, 64, 1, 1, (3, 3), (1, 1), taps=(1, 2, 1), rw=1),
    "rw4_blur_8x8_planes": _case(9, 8, 8, 1, 1, (3, 3), (1, 1), min_blocks=2, taps=(1, 2, 1), rw=-1),
    # odd widths from each base alignment (2 to 14 bytes for bf16, 4 to 12
    # for fp32): every row starts at another of the 8 (4) alignments
    **{f"odd_w13_base{lead}": _case(3, 9, 13, 1, 1, (3, 3), (1, 1), x_lead=lead, min_blocks=2,
                                    taps=(1, 2, 1)) for lead in range(8)},
    "odd_w67_4tap_base5": _case(2, 9, 67, 1, 1, (4, 4), (1, 1), x_lead=5, gain=4.0, taps=(1, 3, 3, 1)),
    # up 2 at both phases on odd widths, from unaligned bases
    "odd_up2_phase0": _case(2, 7, 11, 2, 1, (4, 4), (2, 1), x_lead=3, gain=4.0, taps=(1, 3, 3, 1)),
    "odd_up2_phase1": _case(2, 7, 11, 2, 1, (4, 4), (1, 2), x_lead=6, gain=4.0),
    # the 4-tap FIR's adjoint (flipped taps, pads 2 and 2) into odd widths:
    # shuffled stores, from aligned and unaligned outputs
    "adjoint_4tap_into_65": _case(2, 64, 64, 1, 1, (4, 4), (2, 2), gain=4.0, taps=(1, 3, 3, 1)),
    "adjoint_4tap_into_129_y_off": _case(1, 24, 128, 1, 1, (4, 4), (2, 2), y_lead=3, x_lead=2,
                                         taps=(1, 3, 3, 1)),
    # several tiles a plane, odd widths, unaligned bases
    "tiles_4tap_base1": _case(11, 40, 70, 1, 1, (4, 4), (1, 2), min_blocks=2, x_lead=1),
    "tiles_up2_odd": _case(17, 21, 19, 2, 1, (4, 4), (2, 1), min_blocks=2, gain=4.0),
    # front pads per axis: a row shard's blur (H none, W 1 and 1) and its
    # reverse; at up 2 two pads of one phase
    "pads_0011_row_shard_blur": _case(3, 10, 70, 1, 1, (3, 3), (0, 0), pad_x=(1, 1), taps=(1, 2, 1)),
    "pads_2100": _case(2, 9, 21, 1, 1, (4, 4), (2, 1), pad_x=(0, 0), x_lead=7),
    "pads_up2_2_0": _case(2, 5, 7, 2, 1, (4, 4), (2, 1), pad_x=(0, 1), gain=4.0),
}


def _random_cases(count, seed=20261016):
    """Seeded draws over the whole contract: every (up, down), taps 1-8 on
    each side, pads 0-5, sizes 1-23, 1-7 planes, aligned bases and bases
    off 16-byte boundaries."""
    rng = np.random.RandomState(seed)
    cases = {}
    while len(cases) < count:
        up, down = rng.randint(1, 3), rng.randint(1, 3)
        kh, kw = rng.randint(1, 9), rng.randint(1, 9)
        pad = (int(rng.randint(0, 6)), int(rng.randint(0, 6)))
        h, w = rng.randint(1, 24), rng.randint(1, 24)
        if (h * up + sum(pad) - kh) // down + 1 < 1 or (w * up + sum(pad) - kw) // down + 1 < 1:
            continue
        x_lead = 0 if rng.randint(0, 2) else 1 + len(cases) % 7
        cases[f"random_{len(cases):02d}"] = _case(
            int(rng.randint(1, 8)), h, w, up, down, (kh, kw), pad, x_lead=x_lead,
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


def _sizes(case):
    kh, kw = case["kshape"]
    up, down, (p0, p1), (q0, q1) = case["up"], case["down"], case["pad"], case["pad_x"]
    return (case["h"] * up + p0 + p1 - kh) // down + 1, (case["w"] * up + q0 + q1 - kw) // down + 1


def _plan(case, elem_bytes=4):
    """The case's plan; ``rw`` -1 asks for the 16-byte strip of the element."""
    kh, kw = case["kshape"]
    ho, wo = _sizes(case)
    v = upfirdn.COPY_BYTES // elem_bytes
    rw = v if case["rw"] == -1 else case["rw"]
    plan = upfirdn.fir_plan(case["planes"], case["h"], case["w"], case["up"], case["down"], case["pad"][0],
                            kh, kw, ho, wo, min_blocks=case["min_blocks"] or H100_MIN_BLOCKS,
                            aligned=case["x_lead"] % v == 0, rw=rw, elem_bytes=elem_bytes)
    return plan, ho, wo


def _run(case, x, k, elem_bytes, stats=None):
    """The case through run_plan and through the plain FIR, on x (fp32 or bf16)."""
    v = upfirdn.COPY_BYTES // elem_bytes
    plan, ho, wo = _plan(case, elem_bytes)
    pads = (*case["pad"], *case["pad_x"])
    got = run_plan(x, torch.from_numpy(upfirdn._taps(k, case["gain"])), case["up"], case["down"], pads[0],
                   ho, wo, plan, pad_x0=pads[2], x_lead=case["x_lead"] % v, y_lead=case["y_lead"] % v,
                   stats=stats)
    want = upfirdn._fir_plain(x[None], upfirdn._taps(k, case["gain"]), case["up"], case["down"], pads)[0]
    return got, want


@pytest.mark.parametrize("name", sorted(CASES))
def test_plan_tile_by_tile_matches_plain(rng, name):
    case = CASES[name]
    x, k = _inputs(case, rng)
    assert k.shape == case["kshape"]
    got, want = _run(case, torch.from_numpy(x), k, 4)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **FIR_TOL)
    if case["pad"] == case["pad_x"]:
        ref = jfir._upfirdn2d_xla(jnp.asarray(x.transpose(1, 2, 0)[None]), k, case["up"], case["down"],
                                  case["pad"], case["gain"])
        np.testing.assert_allclose(want.numpy(), np.asarray(ref)[0].transpose(2, 0, 1), **FIR_TOL)


# bf16 rows whose width is a multiple of 4 but not of 8 (16-byte aligned
# rows in fp32, not in bf16), and 16-byte strips at the narrowest rows
BF16_CASES = CASES | {
    "bf16_w12_unaligned_rows": _case(3, 10, 12, 1, 1, (3, 3), (1, 1), taps=(1, 2, 1)),
    "bf16_w36_rw8": _case(2, 9, 36, 1, 1, (4, 4), (1, 2), min_blocks=1, rw=-1),
    "bf16_w40_up2": _case(2, 6, 20, 2, 1, (4, 4), (2, 1), gain=4.0, taps=(1, 3, 3, 1)),
    "bf16_w68_adjoint_y_off": _case(2, 12, 67, 1, 1, (4, 4), (2, 2), y_lead=5, taps=(1, 3, 3, 1), rw=-1),
}


@pytest.mark.parametrize("name", sorted(BF16_CASES))
def test_bf16_plan_tile_by_tile_matches_plain(rng, name):
    """The plan for 2-byte elements on bf16 input, block by block: within
    one bf16 ulp of the plain bf16 FIR (fp32 sums of the same taps in
    another order, each rounded once)."""
    case = BF16_CASES[name]
    x, k = _inputs(case, rng)
    got, want = _run(case, torch.from_numpy(x).bfloat16(), k, 2)
    assert got.dtype == want.dtype == torch.bfloat16
    assert_within_one_bf16_ulp(got, want)


# a bf16 SG2-1024 case-2 step's FIRs at batch 2 (planes, side in, up, down,
# taps, pads): the 4-tap FIR after each up-sampling conv, its adjoint into
# odd widths, E_Blur's blur, the ToRGB up-2 and its adjoint
SG2_STEP_FIRS = (
    (64, 1025, 1, 1, 4, (1, 1)), (128, 513, 1, 1, 4, (1, 1)), (256, 257, 1, 1, 4, (1, 1)),
    (1024, 65, 1, 1, 4, (1, 1)), (64, 1024, 1, 1, 4, (2, 2)), (256, 256, 1, 1, 4, (2, 2)),
    (32, 1024, 1, 1, 3, (1, 1)), (6, 512, 2, 1, 4, (2, 1)), (6, 1024, 1, 2, 4, (1, 1)),
)


@pytest.mark.parametrize("planes,side,up,down,taps,pad", SG2_STEP_FIRS)
def test_bf16_step_plans_by_strip_width(planes, side, up, down, taps, pad):
    """bf16 plans at a step's shapes on the card: on rows of 128 columns or
    more, or 16-byte aligned ones of 64 or more, a same-size FIR takes
    16-byte strips of 8 columns, so its tile
    holds about twice the fp32 tile's outputs (exactly twice where the
    columns split alike) and stages about its bytes; elsewhere the bf16
    tile is the fp32 one at half its bytes. Staged rows are whole 16-byte
    copies in bf16 (aligned rows or per-row windows); fp32 rows of odd
    width copy one element at a time."""
    out = (side * up + sum(pad) - taps) // down + 1
    p32, p16 = (upfirdn.fir_plan(planes, side, side, up, down, pad[0], taps, taps, out, out,
                                 min_blocks=H100_MIN_BLOCKS, elem_bytes=e) for e in (4, 2))
    assert p16.elem_bytes == 2 and p32.elem_bytes == 4
    assert p16.vec == int(side % 8 == 0) and p32.vec == int(side % 4 == 0)
    assert p16.in_stride % 8 == 0 and (p32.in_stride % 4 == 0 or not p32.vec)
    outputs = [p.planes_per_block * p.tile_rows * p.tile_cols for p in (p32, p16)]
    staged = [p.planes_per_block * p.in_rows * p.in_stride * p.elem_bytes for p in (p32, p16)]
    if (up, down) == (1, 1) and (out >= 128 or (out >= 64 and out % 8 == 0)):
        assert p16.rw == 8 and p32.rw == 4
        assert 1.5 * outputs[0] <= outputs[1] <= 2 * outputs[0], (p32, p16)
        assert outputs[1] == 2 * outputs[0] or out % 8, (p32, p16)
        assert staged[1] >= 0.8 * staged[0], (p32, p16)
    else:
        assert p16.rw == p32.rw
        assert (p16.tile_rows, p16.tile_cols, p16.planes_per_block) == (p32.tile_rows, p32.tile_cols,
                                                                         p32.planes_per_block)
        # half the bytes, but for a row's lead and its rounding to copies (two copies at most)
        assert staged[1] <= staged[0] // 2 + 32 * p16.planes_per_block * p16.in_rows, (p32, p16)
    for p in (p32, p16):
        assert p.blocks >= H100_MIN_BLOCKS and max(staged) <= upfirdn.MAX_SHARED_BYTES
    with pytest.raises(ValueError, match="2 \\(bf16\\)"):
        upfirdn.fir_plan(1, 8, 8, 1, 1, 1, 3, 3, 8, 8, min_blocks=1, elem_bytes=8)


@pytest.mark.parametrize("elem_bytes,w,aligned,vec,stride", [
    (4, 64, True, 1, 72), (4, 65, True, 0, 67), (4, 64, False, 0, 67),
    (2, 64, True, 1, 80), (2, 65, True, 0, 80), (2, 68, True, 0, 80), (2, 64, False, 0, 80),
])
def test_plan_staging_follows_the_rows(elem_bytes, w, aligned, vec, stride):
    """The staging a plan selects from the element size, the width and the
    base's alignment: 16-byte copies from a copy's boundary where every row
    is 16-byte aligned (``vec``; the staged row a copy longer than the 67
    columns a 64-column tile of the 4-tap FIR reads, rounded to copies);
    otherwise fp32 copies one element at a time into rows of just those
    columns, and bf16 stages each row's own 16-byte window (rounded to
    copies, up to a copy longer: 80 for the 74 that a lead of 7 needs)."""
    plan = upfirdn.fir_plan(2, 8, w, 1, 1, 1, 4, 4, 7, 64, min_blocks=2, aligned=aligned, rw=4,
                            elem_bytes=elem_bytes)
    assert (plan.vec, plan.in_stride, plan.tile_cols) == (vec, stride, 64)


def test_plan_covers_what_the_name_says():
    """The named cases reach the layouts they are named for."""
    def plan(name, elem_bytes=4):
        return _plan(BF16_CASES[name], elem_bytes)[0]

    def stats(name, elem_bytes):
        case, counts = BF16_CASES[name], {}
        x, k = _inputs(case, np.random.RandomState(0))
        x = torch.from_numpy(x)
        _run(case, x if elem_bytes == 4 else x.bfloat16(), k, elem_bytes, counts)
        return counts

    ragged = plan("blur_8x8_planes_ragged")
    assert ragged.planes_per_block == 3 and CASES["blur_8x8_planes_ragged"]["planes"] % 3 != 0
    assert plan("blur_64x64_bands").tiles_y > 1 and plan("tall_narrow_300x20").tiles_y > 1
    assert plan("blur_128x40_bands").tiles_y > 1 and plan("blur_128x40_bands").rw == 4
    assert plan("wide_short_3x1030").tiles_x > 1 and plan("wide_20x600_tiles").tiles_x > 1
    assert plan("up2_8x8_pad43").phase == 0 and plan("up2_8x8_pad34").phase == 1
    assert plan("tall_narrow_300x20").tiles_y * plan("tall_narrow_300x20").tile_rows != 300
    ragged4 = plan("rw4_planes_16x32_ragged")
    assert ragged4.rw == 4 and ragged4.planes_per_block > 1 and 7 % ragged4.planes_per_block != 0
    assert plan("rw4_unaligned_9x35").rw == 4 and plan("tall_narrow_300x20").rw == 1
    assert plan("rw4_7x5_pad").rw == 4
    assert plan("rw1_blur_64x64").rw == 1 and plan("rw1_blur_64x64").tiles_y > 1
    assert plan("rw4_blur_8x8_planes").rw == 4 and plan("rw4_blur_8x8_planes").planes_per_block > 1
    assert plan("bf16_w36_rw8", 2).rw == 8 and plan("bf16_w12_unaligned_rows", 2).rw == 1
    # odd widths and unaligned bases: bf16 rows in 16-byte copies, the last
    # zero-filled past the row's end, and element loads where a row's first
    # chunk starts before it; fp32 rows one element a copy
    odd = stats("odd_w13_base6", 2)
    assert odd["copies"] > 0 and odd["filled"] > 0 and odd["element_chunks"] > 0, odd
    odd32 = stats("odd_w13_base6", 4)
    assert plan("odd_w13_base6").vec == 0 and odd32["copies"] > 0, odd32
    assert odd32["filled"] == odd32["element_chunks"] == 0, odd32
    assert plan("blur_aligned_base_off").vec == 0 and plan("eblur_64x64").vec == 1
    assert plan("bf16_w12_unaligned_rows", 2).vec == 0 and plan("bf16_w12_unaligned_rows").vec == 1
    for elem_bytes in (4, 2):
        assert plan("odd_up2_phase0", elem_bytes).phase == 0 and plan("odd_up2_phase1", elem_bytes).phase == 1
        for name in ("tiles_4tap_base1", "tiles_up2_odd"):
            assert plan(name, elem_bytes).planes_per_block == 1 and (plan(name).tiles_y > 1)
    # 16-byte strips into odd widths: whole 16-byte chunks between a head
    # and a tail (bf16 takes them on rows of 128 columns or more)
    for name, elem_bytes in (("adjoint_4tap_into_65", 4), ("adjoint_4tap_into_129_y_off", 4),
                             ("adjoint_4tap_into_129_y_off", 2)):
        assert plan(name, elem_bytes).rw == 16 // elem_bytes and _plan(BF16_CASES[name])[2] % 2 == 1
        into = stats(name, elem_bytes)
        assert into["whole_stores"] > 0 and into["part_stores"] > 0, into
    assert plan("adjoint_4tap_into_65", 2).rw == 4  # 8-byte strips, stored element by element
    assert stats("bf16_w68_adjoint_y_off", 2)["whole_stores"] > 0  # 68 columns: 16-byte rows in fp32, not bf16
    assert stats("bf16_w68_adjoint_y_off", 4)["whole_stores"] > 0  # y off its boundary in both


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


@pytest.mark.parametrize("channels,side", [(512, 8), (512, 16), (512, 32), (256, 64), (128, 128),
                                           (64, 256)])
def test_bf16_path_blur_plans(channels, side):
    """The same blurs in bf16: 16-byte copies, 16-byte strips (8 columns)
    from 64 x 64 on, 8-byte strips (4 columns) at 32 x 32, a column a strip
    on narrower ones, several planes to a block up to 32 x 32, a whole
    plane a block at 64 x 64, row bands from 128 x 128 on, a strip a
    thread, and enough blocks for every SM."""
    plan = upfirdn.fir_plan(2 * channels, side, side, 1, 1, 1, 3, 3, side, side,
                            min_blocks=H100_MIN_BLOCKS, elem_bytes=2)
    assert plan.vec == 1 and plan.shared_bytes <= upfirdn.MAX_SHARED_BYTES
    assert plan.blocks >= 256
    assert plan.rw == (8 if side >= 64 else 4 if side >= 32 else 1)
    assert (plan.planes_per_block > 1) == (side <= 32)
    assert (plan.tiles_y > 1) == (side >= 128)
    strips = plan.planes_per_block * plan.tile_rows // 4 * plan.tile_cols // plan.rw
    assert strips <= plan.threads <= upfirdn.THREADS


def test_plan_constants_match_the_kernel_source():
    text = (cuda.CSRC / cuda.KERNELS["upfirdn2d"][0]).read_text()
    assert f"kMaxThreads = {upfirdn.THREADS};" in text
    assert f"kStripRows = {upfirdn.STRIP_ROWS};" in text
    assert f"kMaxSharedBytes = {upfirdn.MAX_SHARED_BYTES // 1024} * 1024;" in text
    assert f"kMaxTaps = {upfirdn.MAX_TAPS};" in text
    assert f"kCopyBytes = {upfirdn.COPY_BYTES};" in text
    assert "kCopyBytes / static_cast<int>(sizeof(T))" in text
    assert f"cp.async.cg.shared.global [%0], [%1], {upfirdn.COPY_BYTES}, %2;" in text
    assert "cp.async.ca.shared.global [%0], [%1], 4, %2;" in text  # fp32's one-element copies
    for symbol in (cuda.KERNELS["upfirdn2d"][1], cuda.KERNELS["upfirdn2d_bf16"][1]):
        assert f'extern "C" int {symbol}(' in text
    # a strip row of rw outputs is one store of rw elements where the output
    # rows allow it (16 or 8 bytes of fp32, 16, 8 or 4 of bf16), else rw scalar ones
    assert "rw > 1 && wo % rw == 0 && reinterpret_cast<uintptr_t>(y) % (sizeof(T) * rw) == 0" in text
    for elem, widths in (("float", (4, 2)), ("__nv_bfloat16", (8, 4, 2))):
        for width in widths:
            assert f"void store_wide({elem}* row, const float (&a)[{width}])" in text
    fields = re.search(r"enum PlanField \{([^}]*)\}", text).group(1)
    names = [f.strip() for f in fields.split(",") if f.strip()]
    want = ["k" + "".join(p.capitalize() for p in f.split("_")) for f in upfirdn.FirPlan.__dataclass_fields__]
    assert names == want + ["kPlanFields"]
