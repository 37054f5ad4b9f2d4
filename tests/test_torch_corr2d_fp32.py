"""corr2d's fp32 kernels (``csrc/corr2d.cu``: ``corr2d_fp32_kernel`` and
``corr2d_bwd_fp32_kernel``) modelled in plain PyTorch on the CPU, index for
index, and held against ``correlation_plain`` and ``correlation2d_vjp_plain``
(fp32, 1e-5 * max|ref|). The models walk what the kernels walk: the
forward's 4-row groups, its 2 passes of 10 f2 rows (a block each), the
16-channel stages in the padded chunk layout the threads' copies write,
each half-warp's full (f2 row, row pair) unit, each lane's 2 rows x 4
columns x 17 shifts, its share of its pair's edge unit and the outputs'
staging through the ring; the backward's relayout of g into G's and the
mirrored G2's padded slices, its items of 4 rows x 128 channels x 64
columns, the persistent blocks' ring of stages across items, each F row's
rows and offsets, and each lane's 2 columns x 16 channels for the 4 rows.
Every output element must be written exactly once. No JAX: the plain
versions are held against the JAX package in test_torch_correlation.py."""
from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch
from port_threads import torch_threads  # noqa: F401

# by path: the package ``ops`` re-exports the function ``correlation`` over
# its module's name
tcorr = importlib.import_module("pmt_learning_for_semantic_segmentation_and_disparity_torch.ops.correlation")

PH = PW = 17
HALO, TX, WIN = 8, 64, 80
PATCH = PH * PW

# ---- the forward ----
R, PASSES, F2, CS = 4, 2, 10, 16  # rows a block, passes, f2 rows a pass, channels a stage
THREADS = 256                     # 16 half-warps of 16 lanes


def _chunk(col):
    return 4 * col + col // 4


F1ROW, F2ROW = _chunk(TX), _chunk(WIN)      # 272, 340 chunks of 4 floats
STAGE = R * F1ROW + F2 * F2ROW


def _unit(p, hw):
    """(pair, k) of half-warp hw's full unit in pass p (``unit_pair``,
    ``unit_row``)."""
    pair = int(hw >= (9 if p == 0 else 7))
    if p == 0:
        return pair, hw + 1 if hw < 9 else hw - 6
    return pair, hw if hw < 7 else hw - 7


def _edge(p, hw):
    """Half-warp hw's share of its pair's edge unit in pass p: (f2 row k,
    first shift j0, shifts ns) (``edge_f2``, ``edge_shift``): the pair's row p
    against f2 row k, its 17 shifts split over the pair's 9 or 7 half-warps."""
    pair = _unit(p, hw)[0]
    first = 0 if pair == 0 else (9 if p == 0 else 7)
    n = 9 if pair == (0 if p == 0 else 1) else 7
    j0, j1 = ((PW * u + n - 1) // n for u in (hw - first, hw - first + 1))
    return 2 * pair if p == 0 else 7 + 2 * pair, j0, j1 - j0


def _fwd_stage(f1, f2, b, y0, x0, rbase, s):
    """Stage s of a block's pass as the threads' copies leave it: (STAGE, 4)
    floats, NaN where nothing is copied (the pad chunks). Thread t copies
    quad t % 4 of f1's column t / 4 in its 4 rows and of f2's staged columns
    t / 4 + 64n, n < 13 (row m // 80, column m % 80 of the pass's 10 x 80)."""
    _, h, w, c = f1.shape
    t = torch.arange(THREADS)
    q, m0 = t % 4, t // 4
    a = torch.arange(R)[:, None]                                   # f1: (4, 256)
    m = m0 + 64 * torch.arange(-(-F2 * WIN // 64))[:, None]        # f2: (13, 256)
    keep2 = m < F2 * WIN
    k2, col2 = m // WIN, m % WIN
    rows = torch.cat([(y0 + a).expand(R, THREADS), rbase + k2]).reshape(-1)
    xs = torch.cat([(x0 + m0).expand(R, THREADS), x0 - HALO + col2]).reshape(-1)
    dst = torch.cat([(a * F1ROW + _chunk(m0) + q), R * F1ROW + k2 * F2ROW + _chunk(col2) + q])
    one = torch.cat([torch.ones(R, THREADS, dtype=torch.bool), torch.zeros_like(keep2)]).reshape(-1)
    live = torch.cat([torch.ones(R, THREADS, dtype=torch.bool), keep2]).reshape(-1)
    qq = torch.cat([q.expand(R, THREADS), q.expand_as(m)]).reshape(-1)
    dst = dst.reshape(-1)
    rows, xs, dst, one, qq = rows[live], xs[live], dst[live], one[live], qq[live]
    assert dst.unique().numel() == dst.numel()  # each chunk copied once
    ch = s * CS + 4 * qq[:, None] + torch.arange(4)                # (n, 4)
    ok = ((rows >= 0) & (rows < h) & (xs >= 0) & (xs < w))[:, None] & (ch < c)
    rr, xx, cc = rows.clamp(0, h - 1)[:, None], xs.clamp(0, w - 1)[:, None], ch.clamp(max=c - 1)
    vals = torch.where(one[:, None], f1[b, rr, xx, cc], f2[b, rr, xx, cc])
    buf = torch.full((STAGE, 4), float("nan"))
    buf[dst] = torch.where(ok, vals, torch.zeros(()))
    return buf


def _fwd32(f1, f2):
    """correlation2d's fp32 forward as corr2d_fp32_kernel computes it."""
    bsz, h, w, c = f1.shape
    out = torch.full((bsz, h, w, PATCH), float("nan"))
    writes = torch.zeros(out.shape, dtype=torch.long)
    nst = -(-c // CS)
    lane = torch.arange(16)[None, :]                     # (1, 16): columns 4l .. 4l+3
    for b in range(bsz):
        for y0 in range(0, h, R):
            for x0 in range(0, w, TX):
                for p in range(PASSES):
                    rbase = y0 - HALO + F2 * p
                    pair = torch.tensor([_unit(p, i)[0] for i in range(16)])[:, None]
                    k = torch.tensor([_unit(p, i)[1] for i in range(16)])[:, None]
                    r = rbase + k  # rows outside the image are staged as zeros: no test
                    ke, j0, ns = (torch.tensor(v)[:, None] for v in zip(*(_edge(p, i) for i in range(16))))
                    re = rbase + ke
                    acc = torch.zeros(16, 16, 2, 4, PW)
                    acce = torch.zeros(16, 16, 4, 3)
                    for s in range(nst):
                        buf = _fwd_stage(f1, f2, b, y0, x0, rbase, s)
                        for q in range(CS // 4):
                            a_ = torch.arange(2)[:, None]
                            x_ = torch.arange(4)[None, :]
                            i1 = ((2 * pair)[..., None, None] * F1ROW + 17 * lane[..., None, None]
                                  + a_ * F1ROW + 4 * x_ + q)             # (16, 16, 2, 4)
                            v1 = buf[i1]                                  # (16, 16, 2, 4, 4)
                            wcol = torch.arange(4 + PW - 1)
                            i2 = (R * F1ROW + k[..., None] * F2ROW + 17 * lane[..., None]
                                  + 4 * wcol + wcol // 4 + q)            # (16, 16, 20)
                            v2 = buf[i2]                                  # (16, 16, 20, 4)
                            for x in range(4):
                                for j in range(PW):
                                    acc[:, :, :, x, j] += (v1[:, :, :, x, :]
                                                           * v2[:, :, None, x + j, :]).sum(-1)
                            # the edge share: shifts j0 .. j0 + 2 of the pair's row
                            # p (those past ns never stored), the window's last
                            # column repeated past it
                            for t in range(6):
                                wc = torch.minimum(j0 + t, WIN - 1 - 4 * lane)  # (16, 16)
                                ie = R * F1ROW + ke * F2ROW + 17 * lane + q + 4 * wc + wc // 4
                                v = buf[ie]                               # (16, 16, 4)
                                for x in range(4):
                                    jj = t - x
                                    if 0 <= jj < 3:
                                        acce[:, :, x, jj] += (v1[:, :, p, x, :] * v).sum(-1)
                    # the outputs through the ring, a pair's rows at a time:
                    # row a's pixel runs of shifts ilo .. ihi of this pass
                    for pr in range(2):
                        ilo, ln, base = [], [], []
                        for a in range(2):
                            y = y0 + 2 * pr + a
                            ilo.append(max(0, rbase + HALO - y))
                            ln.append(PW * (min(PH - 1, rbase + F2 - 1 + HALO - y) - ilo[a] + 1))
                            base.append(0 if a == 0 else TX * ln[0])
                        stage = torch.full((TX * (ln[0] + ln[1]),), float("nan"))
                        staged = torch.zeros(stage.shape, dtype=torch.long)
                        for u_ in range(16):
                            if int(pair[u_]) == pr:
                                for a in range(2):
                                    i = int(r[u_]) - (y0 + 2 * pr + a) + HALO
                                    if not 0 <= i < PH:
                                        continue
                                    for l in range(16):
                                        for x in range(4):
                                            o = base[a] + (4 * l + x) * ln[a] + PW * (i - ilo[a])
                                            stage[o:o + PW] = acc[u_, l, a, x]
                                            staged[o:o + PW] += 1
                            if int(pair[u_]) == pr:
                                i = int(re[u_]) - (y0 + 2 * pr + p) + HALO
                                for l in range(16):
                                    for x in range(4):
                                        o = (base[p] + (4 * l + x) * ln[p] + PW * (i - ilo[p])
                                             + int(j0[u_]))
                                        n_ = int(ns[u_])
                                        stage[o:o + n_] = acce[u_, l, x, :n_]
                                        staged[o:o + n_] += 1
                        assert bool((staged == 1).all()), "a staged value is not written exactly once"
                        for a in range(2):
                            y = y0 + 2 * pr + a
                            if y >= h:
                                continue
                            for col in range(min(TX, w - x0)):
                                src = stage[base[a] + col * ln[a]:base[a] + (col + 1) * ln[a]]
                                sl = slice(PW * ilo[a], PW * ilo[a] + ln[a])
                                out[b, y, x0 + col, sl] = src
                                writes[b, y, x0 + col, sl] += 1
    assert bool((writes == 1).all()), "an output is not written exactly once"
    return out


@pytest.mark.parametrize("shape", [
    (1, 3, 70, 20),    # H < 4: one block, rows cut by H; two column tiles
    (2, 6, 65, 40),    # H = 6: blocks of 4 and 2 rows; W = 65; C = 40: a last stage of 4
    (1, 1, 17, 37),    # H = 1, W = 17, C = 37: a channel tail inside a chunk
    (1, 21, 20, 8),    # 6 blocks, f2 rows of both passes in the image; one stage
])
def test_corr2d_fp32_forward_tiling(shape):
    g = np.random.default_rng(20)
    f1, f2 = (torch.from_numpy(g.standard_normal(shape, dtype=np.float32)) for _ in range(2))
    got = _fwd32(f1, f2)
    ref = tcorr.correlation_plain(f1, f2, (PH, PW))
    err, bound = (got - ref).abs().max().item(), 1e-5 * ref.abs().max().item()
    assert err <= bound, f"max|d| {err} > {bound}"


# ---- the backward ----
ROWS, CG = 4, 128                 # an item's rows and channels
PIX = 20                          # an fp32 slice pads a pixel's 17 values to 20
SLICE = TX * PIX                  # a slice: 1280 values, pixel q's value j at 20q + j
WINQ = WIN * CG // 4              # window chunks of a stage
STAGES = 3


def _relayout(g):
    """The relayout's workspace, (tensor, b, y, i, tile, SLICE): G's slices
    and the mirrored G2's in the padded fp32 layout, those whose F row lies
    in the image (the rest NaN: never read), zero past W and outside the
    image."""
    b, h, w, _ = g.shape
    nt = -(-w // TX)
    work = torch.full((2, b, h, PH, nt, SLICE), float("nan"))
    pos = torch.arange(TX * PW)
    q, j = pos // PW, pos % PW
    at = PIX * q + j  # the pads stay NaN: never read as values
    for tx in range(nt):
        x = tx * TX + q
        for y in range(h):
            for i in range(PH):
                if 0 <= y + i - HALO < h:  # G[y, x, i, j] = g[y, x, 17i + j]
                    v = g[:, y, x.clamp(max=w - 1), PW * i + j]
                    work[0, :, y, i, tx, at] = torch.where(x < w, v, torch.zeros(()))
                y2 = y + HALO - i  # G2[y2, x, i, j] = g[y, x + j - 8, 288 - 17i - j]
                if 0 <= y2 < h:
                    xj = x + j - HALO
                    ok = (x < w) & (xj >= 0) & (xj < w)
                    v = g[:, y, xj.clamp(0, w - 1), PATCH - 1 - PW * i - j]
                    work[1, :, y2, i, tx, at] = torch.where(ok, v, torch.zeros(()))
    return work


def _item(k, bsz, h, c, ntx):
    """``item_at``: (t, b, y0, nr, c0, tx, x0, r_lo, r_hi) of item k."""
    ny, ncg = -(-h // ROWS), -(-c // CG)
    tx = k % ntx
    k //= ntx
    yg = k % ny
    k //= ny
    c0 = (k % ncg) * CG
    k //= ncg
    b, t = k % bsz, k // bsz
    y0, nr = yg * ROWS, min(ROWS, h - yg * ROWS)
    return t, b, y0, nr, c0, tx, tx * TX, max(0, y0 - HALO), min(h, y0 + nr + HALO)


def _bwd32(f1, f2, g, sms):
    """(df1, df2) as corr2d_backward's fp32 launches compute them, with a
    grid of min(items, sms) persistent blocks."""
    bsz, h, w, c = f1.shape
    ntx = -(-w // TX)
    work = _relayout(g)
    items = 2 * bsz * -(-c // CG) * -(-h // ROWS) * ntx
    outs = [torch.full(f1.shape, float("nan")), torch.full(f1.shape, float("nan"))]
    writes = torch.zeros((2,) + f1.shape, dtype=torch.long)
    # lane (warp m, xg, cg): columns xl + {0, 1}, channels 4cg + 32t + e
    m, xg, cg = torch.meshgrid(torch.arange(8), torch.arange(4), torch.arange(8), indexing="ij")
    xl = (8 * m + 2 * xg).reshape(-1)                    # (256,)
    cg = cg.reshape(-1)
    chans = (4 * cg[:, None, None] + 32 * torch.arange(4)[None, :, None]
             + torch.arange(4)[None, None, :]).reshape(256, 16)
    for blk in range(min(items, sms)):
        stages = [(k, r) for k in range(blk, items, min(items, sms))
                  for r in range(*_item(k, bsz, h, c, ntx)[7:9])]
        ring = [None] * STAGES

        def issue(jl):
            k, r = stages[jl]
            t, b, y0, nr, c0, tx, x0, _, _ = _item(k, bsz, h, c, ntx)
            frow = (f2 if t == 0 else f1)[b, r]
            n = torch.arange(WINQ)
            col, ch = n // (CG // 4), c0 + 4 * (n % (CG // 4))
            x = x0 - HALO + col
            ok = ((x >= 0) & (x < w))[:, None] & (ch[:, None] + torch.arange(4) < c)
            win = torch.where(ok, frow[x.clamp(0, w - 1)[:, None],
                                       (ch[:, None] + torch.arange(4)).clamp(max=c - 1)],
                              torch.zeros(()))
            slices = torch.full((ROWS, SLICE), float("nan"))
            for a in range(nr):
                i = r - y0 - a + HALO
                if 0 <= i < PH:
                    slices[a] = work[t, b, y0 + a, i, tx]
            ring[jl % STAGES] = (win, slices)           # (WINQ, 4): chunk col * 32 + quad

        acc = torch.zeros(ROWS, 256, 2, 16)
        for jl in range(min(STAGES - 1, len(stages))):
            issue(jl)
        for jc, (k, r) in enumerate(stages):
            if jc + STAGES - 1 < len(stages):
                issue(jc + STAGES - 1)
            t, b, y0, nr, c0, tx, x0, _, r_hi = _item(k, bsz, h, c, ntx)
            win, slices = ring[jc % STAGES]
            live = (x0 + xl < w)[:, None, None]
            for a in range(ROWS):
                if not (a < nr and abs(r - y0 - a) <= HALO):
                    continue
                for wc in range(2 + PW - 1):   # window column xl + wc: the lane's 4 quads
                    fw = win[(xl + wc)[:, None] * (CG // 4) + cg[:, None] + 8 * torch.arange(4)]
                    fw = fw.reshape(256, 16)
                    for x in range(2):
                        j = wc - x
                        if 0 <= j < PW:
                            # from the 16-byte chunk of shifts 4(j // 4) .. +3
                            gq = slices[a, (PIX * (xl + x) + 4 * (j // 4))[:, None] + torch.arange(4)]
                            gv = gq[:, j % 4]                            # (256,)
                            acc[a, :, x] += torch.where(live[:, :, 0], gv[:, None] * fw,
                                                        torch.zeros(()))
            if r == r_hi - 1:  # the item's stores
                for a in range(nr):
                    for x in range(2):
                        col = x0 + xl + x
                        for ln in range(256):
                            cc = c0 + chans[ln]
                            keep = cc < c
                            if int(col[ln]) < w and bool(keep.any()):
                                outs[t][b, y0 + a, int(col[ln]), cc[keep]] = acc[a, ln, x][keep]
                                writes[t, b, y0 + a, int(col[ln]), cc[keep]] += 1
                acc.zero_()
    assert bool((writes == 1).all()), "an output is not written exactly once"
    return tuple(outs)


@pytest.mark.parametrize("shape,sms", [
    ((1, 3, 17, 37), 2),     # H = 3: one item of 3 rows; C % 4 != 0; W = 17
    ((1, 5, 65, 136), 3),    # H = 5: items of 4 and 1 rows; a second group of 8 channels; W = 65
    ((1, 1, 20, 40), 1),     # H = 1; one block walks all 2 items
    ((2, 9, 12, 200), 5),    # C = 200: a second group of 72; blocks across images and tensors
])
def test_corr2d_fp32_backward_tiling(shape, sms):
    g_ = np.random.default_rng(21)
    f1, f2 = (torch.from_numpy(g_.standard_normal(shape, dtype=np.float32)) for _ in range(2))
    g = torch.from_numpy(g_.standard_normal(shape[:3] + (PATCH,), dtype=np.float32))
    got = _bwd32(f1, f2, g, sms)
    ref = tcorr.correlation2d_vjp_plain(f1, f2, g, (PH, PW))
    for name, a, r in zip(("df1", "df2"), got, ref):
        err, bound = (a - r).abs().max().item(), 1e-5 * r.abs().max().item()
        assert err <= bound, f"{name}: max|d| {err} > {bound}"
