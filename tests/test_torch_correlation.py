"""The port's correlation (plain PyTorch path) against the JAX package's
``correlation_lax`` and its Pallas kernels in interpret mode, fp32, abs 1e-5;
its plain gradients against ``jax.vjp`` of the JAX package's ``correlation``
(whose backward is ``_corr1d_bwd_lax`` / ``_corr2d_bwd_lax``) and against
autograd through ``correlation_plain``; the arithmetic of both backward
kernels' bands, written out in plain PyTorch; and the checks its CUDA
wrappers make before a kernel is built. The CUDA kernels themselves are checked on the
card by ``chip_smoke.py``."""
import importlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port import torch_threads  # noqa: F401

from pmt_learning_for_semantic_segmentation_and_disparity_torch.ops import _kernels

# the packages' ops/__init__ re-export the function ``correlation`` over the module name
tcorr = importlib.import_module(
    "pmt_learning_for_semantic_segmentation_and_disparity_torch.ops.correlation")
jcorr = importlib.import_module(
    "pmt_learning_for_semantic_segmentation_and_disparity_tpu.ops.correlation")

ATOL = 1e-5


def _pair(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape, dtype=np.float32),
            rng.standard_normal(shape, dtype=np.float32))


@pytest.mark.parametrize("shape,pw", [
    ((2, 8, 16, 12), 17),
    ((1, 5, 9, 4), 5),
    ((2, 3, 7, 6), 17),   # W < pw
    ((1, 4, 40, 35), 17),
])
def test_corr1d_plain_matches_lax(shape, pw):
    f1, f2 = _pair(0, shape)
    ref = np.asarray(jcorr.correlation_lax(jnp.asarray(f1), jnp.asarray(f2), (1, pw)))
    got = tcorr.correlation_plain(torch.from_numpy(f1), torch.from_numpy(f2), (1, pw)).numpy()
    assert got.shape == ref.shape == shape[:3] + (pw,)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("shape", [(2, 8, 16, 12), (1, 4, 10, 20)])
def test_corr1d_plain_matches_pallas_interpret(shape):
    f1, f2 = _pair(1, shape)
    ref = np.asarray(jcorr.correlation1d_pallas(jnp.asarray(f1), jnp.asarray(f2), 17,
                                                interpret=True))
    got = tcorr.correlation_plain(torch.from_numpy(f1), torch.from_numpy(f2), (1, 17)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("patch", [(5, 5), (3, 7)])
def test_corr2d_plain_normalized_matches_lax(patch):
    f1, f2 = _pair(2, (1, 6, 10, 8))
    ref = np.asarray(jcorr.correlation_lax(jnp.asarray(f1), jnp.asarray(f2), patch,
                                           normalize=True))
    got = tcorr.correlation_plain(torch.from_numpy(f1), torch.from_numpy(f2), patch,
                                  normalize=True).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("patch", [(1, 17), (17, 17)])
def test_plain_bf16_matches_lax_bf16(patch):
    # the bf16 reference the tensor-core kernels are held against on the card,
    # with the card's bf16 tolerance: 1e-2 * max|ref|
    f1, f2 = (torch.from_numpy(a).bfloat16() for a in _pair(6, (1, 4, 20, 24)))
    ref = np.asarray(jcorr.correlation_lax(jnp.asarray(f1.float().numpy(), jnp.bfloat16),
                                           jnp.asarray(f2.float().numpy(), jnp.bfloat16),
                                           patch), np.float32)
    got = tcorr.correlation_plain(f1, f2, patch)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 4, 20, patch[0] * patch[1])
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=1e-2 * np.abs(ref).max())


@pytest.mark.parametrize("patch,normalize", [((1, 17), False), ((1, 17), True), ((5, 5), True)])
def test_dispatcher_on_cpu_matches_jax_dispatcher(patch, normalize):
    f1, f2 = _pair(3, (1, 4, 12, 16))
    ref = np.asarray(jcorr.correlation(jnp.asarray(f1), jnp.asarray(f2), patch,
                                       normalize=normalize))
    got = tcorr.correlation(torch.from_numpy(f1), torch.from_numpy(f2), patch,
                            normalize=normalize).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("patch,normalize", [
    ((17, 17), True), ((17, 17), False), ((5, 5), True), ((5, 5), False)])
@pytest.mark.parametrize("shape", [
    (1, 8, 12, 4),     # H, W < 17: the halo is larger than the map
    (2, 8, 20, 6),
])
def test_corr2d_plain_matches_pallas_interpret(shape, patch, normalize):
    f1, f2 = _pair(5, shape)
    ref = np.asarray(jcorr.correlation2d_pallas(jnp.asarray(f1), jnp.asarray(f2), patch,
                                                normalize=normalize, h_tile=4, interpret=True))
    got = tcorr.correlation_plain(torch.from_numpy(f1), torch.from_numpy(f2), patch,
                                  normalize=normalize).numpy()
    assert got.shape == ref.shape == shape[:3] + (patch[0] * patch[1],)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


# the JAX package's lax VJPs take maps no smaller than the patch (at W < pw
# its pad widths go negative), so the smaller maps are held to autograd only
JAX_VJP_CASES = [((2, 4, 20, 8), (1, 17)), ((1, 3, 17, 5), (1, 17)),
                 ((1, 6, 9, 4), (5, 5)), ((1, 17, 18, 3), (17, 17))]
VJP_CASES = JAX_VJP_CASES + [((1, 3, 7, 5), (1, 17)), ((1, 5, 6, 3), (17, 17))]


@pytest.mark.parametrize("shape,patch", JAX_VJP_CASES)
def test_vjp_plain_matches_jax_vjp(shape, patch):
    """(df1, df2) against jax.vjp of the JAX package's correlation for the
    same output gradient; fp32, max|d| <= 1e-5 * max|ref|."""
    f1, f2 = _pair(7, shape)
    g = np.random.default_rng(8).standard_normal(shape[:3] + (patch[0] * patch[1],),
                                                 dtype=np.float32)
    # jitted: the 2-D VJP is 289 shifted slices, slow op by op
    refs = jax.jit(lambda a, b, c: jax.vjp(lambda x, y: jcorr.correlation(x, y, patch), a, b)[1](c))(
        f1, f2, g)
    vjp = (tcorr.correlation1d_vjp_plain(*(torch.from_numpy(a) for a in (f1, f2, g)), patch[1])
           if patch[0] == 1 else
           tcorr.correlation2d_vjp_plain(*(torch.from_numpy(a) for a in (f1, f2, g)), patch))
    for got, ref in zip(vjp, refs):
        ref = np.asarray(ref)
        assert got.shape == ref.shape == shape and got.dtype == torch.float32
        assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("shape,patch", VJP_CASES)
def test_vjp_plain_matches_autograd(shape, patch):
    """The explicit VJP against autograd through correlation_plain (the CPU
    path's backward), float64 so that only the formulas are compared, also
    at maps smaller than the patch."""
    f1, f2 = (torch.from_numpy(a).double().requires_grad_() for a in _pair(9, shape))
    out = tcorr.correlation_plain(f1, f2, patch)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(0), dtype=torch.float64)
    refs = torch.autograd.grad(out, (f1, f2), g)
    got = tcorr.correlation2d_vjp_plain(f1.detach(), f2.detach(), g, patch)
    for a, b in zip(got, refs):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6 * b.abs().max().item())


TILE, HALO, SLAB, PW = 64, 8, 16, 17


def _band_backward(f1, f2, g):
    """(df1, df2) as corr1d's bf16 backward kernel (``csrc/corr1d.cu``)
    computes them, in plain PyTorch: each row cut into 64-column tiles x0 +
    [0, 64), window column k in [0, 80) is image column x0 - 8 + k (zero
    outside [0, W)), and for each 16-column slab m, r in [16m, 16m+16) and
    k in [16m, 16m+32):

        df1[x0+r] = sum_k A1[r,k] F2w[k],  A1[r,k] = g[x0+r,   k-r]
        df2[x0+r] = sum_k A2[r,k] F1w[k],  A2[r,k] = g[x0-8+k, r-k+16]

    both zero unless 0 <= k-r <= 16."""
    b, h, w, c = f1.shape
    nt = -(-w // TILE)
    pad = (0, 0, HALO, nt * TILE + HALO - w)  # (channels, columns) of the windows
    f1p, f2p, gp = (torch.nn.functional.pad(t, pad) for t in (f1, f2, g))
    win = torch.arange(nt)[:, None] * TILE + torch.arange(TILE + 2 * HALO)  # (tile, k)
    f1w, f2w, gw = f1p[:, :, win], f2p[:, :, win], gp[:, :, win]  # (b, h, tile, k, .)
    m = torch.arange(TILE // SLAB)[:, None, None]
    r = m * SLAB + torch.arange(SLAB)[None, :, None]           # (slab, r, 1)
    k = m * SLAB + torch.arange(2 * SLAB)[None, None, :]        # (slab, 1, kk)
    dd = k - r                                                  # (slab, r, kk)
    band = (dd >= 0) & (dd < PW)
    d = dd.clamp(0, PW - 1)
    a1 = gw[:, :, :, (r + HALO).expand_as(dd), d] * band        # (b, h, tile, slab, r, kk)
    a2 = gw[:, :, :, k.expand_as(dd), PW - 1 - d] * band
    kk = k[:, 0, :]                                             # (slab, kk)
    df1 = torch.einsum("bhtmrk,bhtmkc->bhtmrc", a1, f2w[:, :, :, kk])
    df2 = torch.einsum("bhtmrk,bhtmkc->bhtmrc", a2, f1w[:, :, :, kk])
    return tuple(t.reshape(b, h, nt * TILE, c)[:, :, :w] for t in (df1, df2))


@pytest.mark.parametrize("c", [20, 37, 64, 352])
@pytest.mark.parametrize("w", [9, 16, 17, 63, 64, 65, 70, 120])
def test_corr1d_backward_band_decomposition(w, c):
    """The backward kernel's band decomposition (tiles, halo windows, slabs,
    A1/A2) against autograd through correlation_plain in float64 (1e-12 *
    max|ref|), correlation1d_vjp_plain (fp32 sums, 1e-5) and, where the map
    is no narrower than the patch, jax.vjp of the JAX package's correlation
    in fp32 (1e-5): catches the band's off-by-ones before any chip time."""
    shape = (1, 2, w, c)
    f1, f2 = _pair(10, shape)
    g = np.random.default_rng(11).standard_normal(shape[:3] + (PW,), dtype=np.float32)
    got = _band_backward(*(torch.from_numpy(a).double() for a in (f1, f2, g)))
    x1, x2 = (torch.from_numpy(a).double().requires_grad_() for a in (f1, f2))
    refs = {"autograd float64": (torch.autograd.grad(
        tcorr.correlation_plain(x1, x2, (1, PW)), (x1, x2), torch.from_numpy(g).double()), 1e-12),
        "correlation1d_vjp_plain": (tcorr.correlation1d_vjp_plain(
            *(torch.from_numpy(a) for a in (f1, f2, g)), PW), 1e-5)}
    if w >= PW:
        vjp = jax.jit(lambda a, b, e: jax.vjp(lambda x, y: jcorr.correlation(x, y, (1, PW)),
                                              a, b)[1](e))
        refs["jax.vjp"] = (vjp(f1, f2, g), 1e-5)
    for what, (ref, tol) in refs.items():
        for name, a, r in zip(("df1", "df2"), got, ref):
            r = torch.from_numpy(np.array(r)).double()
            assert a.shape == r.shape == shape
            err, bound = (a - r).abs().max().item(), tol * r.abs().max().item()
            assert err <= bound, f"{name} against {what}: max|d| {err} > {bound}"


PH = 17
# corr2d's bf16 backward (csrc/corr2d.cu): items of ROWS output rows x CG
# channels (two 64-channel boxes) x one 64-column tile; a G slice holds the
# 17 values j of the tile's 64 pixels, pixel q's value j at gpos(q, j)
ROWS, CG, BOX = 4, 128, 64
SLICE = TILE * PW
ROW8 = (8 * PW - 8) // 2  # slice words between A rows r and r + 8


def _gpos(q, j):
    return PW * q + j


def _relayout(g):
    """The relayout kernel's workspace, (tensor, b, y, i, tile, SLICE): G's
    slices (tensor 0) and the mirrored G2's (tensor 1), only those whose F
    row lies in the image (the rest stay NaN: the band never reads them),
    zero past W and outside the image."""
    b, h, w, _ = g.shape
    nt = -(-w // TILE)
    work = torch.full((2, b, h, PH, nt, SLICE), float("nan"), dtype=g.dtype)
    pos = torch.arange(SLICE)
    q, j = pos // PW, pos % PW
    for tx in range(nt):
        x = tx * TILE + q
        for y in range(h):
            for i in range(PH):
                if 0 <= y + i - HALO < h:  # G[y, x, i, j] = g[y, x, 17i + j]
                    ok = x < w
                    v = g[:, y, x.clamp(max=w - 1), (PW * i + j)]
                    work[0, :, y, i, tx] = torch.where(ok, v, torch.zeros_like(v))
                y2 = y + HALO - i  # G2[y2, x, i, j] = g[y, x + j - 8, 288 - 17i - j]
                if 0 <= y2 < h:
                    xj = x + j - HALO
                    ok = (x < w) & (xj >= 0) & (xj < w)
                    v = g[:, y, xj.clamp(0, w - 1), PH * PW - 1 - PW * i - j]
                    work[1, :, y2, i, tx] = torch.where(ok, v, torch.zeros_like(v))
    return work


def _a_map():
    """For each slab m, the slice position each A[r, k] reads (-1: zero), as
    the band's lanes build their fragments: register q of k-step ks holds
    rows gid + 8(q&1), columns 16ks + 8(q>>1) + 2tig + {0, 1}, one 32-bit
    word at abase + ROW8(q&1) + 8ks + 4(q>>1), (0,1) and (1,2) zero, (0,2) and
    (1,1) whole, the rest masked by d = 2tig - gid."""
    amap = torch.full((TILE // SLAB, SLAB, 2 * SLAB), -1, dtype=torch.long)
    for m in range(TILE // SLAB):
        for lane in range(32):
            gid, tig = lane // 4, lane % 4
            abase = _gpos(16 * m + gid, 2 * tig - gid) // 2
            d = 2 * tig - gid
            keep = {(0, 0): (d >= 0, d + 1 >= 0), (0, 3): (d >= 0, d + 1 >= 0),
                    (1, 0): (d <= 0, d <= -1), (1, 3): (d <= 0, d <= -1),
                    (0, 2): (True, True), (1, 1): (True, True)}
            for (ks, q), halves in keep.items():
                word = abase + ROW8 * (q & 1) + 8 * ks + 4 * (q >> 1)
                r, k = gid + 8 * (q & 1), 16 * ks + 8 * (q >> 1) + 2 * tig
                for e in range(2):
                    if halves[e]:
                        amap[m, r, k + e] = 2 * word + e
    return amap


def _band2d_backward(f1, f2, g):
    """(df1, df2) of the 17x17 correlation as corr2d's bf16 backward kernel
    (``csrc/corr2d.cu``) computes them, in plain PyTorch: g's relayout into
    G and G2 slices, then every work item (tensor t, b, channel group, row
    group y0 .. y0+3, tile) walks F's rows r = y0-8 .. y0+11 inside the
    image (F = f2, f1), each stage serving the item's rows y' with |r - y'|
    <= 8 at offset i = r - y' + 8 from slice (y', i); warp (slab m, box h)
    multiplies A, read from the slice through ``_a_map``, by the 32 window
    columns 16m .. 16m+31 of F's row r (80 columns from x0 - 8, zero outside
    the image and past C) for its 64 channels; stores keep x < W, c < C."""
    b, h, w, c = f1.shape
    nt = -(-w // TILE)
    work = _relayout(g)
    amap = _a_map()
    zero_at = amap < 0
    out = (torch.zeros_like(f1), torch.zeros_like(f2))
    ncg = -(-c // CG)
    pad = (0, ncg * CG - c, HALO, nt * TILE + HALO - w)  # channels, columns
    fpad = {0: torch.nn.functional.pad(f2, pad), 1: torch.nn.functional.pad(f1, pad)}
    for t in range(2):
        for bb in range(b):
            for cg in range(ncg):
                for y0 in range(0, h, ROWS):
                    nr = min(ROWS, h - y0)
                    for tx in range(nt):
                        x0 = tx * TILE
                        # warp (m, box) is live where its slab has a column < W
                        # and its box a channel < C
                        live = ((x0 + 16 * torch.arange(TILE // SLAB) < w)[:, None, None]
                                & (cg * CG + torch.arange(CG) // BOX * BOX < c)[None, None, :])
                        acc = torch.zeros(ROWS, TILE // SLAB, SLAB, CG, dtype=f1.dtype)
                        for r in range(max(0, y0 - HALO), min(h, y0 + nr + HALO)):
                            win = fpad[t][bb, r, x0:x0 + TILE + 2 * HALO, cg * CG:(cg + 1) * CG]
                            wins = torch.stack([win[16 * m:16 * m + 32] for m in range(TILE // SLAB)])
                            for a in range(nr):
                                i = r - y0 - a + HALO
                                if not 0 <= i < PH:
                                    continue
                                sl = work[t, bb, y0 + a, i, tx]
                                amat = torch.where(zero_at, torch.zeros(()), sl[amap.clamp(min=0)])
                                acc[a] += torch.where(live, torch.bmm(amat, wins), torch.zeros(()))
                        acc = acc.reshape(ROWS, TILE, CG)
                        xs, cs = min(TILE, w - x0), min(CG, c - cg * CG)
                        out[t][bb, y0:y0 + nr, x0:x0 + xs, cg * CG:cg * CG + cs] = acc[:nr, :xs, :cs]
    return out


@pytest.mark.parametrize("shape", [
    (1, 1, 9, 20),     # H = 1: one row offset
    (1, 7, 7, 20),     # H, W below the patch radius
    (1, 8, 16, 20),    # the smallest sides the JAX package's VJP takes
    (1, 9, 17, 37),
    (2, 16, 8, 20),
    (1, 17, 18, 64),
    (1, 18, 65, 20),   # two column tiles
    (1, 20, 7, 20),
    (1, 3, 70, 20),    # H = ROWS - 1; two tiles, W % 8 != 0
    (1, 5, 9, 136),    # H = ROWS + 1; a second channel group of 8 channels
    (1, 6, 12, 200),   # a second group whose second box holds 8 channels
])
def test_corr2d_backward_band_decomposition(shape):
    """The 2-D backward kernel's decomposition (g's relayout into slices,
    the items' row groups, channel groups and tiles, each stage's rows and
    offsets, the A fragments' words and masks) against autograd through
    correlation_plain in float64 (1e-12 * max|ref|), correlation2d_vjp_plain
    (fp32 sums, 1e-5) and, where both map sides are at least the patch
    radius 8, jax.vjp of the JAX package's correlation in fp32 (1e-5)."""
    f1, f2 = _pair(12, shape)
    g = np.random.default_rng(13).standard_normal(shape[:3] + (PH * PW,), dtype=np.float32)
    got = _band2d_backward(*(torch.from_numpy(a).double() for a in (f1, f2, g)))
    x1, x2 = (torch.from_numpy(a).double().requires_grad_() for a in (f1, f2))
    refs = {"autograd float64": (torch.autograd.grad(
        tcorr.correlation_plain(x1, x2, (PH, PW)), (x1, x2), torch.from_numpy(g).double()), 1e-12),
        "correlation2d_vjp_plain": (tcorr.correlation2d_vjp_plain(
            *(torch.from_numpy(a) for a in (f1, f2, g)), (PH, PW)), 1e-5)}
    if min(shape[1:3]) >= HALO:
        vjp = jax.jit(lambda a, b, e: jax.vjp(lambda x, y: jcorr.correlation(x, y, (PH, PW)),
                                              a, b)[1](e))
        refs["jax.vjp"] = (vjp(f1, f2, g), 1e-5)
    for what, (ref, tol) in refs.items():
        for name, a, r in zip(("df1", "df2"), got, ref):
            r = torch.from_numpy(np.array(r)).double()
            assert a.shape == r.shape == shape
            err, bound = (a - r).abs().max().item(), tol * r.abs().max().item()
            assert err <= bound, f"{name} against {what}: max|d| {err} > {bound}"


@pytest.fixture
def no_build(monkeypatch):
    """Any attempt to build or load a kernel fails the test."""
    def refuse(*_, **__):
        raise AssertionError("a kernel build was attempted")
    monkeypatch.setattr(_kernels, "build", refuse)
    monkeypatch.setattr(_kernels, "load", refuse)


def test_dispatcher_sends_2d_off_the_cpu_to_the_roadmap(no_build):
    # a tensor that is not on the CPU takes the kernel route: the 2-D kernel
    # wrapper must raise for a device that is not CUDA rather than fall back
    # to the plain path
    f = torch.empty((1, 4, 12, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tcorr.correlation(f, f, (17, 17), normalize=True)
    assert tcorr.correlation2d_cuda.launches == 0


@pytest.mark.parametrize("patch", [(1, 17), (17, 17)])
@pytest.mark.parametrize("case", ["meta device", "dtypes differ", "devices differ"])
def test_dispatcher_raises_before_any_build(no_build, patch, case):
    shape = (1, 4, 12, 16)
    f1 = torch.zeros(shape, device="meta" if case == "meta device" else "cpu")
    f2 = {"meta device": f1, "dtypes differ": f1.to(torch.bfloat16),
          "devices differ": torch.zeros(shape, device="meta")}[case]
    with pytest.raises(ValueError):
        tcorr.correlation(f1, f2, patch)


@pytest.mark.parametrize("wrapper,arg", [("correlation1d_cuda", 17), ("correlation2d_cuda", (17, 17))])
def test_kernel_wrapper_rejects_cpu_tensors(no_build, wrapper, arg):
    f1, f2 = _pair(4, (1, 2, 8, 4))
    fn = getattr(tcorr, wrapper)
    with pytest.raises(ValueError, match="CUDA"):
        fn(torch.from_numpy(f1), torch.from_numpy(f2), arg)
    assert fn.launches == 0


def test_backward_wrapper_rejects_cpu_tensors(no_build):
    f1, f2 = (torch.from_numpy(a) for a in _pair(4, (1, 2, 8, 4)))
    g = torch.zeros((1, 2, 8, 17))
    with pytest.raises(ValueError, match="CUDA"):
        tcorr.correlation1d_backward_cuda(f1, f2, g)
    assert tcorr.correlation1d_backward_cuda.launches == 0


def test_corr2d_backward_wrapper_rejects_cpu_tensors(no_build):
    f1, f2 = (torch.from_numpy(a) for a in _pair(4, (1, 2, 8, 4)))
    g = torch.zeros((1, 2, 8, 289))
    with pytest.raises(ValueError, match="CUDA"):
        tcorr.correlation2d_backward_cuda(f1, f2, g)
    assert tcorr.correlation2d_backward_cuda.launches == 0


def test_probe_variants_edit_todays_sources():
    # every variant of tools/probe_band.py is a text edit of csrc/: each text
    # must still be there, or the probe stops on the card
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.tools import probe_band
    for name, edits in probe_band.all_variants().items():
        probe_band.apply_edits(name, edits, lambda f: (_kernels.CSRC / f).read_text())


def test_every_kernel_has_a_source_and_a_patch():
    assert set(_kernels.SOURCES) == set(tcorr.KERNEL_PATCH) == {"corr1d", "corr2d"}
    for name, src in _kernels.SOURCES.items():
        assert (_kernels.CSRC / src).is_file()
        assert _kernels.library_path(name).parent == _kernels.BUILD


@pytest.mark.parametrize("header", sorted(p.name for p in _kernels.CSRC.glob("*.cuh")))
def test_library_name_follows_the_shared_header(tmp_path, monkeypatch, header):
    # an edit of any shared header renames (and so rebuilds) both libraries
    csrc = tmp_path / "csrc"
    shutil.copytree(_kernels.CSRC, csrc)
    monkeypatch.setattr(_kernels, "CSRC", csrc)
    before = {n: _kernels.library_path(n) for n in _kernels.SOURCES}
    path = csrc / header
    path.write_text(path.read_text() + "\n// edited\n")
    after = {n: _kernels.library_path(n) for n in _kernels.SOURCES}
    assert all(before[n] != after[n] for n in _kernels.SOURCES)
