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


def _shift_rows(t, o):
    """out[:, y] = t[:, y + o], zero where y + o lies outside the map."""
    h = t.shape[1]
    out = torch.zeros_like(t)
    if abs(o) < h:
        out[:, max(0, -o):h - max(0, o)] = t[:, max(0, o):h - max(0, -o)]
    return out


def _band2d_backward(f1, f2, g):
    """(df1, df2) of the 17x17 correlation as corr2d's bf16 backward kernel
    (``csrc/corr2d.cu``) computes them, in plain PyTorch: for each output
    row y, the row offsets i in the kernel's range [i_lo(y), i_hi(y)), each
    one corr1d's transposed band (``_band_backward``) with g[..., 17i :
    17i+17] as its g, df1 against f2's row y + i - 8 and df2 against f1's and
    g's row y - i + 8."""
    b, h, w, c = f1.shape
    y = torch.arange(h)
    i_lo = torch.minimum(HALO - y, y + HALO + 1 - h).clamp(min=0)
    i_hi = torch.maximum(h + HALO - y, y + HALO + 1).clamp(max=PH)
    df1, df2 = torch.zeros_like(f1), torch.zeros_like(f2)
    for i in range(PH):
        on = ((i_lo <= i) & (i < i_hi))[None, :, None, None]
        gi = g[..., i * PW:(i + 1) * PW]
        f1s, f2s = _shift_rows(f1, HALO - i), _shift_rows(f2, i - HALO)
        df1 += on * _band_backward(f1s, f2s, gi)[0]
        df2 += on * _band_backward(f1s, f2s, _shift_rows(gi, HALO - i))[1]
    return df1, df2


@pytest.mark.parametrize("shape", [
    (1, 1, 9, 20),     # H = 1: one row offset
    (1, 7, 7, 20),     # H, W below the patch radius
    (1, 8, 16, 20),    # the smallest sides the JAX package's VJP takes
    (1, 9, 17, 37),
    (2, 16, 8, 20),
    (1, 17, 18, 64),
    (1, 18, 65, 20),   # two column tiles
    (1, 20, 7, 20),
])
def test_corr2d_backward_band_decomposition(shape):
    """The 2-D backward kernel's decomposition (the row-offset range of each
    output row, the row shifts of f1, f2 and g, corr1d's band per offset)
    against autograd through correlation_plain in float64 (1e-12 *
    max|ref|), correlation2d_vjp_plain (fp32 sums, 1e-5) and, where both map
    sides are at least the patch radius 8, jax.vjp of the JAX package's
    correlation in fp32 (1e-5)."""
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
