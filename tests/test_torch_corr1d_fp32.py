"""corr1d's fp32 forward kernel (``csrc/corr_tile.cuh``:
``corr1d_fp32_kernel``) modelled in plain PyTorch on the CPU, index for
index, and held against ``correlation_plain`` (fp32, 1e-5 * max|ref|). The
model walks what the kernel walks: its grid of 64-column row tiles, the
32-channel stages the threads' 16-byte copies (or element loads) leave in
the ring of 4, zero outside [0, W) and past C, the ring's refill order, each
thread's 4 columns x 17 shifts over its quad of a stage, the butterfly over
the 8 lanes that split a column group's channels, the output tile in shared
memory and the stores of its run. Every output element must be written
exactly once. No JAX: the plain version is held against the JAX package in
test_torch_correlation.py."""
from __future__ import annotations

import importlib
import re

import numpy as np
import pytest
import torch
from port_threads import torch_threads  # noqa: F401

# by path: the package ``ops`` re-exports the function ``correlation`` over
# its module's name
tcorr = importlib.import_module("pmt_learning_for_semantic_segmentation_and_disparity_torch.ops.correlation")
_kernels = importlib.import_module("pmt_learning_for_semantic_segmentation_and_disparity_torch.ops._kernels")

PW, HALO = 17, 8
TX, XPT, CG, STAGES = 64, 4, 8, 4      # columns a tile and a thread, lanes a column group, ring
WIN = TX + PW - 1                      # f2 columns a tile reads (80)
CS, QUADS = 4 * CG, CG                 # channels a stage (32), 16-byte quads a staged column
THREADS = (TX // XPT) * CG             # 128
STAGE_QUADS = (TX + WIN) * QUADS       # 1,152


def _stage(f1, f2, x0, c0):
    """The stage of channels c0 .. c0+31 of row tile x0 as the threads'
    copies leave it, for every (b, y) at once: (B, H, STAGE_QUADS, 4). Quad i
    is channels c0 + 4(i % 8) .. +3 of staged column i // 8: f1's column x0 +
    col for col < 64, else f2's column x0 - 8 + col - 64, zero outside [0, W)
    and channel by channel past C (the element path's partial quad)."""
    _, _, w, c = f1.shape
    mine = torch.arange(THREADS)[:, None] + THREADS * torch.arange(STAGE_QUADS // THREADS)
    assert torch.equal(mine.flatten().sort().values, torch.arange(STAGE_QUADS))  # each quad once
    i = torch.arange(STAGE_QUADS)
    col, ch = i // QUADS, c0 + 4 * (i % QUADS)
    one = col < TX
    x = torch.where(one, x0 + col, x0 - HALO + col - TX)
    chans = ch[:, None] + torch.arange(4)
    ok = ((x >= 0) & (x < w))[:, None] & (chans < c)
    xx, cc = x.clamp(0, w - 1)[:, None], chans.clamp(max=c - 1)
    vals = torch.where(one[:, None], f1[:, :, xx, cc], f2[:, :, xx, cc])
    return torch.where(ok, vals, torch.zeros(()))


def _fwd32(f1, f2):
    """correlation1d's fp32 forward as corr1d_fp32_kernel computes it."""
    bsz, h, w, c = f1.shape
    out = torch.full((bsz, h, w, PW), float("nan"))
    writes = torch.zeros(out.shape, dtype=torch.long)
    nst = -(-c // CS)
    t = torch.arange(THREADS)
    q, xl = t % CG, (t // CG) * XPT
    lane = torch.arange(CG)
    for x0 in range(0, w, TX):  # blockIdx.x; (b, y) = (blockIdx.z, blockIdx.y) at once
        acc = torch.zeros(bsz, h, THREADS, XPT, PW)
        ring = [None] * STAGES
        for j in range(min(STAGES - 1, nst)):
            ring[j] = _stage(f1, f2, x0, j * CS)
        for j in range(nst):
            jn = j + STAGES - 1  # refilled before stage j is read: the buffer stage j - 1 held
            if jn < nst:
                assert jn % STAGES != j % STAGES
                ring[jn % STAGES] = _stage(f1, f2, x0, jn * CS)
            st = ring[j % STAGES]
            a = st[:, :, (xl[:, None] + torch.arange(XPT)) * QUADS + q[:, None]]       # (B,H,128,4,4)
            v = st[:, :, (TX + xl[:, None] + torch.arange(XPT + PW - 1)) * QUADS + q[:, None]]
            for i in range(XPT):  # column xl + i meets window column xl + i + d at shift d
                acc[:, :, :, i] += (a[:, :, :, i, None] * v[:, :, :, i:i + PW]).sum(-1)
        # the butterfly over the 8 lanes of a column group: acc += shfl_xor(acc, m)
        acc = acc.view(bsz, h, TX // XPT, CG, XPT, PW)
        for m in (4, 2, 1):
            acc = acc + acc[:, :, :, lane ^ m]
        acc = acc.reshape(bsz, h, THREADS, XPT * PW)
        # the tile in shared memory: lane q writes every 8th of its group's 68 sums
        tile = torch.full((bsz, h, TX * PW), float("nan"))
        staged = torch.zeros(TX * PW, dtype=torch.long)
        for n in range(XPT * PW):
            who = q == n % CG
            tile[:, :, xl[who] * PW + n] = acc[:, :, who, n]
            staged[xl[who] * PW + n] += 1
        assert bool((staged == 1).all()), "a tile value is not written exactly once"
        # the run's stores: thread t stores values t, t + 128, ... of the run
        n_out = min(TX, w - x0) * PW
        for k in range(-(-n_out // THREADS)):
            i = t + k * THREADS
            i = i[i < n_out]
            out[:, :, x0 + i // PW, i % PW] = tile[:, :, i]
            writes[:, :, x0 + i // PW, i % PW] += 1
    assert bool((writes == 1).all()), "an output is not written exactly once"
    return out


@pytest.mark.parametrize("shape", [
    (1, 2, 1, 8),       # W = 1; C below one stage
    (2, 3, 16, 36),     # W = 16 < 17; a second stage of 4 channels
    (1, 1, 17, 352),    # H = 1, W = 17; C = 352: 11 stages, the ring wraps
    (1, 2, 65, 136),    # W = 65: a second tile of one column; a last stage of 8 channels
    (1, 2, 120, 480),   # W = 120: tiles of 64 and 56 columns; C = 480, 15 stages
    (1, 1, 70, 1024),   # C = 1024: 32 stages
    (2, 3, 33, 37),     # C % 4 != 0: the element path's partial quad
])
def test_corr1d_fp32_forward_tiling(shape):
    g = np.random.default_rng(17)
    f1, f2 = (torch.from_numpy(g.standard_normal(shape, dtype=np.float32)) for _ in range(2))
    got = _fwd32(f1, f2)
    ref = tcorr.correlation_plain(f1, f2, (1, PW))
    err, bound = (got - ref).abs().max().item(), 1e-5 * ref.abs().max().item()
    assert err <= bound, f"max|d| {err} > {bound}"


def test_corr1d_fp32_model_matches_the_source():
    # the model's constants are the kernel's
    src = (_kernels.CSRC / "corr_tile.cuh").read_text()
    for name, value in {"kTX": TX, "kXPT": XPT, "kCG": CG, "kStages": STAGES, "kPW": PW}.items():
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert "constexpr int kCS = 4 * kCG;" in src and "constexpr int kQuads = kCS / 4;" in src
    assert "constexpr int kHalo = kPW / 2;" in src
