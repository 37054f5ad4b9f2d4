"""The port's own PNG reader and writer, on ``zlib`` and numpy.

The JAX package reads and writes PNGs with cv2 (``data/imageio.py``,
``data/synthetic.py``); the card's machine is not known to have cv2 or
libpng, so the port decodes PNGs itself. It covers what the data path reads:
8- and 16-bit gray, gray+alpha, RGB and RGBA, not interlaced, every one of
the five row filters. Palette images, bit depths below 8 and interlacing
raise.

Unfiltering is vectorised. Rows filtered None, Sub or Up (cv2's writer uses
Sub on every row) take one numpy operation per run of rows. Average and
Paeth depend on the pixel to the left as well as on the row above, so the
rows from the first to the last such row are reconstructed along
anti-diagonals: step t computes pixel x = t - r of every row r of the block
at once, in (pixels + rows) steps.

Arrays follow cv2's conventions: a 3-channel array is BGR (RGB on disk), a
4-channel one BGRA; ``read(path, unchanged=False)`` is ``cv2.imread(path)``
(3-channel BGR uint8) and ``unchanged=True`` is ``cv2.imread(path,
cv2.IMREAD_UNCHANGED)``.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
FILTERS = ("none", "sub", "up", "average", "paeth")


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IEND":
            return
    raise ValueError("truncated PNG: no IEND chunk")


def _paeth(a, b, c):
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_block(filt: np.ndarray, kinds: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    """Rows of any filter types, reconstructed along anti-diagonals.

    ``filt`` (K, P, bpp) filtered bytes of K rows of P pixels, ``kinds`` (K,)
    their filter types, ``prior`` (P, bpp) the row above the first. In the
    skewed array ``q[i, j] = row i's pixel j - i - 1`` (row 0 is ``prior``,
    column i the zero left of row i), pixel x of block row r = i - 1 is
    ``q[i, t + 2]`` at step t = r + x, and its left, upper and upper-left
    neighbours are ``q[i, t + 1]``, ``q[i - 1, t + 1]`` and ``q[i - 1, t]``."""
    k, p, _ = filt.shape
    q = np.zeros((k + 1, p + k + 1, bpp), np.int16)
    rows = np.arange(k + 1)[:, None]
    cols = rows + 1 + np.arange(p)[None, :]
    q[0, 1:p + 1] = prior
    fs = np.zeros_like(q)
    fs[rows[1:], cols[1:]] = filt
    kinds = kinds.astype(np.int16)
    for t in range(p + k - 1):
        lo, hi = max(1, t - p + 2), min(k, t + 1)
        a, b, c = q[lo:hi + 1, t + 1], q[lo - 1:hi, t + 1], q[lo - 1:hi, t]
        kind = kinds[lo - 1:hi, None]
        pred = np.where(kind == 4, _paeth(a, b, c),
                        np.where(kind == 3, (a + b) >> 1,
                                 np.where(kind == 2, b, np.where(kind == 1, a, 0))))
        q[lo:hi + 1, t + 2] = (fs[lo:hi + 1, t + 2] + pred) & 255
    return q[rows[1:], cols[1:]].astype(np.uint8)


def unfilter(raw: np.ndarray, bpp: int) -> np.ndarray:
    """(H, 1 + stride) filtered scanlines -> (H, stride) bytes."""
    kinds, filt = raw[:, 0], raw[:, 1:]
    h, stride = filt.shape
    if np.any(kinds > 4):
        raise ValueError(f"PNG filter type {int(kinds.max())} is not defined")
    out = np.empty((h, stride), np.uint8)
    px = filt.reshape(h, stride // bpp, bpp)
    zero = np.zeros(stride, np.uint8)
    slow = np.flatnonzero(kinds >= 3)
    end = slow[-1] + 1 if len(slow) else h
    y = 0
    while y < h:
        if len(slow) and y == slow[0]:
            prior = out[y - 1] if y else zero
            out[y:end] = _unfilter_block(px[y:end], kinds[y:end], prior.reshape(-1, bpp),
                                         bpp).reshape(end - y, stride)
            y, slow = end, ()
            continue
        kind = kinds[y]
        run = y + 1
        while run < h and kinds[run] == kind and not (len(slow) and run == slow[0]):
            run += 1
        if kind == 0:
            out[y:run] = filt[y:run]
        elif kind == 1:  # Sub: a running sum along each row, per byte of a pixel
            out[y:run] = np.cumsum(px[y:run], axis=1, dtype=np.uint8).reshape(run - y, stride)
        else:  # Up: a running sum down the rows, from the row above
            prior = out[y - 1] if y else zero
            out[y:run] = np.cumsum(filt[y:run], axis=0, dtype=np.uint8) + prior
        y = run
    return out


def decode(data: bytes) -> np.ndarray:
    """The image in a PNG file's bytes, as stored: (H, W) or (H, W, C),
    uint8 or uint16, channels in file order (gray, RGB, ...)."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, _, interlace = header
    if color not in _CHANNELS or depth not in (8, 16) or interlace:
        raise ValueError(f"unsupported PNG (colour type {color}, bit depth {depth}, interlace "
                         f"{interlace}): the port reads 8/16-bit gray, gray+alpha, RGB, RGBA")
    ch, nbytes = _CHANNELS[color], depth // 8
    bpp = ch * nbytes
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * bpp):
        raise ValueError(f"PNG data holds {raw.size} bytes, expected {h * (1 + w * bpp)}")
    img = unfilter(raw.reshape(h, 1 + w * bpp), bpp)
    if nbytes == 2:
        img = img.view(">u2").astype(np.uint16)
    img = img.reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img


def read(path: str, unchanged: bool = False) -> np.ndarray:
    """cv2.imread(path) (``unchanged=False``: 3-channel BGR uint8; 16-bit
    samples keep their high byte) or cv2.imread(path, IMREAD_UNCHANGED)."""
    with open(path, "rb") as f:
        img = decode(f.read())
    if img.ndim == 3:  # RGB(A) -> BGR(A)
        img = img[..., [2, 1, 0, 3][:img.shape[2]]] if img.shape[2] >= 3 else img
    if unchanged:
        return np.ascontiguousarray(img)
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=2)
    elif img.shape[2] == 2:  # gray + alpha
        img = np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def _filter(img: np.ndarray, kind: int, bpp: int) -> np.ndarray:
    """(H, stride) bytes -> (H, stride) bytes filtered by ``kind`` on every row."""
    x = img.astype(np.int16)
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    upleft = np.zeros_like(x)
    upleft[1:, bpp:] = x[:-1, :-bpp]
    pred = (np.zeros_like(x), left, up, (left + up) >> 1, _paeth(left, up, upleft))[kind]
    return ((x - pred) & 255).astype(np.uint8)


def write(path: str, img: np.ndarray, filter: str = "sub") -> None:
    """cv2.imwrite for a PNG: ``img`` (H, W), (H, W, 1) gray, (H, W, 3) BGR or
    (H, W, 4) BGRA, uint8 or uint16. Every row is filtered by ``filter``
    and compressed at zlib level 1, as cv2's writer does (with "sub")."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG samples must be uint8 or uint16, not {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    ch = 1 if img.ndim == 2 else img.shape[2]
    color = {1: 0, 3: 2, 4: 6}.get(ch)
    if color is None:
        raise ValueError(f"cannot write {ch} channels as PNG")
    if ch >= 3:  # BGR(A) -> RGB(A)
        img = img[..., [2, 1, 0, 3][:ch]]
    h, w = img.shape[:2]
    nbytes = img.dtype.itemsize
    raw = np.ascontiguousarray(img.astype(">u2") if nbytes == 2 else img).view(np.uint8)
    raw = raw.reshape(h, w * ch * nbytes)
    kind = FILTERS.index(filter)
    lines = np.concatenate([np.full((h, 1), kind, np.uint8), _filter(raw, kind, ch * nbytes)], 1)

    def chunk(tag: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8 * nbytes, color, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(SIGNATURE + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(lines.tobytes(), 1)) + chunk(b"IEND", b""))
