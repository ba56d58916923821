"""PNG rows filtered with every filter type (numpy only), for the
unfilter tests on the CPU and on the card."""
import numpy as np


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def filtered_stream(rows: np.ndarray, bpp: int) -> bytes:
    """rows uint8 [h, n] filtered as a PNG encoder would, row y with
    filter type y % 5: the inflated stream an unfilter takes."""
    h, n = rows.shape
    out = bytearray()
    prev = [0] * n
    for y in range(h):
        ftype = y % 5
        cur = rows[y].astype(int).tolist()
        enc = []
        for i in range(n):
            a = cur[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            pred = (0, a, b, (a + b) >> 1, _paeth(a, b, c))[ftype]
            enc.append((cur[i] - pred) & 255)
        out.append(ftype)
        out += bytes(enc)
        prev = cur
    return bytes(out)
