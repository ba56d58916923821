"""Score maps that pin the stratified selection's tie rule (kernels K1 and
K2): the first maximum in tile order ty*(w//bb)+tx wins.

numpy only, so that tests/test_torch_cuda.py can use them on a host
without JAX. Every map has integer values, so equal maxima are common:

- ``ints``: values 0, 1, 2; equal maxima fall in different columns of one
  phase, in different tile rows and in different warps' column spans;
- ``late``: as ``ints``, plus in every bucket a 5.0 first at (ty1, tx1)
  with tx1 >= 1 (not the phase's first column) and again at a later tile
  (ty2 > ty1) of an earlier column tx2 < tx1;
- ``neg_inf``: as ``ints``, with row phase 1 all -inf (buckets that no
  candidate beats), row phase 2 -inf but in its last tile row, and a tenth
  of the other pixels -inf;
- ``padded``: as ``ints``, with the -1.0 padding that
  ``voting.sample_foreground`` adds below and right of an image, and row
  phase 0 padding only (an image shorter than its phase grid).
"""
import numpy as np

KINDS = ("ints", "late", "neg_inf", "padded")


def tie_map(kind: str, b: int, h: int, w: int, a: int, bb: int,
            seed: int = 0) -> np.ndarray:
    """A float32 [b, h, w] score map of the given kind (h % a == 0 == w % bb;
    ``late`` needs h // a >= 2 and w // bb >= 2, ``neg_inf`` a >= 3)."""
    rng = np.random.RandomState(seed)
    ty_n, tx_n = h // a, w // bb
    s = rng.randint(0, 3, (b, h, w)).astype(np.float32)
    s5 = s.reshape(b, ty_n, a, tx_n, bb)                    # a view of s
    if kind == "late":
        shape = (b, a, bb)
        tx1 = rng.randint(1, tx_n, shape)
        ty1 = rng.randint(0, ty_n - 1, shape)
        ty2 = ty1 + 1 + (rng.rand(*shape) * (ty_n - 1 - ty1)).astype(int)
        tx2 = (rng.rand(*shape) * tx1).astype(int)
        bi, py, px = np.indices(shape)
        s5[bi, ty1, py, tx1, px] = 5.0
        s5[bi, ty2, py, tx2, px] = 5.0
    elif kind == "neg_inf":
        s[rng.rand(b, h, w) < 0.1] = -np.inf
        s5[:, :, 1] = -np.inf
        s5[:, :-1, 2] = -np.inf
    elif kind == "padded":
        s[:, h - 3:] = -1.0
        s[:, :, w - 5:] = -1.0
        s5[:, :, 0] = -1.0
    elif kind != "ints":
        raise ValueError(kind)
    return s


def first_max_tiles(score: np.ndarray, a: int, bb: int) -> np.ndarray:
    """int32 [b, a, bb]: each bucket's first maximum in tile order (the rule
    of jnp.argmax, torch.argmax and the CUDA kernel; scores not NaN)."""
    b, h, w = score.shape
    ty_n, tx_n = h // a, w // bb
    st = score.reshape(b, ty_n, a, tx_n, bb).transpose(0, 2, 4, 1, 3)
    return st.reshape(b, a, bb, ty_n * tx_n).argmax(-1).astype(np.int32)
