"""Kernel K1's plain version (stratified selection over a channel-major
field) against the JAX package's Pallas kernel, run in TPU interpret mode,
and against its XLA reference. Values are selected, never blended, so
equality is exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pvnet_tpu.ops import select_kernel as SK
from pvnet_tpu_torch.ops import select_kernel as TSK

from _select_maps import KINDS, first_max_tiles, tie_map

torch.set_num_threads(1)


def _inputs(seed, b=2, h=32, w=256, c=6):
    rng = np.random.RandomState(seed)
    score = rng.rand(b, h, w).astype(np.float32)
    score += 2.0 * (rng.rand(b, h, w) < 0.3)                # fg + noise
    vertex = rng.randn(b, h, w, c).astype(np.float32)
    return score, vertex


# the (a, bb) cases of tests/test_cmajor_head.py (w % 128 == 0 for Pallas)
@pytest.mark.parametrize("a,bb", [(8, 8), (4, 16), (4, 32)])
def test_plain_matches_pallas_interpret_and_xla(a, bb):
    score, vertex = _inputs(a * bb)
    vcm = np.ascontiguousarray(vertex.transpose(0, 3, 1, 2))
    with pltpu.force_tpu_interpret_mode():
        pb, pi, pd = SK.stratified_select_cmajor(
            jnp.asarray(score), jnp.asarray(vcm), a, bb)
    xb, xi, xd = SK.stratified_select_xla(jnp.asarray(score),
                                          jnp.asarray(vertex), a, bb)
    tb, ti, td = TSK.stratified_select_cmajor_plain(
        torch.from_numpy(score), torch.from_numpy(vcm), a, bb)
    assert ti.dtype == torch.int32 and td.shape == (2, a, bb, 6)
    for want_b, want_i, want_d in ((pb, pi, pd), (xb, xi, xd)):
        np.testing.assert_array_equal(tb.numpy(), np.asarray(want_b))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(td.numpy(), np.asarray(want_d))


@pytest.mark.parametrize("a,bb,h,w", [(16, 32, 48, 96), (4, 8, 20, 24)])
def test_plain_matches_xla_other_grids(a, bb, h, w):
    score, vertex = _inputs(h + w, b=3, h=h, w=w, c=4)
    vcm = np.ascontiguousarray(vertex.transpose(0, 3, 1, 2))
    xb, xi, xd = SK.stratified_select_xla(jnp.asarray(score),
                                          jnp.asarray(vertex), a, bb)
    tb, ti, td = TSK.stratified_select_cmajor_plain(
        torch.from_numpy(score), torch.from_numpy(vcm), a, bb)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(xb))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(xi))
    np.testing.assert_array_equal(td.numpy(), np.asarray(xd))


def test_ties_pick_the_first_tile():
    # every candidate of every phase scores the same: tile 0 must win
    score = torch.full((1, 8, 16), 2.5)
    field = torch.arange(1 * 3 * 8 * 16, dtype=torch.float32).reshape(
        1, 3, 8, 16)
    best, idx, dirs = TSK.stratified_select_cmajor_plain(score, field, 4, 8)
    assert (idx == 0).all() and (best == 2.5).all()
    np.testing.assert_array_equal(dirs[0, :, :, 0].numpy(),
                                  field[0, 0, :4, :8].numpy())


def test_wrapper_takes_plain_version_on_cpu_without_counting():
    score, vertex = _inputs(7)
    vcm = torch.from_numpy(np.ascontiguousarray(vertex.transpose(0, 3, 1, 2)))
    before = TSK.stratified_select_cmajor.launches
    got = TSK.stratified_select_cmajor(torch.from_numpy(score), vcm, 8, 8)
    want = TSK.stratified_select_cmajor_plain(torch.from_numpy(score), vcm,
                                              8, 8)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert TSK.stratified_select_cmajor.launches == before


def test_wrapper_rejects_bad_inputs():
    score = torch.zeros(1, 30, 32)
    with pytest.raises(ValueError, match="multiples"):
        TSK.stratified_select_cmajor(score, torch.zeros(1, 2, 30, 32), 4, 8)
    with pytest.raises(ValueError, match="does not match"):
        TSK.stratified_select_cmajor(torch.zeros(1, 32, 32),
                                     torch.zeros(1, 2, 32, 16), 4, 8)
    with pytest.raises(ValueError, match="unsupported device"):
        TSK.stratified_select_cmajor(torch.zeros(1, 32, 32, device="meta"),
                                     torch.zeros(1, 2, 32, 32,
                                                 device="meta"), 4, 8)


# --- K2: the NHWC field (stratified_select) ----------------------------------

# the (a, bb) grids of the packed path's budgets (tn//4 = 64 -> (8, 8),
# 128 -> (8, 16)) and one Pallas cannot take (a % 8 != 0)
@pytest.mark.parametrize("a,bb", [(8, 8), (4, 16), (8, 16)])
def test_nhwc_plain_matches_pallas_interpret_and_xla(a, bb):
    score, vertex = _inputs(100 + a * bb, h=32, w=128, c=20)
    with pltpu.force_tpu_interpret_mode():
        pallas = SK.stratified_select(jnp.asarray(score), jnp.asarray(vertex),
                                      a, bb)
    xla = SK.stratified_select_xla(jnp.asarray(score), jnp.asarray(vertex),
                                   a, bb)
    tb, ti, td = TSK.stratified_select_plain(
        torch.from_numpy(score), torch.from_numpy(vertex), a, bb)
    assert ti.dtype == torch.int32 and td.shape == (2, a, bb, 20)
    for want_b, want_i, want_d in (pallas, xla):
        np.testing.assert_array_equal(tb.numpy(), np.asarray(want_b))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(td.numpy(), np.asarray(want_d))


@pytest.mark.parametrize("a,bb", [(8, 8), (4, 16), (8, 16)])
def test_nhwc_plain_bf16_field_is_bit_equal(a, bb):
    # a bf16 field is selected, never rounded: idx and dirs bit-equal
    score, vertex = _inputs(200 + a * bb, h=32, w=128, c=20)
    vb = jnp.asarray(vertex, jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        pb, pi, pd = SK.stratified_select(jnp.asarray(score), vb, a, bb)
    xb, xi, xd = SK.stratified_select_xla(jnp.asarray(score), vb, a, bb)
    tb, ti, td = TSK.stratified_select_plain(
        torch.from_numpy(score), torch.from_numpy(vertex).bfloat16(), a, bb)
    assert td.dtype == torch.bfloat16
    bits = td.view(torch.int16).numpy()
    for want_i, want_d in ((pi, pd), (xi, xd)):
        assert np.asarray(want_d).dtype == jnp.bfloat16
        np.testing.assert_array_equal(ti.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(
            bits, np.asarray(want_d).view(np.int16))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(pb))


def test_nhwc_wrapper_takes_plain_version_on_cpu_without_counting():
    score, vertex = _inputs(9, c=5)
    s, v = torch.from_numpy(score), torch.from_numpy(vertex)
    before = TSK.stratified_select.launches
    for g, w in zip(TSK.stratified_select(s, v, 8, 16),
                    TSK.stratified_select_plain(s, v, 8, 16)):
        assert torch.equal(g, w)
    assert TSK.stratified_select.launches == before


def test_nhwc_wrapper_rejects_bad_inputs():
    with pytest.raises(ValueError, match="multiples"):
        TSK.stratified_select(torch.zeros(1, 30, 32),
                              torch.zeros(1, 30, 32, 2), 4, 8)
    with pytest.raises(ValueError, match="does not match"):
        TSK.stratified_select(torch.zeros(1, 32, 32),
                              torch.zeros(1, 2, 32, 32), 4, 8)
    with pytest.raises(ValueError, match="unsupported device"):
        TSK.stratified_select(torch.zeros(1, 32, 32, device="meta"),
                              torch.zeros(1, 32, 32, 2, device="meta"), 4, 8)


# --- the tie rule: the first maximum in tile order ty*(w//bb)+tx wins -------

# w = 256: two 128-column warp spans of the CUDA kernel's vector path, and
# the Pallas channel-major kernel's w % 128 == 0 == 128 % bb
_TIE_SHAPE = dict(b=2, h=24, w=256)
_TIE_GRIDS = [(8, 8), (4, 32)]


def _tie_inputs(kind, a, bb, c=3):
    score = tie_map(kind, a=a, bb=bb, seed=len(kind) + a, **_TIE_SHAPE)
    rng = np.random.RandomState(a * bb)
    vertex = rng.randn(*score.shape, c).astype(np.float32)
    return score, vertex


def _pallas_cmajor_tiles(score, a, bb):
    """The winners of the JAX package's channel-major Pallas kernel. Its
    128-lane tiles hold g_n = 128 // bb replicas of the bb x phases; replica
    g keeps its first maximum in (ty, 128-lane tile) order, and the
    epilogue takes the first replica among the maxima. So on ties it does
    not pick the first maximum in tile order (ROADMAP fault F6)."""
    b, h, w = score.shape
    ty_n, tx_n, g_n, lanes = h // a, w // bb, 128 // bb, w // 128
    st = score.reshape(b, ty_n, a, tx_n, bb).transpose(0, 2, 4, 1, 3)
    ty, tx = np.indices((ty_n, tx_n))
    order = (tx % g_n) * ty_n * lanes + ty * lanes + tx // g_n
    ties = st == st.max(axis=(3, 4), keepdims=True)
    first = np.where(ties, order, order.size).reshape(b, a, bb, -1).argmin(-1)
    return first.astype(np.int32)


def _rows_at(vertex, tiles, a, bb):
    """[b, a, bb, C]: the NHWC field's rows at each bucket's tile."""
    b, h, w, _ = vertex.shape
    tx_n = w // bb
    bi, py, px = np.indices(tiles.shape)
    return vertex[bi, (tiles // tx_n) * a + py, (tiles % tx_n) * bb + px]


@pytest.mark.parametrize("a,bb", _TIE_GRIDS)
@pytest.mark.parametrize("kind", KINDS)
def test_cmajor_tie_rule(kind, a, bb):
    """K1's plain version picks the first maximum in tile order, as
    stratified_select_xla does, exactly; the Pallas kernel returns the same
    scores but breaks ties by replica (F6), and zero rows where no
    candidate beats -inf."""
    score, vertex = _tie_inputs(kind, a, bb)
    vcm = np.ascontiguousarray(vertex.transpose(0, 3, 1, 2))
    tb, ti, td = TSK.stratified_select_cmajor_plain(
        torch.from_numpy(score), torch.from_numpy(vcm), a, bb)
    xb, xi, xd = SK.stratified_select_xla(jnp.asarray(score),
                                          jnp.asarray(vertex), a, bb)
    np.testing.assert_array_equal(ti.numpy(), first_max_tiles(score, a, bb))
    np.testing.assert_array_equal(tb.view(torch.int32).numpy(),
                                  np.asarray(xb).view(np.int32))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(xi))
    np.testing.assert_array_equal(td.numpy(), np.asarray(xd))
    np.testing.assert_array_equal(td.numpy(), _rows_at(vertex, ti.numpy(),
                                                       a, bb))

    with pltpu.force_tpu_interpret_mode():
        pb, pi, pd = SK.stratified_select_cmajor(
            jnp.asarray(score), jnp.asarray(vcm), a, bb)
    pi = np.asarray(pi)
    np.testing.assert_array_equal(np.asarray(pb), tb.numpy())
    np.testing.assert_array_equal(pi, _pallas_cmajor_tiles(score, a, bb))
    beaten = tb.numpy() > -np.inf
    want = np.where(beaten[..., None], _rows_at(vertex, pi, a, bb), 0.0)
    np.testing.assert_array_equal(np.asarray(pd), want)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("a,bb", _TIE_GRIDS)
@pytest.mark.parametrize("kind", KINDS)
def test_nhwc_tie_rule(kind, a, bb, dtype):
    """K2's plain version equals stratified_select_xla and the Pallas
    kernel (interpret mode) exactly, bf16 rows bit for bit; the Pallas
    kernel alone leaves a zero row where no candidate beats -inf, and the
    plain version (like XLA and the CUDA kernel) returns tile 0's row."""
    score, vertex = _tie_inputs(kind, a, bb, c=5)
    vj = jnp.asarray(vertex, dtype)
    vt = torch.from_numpy(vertex)
    if dtype is not np.float32:
        vt = vt.bfloat16()
    tb, ti, td = TSK.stratified_select_plain(torch.from_numpy(score), vt,
                                             a, bb)
    bits = td.view(torch.int16 if td.dtype == torch.bfloat16
                   else torch.int32).numpy()
    with pltpu.force_tpu_interpret_mode():
        pb, pi, pd = SK.stratified_select(jnp.asarray(score), vj, a, bb)
    xb, xi, xd = SK.stratified_select_xla(jnp.asarray(score), vj, a, bb)
    np.testing.assert_array_equal(ti.numpy(), first_max_tiles(score, a, bb))
    for want_b, want_i in ((pb, pi), (xb, xi)):
        np.testing.assert_array_equal(tb.view(torch.int32).numpy(),
                                      np.asarray(want_b).view(np.int32))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(bits, np.asarray(xd).view(bits.dtype))
    beaten = (tb.numpy() > -np.inf)[..., None]
    np.testing.assert_array_equal(
        np.where(beaten, bits, 0), np.asarray(pd).view(bits.dtype))
    if not beaten.all():
        assert kind == "neg_inf"
        np.testing.assert_array_equal(np.asarray(pd)[~beaten[..., 0]], 0)
