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
