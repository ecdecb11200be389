"""Port parity, iSAX math: repro_torch.core.isax against repro.core.isax.

Inputs are made with numpy from a seed and handed to both packages as the
same arrays. Breakpoints, PAA and symbols from one z-normed input (sums of
at most 32 values, taken left to right by both), keys and bounds are
compared bit for bit everywhere. Z-norms and distances sum 64 or more
values: the port sums them in XLA CPU's order (``isax.sum_last``) and takes
the z-norm's square root correctly rounded, which makes them bit-identical
on hosts whose XLA sums that way (``reference_sums_like_port``) and equal to
rounding elsewhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import datagen
from repro.core import isax as jx
from repro_torch.core import datagen as tdatagen
from repro_torch.core import isax as tx
from test_torch_search import assert_float_parity, reference_sums_like_port

CARDS = [2, 4, 8, 16, 32, 64, 128, 256]


def _t(a):
    return torch.from_numpy(np.array(a))


def _walks(rows, n, seed):
    return datagen.random_walk(rows, n, seed=seed)


@pytest.mark.parametrize("card", CARDS)
def test_breakpoint_tables_bitwise(card):
    want = np.asarray(jx.gaussian_breakpoints(card))
    got = tx.gaussian_breakpoints(card).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(
        tx.padded_breakpoints(card).numpy(),
        np.asarray(jx.padded_breakpoints(card)))


def test_unknown_cardinality_raises():
    with pytest.raises(ValueError, match="cardinality"):
        tx.gaussian_breakpoints(100)


def test_random_walk_copy_matches_reference():
    np.testing.assert_array_equal(tdatagen.random_walk(300, 64, seed=4),
                                  datagen.random_walk(300, 64, seed=4))


def _windowed_sum(x):
    # The order sum_last promises, written out: windows of 32 left to right,
    # then the window totals the same way.
    acc = x.astype(np.float32)
    while acc.shape[-1] > 32:
        pad = (-acc.shape[-1]) % 32
        acc = np.pad(acc, [(0, 0), (0, pad)]).reshape(acc.shape[0], -1, 32)
        total = acc[..., 0]
        for i in range(1, 32):
            total = (total + acc[..., i]).astype(np.float32)
        acc = total
    total = acc[..., 0]
    for i in range(1, acc.shape[-1]):
        total = (total + acc[..., i]).astype(np.float32)
    return total


@pytest.mark.parametrize("n", [16, 64, 128, 256, 1024, 100])
def test_sum_last_order(n):
    x = _walks(500, n, seed=n)
    got = tx.sum_last(_t(x)).numpy()
    np.testing.assert_array_equal(got, _windowed_sum(x))
    if n % 32 == 0:  # the reference pads a ragged last window its own way
        assert_float_parity(got, jnp.sum(jnp.asarray(x), axis=-1))


@pytest.mark.parametrize("n", [64, 128, 256])
def test_znorm_parity(n):
    x = _walks(2000, n, seed=n + 1)
    assert_float_parity(tx.znorm(_t(x)).numpy(), jx.znorm(jnp.asarray(x)))


@pytest.mark.parametrize("n,w", [(64, 16), (128, 16), (256, 16), (256, 8)])
@pytest.mark.parametrize("card", [16, 256])
def test_paa_and_sax_bitwise_from_same_znormed_input(n, w, card):
    z = np.asarray(jx.znorm(jnp.asarray(_walks(3000, n, seed=7))))
    j_sax, j_paa = jx.convert_to_sax(jnp.asarray(z), w, card, normalize=False)
    t_sax, t_paa = tx.convert_to_sax(_t(z), w, card, normalize=False)
    np.testing.assert_array_equal(t_paa.numpy(), np.asarray(j_paa))
    assert t_sax.dtype == torch.uint8
    np.testing.assert_array_equal(t_sax.numpy(), np.asarray(j_sax))


def test_convert_to_sax_from_raw_parity():
    x = _walks(3000, 256, seed=8)
    j_sax, j_paa = jx.convert_to_sax(jnp.asarray(x))
    t_sax, t_paa = tx.convert_to_sax(_t(x))
    assert_float_parity(t_paa.numpy(), j_paa)
    if reference_sums_like_port():
        np.testing.assert_array_equal(t_sax.numpy(), np.asarray(j_sax))
    else:  # a symbol may move only where PAA lies at a breakpoint
        near = np.min(np.abs(np.asarray(j_paa)[..., None]
                             - np.asarray(jx.gaussian_breakpoints())), -1)
        assert np.all(near[t_sax.numpy() != np.asarray(j_sax)] < 1e-5)


@pytest.mark.parametrize("card,w", [(256, 16), (64, 8), (16, 32)])
def test_root_and_refine_keys_bitwise(card, w):
    rng = np.random.default_rng(card + w)
    sax = rng.integers(0, card, size=(4000, w), dtype=np.uint8)
    np.testing.assert_array_equal(
        tx.root_key(_t(sax), card).numpy(),
        np.asarray(jx.root_key(jnp.asarray(sax), card)))
    bits = (card - 1).bit_length()
    for got, want in zip(tx.refine_keys(_t(sax), bits, card),
                         jx.refine_keys(jnp.asarray(sax), bits, card)):
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want).astype(np.int64))
    with pytest.raises(ValueError, match="exceeds"):
        tx.refine_keys(_t(sax), bits + 1, card)


def test_symbol_bounds_lower_bound_and_euclid_parity():
    z = np.asarray(jx.znorm(jnp.asarray(_walks(2000, 256, seed=9))))
    q = np.asarray(jx.znorm(jnp.asarray(_walks(3, 256, seed=10))))
    sax = np.asarray(jx.convert_to_sax(jnp.asarray(z), normalize=False)[0])
    qp = np.asarray(jx.paa(jnp.asarray(q), 16))
    for got, want in zip(tx.symbol_bounds(_t(sax)),
                         jx.symbol_bounds(jnp.asarray(sax))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tx.lower_bound_sq(_t(qp), _t(sax)).numpy(),
        np.asarray(jx.lower_bound_sq(jnp.asarray(qp), jnp.asarray(sax))))
    assert_float_parity(tx.euclid_sq(_t(q[0]), _t(z)).numpy(),
                        jx.euclid_sq(jnp.asarray(q[0]), jnp.asarray(z)))


def test_lower_bound_never_exceeds_distance():
    z = tx.znorm(_t(_walks(1000, 128, seed=12)))
    q = tx.znorm(_t(_walks(4, 128, seed=13)))
    sax, _ = tx.convert_to_sax(z, 16, 256, normalize=False)
    lb = tx.lower_bound_sq(tx.paa(q, 16), sax, 128)  # (4, 1000)
    d = tx.euclid_sq(q[:, None, :], z[None, :, :])
    assert torch.all(lb <= d * (1 + 1e-5) + 1e-5)
