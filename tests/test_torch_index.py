"""Port parity, index: repro_torch.core.index against repro.core.index.

The leaf-order permutation, the sorted SAX and the bucket offsets must be
identical to the reference's from the same SAX, and end to end from raw on
hosts whose XLA sums like the port (``reference_sums_like_port``);
elsewhere a z-norm rounding difference may move a symbol that sits within
1e-5 of a breakpoint, and with it that series' place in the leaf order.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_index as j_build_index
from repro.core import datagen
from repro.core import index as jindex
from repro.core import isax as jx
from repro_torch import convert
from repro_torch.core import index as tindex
from test_torch_search import assert_float_parity, reference_sums_like_port

GOLDEN = np.load(pathlib.Path(__file__).parent / "golden_engine_core.npz")


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("card,w,bits", [(256, 16, 4), (256, 16, 8),
                                         (64, 8, 6)])
def test_sort_and_offsets_bitwise_from_same_sax(card, w, bits):
    rng = np.random.default_rng(card + bits)
    # Few distinct symbols -> many exact key ties: stability is exercised.
    sax = rng.integers(0, card, size=(5000, w)).astype(np.uint8)
    sax[::3] = sax[1::3][: len(sax[::3])]
    want = np.asarray(jindex.sort_by_index_key(jnp.asarray(sax), card, bits))
    got = tindex.sort_by_index_key(_t(sax), card, bits).numpy()
    np.testing.assert_array_equal(got, want)
    root = jx.root_key(jnp.asarray(sax[want]), card)
    np.testing.assert_array_equal(
        tindex.bucket_offsets_from_keys(_t(np.asarray(root)), 2 ** w).numpy(),
        np.asarray(jindex.bucket_offsets_from_keys(root, 2 ** w)))


@pytest.mark.parametrize("name", ["golden", "walk"])
def test_build_index_from_raw_parity(name):
    raw = (GOLDEN["raw"] if name == "golden"
           else datagen.random_walk(4000, 256, seed=17))
    j = j_build_index(jnp.asarray(raw))
    t = tindex.build_index(raw, device="cpu")
    # A z-norm that rounds differently could move a symbol wherever the
    # reference's PAA lies within 1e-5 of a breakpoint.
    j_paa = np.asarray(jx.paa(j.raw, j.segments))
    near = np.min(np.abs(j_paa[..., None]
                         - np.asarray(jx.gaussian_breakpoints())), -1) < 1e-5
    j_sax_file = np.empty_like(np.asarray(j.sax))
    j_sax_file[np.asarray(j.pos)] = np.asarray(j.sax)
    t_sax_file = np.empty_like(j_sax_file)
    t_sax_file[t.pos.numpy()] = t.sax.numpy()
    moved = t_sax_file != j_sax_file
    print(f"{name}: {int(near.sum())} PAA values within 1e-5 of a "
          f"breakpoint; symbols differing: {int(moved.sum())}")
    assert_float_parity(t.raw.numpy(), j.raw)
    assert np.all(near[moved])
    if reference_sums_like_port():
        np.testing.assert_array_equal(t.sax.numpy(), np.asarray(j.sax))
        np.testing.assert_array_equal(t.pos.numpy(), np.asarray(j.pos))
        np.testing.assert_array_equal(t.bucket_offsets.numpy(),
                                      np.asarray(j.bucket_offsets))
    assert all(tindex.validate_index(t).values())


def test_build_without_normalize_and_small_w():
    raw = datagen.random_walk(1500, 64, seed=18)
    z = np.asarray(jx.znorm(jnp.asarray(raw)))
    j = j_build_index(jnp.asarray(z), 8, 64, normalize=False, refine_bits=6)
    t = tindex.build_index(z, 8, 64, normalize=False, refine_bits=6,
                           device="cpu")
    np.testing.assert_array_equal(t.sax.numpy(), np.asarray(j.sax))
    np.testing.assert_array_equal(t.pos.numpy(), np.asarray(j.pos))
    np.testing.assert_array_equal(t.bucket_offsets.numpy(),
                                  np.asarray(j.bucket_offsets))


def test_convert_round_trip_and_assemble():
    j = j_build_index(jnp.asarray(datagen.random_walk(800, 64, seed=19)))
    arrays = dict(sax=np.asarray(j.sax), pos=np.asarray(j.pos),
                  bucket_offsets=np.asarray(j.bucket_offsets),
                  raw=np.asarray(j.raw), series_length=64, segments=16,
                  cardinality=256)
    t = convert.index_from_arrays(**arrays, device="cpu")
    back = convert.index_to_arrays(t)
    for key, val in arrays.items():
        np.testing.assert_array_equal(back[key], val)
    a = tindex.assemble_index(arrays["sax"], arrays["pos"], t.raw, 16, 256)
    assert torch.equal(a.bucket_offsets, t.bucket_offsets)
    assert a.num_series == 800 and a.num_buckets == 2 ** 16
    with pytest.raises(ValueError, match="sax shape"):
        convert.index_from_arrays(**{**arrays, "sax": arrays["sax"][:, :8]},
                                  device="cpu")


def test_empty_index_and_devices():
    e = tindex.empty_index(64, device="cpu")
    assert e.num_series == 0 and e.bucket_offsets.shape == (2 ** 16 + 1,)
    assert e.device == torch.device("cpu")
    if not torch.cuda.is_available():  # a CUDA request never falls back
        with pytest.raises(RuntimeError, match="cuda"):
            tindex.build_index(np.zeros((4, 64), np.float32))
        with pytest.raises(RuntimeError, match="cuda"):
            tindex.empty_index(64)
    with pytest.raises(ValueError, match="device"):
        tindex.build_index(np.zeros((4, 64), np.float32), device="meta")


@pytest.mark.parametrize("num_shards", [1, 3, 7])
def test_build_sharded_index_parity(num_shards):
    # 1000 rows in 3 or 7 shards: sizes differ by one (S does not divide N).
    raw = datagen.random_walk(1000, 64, seed=23)
    j = j_build_index(jnp.asarray(raw))
    t = convert.index_from_arrays(
        np.asarray(j.sax), np.asarray(j.pos), np.asarray(j.bucket_offsets),
        np.asarray(j.raw), j.series_length, j.segments, j.cardinality,
        device="cpu")
    sj = jindex.build_sharded_index(j, num_shards)
    st = tindex.build_sharded_index(t, num_shards)
    assert st.offsets == sj.offsets and st.num_shards == num_shards
    assert st.num_series == 1000
    for a, b, lo, hi in zip(sj.shards, st.shards, st.offsets[:-1],
                            st.offsets[1:]):
        for name in ("sax", "pos", "bucket_offsets", "raw"):
            got, want = getattr(b, name).numpy(), np.asarray(getattr(a, name))
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want)
        # An independent build over the slice gives the same shard.
        alone = tindex.build_index(t.raw[lo:hi], normalize=False,
                                   device="cpu")
        for name in ("sax", "pos", "bucket_offsets"):
            assert torch.equal(getattr(b, name), getattr(alone, name)), name
    with pytest.raises(ValueError, match="num_shards"):
        tindex.build_sharded_index(t, 1001)
