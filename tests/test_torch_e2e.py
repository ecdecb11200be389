"""Port parity, end to end from raw: the README quickstart in both packages.

Each package builds its own index from the same raw numpy series
(``build_index``: z-norm, PAA/iSAX, leaf-order sort, bucket table) and
answers the same queries exactly and at the epsilon 0.1 and budget 2 tiers.
Answer positions must be identical and distances within rtol 1e-5. SAX may
only differ where the reference's PAA lies within 1e-5 of a breakpoint; the
test prints how many such values there are (the port z-norms in the
reference's order, so none differs).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import build_index as j_build_index
from repro.core import isax as jx
from repro.core import search as js
from repro_torch.core import build_index as t_build_index
from repro_torch.core import search as ts


@pytest.mark.parametrize("n", [128, 256])
def test_quickstart_from_raw_matches_reference(n):
    rng = np.random.default_rng(0)
    raw = rng.standard_normal((4096, n), dtype=np.float32).cumsum(axis=1)
    queries = rng.standard_normal((8, n), dtype=np.float32).cumsum(axis=1)
    j = j_build_index(jnp.asarray(raw))
    t = t_build_index(raw, device="cpu")

    j_paa = np.asarray(jx.paa(j.raw, j.segments))
    near = np.min(np.abs(j_paa[..., None]
                         - np.asarray(jx.gaussian_breakpoints())), -1) < 1e-5
    differ = t.sax.numpy() != np.asarray(j.sax)
    print(f"n={n}: {int(near.sum())} PAA values within 1e-5 of a breakpoint; "
          f"{int(differ.sum())} symbols differ")
    j_sax_file = np.empty_like(np.asarray(j.sax))
    j_sax_file[np.asarray(j.pos)] = np.asarray(j.sax)
    t_sax_file = np.empty_like(j_sax_file)
    t_sax_file[t.pos.numpy()] = t.sax.numpy()
    assert np.all(near[j_sax_file != t_sax_file])

    jd, jp = js.exact_knn_batch(j, jnp.asarray(queries), k=4)
    td, tp = ts.exact_knn_batch(t, queries, k=4)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5)

    for jt, tt in ((js.Tier.epsilon(0.1), ts.Tier.epsilon(0.1)),
                   (js.Tier.budget(2), ts.Tier.budget(2))):
        jd2, jp2, ja = js.knn_batch_tiered(j, jnp.asarray(queries), jt, k=4)
        td2, tp2, ta = ts.knn_batch_tiered(t, queries, tt, k=4)
        np.testing.assert_array_equal(tp2.numpy(), np.asarray(jp2))
        np.testing.assert_allclose(td2.numpy(), np.asarray(jd2), rtol=1e-5)
        np.testing.assert_allclose(ta, ja, rtol=1e-5, atol=1e-6)
    # The quickstart's own guarantees, on the port's answers.
    _, _, achieved = ts.knn_batch_tiered(t, queries, ts.Tier.epsilon(0.1), k=4)
    assert np.all(achieved <= 0.1 + 1e-6)
