"""k-NN classification on top of ParIS+ exact search (paper Fig. 18).

Counterpart of ``repro/core/classifier.py``. The paper's downstream use
case: classify an object by the majority label of its k nearest neighbours,
with the neighbour search done by the index (against the serial scan). The
speedup of the classifier is the speedup of the exact k-NN search below it:
on the card :meth:`KnnClassifier.predict` runs the ``lower_bound_sq_batch``
and ``euclid_sq`` kernels through :func:`~repro_torch.core.search.exact_knn`.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import isax
from repro_torch.core import search as search_mod
from repro_torch.core.index import ParISIndex

# Rows of the raw file the brute-force path distances at once: a (rows, n)
# f32 temporary of 256 MiB at n = 256, where the whole (N, n) difference
# would take as much memory as the raw series themselves.
BRUTE_CHUNK = 1 << 18


class KnnClassifier:
    """Majority-vote k-NN classifier over one index (labels in file order).

    ``labels`` are non-negative integer class ids, one a series in file
    order (numpy, a list, or a tensor on the index's device); they are kept
    as int64 on the index's device. Ties in the vote go to the smallest
    label, as ``jnp.argmax`` gives them.
    """

    def __init__(self, index: ParISIndex, labels, k: int = 1,
                 round_size: int = 4096, impl: str = "auto"):
        if isinstance(labels, torch.Tensor):
            if labels.device != index.device:
                raise ValueError(
                    f"labels on {labels.device}, index on {index.device}")
            labels = labels.to(torch.int64)
        else:
            labels = torch.tensor(np.asarray(labels), dtype=torch.int64,
                                  device=index.device)
        if labels.shape != (index.num_series,):
            raise ValueError(f"need one label a series ({index.num_series}), "
                             f"got shape {tuple(labels.shape)}")
        self.index = index
        self.labels = labels  # file order
        self.k = k
        self.round_size = round_size
        self.impl = impl
        self.num_classes = int(labels.max()) + 1

    def kneighbors(self, query) -> tuple:
        """((k,) squared distances, (k,) file positions) of one (n,) query's
        nearest series, by the index's exact k-NN search."""
        return search_mod.exact_knn(self.index, query, k=self.k,
                                    round_size=self.round_size,
                                    impl=self.impl)

    def brute_kneighbors(self, query) -> tuple:
        """The same by a full scan (the UCR-Suite classifier): the z-normed
        query's distance to every raw row in file order, summed as
        :func:`isax.euclid_sq` sums it, ``BRUTE_CHUNK`` rows at a time, then
        a stable sort (the lower position first on ties) and the first k."""
        raw = self.index.raw
        q = isax.znorm(search_mod._query(self.index, query))
        d = torch.cat([isax.euclid_sq(q, raw[s:s + BRUTE_CHUNK])
                       for s in range(0, raw.shape[0], BRUTE_CHUNK)])
        nn = torch.argsort(d, stable=True)[:self.k]
        return d[nn], nn

    def vote(self, positions: torch.Tensor) -> int:
        """The majority label of the series at ``positions`` (the first,
        that is the smallest, label on ties)."""
        votes = self.labels[positions.to(torch.int64)]
        counts = torch.bincount(votes, minlength=self.num_classes)
        return int(torch.argmax(counts))

    def predict(self, query) -> int:
        """Label for one (n,) query: majority vote among its k nearest series."""
        return self.vote(self.kneighbors(query)[1])

    def predict_brute(self, query) -> int:
        """Reference path: the vote over :meth:`brute_kneighbors`."""
        return self.vote(self.brute_kneighbors(query)[1])
