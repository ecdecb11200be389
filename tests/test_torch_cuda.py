"""The CUDA kernels and the engine on the card (marked ``cuda``).

Each kernel is held against its plain version (``kernels/ref.py``) on the
same CUDA tensors: ``paa_isax`` and ``lower_bound_sq_batch`` bit for bit,
``euclid_sq`` within 1e-5 relative (it sums in another order). Whether a
card is present is decided inside the ``cuda_device`` fixture, so every
worker collects the same tests; without a card they skip with a reason.
This file imports no JAX, so it runs where the port runs:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import isax as tx
from repro_torch.core.datagen import random_walk
from repro_torch.kernels import ops as tops


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [8, 16])
def test_cuda_paa_isax_matches_plain(cuda_device, w):
    z = tx.znorm(_t(random_walk(5000, 256, seed=71))).to(cuda_device)
    bp = tx.gaussian_breakpoints(256, cuda_device)
    k_sax, k_paa = tops.paa_isax(z, bp, w, normalize=False)
    p_sax, p_paa = tops.paa_isax(z, bp, w, normalize=False, impl="ref")
    torch.cuda.synchronize()
    assert torch.equal(k_paa, p_paa) and torch.equal(k_sax, p_sax)
    raw = _t(random_walk(5000, 256, seed=72)).to(cuda_device)
    k_sax, k_paa = tops.paa_isax(raw, bp, w, normalize=True)
    p_sax, p_paa = tops.paa_isax(raw, bp, w, normalize=True, impl="ref")
    torch.testing.assert_close(k_paa, p_paa, rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [4, 8, 16, 32])
def test_cuda_lower_bound_batch_bitwise(cuda_device, w):
    z = tx.znorm(_t(random_walk(3000, 256, seed=81))).to(cuda_device)
    q = tx.znorm(_t(random_walk(70, 256, seed=82))).to(cuda_device)  # > one query block
    sax, _ = tx.convert_to_sax(z, w, 256, normalize=False)
    qp = tx.paa(q, w)
    bpp = tx.padded_breakpoints(256, cuda_device)
    got = tops.lower_bound_sq_batch(qp, sax, bpp, 256)
    want = tops.lower_bound_sq_batch(qp, sax, bpp, 256, impl="ref")
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 256, 100])  # 100: the scalar-load path
def test_cuda_euclid_gather_matches_plain(cuda_device, n):
    raw = _t(random_walk(2000, n, seed=91)).to(cuda_device)
    qs = _t(random_walk(9, n, seed=92)).to(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    pos = torch.randint(-3, 2003, (9, 333), generator=gen,
                        device=cuda_device, dtype=torch.int32)
    for p in (pos, pos[0].contiguous()):
        got = tops.euclid_sq_gather(qs, raw, p)
        want = tops.euclid_sq_gather(qs, raw, p, impl="ref")
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cuda_engine_matches_cpu_engine(cuda_device):
    from repro_torch.core import Tier, build_index
    from repro_torch.core.search import exact_knn_batch, knn_batch_tiered

    raw = random_walk(6000, 128, seed=101)
    queries = random_walk(8, 128, seed=102)
    on_card = build_index(raw, device=cuda_device)
    on_cpu = build_index(raw, device="cpu")
    assert torch.equal(on_card.sax.cpu(), on_cpu.sax)
    assert torch.equal(on_card.pos.cpu(), on_cpu.pos)
    for k in (1, 8):
        d, p = exact_knn_batch(on_card, queries, k=k, round_size=256)
        d0, p0 = exact_knn_batch(on_cpu, queries, k=k, round_size=256)
        torch.testing.assert_close(d.cpu(), d0, rtol=1e-5, atol=1e-5)
        _, _, ach = knn_batch_tiered(on_card, queries, Tier.epsilon(0.1), k=k,
                                     round_size=256)
        assert np.all(ach <= 0.1 + 1e-6)
    counts = tops.launch_counts()
    assert all(c > 0 for c in counts.values()), counts


@pytest.mark.cuda
def test_cuda_wrappers_reject_bad_input(cuda_device):
    from repro_torch.kernels import lower_bound

    sax = torch.zeros((10, 12), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError, match="w=12"):
        lower_bound.lower_bound_sq_batch_cuda(
            torch.zeros((2, 12), device=cuda_device), sax,
            tx.padded_breakpoints(256, cuda_device), 48)
    with pytest.raises(ValueError, match="float32"):
        tops.paa_isax(torch.zeros((4, 64), dtype=torch.float64,
                                  device=cuda_device),
                      tx.gaussian_breakpoints(256, cuda_device), 16)
