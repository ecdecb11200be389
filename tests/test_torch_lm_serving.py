"""The port's LM serving path against the JAX package's, on the CPU.

Greedy generation, the slot batcher and the kNN-LM example run with JAX's
``init_params(PRNGKey(0))`` parameters carried into the port by
``convert.model_from_arrays``, in float32: their tokens must be equal to
JAX's. ``knn_mix_logits`` is held to the root example's within 1e-5
(absolute, on log-probabilities), and the synthetic token streams must be
equal array for array. The two entry points are run once each as a user
runs them, on the CPU.
"""

import dataclasses
import functools
import importlib.util
import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import Model as JModel
from repro.serving.batcher import Request as JRequest
from repro.serving.batcher import SlotBatcher as JSlotBatcher
from repro.serving.serve_step import greedy_generate as jgreedy
from repro.training import data as jdata
from repro_torch.convert import model_from_arrays
from repro_torch.examples import retrieval_serve as tserve
from repro_torch.serving.batcher import Request, SlotBatcher
from repro_torch.serving.kv_cache import pad_cache_to
from repro_torch.serving.serve_step import (greedy_generate,
                                            make_decode_step,
                                            make_prefill_step)
from repro_torch.training import data as tdata

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


@functools.lru_cache(maxsize=None)
def _models(arch, **over):
    cfg = dataclasses.replace(jconfigs.get_smoke_config(arch),
                              dtype="float32", **over)
    jm = JModel(cfg, remat=False)
    params = jax.jit(jm.init_params)(jax.random.PRNGKey(0))
    return cfg, jm, params, model_from_arrays(
        cfg, jax.tree.map(np.asarray, params), CPU)


def _root_example():
    spec = importlib.util.spec_from_file_location(
        "root_retrieval_serve", ROOT / "examples" / "retrieval_serve.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ["granite-34b", "rwkv6-1.6b",
                                  "jamba-v0.1-52b"])
def test_greedy_generate_matches_jax(arch):
    cfg, jm, params, tm = _models(arch)
    prompts = (np.arange(10).reshape(2, 5) * 7 + 3) % cfg.vocab_size
    want = jgreedy(jm, params, jnp.asarray(prompts, jnp.int32), max_new=6)
    got = greedy_generate(tm, torch.from_numpy(prompts), max_new=6)
    assert got.shape == (2, 11)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_serve_steps_drive_greedy_generation():
    """``make_prefill_step`` + ``make_decode_step`` give greedy_generate's
    tokens (the steps the JAX package's launcher wraps)."""
    cfg, _, _, tm = _models("granite-34b")
    prompts = torch.from_numpy((np.arange(12).reshape(2, 6) * 5) % 128)
    logits, cache = make_prefill_step(tm)({"tokens": prompts})
    cache = pad_cache_to(cache, 6 + 4)
    decode = make_decode_step(tm)
    out = [prompts]
    for i in range(4):
        nxt = torch.argmax(logits, dim=-1)[:, None]
        out.append(nxt)
        logits, cache = decode({"tokens": nxt}, cache, 6 + i)
    assert torch.equal(torch.cat(out, dim=1),
                       greedy_generate(tm, prompts, max_new=4))


def _prompts(cfg, lengths, mult=3, add=1):
    return [((np.arange(n, dtype=np.int32) * mult + add + i)
             % cfg.vocab_size) for i, n in enumerate(lengths)]


def _serve_both(arch, prompts, slots, max_len, max_new, steps):
    cfg, jm, params, tm = _models(arch)
    jb = JSlotBatcher(jm, params, batch_size=slots, max_len=max_len)
    tb = SlotBatcher(tm, batch_size=slots, max_len=max_len)
    for i, p in enumerate(prompts):
        jb.submit(JRequest(rid=i, prompt=p, max_new=max_new))
        tb.submit(Request(rid=i, prompt=p, max_new=max_new))
    return jb.run(steps), tb.run(steps), (cfg, tm)


@pytest.mark.parametrize("case", ["slot_reuse", "bucket_padding",
                                  "rwkv_state_isolation"])
def test_slot_batcher_matches_jax(case):
    if case == "slot_reuse":  # 2 slots, 3 requests
        arch, lengths, max_len = "granite-34b", (4, 6, 5), 32
    elif case == "bucket_padding":  # 5 and 7 share the bucket of 8
        arch, lengths, max_len = "granite-34b", (7, 5), 32
    else:
        arch, lengths, max_len = "rwkv6-1.6b", (5, 5), 24
    cfg = jconfigs.get_smoke_config(arch)
    prompts = _prompts(cfg, lengths)
    want, got, (cfg, tm) = _serve_both(arch, prompts, 2, max_len, 4, 40)
    assert sorted(got) == sorted(want) == list(range(len(prompts)))
    for rid in want:
        assert np.array_equal(got[rid], np.asarray(want[rid])), rid
        # and each answer is its own greedy generation
        single = greedy_generate(tm, torch.from_numpy(
            prompts[rid][None].astype(np.int64)), max_new=4)
        assert np.array_equal(got[rid], single[0].numpy()), rid


def test_slot_batcher_run_drains_finished():
    cfg, _, _, tm = _models("granite-34b")
    b = SlotBatcher(tm, batch_size=2, max_len=32)
    p0 = np.arange(4, dtype=np.int32) % cfg.vocab_size
    b.submit(Request(rid=0, prompt=p0, max_new=3))
    assert sorted(b.run(20)) == [0]
    assert b.run(5) == {}
    b.submit(Request(rid=1, prompt=(p0 + 1) % cfg.vocab_size, max_new=3))
    assert sorted(b.run(20)) == [1]


def test_pad_cache_to_only_touches_attention():
    _, _, _, tm = _models("jamba-v0.1-52b")
    cache = tm.init_cache(2, 8)
    padded = pad_cache_to(cache, 16)
    assert padded["periods"]["attn_k"].shape[-3] == 16
    assert padded["periods"]["attn_v"].shape[-3] == 16
    for name in ("mamba_conv", "mamba_ssm"):
        assert padded["periods"][name] is cache["periods"][name]
    _, _, _, rm = _models("rwkv6-1.6b")
    rc = rm.init_cache(2, 8)
    assert all(pad_cache_to(rc, 16)["blocks"][k] is v
               for k, v in rc["blocks"].items())


@pytest.mark.parametrize("fn", ["synthetic_batch", "bigram_batch"])
@pytest.mark.parametrize("step,seed", [(0, 0), (3, 7)])
def test_token_streams_equal_jax(fn, step, seed):
    want = getattr(jdata, fn)(step, 4, 33, 500, seed=seed)
    got = getattr(tdata, fn)(step, 4, 33, 500, seed=seed)
    for key in ("tokens", "labels"):
        assert got[key].dtype == want[key].dtype
        assert np.array_equal(got[key], want[key])


def test_knn_mix_logits_matches_root_example():
    root = _root_example()
    rng = np.random.default_rng(21)
    b, k, v = 4, 8, 64
    lm = rng.standard_normal((b, v)).astype(np.float32)
    d = np.sort(np.abs(rng.standard_normal((b, k))) * 30, axis=1).astype(
        np.float32)
    d[0, 0] = 0.0
    toks = rng.integers(0, v, (b, k))
    toks[1, :4] = toks[1, 0]  # neighbours sharing a token: their max counts
    want = root.knn_mix_logits(jnp.asarray(lm), jnp.asarray(d),
                               jnp.asarray(toks, jnp.int32), v, 0.3)
    got = tserve.knn_mix_logits(torch.from_numpy(lm), torch.from_numpy(d),
                                torch.from_numpy(toks), v, 0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def _generated(stdout: str) -> list:
    lines = [ln for ln in stdout.splitlines()
             if ln.startswith("seq ") and "prompt + generated:" in ln]
    # numpy 2 prints the prompt's tokens as np.int32(242)
    return [[int(t) for t in re.findall(
        r"\d+", re.sub(r"np\.\w+\(", "", ln.split(":", 1)[1]))]
        for ln in lines]


def test_retrieval_serve_matches_root_example(capsys):
    """The port's loop, given JAX's parameters, generates the root
    example's tokens (its stdout, captured)."""
    _root_example().main()
    want = _generated(capsys.readouterr().out)
    cfg = dataclasses.replace(jconfigs.get_smoke_config("granite-34b"),
                              d_model=64, vocab_size=512, dtype="float32")
    params = jax.jit(JModel(cfg, remat=False).init_params)(
        jax.random.PRNGKey(0))
    model = model_from_arrays(cfg, jax.tree.map(np.asarray, params), CPU)
    got = tserve.run(model)
    assert len(want) == 4 and all(len(w) == 16 for w in want)
    assert got.tolist() == want
    assert _generated(capsys.readouterr().out) == want


@pytest.mark.parametrize("module", ["repro_torch.launch.serve",
                                    "repro_torch.examples.retrieval_serve"])
def test_entry_points_run_on_cpu(module):
    args = [sys.executable, "-m", module, "--device", "cpu"]
    if module.endswith("serve") and "launch" in module:
        args.append("--smoke")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(args, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    if "launch" in module:
        assert re.search(r"served 8/8 requests", out.stdout), out.stdout
    else:
        assert len(_generated(out.stdout)) == 4, out.stdout
