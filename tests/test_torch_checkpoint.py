"""The port's checkpoints and resume against the JAX package's, on the CPU,
and jamba's train step (its JAX compile is the slowest, so it runs here,
beside ``test_torch_training.py``'s architectures).

Both packages start from JAX's ``init_params(PRNGKey(0))``. A float32 train
state written by either package is byte-identical to the other's (every
``.npy`` file and ``manifest.json``), and each package restores the
other's bit for bit. Jamba's two float32 train steps are held with
``test_torch_training.py``'s tolerances (``_assert_states_close``).
"""

import dataclasses
import filecmp
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import Model as JModel
from repro.training import checkpoint as jck
from repro.training import optimizer as jopt
from repro.training import train_step as jts
from repro_torch import convert
from repro_torch.models import Model as TModel
from repro_torch.training import checkpoint as tck
from repro_torch.training import data as tdata
from repro_torch.training import elastic as tel
from repro_torch.training import optimizer as topt
from repro_torch.training import train_step as tts

from test_torch_training import (OCFG, _assert_states_close, _np_tree,
                                 _run_both)

CPU = torch.device("cpu")


@functools.lru_cache(maxsize=None)
def _jax_trained(arch="granite-34b"):
    """JAX's float32 train state after one step (moments nonzero)."""
    cfg = dataclasses.replace(jconfigs.get_smoke_config(arch),
                              dtype="float32")
    params = jax.jit(JModel(cfg, remat=False).init_params)(
        jax.random.PRNGKey(0))
    step = jax.jit(jts.make_train_step(
        JModel(cfg, remat=False),
        jts.TrainConfig(optimizer=jopt.OptimizerConfig(**OCFG))))
    batch = tdata.synthetic_batch(0, 2, 8, cfg.vocab_size)
    p, o, _ = step(params, jopt.init_opt_state(params),
                   {k: jnp.asarray(v) for k, v in batch.items()})
    return cfg, (p, o)


def _equal_trees(got, want):
    gl = jax.tree_util.tree_leaves_with_path(got)
    wl = jax.tree_util.tree_leaves_with_path(want)
    assert [jax.tree_util.keystr(p) for p, _ in gl] == \
        [jax.tree_util.keystr(p) for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and np.array_equal(g, w), \
            jax.tree_util.keystr(path)


def test_jamba_train_steps_match_jax_float32():
    jstate, st, jm, tm = _run_both("jamba-v0.1-52b", (("dtype", "float32"),))
    for a, b in zip(jm, tm):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_allclose(float(b[k]), float(a[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=k)
    _assert_states_close(convert.train_state_to_arrays(st),
                         _np_tree(jstate))


def test_files_byte_identical_to_jax(tmp_path):
    cfg, jstate = _jax_trained()
    st = convert.train_state_from_arrays(cfg, _np_tree(jstate), CPU)
    a, b = tmp_path / "jax", tmp_path / "port"
    jck.save(str(a), 3, jstate, extra={"note": "x"})
    tck.save(str(b), 3, st, extra={"note": "x"})
    da, db = a / "step_00000003", b / "step_00000003"
    names = sorted(os.listdir(da))
    assert names == sorted(os.listdir(db)) and "manifest.json" in names
    assert len(names) == len(jax.tree.leaves(jstate)) + 1
    match, mismatch, errors = filecmp.cmpfiles(da, db, names, shallow=False)
    assert not mismatch and not errors


def test_port_restores_jax_checkpoint_bitwise(tmp_path):
    cfg, jstate = _jax_trained()
    jck.save(str(tmp_path), 5, jstate)
    # into a fresh state: another init, zero moments
    st = tts.init_train_state(TModel(cfg, device="cpu",
                                     generator=torch.Generator()))
    out, step = tck.restore_latest(str(tmp_path), st)
    assert out is st and step == 5
    _equal_trees(convert.train_state_to_arrays(st), _np_tree(jstate))
    # a generic tree comes back as tensors of the manifest's dtypes
    tree = tck.restore(str(tmp_path), 5, _np_tree(jstate))
    assert tree[1].step.dtype == torch.int32
    _equal_trees(jax.tree.map(lambda t: t.numpy(), tree), _np_tree(jstate))


def test_jax_restores_port_checkpoint_bitwise(tmp_path):
    cfg, jstate = _jax_trained()
    st = convert.train_state_from_arrays(cfg, _np_tree(jstate), CPU)
    tck.save(str(tmp_path), 7, st)
    like = jax.eval_shape(lambda: jstate)
    restored, step = jck.restore_latest(str(tmp_path), like)
    assert step == 7
    _equal_trees(_np_tree(restored), _np_tree(jstate))


def test_bfloat16_leaf_written_as_jax_writes_it(tmp_path):
    """JAX's ``np.save`` of a bfloat16 array; the port reads it back as a
    bfloat16 tensor (the JAX package's own restore cannot place it)."""
    vals = np.arange(12, dtype=np.float32).reshape(3, 4) / 7
    jck.save(str(tmp_path / "jax"), 1, {"w": jnp.asarray(vals, jnp.bfloat16)})
    tck.save(str(tmp_path / "port"), 1,
             {"w": torch.from_numpy(vals).to(torch.bfloat16)})
    da, db = tmp_path / "jax" / "step_00000001", tmp_path / "port" / \
        "step_00000001"
    names = sorted(os.listdir(da))
    assert names == sorted(os.listdir(db))
    assert not filecmp.cmpfiles(da, db, names, shallow=False)[1]
    out = tck.restore(str(tmp_path / "jax"), 1, {"w": vals})
    assert out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"], torch.from_numpy(vals).to(torch.bfloat16))


def test_atomicity_ignores_partial_tmp(tmp_path):
    tck.save(str(tmp_path), 1, {"x": torch.arange(4)})
    os.makedirs(tmp_path / "step_00000002.tmp")
    with open(tmp_path / "step_00000002.tmp" / "manifest.json", "w") as f:
        f.write("{corrupt")
    assert tck.latest_step(str(tmp_path)) == 1
    assert jck.latest_step(str(tmp_path)) == 1


def test_retention(tmp_path):
    for s in range(5):
        tck.save(str(tmp_path), s, {"x": torch.arange(4)}, keep=2)
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000004"]


def test_async_saver_snapshots_before_returning(tmp_path):
    x = torch.arange(128, dtype=torch.float32)
    saver = tck.AsyncSaver()
    saver.save(str(tmp_path), 7, {"x": x})
    x.add_(1)  # training goes on mutating its buffers
    saver.wait()
    out = tck.restore(str(tmp_path), 7, {"x": x})
    assert torch.equal(out["x"], torch.arange(128, dtype=torch.float32))


def test_async_saver_raises_a_failed_write(tmp_path):
    (tmp_path / "file").write_text("not a directory")
    saver = tck.AsyncSaver()
    saver.save(str(tmp_path / "file"), 1, {"x": torch.arange(4)})
    with pytest.raises(RuntimeError, match="background checkpoint write"):
        saver.wait()


def _train(st, step_fn, start, n, vocab):
    for i in range(start, start + n):
        batch = tdata.synthetic_batch(i, 2, 8, vocab)
        st, _ = step_fn(st, {k: torch.from_numpy(v) for k, v in
                             batch.items()})
    return st


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_interrupted_training_resumes_bitwise(tmp_path, dtype):
    """6 steps straight against 3 + save + a crash + restore into a fresh
    model and optimizer + 3: masters, moments and step bitwise."""
    cfg = dataclasses.replace(jconfigs.get_smoke_config("internlm2-20b"),
                              dtype=dtype)
    tcfg = tts.TrainConfig(optimizer=topt.OptimizerConfig(
        warmup_steps=0, total_steps=100))

    def fresh(seed):
        model = TModel(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(seed))
        st = tts.init_train_state(model)
        return st, tts.make_train_step(model, tcfg)

    st, fn = fresh(0)
    straight = convert.train_state_to_arrays(_train(st, fn, 0, 6,
                                                    cfg.vocab_size))
    st, fn = fresh(0)
    tck.save(str(tmp_path), 3, _train(st, fn, 0, 3, cfg.vocab_size))
    del st, fn  # the crash
    st, fn = fresh(1)
    out, step = tck.restore_latest(str(tmp_path), st)
    assert step == 3 and int(st.opt.step) == 3
    resumed = convert.train_state_to_arrays(_train(st, fn, 3, 3,
                                                   cfg.vocab_size))
    _equal_trees(resumed, straight)
    for p, m in zip(st.params, st.master):  # compute copies refreshed
        assert torch.equal(p.detach(), m.to(p.dtype))


def test_resume_or_init_and_policy(tmp_path):
    ecfg = tel.ElasticConfig(ckpt_dir=str(tmp_path), async_save=False,
                             steps_between_checkpoints=2)
    init_fn = lambda: {"w": torch.zeros((4, 4)),  # noqa: E731
                       "step_marker": torch.tensor(0, dtype=torch.int32)}
    state, start = tel.resume_or_init(ecfg, init_fn)
    assert start == 0
    state = {"w": state["w"] + 1,
             "step_marker": torch.tensor(4, dtype=torch.int32)}
    pol = tel.CheckpointPolicy(ecfg)
    assert not pol.maybe_save(3, state)
    assert pol.maybe_save(4, state)
    state2, start2 = tel.resume_or_init(ecfg, init_fn)
    assert start2 == 4 and float(state2["w"].sum()) == 16.0
    assert int(state2["step_marker"]) == 4


def test_resume_or_init_train_state_with_async_policy(tmp_path):
    cfg = dataclasses.replace(jconfigs.get_smoke_config("granite-34b"),
                              dtype="float32")
    ecfg = tel.ElasticConfig(ckpt_dir=str(tmp_path),
                             steps_between_checkpoints=1)

    def init_fn():
        return tts.init_train_state(TModel(
            cfg, device="cpu", generator=torch.Generator().manual_seed(0)))

    st, start = tel.resume_or_init(ecfg, init_fn)
    assert start == 0
    fn = tts.make_train_step(st.model, tts.TrainConfig())
    pol = tel.CheckpointPolicy(ecfg)
    st = _train(st, fn, 0, 1, cfg.vocab_size)
    assert pol.maybe_save(1, st)
    st = _train(st, fn, 1, 1, cfg.vocab_size)
    pol.finalize(2, st)
    want = convert.train_state_to_arrays(st)
    back, start = tel.resume_or_init(ecfg, init_fn)
    assert start == 2
    _equal_trees(convert.train_state_to_arrays(back), want)
    assert sorted(os.listdir(tmp_path)) == ["step_00000001",
                                            "step_00000002"]
