"""The port's training path against the JAX package's, on the CPU.

Both packages start from JAX's ``init_params(PRNGKey(0))`` (the port's
state through ``convert.train_state_from_arrays``) and see the same numpy
batches, made from a seed. Each JAX train step is jitted once per
(architecture, config). Tolerances, stated once:

- optimizer pieces, loss and metrics: rtol 1e-5 (float32; the port sums
  and takes ``pow`` in another order than XLA);
- compression: bitwise (``torch.round`` and ``jnp.round`` both round half
  to even);
- float32 train steps (2 steps, lr 1e-2): every moment within 1e-3 of its
  leaf's largest magnitude (measured at most 8.2e-5 over the four
  architectures), and every parameter within ``PARAM_TOL`` = lr / 4 (an
  Adam step moves a weight by up to lr whatever its gradient's size, so a
  gradient within float noise of 0 may move by up to lr on either side;
  measured at most 0.076 lr; a wrong gradient moves most weights by lr);
- bfloat16 granite, one step: loss and grad norm within 2e-3 relative,
  first moments within 5e-2 of the leaf's largest magnitude (the JAX scan
  drops some bf16 roundings that the port keeps, ``test_torch_models.py``);
- flash-path gradients: within 1e-4 of the leaf's largest magnitude;
- remat on against off: bitwise (the same ops recomputed).

Jamba's train step (a 25 s JAX compile) is held in
``test_torch_checkpoint.py``, which a second worker runs.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import Model as JModel
from repro.training import compression as jcomp
from repro.training import data as jdata
from repro.training import optimizer as jopt
from repro.training import train_step as jts
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.examples import train_lm
from repro_torch.launch import train as tlaunch
from repro_torch.models import Model as TModel
from repro_torch.training import compression as tcomp
from repro_torch.training import data as tdata
from repro_torch.training import optimizer as topt
from repro_torch.training import train_step as tts

CPU = torch.device("cpu")
LR = 1e-2
PARAM_TOL = LR / 4
OCFG = dict(learning_rate=LR, warmup_steps=2, total_steps=10)


@functools.lru_cache(maxsize=None)
def _params(arch):
    cfg = jconfigs.get_smoke_config(arch)
    return jax.jit(JModel(cfg, remat=False).init_params)(
        jax.random.PRNGKey(0))


def _cfg(arch, **over):
    return dataclasses.replace(jconfigs.get_smoke_config(arch), **over)


@functools.lru_cache(maxsize=None)
def _jax_step(arch, over, **tkw):
    cfg = _cfg(arch, **dict(over))
    return jax.jit(jts.make_train_step(
        JModel(cfg, remat=False),
        jts.TrainConfig(optimizer=jopt.OptimizerConfig(**OCFG), **tkw)))


def _tcfg(**tkw):
    return tts.TrainConfig(optimizer=topt.OptimizerConfig(**OCFG), **tkw)


def _jax_state(arch):
    params = _params(arch)
    return params, jopt.init_opt_state(params)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(vocab, step, b=4, s=16):
    rng = np.random.default_rng(100 + step)
    tok = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def _jx(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tx(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(x)) for p, x in
            jax.tree_util.tree_leaves_with_path(tree)]


def _assert_states_close(got_tree, want_tree, param_tol=PARAM_TOL,
                         moment_rel=1e-3, flips=0.0):
    """``got``/``want``: JAX train-state trees of numpy arrays. With
    ``flips`` > 0 (compressed gradients), that share of a leaf's elements
    may miss the tolerance by one quantization step: a gradient within
    float noise of a rounding boundary rounds either way. Such an element
    stays within 2 lr (a parameter) or 1e-2 of the leaf's largest
    magnitude (a moment: int8's step is 1/127 of the largest)."""
    got, want = _leaves(got_tree), _leaves(want_tree)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, path
        if path == "[1].step":
            assert np.array_equal(g, w)
            continue
        if path.startswith("[0]"):
            tol, flip_tol = param_tol, 2 * LR
        else:
            scale = max(float(np.abs(w).max()), 1e-30)
            tol, flip_tol = moment_rel * scale, 1e-2 * scale
        diff = np.abs(g.astype(np.float64) - w)
        assert np.mean(diff > tol) <= flips, (path, np.mean(diff > tol))
        if flips:
            assert diff.max() <= flip_tol, (path, diff.max())


def _run_both(arch, over=(), steps=2, **tkw):
    """``steps`` train steps through both packages from the same state and
    batches: (JAX state, port state, JAX metrics, port metrics) a step."""
    cfg = _cfg(arch, **dict(over))
    jstep = _jax_step(arch, over, **tkw)
    jstate = _jax_state(arch)
    st = convert.train_state_from_arrays(cfg, _np_tree(jstate), CPU)
    tstep = tts.make_train_step(st.model, _tcfg(**tkw))
    jm, tm = [], []
    for i in range(steps):
        b = _batch(cfg.vocab_size, i)
        p, o, m = jstep(*jstate, _jx(b))
        jstate = (p, o)
        st, m2 = tstep(st, _tx(b))
        jm.append(m)
        tm.append(m2)
    return jstate, st, jm, tm


# ---------------------------------------------------------------------------
# Optimizer pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 1, 5, 10, 60, 110, 200])
def test_lr_at_matches_jax(step):
    cfg = dict(learning_rate=1.0, warmup_steps=10, total_steps=110,
               min_lr_ratio=0.1)
    want = float(jopt.lr_at(jopt.OptimizerConfig(**cfg), jnp.int32(step)))
    got = topt.lr_at(topt.OptimizerConfig(**cfg),
                     torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-7)


def test_global_norm_and_clip_match_jax():
    rng = np.random.default_rng(0)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((4, 5), (7,), (2, 3, 4))]
    jg, jn = jopt.clip_by_global_norm([jnp.asarray(a) for a in arrs], 1.0)
    tg, tn = topt.clip_by_global_norm([torch.from_numpy(a) for a in arrs],
                                      1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    np.testing.assert_allclose(float(topt.global_norm(
        [torch.from_numpy(a) for a in arrs])), float(jopt.global_norm(
            [jnp.asarray(a) for a in arrs])), rtol=1e-6)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


@pytest.mark.parametrize("zero_grads", [False, True])
def test_adamw_update_matches_jax_over_a_model_tree(zero_grads):
    """AdamW over granite's smoke tree, three updates. With zero gradients
    only the decay moves a weight: the stacked ``blocks`` norm scales
    (JAX leaves of rank 2) are decayed, ``final_norm`` is not."""
    cfg = _cfg("granite-34b", dtype="float32")
    params = _params("granite-34b")
    ocfg = dict(learning_rate=1e-2, warmup_steps=1, total_steps=20)
    st = convert.train_state_from_arrays(
        cfg, _np_tree((params, jopt.init_opt_state(params))), CPU)
    rng = np.random.default_rng(3)
    jp, jo = params, jopt.init_opt_state(params)
    for _ in range(3):
        grads = jax.tree.map(
            lambda a: (np.zeros(a.shape, np.float32) if zero_grads else
                       rng.standard_normal(a.shape).astype(np.float32)),
            jp)
        jp, jo, jm = jopt.adamw_update(jopt.OptimizerConfig(**ocfg), jp,
                                       grads, jo)
        tgrads = [torch.from_numpy(np.array(convert._leaf(grads, n)))
                  for n in st.names]
        _, st.opt, tm = topt.adamw_update(
            topt.OptimizerConfig(**ocfg), st.master, tgrads, st.opt,
            st.ranks)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
    _assert_states_close(convert.train_state_to_arrays(st),
                         _np_tree((jp, jo)), param_tol=1e-6,
                         moment_rel=1e-5)
    if zero_grads:
        init = _np_tree(params)
        now = convert.train_state_to_arrays(st)[0]
        assert not np.array_equal(now["blocks"]["ln1"]["scale"],
                                  init["blocks"]["ln1"]["scale"])
        assert np.array_equal(now["final_norm"]["scale"],
                              init["final_norm"]["scale"])


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_cross_entropy_matches_jax(masked, z_loss):
    rng = np.random.default_rng(5)
    logits = (3 * rng.standard_normal((3, 7, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.int32) if masked else None
    want = jts.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                             None if mask is None else jnp.asarray(mask),
                             z_loss)
    got = tts.cross_entropy(torch.from_numpy(logits),
                            torch.from_numpy(labels),
                            None if mask is None else torch.from_numpy(mask),
                            z_loss)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# Compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["none", "bf16", "int8"])
def test_compression_bitwise(method):
    rng = np.random.default_rng(7)
    g = (0.1 * rng.standard_normal((33, 17))).astype(np.float32)
    r = (0.001 * rng.standard_normal((33, 17))).astype(np.float32)
    g[0, :4] = [0.5, -0.5, 1.5, -2.5]  # exact halves after scaling
    want = np.asarray(jcomp.compress_decompress(jnp.asarray(g), method))
    got = tcomp.compress_decompress(torch.from_numpy(g), method).numpy()
    assert np.array_equal(got, want)
    jo, jr = jcomp.compress_with_feedback(jnp.asarray(g), jnp.asarray(r),
                                          method)
    to, tr = tcomp.compress_with_feedback(torch.from_numpy(g),
                                          torch.from_numpy(r), method)
    assert np.array_equal(to.numpy(), np.asarray(jo))
    assert np.array_equal(tr.numpy(), np.asarray(jr))
    tree = {"a": g, "b": g[:5] * 3, "s": np.float32(2.0)}
    res = {k: np.zeros_like(v) for k, v in tree.items()}
    jt, jres = jcomp.tree_compress_with_feedback(
        jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, res),
        method)
    tt, tres = tcomp.tree_compress_with_feedback(
        {k: torch.tensor(v) for k, v in tree.items()},
        {k: torch.tensor(v) for k, v in res.items()}, method)
    for k in tree:
        assert np.array_equal(tt[k].numpy(), np.asarray(jt[k])), k
        assert np.array_equal(tres[k].numpy(), np.asarray(jres[k])), k


# ---------------------------------------------------------------------------
# Train steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["granite-34b", "olmoe-1b-7b",
                                  "rwkv6-1.6b"])
def test_train_steps_match_jax_float32(arch):
    jstate, st, jm, tm = _run_both(arch, (("dtype", "float32"),))
    for a, b in zip(jm, tm):
        assert sorted(a) == sorted(b)  # loss, grad_norm, lr, aux
        for k in a:
            np.testing.assert_allclose(float(b[k]), float(a[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=k)
    if arch == "olmoe-1b-7b":
        assert float(tm[0]["aux"]) > 0  # the MoE aux loss is in the loss
    _assert_states_close(convert.train_state_to_arrays(st),
                         _np_tree(jstate))


@pytest.mark.parametrize("tkw,steps,rtol,flips", [
    (dict(microbatches=2), 2, 1e-5, 0.0),
    (dict(grad_compression="int8"), 1, 1e-5, 1e-3),
    (dict(microbatches=2, grad_compression="bf16"), 1, 1e-5, 1e-3)],
    ids=["mb2", "int8", "mb2-bf16"])
def test_microbatches_and_compression_match_jax(tkw, steps, rtol, flips):
    """Compressed gradients: a gradient within float noise of a rounding
    boundary quantizes one step apart in the two packages (at most 1 in
    1000 elements, ``_assert_states_close``). One step only: a weight that
    moved by another lr changes the next step's gradients everywhere, and
    the quantization amplifies that into more such flips."""
    jstate, st, jm, tm = _run_both("granite-34b", (("dtype", "float32"),),
                                   steps=steps, **tkw)
    for a, b in zip(jm, tm):
        assert sorted(a) == sorted(b)  # no aux when microbatched
        for k in a:
            np.testing.assert_allclose(float(b[k]), float(a[k]), rtol=rtol,
                                       err_msg=k)
    _assert_states_close(convert.train_state_to_arrays(st),
                         _np_tree(jstate), flips=flips)


def test_microbatches_equal_one_full_batch():
    cfg = _cfg("granite-34b", dtype="float32")
    jstate = _np_tree(_jax_state("granite-34b"))
    b = _tx(_batch(cfg.vocab_size, 0))
    out = []
    for n in (1, 2):
        st = convert.train_state_from_arrays(cfg, jstate, CPU)
        st, m = tts.make_train_step(st.model, _tcfg(microbatches=n,
                                                    z_loss=0.0))(st, b)
        out.append((float(m["loss"]), convert.train_state_to_arrays(st)))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-5)
    _assert_states_close(out[1][1], out[0][1])


def test_bf16_granite_step_matches_jax():
    jstate, st, jm, tm = _run_both("granite-34b", steps=1)
    assert st.params[0].dtype == torch.bfloat16
    assert all(m.dtype == torch.float32 for m in st.master)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[0][k]), float(jm[0][k]),
                                   rtol=2e-3, err_msg=k)
    got, want = convert.train_state_to_arrays(st), _np_tree(jstate)
    for (path, g), (_, w) in zip(_leaves(got[1].mu), _leaves(want[1].mu)):
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=0, atol=5e-2 * scale,
                                   err_msg=path)
    # the compute copies are the masters rounded to nearest even
    for p, m in zip(st.params, st.master):
        assert torch.equal(p.detach(), m.to(p.dtype))


FLASH = (("dtype", "float32"), ("attn_dense_threshold", 8),
         ("attn_flash_q_block", 8), ("attn_flash_kv_block", 8))


def test_flash_gradients_match_jax():
    """Sequences of 32 over blocks of 8: the flash path, with its masked
    blocks skipped, differentiated against JAX's."""
    cfg = _cfg("granite-34b", **dict(FLASH))
    b = _batch(cfg.vocab_size, 0, b=2, s=32)
    jmodel = JModel(cfg, remat=False)
    jloss = jts.make_loss_fn(jmodel, jts.TrainConfig())
    jgrads = jax.jit(jax.grad(lambda p, x: jloss(p, x)[0]))(
        _params("granite-34b"), _jx(b))
    st = convert.train_state_from_arrays(
        cfg, _np_tree(_jax_state("granite-34b")), CPU)
    loss, _ = tts.make_loss_fn(st.model, tts.TrainConfig())(_tx(b))
    grads = torch.autograd.grad(loss, st.params)
    got = convert._stack_tree(st.names, grads)
    for (path, g), (_, w) in zip(_leaves(got), _leaves(_np_tree(jgrads))):
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * scale,
                                   err_msg=path)


@pytest.mark.parametrize("arch,over", [
    ("granite-34b", FLASH), ("olmoe-1b-7b", (("dtype", "float32"),)),
    ("rwkv6-1.6b", (("dtype", "float32"),)),
    ("jamba-v0.1-52b", (("dtype", "float32"),))],
    ids=["granite-flash", "olmoe", "rwkv6", "jamba"])
def test_remat_on_equals_off_bitwise(arch, over):
    """Recomputing each block in the backward pass changes no bit of the
    gradients (granite's flash path runs its host-side block skip again in
    the recompute)."""
    cfg = tconfigs.get_smoke_config(arch)
    cfg = dataclasses.replace(cfg, **dict(over))
    b = _tx(_batch(cfg.vocab_size, 1, b=2, s=32))
    out = []
    for remat in (True, False):
        model = TModel(cfg, device="cpu", remat=remat,
                       generator=torch.Generator().manual_seed(0))
        st = tts.init_train_state(model)
        loss, _ = tts.make_loss_fn(model, tts.TrainConfig())(b)
        out.append((loss, torch.autograd.grad(loss, st.params)))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_eval_step_matches_the_train_loss():
    cfg = _cfg("granite-34b", dtype="float32")
    st = convert.train_state_from_arrays(
        cfg, _np_tree(_jax_state("granite-34b")), CPU)
    b = _tx(_batch(cfg.vocab_size, 0))
    loss = tts.make_eval_step(st.model, _tcfg())(b)
    assert not loss.requires_grad
    _, m = tts.make_train_step(st.model, _tcfg())(st, b)
    assert torch.equal(loss, m["loss"])


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

def test_memmap_batch_fn_matches_jax(tmp_path):
    path = str(tmp_path / "tokens.bin")
    np.random.default_rng(9).integers(0, 500, 4000).astype(np.int32).tofile(
        path)
    jfn = jdata.memmap_batch_fn(path, 16, 500)
    tfn = tdata.memmap_batch_fn(path, 16, 500)
    for step in (0, 3):
        want, got = jfn(step, 4, 16, 500, 2), tfn(step, 4, 16, 500, 2)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k])


def test_prefetching_loader_order_values_and_close():
    loader = tdata.PrefetchingLoader(tdata.bigram_batch, 2, 8, 100,
                                     start_step=5, seed=3, device="cpu")
    try:
        for want_step in (5, 6, 7, 8):
            step, batch = next(loader)
            assert step == want_step
            ref = jdata.bigram_batch(step, 2, 8, 100, 3)
            for k in ref:
                assert batch[k].device == CPU
                assert np.array_equal(batch[k].numpy(), ref[k])
    finally:
        loader.close()
    assert not loader._thread.is_alive()


def test_prefetching_loader_raises_a_failed_batch():
    def bad(step, *a):
        raise ValueError("no data")

    loader = tdata.PrefetchingLoader(bad, 2, 8, 100, device="cpu")
    try:
        with pytest.raises(RuntimeError, match="batch 0 failed"):
            next(loader)
    finally:
        loader.close()
    assert not loader._thread.is_alive()


# ---------------------------------------------------------------------------
# Entry points, in process, on the CPU
# ---------------------------------------------------------------------------

def test_launch_train_smoke_cpu_resumes(tmp_path, capsys):
    argv = ["--smoke", "--device", "cpu", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "3", "--log-every", "3", "--batch", "2",
            "--seq", "16"]
    m = tlaunch.main(argv + ["--steps", "6"])
    assert sorted(m) == ["aux", "grad_norm", "loss", "lr"]
    assert all(np.isfinite(v) for v in m.values())
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000003", "step_00000006"]
    tlaunch.main(argv + ["--steps", "8", "--microbatches", "2",
                         "--compression", "int8"])
    out = capsys.readouterr().out
    assert "start=0" in out and "start=6" in out
    assert (tmp_path / "step_00000008" / "manifest.json").exists()


def test_example_train_lm_cpu(tmp_path, capsys):
    out = train_lm.main(["--device", "cpu", "--steps", "3", "--batch", "2",
                         "--seq", "16", "--ckpt-dir", str(tmp_path)])
    assert out["steps"] == 3 and np.isfinite(out["last_loss"])
    assert "lm-22m: 12.6M params, resuming at step 0" in \
        capsys.readouterr().out
    again = train_lm.main(["--device", "cpu", "--steps", "4", "--batch",
                           "2", "--seq", "16", "--ckpt-dir", str(tmp_path)])
    assert again["steps"] == 1
