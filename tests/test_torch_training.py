"""The port's training substrate against the JAX package: the data
pipeline array for array, an 8-step loss trajectory, checkpoints that
cross between the packages both ways, exact resume, retention and async
saves, the train -> checkpoint -> restart -> serve lifecycle
(``tests/test_system.py:22``) on the port, the CLI, and the analytic
counts (``count_active_params``, ``model_flops_for``, ``SHAPES``)."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS as JAX_ARCHS, get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.configs.shapes import SHAPES as JAX_SHAPES, shape_applicable as jax_applicable  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models import count_active_params as jcount_active, init_params as jinit  # noqa: E402
from repro.roofline.analysis import model_flops_for as jflops  # noqa: E402
from repro.training import checkpoint as jckpt, optimizer as jopt  # noqa: E402
from repro.training.train_loop import make_train_step as jmake_step  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config  # noqa: E402
from repro_torch.configs.shapes import SHAPES, shape_applicable  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.models import (  # noqa: E402
    count_active_params,
    params_for_serving,
    params_from_numpy,
    params_to_numpy,
)
from repro_torch.roofline.analysis import model_flops_for  # noqa: E402
from repro_torch.serving.config import EngineConfig, PagedConfig  # noqa: E402
from repro_torch.serving.engine import DecodeEngine, Request  # noqa: E402
from repro_torch import training as T  # noqa: E402
from repro_torch.training.tree import flatten  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# trajectories part through Adam's first step: an element whose gradient
# sits at bf16 rounding noise moves by lr * sign(g) with the sign a coin
# toss (tests/_torch_train.py); measured at most 2.1e-3 over 8 steps
TRAJ_RTOL = 1e-2


def _tb(b, dev="cpu"):
    return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _cpu_gen(seed):
    return torch.Generator(device="cpu").manual_seed(seed)


@pytest.mark.parametrize("kw", [
    dict(vocab_size=128, seq_len=16, global_batch=8, seed=3),
    dict(vocab_size=131072, seq_len=33, global_batch=4, seed=0),
    dict(vocab_size=128, seq_len=3, global_batch=2, seed=7),
    dict(vocab_size=128, seq_len=24, global_batch=2, seed=5, img_tokens=6, d_model=64),
])
def test_pipeline_matches_jax_package(kw):
    """Every batch, shard and stub image embedding equal, array for array."""
    cj, ct = jpipe.DataConfig(**kw), tpipe.DataConfig(**kw)
    for step in (0, 7, 123456):
        for shard, n in ((0, 1), (1, 2)):
            a, b = jpipe.batch_at(cj, step, shard, n), tpipe.batch_at(ct, step, shard, n)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
    it_j, it_t = jpipe.iterate(cj, 5), tpipe.iterate(ct, 5)
    for _ in range(3):
        np.testing.assert_array_equal(next(it_j)["tokens"], next(it_t)["tokens"])


def _trajectory_setup():
    cj, ct = jax_smoke("mistral-nemo-12b"), get_smoke_config("mistral-nemo-12b")
    dc = tpipe.DataConfig(vocab_size=ct.vocab_size, seq_len=32, global_batch=8)
    return cj, ct, dc, dict(lr=1e-2, warmup_steps=2, total_steps=8)


def test_eight_step_trajectory_matches_jax():
    cj, ct, dc, okw = _trajectory_setup()
    pj = jinit(jax.random.PRNGKey(0), cj)
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), ct, "cpu", dtype=torch.float32)
    oj, ot = jopt.adamw_init(pj), T.adamw_init(pt)
    sj = jax.jit(jmake_step(cj, jopt.OptConfig(**okw)))
    st = T.make_train_step(ct, T.OptConfig(**okw))
    lj, lt = [], []
    for i in range(8):
        b = tpipe.batch_at(dc, i)
        pj, oj, mj = sj(pj, oj, _jb(b))
        pt, ot, mt = st(pt, ot, _tb(b))
        lj.append(float(mj["loss"]))
        lt.append(float(mt["loss"]))
    np.testing.assert_allclose(lt, lj, rtol=TRAJ_RTOL)
    assert lt[-1] < 0.9 * lt[0] and lj[-1] < 0.9 * lj[0], (lt, lj)


def _train(ct, dc, okw, params, opt, start, steps):
    st = T.make_train_step(ct, T.OptConfig(**okw))
    losses = []
    for i in range(start, start + steps):
        params, opt, m = st(params, opt, _tb(tpipe.batch_at(dc, i)))
        losses.append(float(m["loss"]))
    return params, opt, losses


def test_exact_resume(tmp_path):
    """6 steps straight == 3 + save + restore into fresh tensors + 3, bit
    for bit: the losses, the parameters and the optimizer state."""
    _, ct, dc, okw = _trajectory_setup()
    p, o = T.init_train_state(ct, _cpu_gen(0), "cpu")
    p, o, l_straight = _train(ct, dc, okw, p, o, 0, 6)
    q, r = T.init_train_state(ct, _cpu_gen(0), "cpu")
    q, r, l_first = _train(ct, dc, okw, q, r, 0, 3)
    T.save_checkpoint(tmp_path, 3, T.train_state_to_numpy(q, r, ct), extra={"data_step": 3})
    fresh = T.init_train_state(ct, _cpu_gen(99), "cpu")
    state, extra = T.restore_checkpoint(tmp_path, T.train_state_to_numpy(*fresh, ct), device="cpu")
    assert extra == {"data_step": 3}
    q, r = T.train_state_from_numpy(state, ct, "cpu")
    q, r, l_rest = _train(ct, dc, okw, q, r, 3, 3)
    assert l_first + l_rest == l_straight
    for a, b in zip(flatten(T.train_state_to_numpy(p, o, ct))[1],
                    flatten(T.train_state_to_numpy(q, r, ct))[1]):
        np.testing.assert_array_equal(a, b)


def test_checkpoint_retention_latest_and_async(tmp_path):
    ct = get_smoke_config("mistral-nemo-12b")
    p = T.init_train_state(ct, _cpu_gen(0), "cpu")[0]
    tree = {"p": params_to_numpy(p, ct)}
    assert T.latest_step(tmp_path) is None
    for s in (1, 2, 3, 4):
        T.save_checkpoint(tmp_path, s, tree, keep=2)
    assert sorted(d.name for d in tmp_path.glob("step_*")) == ["step_00000003", "step_00000004"]
    assert not list(tmp_path.glob(".tmp-*"))
    assert T.latest_step(tmp_path) == 4
    t = T.save_checkpoint(tmp_path, 5, tree, block=False)
    t.join(timeout=30)
    assert not t.is_alive()
    restored, _ = T.restore_checkpoint(tmp_path, tree, device="cpu")
    for a, b in zip(flatten(tree)[1], flatten(restored)[1]):
        np.testing.assert_array_equal(a, b.numpy())
    with pytest.raises(FileNotFoundError):
        T.restore_checkpoint(tmp_path / "none", tree, device="cpu")
    with pytest.raises(ValueError, match="first differing path"):
        T.restore_checkpoint(tmp_path, {"q": tree["p"]}, device="cpu")


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "xlstm-350m", "llama-3.2-vision-11b"])
def test_checkpoints_cross_between_packages(arch, tmp_path):
    """A checkpoint the JAX trainer wrote, restored by the port, and one the
    port wrote, restored by ``repro.training.checkpoint.restore_checkpoint``:
    the same manifest paths, the same arrays and dtypes."""
    cj, ct = jax_smoke(arch), get_smoke_config(arch)
    pj = jinit(jax.random.PRNGKey(1), cj)
    oj = jopt.adamw_init(pj)
    b = tpipe.batch_at(tpipe.DataConfig(vocab_size=cj.vocab_size, seq_len=12, global_batch=2,
                                        img_tokens=cj.cross_kv_len, d_model=cj.d_model), 0)
    pj, oj, _ = jax.jit(jmake_step(cj))(pj, oj, _jb(b))        # a nonzero step and moments
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jckpt.save_checkpoint(jdir, 1, {"params": pj, "opt": oj}, extra={"data_step": 1})
    # JAX -> port
    p0, o0 = T.init_train_state(ct, _cpu_gen(0), "cpu")
    state, extra = T.restore_checkpoint(jdir, T.train_state_to_numpy(p0, o0, ct), device="cpu")
    assert extra == {"data_step": 1}
    pt, ot = T.train_state_from_numpy(state, ct, "cpu")
    want = jax.tree.map(np.asarray, {"params": pj, "opt": oj})
    got = T.train_state_to_numpy(pt, ot, ct)
    paths_w, lw = flatten(want)
    paths_g, lg = flatten(got)
    assert paths_g == paths_w
    for path, a, c in zip(paths_w, lw, lg):
        assert a.dtype == c.dtype, path
        np.testing.assert_array_equal(a, c, err_msg=path)
    # port -> JAX
    T.save_checkpoint(tdir, 1, got, extra={"data_step": 1})
    mj = json.loads((jdir / "step_00000001" / "manifest.json").read_text())
    mt = json.loads((tdir / "step_00000001" / "manifest.json").read_text())
    assert mt["paths"] == mj["paths"] and mt["num_leaves"] == mj["num_leaves"]
    fresh = jinit(jax.random.PRNGKey(9), cj)
    back, extra = jckpt.restore_checkpoint(tdir, {"params": fresh, "opt": jopt.adamw_init(fresh)})
    assert extra == {"data_step": 1}
    for a, c in zip(jax.tree.leaves(want), jax.tree.leaves(back)):
        assert a.dtype == np.asarray(c).dtype
        np.testing.assert_array_equal(a, np.asarray(c))


def test_train_checkpoint_restart_serve_lifecycle(tmp_path):
    """``tests/test_system.py:22`` on the port: gemma3's smoke config trains
    12 steps (the loss falls), saves, restores into fresh tensors, takes a
    finite step, and the trained weights serve through the port's engine on
    the CPU."""
    cfg = get_smoke_config("gemma3-4b")
    dc = tpipe.DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    params, opt = T.init_train_state(cfg, _cpu_gen(0), "cpu")
    step = T.make_train_step(cfg, T.OptConfig(lr=3e-3, warmup_steps=2))
    losses = []
    for i in range(12):
        params, opt, m = step(params, opt, _tb(tpipe.batch_at(dc, i)))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses
    T.save_checkpoint(tmp_path, 12, T.train_state_to_numpy(params, opt, cfg),
                      extra={"data_step": 12})
    fresh = T.init_train_state(cfg, _cpu_gen(99), "cpu")
    state, extra = T.restore_checkpoint(tmp_path, T.train_state_to_numpy(*fresh, cfg),
                                        device="cpu")
    assert extra["data_step"] == 12
    params2, opt2 = T.train_state_from_numpy(state, cfg, "cpu")
    _, _, m2 = step(params2, opt2, _tb(tpipe.batch_at(dc, 12)))
    assert np.isfinite(float(m2["loss"]))

    served = params_for_serving(params2)
    assert served["embed"].dtype == torch.bfloat16 and served["final_norm"].dtype == torch.float32
    same = params_from_numpy(params_to_numpy(params2, cfg), cfg, "cpu")
    for a, b in zip(flatten(served)[1], flatten(same)[1]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    eng = DecodeEngine(cfg, served, EngineConfig(max_batch=2, cache_len=64,
                                                 paged=PagedConfig(enabled=False)), device="cpu")
    reqs = [Request(uid=i, prompt=np.arange(5 + i) % cfg.vocab_size, max_new_tokens=4)
            for i in range(3)]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion(max_ticks=30)
    assert all(len(r.generated) == 4 for r in reqs)


def test_remat_does_not_change_gradients():
    """``cfg.remat`` recomputes each stage unit in the backward pass: the
    same loss and the same gradients, bit for bit."""
    ct = get_smoke_config("xlstm-350m")
    p = T.init_train_state(ct, _cpu_gen(0), "cpu")[0]
    b = _tb(tpipe.batch_at(tpipe.DataConfig(vocab_size=ct.vocab_size, seq_len=20,
                                            global_batch=2), 0))
    out = []
    for remat in (True, False):
        c = dataclasses.replace(ct, remat=remat)
        (l, _), g = T.value_and_grad(T.make_loss(c), p, b)
        out.append((l, flatten(g)[1]))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(x, y) for x, y in zip(out[0][1], out[1][1]))


def test_launch_train_cli_resumes(tmp_path):
    """``python -m repro_torch.launch.train --device cpu``: 4 steps with a
    checkpoint every 2, then a second process resumes from step 4."""
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "mistral-nemo-12b",
            "--smoke", "--device", "cpu", "--steps", "4", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2", "--log-every", "2"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    first = subprocess.run(base, capture_output=True, text=True, env=env, timeout=240)
    assert first.returncode == 0, first.stderr
    assert "step 4: loss=" in first.stdout and "resumed" not in first.stdout
    assert T.latest_step(tmp_path) == 4
    second = subprocess.run(base, capture_output=True, text=True, env=env, timeout=240)
    assert second.returncode == 0, second.stderr
    assert "resumed from step 4" in second.stdout and "step 8: loss=" in second.stdout
    assert T.latest_step(tmp_path) == 8


def test_counts_and_shapes_match_jax():
    """``count_active_params`` and ``model_flops_for`` on every full
    configuration and shape, and the shape table, as the reference's."""
    assert sorted(ARCH_IDS) == sorted(JAX_ARCHS)
    assert SHAPES.keys() == JAX_SHAPES.keys()
    for name, spec in SHAPES.items():
        assert dataclasses.astuple(spec) == dataclasses.astuple(JAX_SHAPES[name])
    for arch in ARCH_IDS:
        cj, ct = jax_config(arch), get_config(arch)
        assert count_active_params(ct) == jcount_active(cj), arch
        for name, spec in SHAPES.items():
            assert shape_applicable(arch, name) == jax_applicable(arch, name)
            assert model_flops_for(ct, spec, count_active_params(ct)) == \
                jflops(cj, JAX_SHAPES[name], jcount_active(cj)), (arch, name)
