"""FSDP x TP training on the port against the port's one-device step and
JAX's sharded step: seven smoke configurations, each on the ranks of one
spawned ``gloo`` group of eight, each rank holding its float32 blocks of
the parameters and both AdamW moments under ``param_specs(...,
mode="train")`` (``repro_torch/distributed/fsdp.py``).

Layout "2d" on a ``(data=4, model=2)`` mesh for mistral-nemo, gemma3
(``q_norm``/``k_norm`` inside the heads' parallel region),
llama-3.2-vision (image embeddings) and qwen3-moe (8 experts over model=2:
expert parallelism); qwen2-moe on ``(2, 4)`` (6 experts: expert-TP, its
shared expert row-parallel); layout "dp_only" for xlstm-350m and
recurrentgemma-9b on ``(4, 2)``. Each case, on a batch of 8 x 24 tokens:
step 1 from the weights and step 2 from a carried state (moments of a
first step, AdamW's count 1), both with ``grad_accum=2``, and one
int8-compressed step from the weights with ``grad_accum=1`` (its metrics
carry the MoE's aux loss); then the sharded save of step 2's state and
its restore onto the transposed mesh. The JAX side (``tests/
_torch_dist_ref.py``'s ``train`` case, one subprocess a case) is the
reference's ``jax.jit`` of ``make_train_step(..., grad_specs=to_named(
pspec, mesh))`` with its inputs placed by the same specs on Auto meshes.

Each rank's blocks are held under ``tests/_torch_train.py``'s tolerances:
the metrics (loss, ce, aux, lr, grad_norm); every element of the first
moment within 2**-4 of its leaf's largest (the second within twice that);
the parameters by Adam's first-step rule at step 1, and at step 2 by the
update the moments give (``lr * m_hat / (sqrt(v_hat) + eps)`` from each
side's own moments, within ``PARAM_ATOL``); a compressed step's moments
also within one step of the int8 grid (:func:`check_step`). The MoE
one-device steps take their sharded steps' expert choices (recorded,
replayed; ``tests/_torch_fsdp.py::routing``), and so does JAX's sharded
step (its ``jax.lax.top_k`` patched in the test's subprocess,
``tests/_torch_dist_ref.py::replayed_top_k``), so that a router near-tie
flipped by another summation order does not decide the comparison; the
one-device steps' own choices part at 2-6 of 1536 pairs a call. The MoE
cases are then held to the tolerances as they are, against both sides.
Widened only to the gap JAX's own sharded step shows from its one-device
step, measured in the same subprocess (``WIDENED``, :func:`tolerances`):
llama-3.2-vision (its loss gap 2.48e-4 against 2e-4), against the
one-device step its loss and grad_norm, against JAX's sharded step every
rule. The restore is bit for bit. The planted fault -- a whole norm's
gradient summed over ``model`` as well as ``data`` -- must fail the same
check.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from _torch_dist import block, run_train  # noqa: E402
from _torch_fsdp import OPT_KW, PLANTED_LEAF, TRAIN_CASES, WIDENED, train_config  # noqa: E402
from _torch_train import (  # noqa: E402
    FIRM_M,
    GNORM_RTOL,
    GRAD_ELEM,
    LOSS_RTOL,
    PARAM_ATOL,
)

CASES = tuple(TRAIN_CASES)
STEPS = ("s1", "s2", "c")
B1, B2, EPS = 0.9, 0.95, 1e-8


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    return run_train(CASES, tmp_path_factory.mktemp("fsdp_train"), jax_procs=len(CASES))


def _cfg(name):
    from repro_torch.configs import get_smoke_config

    return train_config(name, get_smoke_config)


def _port(tree, name) -> dict:
    """A reference-layout tree of numpy arrays in the port's layout, by
    path."""
    from repro_torch.models import params_from_numpy
    from repro_torch.training.tree import flatten

    p = params_from_numpy(tree, _cfg(name), "cpu", dtype=torch.float32)
    return {k: v.numpy() for k, v in zip(*flatten(p))}


def _want(run, ref_side: bool, name) -> dict:
    if not ref_side:
        return run
    return dict(run, **{k: _port(run[k], name) for k in ("params", "m", "v")})


# the int8 scale is the stacked leaf's largest gradient over 127: one
# gradient element, which the element rule lets move by GRAD_ELEM of the
# largest, so the grid may stretch by as much
QUANT_DRIFT = GRAD_ELEM
TOL = {"loss": LOSS_RTOL, "grad_norm": GNORM_RTOL, "m": GRAD_ELEM, "v": 2 * GRAD_ELEM,
       "firm": PARAM_ATOL}


def _firm(m, scale):
    return np.abs(m) > max(GRAD_ELEM * scale, FIRM_M)


def jax_gaps(ref, name, key) -> dict:
    """JAX's own sharded step against its one-device step from the same
    start, in each rule's units: the losses' and the gradient norm's
    relative gaps, each moment's largest element gap over its leaf's
    largest, and (step 1) the largest parameter gap where the one-device
    step's first moment is firm."""
    sh, one = _want(ref[name][key], True, name), _want(ref[name]["one"][key], True, name)
    gaps = {k: abs(sh["metrics"][k] - one["metrics"][k]) / abs(one["metrics"][k])
            for k in ("loss", "grad_norm")}
    for t in ("m", "v"):
        gaps[t] = max(np.abs(sh[t][p] - one[t][p]).max() / np.abs(one[t][p]).max()
                      for p in one[t] if np.abs(one[t][p]).max() > 0)
    gaps["firm"] = max((np.abs(sh["params"][p] - one["params"][p])[
        _firm(one["m"][p], np.abs(one["m"][p]).max())].max(initial=0.0) for p in one["m"]))
    return gaps


def tolerances(ref, name, key) -> dict:
    """``TOL`` (``tests/_torch_train.py``'s), for a ``WIDENED`` case each
    widened to JAX's own gap where that is larger (:func:`jax_gaps`)."""
    if name not in WIDENED:
        return dict(TOL)
    gaps = jax_gaps(ref, name, key)
    return {k: max(v, gaps[k]) for k, v in TOL.items()}


def quant_steps(want, name) -> dict:
    """Per leaf, the int8 step of the compressed gradient: one scale per
    stacked leaf, ``amax / 127``, read back from the first moment of a
    step from zero moments (``m = (1 - b1) * q * scale``, ``|q|`` 127 at
    the stacked leaf's largest)."""
    from repro_torch.models.transformer import layer_slots, stacked_leaf

    slots = layer_slots(_cfg(name))
    keys = {p: stacked_leaf(p, want["m"][p].ndim, slots)[0] for p in want["m"]}
    top = {}
    for p, k in keys.items():
        top[k] = max(top.get(k, 0.0), float(np.abs(want["m"][p]).max()))
    return {p: top[k] / ((1 - B1) * 127) for p, k in keys.items()}


def check_step(got, want, coord, sizes, specs, count, what, tol=TOL, quant=None):
    """``got`` (a rank's blocks and metrics after one step) against
    ``want`` (the whole trees, the port's layout, of a step from the same
    start); ``count`` AdamW's step count at the start. ``quant`` (a
    compressed step: :func:`quant_steps`): a gradient element at a rounding
    boundary of the int8 grid may land one step ``s`` apart, and the grid
    itself moves with the shared scale (the stacked leaf's largest
    gradient, ``QUANT_DRIFT`` of it), so the first moment may also part by
    ``(1 - b1) s'`` and the second by ``(1 - b2) s' (2 |g| + s')``, ``s' = s
    + QUANT_DRIFT (|g| + s)`` (the element a grid step either way)."""
    lr = want["metrics"]["lr"]
    for k in ("loss", "ce", "aux"):
        a, b = got["metrics"][k], want["metrics"][k]
        assert abs(a - b) <= tol["loss"] * abs(b), f"{what} {k}: {a} against {b}"
    assert abs(got["metrics"]["lr"] - lr) <= 1e-7 * lr, what
    a, b = got["metrics"]["grad_norm"], want["metrics"]["grad_norm"]
    assert abs(a - b) <= tol["grad_norm"] * abs(b), f"{what} grad_norm: {a} against {b}"
    t = count + 1
    c1, c2 = 1 - B1 ** t, 1 - B2 ** t
    for path, spec in specs.items():
        w = path + f" ({what})"
        m0 = block(want["m"][path], spec, coord, sizes)
        v0 = block(want["v"][path], spec, coord, sizes)
        p0 = block(want["params"][path], spec, coord, sizes)
        m1, v1, p1 = got["m"][path], got["v"][path], got["params"][path]
        scale = np.abs(want["m"][path]).max()
        m_tol = np.full(m0.shape, tol["m"] * scale)
        v_tol = np.full(v0.shape, tol["v"] * np.abs(want["v"][path]).max())
        if quant is not None:
            q = quant[path] * (1 + 1e-6)
            g0 = np.abs(m0) / (1 - B1)
            step = q + QUANT_DRIFT * (g0 + q)
            m_tol = np.maximum(m_tol, (1 - B1) * step)
            v_tol = np.maximum(v_tol, (1 - B2) * step * (2 * g0 + step))
        bad = np.abs(m1 - m0) > m_tol
        assert not bad.any(), (f"m {w}: {bad.sum()} of {bad.size} elements past the tolerance, "
                               f"worst {np.abs(m1 - m0).max()} against {m_tol.min()}")
        bad = np.abs(v1 - v0) > v_tol
        assert not bad.any(), (f"v {w}: {bad.sum()} of {bad.size} elements past the tolerance, "
                               f"worst {np.abs(v1 - v0).max()} against {v_tol.min()}")
        if count == 0:
            firm = _firm(m0, scale)
            np.testing.assert_allclose(p1[firm], p0[firm], rtol=0, atol=tol["firm"],
                                       err_msg="params " + w)
            assert np.abs(p1 - p0).max() <= 2 * lr * (1 + 1e-3) + PARAM_ATOL, "params " + w
        else:
            def update(m, v):
                m, v = m.astype(np.float64), v.astype(np.float64)
                return lr * (m / c1) / (np.sqrt(v / c2) + EPS)

            np.testing.assert_allclose(p1 - p0, -(update(m1, v1) - update(m0, v0)), rtol=0,
                                       atol=PARAM_ATOL, err_msg="params " + w)


def one_device(ranks, name, key):
    """The port's one-device step ``key`` (each ran on one of ranks 0-2)."""
    return ranks[STEPS.index(key)][name]["one"][key]


def _rank_args(r, name):
    shape = TRAIN_CASES[name][1]
    sizes = {"data": shape[0], "model": shape[1]}
    return dict(zip(("data", "model"), r[name]["coord"])), sizes, r[name]["specs"]


@pytest.mark.parametrize("key", STEPS)
@pytest.mark.parametrize("name", CASES)
def test_step_matches_one_device(both, name, key):
    _, ref, ranks = both
    want = one_device(ranks, name, key)
    quant = quant_steps(want, name) if key == "c" else None
    wide = tolerances(ref, name, key)
    tol = dict(TOL, loss=wide["loss"], grad_norm=wide["grad_norm"])
    for i, r in enumerate(ranks):
        coord, sizes, specs = _rank_args(r, name)
        check_step(r[name][key], want, coord, sizes, specs, int(key == "s2"),
                   f"{name} {key} rank {i} against the one-device step", tol, quant)


@pytest.mark.parametrize("name", ("qwen3-moe", "qwen2-moe"))
def test_one_device_routing_replays_the_sharded_steps(both, name):
    # the one-device steps route as their sharded steps did (recorded and
    # replayed); their own choices part only at router near-ties
    _, _, ranks = both
    for key in STEPS:
        flipped, pairs, calls = one_device(ranks, name, key)["routing"]
        assert calls > 0 and flipped <= 0.01 * pairs, (key, flipped, pairs)


@pytest.mark.parametrize("key", STEPS)
@pytest.mark.parametrize("name", CASES)
def test_step_matches_jax_sharded(both, name, key):
    _, ref, ranks = both
    want, tol = _want(ref[name][key], True, name), tolerances(ref, name, key)
    quant = quant_steps(want, name) if key == "c" else None
    for i, r in enumerate(ranks):
        coord, sizes, specs = _rank_args(r, name)
        check_step(r[name][key], want, coord, sizes, specs, int(key == "s2"),
                   f"{name} {key} rank {i} against JAX's sharded step", tol, quant)


@pytest.mark.parametrize("name", CASES)
def test_metrics_are_global_on_every_rank(both, name):
    _, _, ranks = both
    for key in STEPS:
        assert all(r[name][key]["metrics"] == ranks[0][name][key]["metrics"] for r in ranks)


def _stacked_specs(name, sizes):
    """The train specs of the reference's stacked tree on a mesh of
    ``sizes``: a layer's spec behind the repeats' None."""
    from repro_torch.distributed.sharding import param_specs, spec_paths
    from repro_torch.distributed.tensor_parallel import abstract_params
    from repro_torch.models.transformer import layer_slots

    cfg = _cfg(name)
    mesh = type("FakeMesh", (), {"shape": sizes})()
    specs = spec_paths(param_specs(abstract_params(cfg), mesh, cfg, TRAIN_CASES[name][2]))
    slots = layer_slots(cfg)
    out = {}
    for path, spec in specs.items():
        if path.startswith("layers/"):
            _, i, rest = path.split("/", 2)
            si, pi = slots[int(i)]
            out[f"stages/{si}/{pi}/{rest}"] = (None,) + tuple(spec)
        else:
            out[path] = tuple(spec)
    return out


@pytest.mark.parametrize("name", CASES)
def test_restore_across_mesh_shapes_bit_for_bit(both, name):
    from repro_torch.models.transformer import layer_slots

    inputs, _, ranks = both
    d = f"{inputs['cases'][name]['ckpt']}/{name}/step_00000002"
    manifest = json.loads(open(f"{d}/manifest.json").read())
    shape = TRAIN_CASES[name][1]
    from repro_torch.training.tree import flatten

    pn = inputs["cases"][name]["params"]
    assert manifest["paths"] == flatten({"params": pn, "opt": {"m": pn, "v": pn, "step": 0}})[0]
    with np.load(f"{d}/arrays.npz") as data:
        saved = {p: data[f"a{i}"] for i, p in enumerate(manifest["paths"])}
    assert saved["opt/step"] == 2 and manifest["extra"] == {"data_step": 2}
    # the saved leaves are the (data, model) ranks' blocks of step 2, whole
    slots = layer_slots(_cfg(name))
    for r in ranks:
        coord, sizes, specs = _rank_args(r, name)
        for tree, prefix in (("params", "params"), ("m", "opt/m"), ("v", "opt/v")):
            for path, spec in specs.items():
                if path.startswith("layers/"):
                    _, i, rest = path.split("/", 2)
                    si, pi = slots[int(i)]
                    reps = [j for j, s in enumerate(slots) if s == (si, pi)]
                    whole = saved[f"{prefix}/stages/{si}/{pi}/{rest}"][reps.index(int(i))]
                else:
                    whole = saved[f"{prefix}/{path}"]
                assert np.array_equal(block(whole, spec, coord, sizes), r[name]["s2"][tree][path]), \
                    (name, prefix, path)
    # each rank's restored blocks on the transposed mesh
    other = {"data": shape[1], "model": shape[0]}
    specs = _stacked_specs(name, other)
    for r in ranks:
        got = r[name]["restored"]
        assert got["extra"] == {"data_step": 2}
        coord = dict(zip(("data", "model"), got["coord"]))
        for path, arr in got["tree"].items():
            if path == "opt/step":
                assert arr == 2
                continue
            key = path.split("/", 1)[1] if path.startswith("params/") else path.split("/", 2)[2]
            assert np.array_equal(arr, block(saved[path], specs[key], coord, other)), (name, path)


@pytest.mark.parametrize("name", CASES)
def test_sharded_save_gathers_one_replica_of_each_block(both, name):
    # every element of a leaf that some axis splits is sent to the writer
    # once, from its device: the ranks holding another replica of a block
    # (dp_only's leaves are whole over model) send nothing
    inputs, _, ranks = both
    d = f"{inputs['cases'][name]['ckpt']}/{name}/step_00000002"
    manifest = json.loads(open(f"{d}/manifest.json").read())
    shape = TRAIN_CASES[name][1]
    sizes = {"data": shape[0], "model": shape[1]}
    specs = _stacked_specs(name, sizes)
    whole = 0
    with np.load(f"{d}/arrays.npz") as data:
        for i, path in enumerate(manifest["paths"]):
            if path == "opt/step":
                continue
            key = path.split("/", 1)[1] if path.startswith("params/") else path.split("/", 2)[2]
            if any(a in sizes and sizes[a] > 1 for e in specs[key] if e is not None
                   for a in ((e,) if isinstance(e, str) else e)):
                whole += data[f"a{i}"].size
    sent = [n for r in ranks for n, _ in r[name]["save_sent"]]
    assert sum(sent) == whole
    assert {dev for r in ranks for _, dev in r[name]["save_sent"]} == {"cpu"}


def test_planted_wrong_axis_sum_fails(both):
    _, _, ranks = both
    name = "mistral-nemo"
    failed = []
    for i, r in enumerate(ranks):
        coord, sizes, specs = _rank_args(r, name)
        with pytest.raises(AssertionError) as exc:
            check_step(r[name]["planted"], one_device(ranks, name, "s1"), coord, sizes, specs, 0,
                       f"planted rank {i}")
        failed.append(str(exc.value))
        # the planted leaf's first moment: twice its gradient on model=2
        m0 = block(one_device(ranks, name, "s1")["m"][PLANTED_LEAF], specs[PLANTED_LEAF], coord,
                   sizes)
        gap = np.abs(r[name]["planted"]["m"][PLANTED_LEAF] - m0).max()
        assert gap > GRAD_ELEM * np.abs(m0).max(), (i, gap)
        assert np.abs(r[name]["s1"]["m"][PLANTED_LEAF] - m0).max() <= GRAD_ELEM * np.abs(m0).max()
    assert all(PLANTED_LEAF in msg or "grad_norm" in msg for msg in failed), failed


def test_refusals(both):
    _, _, ranks = both
    refused = ranks[0]["refused"]
    assert "item 16.4" in refused["recurrent_2d"] and "rglru" in refused["recurrent_2d"]
    assert "train specs" in refused["grad_specs"]
    assert "no mesh" in refused["no_mesh"]


def test_lr_is_the_schedule(both):
    _, ref, ranks = both
    for name in CASES:
        assert ranks[0][name]["s1"]["metrics"]["lr"] == pytest.approx(OPT_KW["lr"], rel=1e-7)
        assert ref[name]["s1"]["metrics"]["lr"] == pytest.approx(OPT_KW["lr"], rel=1e-7)
