"""The port's sharding policy and input specs against the reference's,
spec for spec, for all ten configurations at full size (shapes through
``jax.eval_shape`` on the reference's side, ``meta`` tensors on the
port's), on the meshes ``(16, 16)``, ``(2, 16, 16)``, ``(4, 2)`` and
``(2, 4)``. The policy is pure, so a duck-typed mesh stands in for a
device mesh, as in ``tests/test_hints_sharding.py``.

The port holds one entry per layer where the reference stacks a stage's
repeats, so a layer's spec is held to the reference's stacked spec without
its leading ``None`` (the repeats axis).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro.distributed import sharding as J  # noqa: E402
from repro.models import init_cache as jinit_cache, init_params as jinit  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.configs.shapes import SHAPES, input_specs, shape_applicable  # noqa: E402
from repro_torch.distributed import sharding as T  # noqa: E402
from repro_torch.models import init_cache, layer_kinds, params_from_numpy  # noqa: E402
from repro_torch.models.transformer import layer_slots  # noqa: E402


class FakeMesh:
    """Duck-typed mesh for pure spec logic."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESHES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "4x2": {"data": 4, "model": 2},
    "2x4": {"data": 2, "model": 4},
}
LAYOUTS = ("2d", "dp_only")
BATCHES = (1, 2, 3, 8, 32, 128, 256, 512)
DTYPES = {jnp.dtype(jnp.bfloat16): torch.bfloat16, jnp.dtype(jnp.float32): torch.float32,
          jnp.dtype(jnp.int32): torch.int32, jnp.dtype(jnp.int8): torch.int8}
CASES = [(a, m) for a in ARCH_IDS for m in MESHES]


@functools.lru_cache(maxsize=None)
def params_pair(arch):
    """The reference's parameter shapes and the port's tree of them on the
    ``meta`` device."""
    cfg = jget(arch)
    sds = jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0), cfg))
    meta = jax.tree.map(lambda s: torch.empty(s.shape, device="meta"), sds)
    return sds, params_from_numpy(meta, get_config(arch), device="meta")


def jax_paths(tree, is_leaf=None):
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", ""))) for k in kp): v
            for kp, v in flat}


def port_paths(tree, prefix=""):
    """``(path, spec)`` of every spec of the port's tree (a spec is a
    tuple: a leaf here)."""
    if isinstance(tree, T.P):
        return [(prefix, tree)]
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    return [pair for k, v in items for pair in port_paths(v, f"{prefix}/{k}".lstrip("/"))]


def ref_path(path, slots):
    """The reference's stacked path of the port's leaf at ``path``."""
    if not path.startswith("layers/"):
        return path, False
    _, i, rest = path.split("/", 2)
    si, pi = slots[int(i)]
    return f"stages/{si}/{pi}/{rest}", True


def held(port_spec, ref_spec, stacked):
    want = tuple(ref_spec)
    if stacked:
        assert want[0] is None, want
        want = want[1:]
    return tuple(port_spec) == want


@pytest.mark.parametrize("arch,mesh", CASES)
def test_param_specs_match(arch, mesh):
    """Both layouts, both modes, every leaf."""
    fake = FakeMesh(MESHES[mesh])
    sds, params = params_pair(arch)
    cfg = get_config(arch)
    slots = layer_slots(cfg)
    for layout in LAYOUTS:
        for mode in ("train", "serve"):
            want = jax_paths(J.param_specs(sds, fake, jget(arch), layout, mode),
                             is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
            seen = set()
            for path, spec in port_paths(T.param_specs(params, fake, cfg, layout, mode)):
                rp, stacked = ref_path(path, slots)
                seen.add(rp)
                assert held(spec, want[rp], stacked), (layout, mode, path, spec, want[rp])
            assert seen == set(want), set(want) ^ seen


@pytest.mark.parametrize("arch,mesh", CASES)
def test_decode_plan_and_cache_specs_match(arch, mesh):
    """``decode_plan`` at every batch and layout, and ``cache_specs`` of the
    dense cache of each decode shape the architecture runs, under that
    shape's plan and under no plan."""
    fake = FakeMesh(MESHES[mesh])
    cfg, jcfg = get_config(arch), jget(arch)
    for layout in LAYOUTS:
        for batch in BATCHES:
            assert T.decode_plan(cfg, fake, batch, layout) == J.decode_plan(jcfg, fake, batch,
                                                                            layout)
    slots, kinds = layer_slots(cfg), layer_kinds(cfg)
    for name, shape in SHAPES.items():
        if shape.kind != "decode" or not shape_applicable(arch, name):
            continue
        B, S = shape.global_batch, shape.seq_len
        jcache = jax.eval_shape(lambda: jinit_cache(jcfg, B, S))
        cache = init_cache(cfg, B, S, device="meta")
        for layout in LAYOUTS:
            for plan in (J.decode_plan(jcfg, fake, B, layout), None):
                want = J.cache_specs(jcache, fake, B, layout, plan, cache_len=S)
                got = T.cache_specs(cache, fake, B, layout, plan, cache_len=S)
                for i, (lc, (si, pi)) in enumerate(zip(got, slots)):
                    ref = want[si][pi]
                    assert set(lc) == set(ref), (i, kinds[i])
                    for leaf, spec in lc.items():
                        assert held(spec, ref[leaf], True), (name, layout, plan, i, leaf, spec,
                                                             ref[leaf])


@pytest.mark.parametrize("mesh", MESHES)
def test_batch_and_dp_specs_match(mesh):
    fake = FakeMesh(MESHES[mesh])
    for layout in LAYOUTS:
        assert T.dp_axes(fake, layout) == J.dp_axes(fake, layout)
        for dim in BATCHES + (4, 16, 64):
            assert T.best_dp_spec(dim, fake, layout) == J.best_dp_spec(dim, fake, layout)
            for img in (False, True):
                want = J.batch_specs(fake, dim, img, layout)
                got = T.batch_specs(fake, dim, img, layout)
                assert {k: tuple(v) for k, v in got.items()} == \
                    {k: tuple(v) for k, v in want.items()}


def test_choose_layout_matches():
    for arch in ARCH_IDS:
        assert T.choose_layout(get_config(arch)) == J.choose_layout(jget(arch)), arch


INPUT_CASES = [(a, s) for a in ARCH_IDS for s in SHAPES if shape_applicable(a, s)]


@pytest.mark.parametrize("arch,shape", INPUT_CASES)
def test_input_specs_match(arch, shape):
    """Shapes and dtypes of every input, the cache's layer by layer (each
    the reference's stacked leaf without its repeats axis); all on the
    ``meta`` device."""
    cfg = get_config(arch)
    want = jshapes.input_specs(jget(arch), shape)
    got = input_specs(cfg, shape)
    assert set(got) == set(want)
    for name in got:
        if name == "cache":
            continue
        assert got[name].device.type == "meta"
        assert tuple(got[name].shape) == tuple(want[name].shape), name
        assert got[name].dtype == DTYPES[jnp.dtype(want[name].dtype)], name
    if "cache" in got:
        for lc, (si, pi) in zip(got["cache"], layer_slots(cfg)):
            ref = want["cache"][si][pi]
            assert set(lc) == set(ref)
            for leaf, t in lc.items():
                assert t.device.type == "meta"
                assert tuple(t.shape) == tuple(ref[leaf].shape[1:]), (leaf, t.shape)
                assert t.dtype == DTYPES[jnp.dtype(ref[leaf].dtype)], leaf


def test_to_named_places_shards():
    """A spec's DTensor placements: ``Shard(i)`` on each mesh dimension
    that splits tensor dimension ``i``; a tuple of axes out of the mesh's
    order is refused."""
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("data", "model")

    P = T.P
    got = T.to_named({"a": P("model", "data"), "b": [P(None, ("data", "model")), P()]}, Mesh())
    assert got == {"a": (Shard(1), Shard(0)), "b": [(Shard(1), Shard(1)),
                                                    (Replicate(), Replicate())]}
    with pytest.raises(ValueError):
        T.to_named(P(("model", "data")), Mesh())
    assert repr(P("data", None)) == "P('data', None)"
    assert tuple(P("data", None)) == tuple(jax.sharding.PartitionSpec("data", None))


def test_make_prefill_step_is_prefill():
    """``make_prefill_step`` is the model's prefill into a cache of the
    given length."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve_step import make_prefill_step
    from repro_torch.models import init_params, prefill

    cfg = get_smoke_config("gemma3-4b")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 9)))
    lg, cache, n = make_prefill_step(cfg, 16)(params, toks)
    lw, want, nw = prefill(params, cfg, toks, cache_len=16)
    assert n == nw == 9 and torch.equal(lg, lw)
    for a, b in zip(cache, want):
        assert all(torch.equal(a[k], b[k]) for k in b)
