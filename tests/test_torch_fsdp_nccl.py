"""The sharded checkpoint over NCCL, the backend of the port's training on
several cards: ranks, one a card, draw a smoke config's float32 training
state as their blocks under the train specs, save it with
``save_checkpoint(..., shardings=, mesh=)`` -- each block gathered on its
card to rank 0 over the axes its leaf splits on -- and restore it onto
another mesh shape. The saved arrays must equal a one-device save of the
same state, and every restored block its slice of them, bit for bit.

Needs two CUDA cards or more (NCCL refuses two ranks on one card) and
skips elsewhere; run it on such a machine with ``pytest -m cuda
tests/test_torch_fsdp_nccl.py``. The CPU tests hold the same save over
gloo (``tests/test_torch_fsdp_train.py``).
"""
import json
import os
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ARCH = "mistral-nemo-12b"
# world -> (the saving mesh, the restoring mesh), over (data, model)
MESHES = {2: ((2, 1), (1, 2)), 4: ((2, 2), (4, 1))}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank(rank: int, world: int, port: int, out: str) -> None:
    import torch.distributed as dist

    from repro_torch.configs import get_smoke_config
    from repro_torch.core.distributed import shard_of
    from repro_torch.distributed.fsdp import FSDP
    from repro_torch.distributed.sharding import spec_paths
    from repro_torch.distributed.tensor_parallel import abstract_params
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.training import (init_train_state, restore_checkpoint, save_checkpoint,
                                      train_state_shardings, train_state_to_numpy)
    from repro_torch.training.tree import flatten

    torch.cuda.set_device(rank)
    init_distributed(rank, world, port, "nccl")
    try:
        cfg = get_smoke_config(ARCH)
        shape, other = MESHES[world]
        mesh = make_mesh(shape, ("data", "model"), "cuda")
        fs = FSDP(cfg, mesh, "2d")
        gen = torch.Generator(device="cuda").manual_seed(3)
        params, opt = init_train_state(cfg, gen, "cuda", shard=fs.block)
        state, shardings = train_state_shardings(params, opt, cfg, fs.train_specs)
        save_checkpoint(os.path.join(out, "sharded"), 1, state, shardings=shardings, mesh=mesh)
        if rank == 0:               # the same draw whole on one card, saved there
            whole = init_train_state(cfg, torch.Generator(device="cuda").manual_seed(3), "cuda")
            save_checkpoint(os.path.join(out, "whole"), 1, train_state_to_numpy(*whole, cfg))
        dist.barrier()
        fo = FSDP(cfg, make_mesh(other, ("data", "model"), "cuda"), "2d")
        like = abstract_params(cfg)
        meta = {"m": like, "v": like, "step": torch.zeros((), dtype=torch.int32, device="meta")}
        like_state, specs = train_state_shardings(like, meta, cfg, fo.train_specs)
        got, _ = restore_checkpoint(os.path.join(out, "sharded"), like_state, device="cuda",
                                    shardings=specs, mesh=fo.mesh)
        with np.load(os.path.join(out, "whole", "step_00000001", "arrays.npz")) as data:
            paths = flatten(like_state)[0]
            want = {p: torch.from_numpy(data[f"a{i}"]) for i, p in enumerate(paths)}
        bad = [p for p, t in zip(*flatten(got))
               if not torch.equal(t.cpu(), shard_of(want[p], spec_paths(specs)[p], fo.mesh))]
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump({"bad": bad, "leaves": len(paths)}, f)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_sharded_save_and_restore_over_nccl(tmp_path):
    import torch.distributed as dist
    import torch.multiprocessing as mp

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2 or not dist.is_nccl_available():
        pytest.skip("needs two CUDA cards and NCCL (NCCL refuses two ranks on one card)")
    world = 4 if n >= 4 else 2
    mp.spawn(_rank, args=(world, _free_port(), str(tmp_path)), nprocs=world)
    d = tmp_path / "sharded" / "step_00000001"
    w = tmp_path / "whole" / "step_00000001"
    assert json.loads((d / "manifest.json").read_text())["paths"] == \
        json.loads((w / "manifest.json").read_text())["paths"]
    with np.load(d / "arrays.npz") as a, np.load(w / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k
    for r in range(world):
        res = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert res["bad"] == [] and res["leaves"] > 0, (r, res)
