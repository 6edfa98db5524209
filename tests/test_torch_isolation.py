"""The port stands alone: with JAX made unimportable, every ``repro_torch``
module and ``chip_smoke.py`` import, and nothing of the JAX package
``repro`` gets loaded. And ``chip_smoke.py`` refuses to report a result
without a card, or without the rest of the repository."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, json, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.path.insert(0, {src!r})
sys.path.insert(0, {root!r})
import repro_torch
names = ["repro_torch"] + [
    m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")
]
for name in names:
    importlib.import_module(name)
import chip_smoke
import repro_torch.configs, repro_torch.kernels.build, repro_torch.kernels.lean_decode
import repro_torch.kernels.lean_prefill, repro_torch.kernels.flash_decode
import repro_torch.kernels.flash_prefill, repro_torch.kernels.ops
import repro_torch.models, repro_torch.serving.engine, repro_torch.serving.scheduler
import repro_torch.obs.__main__, repro_torch.obs.report, repro_torch.obs.watch
import repro_torch.roofline.analysis
obs = sorted(n for n in names if n.startswith(("repro_torch.obs", "repro_torch.roofline",
                                               "repro_torch.serving.guards",
                                               "repro_torch.serving.faults")))
leaked = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
print(json.dumps({{"modules": len(names), "obs": obs, "leaked": leaked}}))
"""


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_port_imports_without_jax_or_repro():
    probe = _PROBE.format(src=str(ROOT / "src"), root=str(ROOT))
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         timeout=300, env=_env(), cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["modules"] >= 39, res
    # the observability layer, the roofline, the guards and the fault
    # injector are the port's own copies
    assert {"repro_torch.obs.trace", "repro_torch.obs.metrics", "repro_torch.obs.flight",
            "repro_torch.obs.watch", "repro_torch.obs.calib", "repro_torch.obs.report",
            "repro_torch.obs.__main__", "repro_torch.roofline.analysis",
            "repro_torch.serving.guards", "repro_torch.serving.faults"} <= set(res["obs"])
    assert res["leaked"] == [], f"repro modules loaded by the port: {res['leaked']}"


def _smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True, text=True,
                          timeout=300, env=_env(), cwd=str(cwd))


def _prints_no_result(out):
    lines = out.stdout.strip().splitlines()
    if not lines:
        return True
    try:
        return not json.loads(lines[-1]).get("ok")
    except ValueError:
        return True


def test_chip_smoke_fails_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = _smoke(ROOT)
    assert out.returncode != 0
    assert _prints_no_result(out)


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _smoke(tmp_path)
    assert out.returncode != 0
    assert _prints_no_result(out)
