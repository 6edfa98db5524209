"""Train a small LM with the PyTorch port (the reduced mistral-nemo
config), with a checkpoint and a restart mid-run: 100 steps, then a fresh
process resumes from the latest checkpoint and runs 100 more. The
counterpart of ``examples/train_lm.py``; on the card by default:

  PYTHONPATH=src python examples/train_lm_torch.py [--device cpu]
"""
import argparse
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

ckpt = Path(tempfile.gettempdir()) / "repro_torch_train_lm_ckpt"
if ckpt.exists():
    shutil.rmtree(ckpt)

base = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "mistral-nemo-12b",
        "--smoke", "--device", args.device, "--batch", "8", "--seq", "64",
        "--ckpt-dir", str(ckpt), "--ckpt-every", "50", "--log-every", "20"]
env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

print("== phase 1: 100 steps ==")
subprocess.run(base + ["--steps", "100"], check=True, env=env)
print("== phase 2: resume (simulated restart) + 100 steps ==")
subprocess.run(base + ["--steps", "100"], check=True, env=env)
print("training with restart complete; checkpoints in", ckpt)
