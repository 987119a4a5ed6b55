"""The PyTorch port and chip_smoke.py stand alone: importing every module of
``deepmusicgeneration_tpu_torch`` and ``chip_smoke`` loads neither JAX, flax,
msgpack nor any module of the JAX package (the card's machine has none of
them)."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, pkgutil, sys
import deepmusicgeneration_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
         if not m.name.endswith("__main__")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "msgpack",
                                    "deepmusicgeneration_tpu"))
print(len(names), "modules;", "forbidden:", bad)
assert not bad, bad
"""


def test_port_and_chip_smoke_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "forbidden: []" in proc.stdout


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Without CUDA (this host) the smoke script exits non-zero and prints no
    result line; alone in a directory it cannot even import the port."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run for real")
    script = os.path.join(ROOT, "chip_smoke.py")
    proc = subprocess.run([sys.executable, script], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(Path(script).read_text())
    proc = subprocess.run([sys.executable, str(lone)], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120,
                          env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
