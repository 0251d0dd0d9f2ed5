"""The port stands alone: importing every ``repro_torch`` module loads
neither ``jax`` nor any module of the JAX package ``repro``."""

import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"

_PROBE = """
import importlib, os, pkgutil, sys
flags = os.environ.get("XLA_FLAGS")
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro."))
print(len(names))
print(",".join(bad))
print(",".join(names))
print(os.environ.get("XLA_FLAGS") == flags)
"""


def test_port_imports_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True, text=True,
                         env=env, timeout=120, check=True)
    n_modules, bad, names, flags_kept = (out.stdout.splitlines() + ["", "", ""])[:4]
    assert int(n_modules) >= 24
    assert bad == "", f"repro_torch loaded {bad}"
    for module in ("core.dim", "kernels.gemv_int8", "kernels.gemv_int4",
                   "kernels.dim_kernel", "optim.adamw", "train.trainstep", "train.trainer",
                   "data.pipeline", "checkpoint.ckpt", "distributed.resilience",
                   "launch.train", "launch.dryrun", "launch.hlo_stats", "tree",
                   "sharding.partitioning", "launch.mesh", "core.transfer",
                   "distributed.mesh", "distributed.collectives", "distributed.pipeline",
                   "examples.train_resilient"):
        assert f"repro_torch.{module}" in names.split(",")
    assert flags_kept == "True", "a repro_torch module set XLA_FLAGS"


def test_tensor_parallel_rank_imports_neither_jax_nor_repro():
    """A spawned rank of tests/test_torch_tp.py (its module and everything it
    loads when it runs) stays clear of JAX and the reference."""
    probe = ("import sys; sys.path.insert(0, %r); import _torch_tp_rank\n"
             "from repro_torch import configs, convert\n"
             "from repro_torch.core import transfer\n"
             "from repro_torch.distributed import mesh\n"
             "from repro_torch.serve import engine\n"
             "print(','.join(sorted(m for m in sys.modules if m == 'jax' or "
             "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))))"
             % str(Path(__file__).resolve().parent))
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         env=env, timeout=120, check=True)
    assert out.stdout.strip() == ""


def test_mesh_training_rank_imports_neither_jax_nor_repro():
    """A spawned rank of tests/test_torch_distributed.py, with the modules it
    runs, stays clear of JAX and the reference."""
    probe = ("import sys; sys.path.insert(0, %r); import _torch_train_rank\n"
             "from repro_torch.distributed import collectives, mesh, pipeline\n"
             "from repro_torch.train import trainer, trainstep\n"
             "print(','.join(sorted(m for m in sys.modules if m == 'jax' or "
             "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))))"
             % str(Path(__file__).resolve().parent))
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         env=env, timeout=120, check=True)
    assert out.stdout.strip() == ""
