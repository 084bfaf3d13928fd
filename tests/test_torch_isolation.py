"""The port depends on nothing of the JAX package: in a fresh interpreter
where importing ``jax``, ``jaxlib`` or ``raytracing_engine_tpu`` fails, every
module of ``raytracing_engine_tpu_torch`` and ``chip_smoke`` import."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "raytracing_engine_tpu")


class Block:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(f"blocked: {name}")
        return None


sys.meta_path.insert(0, Block())
sys.modules["jax"] = None
import raytracing_engine_tpu_torch as pkg

names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401

loaded = [m for m, v in sys.modules.items() if v is not None
          and any(m == b or m.startswith(b + ".") for b in BLOCKED)]
assert not loaded, loaded
print(len(names), "modules:", " ".join(names))
"""


def test_port_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n, names = int(out.stdout.split()[0]), out.stdout.split()[2:]
    assert n >= 30, out.stdout  # every module of the package was walked
    # the threefry stream (K9's plain version) and K9's wrapper among them
    assert {"raytracing_engine_tpu_torch.ops.rng",
            "raytracing_engine_tpu_torch.ops.cuda.rng"} <= set(names), out.stdout
    # and the entry points: the command line and the live server
    assert {"raytracing_engine_tpu_torch.cli",
            "raytracing_engine_tpu_torch.runtime.live"} <= set(names), out.stdout
