"""echoflow_torch, chip_smoke.py, profile_torch.py, train_clasfv_torch.py,
train_camus_torch.py and motion_segment_torch.py import neither jax nor
echoflow.

A subprocess blocks `jax`, `jaxlib`, `flax` and `echoflow` (the exact name
and its submodules, not `echoflow_torch`) with a meta-path finder, then
imports every module of the port and the five scripts."""

import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent

_SCRIPT = r"""
import importlib, importlib.util, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "flax", "echoflow")


class Block:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError("blocked import: " + name)


for mod in [m for m in sys.modules if any(m == b or m.startswith(b + ".") for b in BLOCKED)]:
    del sys.modules[mod]
sys.meta_path.insert(0, Block())

import echoflow_torch

names = ["echoflow_torch"] + [m.name for m in pkgutil.walk_packages(
    echoflow_torch.__path__, "echoflow_torch.")]
for name in names:
    importlib.import_module(name)
for path in sys.argv[1:]:
    name = path.rsplit("/", 1)[-1][:-3]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module   # profile_torch imports chip_smoke, which imports
                                 # train_clasfv_torch
    spec.loader.exec_module(module)
leaked = [m for m in sys.modules if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
assert not leaked, leaked
try:
    import echoflow
except ImportError:
    pass
else:
    raise AssertionError("the blocker let echoflow through")
print(len(names))
"""


def test_port_imports_no_jax_and_no_echoflow():
    out = subprocess.run([sys.executable, "-c", _SCRIPT, str(REPO / "chip_smoke.py"),
                          str(REPO / "profile_torch.py"), str(REPO / "train_clasfv_torch.py"),
                          str(REPO / "motion_segment_torch.py"),
                          str(REPO / "train_camus_torch.py")],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    # every subpackage and module was walked, not just the top package
    assert int(out.stdout.strip().splitlines()[-1]) >= 20
