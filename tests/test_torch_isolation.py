"""paddle_tpu_torch stands alone: importing every module of the port (and
chip_smoke.py, the script that drives it on the card) pulls in neither
`jax` nor anything of `paddle_tpu`, builds no kernel and imports no
Triton. Checked in a fresh interpreter, since this test process itself
has both packages loaded."""
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, pkgutil, sys
import paddle_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    paddle_tpu_torch.__path__, "paddle_tpu_torch."))
for name in names:
    importlib.import_module(name)
import chip_smoke
loaded = [m for m in sys.modules
          if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu", "triton")]
print(len(names), loaded)
"""


def test_port_imports_neither_jax_nor_paddle_tpu():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    count, loaded = proc.stdout.split(" ", 1)
    assert int(count) >= 15, proc.stdout       # every module was imported
    assert loaded.strip() == "[]", proc.stdout


def test_kernel_sources_are_in_the_checkout():
    from paddle_tpu_torch import _build

    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").is_file()
    for name in _build.HOST_SOURCES:      # the TCPStore's g++ source
        assert (_build.CSRC / f"{name}.cc").is_file()
    assert not any(_build.CSRC.glob("*.so"))   # built into build/, not here


def test_lazy_name_tables_match_the_modules():
    """The package inits resolve names at first use from hand-kept
    tables; each name must be in its module's `__all__` and resolve."""
    import importlib

    import paddle_tpu_torch
    from paddle_tpu_torch import device
    from paddle_tpu_torch import distributed as ptd

    assert set(paddle_tpu_torch.__all__) <= set(device.__all__)
    for name in paddle_tpu_torch.__all__:
        assert getattr(paddle_tpu_torch, name) is getattr(device, name)
    for mod, names in ptd._NAMES.items():
        module = importlib.import_module(f"paddle_tpu_torch.distributed."
                                         f"{mod}")
        assert set(names) <= set(module.__all__), mod
        for name in names:
            assert getattr(ptd, name) is getattr(module, name), name
    for mod in ptd._SUBMODULES:
        assert getattr(ptd, mod) is importlib.import_module(
            f"paddle_tpu_torch.distributed.{mod}") or mod == "spawn"
