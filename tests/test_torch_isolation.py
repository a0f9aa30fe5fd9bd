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
    assert not any(_build.CSRC.glob("*.so"))   # built into build/, not here
