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
    from paddle_tpu_torch import distributed as ptd

    for mod, names in paddle_tpu_torch._NAMES.items():
        module = importlib.import_module(f"paddle_tpu_torch.{mod}")
        assert set(names) <= set(module.__all__), mod
        for name in names:
            assert getattr(paddle_tpu_torch, name) is getattr(module, name)
    for mod in paddle_tpu_torch._SUBMODULES:
        assert getattr(paddle_tpu_torch, mod) is importlib.import_module(
            f"paddle_tpu_torch.{mod}")
    ops = importlib.import_module("paddle_tpu_torch.tensor")
    for name in ("add", "matmul", "to_tensor", "randn", "einsum"):
        assert getattr(paddle_tpu_torch, name) is getattr(ops, name)
    for mod, names in ptd._NAMES.items():
        module = importlib.import_module(f"paddle_tpu_torch.distributed."
                                         f"{mod}")
        assert set(names) <= set(module.__all__), mod
        for name in names:
            assert getattr(ptd, name) is getattr(module, name), name
    for mod in ptd._SUBMODULES:
        assert getattr(ptd, mod) is importlib.import_module(
            f"paddle_tpu_torch.distributed.{mod}") or mod == "spawn"


_NEW_SURFACE = """
import sys
import paddle_tpu_torch as paddle
names = [paddle.Model, paddle.summary, paddle.flops, paddle.save,
         paddle.load, paddle.vision.models.resnet50, paddle.vision.LeNet,
         paddle.vision.transforms.ToTensor, paddle.vision.datasets.MNIST,
         paddle.hapi.callbacks.ModelCheckpoint, paddle.framework.io.save,
         paddle.nn.utils.weight_norm, paddle.nn.Conv2D, paddle.nn.LSTM,
         paddle.nn.Transformer, paddle.nn.functional.conv2d]
from paddle_tpu_torch.ops import registry
registry._load()
loaded = [m for m in sys.modules
          if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu", "triton")]
print(len(registry.OPS), loaded)
"""


def test_framework_hapi_and_vision_stand_alone():
    """The slice's packages (`framework`, `hapi`, `vision`, `nn.utils`,
    the nn ops) and the top level's new names (`paddle.Model`, `summary`,
    `flops`, `save`, `load`) resolve in a fresh interpreter without
    `jax`, `paddle_tpu` or Triton, and the op table holds all 397 ops."""
    import paddle_tpu_torch

    assert {"framework", "hapi", "vision"} <= set(
        paddle_tpu_torch._SUBMODULES)
    assert paddle_tpu_torch._NAMES["hapi"] == ("Model", "summary", "flops")
    assert paddle_tpu_torch._NAMES["framework"] == ("save", "load")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", _NEW_SURFACE], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    count, loaded = proc.stdout.split(" ", 1)
    assert int(count) == 397, proc.stdout
    assert loaded.strip() == "[]", proc.stdout


_VISION_DP = """
import sys
import paddle_tpu_torch as paddle
paddle.set_device("cpu")
M = paddle.vision.models
names = [n for n in M.__all__ if callable(getattr(M, n))]
ops = [getattr(paddle.vision.ops, n) for n in paddle.vision.ops.__all__]
net = paddle.nn.SyncBatchNorm.convert_sync_batchnorm(M.mobilenet_v3_small(
    scale=0.25, num_classes=4))
model = paddle.Model(paddle.DataParallel(net))
from paddle_tpu_torch.distributed import sharding
wrapped, opt = sharding.group_sharded_parallel(
    M.squeezenet1_1(num_classes=4), paddle.optimizer.Adam(
        parameters=net.parameters()), level="os_g")
assert paddle.Model(wrapped)._sharded_opt is opt
loaded = [m for m in sys.modules
          if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu", "triton")]
print(len(names), len(ops), loaded)
"""


def test_vision_zoo_ops_and_the_data_parallel_model_stand_alone():
    """The zoo, `vision.ops`, SyncBatchNorm and `paddle.Model` over
    DataParallel and GroupSharded build in a fresh interpreter without
    `jax`, `paddle_tpu` or Triton."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", _VISION_DP], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    n_models, n_ops, loaded = proc.stdout.split(" ", 2)
    assert int(n_models) == 53 and int(n_ops) == 18, proc.stdout
    assert loaded.strip() == "[]", proc.stdout
