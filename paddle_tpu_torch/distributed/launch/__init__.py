"""fleetrun: `python -m paddle_tpu_torch.distributed.launch`."""
from .main import main

__all__ = ["main"]
