"""incubate namespace of the port: the MoE layer (`distributed.models.moe`)."""
from . import distributed  # noqa: F401
