"""fleet.utils (counterpart of
paddle_tpu/distributed/fleet/utils/__init__.py): `sequence_parallel_utils`
(the sequence-parallel layers), `recompute`, and
`fused_allreduce_gradients`, which really reduces: under GSPMD the
reference's is a no-op, here it sums every gradient over the hcg's
data-parallel group in rank order and multiplies by 1 / dp, as
`DataParallel` does."""
from ..meta_parallel import sequence_parallel as sequence_parallel_utils
from ..recompute import recompute

__all__ = ["fused_allreduce_gradients", "sequence_parallel_utils",
           "recompute"]


def fused_allreduce_gradients(parameter_list, hcg) -> None:
    """The gradients of `parameter_list` reduced over `hcg`'s dp group
    (the world when `hcg` is None), in place. Every rank of the group
    calls it with the same parameters."""
    from ...group import _default
    from ...parallel import reduce_gradients

    group = (hcg.get_data_parallel_group() if hcg is not None
             else _default())
    reduce_gradients(list(parameter_list), group)
