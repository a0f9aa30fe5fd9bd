"""paddle_tpu_torch.distributed, the process-group helper of the multi-rank
slice, over 4 gloo processes on the CPU (`spawn`: the spawn start method, a
file:// store in a temporary directory, one PyTorch thread a rank).

One world runs every collective once (a module-scoped fixture); each test
checks one of them against the values numpy gives: all_reduce (sum, max),
all_gather, ring_shift, alltoall_single, the tiled all_to_all and its
gradient (the inverse all-to-all), send / recv, batch_isend_irecv, pmean's
and replicated's gradients, new_group. Without a process group the world
is one rank and every collective is the identity. A rank that raises makes
`spawn` raise with its traceback, and ranks past the timeout make it raise
naming them, instead of hanging.
"""
import time

import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from paddle_tpu_torch import distributed as ptd

N = 4


@pytest.fixture(scope="module")
def seen():
    return ptd.spawn(ranks.collectives, nprocs=N, device="cpu", timeout=120)


def _x(r):
    return np.arange(6, dtype=np.float32) + 10 * r


def test_world_is_four_gloo_ranks_in_order(seen):
    assert [s["rank"] for s in seen] == list(range(N))
    assert {s["world"] for s in seen} == {N}
    assert {s["backend"] for s in seen} == {"gloo"}


def test_all_reduce_sums_and_maxes_over_the_ranks(seen):
    for s in seen:
        np.testing.assert_array_equal(s["all_reduce"],
                                      sum(_x(r) for r in range(N)))
        np.testing.assert_array_equal(s["all_reduce_max"], _x(N - 1))


def test_all_gather_lists_every_rank_in_order(seen):
    for s in seen:
        assert len(s["all_gather"]) == N
        for r, got in enumerate(s["all_gather"]):
            np.testing.assert_array_equal(got, _x(r))


def test_ring_shift_receives_from_the_previous_rank(seen):
    for me, s in enumerate(seen):
        a, b = s["ring_shift"]
        prev = (me - 1) % N
        np.testing.assert_array_equal(a, _x(prev))
        np.testing.assert_array_equal(b, _x(prev).reshape(2, 3) * 2)


def test_alltoall_single_trades_blocks(seen):
    for me, s in enumerate(seen):
        want = np.concatenate([np.arange(4 * me, 4 * me + 4) + 100 * j
                               for j in range(N)]).astype(np.float32)
        np.testing.assert_array_equal(s["alltoall_single"], want)


def test_all_to_all_and_its_gradient_are_jax_tiled_all_to_all(seen):
    """y = all_to_all(t, split 1, concat 2), as jax.lax.all_to_all(tiled):
    rank me gets block me of axis 1 from every rank j, at j's place along
    axis 2; t's gradient is the inverse all-to-all of y's."""
    t = [np.arange(2 * N * 3 * 5, dtype=np.float64).reshape(2, N * 3, 5)
         + 1000 * j for j in range(N)]
    for me, s in enumerate(seen):
        want = np.concatenate([t[j][:, me * 3:(me + 1) * 3] for j in
                               range(N)], axis=2)
        np.testing.assert_array_equal(s["all_to_all"], want)
        wgt = np.arange(want.size, dtype=np.float64).reshape(want.shape)
        grad = np.concatenate([(wgt + i)[:, :, me * 5:(me + 1) * 5]
                               for i in range(N)], axis=1)
        np.testing.assert_array_equal(s["all_to_all_grad"], grad)


def test_send_recv_and_batch_isend_irecv(seen):
    np.testing.assert_array_equal(seen[N - 1]["recv"], _x(0) * 3)
    for me, s in enumerate(seen):
        np.testing.assert_array_equal(s["batch_isend_irecv"],
                                      _x((me - 1) % N) + 0.5)


def test_pmean_and_replicated_gradients(seen):
    """pmean: the mean over ranks, its gradient split 1/n among them;
    replicated: the identity, its gradient summed over the ranks."""
    mean = np.mean([(2.0 + r) ** 2 for r in range(N)])
    for me, s in enumerate(seen):
        m, g = s["pmean"]
        assert m == pytest.approx(mean)
        assert g == pytest.approx(2 * (2.0 + me) / N)
        assert s["replicated_grad"] == pytest.approx(sum(range(1, N + 1)))


def test_new_group_over_two_ranks(seen):
    for me, s in enumerate(seen):
        member = me in (0, N - 1)
        assert s["new_group"] == ((0 if me == 0 else 1) if member else -1, 2)
        if member:
            assert s["sub_all_reduce"] == 1.0 + 1.0 + (N - 1)
        else:
            assert "sub_all_reduce" not in s


def test_one_rank_world_without_a_process_group():
    assert not ptd.is_initialized()
    assert ptd.get_world_size() == 1 and ptd.get_rank() == 0
    x = torch.arange(6.0).reshape(2, 3).requires_grad_()
    assert ptd.ring_shift((x,))[0] is x
    assert ptd.all_reduce(x) is x
    assert torch.equal(ptd.all_gather(None, x)[0], x)
    assert ptd.all_to_all(x, 0, 1) is x
    assert ptd.pmean(x) is x and ptd.replicated(x) is x
    assert torch.equal(ptd.alltoall_single(None, x), x)


def test_a_failing_rank_makes_spawn_raise_with_its_traceback():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"rank \d of 4 failed"):
        ptd.spawn(ranks.fail_on, (2,), nprocs=N, device="cpu", timeout=120)
    assert time.monotonic() - t0 < 120


def test_spawn_raises_naming_the_ranks_past_its_timeout():
    with pytest.raises(TimeoutError, match=r"rank\(s\) \[.*1.*\] of 4 did "
                                           "not finish within 20"):
        ptd.spawn(ranks.sleep_on, (1, 600), nprocs=N, device="cpu",
                  timeout=20)


def test_spawn_returns_the_ranks_results_in_order():
    assert ptd.spawn(ranks.sleep_on, (0, 0), nprocs=2, device="cpu",
                     timeout=120) == [0, 1]
