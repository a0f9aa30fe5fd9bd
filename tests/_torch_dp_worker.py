"""A data-parallel training script run by the port's launcher (fleetrun)
in tests/test_torch_data_parallel.py: each rank joins the world with
`init_parallel_env()` and no arguments, reads its shard of a seeded
regression dataset through `DistributedBatchSampler` and `DataLoader`,
and trains the reference worker's MLP (tests/_multiproc_train_worker.py:
Linear 8 -> 16, ReLU, Linear 16 -> 4, MSE, Adam 0.05) under
`DataParallel` for 4 steps, printing the ranks' mean loss each step.

Usage (the launcher sets the rank's environment):
  python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2 \\
      tests/_torch_dp_worker.py WEIGHTS.npz
WEIGHTS.npz holds the initial parameters by name, torch's layout."""
import sys

import numpy as np
import torch

N, IN, OUT = 32, 8, 4
LOCAL_BS, STEPS = 4, 4


def sample(i):
    """Sample i of the reference worker's SynthDS."""
    rng = np.random.RandomState(1000 + i)
    x = rng.randn(IN).astype(np.float32)
    y = rng.randn(OUT).astype(np.float32)
    return x, y


def main():
    import paddle_tpu_torch
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.io import (DataLoader, Dataset,
                                     DistributedBatchSampler)
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.parallel.mesh import ordered_psum

    class SynthDS(Dataset):
        def __len__(self):
            return N

        def __getitem__(self, i):
            return sample(i)

    torch.set_num_threads(1)
    paddle_tpu_torch.set_device("cpu")
    group = dist.init_parallel_env()
    rank = dist.get_rank()
    weights = np.load(sys.argv[1])
    net = torch.nn.Sequential(torch.nn.Linear(IN, 16), torch.nn.ReLU(),
                              torch.nn.Linear(16, OUT))
    net.load_state_dict({k: torch.from_numpy(weights[k]) for k in weights})
    model = dist.DataParallel(net)
    opt = Adam(learning_rate=0.05, parameters=net.parameters())
    ds = SynthDS()
    loader = DataLoader(ds, batch_sampler=DistributedBatchSampler(
        ds, batch_size=LOCAL_BS, shuffle=False))
    for t, (xb, yb) in enumerate(loader, 1):
        if t > STEPS:
            break
        loss = torch.mean((model(xb) - yb) ** 2)
        loss.backward()
        opt.step()
        opt.clear_grad()
        mean = ordered_psum(loss.detach().reshape(1), group)[0] / \
            group.nranks
        print(f"rank={rank} step={t} loss={float(mean):.8f}", flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
