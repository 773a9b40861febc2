"""Parallelism (counterpart of gof_tpu/parallel/sharding.py).

gof_tpu drives every device from one controller over a jax.sharding.Mesh.
A train step here dispatches some 2,300 torch ops from the host, so one
process driving N devices would repeat that host work N times in series.
The port therefore runs one process per rank over torch.distributed, the
PyTorch idiom, wherever ranks exchange data:

1. camera-batch data parallelism (`train.build_train_step(dp=N,
   group=...)`, `train.training(dp=N)`, `python -m gof_tpu_torch.train --dp
   N`): each rank renders a different training view of the same scene; the
   gradients are averaged over the group (gof_tpu's pmean over ICI). As in
   gof_tpu, the learning rates are not rescaled: its measured rule is to
   scale every lr by about sqrt(dp) (scripts/dp_semantics_study.py);
2. scene parallelism (`build_scene_parallel_step`): each rank owns an
   independent scene and steps it with no communication, the counterpart of
   the reference's one-process-per-GPU scene dispatcher;
3. point-sharded opacity-field evaluation for mesh extraction
   (`sharded_min_transmittance`, `mesh.extract.FieldEvaluator(devices=...)`,
   `extract_mesh --shard N`): no gradient and no reduction, so one process
   splits the points over a device list and concatenates the results,
   keeping the host Delaunay in that one process.

`launch` starts the ranks (spawn, never fork), each with a `Group`: its
rank, every rank's device and the collectives. NCCL joins ranks that each
have a CUDA device of their own; gloo joins ranks on the CPU or sharing a
device (NCCL refuses two ranks on one device). Every collective runs under
the group's timeout, so a dead rank cannot hang the run, and a rank that
raises makes `launch` raise.
"""

from __future__ import annotations

import os
import pickle
import tempfile
from dataclasses import dataclass
from datetime import timedelta
from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT = timedelta(minutes=10)
# far points padding a point set to a multiple of the shard count; their
# values are cut off (gof_tpu mesh/extract.py:206-213)
FAR = 1e8


def as_device(d) -> torch.device:
    """d as a torch.device, "cuda" as cuda:0 (a fresh rank's current
    device), so equal devices compare equal."""
    d = torch.device(d)
    return torch.device("cuda", 0) if d.type == "cuda" and d.index is None else d


def make_mesh(n: int, device_type: str = "cuda", what: str = "") -> list:
    """gof_tpu's make_mesh(n) over jax.devices()[:n]: the first n CUDA
    devices, or n CPU ranks. Never fewer: it raises where fewer than n CUDA
    devices are visible, and it never puts two ranks on one card."""
    if device_type == "cpu":
        return [torch.device("cpu")] * n
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < n:
        raise RuntimeError(f"{what or f'{n} ranks'} needs {n} devices; only {count} visible "
                           "on backend 'cuda'")
    return [torch.device("cuda", i) for i in range(n)]


def backend_for(devices: Sequence) -> str:
    """NCCL when every rank has a CUDA device of its own, gloo when the
    ranks are on the CPU or share a device."""
    devs = [as_device(d) for d in devices]
    if all(d.type == "cuda" for d in devs) and len(set(devs)) == len(devs):
        return "nccl"
    return "gloo"


@dataclass(frozen=True)
class Group:
    """One rank's view of a launch: its rank and every rank's device (the
    rank -> device map). Its collectives act on the default process group
    that `launch` set up, under that group's timeout."""

    rank: int
    devices: tuple

    @property
    def world(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        return self.devices[self.rank]

    @property
    def backend(self) -> str:
        return backend_for(self.devices)

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """In place over every rank; op "sum" or "max"."""
        dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op])
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's t, stacked in rank order."""
        if self.backend == "gloo" and t.is_cuda:
            # gloo gathers host tensors only: copy there and back explicitly
            return self.all_gather(t.cpu()).to(t.device)
        out = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(out, t.contiguous())
        return torch.stack(out)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """In place: every rank's t becomes rank src's."""
        dist.broadcast(t, src)
        return t

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()


def replicate(tensors, group: Group) -> None:
    """gof_tpu's replicate: every rank's tensors take rank 0's values, in
    place (one broadcast each)."""
    for t in tensors:
        group.broadcast(t, 0)


def shard_leading(x, world: int, rank: int):
    """gof_tpu's shard_leading for one rank: its contiguous 1/world of the
    leading axis, which must divide evenly."""
    if len(x) % world:
        raise ValueError(f"a leading axis of {len(x)} does not split over {world} ranks")
    n = len(x) // world
    return x[rank * n:(rank + 1) * n]


def build_scene_parallel_step(single_scene_step: Callable, group: Group) -> Callable:
    """Share-nothing multi-scene training (gof_tpu sharding.py:57-76): each
    rank advances its own scene with single_scene_step(...) -> (..., loss)
    and no communication; the returned step gives single_scene_step's
    outputs with the loss replaced by every rank's loss [world], gathered
    in rank order, as gof_tpu returns them stacked."""

    def step(*local):
        *out, loss = single_scene_step(*local)
        return (*out, group.all_gather(torch.as_tensor(loss).reshape(())))

    return step


def sharded_min_transmittance(eval_fn: Callable, devices: Sequence) -> Callable:
    """Point-sharded field evaluation (gof_tpu sharding.py:79-97,
    mesh/extract.py:199-213): run(points [N, 3] numpy) pads the points to a
    multiple of len(devices) with far points, hands each device its
    contiguous shard as eval_fn(points on that device) -> [n] tensor, and
    concatenates the shards' values on the host, cut to N. The model is the
    caller's to replicate; a device may appear more than once."""
    devices = [as_device(d) for d in devices]

    def run(points: np.ndarray) -> np.ndarray:
        pts = np.asarray(points, np.float32)
        n = len(pts)
        pad = (-n) % len(devices)
        if pad:
            pts = np.concatenate([pts, np.full((pad, 3), FAR, np.float32)])
        outs = [eval_fn(torch.as_tensor(shard_leading(pts, len(devices), r), device=d))
                for r, d in enumerate(devices)]
        return np.concatenate([o.cpu().numpy() for o in outs])[:n]

    return run


def launch(fn: Callable, world: int, devices: Sequence, args: tuple = (),
           timeout: timedelta = TIMEOUT) -> list:
    """Run fn(group, *args) in `world` spawned ranks, rank r on devices[r],
    and return their results in rank order (each pickled to a file in a
    temporary directory and read back). fn must be importable by the rank
    (a module-level function) and args picklable: host arrays and plain
    values, not CUDA tensors. Rendezvous is a file store in that directory,
    so concurrent launches need no port. A rank that raises makes launch
    raise (torch.multiprocessing's ProcessRaisedException, the others
    terminated). With a CUDA rank, the kernels are built here once first,
    so the ranks do not each run nvcc."""
    devices = tuple(as_device(d) for d in devices)
    if len(devices) != world:
        raise ValueError(f"{world} ranks need {world} devices, got {len(devices)}")
    if any(d.type == "cuda" for d in devices):
        from ..ops import cuda_lib

        cuda_lib.library()
    threads = max(1, torch.get_num_threads() // world)
    with tempfile.TemporaryDirectory(prefix="gof_launch_") as tmp:
        # the arguments go through a file: a spawned rank reads its pipe only
        # after importing fn's module, so a large pickle there would start
        # the ranks one after another
        with open(os.path.join(tmp, "args.pkl"), "wb") as f:
            pickle.dump(args, f, protocol=pickle.HIGHEST_PROTOCOL)
        torch.multiprocessing.spawn(_rank_main, args=(fn, devices, tmp, timeout, threads),
                                    nprocs=world, join=True, start_method="spawn")
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))  # written by the rank
    return results


def _rank_main(rank: int, fn: Callable, devices: tuple, tmp: str, timeout: timedelta,
               threads: int) -> None:
    dev = devices[rank]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:  # CPU ranks share the host's cores
        torch.set_num_threads(threads)
    with open(os.path.join(tmp, "args.pkl"), "rb") as f:
        args = pickle.load(f)  # written by launch
    dist.init_process_group(backend_for(devices),
                            init_method="file://" + os.path.join(tmp, "rendezvous"),
                            world_size=len(devices), rank=rank, timeout=timeout)
    out = fn(Group(rank, devices), *args)
    dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f, protocol=pickle.HIGHEST_PROTOCOL)
