"""Process bootstrap and the 1D mesh (counterpart of
graphblast_tpu/parallel/bootstrap.py).

JAX drives every device from one controller; torch runs one process per
rank, and each rank holds its own block of the graph. A rank joins its
process group through one of:

  * one process and no variables: a world of one rank over an in-process
    store (no file, no port);
  * torch's env:// rendezvous, across machines or on one: MASTER_ADDR,
    MASTER_PORT, RANK and WORLD_SIZE (and LOCAL_RANK), as torchrun sets
    them; it takes the place of the JAX package's GRB_COORDINATOR and
    GRB_MULTIHOST paths;
  * `launch(fn, nprocs)`: nprocs ranks on this machine, spawned over a
    file:// store in a temporary directory. It takes the place of the JAX
    package's virtual CPU mesh (--xla_force_host_platform_device_count),
    which examples/scaling.py re-execs into; the tests and the port's
    scaling.py use it.

`global_mesh` gives the 1D `DeviceMesh` over the ranks, axis "x", the
counterpart of the JAX `Mesh((P,), ("x",))`. The backend is NCCL on cards
and gloo on the CPU; a rank on cards takes the card of its local rank.
"""
from __future__ import annotations

import datetime
import os
import pickle
import sys
import tempfile

import torch
import torch.distributed as dist

AXIS = "x"
# how long a rank waits in a collective for the others before it raises
TIMEOUT = datetime.timedelta(minutes=10)


def backend_for(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def _check_device(device_type: str) -> None:
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the distributed layer runs on cuda unless the "
                           "caller asks for device_type='cpu', and "
                           "torch.cuda.is_available() is False")
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"no distributed backend for {device_type!r}")


def init_distributed(device_type: str = "cuda") -> bool:
    """Join the process group the environment describes, once. Returns
    True when this process is in a process group (joined now or before),
    False when the environment names none (no WORLD_SIZE)."""
    if dist.is_initialized():
        return True
    if "WORLD_SIZE" not in os.environ:
        return False
    _check_device(device_type)
    dist.init_process_group(backend_for(device_type), init_method="env://",
                            timeout=TIMEOUT)
    return True


def local_rank() -> int:
    """This rank's index among the ranks of its machine."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() % max(torch.cuda.device_count(), 1)


def global_mesh(axis: str = AXIS, max_devices: int = None,
                device_type: str = "cuda"):
    """The 1D DeviceMesh over the ranks (the first `max_devices` of them
    when given; a rank past them gets a mesh it is not in). Joins the
    environment's process group first, or a world of one rank when it
    names none. On cards each rank takes the card of its local rank."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    _check_device(device_type)
    if not init_distributed(device_type):
        dist.init_process_group(backend_for(device_type),
                                store=dist.HashStore(), rank=0, world_size=1,
                                timeout=TIMEOUT)
    if device_type == "cuda":
        torch.cuda.set_device(local_rank())
    world = dist.get_world_size()
    P = min(max_devices, world) if max_devices else world
    if P == world:
        return init_device_mesh(device_type, (P,), mesh_dim_names=(axis,))
    return DeviceMesh(device_type, list(range(P)), mesh_dim_names=(axis,))


def mesh_device(mesh) -> torch.device:
    """The device a rank of `mesh` computes on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _rank_main(rank: int, fn, nprocs: int, device_type: str, tmp: str,
               args: tuple) -> None:
    """One spawned rank of `launch`: join the group over the file store,
    build the mesh, run fn(mesh, *args), save what it returns, and leave
    once every rank has saved its result."""
    if device_type == "cpu":
        # the ranks share the machine's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // nprocs))
    else:
        torch.cuda.set_device(rank)
    dist.init_process_group(backend_for(device_type),
                            init_method="file://" + os.path.join(tmp,
                                                                 "store"),
                            rank=rank, world_size=nprocs, timeout=TIMEOUT)
    out = fn(global_mesh(device_type=device_type), *args)
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    # every rank has its result saved past this barrier. The process then
    # ends without tearing the group down: gloo's teardown, racing a
    # peer's, aborts a rank now and then (std::terminate on a joinable
    # thread) after all its work is done
    dist.barrier()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def launch(fn, nprocs: int, *args, device_type: str = "cuda") -> list:
    """Run fn(mesh, *args) on `nprocs` ranks spawned on this machine, over
    a file:// store in a temporary directory (gloo on the CPU, NCCL on the
    first nprocs cards, one a rank), and return what each rank returned,
    in rank order. fn must be importable by name (a module-level
    function), and what it returns picklable. A rank that raises ends the
    others and raises here."""
    import torch.multiprocessing as mp

    _check_device(device_type)
    if device_type == "cuda" and nprocs > torch.cuda.device_count():
        raise ValueError(f"{nprocs} ranks on cuda, "
                         f"{torch.cuda.device_count()} cards")
    with tempfile.TemporaryDirectory(prefix="grb-launch-") as tmp:
        mp.spawn(_rank_main, args=(fn, nprocs, device_type, tmp, args),
                 nprocs=nprocs, join=True)
        out = []
        for rank in range(nprocs):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
