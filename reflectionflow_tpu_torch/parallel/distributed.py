"""One process per device under `torch.distributed`: start-up, spawning and
the rank-0 host calls.

Counterpart of the JAX package's multi-process start
(`__graft_entry__.py::dryrun_multihost` and its worker: one
`jax.distributed.initialize` per process). A rank drives one device:
`cuda:LOCAL_RANK`, another CUDA device the caller names, or the CPU when the
caller asks for it; there is no silent CPU fallback. The backend is NCCL for
CUDA devices and gloo for the CPU unless the caller names one: gloo on CUDA
is how several ranks share one card (NCCL refuses two ranks on one GPU), and
its collectives go through host memory (`collectives.COUNTS["host_copies"]`).

  * `init_distributed` joins the process group from torchrun's environment
    (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`/`MASTER_PORT`) or an
    explicit `init_method` and rank;
  * `launch` spawns a world of ranks on this host (`torch.multiprocessing`,
    spawn context), runs `fn(*args)` in each after `init_distributed`, and
    returns the ranks' results in rank order; a rank that raises ends them
    all and the error reaches the caller;
  * `RankZero` runs host work (file reads, verifier / reflector / refiner
    calls) on rank 0 of a mesh and hands every rank the result, and lets
    rank 0 alone write: the search loops' rule, so that every rank takes the
    same branches and one copy of the artifacts is written.
"""

from __future__ import annotations

import os
import queue as queue_mod
import time
import traceback

import torch
import torch.distributed as dist

from . import collectives


def resolve_rank_device(device=None, local_rank: int = 0) -> torch.device:
    """The device of a rank: "cuda" (or None) is cuda:LOCAL_RANK, "cuda:i" is
    that card, "cpu" the CPU. A CUDA device without CUDA raises."""
    if device is None or str(device) == "cuda":
        device = torch.device("cuda", local_rank)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"rank device {device}: CUDA is not available; pass device='cpu' to run "
                           "the ranks on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"rank device {device}: expected cuda[:N] or cpu")
    return device


def init_distributed(backend: str | None = None, device=None, *, init_method: str | None = None,
                     rank: int | None = None, world_size: int | None = None,
                     local_rank: int | None = None) -> torch.device:
    """Join the process group; returns this rank's device (set as the current
    CUDA device on CUDA). Without `rank`/`world_size` they come from torchrun's
    `RANK`/`WORLD_SIZE`/`LOCAL_RANK` and the rendezvous from `MASTER_ADDR`/
    `MASTER_PORT` ("env://"). `backend` None picks NCCL for a CUDA device and
    gloo for the CPU."""
    env = os.environ
    rank = int(env["RANK"]) if rank is None else rank
    world_size = int(env["WORLD_SIZE"]) if world_size is None else world_size
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", rank))
    device = resolve_rank_device(device, local_rank)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the NCCL backend takes CUDA devices; use gloo for the CPU")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size)
    return device


def _rank_main(rank, world_size, fn, args, backend, device, init_method, results):
    try:
        dev = init_distributed(backend, device, init_method=init_method, rank=rank,
                               world_size=world_size, local_rank=rank)
        try:
            out = fn(dev, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 - handed to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def launch(fn, world_size: int, *, args: tuple = (), backend: str | None = None, device=None,
           init_method: str, timeout: float = 600.0) -> list:
    """Run `fn(device, *args)` on `world_size` spawned ranks of this host and
    return their results in rank order. `fn` must be importable (spawned ranks
    import it by name) and its results picklable. `device` as
    `init_distributed`: "cuda" puts rank i on cuda:i, "cuda:0" every rank on
    that card, "cpu" on the CPU. `init_method` is the rendezvous, e.g.
    "file:///tmp/x/rdzv" (a file that does not exist yet) or
    "tcp://localhost:PORT". A rank that raises, or a run past `timeout`
    seconds, terminates every rank and raises RuntimeError with the rank's
    traceback (and those of the ranks that fail within 5 s of it)."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world_size, fn, args, backend, device, init_method, results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    out: dict[int, object] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < world_size:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue_mod.Empty:
                if time.monotonic() > deadline:
                    raise RuntimeError(f"launch: ranks {sorted(set(range(world_size)) - set(out))} "
                                       f"gave no result within {timeout} s") from None
                dead = [r for r, p in enumerate(procs) if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"launch: rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} and no result")
                continue
            if not ok:
                raise RuntimeError(f"launch: rank {rank} of {world_size} failed:\n{value}"
                                   + _more_failures(results, rank))
            out[rank] = value
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(world_size)]


def _more_failures(results, first: int, wait: float = 5.0) -> str:
    """The other ranks' failures that arrive within `wait` seconds of the
    first (a rank that dies takes its peers' collectives down with it, and
    the first error to arrive may be a peer's)."""
    more, deadline = [], time.monotonic() + wait
    while time.monotonic() < deadline:
        try:
            rank, ok, value = results.get(timeout=max(0.01, deadline - time.monotonic()))
        except queue_mod.Empty:
            break
        if not ok and rank != first:
            more.append(f"\nrank {rank} failed too:\n{value}")
    return "".join(more)


class RankZero:
    """Host work of a loop that every rank of `mesh` runs: `call` runs a
    function on rank 0 and gives every rank its result (or its exception);
    `write` runs a function on rank 0 only; `is_writer` says whether this
    rank writes. Without a mesh, or on a mesh of one rank, both run here."""

    def __init__(self, mesh=None):
        self.group = None
        self.active = mesh is not None and getattr(mesh, "size", 1) > 1
        self.is_writer = not self.active or mesh.rank == 0
        if self.active:
            self.group = mesh.world_group

    def call(self, fn, *args, **kwargs):
        if not self.active:
            return fn(*args, **kwargs)
        box = None
        if self.is_writer:
            try:
                box = (True, fn(*args, **kwargs))
            except Exception as e:  # noqa: BLE001 - re-raised on every rank below
                box = (False, e)
        ok, value = collectives.broadcast_object(box, self.group)
        if not ok:
            if self.is_writer:
                raise value
            raise RuntimeError(f"rank 0 failed in {getattr(fn, '__name__', fn)!s}: {value!r}")
        return value

    def write(self, fn, *args, **kwargs) -> None:
        if self.is_writer:
            fn(*args, **kwargs)
