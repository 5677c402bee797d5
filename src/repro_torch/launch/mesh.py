"""Device meshes over ``torch.distributed`` (``repro/launch/mesh.py``).

The reference is one process over many devices (GSPMD).  The port is SPMD:
one process per rank, each running the same trainer or server over a
:class:`Mesh`, a named grid of the ranks with the reference's axes
('data', 'model', and 'pod' ahead of them on a multi-pod mesh).  Ranks are
laid out row-major over the axes, so 'model' varies fastest: the ranks of
one tensor-parallel group are consecutive.

Specs (``make_train_mesh``) are the reference's: ``single`` (1x1, the
sharded code path with one rank), ``host`` (every rank on 'data'),
``prod`` (16x16), ``prod-multipod`` (2x16x16) and ``AxB`` / ``AxBxC``.  A
spec whose size is not the world size raises, naming both.

Backend (``backend_for``): NCCL where each rank has a CUDA device of its
own; gloo on the CPU and for several ranks on one card (NCCL refuses two
ranks on one device).  ``spawn`` starts N local ranks, each in a fresh
``spawn`` process that rendezvous through a ``FileStore`` in a temporary
directory (parallel test workers never contend for a TCP port); under
``torchrun`` the environment's rank and world size are used instead
(``init_from_env``).

Teardown (``close_world``): a gloo process group runs worker and
transport threads that its C++ object joins when it is destroyed.  An
engine, a scheduler or a ``Mesh`` left in a reference cycle (or in a
module's cache) keeps its groups alive past ``destroy_process_group``, and
they were then destroyed during the interpreter's final teardown, where a
rank could abort with "terminate called without an active exception"
after it had written its result.  ``close_world`` releases every mesh's
groups and collects the cycles while the interpreter is whole, waits at a
barrier until every rank has left its last collective, and only then
destroys the process group, so no gloo thread outlives it.  A spawned
rank calls it when its function returns; a world joined under
``torchrun`` or made for a one-rank mesh in a plain process is closed at
exit (``atexit``, without the barrier: the peers may be gone).
"""
from __future__ import annotations

import atexit
import datetime
import gc
import itertools
import multiprocessing as mp
import os
import pickle
import tempfile
import time
import traceback
import weakref
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

_TIMEOUT = datetime.timedelta(seconds=300)

# Every Mesh made in this process (``close_world`` releases their groups).
_LIVE: "weakref.WeakSet[Mesh]" = weakref.WeakSet()


def backend_for(device: str, world_size: int) -> str:
    """'nccl' when every rank has a CUDA device of its own, else 'gloo'."""
    if torch.device(device).type == "cuda" \
            and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device: str, rank: int) -> torch.device:
    """The device of ``rank``: ``cuda:rank % cards`` on the card (ranks
    beyond the card count share cards), the CPU otherwise."""
    if torch.device(device).type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device("cpu")


def init_distributed(rank: int, world_size: int, store_path: str,
                     device: str = "cpu") -> torch.device:
    """Join a process group of ``world_size`` ranks that rendezvous through
    a ``FileStore`` at ``store_path``; returns this rank's device."""
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group(backend_for(device, world_size), store=store,
                            rank=rank, world_size=world_size,
                            timeout=_TIMEOUT)
    return dev


def init_from_env(device: str = "cpu") -> Optional[torch.device]:
    """Join the process group ``torchrun`` describes (RANK, WORLD_SIZE,
    MASTER_ADDR/PORT in the environment); None outside ``torchrun``."""
    if dist.is_initialized():
        return rank_device(device, dist.get_rank())
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend_for(device, world), rank=rank,
                            world_size=world, timeout=_TIMEOUT)
    atexit.register(close_world, barrier=False)
    return dev


def world_size() -> int:
    """The world a mesh is built over: the process group's, torchrun's, or
    1 in a plain process."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def _check_size(shape: Sequence[int], axis_names: Sequence[str]) -> None:
    world = world_size()
    if int(np.prod(shape)) != world:
        raise ValueError(
            f"mesh {'x'.join(map(str, shape))} {tuple(axis_names)} has "
            f"{int(np.prod(shape))} ranks; the world has {world}")


def _ensure_world(device: str) -> None:
    """A one-rank process group when none exists (a ``single`` mesh in a
    plain process)."""
    if dist.is_initialized() or init_from_env(device) is not None:
        return
    path = os.path.join(tempfile.mkdtemp(prefix="repro_torch_pg_"), "store")
    init_distributed(0, 1, path, device)
    atexit.register(close_world, barrier=False)


class Mesh:
    """A named grid of the world's ranks (the reference's ``jax.sharding.
    Mesh``).  ``shape`` maps axis name to size; ``coords`` gives this
    rank's coordinate on each axis.  ``group(axes)`` is the process group
    of the ranks that differ only on ``axes`` (None when those axes have
    one rank between them: no collective runs), their rank order the
    row-major order of ``axes``: a dim sharded over ('data', 'model') is
    gathered in that order.  ``device_mesh`` is the ``DeviceMesh`` the
    single-axis groups come from."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device: str = "cpu"):
        _check_size(shape, axis_names)
        world = dist.get_world_size()
        from torch.distributed.device_mesh import init_device_mesh
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              map(int, shape)))
        self.rank = dist.get_rank()
        self.world_size = world
        self.device = rank_device(device, self.rank)
        self.backend = dist.get_backend()
        self.device_mesh = init_device_mesh(
            self.device.type, tuple(int(s) for s in shape),
            mesh_dim_names=self.axis_names)
        grid = np.arange(world).reshape(tuple(shape))
        self.coords = dict(zip(self.axis_names,
                               (int(c) for c in np.argwhere(
                                   grid == self.rank)[0])))
        self._groups: Dict[Tuple[str, ...], object] = {}
        # Every rank creates every group, in one order (new_group's rule).
        for r in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, r):
                if self.axes_size(axes) == 1:
                    continue
                if len(axes) == 1:
                    self._groups[axes] = self.device_mesh.get_group(axes[0])
                    continue
                if len(axes) == len(self.axis_names):
                    self._groups[axes] = dist.group.WORLD
                    continue
                keep = [self.axis_names.index(a) for a in axes]
                rest = [i for i in range(len(shape)) if i not in keep]
                moved = np.transpose(grid, rest + keep).reshape(
                    -1, self.axes_size(axes))
                for ranks in moved:
                    g = dist.new_group([int(x) for x in ranks])
                    if self.rank in ranks:
                        self._groups[axes] = g
        _LIVE.add(self)

    def release(self) -> None:
        """Drop this mesh's references to its process groups (``close_world``
        does so before the groups are destroyed); the mesh runs no
        collective after it."""
        self._groups = {}
        self.device_mesh = None

    def axes_size(self, axes) -> int:
        return int(np.prod([self.shape.get(a, 1) for a in axes]))

    def axes_index(self, axes) -> int:
        """This rank's row-major index over ``axes``."""
        i = 0
        for a in axes:
            i = i * self.shape.get(a, 1) + self.coords.get(a, 0)
        return i

    def group(self, axes):
        axes = tuple(a for a in self.axis_names if a in axes)
        return self._groups.get(axes)

    def spec(self) -> str:
        return "x".join(str(self.shape[a]) for a in self.axis_names)

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank}, {self.backend})"


def close_world(barrier: bool = True) -> None:
    """Tear the process group down so that no gloo thread outlives it:
    release every live mesh's groups, collect the reference cycles that
    may still hold a group (an engine, a scheduler), wait at a barrier
    until every rank is done with its collectives (``barrier``; a rank
    that failed skips it, as its peers may never arrive), then destroy the
    group and collect again.  A no-op without a process group."""
    if not dist.is_initialized():
        return
    for m in list(_LIVE):
        m.release()
    gc.collect()
    if barrier:
        dist.barrier()
    dist.destroy_process_group()
    gc.collect()


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              device: str = "cpu") -> Mesh:
    """A mesh of ``shape`` over the world (a one-rank world is made when
    no process group exists).  A shape whose size is not the world's
    raises, naming both, before any process group is made."""
    _check_size(shape, axis_names)
    _ensure_world(device)
    return Mesh(shape, axis_names, device)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_train_mesh(spec: str = "single", device: str = "cpu") -> Mesh:
    """Resolve a CLI/test mesh spec (the reference's) against the world:

    'single'        1x1 (the sharded code path with one rank)
    'host'          every rank on 'data' (pure FSDP/DP)
    'prod'          16x16; 'prod-multipod' 2x16x16
    'AxB' / 'AxBxC' explicit (data, model) / (pod, data, model)"""
    if spec == "single":
        return make_mesh((1, 1), ("data", "model"), device)
    if spec == "host":
        return make_mesh((world_size(), 1), ("data", "model"), device)
    if spec == "prod":
        return make_production_mesh(device=device)
    if spec == "prod-multipod":
        return make_production_mesh(multi_pod=True, device=device)
    if "x" in spec:
        shape = tuple(int(s) for s in spec.split("x"))
        if len(shape) not in (2, 3):
            raise ValueError(f"mesh spec {spec!r}: need 2 or 3 axes")
        names = ("data", "model") if len(shape) == 2 else \
            ("pod", "data", "model")
        return make_mesh(shape, names, device)
    raise ValueError(f"unknown mesh spec {spec!r}")


# ---------------------------------------------------------------------------
# Local ranks: N spawned processes over one FileStore
# ---------------------------------------------------------------------------


def _rank_main(fn, rank: int, world: int, tmp: str, device: str,
               threads: int):
    if threads:
        torch.set_num_threads(threads)
    try:
        with open(os.path.join(tmp, "args.pkl"), "rb") as f:
            args = pickle.load(f)
        init_distributed(rank, world, os.path.join(tmp, "store"), device)
        out = fn(*args)
        with open(os.path.join(tmp, f"result_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        del out
        close_world()
    except BaseException:
        with open(os.path.join(tmp, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        close_world(barrier=False)
        raise


def spawn(fn: Callable, nproc: int, args: tuple = (), device: str = "cpu",
          threads: int = 1, timeout_s: float = 600.0) -> list:
    """Run ``fn(*args)`` on ``nproc`` local ranks, each a fresh ``spawn``
    process in a process group of ``nproc`` (gloo, or NCCL with a card per
    rank), and return their results in rank order.  ``fn`` must be
    importable (a module-level function) and its result picklable.  A rank
    that fails stops the others; its traceback is raised here.
    ``threads`` sets each rank's torch thread count (0 leaves it)."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        # The arguments go through a file: a start message past the pipe's
        # buffer would hold each start until that child had imported torch.
        with open(os.path.join(tmp, "args.pkl"), "wb") as f:
            pickle.dump(args, f)
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, nproc, tmp, device, threads),
                             daemon=False)
                 for r in range(nproc)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{nproc} ranks still running after "
                                       f"{timeout_s:.0f} s")
                time.sleep(0.02)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join(timeout=30)
        errors = []
        for r in range(nproc):
            path = os.path.join(tmp, f"error_{r}.txt")
            if os.path.exists(path):
                with open(path) as f:
                    errors.append(f"rank {r}:\n{f.read()}")
        if errors or any(p.exitcode != 0 for p in procs):
            raise RuntimeError("ranks failed (exit codes "
                               f"{[p.exitcode for p in procs]}):\n"
                               + "\n".join(errors))
        out = []
        for r in range(nproc):
            with open(os.path.join(tmp, f"result_{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


# ---------------------------------------------------------------------------
# The CLIs' --mesh / --nproc
# ---------------------------------------------------------------------------


def add_mesh_args(ap) -> None:
    """``--mesh SPEC`` and ``--nproc N`` on an argparse parser."""
    ap.add_argument("--mesh", default=None,
                    help="device mesh spec: single | host | prod | "
                    "prod-multipod | AxB | AxBxC (default: no mesh, one "
                    "device); the world is --nproc local ranks or the "
                    "ranks torchrun starts")
    ap.add_argument("--nproc", type=int, default=1,
                    help="start this many local ranks (gloo on the CPU and "
                    "for ranks sharing a card, NCCL with a card per rank)")


def _cli_rank(module: str, argv: list):
    import importlib
    importlib.import_module(module).main(argv)


def run_ranks(module: str, argv, nproc: int, device: str) -> None:
    """Re-run ``module``'s ``main`` on ``nproc`` spawned ranks with
    ``argv`` minus ``--nproc``; each rank's output goes to this process's
    standard output (rank 0 prints)."""
    argv = list(argv)
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
            continue
        if a == "--nproc":
            skip = True
            continue
        if a.startswith("--nproc="):
            continue
        out.append(a)
    # CPU ranks share the host's cores; on the card torch's default stays.
    threads = max(1, (os.cpu_count() or 1) // nproc) \
        if torch.device(device).type == "cpu" else 0
    spawn(_cli_rank, nproc, (module, out), device=device, threads=threads,
          timeout_s=24 * 3600.0)
