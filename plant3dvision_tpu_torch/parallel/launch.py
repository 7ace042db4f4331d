"""Start the ranks of a mesh and run functions on them.

The JAX package runs its multi-device programs from one controlling process
over all visible devices (`shard_map` over a `Mesh`). The port keeps that
model: the controller stays one process (the runtime, the tasks and the
FSDB with it) and drives a `Pool` of worker processes, one a rank, started
with torch.multiprocessing's spawn context. Each rank joins one
`torch.distributed` process group with the backend the caller names:

- "nccl" when each rank has a card of its own (rank r on `cuda:r`);
- "gloo" on the CPU, and when ranks share one card (rank r on
  `cuda:(r % device_count)`; gloo takes CUDA tensors in `all_reduce`,
  `broadcast` and `all_gather`).

Nothing switches backend or device after a failure: a rank that raises, or
dies, makes the controller stop the whole pool and raise `RankError`.
Rendezvous goes through a `FileStore` in a fresh temporary directory, so
pools of concurrent processes never share a port.

`Pool.run(fn, args)` sends `fn` (a module-level function, pickled by
reference: the modules it lives in import no JAX) with each rank's
arguments, runs `fn(rank, *args)` on every member rank and returns the
results in rank order. Tensors travel as CPU tensors in shared memory
(`shared`); a rank moves them to its device. The kernel launches that a
call makes on the ranks are added to the controller's `kernels.LAUNCHES`.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import traceback
import weakref
from multiprocessing.connection import wait

import numpy as np
import torch

BACKENDS = ("gloo", "nccl")


class RankError(RuntimeError):
    """A rank raised or died; the pool it belonged to is closed."""


def shared(x):
    """`x` (a numpy array or a tensor on any device) as a CPU tensor in
    shared memory, which a rank maps without a copy through the pipe."""
    if isinstance(x, np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(x))
    else:
        t = x.detach()
    if t.device.type == "cpu" and t.is_shared() and t.is_contiguous():
        return t
    out = torch.empty(t.shape, dtype=t.dtype).share_memory_()
    out.copy_(t)
    return out


class Rank:
    """What a function run on a rank gets as its first argument: its rank,
    the world size, its device, the backend, the process groups of the
    mesh layouts built so far (`groups`) and `store`, a dict that keeps
    objects resident on the rank between calls."""

    def __init__(self, rank, world, device, backend):
        self.rank = rank
        self.world = world
        self.device = device
        self.backend = backend
        self.groups = {}
        self.store = {}

    def group(self, layout, axis):
        """This rank's process group along `axis` of a mesh layout."""
        return self.groups[layout][axis]


def _rank_main(rank, world, backend, device, store_path, conn, timeout_s,
               threads):
    import torch.distributed as dist

    from .. import kernels

    try:
        torch.set_num_threads(threads)
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
        rt = Rank(rank, world, dev, backend)
    except Exception:
        conn.send(("err", traceback.format_exc(), {}))
        return
    conn.send(("ok", None, {}))
    while True:
        try:
            msg = conn.recv()
        except EOFError:
            break
        if msg is None:
            break
        fn, args = msg
        kernels.reset_launches()
        try:
            out = ("ok", fn(rt, *args))
        except Exception:
            out = ("err", traceback.format_exc())
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        try:
            conn.send((*out, launches))
        except Exception:       # a result that does not pickle
            conn.send(("err", traceback.format_exc(), launches))
    dist.destroy_process_group()


def _shutdown(procs, conns, tmpdir, kill):
    for c in conns:
        try:
            if not kill:
                c.send(None)
        except (OSError, ValueError):
            pass
    for p in procs:
        if kill:
            p.kill()
        p.join(timeout=None if kill else 30)
        if p.is_alive():
            p.kill()
            p.join()
    for c in conns:
        c.close()
    shutil.rmtree(tmpdir, ignore_errors=True)


class Pool:
    """`world` rank processes in one process group (see the module's
    docstring). `device` is "cpu" or "cuda"; `timeout_s` bounds a
    collective and a call."""

    def __init__(self, world, backend, device="cuda", timeout_s=900,
                 threads=1):
        world = int(world)
        if world < 1:
            raise ValueError(f"a pool needs at least one rank, got {world}")
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got "
                             f"{backend!r}")
        dev = torch.device(device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("a CUDA mesh was asked for but "
                                   "torch.cuda.is_available() is False")
            n_cards = torch.cuda.device_count()
            if backend == "nccl" and world > n_cards:
                raise ValueError(
                    f"nccl takes one card a rank: {world} ranks, {n_cards} "
                    "card(s); name backend='gloo' for ranks that share a card")
            devices = [f"cuda:{r % n_cards}" for r in range(world)]
            # the ranks load the kernel library that the controller builds
            from .. import kernels
            kernels.build()
        elif dev.type == "cpu":
            if backend != "gloo":
                raise ValueError("ranks on the CPU take backend='gloo'")
            devices = ["cpu"] * world
        else:
            raise ValueError(f"unsupported mesh device {device!r}")
        self.world, self.backend, self.device = world, backend, dev
        self.timeout_s = float(timeout_s)
        self.layouts = set()        # the mesh layouts whose groups exist
        self._dir = tempfile.mkdtemp(prefix="p3d_mesh_")
        store = os.path.join(self._dir, "store")
        import torch.multiprocessing as tmp
        ctx = tmp.get_context("spawn")
        self.procs, self.conns = [], []
        try:
            for r in range(world):
                parent, child = ctx.Pipe()
                p = ctx.Process(target=_rank_main, daemon=True,
                                args=(r, world, backend, devices[r], store,
                                      child, int(timeout_s), int(threads)))
                p.start()
                child.close()
                self.procs.append(p)
                self.conns.append(parent)
        except BaseException:
            _shutdown(self.procs, self.conns, self._dir, kill=True)
            raise
        self._finalizer = weakref.finalize(self, _shutdown, self.procs,
                                           self.conns, self._dir, True)
        self._collect(range(world))

    @property
    def closed(self):
        return not self._finalizer.alive

    def _fail(self, msg):
        self._finalizer.detach()
        _shutdown(self.procs, self.conns, self._dir, kill=True)
        raise RankError(msg)

    def _collect(self, ranks):
        from .. import kernels

        pending = {self.conns[r]: r for r in ranks}
        sentinels = {self.procs[r].sentinel: r for r in ranks}
        results = {}
        while pending:
            ready = wait(list(pending) + list(sentinels),
                         timeout=self.timeout_s)
            if not ready:
                self._fail(f"ranks {sorted(pending.values())} gave no "
                           f"answer in {self.timeout_s:.0f} s")
            for obj in ready:
                if obj in pending:
                    r = pending.pop(obj)
                    try:
                        status, res, launches = obj.recv()
                    except (EOFError, OSError):
                        self._fail(f"rank {r} closed its pipe")
                    if status != "ok":
                        self._fail(f"rank {r} of {self.world} failed:\n{res}")
                    for k, v in launches.items():
                        kernels.LAUNCHES[k] = kernels.LAUNCHES.get(k, 0) + v
                    results[r] = res
                elif obj in sentinels:
                    r = sentinels.pop(obj)
                    if r in pending.values():
                        self._fail(f"rank {r} of {self.world} exited with "
                                   f"code {self.procs[r].exitcode}")
        return [results[r] for r in ranks]

    def run(self, fn, args, ranks=None):
        """Run `fn(rank, *args[i])` on the i-th of `ranks` (all ranks by
        default); `args` is a list with one tuple a rank, or one tuple for
        every rank. Returns the results in the order of `ranks`."""
        if self.closed:
            raise RankError("the pool is closed")
        ranks = list(range(self.world)) if ranks is None else list(ranks)
        per = args if isinstance(args, list) else [args] * len(ranks)
        if len(per) != len(ranks):
            raise ValueError(f"{len(per)} argument tuples for {len(ranks)} "
                             "ranks")
        for r, a in zip(ranks, per):
            try:
                self.conns[r].send((fn, tuple(a)))
            except (OSError, ValueError) as e:
                self._fail(f"could not send to rank {r}: {e}")
        return self._collect(ranks)

    def close(self):
        """Stop the ranks (they leave their process group) and remove the
        rendezvous directory."""
        if self._finalizer.detach() is not None:
            _shutdown(self.procs, self.conns, self._dir, kill=False)
