"""Start the ranks of a world on this machine, without `torchrun`.

`spawn_ranks(fn, world, *args)` starts `world` fresh Python processes (the
`spawn` method), which meet through a `file://` store in a temporary
directory (no TCP port to collide), and runs `fn(init, *args)` in each:
`init` holds the `make_mesh` keywords of that rank (`init_method`, `rank`,
`world_size`), so `fn` lays its world out as it needs. It returns the ranks'
results in rank order, or raises with the failing rank's traceback; a rank
that fails, or a world that outlives `timeout`, stops every rank. The dry
run, the tests and the card's smoke run start their ranks this way; a
training run is started by `torchrun` (see `parallel/mesh.py`).
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue as queue_mod
import tempfile
import time
import traceback


def _rank_main(fn, rank, world, store, q, args):
    # gloo listens on the loopback device unless the caller names another
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)    # ranks share the machine's cores
    init = dict(init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        result = fn(init, *args)
    except BaseException:
        q.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    q.put((rank, True, result))


def spawn_ranks(fn, world: int, *args, timeout: float = 600.0) -> list:
    """[fn(init, *args) of rank 0, ..., of rank world - 1]. `fn` must be
    importable (a module-level function)."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, store, q, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        results, failure = {}, None
        deadline = time.monotonic() + timeout
        try:
            while len(results) < world and failure is None:
                left = deadline - time.monotonic()
                if left <= 0:
                    failure = f"the world of {world} ranks outlived {timeout} s"
                    break
                try:
                    rank, ok, value = q.get(timeout=min(left, 1.0))
                except queue_mod.Empty:
                    dead = [p for p in procs if p.exitcode not in (None, 0)]
                    if dead:
                        # a rank died without a word (killed, or crashed)
                        failure = (f"rank {procs.index(dead[0])} exited with "
                                   f"code {dead[0].exitcode}")
                    continue
                if ok:
                    results[rank] = value
                else:
                    failure = f"rank {rank} failed:\n{value}"
        finally:
            for p in procs:
                if failure is not None and p.is_alive():
                    p.kill()
                p.join(timeout=60)
                if p.is_alive():
                    p.kill()
                    p.join()
    if failure is not None:
        raise RuntimeError(failure)
    return [results[r] for r in range(world)]
