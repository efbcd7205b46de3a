"""Start one process per rank and collect what each returns.

    results = run_ranks(fn, world=4, args=(...), workdir=path)

Each rank is a fresh (spawned) Python process that joins a process group of
``world`` ranks through a ``file://`` rendezvous under ``workdir``, calls
``fn(rank, world, *args)`` (a module-level function), and hands back its
return value through a pickle file.  A rank that raises, dies or outlives
``timeout_s`` fails the run: the others are stopped and ``RankFailed``
carries every rank's traceback.  Nothing is swallowed.
"""

from __future__ import annotations

import multiprocessing as mp
import pathlib
import pickle
import sys
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import init_ranks


class RankFailed(RuntimeError):
    pass


def _child(rank, world, init_method, fn, args, device, threads, out):
    try:
        if threads:
            torch.set_num_threads(threads)
        init_ranks(rank, world, init_method, device=device)
        res = fn(rank, world, *args)
        pathlib.Path(out).write_bytes(pickle.dumps(("ok", res)))
    except BaseException:
        pathlib.Path(out).write_bytes(
            pickle.dumps(("error", traceback.format_exc())))
        sys.exit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world: int, args=(), *, workdir, device: str = "cpu",
              threads: int = 0, timeout_s: float = 900.0) -> list:
    """``[fn(0, world, *args), ..., fn(world - 1, world, *args)]``, each run
    in its own process; ``device`` picks the backend (``launch.mesh``)."""
    work = pathlib.Path(workdir)
    work.mkdir(parents=True, exist_ok=True)
    rdv = work / f"rendezvous-{time.time_ns()}"
    outs = [work / f"rank{r}-{rdv.name}.pkl" for r in range(world)]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_child, args=(
        r, world, f"file://{rdv}", fn, args, device, threads, str(outs[r])))
        for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    try:
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break                       # one failed: stop the rest
            if time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.kill()
                p.join()
    results, errors = [], []
    for r, (p, out) in enumerate(zip(procs, outs)):
        if out.exists():
            status, val = pickle.loads(out.read_bytes())
            out.unlink()
        else:                # killed, stopped above, or out of time
            status, val = "error", f"no result (exit code {p.exitcode})"
        if status == "ok" and p.exitcode == 0:
            results.append(val)
        else:
            errors.append(f"--- rank {r} ---\n{val}")
    rdv.unlink(missing_ok=True)
    if errors:
        raise RankFailed(f"{len(errors)} of {world} ranks failed:\n"
                         + "\n".join(errors))
    return results


__all__ = ["run_ranks", "RankFailed"]
