"""Start the ranks of a world on one node and collect what they return.

:func:`run_ranks` is the single-node launcher the tests and the smoke script
use: it spawns ``world_size`` fresh Python processes (``spawn``, never
``fork``: a forked CUDA context is unusable), each joins the world through a
``file://`` store in a temporary directory (no fixed TCP port to collide
on), runs ``fn(rank, *args)`` and writes the result to a file the parent
reads. The parent fails when a rank exits non-zero, and kills every rank and
fails when they outlast ``timeout_s``: a rank that raises while its peers wait
in a collective would otherwise hang them until the group's own timeout.
Across nodes, start one process per device with any launcher and call
``parallel.distributed.initialize`` in each.
"""

import multiprocessing
import pickle
import tempfile
import time
import traceback
import typing as tp
from pathlib import Path


def _rank_main(
    fn: tp.Callable[..., tp.Any],
    rank: int,
    world_size: int,
    workdir: str,
    args: tp.Tuple[tp.Any, ...],
    backend: tp.Optional[str],
    threads: tp.Optional[int],
    group_timeout_s: float,
) -> None:
    import torch

    from . import distributed

    if threads is not None:
        torch.set_num_threads(threads)
    try:
        distributed.initialize(
            init_method=f"file://{workdir}/store",
            num_processes=world_size,
            process_id=rank,
            backend=backend,
            timeout_s=group_timeout_s,
        )
        result = fn(rank, *args)
        Path(workdir, f"result_{rank}.pkl").write_bytes(pickle.dumps(result))
        distributed.shutdown()
    except BaseException:
        Path(workdir, f"error_{rank}.txt").write_text(traceback.format_exc())
        raise


def run_ranks(
    fn: tp.Callable[..., tp.Any],
    world_size: int,
    args: tp.Tuple[tp.Any, ...] = (),
    timeout_s: float = 600.0,
    backend: tp.Optional[str] = None,
    threads: tp.Optional[int] = 1,
) -> tp.List[tp.Any]:
    """``[fn(rank, *args) for rank in range(world_size)]``, each call in a
    process of its own inside one ``torch.distributed`` world. ``fn`` must be
    importable by name (a module-level function) and its results picklable.
    ``threads`` caps each rank's intra-op CPU threads (None leaves torch's
    default)."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="ranks_") as workdir:
        procs = [
            ctx.Process(
                target=_rank_main,
                args=(fn, rank, world_size, workdir, args, backend, threads, timeout_s),
                daemon=True,
            )
            for rank in range(world_size)
        ]
        for proc in procs:
            proc.start()
        deadline = time.monotonic() + timeout_s
        try:
            failed: tp.List[int] = []
            while any(proc.is_alive() for proc in procs) and not failed and time.monotonic() < deadline:
                time.sleep(0.05)
                failed = [rank for rank, proc in enumerate(procs) if proc.exitcode not in (None, 0)]
            failed = [rank for rank, proc in enumerate(procs) if proc.exitcode not in (None, 0)]
            hung = [rank for rank, proc in enumerate(procs) if proc.is_alive()]
        finally:
            for proc in procs:
                if proc.is_alive():
                    proc.kill()
                proc.join()
        if failed:
            errors = "\n".join(
                f"--- rank {rank}:\n" + Path(workdir, f"error_{rank}.txt").read_text()
                for rank in failed
                if Path(workdir, f"error_{rank}.txt").exists()
            )
            raise RuntimeError(f"ranks {failed} of {world_size} failed\n{errors}")
        if hung:
            raise TimeoutError(f"ranks {hung} of {world_size} were still running after {timeout_s} s and were killed")
        return [pickle.loads(Path(workdir, f"result_{rank}.pkl").read_bytes()) for rank in range(world_size)]
