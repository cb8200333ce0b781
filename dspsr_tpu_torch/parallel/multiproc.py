"""Multi-process fold: the MPIRoot/MPIServer equivalent on
``torch.distributed``.

Counterpart of ``dspsr_tpu/parallel/multiproc.py``.  The reference scatters
raw blocks from a root rank to worker ranks over MPI
(``Kernel/Classes/MPIRoot.C:318-472``, ``MPIServer.C``).  Here no root
exists: process r of N hosts time shards ``[r k, (r+1) k)`` of the mesh
and reads only their stripes (:class:`ShardedFoldPipeline` with
``distributed=True``); the only traffic between processes is the halo of
the shard at each process boundary (``all_gather``) and the sums of the
fold accumulators and byte counts (``all_reduce``).

- ``worker_main``: one process: joins the process group
  (``MASTER_ADDR``/``MASTER_PORT`` from the environment, its rank and the
  world size from its flags, the backend named by ``--backend``), builds
  the mesh of ``--shards-per-proc`` logical shards a process on
  ``--device``, streams its stripes, and (rank 0) writes the combined
  result to an npz.
- ``launch_fold``: spawns N local workers (the ``mpirun`` role) and returns
  rank 0's result.

The backend is chosen by the caller, never swapped: ``gloo`` for CPU
shards, and for CUDA shards whose collectives it then stages through host
memory; ``nccl`` where each rank has a card of its own (NCCL refuses two
ranks on one card).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Optional, Sequence, Union

import numpy as np


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker_main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="dspsr-torch-worker")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--shards-per-proc", type=int, required=True,
                    help="logical shards this process hosts")
    ap.add_argument("--device", default="cuda",
                    help="torch device of this process's shards")
    ap.add_argument("--backend", required=True, choices=("gloo", "nccl"))
    ap.add_argument("--data", required=True, help="input file (DADA etc.)")
    ap.add_argument("--config", required=True, help="FoldConfig kwargs JSON")
    ap.add_argument("--nchan-shards", type=int, default=1)
    ap.add_argument("--out", required=True, help="npz written by process 0")
    ap.add_argument("--max-superblocks", type=int, default=0)
    ap.add_argument("--timed", action="store_true",
                    help="time the halo and the sums between device "
                    "synchronises and write them to the npz")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from ..device import resolve_device
    from ..io.sources import open_source
    from ..models.load_to_fold import FoldConfig
    from .pipeline import ShardedFoldPipeline
    from .sharded import make_mesh

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(args.backend, init_method="env://",
                            world_size=args.num_processes,
                            rank=args.process_id)
    try:
        src = open_source(args.data)
        cfg = FoldConfig(**json.loads(args.config))
        n = args.num_processes * args.shards_per_proc
        # the other processes' shards are theirs; each process names only
        # its own device
        mesh = make_mesh(n, args.nchan_shards, devices=[dev] * n)
        pipe = ShardedFoldPipeline(src, cfg, mesh, distributed=True)
        pipe.timed = args.timed
        res = pipe.run(max_superblocks=args.max_superblocks or None)
        if dist.get_rank() == 0:
            np.savez(
                args.out,
                profiles=res.profiles,
                hits=res.hits,
                integration_length=res.integration_length,
                epochs_days=np.array([e.days for e in res.epochs], np.int64),
                epochs_frac=np.array([e.fracday() for e in res.epochs]),
                nbin=res.nbin,
                folding_period=res.folding_period,
                dispersion_measure=res.dispersion_measure,
                digitizer_counts=(res.digitizer_counts
                                  if res.digitizer_counts is not None
                                  else np.zeros(0, np.int64)),
                seconds_halo=pipe.seconds["halo"],
                seconds_reduce=pipe.seconds["reduce"],
            )
        # ordered shutdown: every process gets here before teardown
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def launch_fold(data_path: str, config_kwargs: dict, n_procs: int = 2,
                shards_per_proc: int = 4, nchan_shards: int = 1,
                backend: str = "gloo",
                device: Union[str, Sequence[str]] = "cuda",
                out_path: Optional[str] = None,
                max_superblocks: Optional[int] = None,
                timeout: float = 600.0, timed: bool = False):
    """Spawn ``n_procs`` local workers over an ``n_procs *
    shards_per_proc``-shard mesh joined by ``backend``; ``device`` is every
    rank's device, or a list of one device a rank.  Returns the loaded npz
    of the combined result (rank 0's).  With ``timed`` the workers
    synchronise their devices around each stage so that the npz's
    ``seconds_halo``/``seconds_reduce`` are the stages' own times; without
    it (a production run) they are host times of asynchronous launches.  A
    failing or late worker stops the rest, and raises."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', not {backend!r}")
    devices = [device] * n_procs if isinstance(device, str) else list(device)
    if len(devices) != n_procs:
        raise ValueError(f"{len(devices)} devices for {n_procs} processes")
    if out_path is None:
        fd, out_path = tempfile.mkstemp(suffix=".npz", prefix="dspsr_mp_")
        os.close(fd)
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()))
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
    procs = []
    try:
        for rank in range(n_procs):
            cmd = [sys.executable, "-m", "dspsr_tpu_torch.parallel.multiproc",
                   "--num-processes", str(n_procs),
                   "--process-id", str(rank),
                   "--shards-per-proc", str(shards_per_proc),
                   "--device", str(devices[rank]),
                   "--backend", backend,
                   "--data", data_path,
                   "--config", json.dumps(config_kwargs),
                   "--nchan-shards", str(nchan_shards),
                   "--out", out_path,
                   "--max-superblocks", str(max_superblocks or 0)]
            if timed:
                cmd.append("--timed")
            procs.append(subprocess.Popen(cmd, env=env))
        # a worker that fails leaves the others waiting in a collective:
        # stop them then, as at the deadline
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if (any(p.poll() for p in procs)
                    or time.monotonic() > deadline):
                break
            time.sleep(0.2)
        rcs = [p.poll() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(rc != 0 for rc in rcs):
        raise RuntimeError(f"worker exit codes: {rcs} (None: stopped)")
    return np.load(out_path)


if __name__ == "__main__":
    raise SystemExit(worker_main())
