"""Multi-process initialization: the launcher / rendezvous contract over
``torch.distributed`` (≙ ``mxnet_tpu/parallel/dist.py``).

The reference replaces ps-lite's scheduler and dmlc-core's tracker
rendezvous (``tools/launch.py:72-116``; env contract ``DMLC_PS_ROOT_URI``
/ ``DMLC_PS_ROOT_PORT`` / ``DMLC_ROLE`` / ``DMLC_NUM_WORKER``, docs
``distributed_training.md:269-289``) with the JAX distributed runtime.
Here the scheduler is rank 0's ``torch.distributed.TCPStore`` at the
root address, workers are the ranks of one process group, and the
KVStore's collectives run over it.  The store is also the key-value
rendezvous that takes the place of JAX's coordination service: the
parameter servers' addresses (``kvstore/ps.py``) and the WorkersMerge
election (``kvstore/workers_merge.py``) go through :func:`store`.

Each field is resolved from the explicit argument, then torch's own
environment (``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``), then the ``DMLC_*`` contract, so a launch script written for
the reference keeps working.  The backend is NCCL where every rank of
this host has a card of its own (``LOCAL_WORLD_SIZE``, else the world
size, against the cards torch sees) and gloo otherwise: NCCL refuses two
ranks on one card.  :func:`initialize` prints the one it chose.
"""
from __future__ import annotations

import datetime
import os
import sys
import time
from typing import Optional

__all__ = ["initialize", "is_initialized", "rank", "size", "local_devices",
           "barrier", "finalize", "backend", "store"]

_initialized = False
_store = None
_barriers: dict = {}

_RANK_VARS = ("DMLC_WORKER_ID", "DMLC_RANK", "DMLC_TASK_ID",
              "OMPI_COMM_WORLD_RANK", "PMI_RANK", "SLURM_PROCID")
STORE_TIMEOUT_S = 300.0     # a rank's wait for the others to join


def _pick_backend(world: int) -> str:
    import torch
    if not torch.cuda.is_available():
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "0") or 0) or world
    return "nccl" if torch.cuda.device_count() >= local else "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None):
    """Join the job's process group (a no-op for one process, and when
    ``torch.distributed`` is initialized already: that group is adopted).

    Resolution order for each field: explicit argument → torch's env →
    ``DMLC_*`` env (the reference launcher's contract).  The backend
    follows the rule of the module docstring."""
    global _initialized, _store
    if _initialized:
        return
    import torch.distributed as tdist
    if tdist.is_available() and tdist.is_initialized():
        _initialized = True
        return
    if coordinator_address is None:
        if os.environ.get("MASTER_ADDR"):
            coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                                   f"{os.environ.get('MASTER_PORT', '29500')}")
        elif os.environ.get("DMLC_PS_ROOT_URI"):
            coordinator_address = (
                f"{os.environ['DMLC_PS_ROOT_URI']}:"
                f"{os.environ.get('DMLC_PS_ROOT_PORT', '9000')}")
    if num_processes is None:
        nw = os.environ.get("WORLD_SIZE") or os.environ.get("DMLC_NUM_WORKER")
        if nw:
            num_processes = int(nw)
    role = os.environ.get("DMLC_ROLE", "worker").lower()
    if role == "scheduler":
        # rank 0 hosts the store itself; a dedicated scheduler process
        # (the reference tracker's layout) has nothing to do
        _initialized = True
        return
    if process_id is None:
        for var in ("RANK",) + _RANK_VARS:
            wr = os.environ.get(var)
            if wr is not None:
                process_id = int(wr)
                break
    if coordinator_address and num_processes and num_processes > 1:
        if process_id is None:
            raise RuntimeError(
                "multi-process init needs a rank: set DMLC_WORKER_ID (the "
                "launcher exports it per worker, mxnet_tpu_torch.launch) or "
                "pass process_id explicitly")
        host, _, port = coordinator_address.rpartition(":")
        _store = tdist.TCPStore(
            host, int(port), num_processes, is_master=process_id == 0,
            timeout=datetime.timedelta(seconds=STORE_TIMEOUT_S))
        kind = _pick_backend(num_processes)
        if kind == "nccl":
            import torch
            local = int(os.environ.get("LOCAL_RANK", process_id))
            torch.cuda.set_device(local % torch.cuda.device_count())
        tdist.init_process_group(kind, store=_store, rank=process_id,
                                 world_size=num_processes)
        print(f"[dist] rank {process_id}/{num_processes} backend {kind}",
              file=sys.stderr, flush=True)
    _initialized = True


def is_initialized() -> bool:
    return _initialized


def _group_up() -> bool:
    import torch.distributed as tdist
    return tdist.is_available() and tdist.is_initialized()


def rank() -> int:
    """≙ kv.rank / ps::MyRank (fork API surface, kvstore_dist.h)."""
    if not _group_up():
        return 0
    import torch.distributed as tdist
    return tdist.get_rank()


def size() -> int:
    """≙ kv.num_workers / DMLC_NUM_WORKER."""
    if not _group_up():
        return 1
    import torch.distributed as tdist
    return tdist.get_world_size()


def backend() -> Optional[str]:
    """The process group's backend (``"nccl"`` / ``"gloo"``), or None
    for one process."""
    if not _group_up():
        return None
    import torch.distributed as tdist
    return str(tdist.get_backend())


def store():
    """The job's key-value store (rank 0's ``TCPStore``), or None for one
    process."""
    if _store is not None:
        return _store
    if not _group_up():
        return None
    from torch.distributed import distributed_c10d as c10d
    try:
        return c10d._get_default_store()
    except Exception:
        return None


def local_devices():
    """The devices this process may use: the cards torch sees, else the
    CPU."""
    import torch
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def barrier(name: str = "mxnet_tpu_barrier", timeout_s: float = 120.0):
    """Block until every process reaches this named barrier (≙ the ps-lite
    ``Barrier`` RPC the reference's kvstore_dist uses between init/push
    phases).  It runs over the store, not a device collective, so it
    works whatever the backend; each call of a name is a new
    generation."""
    if size() <= 1:
        return
    st = store()
    if st is None:
        raise RuntimeError("barrier() before initialize()")
    gen = _barriers[name] = _barriers.get(name, 0) + 1
    key = f"mxnet_tpu/barrier/{name}/{gen}"
    if st.add(key, 1) == size():
        st.set(key + "/done", "1")
    t0 = time.monotonic()
    try:
        st.wait([key + "/done"], datetime.timedelta(seconds=timeout_s))
    except Exception as e:
        raise TimeoutError(
            f"barrier {name!r} (generation {gen}): not every rank arrived "
            f"within {time.monotonic() - t0:.0f} s ({e})") from None


def finalize(timeout_s: float = 60.0):
    """Leave the process group.  Rank 0 hosts the store, so it waits
    until every other rank has checked out before it goes (a rank still
    talking to a store whose host exited fails)."""
    global _initialized, _store
    if _group_up():
        import torch.distributed as tdist
        st, n = store(), size()
        if st is not None and n > 1:
            key = "mxnet_tpu/finalize"
            st.add(key, 1)
            if rank() == 0:
                deadline = time.monotonic() + timeout_s
                while st.add(key, 0) < n and time.monotonic() < deadline:
                    time.sleep(0.01)
        tdist.destroy_process_group()
    _initialized = False
    _store = None
    _barriers.clear()
