"""The dist KVStore's multi-process worker programs (≙ the JAX package's
``tests/nightly/dist_sync_kvstore.py``, ``dist_async_train.py``,
``dist_device_sync_train.py`` and ``dist_async_multiserver.py``, the
reference's nightly tier run under ``--launcher local``):

    python -m mxnet_tpu_torch.launch -n 4 --launcher local \\
        python -m mxnet_tpu_torch.kvstore.nightly dist_sync_kvstore \\
        --device cpu

Each worker joins the job from the ``DMLC_*`` contract
(``parallel.dist.initialize``), asserts the program's cross-worker
invariants numerically, prints ``[worker r/n] <name> OK`` and exits 0
(the launcher propagates a failure):

- ``dist_sync_kvstore`` (any n): pushpull of rank-dependent values is the
  sum over ranks, alone and as one batched list; 2-bit compression's
  residual; a row-sparse pull of an aggregated table; a row-sparse
  gradient's pushpull; the barrier.
- ``dist_async_train`` (n ≥ 1): a Dense net through
  ``Trainer(kvstore="dist_async")`` on different data a rank: the loss
  falls, and after a barrier every worker pulls the same weights.
- ``dist_device_sync_train`` (n ≥ 1): the same through
  ``dist_device_sync`` with Adam: the held-out loss falls and the
  replicas are equal.
- ``dist_async_multiserver`` (``-s`` ≥ 2): S distinct servers,
  round-robin ownership, accumulation across workers, big-array slicing
  and a server-side optimizer on every shard of a sliced key.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

__all__ = ["main", "PROGRAMS"]


def _setup(args):
    from ..parallel import dist
    dist.initialize()
    return dist, torch.device(args.device or "cpu")


def _all_equal_to_rank0(t: torch.Tensor) -> bool:
    import torch.distributed as tdist
    ref = t.detach().cpu().clone()
    tdist.broadcast(ref, 0)
    return torch.equal(ref, t.detach().cpu())


def dist_sync_kvstore(args) -> str:
    from .. import kvstore as kvs
    from ..sparse import RowSparseNDArray
    dist, dev = _setup(args)
    nproc, rank = dist.size(), dist.rank()
    assert nproc == int(os.environ["DMLC_NUM_WORKER"]), nproc
    kv = kvs.create("dist_sync")
    assert kv.num_workers == nproc and kv.rank == rank

    # 1. pushpull: rank r contributes (r+1) * ones → sum = N(N+1)/2
    g = torch.full((4, 3), float(rank + 1), device=dev)
    out = torch.zeros(4, 3, device=dev)
    kv.pushpull(9, g, out=out)
    expect = nproc * (nproc + 1) / 2.0
    assert torch.allclose(out, torch.full_like(out, expect)), (rank, out)

    # 1b. batched pushpull: the whole key set in ONE all-reduce
    keys = [0, 1, 2]
    gs = [torch.full((3,), float((rank + 1) * (k + 1)), device=dev)
          for k in keys]
    kv.pushpull(keys, gs, out=gs)
    for k, gk in zip(keys, gs):
        assert torch.allclose(gk, torch.full_like(gk, expect * (k + 1))), \
            (rank, k, gk)

    # 2. the store's barrier, then rank 0's value reaches everyone
    val = torch.full((2, 2), 7.0) if rank == 0 else torch.zeros(2, 2)
    import torch.distributed as tdist
    tdist.broadcast(val, 0)
    assert torch.allclose(val, torch.full_like(val, 7.0)), rank

    # 3. 2-bit compression (≙ dist_sync_kvstore.py:232 verify_residual):
    # 0.3 < the 0.5 threshold quantizes to 0 everywhere; the residual
    # makes the second push (0.3 + 0.3 = 0.6) quantize to +0.5 a worker
    kvc = kvs.create("dist_sync")
    kvc.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    o3 = torch.zeros(8, device=dev)
    kvc.pushpull(100, torch.full((8,), 0.3, device=dev), out=o3)
    assert torch.all(o3 == 0.0), (rank, o3)
    kvc.pushpull(100, torch.full((8,), 0.3, device=dev), out=o3)
    assert torch.allclose(o3, torch.full_like(o3, 0.5 * nproc)), (rank, o3)

    # 4. row-sparse pull of an aggregated table (≙ :330 check_row_sparse)
    kv.init("table", torch.zeros(6, 2, device=dev))
    ot = torch.zeros(6, 2, device=dev)
    kv.pushpull("table", torch.full((6, 2), float(rank + 1), device=dev),
                out=ot)
    kv.init("table_sum", ot)
    rs = kv.row_sparse_pull("table_sum",
                            row_ids=torch.tensor([0, (rank + 1) % 6]))
    assert torch.allclose(rs.data, torch.full_like(rs.data, expect)), rank

    # 4b. a row-sparse gradient: each worker touches its own rows; the
    # aggregate lands only on the union of touched rows
    rsg = RowSparseNDArray(torch.full((2, 3), float(rank + 1), device=dev),
                           [rank % 6, (rank + 1) % 6], (6, 3))
    o4 = torch.zeros(6, 3, device=dev)
    kv.pushpull("rs_table", rsg, out=o4)
    want = np.zeros((6, 3), np.float32)
    for r in range(nproc):
        want[r % 6] += r + 1
        want[(r + 1) % 6] += r + 1
    assert np.allclose(o4.cpu().numpy(), want), (rank, o4)
    kv.init("rs_sum", o4)
    picked = kv.row_sparse_pull("rs_sum", row_ids=torch.tensor([rank % 6]))
    assert np.allclose(picked.data.cpu().numpy(), want[rank % 6]), rank

    # 5. barrier
    kv.barrier()
    dist.finalize()
    return f"[worker {rank}/{nproc}] dist_sync_kvstore OK"


def dist_async_train(args) -> str:
    from .. import autograd, gluon
    from ..gluon import loss as gloss
    from ..gluon import nn
    import mxnet_tpu_torch as mx
    dist, dev = _setup(args)
    nproc, rank = dist.size(), dist.rank()
    mx.seed(7)                    # identical init on every worker
    net = nn.Dense(1, in_units=4)
    net.initialize(ctx=dev)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.05}, kvstore="dist_async")
    assert trainer._update_on_kvstore
    lf = gloss.L2Loss()
    rng = np.random.RandomState(100 + rank)    # different data a worker
    X = torch.as_tensor(rng.rand(64, 4).astype(np.float32), device=dev)
    Y = X.sum(dim=1, keepdim=True) * 0.5
    first = last = None
    for _ in range(40):
        with autograd.record():
            lv = lf(net(X), Y).mean()
        lv.backward()
        trainer.step(1)
        last = float(lv.detach())
        first = last if first is None else first
    assert last < first * 0.2, (rank, first, last)

    # after a barrier every worker sees the same server weights
    kv = trainer._kvstore
    kv.barrier()
    w = torch.zeros_like(net.weight)
    kv.pull(0, out=w)
    assert _all_equal_to_rank0(w), rank
    kv.barrier()
    dist.finalize()
    return (f"[worker {rank}/{nproc}] dist_async_train OK "
            f"(loss {first:.4f} -> {last:.4f})")


def dist_device_sync_train(args) -> str:
    from .. import autograd, gluon
    from ..gluon import nn
    import mxnet_tpu_torch as mx
    dist, dev = _setup(args)
    nproc, rank = dist.size(), dist.rank()
    mx.seed(42)                   # identical init on every worker
    net = nn.HybridSequential()
    net.add(nn.Dense(16, activation="relu", in_units=8),
            nn.Dense(2, in_units=16))
    net.initialize(ctx=dev)
    from .. import kvstore as kvs
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 0.01},
                            kvstore=kvs.create("dist_device_sync"))
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    hrng = np.random.RandomState(7)   # the same held-out batch everywhere
    hx = torch.as_tensor(hrng.rand(128, 8).astype("float32"), device=dev)
    hy = (hx[:, 0] > hx[:, 1]).long()

    def held_out_loss():
        with torch.no_grad():
            return float(loss_fn(net(hx), hy).mean())

    first = held_out_loss()
    rng = np.random.RandomState(100 + rank)      # DIFFERENT data a rank
    for _ in range(30):
        x = torch.as_tensor(rng.rand(32, 8).astype("float32"), device=dev)
        y = (x[:, 0] > x[:, 1]).long()
        with autograd.record():
            loss = loss_fn(net(x), y).mean()
        loss.backward()
        trainer.step(32 * nproc)
    last = held_out_loss()
    for name, p in net.collect_params().items():
        assert _all_equal_to_rank0(p), \
            f"rank {rank}: param {name} diverged from rank 0"
    assert last < first, (first, last)
    dist.finalize()
    return (f"[worker {rank}/{nproc}] dist sync training OK "
            f"(loss {first:.3f}->{last:.3f})")


def dist_async_multiserver(args) -> str:
    from .. import kvstore as kvs
    from .. import optimizer as opt_mod
    os.environ.setdefault("MXNET_KVSTORE_BIGARRAY_BOUND", "1000")
    dist, dev = _setup(args)
    nproc, rank = dist.size(), dist.rank()
    nserv = int(os.environ.get("DMLC_NUM_SERVER", "1"))
    assert nserv >= 2, "this program needs DMLC_NUM_SERVER >= 2"
    kv = kvs.create("dist_async")

    # 1. S distinct server connections
    group = kv._client
    assert group.n == nserv, group.n
    addrs = {c._sock.getpeername() for c in group.clients}
    assert len(addrs) == nserv, addrs

    # 2. round-robin ownership + accumulation across workers (no
    # optimizer: pushes accumulate on the server)
    keys = list(range(6))
    for k in keys:
        kv.init(k, torch.zeros(4))
    kv.barrier()
    for k in keys:
        kv.push(k, torch.full((4,), float(rank + 1), device=dev))
    kv.barrier()
    expect = nproc * (nproc + 1) / 2.0
    for k in keys:
        out = torch.zeros(4, device=dev)
        kv.pull(k, out=out)
        assert torch.allclose(out, torch.full_like(out, expect)), \
            (rank, k, out)
        assert group._sid(k) == k % nserv

    # 3. big-array slicing: 5000 elements >= bound 1000 → S flat chunks
    big = torch.arange(5000, dtype=torch.float32).reshape(50, 100)
    kv.init("big", big)
    assert "big" in group._shapes, "big tensor was not sliced"
    kv.barrier()
    kv.push("big", torch.ones(50, 100, device=dev))
    kv.barrier()
    out = torch.zeros(50, 100, device=dev)
    kv.pull("big", out=out)
    assert torch.allclose(out.cpu(), big + nproc), rank

    # 4. a server-side optimizer applies on every shard of a sliced key;
    # merge off for this store: only rank 0 pushes, so a WorkersMerge
    # round would never fill and each shard would wait out the timeout
    kv2 = kvs.create("dist_async", use_workers_merge=False)
    kv2.init("w", torch.zeros(4000))
    assert "w" in kv2._client._shapes
    kv2.set_optimizer(opt_mod.create("sgd", learning_rate=0.5))
    kv2.barrier()
    if rank == 0:
        kv2.push("w", torch.ones(4000, device=dev))
    kv2.barrier()
    out = torch.zeros(4000, device=dev)
    kv2.pull("w", out=out)
    assert torch.allclose(out, torch.full_like(out, -0.5)), (rank, out[:4])
    kv.barrier()
    dist.finalize()
    return (f"[worker {rank}/{nproc}] dist_async_multiserver OK "
            f"({nserv} servers)")


PROGRAMS = {f.__name__: f for f in (dist_sync_kvstore, dist_async_train,
                                    dist_device_sync_train,
                                    dist_async_multiserver)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.kvstore.nightly",
        description="a dist KVStore worker program (run it under "
                    "python -m mxnet_tpu_torch.launch)")
    ap.add_argument("program", choices=sorted(PROGRAMS))
    ap.add_argument("--device", default=None,
                    help="where the worker's tensors live (default: the "
                         "CPU)")
    args = ap.parse_args(argv)
    print(PROGRAMS[args.program](args), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
