"""BERT masked-LM pretraining on a synthetic corpus
(≙ ``example/bert/pretrain.py``).

Each step draws a batch of random tokens from a seeded
``numpy.random.RandomState``, masks 15% of them to id 103 with labels of
-1 elsewhere, runs forward and backward of ``models.bert.loss_fn`` and
one AdamW update per parameter, each with its own step count.  It runs
on the GPU unless ``--device cpu`` is given.

    python -m mxnet_tpu_torch.examples.bert_pretrain --steps 10 \\
        --layers 2 --hidden 128 --device cpu

(defaults are BERT-base sized: --layers 12 --hidden 768)

Launched with more than one worker (``python -m mxnet_tpu_torch.launch
-n 2 --launcher local python -m mxnet_tpu_torch.examples.bert_pretrain``)
it is data-parallel, as the reference's (``pretrain.py:50, 65, 70-81``):
``parallel.dist.initialize()`` joins the job, every rank starts from the
same seeded weights and draws its batches from ``--seed`` + its rank, and
the gradients go through one list ``pushpull`` of a ``dist_sync`` store,
averaged by ``dist.size()``, before the update.  Each rank then prints
one ``dist_report`` JSON line: its backend, loss and step ms a step, the
all-reduce's ms a step and bytes, a sha256 of its flat fp32 parameters
after each step, and the kernels' launch counts; ``--dump-dir`` also
writes step 0's local and reduced gradients of the word embedding and of
the first and last layers' attention weights there
(``grads_rank<r>.npz``).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np
import torch

from .. import context as _context
from .. import optimizer as opt_mod
from ..models import bert

MASK_ID = 103


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--vocab", type=int, default=30522)
    ap.add_argument("--hidden", type=int, default=768)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--heads", type=int, default=12)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights and of the token stream")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current GPU)")
    ap.add_argument("--dump-dir", default=None,
                    help="launched with more than one worker: write step "
                         "0's local and reduced gradients of a few "
                         "parameters here")
    return ap.parse_args(argv)


def config(args) -> bert.BertConfig:
    return bert.BertConfig(vocab_size=args.vocab, hidden=args.hidden,
                           layers=args.layers, heads=args.heads,
                           intermediate=4 * args.hidden,
                           max_len=max(args.seq_len, 512))


def leaf_names(tree, prefix=""):
    """The names of ``models.bert.leaves(tree)``, in its order: dict keys
    sorted, list items by index, joined with ``/``."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in leaf_names(v, f"{prefix}{i}/")]
    return [prefix[:-1]]


def dumped_names(layers):
    """The parameters whose step-0 gradients ``--dump-dir`` keeps."""
    return ["embed/tok"] + [f"layers/{i}/{w}/kernel"
                            for i in (0, layers - 1) for w in ("qkv", "out")]


def params_sha256(flat) -> str:
    """sha256 of the parameters' fp32 bytes, one after another."""
    h = hashlib.sha256()
    for t in flat:
        h.update(t.detach().float().contiguous().cpu().numpy())
    return h.hexdigest()


def synthetic_batch(rng, batch_size, seq_len, vocab):
    """(tokens, labels) int64 numpy arrays: 15% of the positions masked
    to ``MASK_ID``, labels the original tokens there and -1 elsewhere."""
    tokens = rng.randint(5, vocab, (batch_size, seq_len))
    mask = rng.rand(batch_size, seq_len) < 0.15
    labels = np.where(mask, tokens, -1)
    return np.where(mask, MASK_ID, tokens), labels


class Trainer:
    """The params tree, its AdamW states and one train step."""

    def __init__(self, cfg: bert.BertConfig, seed=0, lr=1e-4, device=None):
        self.cfg = cfg
        self.device = _context.resolve(device)
        if self.device.type == "cuda":
            _context.exact_fp32()
        self.params = bert.init_params(cfg, seed, self.device)
        self.flat = bert.leaves(self.params)
        for t in self.flat:
            t.requires_grad_(True)
        self.opt = opt_mod.create("adamw", learning_rate=lr, wd=0.01)
        self.states = [self.opt.create_state(i, w)
                       for i, w in enumerate(self.flat)]

    def grads(self, tokens, labels):
        """(loss, gradients in ``leaves`` order); a parameter the loss
        does not reach (``embed.typ`` without token types) gets zeros,
        as ``jax.grad`` gives it."""
        loss = bert.loss_fn(self.params, self.cfg, tokens, labels)
        gs = torch.autograd.grad(loss, self.flat, allow_unused=True)
        return loss.detach(), [torch.zeros_like(w) if g is None else g
                               for w, g in zip(self.flat, gs)]

    def reduce(self, kv, gs, nproc):
        """The list pushpull of ``gs`` through the dist store ``kv`` (one
        all-reduce), averaged by ``nproc``, in place (≙
        ``pretrain.py:70-81``)."""
        kv.pushpull(list(range(len(gs))), gs, out=gs)
        torch._foreach_div_(gs, float(nproc))

    def update(self, gs):
        """One AdamW update of every parameter, in place."""
        self.opt.update_multi(range(len(self.flat)), self.flat, gs,
                              self.states)

    def step(self, tokens, labels):
        """One train step on numpy (tokens, labels) → the loss tensor."""
        loss, gs = self.grads(torch.as_tensor(tokens, device=self.device),
                              torch.as_tensor(labels, device=self.device))
        self.update(gs)
        return loss


def main(argv=None):
    """Train; → {"losses": [...], "step_s": [...], "tokens_s": x}, and
    with more than one worker also "report" (the ``dist_report`` line).
    Each step ends on the host fetch of its loss, so ``step_s`` is the
    whole step's wall time."""
    from .. import kvstore as kvs
    from ..parallel import dist
    args = parse_args(argv)
    dist.initialize()           # no-op for one process; DMLC_* env
    rank, nproc = dist.rank(), dist.size()
    trainer = Trainer(config(args), args.seed, args.lr, args.device)
    kv = kvs.create("dist_sync") if nproc > 1 else None
    rng = np.random.RandomState(args.seed + rank)
    names = leaf_names(trainer.params)
    dumped = {n: names.index(n) for n in dumped_names(args.layers)}
    losses, step_s, reduce_ms, digests = [], [], [], []
    cuda = trainer.device.type == "cuda"
    for step in range(args.steps):
        tokens, labels = synthetic_batch(rng, args.batch_size, args.seq_len,
                                         args.vocab)
        t0 = time.perf_counter()
        loss, gs = trainer.grads(
            torch.as_tensor(tokens, device=trainer.device),
            torch.as_tensor(labels, device=trainer.device))
        dump = kv is not None and step == 0 and args.dump_dir
        d0 = time.perf_counter()
        if dump:
            local = {n: gs[i].cpu().numpy().copy()
                     for n, i in dumped.items()}
        dump_s = time.perf_counter() - d0
        if kv is not None:
            if cuda:
                torch.cuda.synchronize(trainer.device)
            r0 = time.perf_counter()
            trainer.reduce(kv, gs, nproc)
            if cuda:
                torch.cuda.synchronize(trainer.device)
            reduce_ms.append((time.perf_counter() - r0) * 1e3)
        d0 = time.perf_counter()
        if dump:
            arrays = {f"local/{n}": a for n, a in local.items()}
            arrays.update({f"reduced/{n}": gs[i].cpu().numpy()
                           for n, i in dumped.items()})
            os.makedirs(args.dump_dir, exist_ok=True)
            np.savez(os.path.join(args.dump_dir, f"grads_rank{rank}.npz"),
                     **arrays)
        dump_s += time.perf_counter() - d0
        trainer.update(gs)
        losses.append(float(loss))
        step_s.append(time.perf_counter() - t0 - dump_s)
        if kv is not None:
            digests.append(params_sha256(trainer.flat))
        if step % 5 == 0 and rank == 0:
            print(f"step {step} mlm loss {losses[-1]:.4f}", flush=True)
    tokens_s = None
    if args.steps > 1:
        tokens_s = (args.steps - 1) * args.batch_size * args.seq_len / \
            sum(step_s[1:])
        print(f"[rank {rank}/{nproc}] {tokens_s:.0f} tokens/s", flush=True)
    out = {"losses": losses, "step_s": step_s, "tokens_s": tokens_s}
    if kv is not None:
        from ..parallel.train import kernel_wrappers
        out["report"] = {
            "rank": rank, "size": nproc, "backend": dist.backend(),
            "losses": losses, "step_ms": [t * 1e3 for t in step_s],
            "allreduce_ms": reduce_ms,
            "allreduce_bytes": sum(g.numel() * g.element_size()
                                   for g in trainer.flat),
            "params_sha256": digests,
            "launches": {n: fn.launches
                         for n, fn in kernel_wrappers().items()}}
        # one write: the ranks share the launcher's stdout, and a line
        # written in pieces can interleave with another rank's
        sys.stdout.write("dist_report " + json.dumps(out["report"]) + "\n")
        sys.stdout.flush()
        kv.barrier()
        dist.finalize()
    return out


if __name__ == "__main__":
    main()
