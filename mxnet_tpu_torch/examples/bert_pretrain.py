"""BERT masked-LM pretraining on a synthetic corpus
(≙ ``example/bert/pretrain.py``, single process).

Each step draws a batch of random tokens from a seeded
``numpy.random.RandomState``, masks 15% of them to id 103 with labels of
-1 elsewhere, runs forward and backward of ``models.bert.loss_fn`` and
one AdamW update per parameter, each with its own step count.  It runs
on the GPU unless ``--device cpu`` is given.

    python -m mxnet_tpu_torch.examples.bert_pretrain --steps 10 \\
        --layers 2 --hidden 128 --device cpu

(defaults are BERT-base sized: --layers 12 --hidden 768)
"""
from __future__ import annotations

import argparse
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
    return ap.parse_args(argv)


def config(args) -> bert.BertConfig:
    return bert.BertConfig(vocab_size=args.vocab, hidden=args.hidden,
                           layers=args.layers, heads=args.heads,
                           intermediate=4 * args.hidden,
                           max_len=max(args.seq_len, 512))


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
    """Train; → {"losses": [...], "step_s": [...], "tokens_s": x}.  Each
    step ends on the host fetch of its loss, so ``step_s`` is the whole
    step's wall time."""
    args = parse_args(argv)
    trainer = Trainer(config(args), args.seed, args.lr, args.device)
    rng = np.random.RandomState(args.seed)
    losses, step_s = [], []
    for step in range(args.steps):
        tokens, labels = synthetic_batch(rng, args.batch_size, args.seq_len,
                                         args.vocab)
        t0 = time.perf_counter()
        losses.append(float(trainer.step(tokens, labels)))
        step_s.append(time.perf_counter() - t0)
        if step % 5 == 0:
            print(f"step {step} mlm loss {losses[-1]:.4f}", flush=True)
    tokens_s = None
    if args.steps > 1:
        tokens_s = (args.steps - 1) * args.batch_size * args.seq_len / \
            sum(step_s[1:])
        print(f"{tokens_s:.0f} tokens/s", flush=True)
    return {"losses": losses, "step_s": step_s, "tokens_s": tokens_s}


if __name__ == "__main__":
    main()
