"""Image classification training on synthetic ImageNet-shaped data
(≙ ``example/gluon/image_classification.py``, single process).

A model-zoo CNN (default ResNet-50 v1, 1000 classes) in training mode,
``SoftmaxCrossEntropyLoss``, and ``gluon.Trainer`` with SGD (lr 0.1,
momentum 0.9, wd 1e-4).  A step is the forward in training mode,
``backward`` of the per-sample loss (summed over the batch), then
``trainer.step(batch_size)``.  The batches are NHWC float32 images in
[0, 1) and integer labels drawn from ``numpy.random.RandomState(seed)``
in the reference's order (images, then labels, per step); they are all
drawn and copied to the device before the first step, so the timed
steps hold no host data generation.  It runs on the GPU unless
``--device cpu`` is given, and prints images/s over the steps after the
warm-up ones, as the reference does.

    python -m mxnet_tpu_torch.examples.image_classification --device cpu \\
        --model resnet18_v1 --image-size 32 --batch-size 2 --iters 2
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import context as _context
from ..gluon import Trainer
from ..gluon.loss import SoftmaxCrossEntropyLoss
from ..models import get_model

WARMUP = 2              # untimed steps first, as the reference takes


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="resnet50_v1")
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--classes", type=int, default=1000)
    ap.add_argument("--iters", type=int, default=20,
                    help=f"timed steps, after {WARMUP} warm-up ones")
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--kvstore", default="device")
    ap.add_argument("--rec", default=None,
                    help="RecordIO file (synthetic data if absent)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights and of the data stream")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current GPU)")
    return ap.parse_args(argv)


def synthetic_batch(rng, batch_size, image_size, classes):
    """One (images, labels) numpy batch as the reference draws it."""
    x = rng.rand(batch_size, image_size, image_size, 3).astype("float32")
    y = rng.randint(0, classes, (batch_size,))
    return x, y


def build(args, device):
    """(net, trainer, loss_fn): the model in training mode with weights
    from ``args.seed`` (deferred shapes take theirs at the first
    forward), and the reference's SGD trainer."""
    net = get_model(args.model, classes=args.classes)
    net.initialize(ctx=device, seed=args.seed)
    net.hybridize()
    net.train()
    trainer = Trainer(net.collect_params(), "sgd",
                      {"learning_rate": args.lr, "momentum": 0.9,
                       "wd": 1e-4}, kvstore=args.kvstore)
    return net, trainer, SoftmaxCrossEntropyLoss()


def forward_backward(net, loss_fn, x, y):
    """The per-sample loss of one batch, its gradients written to the
    parameters (``backward`` of the loss sums over the batch, as the
    reference's ``loss.backward()`` does)."""
    loss = loss_fn(net(x), y)
    loss.backward(torch.ones_like(loss))
    return loss.detach()


def _mark(device):
    if device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def _ms(a, b):
    return a.elapsed_time(b) if isinstance(a, torch.cuda.Event) else \
        (b - a) * 1e3


def main(argv=None):
    """Train; → {"img_s", "losses", "step_ms", "steps"}.  ``step_ms`` is
    each step's time on the device's timeline (CUDA events between step
    starts; host time on the CPU); ``img_s`` is over the timed steps, by
    the host clock up to a synchronize, as the reference's ``waitall``."""
    args = parse_args(argv)
    if args.rec:
        raise NotImplementedError(
            "--rec: the ImageRecordIter input path is not ported yet (it is "
            "queued with the input-path modules); run on synthetic data")
    if args.kvstore not in ("device", "local"):
        raise NotImplementedError(
            f"--kvstore {args.kvstore}: only single-process training is "
            f"ported ('device' or 'local'); distributed kvstores belong to "
            f"the host-planes slice")
    if args.iters < 1:
        raise ValueError("--iters must be >= 1")
    device = _context.resolve(args.device)
    if device.type == "cuda":
        _context.exact_fp32()
    net, trainer, loss_fn = build(args, device)
    rng = np.random.RandomState(args.seed)
    steps = WARMUP + args.iters
    batches = []
    for _ in range(steps):
        x, y = synthetic_batch(rng, args.batch_size, args.image_size,
                               args.classes)
        batches.append((torch.as_tensor(x, device=device),
                        torch.as_tensor(y, device=device)))
    losses, marks, tic = [], [], None
    for i, (x, y) in enumerate(batches):
        if i == WARMUP:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            tic = time.perf_counter()
        marks.append(_mark(device))
        losses.append(forward_backward(net, loss_fn, x, y))
        trainer.step(args.batch_size)
    marks.append(_mark(device))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - tic
    ips = args.iters * args.batch_size / dt
    print(f"[rank 0/1] {args.model}: {ips:.1f} img/s "
          f"(batch {args.batch_size})", flush=True)
    return {"img_s": ips, "losses": [float(v.mean()) for v in losses],
            "step_ms": [_ms(a, b) for a, b in zip(marks, marks[1:])],
            "steps": steps}


if __name__ == "__main__":
    main()
