"""Image classification training on synthetic ImageNet-shaped data or
a RecordIO file (≙ ``example/gluon/image_classification.py``, single
process).

A model-zoo CNN (default ResNet-50 v1, 1000 classes; ``--model
resnet50_v2`` trains v2, whose stride-1 3x3 convs take the standalone
conv route) in training mode, ``SoftmaxCrossEntropyLoss``, and
``gluon.Trainer`` with SGD (lr 0.1, momentum 0.9, wd 1e-4).  A step is
the forward in training mode under ``autograd.record()``, ``backward`` of
the per-sample loss (summed over the batch), then
``trainer.allreduce_grads()`` and ``trainer.update(batch_size)``, the
Gluon idiom that ``trainer.step(batch_size)`` abbreviates.  The batches
are NHWC float32 images in [0, 1) and integer labels drawn from
``numpy.random.RandomState(seed)`` in the reference's order (images,
then labels, per step); they are all drawn and copied to the device
before the first step, so the timed steps hold no host data
generation.  With ``--rec``, the batches come from the file through
``io.ImageRecordIter(rec, data_shape=(3, S, S), batch_size=B,
shuffle=True)`` as the reference feeds them (the python decode tier; each
batch copied to the device in the step), epoch after epoch, Python's
``random`` seeded with ``--seed`` first; ``--pipeline datafeed`` takes
the native loader and ``io.DataFeed`` instead (uint8 on the wire, the
cast and normalize on the device), with ``--resize``, ``--rand-crop``,
``--rand-mirror`` and ``--normalize`` (ImageNet's mean and std) for
either route.  It runs on the GPU unless ``--device cpu`` is given, and
prints images/s over the steps after the warm-up ones, as the reference
does.

    python -m mxnet_tpu_torch.examples.image_classification --device cpu \\
        --model resnet18_v1 --image-size 32 --batch-size 2 --iters 2
"""
from __future__ import annotations

import argparse
import random
import time

import numpy as np
import torch

from .. import autograd
from .. import context as _context
from .. import io as _io
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
    ap.add_argument("--pipeline", default=None, choices=("datafeed",),
                    help="with --rec: the native loader into io.DataFeed")
    ap.add_argument("--resize", type=int, default=0,
                    help="with --rec: resize the short side first")
    ap.add_argument("--rand-crop", action="store_true")
    ap.add_argument("--rand-mirror", action="store_true")
    ap.add_argument("--normalize", action="store_true",
                    help="with --rec: subtract ImageNet's mean, divide by "
                         "its std")
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


def record_iter(args, device):
    """``io.ImageRecordIter`` over ``args.rec`` as the example feeds it
    (the python tier, or ``DataFeed`` with ``--pipeline datafeed``)."""
    from ..image import IMAGENET_MEAN, IMAGENET_STD
    kw = {}
    if args.resize:
        kw["resize"] = args.resize
    if args.rand_crop:
        kw["rand_crop"] = True
    if args.rand_mirror:
        kw["rand_mirror"] = True
    if args.normalize:
        kw["mean"], kw["std"] = IMAGENET_MEAN, IMAGENET_STD
    if args.pipeline:
        kw.update(pipeline=args.pipeline, device=device, seed=args.seed)
    return _io.ImageRecordIter(
        args.rec, data_shape=(3, args.image_size, args.image_size),
        batch_size=args.batch_size, shuffle=True, **kw)


def record_batches(it, device):
    """(images, labels) on ``device`` from ``it``, epoch after epoch."""
    while True:
        it.reset()
        for b in it:
            yield (b.data[0].to(device),
                   b.label[0].reshape(-1).to(device, torch.int64))


def build(args, device, lr_scheduler=None):
    """(net, trainer, loss_fn): the model in training mode with weights
    from ``args.seed`` (deferred shapes take theirs at the first
    forward), and the reference's SGD trainer, under ``lr_scheduler``
    when one is given."""
    net = get_model(args.model, classes=args.classes)
    net.initialize(ctx=device, seed=args.seed)
    net.hybridize()
    net.train()
    opt = {"learning_rate": args.lr, "momentum": 0.9, "wd": 1e-4}
    if lr_scheduler is not None:
        opt["lr_scheduler"] = lr_scheduler
    trainer = Trainer(net.collect_params(), "sgd", opt,
                      kvstore=args.kvstore)
    return net, trainer, SoftmaxCrossEntropyLoss()


def forward_backward(net, loss_fn, x, y):
    """The per-sample loss of one batch, its gradients written to the
    parameters (``backward`` of the loss sums over the batch, as the
    reference's ``loss.backward()`` does)."""
    loss = loss_fn(net(x), y)
    loss.backward(torch.ones_like(loss))
    return loss.detach()


def train_step(net, trainer, loss_fn, x, y):
    """One step as a Gluon user writes it: the forward and the loss under
    ``autograd.record()``, ``backward``, ``trainer.allreduce_grads()``
    and ``trainer.update(batch)``; → (per-sample loss, logits),
    detached."""
    with autograd.record():
        out = net(x)
        loss = loss_fn(out, y)
    loss.backward(torch.ones_like(loss))
    trainer.allreduce_grads()
    trainer.update(int(x.shape[0]))
    return loss.detach(), out.detach()


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
    """Train; → {"img_s", "losses", "step_ms", "steps", "feed_stats"}.
    ``step_ms`` is each step's time on the device's timeline (CUDA events
    between step starts, so a step holds the wait for the next batch;
    host time on the CPU); ``img_s`` is over the timed steps, by the host
    clock up to a synchronize, as the reference's ``waitall``;
    ``feed_stats`` is ``DataFeed.stats()`` with ``--pipeline datafeed``,
    else None."""
    args = parse_args(argv)
    if args.pipeline and not args.rec:
        raise ValueError("--pipeline needs --rec")
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
    steps = WARMUP + args.iters
    if args.rec:
        random.seed(args.seed)
        it = record_iter(args, device)
        feed = record_batches(it, device)
        batches = (next(feed) for _ in range(steps))
    else:
        rng = np.random.RandomState(args.seed)
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
        losses.append(train_step(net, trainer, loss_fn, x, y)[0])
    marks.append(_mark(device))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - tic
    feed_stats = None
    if args.rec:
        stats = getattr(it, "stats", None)
        feed_stats = stats() if callable(stats) else None
        it.close()
    ips = args.iters * args.batch_size / dt
    print(f"[rank 0/1] {args.model}: {ips:.1f} img/s "
          f"(batch {args.batch_size})", flush=True)
    return {"img_s": ips, "losses": [float(v.mean()) for v in losses],
            "step_ms": [_ms(a, b) for a, b in zip(marks, marks[1:])],
            "steps": steps, "feed_stats": feed_stats}


if __name__ == "__main__":
    main()
