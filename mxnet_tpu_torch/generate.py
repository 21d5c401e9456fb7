"""Autoregressive decode engine — ring KV cache updated in place, eager
PyTorch (≙ ``mxnet_tpu/generate.py``).

The whole mutable decode state of a batch lives in one *ctl block*, a
dict of preallocated tensors — ring K/V caches ``k``/``v`` (layers, B,
S, H, hd), per-row positions ``pos``, the current tokens ``tok``, a step
counter ``t`` — plus ``gen``, the ``torch.Generator`` that sampling
draws from.  Where the reference threads the block through one donated
XLA program per (kind, bucket), this engine updates it IN PLACE: a
decode step writes each row's new K/V into its ring slot and overwrites
``pos``/``tok``/``t``, allocating no new cache.

Ring layout: token ``t`` at slot ``t % S``; a slot is readable once
written (``slot <= pos`` until the ring wraps, every slot after), so the
prefill's pad slots and stale tails are never attended.  ``S`` is the
window (``MXNET_DECODE_CACHE_LEN``, else ``cfg.max_len``): generation
beyond it slides the attention window, generation beyond ``cfg.max_len``
is refused.  Batches and prompts are padded up to bucket ladders
(``MXNET_DECODE_BUCKETS``, ``MXNET_DECODE_PROMPT_BUCKETS``), as in the
reference, so a row's arithmetic does not depend on the batch it rode in.

PyTorch runs eagerly, so the reference's program cache, trace counting,
dispatch fingerprints and route tables have no counterpart here:
``warmup()`` builds the CUDA kernels and runs every rung once,
``retraces`` is always 0.  The tensor-parallel ``mesh=`` path is not
ported.
"""
from __future__ import annotations

import os
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import context as _context
from . import telemetry as _telemetry
from .models import gpt as _gpt

__all__ = ["DecodeEngine", "DEFAULT_BUCKETS", "DEFAULT_PROMPT_BUCKETS",
           "decode_buckets", "prompt_buckets", "snapshot", "restore"]

_US = 1e6

DEFAULT_BUCKETS = (1, 2, 4, 8)
DEFAULT_PROMPT_BUCKETS = (16, 64, 256)


def _ladder(env_name: str, default: Tuple[int, ...],
            buckets: Optional[Sequence[int]]) -> Tuple[int, ...]:
    if buckets is None:
        env = os.environ.get(env_name, "")
        if env.strip():
            buckets = [int(t) for t in env.split(",") if t.strip()]
        else:
            buckets = default
    out = tuple(sorted({int(b) for b in buckets}))
    if not out or out[0] < 1:
        raise ValueError(f"invalid bucket ladder {buckets!r}")
    return out


def decode_buckets(buckets: Optional[Sequence[int]] = None) -> Tuple[int, ...]:
    """Batch-size ladder: explicit argument, else ``MXNET_DECODE_BUCKETS``
    (comma list), else (1, 2, 4, 8)."""
    return _ladder("MXNET_DECODE_BUCKETS", DEFAULT_BUCKETS, buckets)


def prompt_buckets(buckets: Optional[Sequence[int]] = None) -> Tuple[int, ...]:
    """Prompt-length ladder (prefill padding): explicit argument, else
    ``MXNET_DECODE_PROMPT_BUCKETS``, else (16, 64, 256)."""
    return _ladder("MXNET_DECODE_PROMPT_BUCKETS", DEFAULT_PROMPT_BUCKETS,
                   buckets)


def snapshot(ctl) -> dict:
    """Host copy of a ctl block — the *seek* primitive.  Restoring it
    later resumes decoding bit for bit from that point.  The generator
    is saved as its state."""
    out = {k: v.cpu().numpy().copy() for k, v in ctl.items() if k != "gen"}
    out["gen"] = ctl["gen"].get_state().numpy().copy()
    return out


def restore(snap, device=None) -> dict:
    """Device ctl block from a :func:`snapshot` host copy."""
    device = _context.resolve(device)
    ctl = {k: torch.from_numpy(v).to(device) for k, v in snap.items()
           if k != "gen"}
    gen = torch.Generator(device=device)
    gen.set_state(torch.from_numpy(snap["gen"]))
    ctl["gen"] = gen
    return ctl


def _pick(gen, logits, temperature):
    """Next-token rule: greedy argmax (first index on ties) at
    temperature 0, else a categorical draw from ``gen``."""
    if temperature > 0.0:
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]
    return torch.argmax(logits, dim=-1)


class DecodeEngine:
    """Decode state machine for one GPT model over a bucket ladder.

    Parameters
    ----------
    params : dict
        ``models.gpt`` params tree; moved to ``device`` (shared by every
        batch, never written).
    cfg : models.gpt.GPTConfig
    window : int, optional
        Ring cache length S; default ``MXNET_DECODE_CACHE_LEN``, else
        ``cfg.max_len``.
    buckets, prompts : sequences, optional
        Batch / prompt-length ladders.  Prompt rungs longer than the
        window are dropped (the prefill must fit the ring).
    temperature : float
        0 (default) decodes greedily; > 0 samples.
    seed : int
        Seeds the generators that sampling draws from.
    device : optional
        Default: the current CUDA device; raises without a card unless
        ``device="cpu"`` is given.
    """

    def __init__(self, params, cfg, name: str = "gpt",
                 window: Optional[int] = None,
                 buckets: Optional[Sequence[int]] = None,
                 prompts: Optional[Sequence[int]] = None,
                 temperature: float = 0.0, seed: int = 0, device=None):
        self.device = _context.resolve(device)
        if self.device.type == "cuda":
            _context.exact_fp32()
        self.params = _gpt.params_to(params, self.device)
        self.param_bytes = sum(
            t.numel() * t.element_size()
            for t in _flat(self.params))
        self.cfg = cfg
        self.name = name
        if window is None:
            try:
                window = int(os.environ.get("MXNET_DECODE_CACHE_LEN", ""))
            except ValueError:
                window = cfg.max_len
        self.window = int(window)
        if self.window < 1:
            raise ValueError(f"invalid cache window {window!r}")
        self.buckets = decode_buckets(buckets)
        self.prompt_buckets = tuple(t for t in prompt_buckets(prompts)
                                    if t <= self.window)
        if not self.prompt_buckets:
            raise ValueError(
                f"no prompt bucket fits the cache window {self.window}")
        self.temperature = float(temperature)
        self._seeds = torch.Generator().manual_seed(int(seed))
        self._warm = False
        self.retraces = 0
        self._mu = threading.Lock()

    # ----------------------------------------------------------- plumbing
    def _cache_shape(self, b: int) -> tuple:
        cfg = self.cfg
        return (cfg.layers, b, self.window, cfg.heads,
                cfg.hidden // cfg.heads)

    def _generator(self) -> torch.Generator:
        with self._mu:
            seed = int(torch.randint(0, 2 ** 62, (1,),
                                     generator=self._seeds))
        return torch.Generator(device=self.device).manual_seed(seed)

    def empty_ctl(self, b: int) -> dict:
        """Fresh all-rows-idle ctl block for a B-row continuous batch:
        pos -1 marks a row as never prefilled (its ring stays masked)."""
        dev = self.device
        return {"k": torch.zeros(self._cache_shape(b), dtype=self.cfg.dtype,
                                 device=dev),
                "v": torch.zeros(self._cache_shape(b), dtype=self.cfg.dtype,
                                 device=dev),
                "pos": torch.full((b,), -1, dtype=torch.long, device=dev),
                "tok": torch.zeros((b,), dtype=torch.long, device=dev),
                "t": torch.zeros((), dtype=torch.long, device=dev),
                "gen": self._generator()}

    def _pad(self, prompts, b, tb):
        toks = np.zeros((b, tb), np.int64)
        lens = np.ones((b,), np.int64)
        for i, p in enumerate(prompts):
            toks[i, :len(p)] = p
            lens[i] = len(p)
        return (torch.from_numpy(toks).to(self.device),
                torch.from_numpy(lens).to(self.device))

    # -------------------------------------------------------------- kinds
    @torch.no_grad()
    def prefill(self, prompts: List[Sequence[int]]) -> dict:
        """A new ctl block for a batch: prompts padded to their bucket
        (B, T); their K/V seed ring slots [0, T), the first token is
        picked from each prompt's last position."""
        b = self.bucket_for(len(prompts))
        tb = self.prompt_bucket_for(max(len(p) for p in prompts))
        toks, lens = self._pad(prompts, b, tb)
        ctl = self.empty_ctl(b)
        logits, ks, vs = _gpt.prefill(self.params, self.cfg, toks)
        ctl["k"][:, :, :tb] = ks
        ctl["v"][:, :, :tb] = vs
        ctl["pos"].copy_(lens - 1)
        last = logits[torch.arange(b, device=self.device), lens - 1]
        ctl["tok"].copy_(_pick(ctl["gen"], last, self.temperature))
        return ctl

    @torch.no_grad()
    def step(self, ctl: dict) -> dict:
        """One decode step for every row of ``ctl``, in place."""
        ctl["pos"] += 1
        logits, _, _ = _gpt.decode_step(self.params, self.cfg, ctl["tok"],
                                        ctl["pos"], ctl["k"], ctl["v"])
        ctl["tok"].copy_(_pick(ctl["gen"], logits, self.temperature))
        ctl["t"] += 1
        return ctl

    @torch.no_grad()
    def join(self, ctl: dict, prompt: Sequence[int], slot: int) -> dict:
        """Continuous-batching prefill: prefill one prompt at B=1 and
        splice its cache rows, position and first token into row
        ``slot`` of a running batch's ctl block, in place."""
        tb = self.prompt_bucket_for(len(prompt))
        toks, _ = self._pad([prompt], 1, tb)
        logits, ks, vs = _gpt.prefill(self.params, self.cfg, toks)
        for cache, new in ((ctl["k"], ks), (ctl["v"], vs)):
            cache[:, slot, :tb] = new[:, 0]
            cache[:, slot, tb:] = 0
        ctl["pos"][slot] = len(prompt) - 1
        ctl["tok"][slot] = _pick(ctl["gen"], logits[0, len(prompt) - 1][None],
                                 self.temperature)[0]
        return ctl

    # ------------------------------------------------------------- ladder
    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"batch of {n} exceeds max bucket "
                         f"{self.buckets[-1]}")

    def prompt_bucket_for(self, n: int) -> int:
        for t in self.prompt_buckets:
            if n <= t:
                return t
        raise ValueError(f"prompt of {n} exceeds max prompt bucket "
                         f"{self.prompt_buckets[-1]}")

    def warmup(self):
        """Build the CUDA kernels and run prefill + join + step once for
        every rung of the ladder."""
        with _telemetry.timed("decode.warmup_us"):
            for b in self.buckets:
                for tb in self.prompt_buckets:
                    ctl = self.prefill([[0] * tb] * b)
                    self.join(ctl, [0] * tb, 0)
                self.step(ctl)
                ctl["tok"].cpu()
        with self._mu:
            self._warm = True
        return self

    @property
    def warm(self) -> bool:
        return self._warm

    # ------------------------------------------------------------- decode
    def generate(self, prompts: List[Sequence[int]],
                 max_new: int) -> List[List[int]]:
        """Greedy/sampled batch decode: ``max_new`` tokens per prompt.
        One prefill, then one step per token; the host reads only the
        emitted token ids."""
        if not prompts or max_new < 1:
            raise ValueError("need >= 1 prompt and max_new >= 1")
        longest = max(len(p) for p in prompts)
        if longest < 1:
            raise ValueError("empty prompt")
        if longest + max_new > self.cfg.max_len:
            raise ValueError(
                f"prompt {longest} + max_new {max_new} exceeds max_len "
                f"{self.cfg.max_len}")
        n = len(prompts)
        with _telemetry.span("decode.generate", model=self.name,
                             max_new=max_new):
            t0 = time.perf_counter()
            ctl = self.prefill(prompts)
            first = ctl["tok"].tolist()
            _telemetry.observe("decode.prefill_us",
                               (time.perf_counter() - t0) * _US)
            _telemetry.counter_add("decode.prefills")
            kv_bytes = 2 * ctl["k"].numel() * ctl["k"].element_size()
            _telemetry.gauge_set("decode.kv_cache_bytes", kv_bytes)
            _telemetry.gauge_set("decode.kv_bytes_per_device", kv_bytes)
            outs = [[first[i]] for i in range(n)]
            for _ in range(max_new - 1):
                t0 = time.perf_counter()
                tok = self.step(ctl)["tok"].tolist()
                _telemetry.observe("decode.decode_step_us",
                                   (time.perf_counter() - t0) * _US)
                _telemetry.counter_add("decode.steps")
                for i in range(n):
                    outs[i].append(tok[i])
            _telemetry.counter_add("decode.tokens", n * max_new)
        return outs

    # -------------------------------------------------------------- admin
    def stats(self) -> dict:
        with self._mu:
            return {"name": self.name, "window": self.window,
                    "buckets": list(self.buckets),
                    "prompt_buckets": list(self.prompt_buckets),
                    "temperature": self.temperature,
                    "warm": self._warm, "retraces": self.retraces,
                    "device": str(self.device),
                    "param_bytes": self.param_bytes}


def _flat(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _flat(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _flat(v)
    else:
        yield tree
