"""The data-feed gate (≙ ``mxnet_tpu/io/feedcheck.py``) over the port's
native loader (``NativeImageRecordIter`` on the host decode stage).

It writes small synthetic ``.rec`` files through ``recordio.pack_img``
and checks, end to end through the loader:

- the stage decodes JPEG with a library (``libjpeg`` or ``nvjpeg``), the
  loader reports it, ``decode="auto"`` takes it and asking for the other
  one raises;
- at 8/8 (no resize), the loader's pixels against the python tier's
  ``image.imdecode`` of the same records, cropped alike: bit for bit
  under libjpeg; under nvJPEG (batched against single decodes) the
  largest difference is reported, and two epochs must agree bit for bit;
- with a resize of the short side that lets libjpeg decode at a DCT
  scale M/8, every image takes the 2/8 scale and the pixels stay within
  ``SCALED_PARITY_TOL`` of a full decode resized alike;
- PNG and progressive-JPEG records decode through the loader as the
  python tier decodes them (bit for bit under libjpeg; PNG bit for bit
  always, zlib on both sides);
- ``stats_reset`` zeroes the counters without touching the queue;
- worker scaling: a 4-worker loader's fastest epoch beats a 1-worker
  one's by ``SCALING_MIN_X``, enforced where ``os.cpu_count() >= 4``
  (``SCALING_EPOCHS`` timed epochs of ``SCALING_IMAGES`` images each,
  taken in turns; the fastest, as ``timeit`` takes the least time,
  because a host shared with other machines only ever slows an epoch).

``summary()`` returns the whole result as one dict.
"""
import json
import os
import shutil
import tempfile
import time

SCALING_MIN_X = 1.5          # 4-worker vs 1-worker floor (relative)
SCALED_PARITY_TOL = 32       # max |scaled - full| at a DCT scale < 8/8
SCALING_IMAGES = 192         # 24 tickets of 8: six a worker at 4 workers
SCALING_EPOCHS = 7           # timed epochs a worker count, taken in turns


def _gradient_image(onp, size, phase):
    """A smooth low-frequency gradient (JPEG-friendly content)."""
    ramp = onp.linspace(0.0, 255.0, size, dtype=onp.float32)
    xx = onp.tile(ramp, (size, 1))
    yy = xx.T
    img = onp.stack([
        (xx + phase) % 256.0,
        (yy + 2.0 * phase) % 256.0,
        ((xx + yy) / 2.0 + 3.0 * phase) % 256.0,
    ], axis=-1)
    return img.astype(onp.uint8)


def build_rec(dirpath, name, n=16, size=96, encode=".jpg",
              progressive=False, quality=92):
    """Write ``n`` synthetic images as an indexed ``.rec`` / ``.idx`` pair
    (``encode`` ".jpg" or ".png"); → the ``.rec`` path."""
    import numpy as onp

    from .. import recordio as mrec
    from ..image import imencode

    rec_path = os.path.join(dirpath, name + ".rec")
    idx_path = os.path.join(dirpath, name + ".idx")
    w = mrec.MXIndexedRecordIO(idx_path, rec_path, "w")
    for i in range(n):
        img = _gradient_image(onp, size, 11.0 * i)
        buf = imencode(img, encode, quality, progressive=progressive)
        w.write_idx(i, mrec.pack(mrec.IRHeader(0, float(i), i, 0), buf))
    w.close()
    return rec_path


def _epoch(it):
    """Drain one epoch; → (batches, samples, seconds)."""
    batches = samples = 0
    t0 = time.perf_counter()
    while True:
        try:
            data, _label, pad = it.next_raw()
        except StopIteration:
            break
        batches += 1
        samples += data.shape[0] - pad
    return batches, samples, time.perf_counter() - t0


def _scaling(rec):
    """Images/s of a 1-worker and a 4-worker loader over ``rec``: one warm
    epoch each, then ``SCALING_EPOCHS`` timed epochs a loader, in turns,
    so that a slow moment of the host lands on one epoch and not on one
    worker count; → {workers: [images/s of each timed epoch]}.  A loader
    is reset just before its epoch is drained, so that its workers never
    prefetch while the other loader is timed."""
    from . import NativeImageRecordIter

    its = {nw: NativeImageRecordIter(
        path_imgrec=rec, data_shape=(3, 56, 56), batch_size=8,
        preprocess_threads=nw, resize=64, shuffle=False, dtype="uint8")
        for nw in (1, 4)}
    rates = {nw: [] for nw in its}
    try:
        for it in its.values():
            _epoch(it)                   # warm: page cache, pools, decoders
        for _ in range(SCALING_EPOCHS):
            for nw, it in its.items():
                it.reset()
                _b, samples, dt = _epoch(it)
                rates[nw].append(samples / dt if dt > 0 else 0.0)
    finally:
        for it in its.values():
            it.close()
    return rates


def _collect(it):
    """The epoch's data concatenated, and the final stats."""
    import numpy as onp

    out = []
    while True:
        try:
            data, _label, pad = it.next_raw()
        except StopIteration:
            break
        out.append(data[:data.shape[0] - pad] if pad else data.copy())
    return onp.concatenate(out, axis=0), it.stats()


def _python_tier(rec, h, w, resize=-1):
    """The python tier's decode of every record, resized like the
    loader (linear, short side) and center-cropped, NCHW uint8."""
    import numpy as onp

    from .. import recordio as mrec
    from ..image import imdecode, imresize

    r = mrec.MXIndexedRecordIO(os.path.splitext(rec)[0] + ".idx", rec, "r")
    out = []
    for k in r.keys:
        img = imdecode(mrec.unpack(r.read_idx(k))[1])
        if resize > 0:
            s = resize / min(img.shape[:2])
            img = imresize(img, max(1, int(img.shape[1] * s)),
                           max(1, int(img.shape[0] * s)), 1)
        y0 = (img.shape[0] - h) // 2
        x0 = (img.shape[1] - w) // 2
        out.append(img[y0:y0 + h, x0:x0 + w].transpose(2, 0, 1))
    r.close()
    return onp.stack(out)


def _maxdiff(a, b):
    import numpy as onp
    return int(onp.abs(a.astype(onp.int16) - b.astype(onp.int16)).max())


def summary(workdir=None):
    """Run every check against the native loader; → the result dict
    (``ok``, ``checks`` and the measurements).  A failed check does not
    raise; a loader that cannot start does."""
    from . import NativeImageRecordIter
    from ..image import decoder_info

    own_dir = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="mxt_feedcheck_")
    checks = {}
    res = {"cpu_count": os.cpu_count() or 1,
           "scaling_min_x": SCALING_MIN_X}
    try:
        lib = decoder_info()["jpeg"]
        res["decode_backend"] = lib
        probe = build_rec(workdir, "probe", n=4, size=64)
        kw = dict(path_imgrec=probe, data_shape=(3, 64, 64), batch_size=4,
                  preprocess_threads=1)
        st = NativeImageRecordIter(decode="auto", **kw).stats()
        other = "nvjpeg" if lib == "libjpeg" else "libjpeg"
        try:
            NativeImageRecordIter(decode=other, **kw)
            refused = False
        except RuntimeError as e:
            refused = other in str(e)
        checks["backend_selected"] = (lib != "none" and
                                      st["decode_backend"] == lib and
                                      refused)

        def native(rec, shape, resize, batch, workers=2):
            return _collect(NativeImageRecordIter(
                path_imgrec=rec, data_shape=shape, batch_size=batch,
                preprocess_threads=workers, resize=resize, shuffle=False,
                dtype="uint8"))

        # 8/8: the loader against the python tier, and against itself
        rec88 = build_rec(workdir, "par88", n=8, size=64)
        a, sa = native(rec88, (3, 64, 64), -1, 4)
        b = _python_tier(rec88, 64, 64)
        a2, _ = native(rec88, (3, 64, 64), -1, 4, workers=1)
        res["parity88_max_diff"] = _maxdiff(a, b)
        checks["decode_deterministic"] = bool((a == a2).all())
        if lib == "libjpeg":
            checks["parity_exact_at_8_8"] = (
                res["parity88_max_diff"] == 0 and sa["jpeg_decodes"] == 8
                and sa["scale_counts"]["8"] == 8)
            # a DCT scale: 256 px, short side to 64 → 2/8 for every image
            rec28 = build_rec(workdir, "par28", n=8, size=256)
            a, sa = native(rec28, (3, 56, 56), 64, 4)
            b = _python_tier(rec28, 56, 56, resize=64)
            res["parity_scaled_max_diff"] = _maxdiff(a, b)
            res["parity_scaled_tol"] = SCALED_PARITY_TOL
            checks["parity_bounded_at_scale"] = (
                res["parity_scaled_max_diff"] <= SCALED_PARITY_TOL
                and sa["scale_counts"]["2"] == 8)
        # PNG and progressive JPEG through the loader
        recpng = build_rec(workdir, "png", n=6, size=64, encode=".png")
        a, sa = native(recpng, (3, 64, 64), -1, 3)
        png_ok = (_maxdiff(a, _python_tier(recpng, 64, 64)) == 0
                  and sa["png_decodes"] == 6)
        recprog = build_rec(workdir, "prog", n=6, size=64, progressive=True)
        a, sa = native(recprog, (3, 64, 64), -1, 3)
        res["progressive_max_diff"] = _maxdiff(
            a, _python_tier(recprog, 64, 64))
        checks["png_progressive"] = bool(
            png_ok and sa["jpeg_decodes"] == 6 and
            (lib != "libjpeg" or res["progressive_max_diff"] == 0))

        # stats_reset: per-point deltas
        it = NativeImageRecordIter(
            path_imgrec=probe, data_shape=(3, 64, 64), batch_size=4,
            preprocess_threads=2, shuffle=False)
        _epoch(it)
        before = it.stats()
        it.stats_reset()
        mid = it.stats()
        it.reset()
        _epoch(it)
        after = it.stats()
        it.close()
        checks["stats_reset"] = (
            before["samples"] == 4 and mid["samples"] == 0
            and mid["batches"] == 0 and mid["read_us"] == 0
            and mid["decode_us"] == 0 and after["samples"] == 4)

        # worker scaling (relative, same run)
        scal = build_rec(workdir, "scal", n=SCALING_IMAGES, size=256)
        rates = _scaling(scal)
        res["scaling_epochs_img_s_1w"] = rates[1]
        res["scaling_epochs_img_s_4w"] = rates[4]
        res["scaling_img_s_1w"] = max(rates[1])
        res["scaling_img_s_4w"] = max(rates[4])
        x = (res["scaling_img_s_4w"] / res["scaling_img_s_1w"]
             if res["scaling_img_s_1w"] > 0 else 0.0)
        res["scaling_x"] = x
        res["scaling_enforced"] = res["cpu_count"] >= 4
        if res["scaling_enforced"]:
            checks["scaling_4w_vs_1w"] = x >= SCALING_MIN_X
        else:
            res["scaling_skip_reason"] = (
                "host has %d core(s); 4-worker scaling not enforceable"
                % res["cpu_count"])
    finally:
        if own_dir:
            shutil.rmtree(workdir, ignore_errors=True)
    res["checks"] = checks
    res["ok"] = all(checks.values())
    return res


def _selfcheck():
    """Entry point: 0 when every enforced check passed."""
    res = summary()
    print(json.dumps(res, indent=2, sort_keys=True))
    if not res["ok"]:
        failed = [k for k, v in res["checks"].items() if not v]
        print("feed-check FAILED: %s" % ", ".join(failed))
        return 1
    print("feed-check OK (backend=%s, scaling_x=%.2f%s)" % (
        res.get("decode_backend"), res.get("scaling_x", 0.0),
        "" if res.get("scaling_enforced") else " [scaling not enforced]"))
    return 0


if __name__ == "__main__":
    raise SystemExit(_selfcheck())
