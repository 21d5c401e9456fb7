"""Fleet observability aggregator (≙ the reference's ``tools/obs.py``).

``scrape`` polls the ``/metrics`` endpoints the serving, router and feed
tiers expose and merges them with the recorder shards trainer processes
leave under ``MXNET_OBS_DIR`` into one fleet timeline keyed (role, rank,
metric)::

    python -m mxnet_tpu_torch.obs.fleet scrape \
        --target serve@127.0.0.1:8080 --target router@127.0.0.1:8081 \
        --shards /tmp/obs --interval-ms 250 --duration-s 5 --out fleet.json

``report`` renders a timeline: per-role rate tables, the derived health
signals (input-stall fraction, goodput, MFU, straggler skew across data-
parallel ranks), the top regressing series (second-half against
first-half rate) and the cross-role step-time breakdown::

    python -m mxnet_tpu_torch.obs.fleet report fleet.json

Counter → rate and histogram → delta quantile come from
:mod:`.recorder`, so every rate column is the same arithmetic.
"""
import argparse
import json
import os
import re
import sys
import time

from .. import telemetry as _telemetry
from .recorder import SHARD_SUFFIX, derive_between, split_label
from .rules import Rule, RuleEngine

__all__ = ["parse_prometheus", "scrape", "read_shards", "build_report",
           "render_report", "main"]

_PROM_LINE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+(-?[0-9.eE+]+|[+-]Inf|NaN)$")
_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="([^"]*)"')


def parse_prometheus(text):
    """Prometheus text exposition → a raw-snapshot-shaped dict
    ({"counters", "gauges", "histograms"}), classifying families by
    their ``# TYPE`` line and re-assembling cumulative ``le`` buckets
    into the snapshot histogram form ({"le", "counts", "count", "sum"})
    so the shared derivation (`derive_between`) applies unchanged."""
    types = {}
    out = {"counters": {}, "gauges": {}, "histograms": {}}
    hacc = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        m = _PROM_LINE.match(line)
        if not m:
            raise ValueError(f"malformed exposition line: {line!r}")
        name, labels, val = m.group(1), m.group(2) or "", m.group(3)
        v = float(val)
        base = re.sub(r"_(bucket|sum|count)$", "", name)
        if types.get(base) == "histogram":
            h = hacc.setdefault(base, {"le": [], "cum": [], "sum": 0.0,
                                       "count": 0})
            if name.endswith("_bucket"):
                le = dict(_LABEL.findall(labels)).get("le", "+Inf")
                h["le"].append(le)
                h["cum"].append(v)
            elif name.endswith("_sum"):
                h["sum"] = v
            elif name.endswith("_count"):
                h["count"] = int(v)
            continue
        kind = types.get(name)
        if kind == "counter":
            out["counters"][name] = int(v)
        else:
            # gauges, and labeled families we don't decompose (device
            # memory): last sample wins, keyed with labels when present
            out["gauges"][name + labels] = v
    for base, h in hacc.items():
        counts, prev = [], 0.0
        for c in h["cum"]:
            counts.append(c - prev)
            prev = c
        le = [float("inf") if b == "+Inf" else float(b) for b in h["le"]]
        if le and le[-1] == float("inf"):
            le = le[:-1]                     # snapshot form: overflow last
        out["histograms"][base] = {
            "le": le, "counts": [int(c) for c in counts],
            "count": h["count"], "sum": h["sum"]}
    return out


def _dotted(prom_name):
    """``mxtpu_serve_queue_depth`` → ``serve.queue_depth`` (longest
    known telemetry section wins, so feed_service survives)."""
    name = prom_name[len("mxtpu_"):] if prom_name.startswith("mxtpu_") \
        else prom_name
    for sec in sorted(_telemetry.SECTIONS, key=len, reverse=True):
        if name.startswith(sec + "_"):
            return sec + "." + name[len(sec) + 1:]
    return name


def _fetch_metrics(host, port, timeout=5.0):
    import http.client
    c = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        c.request("GET", "/metrics")
        r = c.getresponse()
        body = r.read().decode("utf-8", "replace")
        if r.status != 200:
            raise OSError(f"/metrics -> {r.status}")
        return body
    finally:
        c.close()


def _parse_target(spec):
    """``role[.rank]@host:port`` → (role, rank, host, port)."""
    role, _, addr = spec.partition("@")
    if not addr:
        raise ValueError(f"--target {spec!r}: want role[.rank]@host:port")
    rank = 0
    if "." in role:
        role, _, r = role.partition(".")
        rank = int(r)
    host, _, port = addr.rpartition(":")
    return role, rank, host or "127.0.0.1", int(port)


def scrape(targets, shards_dir=None, interval_ms=250.0, duration_s=5.0,
           out=None):
    """Poll each target's /metrics for `duration_s`, derive windowed
    rates/quantiles per tick, fold in recorder shards, return the
    timeline dict (and write it to `out` when given)."""
    parsed = [_parse_target(t) for t in targets]
    prev = {}
    frames = []
    t_end = time.monotonic() + float(duration_s)
    while True:
        tick_t = time.time()
        mono = time.monotonic()
        for role, rank, host, port in parsed:
            key = (role, rank)
            try:
                raw = parse_prometheus(_fetch_metrics(host, port))
            except (OSError, ValueError) as e:
                frames.append({"t": tick_t, "role": role, "rank": rank,
                               "source": "scrape", "error": str(e)})
                continue
            raw = {
                "counters": {_dotted(k): v
                             for k, v in raw["counters"].items()},
                "gauges": {_dotted(k): v for k, v in raw["gauges"].items()
                           if "{" not in k},
                "histograms": {_dotted(k): v
                               for k, v in raw["histograms"].items()},
            }
            p = prev.get(key)
            der = derive_between(p[0] if p else None, raw,
                                 mono - p[1] if p else 0.0) \
                if p else {"rates": {}, "quantiles": {}}
            prev[key] = (raw, mono)
            frames.append({
                "t": tick_t, "role": role, "rank": rank, "source": "scrape",
                "rates": der["rates"], "quantiles": der["quantiles"],
                "gauges": raw["gauges"],
                "counters": raw["counters"],
            })
        if mono >= t_end:
            break
        time.sleep(max(float(interval_ms) / 1000.0, 0.01))
    if shards_dir:
        frames.extend(read_shards(shards_dir))
    frames.sort(key=lambda f: f.get("t", 0.0))
    timeline = {"version": 1, "generated_t": time.time(),
                "targets": targets, "shards_dir": shards_dir,
                "frames": frames}
    if out:
        tmp = f"{out}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(timeline, f, default=str)
        os.replace(tmp, out)
    return timeline


def read_shards(shards_dir):
    """Obs-recorder shard files → timeline frames (role/rank from the
    shard meta's MXNET_TRACE_LABEL)."""
    frames = []
    try:
        names = sorted(os.listdir(shards_dir))
    except OSError:
        return frames
    for fn in names:
        if not fn.endswith(SHARD_SUFFIX):
            continue
        path = os.path.join(shards_dir, fn)
        with open(path) as f:
            lines = [ln for ln in f.read().splitlines() if ln.strip()]
        if not lines:
            continue
        meta = json.loads(lines[0])
        role = meta.get("role")
        rank = meta.get("rank", 0)
        if not role:
            role, rank = split_label(meta.get("label", fn))
        for ln in lines[1:]:
            fr = json.loads(ln)
            frames.append({
                "t": fr.get("t"), "role": role, "rank": rank,
                "source": "shard",
                "rates": fr.get("rates", {}),
                "quantiles": fr.get("quantiles", {}),
                "gauges": fr.get("gauges", {}),
                "signals": fr.get("signals", {}),
            })
    return frames


# ------------------------------------------------------------------ report
def _mean(xs):
    xs = [x for x in xs if x is not None]
    return sum(xs) / len(xs) if xs else None


def _series(frames, kind, name):
    for f in frames:
        v = f.get(kind, {}).get(name)
        if isinstance(v, dict):
            v = v.get("p50_us")
        if v is not None:
            yield f.get("t", 0.0), float(v)


def build_report(timeline, top=8):
    """The merged-timeline analysis behind ``report`` (and the obs
    check's gates): per-role aggregates, derived fleet signals,
    regressing series, the cross-role step-time breakdown, the replayed
    straggler watchdog."""
    frames = [f for f in timeline["frames"] if "error" not in f]
    errors = [f for f in timeline["frames"] if "error" in f]
    by_role = {}
    for f in frames:
        by_role.setdefault(f["role"], []).append(f)

    roles = {}
    for role, fs in sorted(by_role.items()):
        rate_acc = {}
        for f in fs:
            for name, v in f.get("rates", {}).items():
                rate_acc.setdefault(name, []).append(v)
        mean_rates = {n: _mean(vs) for n, vs in rate_acc.items()}
        nonzero = {n: r for n, r in mean_rates.items() if r and r > 0.0}
        roles[role] = {
            "frames": len(fs),
            "ranks": sorted({f["rank"] for f in fs}),
            "sources": sorted({f["source"] for f in fs}),
            "nonzero_rates": len(nonzero),
            "top_rates": sorted(nonzero.items(), key=lambda kv: -kv[1])[:top],
        }

    # ------------------------------------------------- derived signals
    signals = {}
    trainer_frames = [f for fs in by_role.values() for f in fs
                      if f.get("signals")]
    for key in ("input_stall_frac", "mfu", "ckpt_pause_frac",
                "steps_per_s"):
        v = _mean([f["signals"].get(key) for f in trainer_frames])
        if v is not None:
            signals[key] = v
    # goodput from the serving tier's own scraped rates (the trainer
    # never sees the request counters)
    serve_fs = [f for role in ("serve", "replica") for f in
                by_role.get(role, [])]
    offered = _mean([f.get("rates", {}).get("serve.requests")
                     for f in serve_fs])
    if offered:
        good = ((_mean([f.get("rates", {}).get("serve.admitted")
                        for f in serve_fs]) or 0.0)
                - (_mean([f.get("rates", {}).get("serve.rejected")
                          for f in serve_fs]) or 0.0)
                - (_mean([f.get("rates", {}).get("serve.abandoned")
                          for f in serve_fs]) or 0.0))
        signals["goodput"] = min(max(good / offered, 0.0), 1.0)

    # straggler skew: relative spread of per-rank step-time p50s,
    # replayed through the SAME watchdog rule the recorder seeds
    alerts = []
    trainer_roles = [r for r in by_role if r.startswith("trainer")
                     or r.startswith("worker")]
    rank_frames = {}
    for r in trainer_roles:
        for f in by_role[r]:
            q = f.get("quantiles", {}).get("fused.step_us")
            if q and q.get("p50_us") is not None:
                rank_frames.setdefault((r, f["rank"]), []).append(
                    (f.get("t", 0.0), q["p50_us"]))
    if len(rank_frames) >= 2:
        per_rank = {k: _mean([p for _, p in v])
                    for k, v in rank_frames.items()}
        vals = list(per_rank.values())
        mean_v = _mean(vals)
        if mean_v:
            signals["straggler_skew"] = (max(vals) - min(vals)) / mean_v
        # replay: one synthetic frame per aligned sample index
        eng = RuleEngine([Rule("straggler", "straggler_skew", ">", 0.5,
                               for_s=0.0, clear_threshold=0.25,
                               clear_for_s=0.0)],
                         log=open(os.devnull, "w"))
        n = min(len(v) for v in rank_frames.values())
        for i in range(n):
            vals_i = [v[i][1] for v in rank_frames.values()]
            m = _mean(vals_i)
            skew = (max(vals_i) - min(vals_i)) / m if m else 0.0
            t_i = _mean([v[i][0] for v in rank_frames.values()])
            alerts.extend(eng.update(
                {"mono": t_i, "t": t_i,
                 "signals": {"straggler_skew": skew}}))

    # ------------------------------------------------ regressing series
    regressions = []
    series_keys = set()
    for f in frames:
        for n in f.get("rates", {}):
            series_keys.add((f["role"], f["rank"], n))
    for role, rank, name in sorted(series_keys):
        pts = [v for f in frames
               if f["role"] == role and f["rank"] == rank
               for v in [f.get("rates", {}).get(name)] if v is not None]
        if len(pts) < 4:
            continue
        half = len(pts) // 2
        first, second = _mean(pts[:half]), _mean(pts[half:])
        if first and first > 0 and second is not None:
            ratio = second / first
            if ratio > 1.25:
                regressions.append({"role": role, "rank": rank,
                                    "metric": name, "first_half": first,
                                    "second_half": second,
                                    "ratio": ratio})
    regressions.sort(key=lambda r: -r["ratio"])

    # ------------------------------------------- step-time breakdown
    breakdown = {}
    for label, kind, name in (
            ("trainer fused.step_us p50", "quantiles", "fused.step_us"),
            ("trainer datafeed.wait_us p50", "quantiles",
             "datafeed.wait_us"),
            ("trainer checkpoint.pause_us p50", "quantiles",
             "checkpoint.pause_us"),
            ("replica serve.e2e_us p50", "quantiles", "serve.e2e_us"),
            ("feed feed_worker p50", "quantiles",
             "feed_service.worker_batch_us")):
        vals = [v for f in frames for _, v in _series([f], kind, name)]
        if vals:
            breakdown[label] = _mean(vals)

    return {"roles": roles, "signals": signals,
            "regressions": regressions[:top], "breakdown": breakdown,
            "straggler_alerts": alerts, "scrape_errors": len(errors)}


def render_report(rep):
    out = []
    out.append("---------- fleet roles ----------")
    out.append(f"{'role':14s} {'frames':>6s} {'ranks':>6s} "
               f"{'nonzero':>8s}  top rates (/s)")
    for role, r in sorted(rep["roles"].items()):
        tops = ", ".join(f"{n}={v:.3g}" for n, v in r["top_rates"][:4])
        out.append(f"{role:14s} {r['frames']:6d} {len(r['ranks']):6d} "
                   f"{r['nonzero_rates']:8d}  {tops}")
    out.append("---------- derived signals ----------")
    if not rep["signals"]:
        out.append("(none — no trainer shards / no offered load)")
    for name, v in sorted(rep["signals"].items()):
        out.append(f"{name:24s} : {v:.6g}")
    if rep["straggler_alerts"]:
        out.append("---------- straggler watchdog ----------")
        for ev in rep["straggler_alerts"]:
            out.append(f"{ev['rule']} {ev['event']} value={ev['value']:.3g}")
    out.append("---------- top regressing series ----------")
    if not rep["regressions"]:
        out.append("(none above 1.25x)")
    for r in rep["regressions"]:
        out.append(f"{r['role']}[{r['rank']}] {r['metric']:32s} "
                   f"{r['first_half']:.3g}/s -> {r['second_half']:.3g}/s "
                   f"({r['ratio']:.2f}x)")
    out.append("---------- cross-role step-time breakdown ----------")
    if not rep["breakdown"]:
        out.append("(no windowed histograms in the timeline)")
    for label, v in rep["breakdown"].items():
        out.append(f"{label:36s} : {v:,.1f} us")
    if rep["scrape_errors"]:
        out.append(f"({rep['scrape_errors']} scrape errors elided)")
    return "\n".join(out) + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.obs.fleet", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    sc = sub.add_parser("scrape", help="poll /metrics + merge shards")
    sc.add_argument("--target", action="append", default=[],
                    metavar="role[.rank]@host:port")
    sc.add_argument("--shards", default=None,
                    help="MXNET_OBS_DIR with recorder shards")
    sc.add_argument("--interval-ms", type=float, default=250.0)
    sc.add_argument("--duration-s", type=float, default=5.0)
    sc.add_argument("--out", default=None, help="timeline JSON path")
    rp = sub.add_parser("report", help="render a scraped timeline")
    rp.add_argument("timeline")
    rp.add_argument("--top", type=int, default=8)
    args = ap.parse_args(argv)
    if args.cmd == "scrape":
        if not args.target and not args.shards:
            ap.error("scrape needs --target and/or --shards")
        tl = scrape(args.target, shards_dir=args.shards,
                    interval_ms=args.interval_ms,
                    duration_s=args.duration_s, out=args.out)
        n_err = sum(1 for f in tl["frames"] if "error" in f)
        print(f"scraped {len(tl['frames'])} frames "
              f"({n_err} errors)" +
              (f" -> {args.out}" if args.out else ""))
        if not args.out:
            sys.stdout.write(render_report(build_report(tl)))
        return 0
    with open(args.timeline) as f:
        tl = json.load(f)
    sys.stdout.write(render_report(build_report(tl, top=args.top)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
