"""Stitch per-process chrome-trace shards into one timeline (≙ the
reference's ``tools/trace.py``).

Every fleet member (trainer, decode worker, serving replica, router)
writes its own shard — ``telemetry.dump_trace()``, ``MXNET_TRACE_DIR`` at
exit, ``kill -USR2`` — because a process sees only its own span ring.
``merge`` joins them into one Chrome trace-event JSON file that
chrome://tracing and Perfetto load::

    python -m mxnet_tpu_torch.tracemerge merge <dir|file>... -o merged.json

- every span keeps its pid and tid; the ``process_name`` and
  ``thread_name`` metadata rows are carried over once each;
- spans share one wall-clock µs timebase (``telemetry.span`` records
  ``time.time_ns``), so a child span a decode worker recorded lands
  inside its parent fetch span the training host recorded;
- ``links`` args (the batcher's coalesced execute → member requests)
  become chrome flow events (ph "s" / "f").

The diagnostic dumps ``telemetry.dump()`` writes (``SIGUSR2``, exit) are
read too: their embedded ``trace.events`` merge the same way.
"""
import argparse
import json
import os
import sys

__all__ = ["load_shard", "merge_events", "merge", "main"]


def _iter_shard_files(paths):
    """Expand dir|file arguments into candidate JSON files."""
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, files in os.walk(p):
                for f in sorted(files):
                    if f.endswith(".json") and not f.endswith(".tmp"):
                        yield os.path.join(root, f)
        else:
            yield p


def load_shard(path):
    """Events from one shard: a dump_trace() file ({"traceEvents": []})
    or a telemetry.dump() diagnostic ({"trace": {"events": []}}).
    Returns [] for files that are neither (a run dir holds logs too)."""
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return []
    if isinstance(data, dict):
        if isinstance(data.get("traceEvents"), list):
            return data["traceEvents"]
        tr = data.get("trace")
        if isinstance(tr, dict) and isinstance(tr.get("events"), list):
            return tr["events"]
    return []


def merge_events(paths, verbose=False):
    """One merged, sorted traceEvents list from many shards, with
    deduplicated metadata rows and synthesized flow events for links."""
    events, meta_seen, span_seen = [], set(), set()
    n_files = 0
    for path in _iter_shard_files(paths):
        evs = load_shard(path)
        if not evs:
            continue
        n_files += 1
        if verbose:
            print(f"[trace] {path}: {len(evs)} events", file=sys.stderr)
        for e in evs:
            if e.get("ph") == "M":
                key = (e.get("pid"), e.get("tid"), e.get("name"),
                       json.dumps(e.get("args", {}), sort_keys=True))
                if key in meta_seen:
                    continue
                meta_seen.add(key)
            elif e.get("ph") == "X":
                # span ids are unique per process: dedup so a run dir
                # holding BOTH a shard and a diagnostic dump (or a
                # previous merge output) doesn't double-count
                sid = (e.get("args") or {}).get("span_id")
                if sid:
                    key = (e.get("pid"), sid)
                    if key in span_seen:
                        continue
                    span_seen.add(key)
            elif e.get("ph") in ("s", "f"):
                continue            # re-synthesized from links below
            events.append(e)
    if n_files == 0:
        raise FileNotFoundError(
            f"no trace shards under {paths} (expected dump_trace() "
            f"files or telemetry dumps with a trace section)")
    events.extend(_flow_events(events))
    events.sort(key=lambda e: (e.get("ts", 0), e.get("ph") != "M"))
    return events


def _flow_events(events):
    """Chrome flow ("s" → "f") pairs for every links entry: member
    request span → the coalesced execute span that served it."""
    by_span = {}
    for e in events:
        if e.get("ph") == "X":
            sid = (e.get("args") or {}).get("span_id")
            if sid:
                by_span[sid] = e
    flows, fid = [], 0
    for e in events:
        if e.get("ph") != "X":
            continue
        for link in (e.get("args") or {}).get("links") or []:
            src = by_span.get(link.split("-", 1)[-1])
            if src is None:
                continue        # linked span fell out of its ring
            fid += 1
            flows.append({"ph": "s", "cat": "mxtpu.link", "name": "coalesce",
                          "id": fid, "ts": src["ts"],
                          "pid": src["pid"], "tid": src["tid"]})
            flows.append({"ph": "f", "bp": "e", "cat": "mxtpu.link",
                          "name": "coalesce", "id": fid, "ts": e["ts"],
                          "pid": e["pid"], "tid": e["tid"]})
    return flows


def merge(paths, out, verbose=False):
    events = merge_events(paths, verbose=verbose)
    data = {"traceEvents": events, "displayTimeUnit": "ms"}
    tmp = f"{out}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(data, f)
    os.replace(tmp, out)
    n_spans = sum(1 for e in events if e.get("ph") == "X")
    pids = {e.get("pid") for e in events if e.get("ph") == "X"}
    print(f"[trace] merged {n_spans} spans from {len(pids)} processes "
          f"→ {out} (load in chrome://tracing or ui.perfetto.dev)")
    return out


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.tracemerge",
        description="merge per-process chrome-trace shards")
    sub = p.add_subparsers(dest="cmd", required=True)
    m = sub.add_parser("merge", help="stitch shards into one timeline")
    m.add_argument("paths", nargs="+",
                   help="shard files and/or directories (MXNET_TRACE_DIR "
                        "run dirs are walked recursively)")
    m.add_argument("-o", "--out", default="merged_trace.json",
                   help="output file (default merged_trace.json)")
    m.add_argument("-v", "--verbose", action="store_true")
    args = p.parse_args(argv)
    if args.cmd == "merge":
        try:
            merge(args.paths, args.out, verbose=args.verbose)
        except FileNotFoundError as e:
            print(f"[trace] {e}", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
