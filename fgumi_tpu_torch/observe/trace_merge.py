"""Stitch several Chrome trace-event files into one timeline.

``fgumi-tpu-torch trace-merge a.json b.json -o merged.json`` takes the
``--trace`` files of several processes (each command of a workflow, or
runs on several hosts) and produces one file Perfetto opens as a single
timeline with a labelled track group per process.

Alignment: every trace export carries a clock anchor
(``otherData.clock.t_zero_unix``, the wall-clock instant of the file's
monotonic zero; see observe/trace.py). The merge shifts each file's
timestamps so the anchors agree on one wall clock; a file that carries
``clock.offset_estimate_s`` is first corrected by it. ``--shift
FILE=SECONDS`` adds an operator's correction per file.

Causality: files may carry ``otherData.trace_context`` (trace id + parent
span id). Differing trace ids are an error unless ``--trace-id`` picks one
(the other files are skipped with a note) or ``--force`` keeps them all.
The merged JSON equals the JAX package's ``trace-merge`` output for the
same inputs.
"""

import json
import os

#: synthetic pid namespace for colliding input files: two processes on
#: different hosts can share an OS pid, and Perfetto would fold their
#: tracks together — remapped pids start here (real pids stay put).
_REMAP_BASE = 1 << 22


class MergeError(ValueError):
    """A merge input is unusable (not a trace, unreadable, id mismatch)."""


def _load(path: str) -> dict:
    try:
        with open(path, encoding="utf-8") as f:
            obj = json.load(f)
    except (OSError, ValueError) as e:
        raise MergeError(f"{path}: cannot read trace: {e}") from None
    if not isinstance(obj, dict) or not isinstance(
            obj.get("traceEvents"), list):
        raise MergeError(f"{path}: not a Chrome trace-event file "
                         "(no traceEvents array)")
    return obj


def _file_meta(path: str, obj: dict) -> dict:
    """Anchor, process identity, and trace context of one input file."""
    other = obj.get("otherData") if isinstance(obj.get("otherData"),
                                               dict) else {}
    clock = other.get("clock") if isinstance(other.get("clock"),
                                             dict) else {}
    process = other.get("process") if isinstance(other.get("process"),
                                                 dict) else {}
    ctx = other.get("trace_context") \
        if isinstance(other.get("trace_context"), dict) else {}
    anchor = clock.get("t_zero_unix")
    if not isinstance(anchor, (int, float)) or isinstance(anchor, bool):
        anchor = None
    offset = clock.get("offset_estimate_s")
    if not isinstance(offset, (int, float)) or isinstance(offset, bool):
        offset = 0.0
    pids = {ev.get("pid") for ev in obj["traceEvents"]
            if isinstance(ev.get("pid"), int)}
    return {
        "path": path,
        "anchor_unix": anchor,
        "offset_s": float(offset),
        "pid": process.get("pid") if isinstance(process.get("pid"), int)
        else (sorted(pids)[0] if pids else 0),
        "label": process.get("label") or None,
        "trace_id": ctx.get("trace_id"),
        "parent_span_id": ctx.get("parent_span_id"),
    }


def parse_shift_specs(specs) -> dict:
    """``["bal.json=0.25", ...]`` -> {basename-or-path: seconds}."""
    out = {}
    for spec in specs or ():
        name, eq, val = spec.partition("=")
        if not eq or not name:
            raise MergeError(f"--shift {spec!r} is not FILE=SECONDS")
        try:
            out[name] = float(val)
        except ValueError:
            raise MergeError(
                f"--shift {spec!r}: {val!r} is not a number") from None
    return out


def _user_shift(path: str, shifts: dict) -> float:
    if path in shifts:
        return shifts[path]
    return shifts.get(os.path.basename(path), 0.0)


def merge_traces(paths, trace_id: str = None, shifts: dict = None,
                 force: bool = False) -> dict:
    """Merge trace files into one Chrome trace-event object.

    Returns the merged object; raises :class:`MergeError` on unusable
    inputs or conflicting trace ids (unless ``force``). ``trace_id``
    keeps only files stamped with that id (others are skipped, recorded
    under ``otherData.skipped``); ``shifts`` maps file path/basename to
    extra seconds added to that file's timeline."""
    if not paths:
        raise MergeError("no trace files to merge")
    shifts = shifts or {}
    loaded = []
    skipped = []
    for path in paths:
        obj = _load(path)
        meta = _file_meta(path, obj)
        if trace_id is not None and meta["trace_id"] != trace_id:
            skipped.append({"path": path,
                            "trace_id": meta["trace_id"],
                            "reason": "trace_id mismatch"})
            continue
        loaded.append((meta, obj))
    if not loaded:
        raise MergeError("no input file matches trace id "
                         f"{trace_id!r}" if trace_id is not None
                         else "no trace files to merge")
    ids = {m["trace_id"] for m, _ in loaded if m["trace_id"]}
    if len(ids) > 1 and not force:
        raise MergeError(
            "inputs span multiple trace ids "
            f"{sorted(ids)}; pick one with --trace-id or pass --force")
    # the reference clock: the earliest corrected anchor, so every merged
    # timestamp is >= 0 (Perfetto dislikes negative ts). Files with no
    # anchor (foreign traces) align at the reference as-is.
    anchored = [m["anchor_unix"] - m["offset_s"]
                + _user_shift(m["path"], shifts)
                for m, _ in loaded if m["anchor_unix"] is not None]
    ref = min(anchored) if anchored else 0.0
    events = []
    merged_from = []
    used_pids = set()
    next_remap = _REMAP_BASE
    for meta, obj in loaded:
        if meta["anchor_unix"] is None:
            shift_us = round(_user_shift(meta["path"], shifts) * 1e6, 1)
        else:
            corrected = (meta["anchor_unix"] - meta["offset_s"]
                         + _user_shift(meta["path"], shifts))
            shift_us = round((corrected - ref) * 1e6, 1)
        # per-file pid remap: keep the real pid unless another file
        # already claimed it (same pid on two hosts, or a restarted
        # process), else move the whole file to a synthetic pid
        pid_map = {}

        def mapped(pid):
            nonlocal next_remap
            if pid in pid_map:
                return pid_map[pid]
            new = pid
            while new in used_pids:
                new = next_remap
                next_remap += 1
            used_pids.add(new)
            pid_map[pid] = new
            return new

        saw_process_name = False
        for ev in obj["traceEvents"]:
            if not isinstance(ev, dict):
                continue
            ev = dict(ev)
            if isinstance(ev.get("pid"), int):
                ev["pid"] = mapped(ev["pid"])
            if ev.get("ph") == "M":
                if ev.get("name") == "process_name":
                    saw_process_name = True
            elif isinstance(ev.get("ts"), (int, float)):
                ev["ts"] = round(ev["ts"] + shift_us, 1)
            events.append(ev)
        file_pid = mapped(meta["pid"])
        if not saw_process_name:
            # label the track group even when the source never did —
            # fall back to the file name so the merged view stays legible
            events.append({
                "name": "process_name", "ph": "M", "pid": file_pid,
                "tid": 0,
                "args": {"name": meta["label"]
                         or os.path.basename(meta["path"])}})
        merged_from.append({
            "path": meta["path"],
            "pid": file_pid,
            "label": meta["label"],
            "trace_id": meta["trace_id"],
            "parent_span_id": meta["parent_span_id"],
            "shift_s": round(shift_us / 1e6, 6),
            "clock_offset_s": round(meta["offset_s"], 6),
        })
    other = {"clock": {"t_zero_unix": round(ref, 6)},
             "merged_from": merged_from}
    if len(ids) == 1:
        other["trace_context"] = {"trace_id": next(iter(ids))}
    if skipped:
        other["skipped"] = skipped
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": other}


def write_merged(obj: dict, path: str):
    """Commit the merged trace atomically (like every other output)."""
    from ..utils.atomic import discard_output, open_output

    out = open_output(path, "w")
    try:
        json.dump(obj, out, separators=(",", ":"))
    except BaseException:
        discard_output(out)
        raise
    out.close()
