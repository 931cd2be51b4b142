"""``trace-merge``: the port's ``observe/trace_merge.py`` against the JAX
package's on seeded trace files (equal merged JSON, equal errors), and the
``trace-merge`` command of both CLIs on the port's own ``--trace`` files.
"""

import json

import numpy as np
import pytest

from fgumi_tpu import cli as jax_cli
from fgumi_tpu.observe import trace_merge as jax_merge
from fgumi_tpu_torch import cli as port_cli
from fgumi_tpu_torch.observe import trace_merge as port_merge


def _trace_file(path, rng, pid, trace_id=None, label=None, offset=None,
                anchor=None, n=40):
    """A Chrome trace of ``n`` seeded spans on a few threads."""
    events = []
    tids = [int(t) for t in rng.integers(1000, 99999, size=3)]
    for tid in tids:
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tid, "args": {"name": f"t{tid}"}})
    ts = 0.0
    for i in range(n):
        ts += float(rng.integers(1, 5000)) / 10
        events.append({"name": f"span{int(rng.integers(0, 5))}", "ph": "X",
                       "pid": pid, "tid": tids[i % 3], "ts": round(ts, 1),
                       "dur": float(rng.integers(1, 900)) / 10})
    clock = {"t_zero_unix": anchor if anchor is not None
             else 1.7e9 + float(rng.random())}
    if offset is not None:
        clock["offset_estimate_s"] = offset
    other = {"clock": clock, "process": {"pid": pid, "label": label}}
    if trace_id:
        other["trace_context"] = {"trace_id": trace_id,
                                  "parent_span_id": "b" * 16}
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                   "otherData": other}, f)
    return str(path)


def _both(fn_name, *args, **kwargs):
    out = []
    for mod in (port_merge, jax_merge):
        try:
            out.append(("ok", getattr(mod, fn_name)(*args, **kwargs)))
        except ValueError as e:
            out.append(("error", type(e).__name__, str(e)))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("case", ["plain", "same_pid", "offset", "labels",
                                  "three"])
def test_merge_equals_jax(tmp_path, seed, case):
    rng = np.random.default_rng(seed)
    tid = "a" * 32
    if case == "plain":
        paths = [_trace_file(tmp_path / "a.json", rng, 11, tid),
                 _trace_file(tmp_path / "b.json", rng, 22, tid)]
    elif case == "same_pid":
        paths = [_trace_file(tmp_path / "a.json", rng, 7, tid),
                 _trace_file(tmp_path / "b.json", rng, 7, tid)]
    elif case == "offset":
        paths = [_trace_file(tmp_path / "a.json", rng, 11, tid,
                             offset=0.25),
                 _trace_file(tmp_path / "b.json", rng, 22, None)]
    elif case == "labels":
        paths = [_trace_file(tmp_path / "a.json", rng, 11, tid,
                             label="client"),
                 _trace_file(tmp_path / "b.json", rng, 22, tid,
                             label="backend j-1")]
    else:
        paths = [_trace_file(tmp_path / f"{k}.json", rng, 5 + k, tid)
                 for k in range(3)]
    shifts = port_merge.parse_shift_specs(["b.json=0.5"])
    assert shifts == jax_merge.parse_shift_specs(["b.json=0.5"])
    for kwargs in ({}, {"shifts": shifts}):
        got, want = _both("merge_traces", paths, **kwargs)
        assert got == want
        assert got[0] == "ok"
        merged = got[1]
        assert min(e["ts"] for e in merged["traceEvents"]
                   if "ts" in e and e["ph"] != "M") >= 0


@pytest.mark.parametrize("mode", ["conflict", "force", "pick", "nomatch"])
def test_trace_id_handling_equals_jax(tmp_path, mode):
    rng = np.random.default_rng(5)
    paths = [_trace_file(tmp_path / "a.json", rng, 1, "a" * 32),
             _trace_file(tmp_path / "b.json", rng, 2, "c" * 32)]
    kwargs = {"conflict": {}, "force": {"force": True},
              "pick": {"trace_id": "c" * 32},
              "nomatch": {"trace_id": "d" * 32}}[mode]
    got, want = _both("merge_traces", paths, **kwargs)
    assert got == want
    assert (got[0] == "error") == (mode in ("conflict", "nomatch"))


@pytest.mark.parametrize("content", ["{not json", '{"traceEvents": 3}', "[]"])
def test_bad_input_equals_jax(tmp_path, content):
    p = tmp_path / "bad.json"
    p.write_text(content)
    got, want = _both("merge_traces", [str(p)])
    assert got[0] == want[0] == "error"
    assert got == want


@pytest.mark.parametrize("spec", ["x", "=1", "a.json=abc"])
def test_bad_shift_equals_jax(spec):
    got, want = _both("parse_shift_specs", [spec])
    assert got == want and got[0] == "error"


def test_cli_trace_merge_of_port_traces_equals_jax(tmp_path):
    src = str(tmp_path / "g.bam")
    assert port_cli.main(["simulate", "grouped-reads", "-o", src,
                          "--num-families", "40"]) == 0
    traces = []
    for k in range(2):
        t = str(tmp_path / f"t{k}.json")
        assert port_cli.main(["--trace", t, "simplex", "-i", src, "-o",
                              str(tmp_path / f"c{k}.bam"), "--device",
                              "cpu"]) == 0
        traces.append(t)
    outs = {}
    for name, main in (("port", port_cli.main), ("jax", jax_cli.main)):
        out = str(tmp_path / f"merged_{name}.json")
        assert main(["trace-merge", *traces, "-o", out]) == 0
        outs[name] = json.load(open(out))
    assert outs["port"] == outs["jax"]
    assert len(outs["port"]["otherData"]["merged_from"]) == 2
    assert port_cli.main(["trace-merge", str(tmp_path / "missing.json"),
                          "-o", str(tmp_path / "x.json")]) == 2
