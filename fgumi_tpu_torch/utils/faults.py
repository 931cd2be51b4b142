"""Deterministic fault injection for chaos testing.

The error plumbing, the exit-code contract and the crash-safe output
commit each claim to handle a failure; this registry injects those
failures on demand at named points of the real code paths (a failpoint
framework: each point is one ``faults.fire(...)`` call, a cheap no-op
unless armed). Grammar, points, kinds and draws are the JAX package's, so
one ``FGUMI_TPU_FAULT`` arms both the same way.

Arm via the environment::

    FGUMI_TPU_FAULT=point:kind:prob[:count][,point:kind:prob[:count]...]

- ``point``: one of :data:`FAULT_POINTS` (an unknown name is a loud
  ``ValueError`` at the first fire: a typo must not silently disarm a chaos
  test).
- ``kind``: ``raise`` (an :class:`InjectedFault`, exit 3), ``hang`` (sleep
  ``FGUMI_TPU_FAULT_HANG_S`` seconds, default 30), ``corrupt-bytes`` (flip
  bytes of the payload passing through the point), ``corrupt-result``
  (flip bits spread across the numpy arrays passing through the point),
  ``oom`` (an :class:`InjectedOom`) or ``enospc`` (an ``OSError(ENOSPC)``,
  exit 4).
- ``prob``: trigger probability per fire, drawn from a ``random.Random``
  seeded by ``FGUMI_TPU_FAULT_SEED`` (default 0) xor the point name, so
  single-threaded runs are reproducible.
- ``count``: optional cap on triggers (default unlimited). With ``prob``
  1.0 the first ``count`` arrivals trigger, so threaded runs are
  deterministic too.

The port fires the host points. The device points (``device.dispatch``,
``device.wedge``, ``device.fetch``) and the kind ``oom`` test the JAX
package's device retry, batch split and host fallback, which the port does
not have yet: :func:`unported_spec` names them, and the CLI refuses such a
spec (exit 2, "not yet ported") before any output is opened.

Faults are re-parsed whenever the variable's value changes, so tests can
arm and disarm between in-process runs.
"""

import logging
import os
import random
import threading
import time
import zlib

log = logging.getLogger("fgumi_tpu_torch")

#: Named fault points (the JAX package's set; where the port fires each)
FAULT_POINTS = frozenset({
    "reader.decompress",   # BGZF/gzip reader raw-chunk ingest (io/bgzf.py)
    "pipeline.process",    # per-item process stage (pipeline.run_stages)
    "device.dispatch",     # device upload + launch (not fired yet)
    "device.wedge",        # dispatch entry, kind `hang` (not fired yet)
    "device.fetch",        # fetched device results (not fired yet)
    "writer.compress",     # BGZF writer write/flush (io/bgzf.py)
    "native.batch",        # native batch-op entry (native/batch.py)
    "serve.dispatch",      # job-service worker dispatch (not fired yet)
    "serve.coalesce",      # merged cross-job dispatch (not fired yet)
    "chain.handoff",       # fused-pipeline channel put (pipeline_chain.py)
    "sort.spill",          # external-sort spill-run write (sort/external.py)
    "governor.sample",     # resource-governor sampling tick
                           # (utils/governor.py)
})

#: Points and kinds a spec may name in the JAX package whose machinery the
#: port lacks (the device retry loop, the batch split, the sentinel, the
#: job service): the CLI refuses them as not yet ported
UNPORTED_POINTS = frozenset({"device.dispatch", "device.wedge",
                             "device.fetch", "serve.dispatch",
                             "serve.coalesce"})
UNPORTED_KINDS = frozenset({"oom"})

KINDS = frozenset({"raise", "hang", "corrupt-bytes", "corrupt-result",
                   "oom", "enospc"})


class InjectedFault(RuntimeError):
    """A fault raised on purpose by the injection registry."""


class InjectedOom(InjectedFault):
    """Injected out-of-memory; message carries RESOURCE_EXHAUSTED so the
    device retry path classifies it exactly like a real XLA OOM."""


class _Fault:
    __slots__ = ("point", "kind", "prob", "remaining", "rng", "fired")

    def __init__(self, point, kind, prob, count, seed):
        self.point = point
        self.kind = kind
        self.prob = prob
        self.remaining = count  # -1 = unlimited
        self.fired = 0
        # per-point stream: arming two points never couples their coins.
        # crc32, not hash(): str hash is salted per process (PYTHONHASHSEED)
        # and the whole contract here is cross-process reproducibility.
        self.rng = random.Random((seed << 32) ^ zlib.crc32(point.encode()))


_lock = threading.Lock()
_env_cache = None  # last-parsed value of FGUMI_TPU_FAULT
_armed = {}  # point -> _Fault


def _parse(env: str) -> dict:
    seed = int(os.environ.get("FGUMI_TPU_FAULT_SEED", "0"))
    armed = {}
    for spec in env.split(","):
        spec = spec.strip()
        if not spec:
            continue
        parts = spec.split(":")
        if len(parts) not in (3, 4):
            raise ValueError(
                f"FGUMI_TPU_FAULT spec {spec!r}: expected "
                "point:kind:prob[:count]")
        point, kind, prob = parts[0], parts[1], float(parts[2])
        count = int(parts[3]) if len(parts) == 4 else -1
        if point not in FAULT_POINTS:
            raise ValueError(
                f"FGUMI_TPU_FAULT: unknown fault point {point!r} "
                f"(known: {', '.join(sorted(FAULT_POINTS))})")
        if kind not in KINDS:
            raise ValueError(
                f"FGUMI_TPU_FAULT: unknown kind {kind!r} "
                f"(known: {', '.join(sorted(KINDS))})")
        armed[point] = _Fault(point, kind, prob, count, seed)
        log.warning("fault injection armed: %s kind=%s prob=%g count=%s",
                    point, kind, prob, count if count >= 0 else "inf")
    return armed


def _refresh_locked():
    global _env_cache, _armed
    env = os.environ.get("FGUMI_TPU_FAULT", "")
    if env == _env_cache:
        return
    _env_cache = env
    _armed = _parse(env) if env else {}


def reset():
    """Drop parsed state so the next fire() re-reads the environment (and
    trigger budgets restart). Tests use this between in-process runs that
    reuse an identical FGUMI_TPU_FAULT value."""
    global _env_cache
    with _lock:
        _env_cache = None
        _armed.clear()


def armed(point: str) -> bool:
    """True when `point` has an armed fault with trigger budget left."""
    with _lock:
        _refresh_locked()
        f = _armed.get(point)
        return f is not None and f.remaining != 0


def fire(point: str, data=None):
    """Trigger the fault armed at `point`, if any.

    Returns `data` (possibly corrupted for kind ``corrupt-bytes``); raises
    for kinds ``raise``/``oom``; sleeps for kind ``hang``. A cheap no-op
    (one env read + dict lookup) when nothing is armed.
    """
    with _lock:
        _refresh_locked()
        f = _armed.get(point)
        if f is None or f.remaining == 0:
            return data
        if f.prob < 1.0 and f.rng.random() >= f.prob:
            return data
        if f.remaining > 0:
            f.remaining -= 1
        f.fired += 1
        kind = f.kind
        if kind == "corrupt-bytes":
            if data is None:
                return None
            out = _corrupt(f.rng, data)
            log.warning("fault injection: corrupted %d bytes at %s",
                        len(out), point)
            return out
        if kind == "corrupt-result":
            if data is None:
                return None
            out = _corrupt_result(data)
            log.warning("fault injection: bit-flipped result arrays at %s",
                        point)
            return out
    # act outside the lock: a hang must not wedge every other fire()
    if kind == "raise":
        log.warning("fault injection: raising at %s", point)
        raise InjectedFault(f"injected fault at {point}")
    if kind == "oom":
        log.warning("fault injection: injected OOM at %s", point)
        raise InjectedOom(
            f"RESOURCE_EXHAUSTED: injected out-of-memory at {point}")
    if kind == "enospc":
        import errno

        log.warning("fault injection: injected ENOSPC at %s", point)
        raise OSError(errno.ENOSPC,
                      f"No space left on device (injected at {point})")
    # hang
    t = float(os.environ.get("FGUMI_TPU_FAULT_HANG_S", "30"))
    log.warning("fault injection: hanging %.1fs at %s", t, point)
    time.sleep(t)
    return data


def _corrupt(rng, data):
    """Flip a deterministic handful of bytes (~1 per KiB, max 16)."""
    b = bytearray(data)
    if not b:
        return bytes(b)
    for _ in range(min(max(len(b) // 1024, 1), 16)):
        b[rng.randrange(len(b))] ^= 0xFF
    return bytes(b)


def _corrupt_result(data):
    """Flip bits in numpy result array(s): a handful of XORed bytes spread
    evenly across each array, so real (non-padding) rows are always hit
    regardless of the dispatch's padded layout. Deterministic by
    construction — the same arrays corrupt identically on every run.
    Accepts a single ndarray or a tuple/list of them (the fetched device
    result shape); non-array leaves pass through untouched."""
    import numpy as np

    def flip(a):
        if not isinstance(a, np.ndarray) or a.size == 0:
            return a
        out = np.array(a, copy=True)  # writable + C-contiguous
        flat = out.reshape(-1).view(np.uint8)
        n = flat.size
        k = min(max(n // 4096, 4), 64)
        idx = (np.arange(k, dtype=np.int64) * n) // k
        flat[idx] ^= 0xFF
        return out

    if isinstance(data, (tuple, list)):
        return type(data)(flip(a) for a in data)
    return flip(data)


def snapshot():
    """{point: fired count} for armed faults (chaos-test assertions)."""
    with _lock:
        _refresh_locked()
        return {p: f.fired for p, f in _armed.items()}


def unported_spec(env: str = None):
    """The first ``point:kind`` of ``FGUMI_TPU_FAULT`` (or ``env``) that the
    port cannot fire (:data:`UNPORTED_POINTS`, :data:`UNPORTED_KINDS`), or
    None. A malformed spec is left to :func:`fire`'s loud parse."""
    if env is None:
        env = os.environ.get("FGUMI_TPU_FAULT", "")
    for spec in env.split(","):
        parts = spec.strip().split(":")
        if len(parts) < 2:
            continue
        if parts[0] in UNPORTED_POINTS or parts[1] in UNPORTED_KINDS:
            return f"{parts[0]}:{parts[1]}"
    return None
