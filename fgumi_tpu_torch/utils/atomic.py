"""Crash-safe output commit: write to a temporary file, fsync, rename.

A killed process must never leave a truncated BAM or metrics file under the
final output name: a torn BGZF tail looks valid to a consumer until it hits
the missing EOF block. Every command output goes to a same-directory
``.<name>.tmp.<pid>.<seq>`` and is fsync'd and renamed over the final name
only on a successful close (atomic on POSIX: both live on one filesystem).
Before the rename an optional ``pre_commit_check`` (``--audit-output``,
io/bam.py) may refute the file, which then is never published.

Escape hatch: ``--no-atomic-output`` or ``FGUMI_TPU_NO_ATOMIC=1`` writes
straight to the final name (FIFOs and other special files).

Stale temporaries of crashed runs are swept when an output of the same
name is opened: a ``.name.tmp.<pid>[.<seq>]`` whose owning pid is dead is
removed (the pid is the component right after ``tmp``; this process's own
temporaries are never touched).
"""

import contextvars
import errno
import glob
import itertools
import logging
import os
import time as _time

log = logging.getLogger("fgumi_tpu_torch")

# context-scoped, so two commands run at once in one process can differ (one
# run with --no-atomic-output must not turn its neighbour's commit off)
_flag_disabled = contextvars.ContextVar("fgumi_tpu_torch_no_atomic", default=False)

# per-open uniquifier: two writers in one process targeting the same path
# never share a temp file
_seq = itertools.count(1)


def set_atomic_enabled(enabled: bool):
    """CLI hook for --no-atomic-output (per invocation, context-scoped)."""
    _flag_disabled.set(not enabled)


def atomic_enabled() -> bool:
    if _flag_disabled.get():
        return False
    return os.environ.get("FGUMI_TPU_NO_ATOMIC", "").lower() \
        not in ("1", "true", "yes")


def _tmp_path(path: str) -> str:
    d, base = os.path.split(os.path.abspath(path))
    return os.path.join(d, f".{base}.tmp.{os.getpid()}.{next(_seq)}")


def _owning_pid(temp_name: str, base: str):
    """The pid embedded in a temp file name, or None when unparseable.

    Reads the component immediately after ``.tmp.`` — both the current
    ``.<base>.tmp.<pid>.<seq>`` and the legacy ``.<base>.tmp.<pid>`` form —
    rather than the last dot token, which in the current form is the
    sequence number (treating *that* as the pid is exactly the bug that let
    a sweep delete a live writer's temp)."""
    suffix = temp_name[len(f".{base}.tmp."):]
    pid_s = suffix.split(".", 1)[0]
    try:
        return int(pid_s)
    except ValueError:
        return None


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True  # exists, owned by someone else
    except (OSError, OverflowError):
        return False
    return True


def cleanup_stale_temps(path: str):
    """Remove ``.<name>.tmp.<pid>[.<seq>]`` leftovers (for this target)
    whose *owning* process is dead. Temps owned by any live pid — this
    process included, which may have several writers near this target —
    are never touched. Best-effort: unlink races are
    ignored."""
    d, base = os.path.split(os.path.abspath(path))
    pattern = os.path.join(glob.escape(d), f".{glob.escape(base)}.tmp.*")
    for p in glob.glob(pattern):
        pid = _owning_pid(os.path.basename(p), base)
        if pid is None or pid == os.getpid() or _pid_alive(pid):
            continue
        try:
            os.unlink(p)
            log.info("removed stale temp output %s (pid %d is gone)", p, pid)
        except OSError:
            pass


def _fsync_dir(d: str):
    """Persist the rename itself (the directory entry), best-effort."""
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class AtomicOutputFile:
    """File-like write target committed by atomic rename.

    ``close()`` commits (flush + fsync + rename to the final name);
    ``discard()`` abandons the temp file. As a context manager, a clean
    exit commits and an exception discards — an interrupted run can never
    leave a partial file under the final name either way.
    """

    def __init__(self, path: str, mode: str = "wb"):
        self.name = path
        self._tmp = _tmp_path(path)
        cleanup_stale_temps(path)
        self._f = open(self._tmp, mode)
        self._done = False
        # optional pre-commit verification hook (--audit-output,
        # io/bam.py): called with the temp path after flush+fsync+close,
        # BEFORE the rename — a raise aborts the commit and discards the
        # temp, so a file that fails its own audit is never published
        self.pre_commit_check = None

    # -- the file-object surface the writers actually use ------------------
    def write(self, data):
        return self._f.write(data)

    def flush(self):
        self._f.flush()

    def fileno(self):
        return self._f.fileno()

    def tell(self):
        return self._f.tell()

    def writable(self):
        return True

    @property
    def closed(self):
        return self._done

    # -- commit protocol ---------------------------------------------------
    def commit(self):
        if self._done:
            return
        t0 = _time.monotonic()
        try:
            self._f.flush()
            try:
                os.fsync(self._f.fileno())
            except OSError as e:
                # only targets that cannot fsync (pipes, /dev/null) are
                # ignorable; a real write-back failure (EIO, ENOSPC) must
                # NOT commit — that would rename data the kernel just
                # reported as unwritten over the final name
                if e.errno not in (errno.EINVAL, errno.ENOTSUP,
                                   errno.EBADF, errno.EROFS):
                    raise
            self._f.close()
            if self.pre_commit_check is not None:
                self.pre_commit_check(self._tmp)
            os.replace(self._tmp, self.name)
        except BaseException:
            # ANY commit failure (flush ENOSPC, close, rename) discards:
            # the temp must not linger with an open fd, and _done must not
            # be set early or the discard would no-op
            self.discard()
            raise
        self._done = True
        _fsync_dir(os.path.dirname(self.name) or ".")
        # the run report's latency decomposition charges flush+fsync+rename
        # time to its "commit" component (io.commit_s histogram sum)
        try:
            from ..observe.metrics import METRICS

            METRICS.observe("io.commit_s", _time.monotonic() - t0)
        except Exception:  # noqa: BLE001 - telemetry never fails a commit
            pass

    def discard(self):
        """Abandon the output: close and remove the temp file."""
        if self._done:
            return
        self._done = True
        try:
            self._f.close()
        finally:
            try:
                os.unlink(self._tmp)
            except OSError:
                pass

    # plain close == successful completion (matches every writer's
    # success-path close() call); error paths use discard()/__exit__
    close = commit

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.commit()
        else:
            self.discard()


def open_output(path: str, mode: str = "wb"):
    """Open a command output for writing, atomically unless disabled.

    Returns an :class:`AtomicOutputFile` (or a plain file when atomic
    commit is disabled). Both support the context-manager protocol and
    ``discard()`` is present only on the atomic variant — error paths use
    :func:`discard_output` which handles either.
    """
    if atomic_enabled():
        return AtomicOutputFile(path, mode)
    return open(path, mode)


def discard_output(fileobj):
    """Abandon an open_output() object: discard if atomic, else close."""
    disc = getattr(fileobj, "discard", None)
    if disc is not None:
        disc()
    else:
        fileobj.close()
