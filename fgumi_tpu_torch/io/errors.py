"""Typed I/O errors carrying the file path and byte offset.

:class:`InputFormatError` subclasses ValueError, so ``except ValueError``
callers keep working, while the CLI's top-level handler recognises a
diagnosed input problem (a truncated BGZF stream, a corrupt block, a
malformed record) and exits 2 with one line instead of a Python traceback.
:class:`OutputIntegrityError` is a refuted ``--audit-output`` pass (exit 5).
"""


class OutputIntegrityError(RuntimeError):
    """A written output failed its pre-commit integrity audit.

    Raised by the ``--audit-output`` pass (io/bam.py, io/bgzf.py) when the
    re-walked temporary file disagrees with what the writer believes it
    wrote: a corrupt BGZF member (CRC32/ISIZE), a truncated member, a
    record-count or record-digest mismatch, or records out of coordinate
    order. The atomic commit is aborted, so the bad file is never
    published under its final name; the CLI exits 5."""

    def __init__(self, message: str, path: str = None, offset: int = None):
        self.path = path
        self.offset = offset
        loc = f"{path}: " if path is not None else ""
        suffix = f" (near byte offset {offset})" if offset is not None \
            else ""
        super().__init__(
            f"{loc}output integrity audit failed: {message}{suffix}")


class InputFormatError(ValueError):
    """Corrupt, truncated or malformed input.

    ``path`` and ``offset`` (the compressed-stream byte offset, when known)
    are kept as attributes and folded into the message, so one ``str()`` is
    the whole diagnostic.
    """

    def __init__(self, message: str, path: str = None, offset: int = None):
        self.path = path
        self.offset = offset
        loc = f"{path}: " if path is not None else ""
        suffix = f" (near byte offset {offset})" if offset is not None \
            else ""
        super().__init__(f"{loc}{message}{suffix}")
