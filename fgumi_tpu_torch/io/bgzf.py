"""BGZF block compression I/O on zlib, parallel across blocks.

BGZF is gzip with fixed-size members carrying a BSIZE extra field (reference:
crates/fgumi-bgzf/src/lib.rs). Every block is compressed and inflated on
its own, so both directions spread a run of blocks over threads: Python's
``zlib`` releases the GIL while it deflates, inflates and checksums.

- Writing: complete 0xFF00-byte blocks buffered by one call are compressed
  together on a process-wide thread pool of :func:`compress_threads`
  workers (the reference's ``bgzf_compress_many``,
  fgumi_tpu/native/fgumi_native.cc:2640-2690). A block's bytes depend only
  on its data and the level, so the output equals the serial writer's.
  Blocks carry the BC subfield, and the stream ends with the EOF sentinel,
  so htslib/samtools read it.
- Reading: BGZF input (each member carries the BC subfield) is parsed block
  by block from raw chunks; a chunk's whole blocks inflate on the same pool
  and each is held to its CRC32 and ISIZE (the reference's
  ``_fill_native``). Plain gzip (one large member, or any member without
  the BC subfield) streams through ``zlib.decompressobj``, as the
  reference auto-detects.

Telemetry: a write's compression is a ``bgzf.compress`` span on the
writing thread and an inflated run a ``bgzf.decompress`` span on the
reading thread (``io.bgzf.compress_s`` / ``decompress_s`` histograms);
with tracing on, each group of blocks a thread compresses or inflates is a
``bgzf.compress.blocks`` / ``bgzf.decompress.blocks`` span on that thread,
the pool's included (its tasks run in the submitting thread's context).
The ``writer.compress`` fault point fires on the bytes handed to
:meth:`BgzfWriter.write` (``corrupt-bytes`` corrupts what is written) and
``reader.decompress`` on each raw chunk read.
"""

import contextvars
import io
import os
import struct
import threading
import time
import zlib
from collections import deque
from concurrent import futures

import numpy as np

from ..observe import trace as _trace
from ..observe.metrics import METRICS
from ..utils import faults
from .errors import InputFormatError, OutputIntegrityError

# Maximum uncompressed payload per BGZF block.
MAX_BLOCK_DATA = 0xFF00

# The fixed 28-byte BGZF EOF sentinel block (SAM spec §4.1.2).
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)

_HEADER = struct.Struct("<4BI2BH2BHH")  # gzip header + XLEN + BC subfield + BSIZE
_MAGIC = b"\x1f\x8b\x08\x04"  # gzip, deflate, FEXTRA
_TRAILER = struct.Struct("<II")  # CRC32, ISIZE

_COMPRESS_THREADS = None
_POOLS = {}
_POOLS_LOCK = threading.Lock()


def compress_threads() -> int:
    """Threads that compress or inflate a run of BGZF blocks: min(4,
    cpus // 2), at least 1 (the reference's policy); the
    ``FGUMI_TPU_COMPRESS_THREADS`` environment variable overrides it. Read
    once per process."""
    global _COMPRESS_THREADS
    if _COMPRESS_THREADS is None:
        env = os.environ.get("FGUMI_TPU_COMPRESS_THREADS", "")
        if env.isdigit():
            _COMPRESS_THREADS = max(int(env), 1)
        else:
            _COMPRESS_THREADS = max(min(4, (os.cpu_count() or 2) // 2), 1)
    return _COMPRESS_THREADS


def _pool(threads: int) -> futures.ThreadPoolExecutor:
    """The process's shared pool of ``threads`` workers (made at first
    use; every reader and writer of the process submits to it)."""
    with _POOLS_LOCK:
        ex = _POOLS.get(threads)
        if ex is None:
            ex = futures.ThreadPoolExecutor(
                max_workers=threads, thread_name_prefix="fgumi-bgzf")
            _POOLS[threads] = ex
        return ex


def _map_groups(fn, items: list, threads: int) -> list:
    """``fn`` over ``threads`` contiguous groups of ``items``, the first on
    the calling thread and the rest on the pool; the groups' results in
    order. Every future is waited for, also when a group raises."""
    n = len(items)
    k = min(threads, n)
    if k <= 1:
        return [fn(items)]
    cuts = [n * i // k for i in range(k + 1)]
    groups = [items[cuts[i]:cuts[i + 1]] for i in range(k)]
    ex = _pool(threads)
    # each task runs in the caller's context: its spans and counters land
    # in the caller's command, whichever command's pool thread runs it
    futs = [ex.submit(contextvars.copy_context().run, fn, g)
            for g in groups[1:]]
    try:
        first = fn(groups[0])
    finally:
        futures.wait(futs)
    return [first] + [f.result() for f in futs]


def _block_header(bsize_minus1: int) -> bytes:
    return _HEADER.pack(
        0x1F, 0x8B, 0x08, 0x04,  # magic, deflate, FEXTRA
        0,  # mtime
        0, 0xFF,  # XFL, OS=unknown
        6,  # XLEN
        0x42, 0x43,  # 'B','C'
        2,  # SLEN
        bsize_minus1,
    )


def compress_block(data, level: int = 1) -> bytes:
    """Compress one <=64KiB chunk (any buffer) into a standalone BGZF
    block.

    Levels 1-9 deflate in one ``zlib.compress`` call, whose bytes equal a
    compressor object's (``compress`` then ``flush``) and which, unlike
    it, runs in parallel across threads; level 0 keeps the compressor
    object, whose stored blocks split differently."""
    assert len(data) <= 0x10000
    if level:
        payload = zlib.compress(data, level, -15)
    else:
        co = zlib.compressobj(level, zlib.DEFLATED, -15)
        payload = co.compress(data) + co.flush()
    bsize = len(payload) + _HEADER.size + 8
    assert bsize <= 0x10000, "BGZF block overflow (incompressible data)"
    return (
        _block_header(bsize - 1)
        + payload
        + _TRAILER.pack(zlib.crc32(data), len(data) & 0xFFFFFFFF)
    )


def compress_many(data, level: int = 1, threads: int = None,
                  trace: bool = False):
    """Compress ``data`` into consecutive BGZF blocks of MAX_BLOCK_DATA
    input bytes (the last one may be shorter), across ``threads`` threads
    (default :func:`compress_threads`). Returns the blocks' bytes and the
    (n_blocks + 1,) int64 table of each block's offset in them, as the
    reference's ``fgumi_bgzf_compress_many`` does. ``trace``: each group of
    blocks is a span on the thread that compresses it."""
    mv = memoryview(data)
    chunks = [mv[i:i + MAX_BLOCK_DATA]
              for i in range(0, len(mv), MAX_BLOCK_DATA)]
    threads = compress_threads() if threads is None else max(int(threads), 1)

    def run(group):
        with _trace.span("bgzf.compress.blocks", blocks=len(group)) \
                if trace else _trace.NULL_SPAN:
            return [compress_block(c, level) for c in group]

    blocks = [b for part in _map_groups(run, chunks, threads) for b in part]
    block_off = np.zeros(len(blocks) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in blocks], out=block_off[1:])
    return b"".join(blocks), block_off


def _reraise_disk_full(exc: BaseException, fileobj):
    """A full output disk ends the command with ``ResourceExhausted``
    (exit 4); every other exception returns for the caller to re-raise."""
    from ..utils.governor import reraise_enospc

    reraise_enospc(exc, "bgzf.write", path=getattr(fileobj, "name", None))


class BgzfWriter(io.RawIOBase):
    """Streaming BGZF writer: buffers to MAX_BLOCK_DATA and emits blocks,
    compressing the complete blocks of one call together across threads.
    It counts the compressed bytes written, so it can give the virtual
    offset of any byte (BAI/CSI indexes). A failed write or flush marks the
    stream broken: :meth:`close` then discards it and writes no EOF
    block."""

    def __init__(self, fileobj, level: int = 1, owns_fileobj: bool = False,
                 *, threads: int = None):
        self._f = fileobj
        self._level = level
        self._threads = threads
        self._buf = bytearray()
        self._owns = owns_fileobj
        self._coffset = 0  # compressed bytes written so far
        self._broken = False
        # hoisted: write() may run once per record, and a fire() costs a
        # lock and an environment read
        self._fault_armed = faults.armed("writer.compress")
        self._trace_on = _trace.tracing_enabled()
        self._counted = False

    def _emit_full(self) -> np.ndarray:
        """Compress and write every complete buffered block; returns their
        block-offset table. The buffer is swapped before the compression
        reads it, so no view pins a buffer that later resizes."""
        chunk_len = len(self._buf) // MAX_BLOCK_DATA * MAX_BLOCK_DATA
        full, self._buf = self._buf, self._buf[chunk_len:]
        t0 = time.monotonic()
        with _trace.span("bgzf.compress",
                         blocks=chunk_len // MAX_BLOCK_DATA) \
                if self._trace_on else _trace.NULL_SPAN:
            blob, block_off = compress_many(memoryview(full)[:chunk_len],
                                            self._level, self._threads,
                                            trace=self._trace_on)
        METRICS.observe("io.bgzf.compress_s", time.monotonic() - t0)
        self._f.write(blob)
        self._coffset += len(blob)
        return block_off

    def write(self, data) -> int:
        try:
            if self._fault_armed:
                data = faults.fire("writer.compress", data)
            # memoryview: a numpy chunk appends through the buffer protocol
            # (a plain += would dispatch to ndarray broadcasting)
            mv = memoryview(data)
            self._buf += mv
            if len(self._buf) >= MAX_BLOCK_DATA:
                self._emit_full()
            return mv.nbytes
        except BaseException as e:
            self._broken = True
            _reraise_disk_full(e, self._f)
            raise

    def tell_virtual(self) -> int:
        """BGZF virtual offset of the next byte to be written: (compressed
        offset of its block) << 16 | offset within the block."""
        return (self._coffset << 16) | len(self._buf)

    def write_indexed(self, blob, starts) -> np.ndarray:
        """Write ``blob`` and return the virtual offset of each position in
        ``starts`` (ascending offsets into ``blob``; pass len(blob) last to
        get the end's). The blocks and their bytes are those of
        :meth:`write`: a position at buffered offset u lands in block
        u // MAX_BLOCK_DATA of this call, at u % MAX_BLOCK_DATA, or in the
        buffer left over."""
        try:
            return self._write_indexed(blob, starts)
        except BaseException as e:
            self._broken = True
            _reraise_disk_full(e, self._f)
            raise

    def _write_indexed(self, blob, starts) -> np.ndarray:
        u = np.asarray(starts, dtype=np.int64) + len(self._buf)
        self._buf += memoryview(blob)
        n_full = len(self._buf) // MAX_BLOCK_DATA
        chunk_len = n_full * MAX_BLOCK_DATA
        coff0 = self._coffset
        if n_full == 0:
            return (coff0 << 16) | u
        block_off = self._emit_full()
        blk = np.minimum(u // MAX_BLOCK_DATA, n_full - 1)
        vo_full = ((coff0 + block_off[blk]) << 16) | (u % MAX_BLOCK_DATA)
        vo_tail = (self._coffset << 16) | np.maximum(u - chunk_len, 0)
        return np.where(u < chunk_len, vo_full, vo_tail)

    def flush(self):
        try:
            # fire only with data to flush: IOBase.close calls flush()
            # again, and must not use up a counted fault's budget
            if self._fault_armed and self._buf:
                faults.fire("writer.compress")
            if self._buf:
                with _trace.span("bgzf.compress", blocks=1) \
                        if self._trace_on else _trace.NULL_SPAN:
                    block = compress_block(self._buf, self._level)
                self._f.write(block)
                self._coffset += len(block)
                self._buf.clear()
        except BaseException as e:
            self._broken = True
            _reraise_disk_full(e, self._f)
            raise

    def close(self):
        if self.closed:
            return
        if self._broken:
            self.discard()
            return
        self.flush()
        try:
            self._f.write(BGZF_EOF)
            self._f.flush()
        except BaseException as e:
            self._broken = True
            _reraise_disk_full(e, self._f)
            raise
        self._coffset += len(BGZF_EOF)
        if not self._counted:
            self._counted = True
            METRICS.inc("io.bytes_written", self._coffset)
        if self._owns:
            self._f.close()
        super().close()

    def discard(self):
        """Abandon the stream (the error path's close): drop the buffered
        data and close (an atomic output: discard) the file without the EOF
        block."""
        if self.closed:
            return
        self._buf.clear()
        if self._owns:
            drop = getattr(self._f, "discard", None)
            (drop or self._f.close)()
        super().close()


def is_bgzf_member(buf) -> bool:
    """True iff ``buf`` starts with a BGZF member header (gzip, FEXTRA and
    a BC subfield of 2 bytes). Call with at least 18 bytes."""
    if bytes(buf[:4]) != _MAGIC:
        return False
    xlen = int.from_bytes(buf[10:12], "little")
    return _bc_bsize(buf[12:12 + xlen]) >= 0


def _bc_bsize(extra) -> int:
    """BSIZE (member length - 1) from a member's FEXTRA subfields, or -1
    when it has no BC subfield."""
    off = 0
    while off + 4 <= len(extra):
        slen = int.from_bytes(extra[off + 2:off + 4], "little")
        if bytes(extra[off:off + 2]) == b"BC" and slen == 2 \
                and off + 6 <= len(extra):
            return int.from_bytes(extra[off + 4:off + 6], "little")
        off += 4 + slen
    return -1


def _scan_blocks(raw):
    """Parse the complete BGZF blocks at the start of ``raw``.

    Returns ``(blocks, end, stop)``: each block as (start, payload start,
    payload end, CRC32, ISIZE), the offset just past the last one, and why
    the scan stopped: ``"partial"`` (a header or block cut by the end of
    ``raw``), ``"foreign"`` (not a BGZF member header: a plain gzip member
    or garbage) or a message naming a malformed block at ``end``."""
    blocks = []
    off = 0
    n = len(raw)
    while True:
        if n - off < 18:
            head = bytes(raw[off:off + 4])
            stop = "partial" if _MAGIC.startswith(head) else "foreign"
            return blocks, off, stop
        if bytes(raw[off:off + 4]) != _MAGIC:
            return blocks, off, "foreign"
        xlen = int.from_bytes(raw[off + 10:off + 12], "little")
        if n - off < 12 + xlen:
            return blocks, off, "partial"
        bsize = _bc_bsize(raw[off + 12:off + 12 + xlen])
        if bsize < 0:
            return blocks, off, "foreign"
        size = bsize + 1
        if size < 12 + xlen + 8:
            return blocks, off, (f"malformed BGZF block: BSIZE {size} is "
                                 "smaller than its own header")
        if n - off < size:
            return blocks, off, "partial"
        crc, isize = _TRAILER.unpack_from(raw, off + size - 8)
        if isize > 0x10000:
            return blocks, off, (f"malformed BGZF block: ISIZE {isize} "
                                 "exceeds 65536")
        blocks.append((off, off + 12 + xlen, off + size - 8, crc, isize))
        off += size


def _inflate_into(raw, blocks, out, out_off) -> int:
    """Inflate ``blocks`` of ``raw`` into ``out`` from ``out_off`` on; the
    index of the first block that fails (its deflate stream, CRC32 or
    ISIZE), or -1."""
    for i, (_, p0, p1, crc, isize) in enumerate(blocks):
        try:
            # an output buffer of ISIZE bytes: one allocation, one release
            # of the GIL for the whole block
            data = zlib.decompress(raw[p0:p1], -15, max(isize, 1))
        except zlib.error:
            return i
        if len(data) != isize or zlib.crc32(data) != crc:
            return i
        out[out_off:out_off + isize] = np.frombuffer(data, dtype=np.uint8)
        out_off += isize
    return -1


class BgzfReader:
    """Streaming multi-member gzip/BGZF reader over a file object.

    read(n) returns exactly n bytes unless EOF. BGZF input inflates a run
    of whole blocks at a time across ``threads`` threads (default
    :func:`compress_threads`), each block held to its CRC32 and ISIZE;
    plain gzip streams through zlib (the reference auto-detects likewise).
    A corrupt or truncated stream raises :class:`InputFormatError` with
    the path and the compressed offset, after every byte before the
    damage has been handed out.
    """

    def __init__(self, fileobj, chunk_size: int = 1 << 20,
                 owns_fileobj: bool = False, name: str = None, *,
                 threads: int = None):
        self._f = fileobj
        self._owns = owns_fileobj
        self._chunk = chunk_size
        self._threads = threads
        self._z = zlib.decompressobj(wbits=31)
        self._z_started = False  # current member got any input
        self._buf = bytearray()
        self._eof = False
        self.name = name if name is not None \
            else getattr(fileobj, "name", None)
        self._in_off = 0  # compressed bytes read off the file
        # None: undecided; True: BGZF blocks; False: zlib streaming
        self._blocks = None
        self._raw = b""  # undecoded raw bytes of the block route
        self._pieces = deque()  # inflated bytes not handed out yet
        self._trace_on = _trace.tracing_enabled()
        self._counted = False

    def _input_error(self, message: str, offset: int = None):
        return InputFormatError(message, path=self.name,
                                offset=self._in_off if offset is None
                                else offset)

    def _read_raw(self) -> bytes:
        raw = self._f.read(self._chunk)
        if raw:
            self._in_off += len(raw)
            raw = faults.fire("reader.decompress", raw)
        else:
            self._eof = True
        return raw

    def _decide(self):
        """Pick the route from the first raw chunk: the block route only
        for genuine BGZF input."""
        first = self._read_raw()
        self._blocks = len(first) >= 18 and is_bgzf_member(first)
        if self._blocks:
            self._raw = first
        elif first:
            self._buf += self._zdecomp(first)

    def _zdecomp(self, data) -> bytes:
        self._z_started = True
        try:
            return self._z.decompress(data)
        except zlib.error as e:
            raise self._input_error(f"corrupt gzip/BGZF data: {e}") from e

    def _to_stream(self):
        """Hand the rest of the stream to zlib (a member without the BC
        subfield, or bytes that are no member at all: zlib reports them)."""
        self._blocks = False
        rest, self._raw = self._raw, b""
        if rest:
            self._buf += self._zdecomp(rest)

    def _decode_run(self) -> bool:
        """Inflate the next run of whole blocks into :attr:`_pieces`; False
        at the end of the stream or once the stream moved to zlib."""
        while True:
            raw = self._raw
            blocks, end, stop = _scan_blocks(raw)
            base = self._in_off - len(raw)  # file offset of raw[0]
            if blocks:
                self._inflate(raw, blocks, base)
                if self._pieces:
                    return True
                continue  # empty blocks only (an EOF block mid-stream)
            if stop == "foreign":
                self._to_stream()
                return False
            if stop != "partial":
                raise self._input_error(stop, base + end)
            if self._eof:
                if raw:
                    raise self._input_error(
                        "truncated BGZF stream (partial block at EOF)",
                        base + end)
                return False
            more = self._read_raw()
            if more:
                self._raw = raw + more

    def _inflate(self, raw, blocks, base: int):
        """Inflate ``blocks`` across threads and queue their bytes as
        pieces. A bad block raises when it is the first; otherwise the
        blocks before it are queued and it raises on the next run."""
        starts = np.zeros(len(blocks) + 1, dtype=np.int64)
        np.cumsum([b[4] for b in blocks], out=starts[1:])
        out = np.empty(int(starts[-1]), dtype=np.uint8)
        threads = compress_threads() if self._threads is None \
            else max(int(self._threads), 1)
        mv = memoryview(raw)
        trace = self._trace_on

        def run(group):
            if not group:
                return -1
            with _trace.span("bgzf.decompress.blocks", blocks=len(group)) \
                    if trace else _trace.NULL_SPAN:
                bad = _inflate_into(mv, blocks[group[0]:group[-1] + 1], out,
                                    int(starts[group[0]]))
            return -1 if bad < 0 else group[0] + bad

        t0 = time.monotonic()
        with _trace.span("bgzf.decompress", blocks=len(blocks)) \
                if trace else _trace.NULL_SPAN:
            failed = [i for i in _map_groups(run, list(range(len(blocks))),
                                             threads) if i >= 0]
        METRICS.observe("io.bgzf.decompress_s", time.monotonic() - t0)
        good = min(failed) if failed else len(blocks)
        if good == 0:
            raise self._input_error(
                "corrupt BGZF block (its deflate data, CRC32 or ISIZE do "
                "not check)", base + blocks[0][0])
        self._raw = raw[blocks[good][0]:] if good < len(blocks) \
            else raw[blocks[-1][2] + 8:]
        for i in range(good):
            self._queue_block(mv, blocks[i], base,
                              out[int(starts[i]):int(starts[i + 1])])

    def _queue_block(self, raw, block, base: int, data: np.ndarray):
        """Queue one block's bytes as the pieces the streaming route hands
        out: the block whole, or split where a read of the file ends inside
        its deflate data (the bytes inflated from before that point), so
        ``read_decoded`` gives the record batches the streaming route
        gives."""
        _, p0, p1, _, isize = block
        cut = 0
        first = (base + p0) // self._chunk + 1
        for edge in range(first * self._chunk, base + p1, self._chunk):
            d = zlib.decompressobj(-15)
            n = len(d.decompress(raw[p0:edge - base]))
            if cut < n < isize:
                self._pieces.append(data[cut:n])
                cut = n
        if cut < isize:
            self._pieces.append(data[cut:])

    def _fill(self, need: int):
        if self._blocks is None:
            self._decide()
        while len(self._buf) < need:
            if self._blocks:
                if self._pieces or self._decode_run():
                    self._buf += memoryview(self._pieces.popleft())
                    continue
                if self._blocks:
                    return  # end of the BGZF stream
                continue  # moved to zlib streaming
            if self._z.eof:
                # recycle pending concatenated members even after file EOF
                rest = self._z.unused_data
                self._z = zlib.decompressobj(wbits=31)
                self._z_started = False
                if rest:
                    self._buf += self._zdecomp(rest)
                    continue
            if self._eof:
                if self._z_started and not self._z.eof:
                    raise self._input_error(
                        "truncated gzip stream (unexpected EOF mid-member)")
                break
            raw = self._read_raw()
            if raw:
                self._buf += self._zdecomp(raw)

    def read(self, n: int) -> bytes:
        self._fill(n)
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out

    def read_decoded(self) -> np.ndarray:
        """The buffered bytes plus at least one more decoded piece, as a
        writable uint8 array (zero-copy on the block route: a piece is a
        view of the inflated run); empty at end of stream."""
        if self._blocks is None:
            self._decide()
        if self._blocks and not self._buf:
            if self._pieces or self._decode_run():
                return self._pieces.popleft()
            if self._blocks:
                return np.empty(0, dtype=np.uint8)
        self._fill(len(self._buf) + 1)
        data, self._buf = self._buf, bytearray()
        return np.frombuffer(data, dtype=np.uint8)

    def close(self):
        if not self._counted:
            self._counted = True
            if self._in_off:
                METRICS.inc("io.bytes_read", self._in_off)
        if self._owns:
            self._f.close()


def verify_members(path: str, sink=None) -> dict:
    """Re-walk a written BGZF file member by member (the ``--audit-output``
    compressed-layer pass): parse each header and its BC subfield, inflate
    the payload with a fresh decompressor, and hold the member's CRC32 and
    ISIZE to the freshly decoded bytes, so a bit flipped anywhere between
    the writer's buffers and the page cache fails loudly. ``sink(bytes)``,
    when given, receives each member's payload in order (the BAM walk rides
    it). Returns ``{"members", "data_bytes", "eof_sentinel"}``; raises
    :class:`OutputIntegrityError` naming the member's offset."""
    members = 0
    data_bytes = 0
    last_empty = False
    with open(path, "rb") as f:
        offset = 0
        while True:
            head = f.read(12)
            if not head:
                break
            if len(head) < 12 or head[:4] != _MAGIC:
                raise OutputIntegrityError(
                    "not a BGZF member header", path=path, offset=offset)
            xlen = int.from_bytes(head[10:12], "little")
            extra = f.read(xlen)
            if len(extra) < xlen:
                raise OutputIntegrityError(
                    "truncated member header", path=path, offset=offset)
            bsize = _bc_bsize(extra)
            if bsize < 0:
                raise OutputIntegrityError(
                    "member has no BC subfield", path=path, offset=offset)
            payload_len = bsize + 1 - 12 - xlen - 8
            if payload_len < 0:
                raise OutputIntegrityError(
                    f"member BSIZE {bsize + 1} smaller than its own "
                    "header", path=path, offset=offset)
            payload = f.read(payload_len)
            trailer = f.read(8)
            if len(payload) < payload_len or len(trailer) < 8:
                raise OutputIntegrityError(
                    "truncated member (file ends mid-block)", path=path,
                    offset=offset)
            z = zlib.decompressobj(wbits=-15)
            try:
                decoded = z.decompress(payload) + z.flush()
            except zlib.error as e:
                raise OutputIntegrityError(
                    f"member payload does not inflate: {e}", path=path,
                    offset=offset) from e
            if z.unconsumed_tail or not z.eof:
                raise OutputIntegrityError(
                    "member deflate stream did not terminate cleanly",
                    path=path, offset=offset)
            crc, isize = _TRAILER.unpack(trailer)
            if zlib.crc32(decoded) != crc:
                raise OutputIntegrityError(
                    f"member CRC32 mismatch (stored {crc:#010x}, "
                    f"computed {zlib.crc32(decoded):#010x})", path=path,
                    offset=offset)
            if (len(decoded) & 0xFFFFFFFF) != isize:
                raise OutputIntegrityError(
                    f"member ISIZE mismatch (stored {isize}, computed "
                    f"{len(decoded)})", path=path, offset=offset)
            members += 1
            data_bytes += len(decoded)
            last_empty = len(decoded) == 0
            if sink is not None and decoded:
                sink(decoded)
            offset += bsize + 1
    return {"members": members, "data_bytes": data_bytes,
            "eof_sentinel": last_empty}
