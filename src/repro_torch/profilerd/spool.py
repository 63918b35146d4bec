"""Size-bounded byte ring over an mmap'd file (the default spool transport):
a copy of ``repro.profilerd.spool``, the same layout.

Single writer (the target's agent thread) / single reader (the daemon
process).  Offsets are monotonically increasing ``u64`` byte counts; the
physical position is ``offset % capacity``.  The writer only commits a batch
if the *whole* batch fits (``capacity - (head - tail)`` bytes free), otherwise
it drops the batch and bumps the ``dropped`` counter — the target never
blocks on the profiler, which is the paper's non-intrusiveness contract.

Because records are self-delimiting (see :mod:`repro_torch.profilerd.wire`) the
ring stores a raw byte stream; the reader drains whatever contiguous bytes
are available (two copies on wrap) and feeds them to a streaming decoder.

No locks: the writer only writes ``head``/``dropped``/``bye``, the reader
only writes ``tail``.  Each field is a single 8-byte aligned slot updated
*after* its payload, which is sufficient for this SPSC design.
"""

from __future__ import annotations

import mmap
import os
import struct
import time

MAGIC = b"RPSP"
SPOOL_VERSION = 1
HEADER_SIZE = 64

_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")

# header field offsets (bytes)
_OFF_MAGIC = 0
_OFF_VERSION = 4
_OFF_CAPACITY = 8
_OFF_HEAD = 16
_OFF_TAIL = 24
_OFF_DROPPED = 32
_OFF_WRITER_PID = 40
_OFF_BYE = 48  # writer sets to 1 after its final record

DEFAULT_CAPACITY = 4 << 20
# Per-read() drain cap: a reader that fell minutes behind sees the backlog as
# a stream of bounded chunks instead of one giant bytes object (the records
# are self-delimiting, so a chunk boundary mid-record is fine — the streaming
# decoder buffers the partial record).
DEFAULT_READ_CAP = 1 << 20


class SpoolError(RuntimeError):
    pass


class _Mapped:
    def __init__(self, path: str, size: int, create: bool):
        flags = os.O_RDWR | (os.O_CREAT if create else 0)
        self._fd = os.open(path, flags, 0o644)
        if create:
            os.ftruncate(self._fd, size)
        self.mm = mmap.mmap(self._fd, size)

    def close(self) -> None:
        try:
            self.mm.close()
        finally:
            os.close(self._fd)

    def get_u64(self, off: int) -> int:
        return _U64.unpack_from(self.mm, off)[0]

    def set_u64(self, off: int, value: int) -> None:
        _U64.pack_into(self.mm, off, value)


class SpoolWriter:
    """Target-side end: create the spool file and append batches."""

    def __init__(self, path: str, capacity: int = DEFAULT_CAPACITY):
        if capacity <= 0:
            raise SpoolError("capacity must be positive")
        self.path = path
        self.capacity = capacity
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        # Build under a temp name then rename, so a reader polling for the
        # spool never maps a half-initialised header.
        tmp = f"{path}.tmp.{os.getpid()}"
        self._m = _Mapped(tmp, HEADER_SIZE + capacity, create=True)
        mm = self._m.mm
        mm[_OFF_MAGIC : _OFF_MAGIC + 4] = MAGIC
        _U32.pack_into(mm, _OFF_VERSION, SPOOL_VERSION)
        self._m.set_u64(_OFF_CAPACITY, capacity)
        self._m.set_u64(_OFF_HEAD, 0)
        self._m.set_u64(_OFF_TAIL, 0)
        self._m.set_u64(_OFF_DROPPED, 0)
        self._m.set_u64(_OFF_WRITER_PID, os.getpid())
        self._m.set_u64(_OFF_BYE, 0)
        os.replace(tmp, path)
        self._head = 0
        self.dropped = 0

    def write(self, payload: bytes) -> bool:
        """Append one batch; returns False (and counts a drop) if it won't fit."""
        n = len(payload)
        if n == 0:
            return True
        tail = self._m.get_u64(_OFF_TAIL)
        free = self.capacity - (self._head - tail)
        if n > free:
            self.dropped += 1
            self._m.set_u64(_OFF_DROPPED, self.dropped)
            return False
        pos = self._head % self.capacity
        first = min(n, self.capacity - pos)
        mm = self._m.mm
        mm[HEADER_SIZE + pos : HEADER_SIZE + pos + first] = payload[:first]
        if first < n:
            mm[HEADER_SIZE : HEADER_SIZE + n - first] = payload[first:]
        self._head += n
        self._m.set_u64(_OFF_HEAD, self._head)
        return True

    def write_bye(self, payload: bytes, retries: int = 20, wait_s: float = 0.05) -> bool:
        """Final record: retry briefly (the reader may still be draining)."""
        for _ in range(retries):
            if self.write(payload):
                self._m.set_u64(_OFF_BYE, 1)
                return True
            self.dropped -= 1  # the retry loop is one logical attempt
            self._m.set_u64(_OFF_DROPPED, self.dropped)
            time.sleep(wait_s)
        self.dropped += 1
        self._m.set_u64(_OFF_DROPPED, self.dropped)
        self._m.set_u64(_OFF_BYE, 1)
        return False

    def close(self) -> None:
        self._m.close()


class _ShortHeader(SpoolError):
    """File smaller than the spool header (possibly still being created)."""


class SpoolReader:
    """Daemon-side end: drain available bytes and advance ``tail``.

    Attaching validates the whole header — magic, version, declared capacity
    against the file size — and every failure mode (empty file, truncated
    header, foreign file, mmap race) raises :class:`SpoolError` with a clean
    message, never a raw ``struct.error``/``ValueError``/``OSError``.  A
    short header gets one retry after ``header_retry_s``: a ``--watch``
    discovery loop races freshly-created files, and the writer's
    temp-then-rename protocol still leaves a brief window on filesystems
    that surface renames before data (network mounts, some CI overlays).
    """

    def __init__(self, path: str, header_retry_s: float = 0.05):
        self.path = path
        try:
            self._open(path)
        except _ShortHeader:
            time.sleep(header_retry_s)
            self._open(path)

    def _open(self, path: str) -> None:
        try:
            size = os.path.getsize(path)
        except OSError as e:
            raise SpoolError(f"{path}: cannot stat spool: {e}") from None
        if size < HEADER_SIZE:
            raise _ShortHeader(
                f"{path}: truncated spool header ({size} < {HEADER_SIZE} bytes)"
            )
        try:
            m = _Mapped(path, size, create=False)
        except (OSError, ValueError) as e:
            raise SpoolError(f"{path}: cannot map spool: {e}") from None
        ok = False
        try:
            mm = m.mm
            if bytes(mm[_OFF_MAGIC : _OFF_MAGIC + 4]) != MAGIC:
                raise SpoolError(f"{path}: bad spool magic (not a spool file?)")
            try:
                (version,) = _U32.unpack_from(mm, _OFF_VERSION)
                capacity = m.get_u64(_OFF_CAPACITY)
                tail = m.get_u64(_OFF_TAIL)
            except struct.error as e:
                raise SpoolError(f"{path}: unreadable spool header: {e}") from None
            if version != SPOOL_VERSION:
                raise SpoolError(f"{path}: spool version {version} != {SPOOL_VERSION}")
            if capacity <= 0:
                raise SpoolError(f"{path}: declared capacity {capacity} is not positive")
            if size < HEADER_SIZE + capacity:
                raise SpoolError(
                    f"{path}: file size {size} smaller than declared capacity "
                    f"{capacity} + header"
                )
            st = os.fstat(m._fd)
            ok = True
        finally:
            if not ok:
                m.close()
        self._m = m
        self.capacity = capacity
        self._tail = tail
        # Identity of the mapped file: a crashed-and-restarted writer
        # recreates the spool via temp+rename, so the path pointing at a
        # different inode is the re-attach signal (see replaced()).
        self.file_id = (st.st_dev, st.st_ino)

    @classmethod
    def wait_for(cls, path: str, timeout_s: float = 30.0, poll_s: float = 0.05) -> "SpoolReader":
        deadline = time.monotonic() + timeout_s
        while True:
            try:
                if os.path.exists(path) and os.path.getsize(path) >= HEADER_SIZE:
                    return cls(path)
            except OSError:
                pass
            if time.monotonic() >= deadline:
                raise SpoolError(f"spool {path} did not appear within {timeout_s:.0f}s")
            time.sleep(poll_s)

    @property
    def writer_pid(self) -> int:
        return self._m.get_u64(_OFF_WRITER_PID)

    @property
    def dropped(self) -> int:
        return self._m.get_u64(_OFF_DROPPED)

    @property
    def bye_seen(self) -> bool:
        return self._m.get_u64(_OFF_BYE) == 1

    @property
    def backlog(self) -> int:
        """Bytes written but not yet drained (backpressure accounting)."""
        return self._m.get_u64(_OFF_HEAD) - self._tail

    def replaced(self) -> bool:
        """True when ``path`` now names a different file than the one mapped.

        A target that crashed and restarted recreates its spool under the
        same path (temp+rename), leaving this reader mapped to the unlinked
        old inode — which stays drainable, so callers drain it dry and then
        attach a fresh reader to the new incarnation.  A deleted (not
        replaced) spool returns False: there is nothing new to attach to.
        """
        try:
            st = os.stat(self.path)
        except OSError:
            return False
        return (st.st_dev, st.st_ino) != self.file_id

    def read(self, max_bytes: int | None = DEFAULT_READ_CAP) -> bytes:
        """Drain up to ``max_bytes`` (``None`` = everything available)."""
        head = self._m.get_u64(_OFF_HEAD)
        n = head - self._tail
        if max_bytes is not None:
            n = min(n, max_bytes)
        if n <= 0:
            return b""
        pos = self._tail % self.capacity
        first = min(n, self.capacity - pos)
        mm = self._m.mm
        out = bytes(mm[HEADER_SIZE + pos : HEADER_SIZE + pos + first])
        if first < n:
            out += bytes(mm[HEADER_SIZE : HEADER_SIZE + n - first])
        self._tail += n
        self._m.set_u64(_OFF_TAIL, self._tail)
        return out

    def close(self) -> None:
        self._m.close()
