"""Validator-directory lockfiles.

The role of lighthouse/common/lockfile (+ validator_dir's lockfile
usage): a VC acquires an exclusive lock per keystore before signing with
its keys, so two processes can never drive the same validator concurrently
— the classic accidental-slashing setup.

Implemented with flock(2) like the reference's fs2 try_lock_exclusive:
acquisition is atomic in the kernel, the lock dies with the process (no
stale-pid reclamation races), and the holder's pid is written into the
file purely as a diagnostic.
"""

from __future__ import annotations

import fcntl
import os
import pathlib


class LockfileError(Exception):
    pass


class Lockfile:
    def __init__(self, path: str | pathlib.Path):
        self.path = pathlib.Path(path)
        self._fd: int | None = None

    def acquire(self) -> "Lockfile":
        self.path.parent.mkdir(parents=True, exist_ok=True)
        # retry loop: if the inode we locked is no longer the one at the
        # path (some other actor unlinked/replaced the file between our
        # open and flock), the lock protects nothing — reopen and relock
        # the current file. Bounded: replacement storms are not expected.
        for _ in range(16):
            fd = os.open(self.path, os.O_CREAT | os.O_RDWR, 0o600)
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                holder = self._holder_pid()
                os.close(fd)
                raise LockfileError(
                    f"{self.path} is locked"
                    + (f" by process {holder}" if holder else "")
                    + " — another validator client is using these keys"
                ) from None
            try:
                st_path = os.stat(self.path)
            except FileNotFoundError:
                os.close(fd)
                continue
            st_fd = os.fstat(fd)
            if (st_fd.st_ino, st_fd.st_dev) != (st_path.st_ino, st_path.st_dev):
                os.close(fd)  # locked an orphaned inode: retry on the live one
                continue
            os.ftruncate(fd, 0)
            os.write(fd, str(os.getpid()).encode())
            self._fd = fd
            return self
        raise LockfileError(f"{self.path}: lockfile kept changing under us")

    def _holder_pid(self) -> int | None:
        try:
            return int(self.path.read_text().strip() or 0) or None
        except (FileNotFoundError, ValueError):
            return None

    def release(self) -> None:
        # NEVER unlink: removing the path before (or after) unlocking lets a
        # second VC lock the orphaned inode while a third locks a fresh file
        # at the same path — two holders of the "same" lock (the accidental-
        # slashing race this module exists to prevent). The empty lockfile
        # staying behind is harmless; flock dies with the fd.
        if self._fd is not None:
            fcntl.flock(self._fd, fcntl.LOCK_UN)
            os.close(self._fd)
            self._fd = None

    def __enter__(self) -> "Lockfile":
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()
