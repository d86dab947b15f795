"""Durable file writes: a file is replaced whole or not at all.

Counterpart of the atomic file primitive of
``deeplearning4j_tpu/resilience/durable.py`` (``atomic_replace_path``),
kept as the port's own copy: the model serializer writes its zip
through it, the flight recorder its artifacts through
:func:`atomic_write_text`. The rest of that module (checkpoint directories, commit
barriers, the crash-injection seam) ports with the fit loop's machinery
(ROADMAP.md A5).
"""

from __future__ import annotations

import contextlib
import os
import threading

__all__ = ["atomic_replace_path", "atomic_write_text"]

_TMP_PREFIX = ".tmp-"


def _fsync_dir(path: str) -> None:
    """fsync a directory so that a just-renamed entry survives power
    loss; best effort (not every file system opens directories)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


@contextlib.contextmanager
def atomic_replace_path(path: str):
    """For writers that need a real path (``zipfile``, ``np.save``):
    yields a temporary path in the same directory; on a clean exit the
    file there is fsynced and renamed onto ``path`` (then the directory
    fsynced), on an error it is removed. A crash leaves the old file or
    the whole new one, never a mix."""
    path = os.path.abspath(path)
    d = os.path.dirname(path)
    tmp = os.path.join(d, f"{_TMP_PREFIX}{os.path.basename(path)}."
                          f"{os.getpid()}.{threading.get_ident()}")
    try:
        yield tmp
        fd = os.open(tmp, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _fsync_dir(d)


def atomic_write_text(path: str, text: str) -> None:
    """Write ``text`` to ``path`` whole or not at all
    (:func:`atomic_replace_path`)."""
    with atomic_replace_path(path) as tmp:
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(text)
