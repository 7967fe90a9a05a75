"""Source-stamped on-disk memoization for expensive metadata scans.

The port's copy of garmentnets_tpu/utils/cache.py.

Role parity with reference ``common/cache.py`` (used by the dataset to cache
the zarr attrs scan across runs), but a different design: instead of
comparing a single cache file's mtime against the source's, every cache
entry's filename embeds a *stamp* of the source file state
``(absolute path, mtime_ns, size)``. A modified source therefore maps to a
fresh entry and can never alias a stale one — even if cache-file mtimes are
perturbed by backup/sync tools — and superseded entries for the same source
are garbage-collected on write.
"""
from __future__ import annotations

import hashlib
import os
import pathlib
import pickle
import tempfile
from typing import Any, Callable


class SourceStampCache:
    """Memoizes one computed object per (source file, file state)."""

    def __init__(self, cache_dir="~/.cache/garmentnets_tpu"):
        self.root = pathlib.Path(cache_dir).expanduser()

    @staticmethod
    def _stamp(source: pathlib.Path) -> tuple[str, str]:
        """Returns (source_id, state_id) hex digests for a source file."""
        st = source.stat()
        path_bytes = str(source.resolve()).encode()
        source_id = hashlib.sha1(path_bytes).hexdigest()[:16]
        state = f"{st.st_mtime_ns}:{st.st_size}".encode()
        state_id = hashlib.sha1(path_bytes + b"\0" + state).hexdigest()[:16]
        return source_id, state_id

    def get_or_compute(self, source_path, compute: Callable[[], Any]) -> Any:
        """Loads the cached value for source_path's current state, or runs
        compute(), stores the result, and drops entries for older states."""
        source = pathlib.Path(source_path).expanduser()
        source_id, state_id = self._stamp(source)
        entry = self.root / f"{source_id}-{state_id}.pkl"
        if entry.exists():
            try:
                with entry.open("rb") as f:
                    return pickle.load(f)
            except (pickle.UnpicklingError, EOFError, OSError):
                pass  # corrupt entry: fall through and recompute
        value = compute()
        self.root.mkdir(parents=True, exist_ok=True)
        # atomic publish so a concurrent reader never sees a partial pickle
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                pickle.dump(value, f)
            os.replace(tmp, entry)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        for stale in self.root.glob(f"{source_id}-*.pkl"):
            if stale != entry:
                try:
                    stale.unlink()
                except OSError:
                    pass
        return value


def file_attr_cache(target_file, cache_dir="~/.cache/garmentnets_tpu"):
    """Decorator-style facade matching the dataset call site: memoize
    ``func(*args)`` on disk, invalidated whenever target_file changes."""
    cache = SourceStampCache(cache_dir)

    def decorator(func):
        def wrapped(*args, **kwargs):
            return cache.get_or_compute(
                target_file, lambda: func(*args, **kwargs))
        return wrapped
    return decorator
