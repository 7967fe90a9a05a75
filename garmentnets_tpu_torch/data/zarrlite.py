"""Minimal zarr v2 DirectoryStore reader/writer (pure Python + zlib).

The port's copy of garmentnets_tpu/data/zarrlite.py.

The reference's de-facto wire format is zarr v2 (SURVEY.md §2.4): the input
dataset, prediction.zarr, and eval summaries are all zarr groups. The zarr
package is not a dependency, so this module implements the subset
of the v2 spec the framework needs, format-compatible with real zarr readers:

- groups (.zgroup), arrays (.zarray), attributes (.zattrs)
- C-order chunks, any numpy dtype incl. unicode/bytes
- compressors: null (raw), zlib (stdlib), and blosc (data/blosc_codec.py —
  the reference's wire format, Blosc-zstd-bitshuffle per predict.py:75-79);
  written files are readable by stock zarr/numcodecs and vice versa.

API mirrors the zarr surface the harness uses: open/group/array/attrs/groups.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import zlib
from typing import Iterator, Tuple

import numpy as np

_CODECS = {}


def register_codec(name, encode, decode):
    _CODECS[name] = (encode, decode)


register_codec("zlib",
               lambda buf, cfg: zlib.compress(buf, cfg.get("level", 5)),
               lambda buf, cfg: zlib.decompress(buf))


class Attrs:
    def __init__(self, path: pathlib.Path, writable: bool):
        self._path = path / ".zattrs"
        self._writable = writable

    def asdict(self) -> dict:
        if self._path.exists():
            return json.loads(self._path.read_text())
        return {}

    def __getitem__(self, key):
        return self.asdict()[key]

    def __contains__(self, key):
        return key in self.asdict()

    def get(self, key, default=None):
        return self.asdict().get(key, default)

    def __setitem__(self, key, value):
        d = self.asdict()
        d[key] = value
        self.put(d)

    def put(self, d: dict):
        assert self._writable, "store opened read-only"
        self._path.write_text(json.dumps(d, default=_json_default))


def _json_default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o)}")


def _dtype_to_str(dt: np.dtype) -> str:
    return dt.str


class Array:
    def __init__(self, path: pathlib.Path, writable: bool):
        self.path = path
        self._writable = writable
        meta = json.loads((path / ".zarray").read_text())
        self.meta = meta
        self.shape = tuple(meta["shape"])
        self.chunks = tuple(meta["chunks"])
        self.dtype = np.dtype(meta["dtype"])
        self.fill_value = meta.get("fill_value", 0)
        self.attrs = Attrs(path, writable)
        comp = meta.get("compressor")
        self._codec = None
        if comp is not None:
            cid = comp["id"]
            if cid not in _CODECS:
                raise ValueError(
                    f"unsupported zarr compressor {cid!r}; register_codec() "
                    "to add support")
            self._codec = (cid, comp)
        if meta.get("order", "C") != "C":
            raise ValueError("only C-order supported")
        if meta.get("filters"):
            raise ValueError("filters not supported")

    def __len__(self):
        return self.shape[0]

    @property
    def ndim(self):
        return len(self.shape)

    def _read_chunk(self, cidx: Tuple[int, ...]) -> np.ndarray:
        # 0-d arrays store their single chunk as "0" (zarr v2 convention)
        fname = self.path / (".".join(map(str, cidx)) if cidx else "0")
        cshape = self.chunks
        if not fname.exists():
            fv = self.fill_value
            if fv is None:
                fv = 0
            return np.full(cshape, fv, self.dtype)
        buf = fname.read_bytes()
        if self._codec is not None:
            buf = _CODECS[self._codec[0]][1](buf, self._codec[1])
        arr = np.frombuffer(buf, self.dtype)
        if not arr.flags.writeable:
            # bytes-backed (uncompressed file / pure-Python codec): copy to
            # own the memory. Codec paths returning writable buffers (the
            # c-blosc decode-into-np.empty path) skip the copy — the full
            # 8.4 MB GT-volume chunk was being copied 3x per read before.
            arr = arr.copy()
        return arr.reshape(cshape)

    def __getitem__(self, key):
        return self._full()[key]

    def _full(self) -> np.ndarray:
        out = np.empty(self.shape, self.dtype)
        if any(s == 0 for s in self.shape):
            return out
        if self.ndim == 0:
            buf = self._read_chunk(())
            return buf.reshape(()).copy()
        grid = [
            -(-s // c) for s, c in zip(self.shape, self.chunks)]
        if all(g == 1 for g in grid):
            # single-chunk array (the common case for this dataset's
            # arrays, incl. the 128^3 GT volume): return the freshly
            # decoded chunk directly instead of copying it into `out`
            chunk = self._read_chunk((0,) * self.ndim)
            if chunk.shape == tuple(self.shape):
                return chunk
            return np.ascontiguousarray(
                chunk[tuple(slice(0, s) for s in self.shape)])
        for cidx in np.ndindex(*grid):
            chunk = self._read_chunk(cidx)
            sel = tuple(
                slice(i * c, min((i + 1) * c, s))
                for i, c, s in zip(cidx, self.chunks, self.shape))
            csel = tuple(
                slice(0, sl.stop - sl.start) for sl in sel)
            out[sel] = chunk[csel]
        return out

    def __array__(self, dtype=None, copy=None):
        arr = self._full()
        if dtype is not None:
            arr = arr.astype(dtype)
        return arr


class Group:
    def __init__(self, path: pathlib.Path, writable: bool):
        self.path = pathlib.Path(path)
        self._writable = writable
        self.attrs = Attrs(self.path, writable)

    # -- creation ------------------------------------------------------
    @staticmethod
    def create(path, overwrite: bool = False) -> "Group":
        path = pathlib.Path(path)
        if overwrite and path.exists():
            shutil.rmtree(path)
        path.mkdir(parents=True, exist_ok=True)
        zg = path / ".zgroup"
        if not zg.exists():
            zg.write_text(json.dumps({"zarr_format": 2}))
        return Group(path, writable=True)

    def require_group(self, name: str, overwrite: bool = False) -> "Group":
        assert self._writable
        return Group.create(self.path / name, overwrite=overwrite)

    def array(self, name: str, data, chunks=None, compressor="zlib",
              overwrite: bool = True, **_ignored) -> Array:
        """Write a numpy array as a zarr v2 array.

        compressor: None (raw), 'zlib', 'blosc' (zstd+bitshuffle, the
        reference's format), or a full compressor-metadata dict."""
        assert self._writable
        data = np.asarray(data)
        apath = self.path / name
        if apath.exists():
            if not overwrite:
                raise FileExistsError(apath)
            shutil.rmtree(apath)
        apath.mkdir(parents=True)
        if chunks is None or int(np.prod(chunks) if chunks else 0) == 0:
            chunks = tuple(max(1, s) for s in data.shape) or (1,)
        chunks = tuple(int(c) for c in chunks)
        if isinstance(compressor, dict):
            comp_meta = compressor
        elif compressor == "zlib":
            comp_meta = {"id": "zlib", "level": 5}
        elif compressor == "blosc":
            # reference predict.py:77 / eval.py:910 compressor settings
            comp_meta = {"id": "blosc", "cname": "zstd", "clevel": 6,
                         "shuffle": 2, "blocksize": 0}
        else:
            assert compressor is None, f"unknown compressor {compressor!r}"
            comp_meta = None
        if (comp_meta is not None and comp_meta["id"] == "blosc"
                and "blosc" not in _CODECS):
            # blosc needs libblosc or the zstandard package; never lose a
            # long compute run to a missing codec — degrade to zlib (stock
            # zarr readers handle both)
            import warnings
            warnings.warn("blosc codec unavailable (no libblosc/zstandard); "
                          "writing zlib instead", RuntimeWarning)
            comp_meta = {"id": "zlib", "level": 5}
        if comp_meta is not None and comp_meta["id"] not in _CODECS:
            raise ValueError(f"unsupported compressor {comp_meta['id']!r}")
        meta = {
            "zarr_format": 2,
            "shape": list(data.shape),
            "chunks": list(chunks),
            "dtype": _dtype_to_str(data.dtype),
            "compressor": comp_meta,
            "fill_value": None if data.dtype.kind in "SU" else 0,
            "order": "C",
            "filters": None,
        }
        (apath / ".zarray").write_text(json.dumps(meta))
        if data.size:
            grid = [-(-s // c) for s, c in zip(data.shape, chunks)]
            if not grid:
                grid = [1]
            for cidx in np.ndindex(*grid):
                sel = tuple(
                    slice(i * c, min((i + 1) * c, s))
                    for i, c, s in zip(cidx, chunks, data.shape))
                chunk = np.zeros(chunks, data.dtype)
                csel = tuple(slice(0, sl.stop - sl.start) for sl in sel)
                chunk[csel] = data[sel]
                buf = chunk.tobytes()
                if comp_meta is not None:
                    cfg = dict(comp_meta, _typesize=data.dtype.itemsize)
                    buf = _CODECS[comp_meta["id"]][0](buf, cfg)
                (apath / ".".join(map(str, cidx))).write_bytes(buf)
        return Array(apath, writable=True)

    def __setitem__(self, name: str, value):
        """Scalar / small-array convenience (zarr root[key] = value)."""
        self.array(name, np.asarray(value), compressor=None)

    # -- access --------------------------------------------------------
    def _child(self, name: str):
        p = self.path / name
        if (p / ".zarray").exists():
            return Array(p, self._writable)
        if (p / ".zgroup").exists():
            return Group(p, self._writable)
        raise KeyError(name)

    def __getitem__(self, name: str):
        node = self
        for part in name.split("/"):
            node = node._child(part)
        return node

    def __contains__(self, name: str) -> bool:
        try:
            self[name]
            return True
        except KeyError:
            return False

    def groups(self) -> Iterator[Tuple[str, "Group"]]:
        for p in sorted(self.path.iterdir()):
            if p.is_dir() and (p / ".zgroup").exists():
                yield p.name, Group(p, self._writable)

    def arrays(self) -> Iterator[Tuple[str, Array]]:
        for p in sorted(self.path.iterdir()):
            if p.is_dir() and (p / ".zarray").exists():
                yield p.name, Array(p, self._writable)

    def items(self):
        yield from self.groups()
        yield from self.arrays()

    def keys(self):
        for name, _ in self.items():
            yield name

    def tree(self) -> str:
        lines = [self.path.name or "/"]
        for name, node in self.items():
            suffix = (f" {node.shape} {node.dtype}"
                      if isinstance(node, Array) else "/")
            lines.append(f" ├── {name}{suffix}")
        return "\n".join(lines)


def open(path, mode: str = "r") -> Group:  # noqa: A001 (zarr API parity)
    path = pathlib.Path(path).expanduser()
    if mode == "r":
        if not (path / ".zgroup").exists():
            raise FileNotFoundError(f"not a zarr group: {path}")
        return Group(path, writable=False)
    if mode in ("a", "r+"):
        if (path / ".zgroup").exists():
            return Group(path, writable=True)
        if mode == "r+":
            raise FileNotFoundError(path)
        return Group.create(path)
    if mode == "w":
        return Group.create(path, overwrite=True)
    raise ValueError(f"invalid mode {mode!r}")


try:
    from garmentnets_tpu_torch.data import blosc_codec as _blosc

    if _blosc.available():
        register_codec("blosc", _blosc.zarr_encode, _blosc.zarr_decode)
except ImportError:  # pragma: no cover - blosc lib and zstandard both absent
    pass


def copy(src, dst_group: Group, name: str, if_exists: str = "replace"):
    """Recursive copy of a group/array into dst (zarr.copy parity subset)."""
    if isinstance(src, Array):
        dst_group.array(name, src[:], chunks=src.chunks)
        return
    sub = dst_group.require_group(name)
    sub.attrs.put(src.attrs.asdict())
    for child_name, child in src.items():
        copy(child, sub, child_name, if_exists=if_exists)
