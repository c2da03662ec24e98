"""JSON (de)serialization for numpy arrays / sets, plus a mixin.

Parity with the reference's ``pyphysim/util/serialize.py:19-208``
(``NumpyOrSetEncoder`` + ``JsonSerializable``): numpy arrays round-trip
through JSON as ``{"_type": "np.ndarray", "data": ..., "dtype": ...}``,
sets as ``{"_type": "set", "data": [...]}``. Complex arrays are stored as
interleaved real/imag pairs (the reference never serialized complex arrays;
we need it for constellation tables and channel snapshots)."""

from __future__ import annotations

import json
from typing import Any

import numpy as np

__all__ = ["NumpyOrSetEncoder", "json_numpy_or_set_obj_hook",
           "JsonSerializable", "dumps", "loads"]


class NumpyOrSetEncoder(json.JSONEncoder):
    """JSON encoder understanding numpy arrays, numpy scalars and sets."""

    def default(self, o: Any):
        if isinstance(o, np.ndarray):
            if np.iscomplexobj(o):
                return {
                    "_type": "np.ndarray",
                    "dtype": str(o.dtype),
                    "shape": list(o.shape),
                    "data": np.stack([o.real, o.imag], axis=-1).tolist(),
                }
            return {
                "_type": "np.ndarray",
                "dtype": str(o.dtype),
                "shape": list(o.shape),
                "data": o.tolist(),
            }
        if isinstance(o, (np.integer,)):
            return int(o)
        if isinstance(o, (np.floating,)):
            return float(o)
        if isinstance(o, (np.complexfloating,)):
            return {"_type": "complex", "data": [float(o.real), float(o.imag)]}
        if isinstance(o, set):
            return {"_type": "set", "data": sorted(o, key=repr)}
        return json.JSONEncoder.default(self, o)


def json_numpy_or_set_obj_hook(dct):
    """Object hook reversing :class:`NumpyOrSetEncoder`."""
    if isinstance(dct, dict) and "_type" in dct:
        t = dct["_type"]
        if t == "np.ndarray":
            dtype = np.dtype(dct["dtype"])
            if dtype.kind == "c":
                arr = np.asarray(dct["data"], dtype=float)
                out = arr[..., 0] + 1j * arr[..., 1]
                return out.astype(dtype).reshape(dct["shape"])
            return np.asarray(dct["data"], dtype=dtype).reshape(dct["shape"])
        if t == "set":
            return set(dct["data"])
        if t == "complex":
            return complex(dct["data"][0], dct["data"][1])
    return dct


def dumps(obj: Any, **kw) -> str:
    """json.dumps with numpy/set support."""
    return json.dumps(obj, cls=NumpyOrSetEncoder, **kw)


def loads(s: str, **kw) -> Any:
    """json.loads with numpy/set support."""
    return json.loads(s, object_hook=json_numpy_or_set_obj_hook, **kw)


class JsonSerializable:
    """Mixin adding to_json/from_json built on `_to_dict`/`_from_dict`.

    Subclasses implement ``_to_dict()`` returning a plain dict and the
    classmethod ``_from_dict(d)`` constructing an instance.
    """

    def _to_dict(self):  # pragma: no cover - abstract
        raise NotImplementedError

    @classmethod
    def _from_dict(cls, d):  # pragma: no cover - abstract
        raise NotImplementedError

    def to_dict(self):
        """Public dict form (parity: serialize.py:135-145)."""
        return self._to_dict()

    @classmethod
    def from_dict(cls, d):
        """Construct from a dict (parity: serialize.py:165-179)."""
        return cls._from_dict(d)

    def to_json(self, **kw) -> str:
        return dumps(self._to_dict(), **kw)

    @classmethod
    def from_json(cls, s: str):
        return cls._from_dict(loads(s))
