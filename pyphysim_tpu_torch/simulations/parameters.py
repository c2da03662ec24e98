"""Simulation parameter container with "unpack" (cartesian sweep)
semantics.

Behavioral counterpart of the reference
``pyphysim/simulations/parameters.py:113-1011``:
  * parameters marked with :meth:`set_unpack_parameter` define a cartesian
    product of variations; :meth:`get_unpacked_params_list` materializes
    them (sorted-by-name axis order, itertools.product semantics),
  * each variation knows its ``unpack_index`` and original object,
  * :meth:`get_pack_indexes` slices the flat variation list by fixing all
    unpacked parameters but one,
  * equality ignores ``rep_max`` (used by checkpoint-resume validation),
  * config-file loading lives in :mod:`.configobjvalidation` (range
    expressions like ``0:5:21`` / ``[0 5 10:2:20]``).

A numpy-only copy of ``pyphysim_tpu/simulations/parameters.py``: this
layer is host-side orchestration, identical in both packages, and the two
share one JSON form (``to_json`` / ``from_json``).
"""

from __future__ import annotations

import itertools
import pickle
from typing import Any, Dict, List, Optional, Set

import numpy as np

from ..utils import serialize

__all__ = ["SimulationParameters", "combine_simulation_parameters"]


class SimulationParameters(serialize.JsonSerializable):
    """Container of named simulation parameters with sweep support.

    Parameters marked with :meth:`set_unpack_parameter` become sweep axes;
    :meth:`get_unpacked_params_list` yields the cartesian product, each
    variation knowing its ``unpack_index``
    (parity: parameters.py:113-754).

    >>> import numpy as np
    >>> p = SimulationParameters.create({"snr": np.array([0, 5, 10]),
    ...                                  "m": 4})
    >>> p.set_unpack_parameter("snr")
    >>> p.get_num_unpacked_variations()
    3
    >>> variations = p.get_unpacked_params_list()
    >>> int(variations[1]["snr"]), variations[1]["m"]
    (5, 4)
    >>> p.get_pack_indexes({"m": 4})    # all variations match m=4
    array([0, 1, 2])
    """

    def __init__(self) -> None:
        self.parameters: Dict[str, Any] = {}
        self._unpacked_parameters_set: Set[str] = set()
        self._unpack_index = -1
        self._original_sim_params: Optional["SimulationParameters"] = None

    # -- construction ------------------------------------------------------

    @staticmethod
    def create(params_dict: Dict[str, Any]) -> "SimulationParameters":
        sp = SimulationParameters()
        sp.parameters = dict(params_dict)
        return sp

    @classmethod
    def _create_variation(cls, params_dict: Dict[str, Any],
                          unpack_index: int,
                          original: "SimulationParameters"):
        sp = cls.create(params_dict)
        sp._unpack_index = unpack_index
        sp._original_sim_params = original
        return sp

    def add(self, name: str, value: Any) -> None:
        self.parameters[name] = value

    def remove(self, name: str) -> None:
        if name in self._unpacked_parameters_set:
            self._unpacked_parameters_set.remove(name)
        del self.parameters[name]

    def set_unpack_parameter(self, name: str,
                             unpack_bool: bool = True) -> None:
        """Mark/unmark a (iterable) parameter as a sweep axis."""
        if name not in self.parameters:
            raise ValueError(f"Unknown parameter: {name}")
        if unpack_bool:
            if not isinstance(self.parameters[name],
                              (list, tuple, np.ndarray)):
                raise ValueError(
                    f"Parameter {name} is not iterable and cannot be "
                    "marked for unpacking")
            self._unpacked_parameters_set.add(name)
        else:
            self._unpacked_parameters_set.discard(name)

    # -- basic container protocol -----------------------------------------

    def __getitem__(self, name: str) -> Any:
        return self.parameters[name]

    def __setitem__(self, name: str, value: Any) -> None:
        self.parameters[name] = value

    def __contains__(self, name: str) -> bool:
        return name in self.parameters

    def __len__(self) -> int:
        return len(self.parameters)

    def __iter__(self):
        return iter(self.parameters)

    def __repr__(self) -> str:
        items = []
        for k, v in self.parameters.items():
            star = "*" if k in self._unpacked_parameters_set else ""
            items.append(f"'{k}{star}': {v}")
        return "{%s}" % ", ".join(items)

    def __eq__(self, other: object) -> bool:
        """Equality ignoring 'rep_max' (checkpoint-resume validation —
        parity with parameters.py:433-495)."""
        if self is other:
            return True
        if not isinstance(other, SimulationParameters):
            return False
        if self._unpacked_parameters_set != other._unpacked_parameters_set:
            return False
        if self._unpack_index != other._unpack_index:
            return False
        if set(self.parameters) != set(other.parameters):
            return False
        for key, v in self.parameters.items():
            if key == "rep_max":
                continue
            ov = other.parameters[key]
            if isinstance(v, np.ndarray) or isinstance(ov, np.ndarray):
                if not np.array_equal(v, ov):
                    return False
            elif np.any(v != ov):
                return False
        return True

    def __ne__(self, other: object) -> bool:
        return not self.__eq__(other)

    # -- unpack machinery --------------------------------------------------

    @property
    def unpack_index(self) -> int:
        """Index of this variation in the unpacked list (-1 if this is not
        a variation)."""
        return self._unpack_index

    @property
    def unpacked_parameters(self) -> List[str]:
        """Sorted names of the parameters marked for unpacking."""
        return sorted(self._unpacked_parameters_set)

    @property
    def fixed_parameters(self) -> List[str]:
        return sorted(set(self.parameters) - self._unpacked_parameters_set)

    def get_num_unpacked_variations(self) -> int:
        if not self._unpacked_parameters_set:
            if self._original_sim_params is not None:
                return self._original_sim_params.get_num_unpacked_variations()
            return 1
        n = 1
        for name in self._unpacked_parameters_set:
            n *= len(self.parameters[name])
        return n

    def get_unpacked_params_list(self) -> List["SimulationParameters"]:
        """All variations (cartesian product over sorted unpacked names)."""
        if not self._unpacked_parameters_set:
            return [self]
        keys = self.unpacked_parameters
        combos = itertools.product(*(self.parameters[k] for k in keys))
        fixed = {k: v for k, v in self.parameters.items()
                 if k not in self._unpacked_parameters_set}
        out = []
        for i, combo in enumerate(combos):
            d = dict(fixed)
            d.update(dict(zip(keys, combo)))
            out.append(SimulationParameters._create_variation(d, i, self))
        return out

    def get_pack_indexes(self, fixed_params_dict=None) -> np.ndarray:
        """Indexes into the unpacked list where all given parameters have
        the given fixed values (the remaining axis varies)."""
        if fixed_params_dict is None:
            fixed_params_dict = {}
        names = self.unpacked_parameters
        dims = [len(self.parameters[n]) for n in names]
        grid = np.arange(int(np.prod(dims))).reshape(dims)
        slicer = []
        for n in names:
            if n in fixed_params_dict:
                values = list(self.parameters[n])
                slicer.append(values.index(fixed_params_dict[n]))
            else:
                slicer.append(slice(None))
        return np.atleast_1d(grid[tuple(slicer)]).ravel()

    def to_grid(self, *names: str):
        """Meshgrid of the named sweep axes as dense float
        arrays of shape ``(num_variations,)`` flat in unpack order —
        directly vmappable."""
        axes = self.unpacked_parameters
        grids = np.meshgrid(*(np.asarray(self.parameters[n]) for n in axes),
                            indexing="ij")
        flat = {n: g.reshape(-1) for n, g in zip(axes, grids)}
        return tuple(flat[n] for n in names)

    # -- persistence -------------------------------------------------------

    def save_to_pickled_file(self, filename: str) -> None:
        with open(filename, "wb") as f:
            pickle.dump(self, f)

    @staticmethod
    def load_from_pickled_file(filename: str) -> "SimulationParameters":
        with open(filename, "rb") as f:
            return pickle.load(f)

    @staticmethod
    def load_from_config_file(filename: str, spec=None,
                              save_parsed_file: bool = False):
        """Load parameters from an INI-style config file with range
        expressions; see :mod:`.configobjvalidation`."""
        from .configobjvalidation import load_config
        return load_config(filename, spec, save_parsed_file)

    def _to_dict(self) -> Dict[str, Any]:
        return {
            "parameters": dict(self.parameters),
            "unpacked_parameters": sorted(self._unpacked_parameters_set),
            "unpack_index": self._unpack_index,
        }

    @classmethod
    def _from_dict(cls, d: Dict[str, Any]) -> "SimulationParameters":
        sp = cls.create(d["parameters"])
        sp._unpacked_parameters_set = set(d.get("unpacked_parameters", []))
        sp._unpack_index = d.get("unpack_index", -1)
        return sp

    def to_dataframe(self):
        import pandas as pd
        unpacked = self.get_unpacked_params_list()
        data = {name: [p[name] for p in unpacked]
                for name in self.parameters}
        return pd.DataFrame(data)


def combine_simulation_parameters(
        params1: SimulationParameters,
        params2: SimulationParameters) -> SimulationParameters:
    """Union of two parameter objects that differ only in the VALUES of
    their unpacked parameters (parameters.py:55-107)."""
    if set(params1.parameters) != set(params2.parameters):
        raise RuntimeError(
            "Both SimulationParameters objects must have the same "
            "parameters")
    if set(params1.unpacked_parameters) != set(params2.unpacked_parameters):
        raise RuntimeError(
            "Both SimulationParameters objects must have the same "
            "unpacked parameters")
    for name in params1.fixed_parameters:
        v1, v2 = params1[name], params2[name]
        eq = (np.array_equal(v1, v2)
              if isinstance(v1, np.ndarray) else v1 == v2)
        if not eq:
            raise RuntimeError(
                "Fixed parameters must have the same value in both "
                "SimulationParameters objects")
    out = SimulationParameters()
    for name in params1.fixed_parameters:
        out.add(name, params1[name])
    for name in params1.unpacked_parameters:
        union = np.union1d(np.asarray(params1[name]),
                           np.asarray(params2[name]))
        out.add(name, union)
        out.set_unpack_parameter(name)
    return out
