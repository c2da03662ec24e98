"""Typed Monte Carlo result accumulators and their containers.

Behavioral counterpart of the reference ``pyphysim/simulations/results.py``:
  * :class:`Result` — one mergeable statistic with four accumulation
    semantics (SUMTYPE / RATIOTYPE / MISCTYPE / CHOICETYPE), running sum and
    squared-sum for mean/variance/confidence intervals
    (results.py:128-786),
  * :class:`SimulationResults` — a named dict of ``List[Result]`` (one entry
    per parameter variation) with merge/append, persistence and pandas
    export (results.py:795-1627),
  * :func:`combine_simulation_results` — merge results files over unioned
    parameter grids (results.py:51-122).

These containers are host-side orchestration, a numpy-only copy of
``pyphysim_tpu/simulations/results.py`` with the same JSON file format: a
results ``.json`` written by either package loads in the other. The runner
feeds whole chunks of per-repetition counters in via
:meth:`Result.update_batch`, so per-repetition Python overhead never
appears on the hot path.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..utils import serialize
from ..utils.misc import calc_confidence_interval

__all__ = ["Result", "SimulationResults", "combine_simulation_results"]


class Result(serialize.JsonSerializable):
    """A single mergeable simulation statistic.

    Update semantics by type:
      * SUMTYPE:    ``update(v)`` adds ``v``.
      * RATIOTYPE:  ``update(num, den)`` accumulates a ratio as exact
        integer-ish numerator/denominator (e.g. bit errors / bits).
      * MISCTYPE:   ``update(v)`` replaces the stored value.
      * CHOICETYPE: ``update(i)`` increments histogram bin ``i``.

    Every update also feeds a running sum and squared sum of the
    *per-update result* so mean/variance/confidence intervals are free.

    Example (mirrors the reference doctest at results.py:177-218):

    >>> ber = Result.create("ber", Result.RATIOTYPE, 3, 100)
    >>> ber.update(7, 100)
    >>> ber.get_result()
    0.05
    >>> other = Result.create("ber", Result.RATIOTYPE, 10, 800)
    >>> ber.merge(other)
    >>> ber.get_result()
    0.02
    >>> errors = Result.create("errors", Result.SUMTYPE, 5)
    >>> errors.update(8)
    >>> errors.get_result()
    13
    >>> hist = Result("sel", Result.CHOICETYPE, choice_num=3)
    >>> hist.update(0); hist.update(2); hist.update(2)
    >>> hist.get_result().round(4)
    array([0.3333, 0.    , 0.6667])
    """

    (SUMTYPE, RATIOTYPE, MISCTYPE, CHOICETYPE) = range(4)
    _all_types_names = {
        SUMTYPE: "SUMTYPE",
        RATIOTYPE: "RATIOTYPE",
        MISCTYPE: "MISCTYPE",
        CHOICETYPE: "CHOICETYPE",
    }

    def __init__(self, name: str, update_type_code: int,
                 accumulate_values: bool = False,
                 choice_num: Optional[int] = None) -> None:
        if update_type_code not in self._all_types_names:
            raise ValueError(f"Invalid update type: {update_type_code}")
        self.name = name
        self._update_type_code = update_type_code
        self._value: Any = 0
        self._total: Any = 0
        self._result_sum = 0.0
        self._result_squared_sum = 0.0
        self.num_updates = 0
        if update_type_code == Result.CHOICETYPE:
            if not isinstance(choice_num, (int, np.integer)):
                raise RuntimeError(
                    "'choice_num' must be an integer for CHOICETYPE Results")
            self._value = np.zeros(int(choice_num), dtype=int)
        self._accumulate_values_bool = bool(accumulate_values)
        self._value_list: List[Any] = []
        self._total_list: List[Any] = []

    # -- construction ------------------------------------------------------

    @staticmethod
    def create(name: str, update_type: int, value: Any, total: Any = 0,
               accumulate_values: bool = False) -> "Result":
        """Create and immediately update a Result."""
        if update_type == Result.CHOICETYPE:
            if total == 0:
                raise RuntimeError(
                    "CHOICETYPE Result.create requires 'total' (the number "
                    "of choices)")
            r = Result(name, update_type, accumulate_values,
                       choice_num=total)
            r.update(value)
        else:
            r = Result(name, update_type, accumulate_values)
            r.update(value, total)
        return r

    # -- properties --------------------------------------------------------

    @property
    def accumulate_values_bool(self) -> bool:
        return self._accumulate_values_bool

    @property
    def type_name(self) -> str:
        return self._all_types_names[self._update_type_code]

    @property
    def type_code(self) -> int:
        return self._update_type_code

    def __repr__(self) -> str:
        if self._update_type_code == Result.RATIOTYPE:
            if self._total != 0:
                return (f"Result -> {self.name}: {self._value}/"
                        f"{self._total} -> {self._value / self._total}")
            return f"Result -> {self.name}: {self._value}/{self._total} -> NaN"
        return f"Result -> {self.name}: {self.get_result()}"

    def __eq__(self, other: object) -> bool:
        """Equality ignoring ``num_updates`` (parity with the reference)."""
        if self is other:
            return True
        if not isinstance(other, Result):
            return False
        if (self.name != other.name
                or self._update_type_code != other._update_type_code
                or self._accumulate_values_bool != other._accumulate_values_bool
                or self._result_sum != other._result_sum
                or self._result_squared_sum != other._result_squared_sum
                or self._total != other._total
                or self._value_list != other._value_list
                or self._total_list != other._total_list):
            return False
        if self._update_type_code == Result.CHOICETYPE:
            return bool(np.array_equal(self._value, other._value))
        return bool(self._value == other._value)

    def __ne__(self, other: object) -> bool:
        return not self.__eq__(other)

    # -- updates -----------------------------------------------------------

    def update(self, value: Any, total: Optional[Any] = None) -> None:
        """Single-sample update (see class docstring for semantics)."""
        t = self._update_type_code
        self.num_updates += 1
        if t == Result.SUMTYPE:
            self._value += value
            self._result_sum += value
            self._result_squared_sum += value ** 2
            if self._accumulate_values_bool:
                self._value_list.append(value)
        elif t == Result.RATIOTYPE:
            if total is None:
                raise ValueError(
                    "RATIOTYPE Result.update requires both value and total")
            self._value += value
            self._total += total
            r = value / total
            self._result_sum += r
            self._result_squared_sum += r ** 2
            if self._accumulate_values_bool:
                self._value_list.append(value)
                self._total_list.append(total)
        elif t == Result.MISCTYPE:
            self._value = value
            if self._accumulate_values_bool:
                self._value_list.append(value)
        else:  # CHOICETYPE
            idx = int(value)
            self._value[idx] += 1
            self._total += 1
            if self._accumulate_values_bool:
                self._value_list.append(idx)

    def update_batch(self, values: np.ndarray,
                     totals: Optional[np.ndarray] = None) -> None:
        """Bulk update from a device-produced batch of per-repetition
        samples (one host call per chunk instead of one per
        repetition).

        ``values``/``totals`` are 1-D arrays with one entry per repetition.
        For CHOICETYPE, ``values`` holds choice indices.
        """
        values = np.asarray(values)
        n = values.shape[0]
        t = self._update_type_code
        if t == Result.SUMTYPE:
            self._value += values.sum()
            self._result_sum += float(values.sum())
            self._result_squared_sum += float((values.astype(float)**2).sum())
            if self._accumulate_values_bool:
                self._value_list.extend(values.tolist())
        elif t == Result.RATIOTYPE:
            if totals is None:
                raise ValueError("RATIOTYPE update_batch requires totals")
            totals = np.asarray(totals)
            self._value += values.sum()
            self._total += totals.sum()
            # Zero-total rows (masked/empty repetitions emitted by a
            # device kernel) contribute nothing to the per-update ratio
            # statistics: a 0/0 division would silently poison the
            # running mean/variance/CI with NaN. They still count into
            # the aggregate numerator/denominator above (adding v and 0)
            # but are excluded from num_updates so the mean stays the
            # mean of *measured* repetitions.
            nz = totals != 0
            r = values[nz] / totals[nz]
            self._result_sum += float(r.sum())
            self._result_squared_sum += float((r ** 2).sum())
            n = int(np.count_nonzero(nz))
            if self._accumulate_values_bool:
                self._value_list.extend(values[nz].tolist())
                self._total_list.extend(totals[nz].tolist())
        elif t == Result.MISCTYPE:
            self._value = values[-1]
            if self._accumulate_values_bool:
                self._value_list.extend(values.tolist())
        else:  # CHOICETYPE: values are indices
            binc = np.bincount(values.astype(int),
                               minlength=self._value.shape[0])
            self._value += binc
            self._total += n
            if self._accumulate_values_bool:
                self._value_list.extend(values.tolist())
        self.num_updates += int(n)

    def merge(self, other: "Result") -> None:
        """Merge another Result (the cross-repetition / cross-worker
        reducer). MISCTYPE replaces; other types add."""
        if not isinstance(other, Result) or \
                self._update_type_code != other._update_type_code or \
                self.name != other.name:
            raise ValueError(
                "Can only merge Result objects with the same name and type")
        if self._accumulate_values_bool:
            if not other._accumulate_values_bool:
                raise ValueError(
                    "The merged Result must also accumulate values")
            self._value_list.extend(other._value_list)
            self._total_list.extend(other._total_list)
        if self._update_type_code == Result.MISCTYPE:
            self.num_updates = other.num_updates
            self._value = other._value
            self._total = other._total
            self._result_sum = other._result_sum
            self._result_squared_sum = other._result_squared_sum
        else:
            self.num_updates += other.num_updates
            self._value = self._value + other._value
            self._total = self._total + other._total
            self._result_sum += other._result_sum
            self._result_squared_sum += other._result_squared_sum

    # -- readers -----------------------------------------------------------

    def get_result(self) -> Any:
        if self.num_updates == 0:
            return "Nothing yet"
        if self._update_type_code in (Result.RATIOTYPE, Result.CHOICETYPE):
            return self._value / self._total
        return self._value

    def get_result_accumulated_values(self) -> List[Any]:
        return self._value_list

    def get_result_accumulated_totals(self) -> List[Any]:
        return self._total_list

    def get_result_mean(self) -> float:
        return self._result_sum / self.num_updates

    def get_result_var(self) -> float:
        return (self._result_squared_sum / self.num_updates -
                self.get_result_mean() ** 2)

    def get_confidence_interval(self, P: float = 95.0) -> Tuple[float, float]:
        if self._update_type_code == Result.MISCTYPE:
            raise RuntimeError(
                "get_confidence_interval is not valid for MISCTYPE Results")
        return calc_confidence_interval(
            self.get_result_mean(),
            float(np.sqrt(max(self.get_result_var(), 0.0))),
            self.num_updates, P)

    # -- (de)serialization -------------------------------------------------

    def _to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "update_type_code": self._update_type_code,
            "value": self._value,
            "total": self._total,
            "result_sum": self._result_sum,
            "result_squared_sum": self._result_squared_sum,
            "num_updates": self.num_updates,
            "accumulate_values_bool": self._accumulate_values_bool,
            "value_list": self._value_list,
            "total_list": self._total_list,
        }

    @classmethod
    def _from_dict(cls, d: Dict[str, Any]) -> "Result":
        choice = d["update_type_code"] == Result.CHOICETYPE
        r = Result(d["name"], d["update_type_code"],
                   d["accumulate_values_bool"],
                   choice_num=(len(d["value"]) if choice else None))
        r._value = (np.asarray(d["value"], dtype=int) if choice
                    else d["value"])
        r._total = d["total"]
        r._result_sum = d["result_sum"]
        r._result_squared_sum = d["result_squared_sum"]
        r.num_updates = d["num_updates"]
        r._value_list = list(d.get("value_list", []))
        r._total_list = list(d.get("total_list", []))
        return r


class SimulationResults(serialize.JsonSerializable):
    """Container of simulation results: ``name -> List[Result]`` with one
    list entry per (unpacked) parameter variation."""

    def __init__(self) -> None:
        self._results: Dict[str, List[Result]] = {}
        from .parameters import SimulationParameters
        self._params = SimulationParameters()
        # Repetition count stored in partial-results checkpoints
        # (parity: runner.py:966 'current_sim_results.current_rep').
        self.current_rep = 0
        # Repetitions actually run per variation, set by the runner at
        # simulation end (parity: results.py:884, runner.py:1628-1630).
        self.runned_reps: Optional[List[int]] = None

    # -- params ------------------------------------------------------------

    @property
    def params(self):
        return self._params

    def set_parameters(self, params) -> None:
        from .parameters import SimulationParameters
        if not isinstance(params, SimulationParameters):
            raise ValueError(
                "params must be a SimulationParameters object")
        self._params = params

    # -- adding results ----------------------------------------------------

    def add_result(self, result: Result) -> None:
        """Set (replacing) the current-variation result list for
        ``result.name`` to ``[result]``."""
        self._results[result.name] = [result]

    def add_new_result(self, name: str, update_type: int, value: Any,
                       total: Any = 0) -> None:
        self.add_result(Result.create(name, update_type, value, total))

    def append_result(self, result: Result) -> None:
        """Append a new variation entry for ``result.name``."""
        if result.name in self._results:
            self._results[result.name].append(result)
        else:
            self._results[result.name] = [result]

    def append_all_results(self, other: "SimulationResults") -> None:
        """Append every result of ``other`` (used across variations)."""
        for name in other.get_result_names():
            for r in other[name]:
                self.append_result(r)

    def merge_all_results(self, other: "SimulationResults") -> None:
        """Merge the LAST variation entry of each result with the one in
        ``other`` (used across repetitions of the same variation)."""
        if len(self) == 0:
            for name in other.get_result_names():
                self._results[name] = list(other[name])
            return
        mine = set(self.get_result_names())
        theirs = set(other.get_result_names())
        # bookkeeping results may exist on only one side (e.g. a resumed
        # checkpoint carries num_skipped_reps/elapsed_time before the new
        # chunk produced them — parity with results.py:1136-1159 which
        # special-cases exactly this). Symmetrically, when ONLY
        # bookkeeping has accumulated so far (a skip merged before the
        # first accepted repetition), the first real results adopt
        # their names instead of raising.
        bookkeeping = {"num_skipped_reps", "elapsed_time"}
        real_mine = mine - bookkeeping
        if ((mine - theirs) - bookkeeping or
                (real_mine and (theirs - mine) - bookkeeping)):
            raise RuntimeError(
                "Cannot merge SimulationResults with different result names")
        for name in theirs:
            if name in mine:
                self._results[name][-1].merge(other[name][-1])
            else:
                self._results[name] = list(other[name])

    # -- readers -----------------------------------------------------------

    def get_result_names(self) -> List[str]:
        return list(self._results.keys())

    def get_result_values_list(self, result_name: str,
                               fixed_params=None) -> List[Any]:
        """List of ``get_result()`` across variations, optionally sliced by
        fixed parameter values via ``params.get_pack_indexes``."""
        entries = self._results[result_name]
        if fixed_params:
            idx = self._params.get_pack_indexes(fixed_params)
            return [entries[i].get_result() for i in np.atleast_1d(idx)]
        return [r.get_result() for r in entries]

    def get_result_values_confidence_intervals(
            self, result_name: str, P: float = 95.0,
            fixed_params=None) -> List[Tuple[float, float]]:
        entries = self._results[result_name]
        if fixed_params:
            idx = self._params.get_pack_indexes(fixed_params)
            entries = [entries[i] for i in np.atleast_1d(idx)]
        return [r.get_confidence_interval(P) for r in entries]

    def __getitem__(self, key: str) -> List[Result]:
        return self._results[key]

    def __contains__(self, key: str) -> bool:
        return key in self._results

    def __len__(self) -> int:
        return len(self._results)

    def __iter__(self) -> Iterator[List[Result]]:
        return iter(self._results.values())

    def __repr__(self) -> str:
        return f"SimulationResults: {sorted(self.get_result_names())}"

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, SimulationResults):
            return False
        return (self._params == other._params
                and self._results == other._results)

    def __ne__(self, other: object) -> bool:
        return not self.__eq__(other)

    # -- persistence -------------------------------------------------------

    def get_filename_with_replaced_params(self, filename: str) -> str:
        """Replace ``{param}`` placeholders with (range-compacted) values."""
        from ..utils.misc import replace_dict_values
        return replace_dict_values(filename, self._params.parameters,
                                   filename_mode=True)

    def save_to_file(self, filename: str) -> str:
        """Save to pickle (default) or JSON if the extension is .json.
        ``{param}`` placeholders in the name are replaced. Returns the
        actual filename used."""
        filename = self.get_filename_with_replaced_params(filename)
        base, ext = os.path.splitext(filename)
        if ext == "":
            filename = base + ".pickle"
            ext = ".pickle"
        if ext == ".json":
            with open(filename, "w") as f:
                f.write(self.to_json())
        else:
            with open(filename, "wb") as f:
                pickle.dump(self, f)
        return filename

    @staticmethod
    def load_from_file(filename: str) -> "SimulationResults":
        if os.path.splitext(filename)[1] == ".json":
            with open(filename) as f:
                return SimulationResults.from_json(f.read())
        with open(filename, "rb") as f:
            return pickle.load(f)

    def _to_dict(self) -> Dict[str, Any]:
        return {
            "results": {
                name: [r._to_dict() for r in lst]
                for name, lst in self._results.items()
            },
            "params": self._params._to_dict(),
            "current_rep": self.current_rep,
            "runned_reps": self.runned_reps,
        }

    @classmethod
    def _from_dict(cls, d: Dict[str, Any]) -> "SimulationResults":
        from .parameters import SimulationParameters
        obj = cls()
        obj._results = {
            name: [Result._from_dict(rd) for rd in lst]
            for name, lst in d["results"].items()
        }
        obj._params = SimulationParameters._from_dict(d["params"])
        obj.current_rep = d.get("current_rep", 0)
        obj.runned_reps = d.get("runned_reps")
        return obj

    # -- pandas ------------------------------------------------------------

    def to_dataframe(self):
        """One row per variation: unpacked parameter values + result
        values (+ fixed parameters)."""
        import pandas as pd
        data = {}
        unpacked = self._params.get_unpacked_params_list()
        for name in self._params.parameters:
            data[name] = [p[name] for p in unpacked]
        for rname in self.get_result_names():
            lst = self._results[rname]
            if len(lst) == len(unpacked):
                data[rname] = [r.get_result() for r in lst]
        if self.runned_reps is not None and \
                len(self.runned_reps) == len(unpacked):
            data["runned_reps"] = list(self.runned_reps)
        return pd.DataFrame(data)


def combine_simulation_results(res1: SimulationResults,
                               res2: SimulationResults) -> SimulationResults:
    """Combine two results objects over the UNION of their parameter grids
    (results.py:51-122): every variation must come from exactly one input
    (or be equal in both)."""
    from .parameters import combine_simulation_parameters
    union = combine_simulation_parameters(res1.params, res2.params)
    if set(res1.get_result_names()) != set(res2.get_result_names()):
        raise RuntimeError(
            "Both SimulationResults objects must have the same result names")
    out = SimulationResults()
    out.set_parameters(union)
    for name in res1.get_result_names():
        for v in union.get_unpacked_params_list():
            added = False
            for source in (res1, res2):
                for i, pv in enumerate(source.params.get_unpacked_params_list()):
                    if _params_match(v, pv, union):
                        out.append_result(source[name][i])
                        added = True
                        break
                if added:
                    break
            if not added:
                raise RuntimeError(
                    f"No source results found for variation {v}")
    return out


def _params_match(v1, v2, union) -> bool:
    for p in union.unpacked_parameters:
        a, b = v1[p], v2[p]
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            if not np.array_equal(a, b):
                return False
        elif a != b:
            return False
    return True
