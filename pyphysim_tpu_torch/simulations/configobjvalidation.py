"""Config-file parsing and validation with range expressions.

Standalone (dependency-free) counterpart of the reference's
configobj/validate-based machinery
(``pyphysim/simulations/configobjvalidation.py:21-369`` and
``parameters.py:789-940``). The `configobj` package is not available in
this environment, so this module implements the same INI + spec format
directly:

  * config files are INI-style with ``[sections]`` (flattened into one
    parameter namespace, like the reference),
  * a *spec* maps parameter names to validator expressions such as
    ``integer(min=4, max=512, default=4)`` or
    ``real_numpy_array(min=-50, max=100, default=0:5:31)``,
  * range expressions: ``min:max`` -> ``np.arange(min, max)`` and
    ``min:step:max`` -> ``np.arange(min, max, step)`` (numpy
    exclusive-stop semantics, matching configobjvalidation.py:21-50);
    lists mix numbers and ranges: ``[0 5 10:2:20]``,
  * the special key ``unpacked_parameters`` (a string list) marks sweep
    axes.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

__all__ = ["ValidationError", "validate_value", "parse_spec", "parse_ini",
           "load_config", "real_numpy_array_check",
           "integer_numpy_array_check",
           "real_scalar_or_real_numpy_array_check",
           "integer_scalar_or_integer_numpy_array_check"]


class ValidationError(ValueError):
    """Raised when a config value fails validation against its spec."""


# ---------------------------------------------------------------------------
# Range expression parsing (parity: configobjvalidation.py:21-90)
# ---------------------------------------------------------------------------


def _parse_range_expr(value: str, converter: Callable = float) -> np.ndarray:
    try:
        limits = [converter(i) for i in value.split(":")]
        if len(limits) == 2:
            return np.arange(limits[0], limits[1])
        if len(limits) == 3:
            return np.arange(limits[0], limits[2], limits[1])
    except ValidationError:
        raise
    except Exception:
        pass
    raise ValidationError(f"Invalid range expression: {value!r}")


def _tokenize_list(value: Union[str, List[str]]) -> List[str]:
    """Split '[0 5 10:2:20]' / '0,5,10' / list-of-strings into tokens."""
    if isinstance(value, (list, tuple)):
        return [str(v).strip() for v in value]
    s = value.strip()
    if s.startswith("[") and s.endswith("]"):
        s = s[1:-1]
    return [t for t in re.split(r"[\s,]+", s.strip()) if t]


def _numpy_array_check(value, converter, min=None, max=None):  # noqa: A002
    tokens = _tokenize_list(value)
    parts = []
    for tok in tokens:
        if ":" in tok:
            parts.append(np.atleast_1d(_parse_range_expr(tok, converter)))
        else:
            try:
                parts.append(np.atleast_1d(converter(tok)))
            except Exception:
                raise ValidationError(f"Invalid number: {tok!r}")
    out = np.concatenate(parts) if parts else np.array([], dtype=float)
    if min is not None and np.any(out < converter(min)):
        raise ValidationError(f"Value below minimum {min}: {value!r}")
    if max is not None and np.any(out > converter(max)):
        raise ValidationError(f"Value above maximum {max}: {value!r}")
    return out


def real_numpy_array_check(value, min=None, max=None):  # noqa: A002
    """Parse/validate a float array with optional bounds."""
    return _numpy_array_check(value, float, min, max).astype(float)


def integer_numpy_array_check(value, min=None, max=None):  # noqa: A002
    """Parse/validate an int array with optional bounds."""
    return _numpy_array_check(value, int, min, max).astype(int)


def real_scalar_or_real_numpy_array_check(value, min=None, max=None):  # noqa: A002
    arr = real_numpy_array_check(value, min, max)
    return float(arr[0]) if arr.size == 1 else arr


def integer_scalar_or_integer_numpy_array_check(value, min=None, max=None):  # noqa: A002
    arr = integer_numpy_array_check(value, min, max)
    return int(arr[0]) if arr.size == 1 else arr


# ---------------------------------------------------------------------------
# Scalar validators
# ---------------------------------------------------------------------------


def _integer_check(value, min=None, max=None):  # noqa: A002
    try:
        v = int(str(value).strip())
    except Exception:
        raise ValidationError(f"Invalid integer: {value!r}")
    if min is not None and v < int(min):
        raise ValidationError(f"{v} < min {min}")
    if max is not None and v > int(max):
        raise ValidationError(f"{v} > max {max}")
    return v


def _float_check(value, min=None, max=None):  # noqa: A002
    try:
        v = float(str(value).strip())
    except Exception:
        raise ValidationError(f"Invalid float: {value!r}")
    if min is not None and v < float(min):
        raise ValidationError(f"{v} < min {min}")
    if max is not None and v > float(max):
        raise ValidationError(f"{v} > max {max}")
    return v


def _boolean_check(value):
    s = str(value).strip().lower()
    if s in ("1", "true", "yes", "on"):
        return True
    if s in ("0", "false", "no", "off"):
        return False
    raise ValidationError(f"Invalid boolean: {value!r}")


def _string_check(value):
    return str(value).strip().strip('"\'')


def _string_list_check(value):
    if isinstance(value, str):
        # configobj spells list defaults as list('a', 'b'); unwrap it
        s = value.strip()
        if s.startswith("list(") and s.endswith(")"):
            value = s[5:-1]
    return [_string_check(t) for t in _tokenize_list(value)]


def _option_check(value, *options):
    v = _string_check(value)
    if v not in options:
        raise ValidationError(f"{v!r} not in allowed options {options}")
    return v


_VALIDATORS: Dict[str, Callable] = {
    "integer": _integer_check,
    "float": _float_check,
    "boolean": _boolean_check,
    "string": _string_check,
    "string_list": _string_list_check,
    "option": _option_check,
    "real_numpy_array": real_numpy_array_check,
    "integer_numpy_array": integer_numpy_array_check,
    "real_scalar_or_real_numpy_array": real_scalar_or_real_numpy_array_check,
    "integer_scalar_or_integer_numpy_array":
        integer_scalar_or_integer_numpy_array_check,
}

# The reference registers its custom validators under their full function
# names, so spec strings may use either form (configobjvalidation.py:91-369)
_VALIDATORS.update({
    "real_numpy_array_check": real_numpy_array_check,
    "integer_numpy_array_check": integer_numpy_array_check,
    "real_scalar_or_real_numpy_array_check":
        real_scalar_or_real_numpy_array_check,
    "integer_scalar_or_integer_numpy_array_check":
        integer_scalar_or_integer_numpy_array_check,
})


_SPEC_RE = re.compile(r"^\s*(\w+)\s*(?:\((.*)\))?\s*$")


def _split_args(argstr: str) -> List[str]:
    """Split validator arguments on commas not inside brackets/quotes."""
    parts, depth, cur, quote = [], 0, "", None
    for ch in argstr:
        if quote:
            cur += ch
            if ch == quote:
                quote = None
            continue
        if ch in "\"'":
            quote = ch
            cur += ch
        elif ch in "[(":
            depth += 1
            cur += ch
        elif ch in "])":
            depth -= 1
            cur += ch
        elif ch == "," and depth == 0:
            parts.append(cur)
            cur = ""
        else:
            cur += ch
    if cur.strip():
        parts.append(cur)
    return [p.strip() for p in parts]


def parse_spec(spec_str: str):
    """Parse a validator expression like
    ``real_numpy_array(min=0, max=100, default=0:5:31)`` into
    ``(validator_name, args, kwargs)``."""
    m = _SPEC_RE.match(spec_str)
    if not m:
        raise ValidationError(f"Invalid spec: {spec_str!r}")
    name, argstr = m.group(1), m.group(2)
    args: List[str] = []
    kwargs: Dict[str, str] = {}
    if argstr:
        for part in _split_args(argstr):
            if "=" in part:
                k, _, v = part.partition("=")
                kwargs[k.strip()] = v.strip().strip('"\'')
            else:
                args.append(part.strip().strip('"\''))
    if name not in _VALIDATORS:
        raise ValidationError(f"Unknown validator: {name!r}")
    return name, args, kwargs


def validate_value(spec_str: str, raw_value: Optional[str]):
    """Validate ``raw_value`` (or apply the spec default when None)."""
    name, args, kwargs = parse_spec(spec_str)
    default = kwargs.pop("default", None)
    if raw_value is None:
        if default is None:
            raise ValidationError(
                f"Missing value with no default for spec {spec_str!r}")
        if default.startswith("list(") and default.endswith(")"):
            # configobj list-default syntax: default=list('a', 'b')
            inner = default[len("list("):-1]
            default = ",".join(p.strip().strip("\"'")
                               for p in _split_args(inner))
        raw_value = default
    return _VALIDATORS[name](raw_value, *args, **kwargs)


# ---------------------------------------------------------------------------
# INI parsing
# ---------------------------------------------------------------------------


def parse_ini(text: str) -> Dict[str, Dict[str, str]]:
    """Minimal INI parser: sections of ``key = value`` lines; ``#`` and
    ``;`` comments; values kept as raw strings. A leading ("") section
    holds keys that appear before any section header."""
    out: Dict[str, Dict[str, str]] = {"": {}}
    section = ""
    for raw_line in text.splitlines():
        line = raw_line.strip()
        if not line or line.startswith(("#", ";")):
            continue
        if line.startswith("[") and line.endswith("]"):
            section = line.strip("[]").strip()
            out.setdefault(section, {})
            continue
        if "=" in line:
            k, _, v = line.partition("=")
            v = v.split("#")[0].strip() if "#" in v else v.strip()
            out[section][k.strip()] = v
    return out


def load_config(filename: str, spec=None, save_parsed_file: bool = False):
    """Load an INI config file, validate against ``spec`` and return a
    :class:`~pyphysim_tpu_torch.simulations.parameters.SimulationParameters`
    (all sections flattened, parity with parameters.py:789-940).

    ``spec`` may be a string (same INI layout with validator expressions
    as values) or a nested dict. The special ``unpacked_parameters`` key
    (a string list) marks sweep axes. With ``save_parsed_file=True`` the
    config file is rewritten with defaults filled in.
    """
    from .parameters import SimulationParameters

    with open(filename) as f:
        conf = parse_ini(f.read())

    spec_map: Dict[str, Dict[str, str]] = {}
    if isinstance(spec, (list, tuple)):
        # configobj accepts a spec as a list of lines
        # (reference simulate_ia.py:320-341 passes spec.split("\n"))
        spec = "\n".join(str(line) for line in spec)
    if isinstance(spec, str):
        spec_map = parse_ini(spec)
    elif isinstance(spec, dict):
        spec_map = {k: dict(v) for k, v in spec.items()} if any(
            isinstance(v, dict) for v in spec.values()) else {"": dict(spec)}

    params = SimulationParameters()
    unpacked: List[str] = []
    validated_conf: Dict[str, Dict[str, Any]] = {}

    sections = set(conf) | set(spec_map)
    for section in sections:
        raw = conf.get(section, {})
        specs = spec_map.get(section, {})
        validated_conf[section] = {}
        for key in set(raw) | set(specs):
            if key in specs:
                value = validate_value(specs[key], raw.get(key))
            else:
                value = _autoconvert(raw[key])
            validated_conf[section][key] = value
            if key == "unpacked_parameters":
                if isinstance(value, str):
                    value = _string_list_check(value)
                unpacked = list(value)
            else:
                params.add(key, value)

    for name in unpacked:
        params.set_unpack_parameter(name)

    if save_parsed_file:
        _write_ini(filename, validated_conf)
    return params


def _autoconvert(raw: str):
    """Best-effort conversion for spec-less values."""
    for conv in (_integer_check, _float_check):
        try:
            return conv(raw)
        except ValidationError:
            pass
    try:
        return _boolean_check(raw)
    except ValidationError:
        pass
    if raw.startswith("["):
        try:
            return real_numpy_array_check(raw)
        except ValidationError:
            pass
    return _string_check(raw)


def _write_ini(filename: str, conf: Dict[str, Dict[str, Any]]) -> None:
    lines = []
    for section in sorted(conf):
        if section:
            lines.append(f"[{section}]")
        for k, v in conf[section].items():
            if isinstance(v, np.ndarray):
                v = "[" + " ".join(str(x) for x in v.tolist()) + "]"
            lines.append(f"{k} = {v}")
        lines.append("")
    with open(filename, "w") as f:
        f.write("\n".join(lines))
