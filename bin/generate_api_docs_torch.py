#!/usr/bin/env python
"""Generate docs/api_torch.md — a markdown API reference for the PyTorch
port, pyphysim_tpu_torch.

The counterpart of ``bin/generate_api_docs.py``: walks every module of the
port and, for each public class and function defined there, emits its
signature and the first paragraph of its docstring. Every module gets its
heading, with its docstring's first paragraph, also a package module that
only re-exports names. Importing the port builds no kernel and loads
neither jax nor the optional packages (zmq, IPython, matplotlib), which
its modules import inside the classes that use them.

It never writes docs/api.md, the JAX package's reference.

Usage: python bin/generate_api_docs_torch.py [output.md]
"""

import importlib
import inspect
import pkgutil
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
JAX_API = ROOT / "docs" / "api.md"


def _summary(obj) -> str:
    doc = inspect.getdoc(obj) or ""
    return doc.split("\n\n")[0].replace("\n", " ").strip()


def _signature(obj) -> str:
    """The signature, without the addresses of default-value objects (so
    that the file is the same on every run)."""
    try:
        return re.sub(r" at 0x[0-9a-fA-F]+", "", str(inspect.signature(obj)))
    except (ValueError, TypeError):
        return "(...)"


def _class_section(name: str, cls, lines: list) -> None:
    lines.append(f"### `{name}`\n")
    s = _summary(cls)
    if s:
        lines.append(s + "\n")
    bases = [b.__name__ for b in cls.__bases__ if b is not object]
    if bases:
        lines.append(f"*Bases:* {', '.join(f'`{b}`' for b in bases)}\n")
    rows = []
    for mname, member in sorted(vars(cls).items()):
        if mname.startswith("_"):
            continue
        if isinstance(member, property):
            rows.append(f"- `{mname}` *(property)* — "
                        f"{_summary(member.fget) or ''}".rstrip(" —"))
        elif inspect.isfunction(member):
            rows.append(f"- `{mname}{_signature(member)}` — "
                        f"{_summary(member) or ''}".rstrip(" —"))
        elif isinstance(member, (staticmethod, classmethod)):
            fn = member.__func__
            rows.append(f"- `{mname}{_signature(fn)}` — "
                        f"{_summary(fn) or ''}".rstrip(" —"))
    lines.extend(rows)
    if rows:
        lines.append("")


def main(out_path: str = str(ROOT / "docs" / "api_torch.md")) -> list:
    """Write the reference to ``out_path``; returns the module names."""
    if Path(out_path).resolve() == JAX_API:
        raise ValueError(f"{JAX_API} is the JAX package's reference; the "
                         "port's goes to docs/api_torch.md")
    sys.path.insert(0, str(ROOT))
    import pyphysim_tpu_torch

    lines = [
        "# API reference — pyphysim_tpu_torch",
        "",
        "Generated by `bin/generate_api_docs_torch.py` — do not edit by "
        "hand.",
        "The port of `pyphysim_tpu` to PyTorch and CUDA; docstrings cite "
        "their JAX",
        "counterparts as `file.py:line` where a name is one.",
        "",
    ]

    modnames = sorted(
        m.name for m in pkgutil.walk_packages(pyphysim_tpu_torch.__path__,
                                              "pyphysim_tpu_torch."))
    for modname in modnames:
        try:
            mod = importlib.import_module(modname)
        except Exception as exc:  # reported in the reference, not raised
            lines.append(f"## `{modname}` — import failed: {exc}\n")
            continue
        classes, funcs = [], []
        for name, obj in sorted(vars(mod).items()):
            if name.startswith("_"):
                continue
            if inspect.isclass(obj) and obj.__module__ == modname:
                classes.append((name, obj))
            elif inspect.isfunction(obj) and obj.__module__ == modname:
                funcs.append((name, obj))
        lines.append(f"## `{modname}`\n")
        msum = _summary(mod)
        if msum:
            lines.append(msum + "\n")
        for name, cls in classes:
            _class_section(name, cls, lines)
        if funcs:
            lines.append("### Functions\n")
            for name, fn in funcs:
                lines.append(f"- `{name}{_signature(fn)}` — "
                             f"{_summary(fn) or ''}".rstrip(" —"))
            lines.append("")

    Path(out_path).write_text("\n".join(lines) + "\n")
    print(f"wrote {out_path} ({len(lines)} lines, "
          f"{len(modnames)} modules)")
    return modnames


if __name__ == "__main__":
    main(*sys.argv[1:])
