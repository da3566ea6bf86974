"""TOML for the key store (counterpart of `drand_tpu/toml_util.py`): a
writer of the subset the key, group and share files use (str, int and
bool scalars, flat tables, arrays of tables, flat scalar arrays), in the
same layout, so a file written by either package is byte-equal; reading
is the standard library's `tomllib`."""

from __future__ import annotations

import tomllib


def _fmt_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        return repr(v)
    if isinstance(v, str):
        escaped = v.replace("\\", "\\\\").replace('"', '\\"')
        return f'"{escaped}"'
    if isinstance(v, list) and all(isinstance(x, (str, int, float, bool))
                                   for x in v):
        return "[" + ", ".join(_fmt_value(x) for x in v) + "]"
    raise TypeError(f"unsupported TOML value {type(v)}")


def dumps(doc: dict) -> str:
    """dict -> TOML: top-level scalars first, then each dict value as a
    [table], then each list of dicts as [[an array of tables]]."""
    lines: list[str] = []
    tables: list[tuple[str, dict]] = []
    array_tables: list[tuple[str, list]] = []
    for k, v in doc.items():
        if isinstance(v, dict):
            tables.append((k, v))
        elif isinstance(v, list) and v and all(isinstance(x, dict) for x in v):
            array_tables.append((k, v))
        else:
            lines.append(f"{k} = {_fmt_value(v)}")
    for name, tbl in tables:
        lines.append("")
        lines.append(f"[{name}]")
        for k, v in tbl.items():
            lines.append(f"{k} = {_fmt_value(v)}")
    for name, items in array_tables:
        for item in items:
            lines.append("")
            lines.append(f"[[{name}]]")
            for k, v in item.items():
                lines.append(f"{k} = {_fmt_value(v)}")
    return "\n".join(lines) + "\n"


def loads(text: str) -> dict:
    return tomllib.loads(text)
