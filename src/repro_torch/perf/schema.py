"""Minimal JSON-Schema (draft-07 subset) validator — no dependencies.

Port of ``repro/perf/schema.py``, copied unchanged in behaviour: the port's
benchmark records (``repro_torch.benchmarks.run``) and its perf gate
(``repro_torch.benchmarks.perf_gate``) validate against the port's copy of
the bench schema, ``src/repro_torch/benchmarks/bench_schema.json``, with
this subset (no ``jsonschema`` package is needed).

Supported keywords: ``type`` (scalar or list), ``properties``,
``required``, ``additionalProperties`` (bool), ``items``, ``enum``,
``const``, ``minimum``, ``oneOf``, ``anyOf``, ``$ref`` (into
``#/definitions/...`` only).  Anything else in a schema is ignored —
which is the permissive direction: the gate can only get *stricter* by
upgrading the validator, never silently looser on the keywords it claims.

:func:`validate` returns a list of problem strings (empty = valid), each
prefixed with a JSON-pointer-ish path into the instance.
"""
from __future__ import annotations

import json
import pathlib
from typing import Any, Dict, List

__all__ = ["validate", "load_schema"]

_TYPES = {
    "object": dict, "array": list, "string": str, "boolean": bool,
    "null": type(None),
}


def load_schema(path) -> Dict:
    with open(pathlib.Path(path)) as f:
        return json.load(f)


def _type_ok(value: Any, tname: str) -> bool:
    if tname == "number":
        return isinstance(value, (int, float)) and not isinstance(value, bool)
    if tname == "integer":
        return (isinstance(value, int) and not isinstance(value, bool)) or \
            (isinstance(value, float) and float(value).is_integer())
    py = _TYPES.get(tname)
    if py is None:
        return True   # unknown type names never reject (permissive direction)
    if py is dict or py is list or py is str:
        return isinstance(value, py)
    if tname == "boolean":
        return isinstance(value, bool)
    return isinstance(value, py)


def _resolve_ref(ref: str, root: Dict) -> Dict:
    if not ref.startswith("#/"):
        raise ValueError(f"only local '#/' refs supported, got {ref!r}")
    node: Any = root
    for part in ref[2:].split("/"):
        node = node[part]
    return node


def _validate(value: Any, schema: Dict, root: Dict, path: str,
              problems: List[str]) -> None:
    if "$ref" in schema:
        _validate(value, _resolve_ref(schema["$ref"], root), root, path,
                  problems)
        return

    for combo in ("oneOf", "anyOf"):
        if combo in schema:
            branches = schema[combo]
            failures = []
            matched = 0
            for i, sub in enumerate(branches):
                sub_probs: List[str] = []
                _validate(value, sub, root, path, sub_probs)
                if not sub_probs:
                    matched += 1
                else:
                    failures.append(f"[{i}] {sub_probs[0]}")
            want_one = combo == "oneOf"
            if matched == 0 or (want_one and matched > 1):
                detail = "; ".join(failures[:3])
                problems.append(
                    f"{path}: matched {matched} of {len(branches)} {combo} "
                    f"branches ({detail})")
            return   # combinators subsume the sibling keywords we support

    t = schema.get("type")
    if t is not None:
        names = t if isinstance(t, list) else [t]
        if not any(_type_ok(value, n) for n in names):
            problems.append(f"{path}: expected type {t}, got "
                            f"{type(value).__name__}")
            return

    if "const" in schema and value != schema["const"]:
        problems.append(f"{path}: expected const {schema['const']!r}, "
                        f"got {value!r}")
        return
    if "enum" in schema and value not in schema["enum"]:
        problems.append(f"{path}: {value!r} not in enum {schema['enum']}")
        return
    if "minimum" in schema and isinstance(value, (int, float)) \
            and not isinstance(value, bool) and value < schema["minimum"]:
        problems.append(f"{path}: {value!r} < minimum {schema['minimum']}")

    if isinstance(value, dict):
        for key in schema.get("required", []):
            if key not in value:
                problems.append(f"{path}: missing required property {key!r}")
        props = schema.get("properties", {})
        for key, sub in props.items():
            if key in value:
                _validate(value[key], sub, root, f"{path}/{key}", problems)
        if schema.get("additionalProperties") is False:
            for key in value:
                if key not in props:
                    problems.append(f"{path}: unexpected property {key!r}")

    if isinstance(value, list) and "items" in schema:
        for i, item in enumerate(value):
            _validate(item, schema["items"], root, f"{path}[{i}]", problems)


def validate(value: Any, schema: Dict, root: Dict | None = None) -> List[str]:
    """Validate ``value`` against ``schema``; returns problem strings
    (empty list = valid).  ``root`` is the document ``$ref``s resolve
    against (defaults to ``schema`` itself)."""
    problems: List[str] = []
    _validate(value, schema, root if root is not None else schema, "$",
              problems)
    return problems
