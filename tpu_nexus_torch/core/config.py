"""Typed configuration loading: a copy of ``tpu_nexus/core/config.py``
that imports ``yaml`` only when it parses a file.

Equivalent of nexus-core `configurations.LoadConfig[T]` as consumed at
reference main.go:14 (behavior contract in SURVEY.md §2.3):

  * reads `appconfig.yaml` from a search path (explicit `config_dir`
    argument, then $TPU_NEXUS_CONFIG_DIR, then cwd, then /app) — kebab-case
    keys, same shape as the reference's appconfig.local.yaml;
  * `APPLICATION_ENVIRONMENT=<env>` overlays `appconfig.<env>.yaml` on top
    (reference CI sets `units`, .github/workflows/build.yaml:53-55);
  * per-key environment overrides `NEXUS__<UPPER_SNAKE>` where `_` maps to
    `-` in the YAML key and `__` descends into nested mappings
    (reference .helm/templates/deployment.yaml:49-66);
  * binds the merged mapping onto a dataclass by field name (snake_case
    field <-> kebab-case key, the Python analogue of mapstructure tags),
    with type coercion for int/float/bool/str/timedelta/lists and nested
    dataclasses.

No CLI flags, matching the reference (SURVEY.md §5.6).
"""

from __future__ import annotations

import dataclasses
import os
import re
from datetime import timedelta
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Type, TypeVar, Union, get_args, get_origin

T = TypeVar("T")

ENV_PREFIX = "NEXUS__"
ENVIRONMENT_SELECTOR = "APPLICATION_ENVIRONMENT"

_DURATION_RE = re.compile(r"(?P<value>\d+(?:\.\d+)?)\s*(?P<unit>ns|us|µs|ms|s|m|h|d)")
_DURATION_UNITS = {
    "ns": 1e-9,
    "us": 1e-6,
    "µs": 1e-6,
    "ms": 1e-3,
    "s": 1.0,
    "m": 60.0,
    "h": 3600.0,
    "d": 86400.0,
}


class ConfigError(Exception):
    """Raised when configuration cannot be loaded or bound."""


def parse_duration(text: Union[str, int, float, timedelta]) -> timedelta:
    """Parse Go-style duration strings ("100ms", "1.5s", "2m30s") into
    timedelta; bare numbers are seconds."""
    if isinstance(text, timedelta):
        return text
    if isinstance(text, (int, float)):
        return timedelta(seconds=float(text))
    s = str(text).strip()
    if not s:
        raise ConfigError(f"empty duration: {text!r}")
    try:
        return timedelta(seconds=float(s))
    except ValueError:
        pass
    total = 0.0
    pos = 0
    for m in _DURATION_RE.finditer(s):
        if m.start() != pos:
            raise ConfigError(f"invalid duration: {text!r}")
        total += float(m.group("value")) * _DURATION_UNITS[m.group("unit")]
        pos = m.end()
    if pos != len(s):
        raise ConfigError(f"invalid duration: {text!r}")
    return timedelta(seconds=total)


def _field_key(field: dataclasses.Field) -> str:
    """YAML key for a dataclass field: explicit metadata['key'] or
    kebab-cased field name (the mapstructure-tag analogue)."""
    return field.metadata.get("key", field.name.replace("_", "-"))


def _coerce(value: Any, target: Any) -> Any:
    origin = get_origin(target)
    if origin is Union:  # Optional[...] and friends
        args = [a for a in get_args(target) if a is not type(None)]
        if value is None:
            return None
        for arg in args:
            try:
                return _coerce(value, arg)
            except (ConfigError, TypeError, ValueError):
                continue
        raise ConfigError(f"cannot coerce {value!r} to {target}")
    if target is Any or target is None:
        return value
    if dataclasses.is_dataclass(target):
        return bind(value or {}, target)
    if origin in (list, List):
        (elem,) = get_args(target) or (Any,)
        if value is None or value == "":
            return []
        if isinstance(value, str):
            value = [v.strip() for v in value.split(",") if v.strip()]
        return [_coerce(v, elem) for v in value]
    if origin in (dict, Dict, Mapping):
        return dict(value or {})
    if target is timedelta:
        return parse_duration(value)
    if target is bool:
        if isinstance(value, bool):
            return value
        if isinstance(value, str):
            if value.lower() in ("true", "1", "yes", "on"):
                return True
            if value.lower() in ("false", "0", "no", "off", ""):
                return False
            raise ConfigError(f"not a bool: {value!r}")
        return bool(value)
    if target in (int, float, str):
        if value is None or value == "":
            # the reference's local config uses "" for unset ints
            # (appconfig.local.yaml: workers: "") — treat as zero value
            return target() if target is not str else ""
        try:
            return target(value)
        except (TypeError, ValueError) as exc:
            raise ConfigError(f"cannot coerce {value!r} to {target.__name__}: {exc}") from exc
    return value


def bind(mapping: Mapping[str, Any], cls: Type[T]) -> T:
    """Bind a (kebab-keyed) mapping onto dataclass `cls`."""
    if not dataclasses.is_dataclass(cls):
        raise ConfigError(f"{cls} is not a dataclass")
    kwargs: Dict[str, Any] = {}
    for field in dataclasses.fields(cls):
        key = _field_key(field)
        if key in mapping:
            kwargs[field.name] = _coerce(mapping[key], _resolve_type(cls, field))
        elif field.default is dataclasses.MISSING and field.default_factory is dataclasses.MISSING:  # type: ignore[misc]
            # required field missing -> instantiate zero value for dataclasses
            t = _resolve_type(cls, field)
            if dataclasses.is_dataclass(t):
                kwargs[field.name] = bind({}, t)
            else:
                raise ConfigError(f"missing required config key {key!r} for {cls.__name__}")
    return cls(**kwargs)  # type: ignore[arg-type]


def _resolve_type(cls: Type, field: dataclasses.Field) -> Any:
    """Resolve possibly-stringified annotations (from __future__ import
    annotations) into real types."""
    if not isinstance(field.type, str):
        return field.type
    import typing
    import sys

    module = sys.modules.get(cls.__module__)
    globalns = getattr(module, "__dict__", {})
    try:
        return eval(field.type, dict(globalns, **vars(typing)), {"timedelta": timedelta})  # noqa: S307
    except Exception as exc:  # pragma: no cover - developer error  # noqa: BLE001 - eval of an annotation can raise anything; rewrap as ConfigError
        raise ConfigError(f"cannot resolve annotation {field.type!r}: {exc}") from exc


def _deep_merge(base: Dict[str, Any], overlay: Mapping[str, Any]) -> Dict[str, Any]:
    out = dict(base)
    for k, v in overlay.items():
        if isinstance(v, Mapping) and isinstance(out.get(k), Mapping):
            out[k] = _deep_merge(dict(out[k]), v)
        else:
            out[k] = v
    return out


def _apply_env_overrides(mapping: Dict[str, Any], environ: Mapping[str, str]) -> Dict[str, Any]:
    """Overlay NEXUS__* environment variables.

    `NEXUS__RESOURCE_NAMESPACE=x`            -> {"resource-namespace": "x"}
    `NEXUS__SCYLLA_CQL_STORE__HOSTS=a,b`     -> {"scylla-cql-store": {"hosts": "a,b"}}
    """
    out = dict(mapping)
    for name, raw in sorted(environ.items()):
        if not name.startswith(ENV_PREFIX):
            continue
        path = [seg.lower().replace("_", "-") for seg in name[len(ENV_PREFIX):].split("__") if seg]
        if not path:
            continue
        node = out
        for seg in path[:-1]:
            nxt = node.get(seg)
            if not isinstance(nxt, dict):
                nxt = {}
                node[seg] = nxt
            node = nxt
        node[path[-1]] = raw
    return out


def _config_search_paths(config_dir: Optional[str]) -> List[Path]:
    paths: List[Path] = []
    if config_dir:
        paths.append(Path(config_dir))
    env_dir = os.environ.get("TPU_NEXUS_CONFIG_DIR")
    if env_dir:
        paths.append(Path(env_dir))
    paths.append(Path.cwd())
    paths.append(Path("/app"))  # image bake location, reference .container/Dockerfile:42
    return paths


def _read_yaml(path: Path) -> Dict[str, Any]:
    """One YAML file's mapping.  ``yaml`` is imported here, not with the
    module: the workload entry point loads this module, and only a found
    file needs the parser."""
    import yaml

    with open(path, "r", encoding="utf-8") as fh:
        return yaml.safe_load(fh) or {}


def load_config(
    cls: Type[T],
    config_dir: Optional[str] = None,
    environ: Optional[Mapping[str, str]] = None,
    base_name: str = "appconfig",
) -> T:
    """Load, overlay, and bind configuration for `cls` (a dataclass)."""
    environ = environ if environ is not None else os.environ
    merged: Dict[str, Any] = {}
    found_dir: Optional[Path] = None
    for directory in _config_search_paths(config_dir):
        candidate = directory / f"{base_name}.yaml"
        if candidate.is_file():
            merged = _read_yaml(candidate)
            found_dir = directory
            break
    env_name = environ.get(ENVIRONMENT_SELECTOR, "")
    if env_name and found_dir is not None:
        overlay_path = found_dir / f"{base_name}.{env_name}.yaml"
        if overlay_path.is_file():
            merged = _deep_merge(merged, _read_yaml(overlay_path))
    merged = _apply_env_overrides(merged, environ)
    return bind(merged, cls)
