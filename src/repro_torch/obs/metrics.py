"""Unified metrics plane: every counter family behind one ``collect()``.

The repo grew half a dozen counter surfaces (``ConnTelemetry.snapshot``,
split ``FabricCounters``, ``ReliableChannel`` retransmits, ``Reassembler``
evictions, controller decision counts, fleet aggregates), each with its
own ad-hoc dict shape. :class:`MetricsRegistry` registers *sources* —
zero-arg callables returning a flat-ish dict — under ``(family,
instance)`` and exposes one snapshot with two exporters:

* :meth:`to_prometheus` — Prometheus text exposition format
  (``repro_<family>_<metric>{instance="..."} value``). Nested one-level
  dicts become a ``key`` label; non-numeric values are skipped (they
  remain visible in the JSON exporter).
* :meth:`to_json` — the full nested snapshot, JSON-serializable.

``watch(family, obj)`` duck-types the repo's counter objects (``snapshot``
/ ``counts`` / ``stats`` / ``collect`` methods, or a dataclass-style
``__dict__`` of numbers) so call sites stay one line. Stdlib-only.
"""
from __future__ import annotations

import json
import re
import threading
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["MetricsRegistry", "parse_prometheus"]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")

_SNAPSHOT_METHODS = ("snapshot", "counts", "stats", "collect")


def _sanitize(name: str) -> str:
    return _NAME_RE.sub("_", name)


def _esc(label: str) -> str:
    return str(label).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class MetricsRegistry:
    """Registry of named metric sources with Prometheus/JSON exporters."""

    def __init__(self):
        self._lock = threading.Lock()
        self._sources: Dict[Tuple[str, str], Callable[[], dict]] = {}

    # -- registration ------------------------------------------------------
    def register(self, family: str, source: Callable[[], dict],
                 instance: str = "default") -> None:
        """Register a zero-arg callable returning a dict of metrics."""
        with self._lock:
            self._sources[(family, instance)] = source

    def watch(self, family: str, obj, instance: str = "default") -> None:
        """Register a counter *object* by duck-typing its snapshot method.

        Resolution order: ``snapshot()`` / ``counts()`` / ``stats()`` /
        ``collect()``, else the object's numeric public attributes
        (covers bare counter holders like ``ReliableChannel``).
        """
        for meth in _SNAPSHOT_METHODS:
            fn = getattr(obj, meth, None)
            if callable(fn):
                self.register(family, fn, instance)
                return
        self.register(family, lambda o=obj: _numeric_attrs(o), instance)

    def watch_fields(self, family: str, obj, fields: Tuple[str, ...],
                     instance: str = "default") -> None:
        """Register an explicit attribute subset of ``obj``."""
        self.register(
            family,
            lambda o=obj, fs=fields: {f: getattr(o, f, None) for f in fs},
            instance,
        )

    def unregister(self, family: str, instance: str = "default") -> None:
        with self._lock:
            self._sources.pop((family, instance), None)

    # -- snapshot ----------------------------------------------------------
    def collect(self) -> Dict[str, Dict[str, dict]]:
        """``{family: {instance: metrics-dict}}`` — one unified snapshot.

        A failing source contributes ``{"_error": repr(exc)}`` instead of
        poisoning the whole snapshot (sources may race object teardown).
        """
        with self._lock:
            sources = list(self._sources.items())
        out: Dict[str, Dict[str, dict]] = {}
        for (family, instance), fn in sources:
            try:
                metrics = fn()
            except Exception as exc:  # lint: allow[silent-except] exporter must not die with a source
                metrics = {"_error": repr(exc)}
            if not isinstance(metrics, dict):
                metrics = {"value": metrics}
            out.setdefault(family, {})[instance] = metrics
        return out

    # -- exporters ---------------------------------------------------------
    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.collect(), indent=indent, sort_keys=True,
                          default=str)

    def to_prometheus(self) -> str:
        """Prometheus text exposition (format version 0.0.4)."""
        lines: List[str] = []
        snap = self.collect()
        for family in sorted(snap):
            for instance in sorted(snap[family]):
                metrics = snap[family][instance]
                for key in sorted(metrics):
                    val = metrics[key]
                    base = f"repro_{_sanitize(family)}_{_sanitize(key)}"
                    if isinstance(val, dict):
                        for sub in sorted(val):
                            num = _as_number(val[sub])
                            if num is None:
                                continue
                            lines.append(
                                f'{base}{{instance="{_esc(instance)}",'
                                f'key="{_esc(sub)}"}} {num!r}')
                        continue
                    num = _as_number(val)
                    if num is None:
                        continue
                    lines.append(
                        f'{base}{{instance="{_esc(instance)}"}} {num!r}')
        return "\n".join(lines) + "\n"

    def write_prometheus(self, path) -> str:
        text = self.to_prometheus()
        with open(path, "w") as f:
            f.write(text)
        return text


def _as_number(val):
    if isinstance(val, bool):
        return int(val)
    if isinstance(val, (int, float)):
        return val
    return None


def _numeric_attrs(obj) -> dict:
    out = {}
    for k, v in vars(obj).items():
        if k.startswith("_"):
            continue
        if isinstance(v, bool) or isinstance(v, (int, float)):
            out[k] = v
    return out


# labels use a greedy ``.*`` (a label VALUE may contain ``}``); the value
# charset admits inf/nan spellings in either case (repr() emits lowercase,
# canonical Prometheus writes ``+Inf``/``NaN``)
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?\s+"
    r"(?P<value>[-+0-9.eEinfaINFA]+)$")

# quote-aware label pair: the value is a run of non-quote/non-backslash
# chars or backslash escapes — a comma INSIDE a quoted value no longer
# splits the pair (the old naive ``split(",")`` did)
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')

_UNESC = {"n": "\n", '"': '"', "\\": "\\"}


def _unescape(s: str) -> str:
    """Invert :func:`_esc` — one left-to-right scan, so a literal
    backslash-n survives as ``\\n`` text and an escaped newline comes back
    as a real newline (chained ``str.replace`` gets this wrong)."""
    if "\\" not in s:
        return s
    out: List[str] = []
    i, n = 0, len(s)
    while i < n:
        c = s[i]
        if c == "\\" and i + 1 < n:
            out.append(_UNESC.get(s[i + 1], "\\" + s[i + 1]))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def parse_prometheus(text: str) -> List[dict]:
    """Parse exposition text back into samples; raises on malformed lines.

    Used by the CLI ``--check`` and verify.sh to assert the exporter's
    output actually parses. Label values are unescaped, so
    ``parse_prometheus(registry.to_prometheus())`` round-trips instance
    names containing quotes, backslashes, newlines, and commas exactly.
    Returns ``[{"name", "labels", "value"}]``.
    """
    samples: List[dict] = []
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"metrics line {lineno} unparseable: {raw!r}")
        labels = {}
        if m.group("labels"):
            for k, v in _LABEL_RE.findall(m.group("labels")):
                labels[k] = _unescape(v)
        samples.append({"name": m.group("name"), "labels": labels,
                        "value": float(m.group("value"))})
    return samples
