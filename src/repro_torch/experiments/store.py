"""Versioned JSON artifact store for sweep results.

Layout (rooted at ``results/`` by default, committed or CI-uploaded):

    results/<sweep-name>/v0001/sweep.json      # the full record
    results/<sweep-name>/v0001/figures/*.svg   # rendered gallery (optional)
    results/<sweep-name>/v0002/...             # next run, never overwritten

Every `run_sweep` call writes a NEW version directory, so a results tree
is an append-only history of reproductions; `latest_dir`/`load_latest`
resolve the most recent one.  Records carry ``schema`` so future readers
can migrate old artifacts.
"""
from __future__ import annotations

import json
import re
from pathlib import Path

__all__ = [
    "SCHEMA_VERSION",
    "next_version_dir",
    "latest_dir",
    "write_record",
    "load_record",
    "load_latest",
]

SCHEMA_VERSION = 1

_V_RE = re.compile(r"^v(\d{4,})$")


def _versions(sweep_dir: Path) -> list[tuple[int, Path]]:
    if not sweep_dir.is_dir():
        return []
    out = []
    for child in sweep_dir.iterdir():
        m = _V_RE.match(child.name)
        if m and child.is_dir():
            out.append((int(m.group(1)), child))
    return sorted(out)


def next_version_dir(root: str | Path, name: str) -> Path:
    """Create and return the next ``results/<name>/v####`` directory.

    Concurrency-safe: ``mkdir`` (never the directory listing) is the
    atomic claim.  Two writers that list the same versions compute the
    same candidate, but only one ``mkdir`` can succeed — the loser sees
    FileExistsError, re-lists, and claims the next free slot instead of
    crashing (CI matrix jobs, sharded sweeps, and the long-running
    service harness all race this path).
    """
    sweep_dir = Path(root) / name
    last_err: OSError | None = None
    for _ in range(1000):     # bounded: each retry means someone claimed
        versions = _versions(sweep_dir)
        nxt = versions[-1][0] + 1 if versions else 1
        out = sweep_dir / f"v{nxt:04d}"
        try:
            out.mkdir(parents=True, exist_ok=False)
            return out
        except FileExistsError as err:
            last_err = err
    raise RuntimeError(
        f"could not claim a version directory under {sweep_dir} after "
        f"1000 attempts") from last_err


def latest_dir(root: str | Path, name: str) -> Path | None:
    """The most recent version directory of a sweep, or None."""
    versions = _versions(Path(root) / name)
    return versions[-1][1] if versions else None


def write_record(record: dict, out_dir: str | Path,
                 filename: str = "sweep.json") -> Path:
    """Write a schema-stamped JSON record into a version directory
    (``sweep.json`` for sweeps; the service harness writes
    ``service.json``)."""
    record = dict(record)
    record.setdefault("schema", SCHEMA_VERSION)
    path = Path(out_dir) / filename
    with open(path, "w") as fh:
        json.dump(record, fh, indent=1, sort_keys=False)
        fh.write("\n")
    return path


def load_record(path: str | Path, filename: str = "sweep.json") -> dict:
    """Load a record from a JSON path or its version directory."""
    p = Path(path)
    if p.is_dir():
        p = p / filename
    with open(p) as fh:
        record = json.load(fh)
    if record.get("schema") != SCHEMA_VERSION:
        raise ValueError(
            f"unsupported sweep artifact schema {record.get('schema')!r} "
            f"in {p} (reader supports {SCHEMA_VERSION})")
    return record


def load_latest(root: str | Path, name: str,
                filename: str = "sweep.json") -> dict | None:
    """Load the most recent record of a sweep, or None if never run."""
    d = latest_dir(root, name)
    return load_record(d, filename) if d else None
