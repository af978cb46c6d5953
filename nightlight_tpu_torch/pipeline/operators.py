"""Operator framework of the port: JSON-polymorphic operator registry, the
promise interface, and the built-in load/save/sequence operators
(reference: internal/ops/operator.go), mirror of
nightlight_tpu/pipeline/operators.py.

The JSON job format -- ``type`` tags and field names -- is the same as the
JAX package's. Execution is eager: promises are plain callables run in
order on the calling thread (no thread pool, no deferred pool); frame files
are read ahead on the loader's threads (io/ingest.py).
"""

from __future__ import annotations

import dataclasses
import glob as globmod
import json
import os
import re
from enum import IntEnum
from typing import Callable, Optional

from nightlight_tpu_torch.image import Image
from nightlight_tpu_torch.parallel import mesh as pm
from nightlight_tpu_torch.pipeline.context import Context

Promise = Callable[[], Optional[Image]]

_operator_factories: dict[str, type] = {}


def register(cls):
    """Register an operator class for JSON decoding (operator.go:159-166)."""
    t = cls.TYPE
    if t in _operator_factories:
        raise ValueError(f"error: re-registering operator key {t}")
    _operator_factories[t] = cls
    return cls


def get_operator_factory(t: str):
    return _operator_factories.get(t)


def op_from_dict(d: dict) -> "Operator":
    """Decode a polymorphic operator from a JSON dict (operator.go:484-513)."""
    t = d.get("type")
    cls = get_operator_factory(t)
    if cls is None:
        raise ValueError(f"unknown operator type '{t}' in raw JSON message '{json.dumps(d)}'")
    return cls.from_dict(d)


class Operator:
    """Base operator: JSON round trip via PARAMS (python_field -> (json_name,
    default)) and the promise interface (operator.go:133-166)."""

    TYPE = ""
    PARAMS: dict[str, tuple[str, object]] = {}

    def __init__(self, **kwargs):
        for name, (_, default) in self.PARAMS.items():
            setattr(self, name, kwargs.pop(name, default))
        if kwargs:
            raise TypeError(f"{self.TYPE}: unknown arguments {sorted(kwargs)}")

    def to_dict(self) -> dict:
        d = {"type": self.TYPE}
        for name, (json_name, _) in self.PARAMS.items():
            v = getattr(self, name)
            if isinstance(v, Operator):
                v = v.to_dict()
            elif isinstance(v, IntEnum):
                v = int(v)
            d[json_name] = v
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Operator":
        kwargs = {}
        for name, (json_name, default) in cls.PARAMS.items():
            if json_name in d:
                v = d[json_name]
                if isinstance(default, Operator) or (isinstance(v, dict) and "type" in v):
                    v = op_from_dict(v) if isinstance(v, dict) else v
                kwargs[name] = v
        return cls(**kwargs)

    def to_json(self, indent=2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    def make_promises(self, ins: list[Promise], c: Context) -> list[Promise]:
        raise NotImplementedError

    def is_noop(self) -> bool:
        """True when apply() passes its input through under the current
        parameters (each op's own first-line guard)."""
        return False

    def __repr__(self):
        return f"<{type(self).__name__} {self.to_dict()}>"


class UnaryOperator(Operator):
    """1-in/1-out operator fanning over n inputs (operator.go:170-207).

    Under ``Context.mesh`` a frame's data may be row-sharded
    (parallel/mesh.py RowSharded). An operator whose apply() works on that
    sets ``SHARDED = True``; any other takes the frame gathered whole onto
    the lead device (``take_whole``), and keeps it whole after, unless it
    passes the frame through (``is_noop``)."""

    SHARDED = False

    def make_promises(self, ins: list[Promise], c: Context) -> list[Promise]:
        if not ins:
            raise ValueError("unary operator with 0 inputs")
        return [self.make_promise(i, c) for i in ins]

    def make_promise(self, in_p: Promise, c: Context) -> Promise:
        def out() -> Optional[Image]:
            f = in_p()
            if f is None:
                return None
            if not self.SHARDED and not self.is_noop():
                take_whole(f, self.TYPE)
            return self.apply(f, c)

        return out

    def apply(self, f: Image, c: Context) -> Optional[Image]:
        raise NotImplementedError


def take_whole(f: Image, site: str) -> None:
    """Gather a row-sharded frame onto the mesh's lead device, for an
    operator that has no sharded form (its statistics stay valid)."""
    if isinstance(f.data, pm.RowSharded):
        f.data = pm.gather(f.data, site)
        if f.stats is not None:
            f.stats.replace_data(f.data)


def materialize_all(ins: list[Promise], forget: bool = False, compact: bool = True):
    """Run promises in order, aggregating and deduplicating errors and
    dropping None results unless compact=False (operator.go:73-131).
    Returns (images, error or None).

    Sequential on purpose: device work stays on one thread and one stream.
    The JAX package's pool here stands in for the reference's goroutines,
    whose gain is reading files while the device computes; the port gets
    that overlap from the read-ahead loader's threads (io/ingest.py), which
    read the frames of a load set ahead of these promises."""
    outs: list[Optional[Image]] = [None] * len(ins)
    errors: list[Exception] = []
    for i, p in enumerate(ins):
        try:
            f = p()
            if not forget:
                outs[i] = f
        except Exception as e:  # noqa: BLE001 - aggregated like the reference
            errors.append(e)
    err: Optional[Exception] = None
    msgs: list[str] = []
    for e in errors:
        if str(e) not in msgs:
            msgs.append(str(e))
            err = err or e
    if err is not None and len(msgs) > 1:
        err = RuntimeError("; ".join(msgs))
    if compact:
        outs = [o for o in outs if o is not None]
    return outs, err


def is_path_allowed(p: str) -> bool:
    """Path sandboxing: relative, no '..' (operator.go:258-266)."""
    return not os.path.isabs(p) and ".." not in p


# Set True by the CLI's -allowAbsolutePaths to lift the relative-path sandbox.
ALLOW_ABSOLUTE_PATHS = False


def _check_path(p: str) -> None:
    if not ALLOW_ABSOLUTE_PATHS and not is_path_allowed(p):
        raise ValueError("filename outside current directory tree, aborting")


class _RangeWarn:
    """The load line's low-dynamic-range suffix."""

    def __init__(self, mn: float, mx: float):
        self._mn, self._mx = mn, mx

    def render_deferred(self) -> str:
        return "; WARNING low dynamic range" if self._mx - self._mn < 1e-8 else ""


@register
class OpLoad(Operator):
    """Load one FITS/TIFF image (operator.go:210-282).
    The image lands on the context's device; under c.mesh it is placed on
    the mesh by rows (parallel/mesh.py place_on_mesh, as the JAX package
    places it here), each shard's rows uploaded straight to its device by
    the readers, and the per-frame operators run on the shards."""

    TYPE = "load"
    PARAMS = {"id": ("id", 0), "file_name": ("fileName", "")}

    def __init__(self, prefetcher=None, **kwargs):
        super().__init__(**kwargs)
        self._prefetcher = prefetcher  # the load set's read-ahead loader, optional

    def make_promises(self, ins, c):
        if ins:
            raise ValueError(f"{self.TYPE} operator with non-zero input")
        _check_path(self.file_name)

        def promise():
            return self.apply(None, c)

        # batch schedulers find the load order and the loader through this
        # (OpStackBatches announces each out-of-core batch)
        promise.op = self
        return [promise]

    def apply(self, _unused, c: Context) -> Image:
        if self._prefetcher is not None:
            f = self._prefetcher.get(self.file_name)
        else:
            from nightlight_tpu_torch.io.fits import read_file

            f = read_file(self.file_name, id=self.id, log=c.log, device=c.device,
                          mesh=c.mesh)
        if c.mesh is not None:
            # the readers shard what they can upload by rows; a TIFF or
            # integer rows that do not divide the mesh arrive whole
            f.data = pm.place_on_mesh(f.data, c.mesh)
            f.stats.replace_data(f.data)
        f.stats.mode = c.ls_estimator_mode
        f.stats._ensure_mmm()
        c.logf("%d: Loaded %s image with %s from %s%s\n",
               f.id, f.dimensions_string(), f.stats, f.file_name,
               _RangeWarn(f.stats.min, f.stats.max))
        return f


@register
class OpLoadMany(Operator):
    """Glob file patterns into n load promises (operator.go:286-345)."""

    TYPE = "loadMany"
    PARAMS = {"file_patterns": ("filePatterns", None)}

    def make_promises(self, ins, c):
        if ins:
            raise ValueError(f"{self.TYPE} operator with non-zero input")
        specs: list[tuple[int, str]] = []
        for pattern in self.file_patterns or []:
            for match in sorted(globmod.glob(pattern)):
                if not ALLOW_ABSOLUTE_PATHS and not is_path_allowed(match):
                    c.logf("Pattern match outside current directory tree, skipping\n")
                    continue
                specs.append((len(specs), match))
        if not specs:
            raise ValueError(
                f"{self.TYPE} operator with no files to load from pattern {self.file_patterns}")
        from nightlight_tpu_torch.io.ingest import LOOKAHEAD, ReadAheadLoader

        # integer frames: raw payloads read ahead within a byte window;
        # else host decode ahead, worth it only with a spare core, as the
        # JAX package's gates decide (operators.py:385-398)
        prefetcher = ReadAheadLoader.try_create(specs, c.log, c.device, mesh=c.mesh)
        if prefetcher is None and len(specs) > 1 and (os.cpu_count() or 1) > 1:
            prefetcher = ReadAheadLoader(specs, c.log, c.device, window_bytes=None,
                                         lookahead=LOOKAHEAD, mesh=c.mesh)
        if prefetcher is not None:
            c.own(prefetcher)
        outs: list[Promise] = []
        for id_, match in specs:
            outs.extend(OpLoad(id=id_, file_name=match, prefetcher=prefetcher)
                        .make_promises([], c))
        c.logf("Found %d files.\n", len(outs))
        return outs


class ExportMode(IntEnum):
    """Export value ranges (operator.go:348-355)."""

    MinMax = 0
    Zero1 = 1
    Zero255 = 2
    Zero65535 = 3


_FITS_SUFFIXES = tuple(base + gz for base in (".fits", ".fit", ".fts")
                       for gz in ("", ".gz", ".gzip"))


@register
class OpSave(Operator):
    """Save to FITS/TIFF/JPEG by suffix, %d expanded with the image id
    (operator.go:359-462). Passes its input through."""

    TYPE = "save"
    PARAMS = {
        "file_pattern": ("filePattern", ""),
        "export_mode": ("saveMode", int(ExportMode.MinMax)),
        "gamma": ("gamma", 1.0),
    }

    def is_noop(self) -> bool:
        return not self.file_pattern

    def make_promises(self, ins, c):
        if not ins:
            raise ValueError("save operator needs inputs")
        return [self.make_promise(p, c) for p in ins]

    def make_promise(self, in_p: Promise, c: Context) -> Promise:
        def out():
            f = in_p()
            if f is None:
                return None
            return self.apply(f, c)

        return out

    def apply(self, f: Image, c: Context) -> Optional[Image]:
        if not self.file_pattern:
            return f
        from nightlight_tpu_torch.pipeline.ops_post import check_align_drop

        f = check_align_drop(f, c)
        if f is None:
            return None
        c.flush_log()
        saved = f
        if isinstance(f.data, pm.RowSharded):
            # the writers take the pixels whole; the frame passes on sharded
            saved = dataclasses.replace(f, data=pm.gather(f.data, "save"))
        file_name = self.file_pattern
        if re.search(r"%0?\d*d", file_name):
            file_name = file_name % f.id
        fn_lower = file_name.lower()

        mode = ExportMode(self.export_mode)
        if mode == ExportMode.MinMax:
            vmin, vmax = f.stats.min, f.stats.max
        elif mode == ExportMode.Zero1:
            vmin, vmax = 0.0, 1.0
        elif mode == ExportMode.Zero255:
            vmin, vmax = 0.0, 255.0
        else:
            vmin, vmax = 0.0, 65535.0

        if fn_lower.endswith(_FITS_SUFFIXES):
            c.logf("%d: Writing %s pixel FITS to %s\n", f.id, f.dimensions_string(), file_name)
            from nightlight_tpu_torch.io.fits import write_file

            write_file(saved, file_name)
        elif fn_lower.endswith((".tiff", ".tif")):
            from nightlight_tpu_torch.io.tiff import write_mono_tiff16, write_tiff16

            if len(f.naxisn) == 2:
                c.logf("%d: Writing %s pixel mono 16-bit TIFF to %s with min=%g max=%g...\n",
                       f.id, f.dimensions_string(), file_name, vmin, vmax)
                write_mono_tiff16(saved, file_name, vmin, vmax, self.gamma)
            elif len(f.naxisn) == 3 and f.naxisn[2] == 3:
                c.logf("%d: Writing %s pixel color 16-bit TIFF to %s with min=%g max=%g...\n",
                       f.id, f.dimensions_string(), file_name, vmin, vmax)
                write_tiff16(saved, file_name, vmin, vmax, self.gamma)
            else:
                raise ValueError(f"{f.id}: unable to write {f.dimensions_string()} pixel "
                                 f"image as 16-bit TIFF to {file_name}")
        elif fn_lower.endswith((".jpeg", ".jpg")):
            from nightlight_tpu_torch.io.jpeg import write_jpg, write_mono_jpg

            if len(f.naxisn) == 2:
                c.logf("%d: Writing %s pixel mono JPEG to %s with min=%g max=%g gamma=%g...\n",
                       f.id, f.dimensions_string(), file_name, vmin, vmax, self.gamma)
                write_mono_jpg(saved, file_name, vmin, vmax, self.gamma, 95)
            elif len(f.naxisn) == 3 and f.naxisn[2] == 3:
                c.logf("%d: Writing %s pixel color JPEG to %s with min=%g max=%g gamma=%g...\n",
                       f.id, f.dimensions_string(), file_name, vmin, vmax, self.gamma)
                write_jpg(saved, file_name, vmin, vmax, self.gamma, 95)
            else:
                raise ValueError(f"{f.id}: unable to write {f.dimensions_string()} pixel "
                                 f"image as JPEG to {file_name}")
        else:
            ext = os.path.splitext(file_name)[1]
            raise ValueError(f'unknown suffix "{ext}" for file {file_name}')
        return f


@register
class OpSequence(Operator):
    """Chain of steps; wiring is recursive make_promises (operator.go:465-553)."""

    TYPE = "seq"
    PARAMS = {}

    def __init__(self, steps=None, **kwargs):
        super().__init__(**kwargs)
        self.steps: list[Operator] = list(steps or [])

    def append(self, *steps):
        self.steps.extend(steps)

    def to_dict(self) -> dict:
        return {"type": self.TYPE, "steps": [s.to_dict() for s in self.steps]}

    @classmethod
    def from_dict(cls, d: dict) -> "OpSequence":
        return cls(steps=[op_from_dict(s) for s in d.get("steps", [])])

    def make_promises(self, ins, c):
        for step in self.steps:
            ins = step.make_promises(ins, c)
        return ins
