"""The port's read-ahead loader (nightlight_tpu_torch/io/ingest.py) held
against the JAX package's loaders (nightlight_tpu/io/ingest.py's
BulkUploader and prefetch_frames, pipeline/operators.py's
_DecodePrefetcher) and against the readers of both packages, on the CPU,
on BITPIX-16 frames written as tests/test_ingest.py writes them. Every
frame is compared bit for bit."""

import io
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from nightlight_tpu.image import Image as JImage
from nightlight_tpu.io import fits as jfits
from nightlight_tpu.io.ingest import BulkUploader, prefetch_frames as jprefetch_frames
from nightlight_tpu.pipeline.operators import _DecodePrefetcher
from nightlight_tpu_torch.image import Image as TImage
from nightlight_tpu_torch.io import fits as tfits
from nightlight_tpu_torch.io import ingest
from nightlight_tpu_torch.io.ingest import ReadAheadLoader
from test_ingest import _write_int16

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 24, 32
FRAME_BYTES = H * W * 2


def _gen(tmp_path, rng, n, h=H, w=W):
    names = []
    for i in range(n):
        p = tmp_path / f"bulk{i:03d}.fits"
        _write_int16(p, rng.integers(100, 60000, size=(h, w)).astype(np.uint16))
        names.append(str(p))
    return names


def _float_frame(tmp_path, rng, name, h=H, w=W):
    p = str(tmp_path / name)
    tfits.write_file(TImage.from_numpy(rng.normal(500.0, 10.0, size=(h, w)).astype(np.float32)),
                     p)
    return p


def _loader(names, **kwargs):
    kwargs.setdefault("frame_bytes", FRAME_BYTES)
    return ReadAheadLoader(list(enumerate(names)), io.StringIO(), "cpu", **kwargs)


def _same_as_readers(img, name, id_):
    """img bit for bit the port's read_file and the JAX package's, with the
    same header fields and statistics."""
    ref = tfits.read_file(name, id=id_, log=io.StringIO())
    jref = jfits.read_file(name, id=id_, log=io.StringIO(), to_device=True)
    got = img.data.numpy()
    assert np.array_equal(got, ref.data.numpy())
    assert np.array_equal(got, np.asarray(jref.data))
    assert (img.id, img.naxisn, img.bitpix, img.exposure) == (
        ref.id, ref.naxisn, ref.bitpix, ref.exposure)
    assert (img.bzero, img.bscale) == (0.0, 1.0)
    assert (img.stats.min, img.stats.mean, img.stats.max) == (
        ref.stats.min, ref.stats.mean, ref.stats.max)


@pytest.fixture(autouse=True)
def no_reader_dies(monkeypatch):
    """Every test fails if a thread (a loader's reader) ends in an
    exception: a reader hands each read's error to `get`, nothing else."""
    died = []
    monkeypatch.setattr(threading, "excepthook", died.append)
    yield
    assert not died, [d.exc_value for d in died]


def _run_bounded(fn, seconds=60):
    """fn() on a thread that must finish within `seconds` (a deadlock
    fails the test instead of hanging it)."""
    errors = []

    def run():
        try:
            fn()
        except Exception as e:  # noqa: BLE001 - surfaced in the assertion
            errors.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), "deadlocked"
    if errors:
        raise errors[0]


def _admissions(loader, monkeypatch):
    """The names the loader admits from now on, in order."""
    seen = []
    admit = loader._admit_frame

    def record(name):
        seen.append(name)
        admit(name)

    monkeypatch.setattr(loader, "_admit_frame", record)
    return seen


def test_ingest_imports_no_jax():
    """io/ingest.py, imported alone in a fresh interpreter, leaves jax and
    nightlight_tpu out of sys.modules."""
    code = ("import sys\nimport nightlight_tpu_torch.io.ingest\n"
            "print('BAD', [m for m in sys.modules if m in ('jax', 'nightlight_tpu')"
            " or m.startswith(('jax.', 'nightlight_tpu.'))])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


@pytest.mark.parametrize("mode", ["window", "lookahead"])
def test_frames_match_read_file_and_jax(tmp_path, rng, mode):
    """Every frame through the loader, in spec order, is bit for bit the
    port's read_file and the JAX package's, and the JAX BulkUploader's
    frame; both gates (the byte window of try_create, the decode-ahead
    lookahead of OpLoadMany's fallback)."""
    names = _gen(tmp_path, rng, 10)
    kwargs = {} if mode == "window" else {"window_bytes": None, "lookahead": 6}
    loader = _loader(names, **kwargs)
    up = BulkUploader(list(enumerate(names)), io.StringIO(), frame_bytes=FRAME_BYTES)
    try:
        for i, name in enumerate(names):
            img = loader.get(name)
            _same_as_readers(img, name, i)
            assert np.array_equal(img.data.numpy(), np.asarray(up.get(name).data))
    finally:
        loader.close()


def test_reorder_keeps_reading_within_the_batch(tmp_path, rng, monkeypatch):
    """After reorder(batch), the readers take the batch's frames in its
    order and only then fall back to spec order: with room for 2 frames,
    nothing is read before the first call, the announcement admits the
    batch's first two frames, each consumption admits its next one, and
    the frames of the next batch come in only when batch 1 is exhausted
    (BulkUploader never uploads another batch's frames before it is
    announced)."""
    names = _gen(tmp_path, rng, 12)
    loader = _loader(names, window_bytes=2 * FRAME_BYTES)
    seen = _admissions(loader, monkeypatch)
    try:
        batch1 = [names[i] for i in (1, 4, 7, 10)]
        batch2 = [n for n in names if n not in batch1]
        assert not loader._frames
        loader.reorder(batch1)
        assert seen == batch1[:2]
        for n in batch1:
            _same_as_readers(loader.get(n), n, names.index(n))
        assert seen == batch1 + [names[0], names[2]]
        loader.reorder(batch2)
        for n in batch2:
            _same_as_readers(loader.get(n), n, names.index(n))
        assert seen[6:] == [n for n in batch2 if n not in (names[0], names[2])]
    finally:
        loader.close()


@pytest.mark.parametrize("mode", ["window", "lookahead"])
def test_out_of_order_and_repeat_consumption(tmp_path, rng, mode):
    """Reverse consumption, then a second get of a consumed frame, which
    reads it directly, as BulkUploader does."""
    names = _gen(tmp_path, rng, 6)
    kwargs = {"window_bytes": 2 * FRAME_BYTES} if mode == "window" else {
        "window_bytes": None, "lookahead": 2}
    loader = _loader(names, **kwargs)
    try:
        for name in reversed(names):
            _same_as_readers(loader.get(name), name, names.index(name))
        _same_as_readers(loader.get(names[0]), names[0], 0)
    finally:
        loader.close()


@pytest.mark.parametrize("mode", ["window", "lookahead"])
def test_permuted_consumption_does_not_deadlock(tmp_path, rng, mode):
    """Consuming in exact reverse spec order with 2 readers and room for 2
    frames (TestDecodePrefetcherOrdering's worst case) completes: the
    consumer reads what no reader has started. The same order through
    the JAX _DecodePrefetcher gives the same frames."""
    names = [_float_frame(tmp_path, rng, f"pf{i}.fits", 16, 16) for i in range(8)]
    kwargs = {"window_bytes": 2 * 16 * 16 * 4} if mode == "window" else {
        "window_bytes": None, "lookahead": 2}
    loader = _loader(names, frame_bytes=16 * 16 * 4, depth=2, **kwargs)
    jpf = _DecodePrefetcher(list(enumerate(names)), io.StringIO(), depth=2, lookahead=2)
    got = {}

    def consume():
        for name in reversed(names):
            got[name] = loader.get(name)

    try:
        _run_bounded(consume)
    finally:
        loader.close()
    for name in reversed(names):
        assert np.array_equal(got[name].data.numpy(), np.asarray(jpf.get(name).data))


def test_reader_skips_frames_the_consumer_took(tmp_path, rng):
    """Frames admitted for the readers but claimed and taken by the
    consumer before any reader came to them: the reader that pops them
    afterwards skips them and reads the rest."""
    names = _gen(tmp_path, rng, 6)
    loader = _loader(names, depth=0)  # every frame admitted, no reader yet
    try:
        for n in names[:3]:
            _same_as_readers(loader.get(n), n, names.index(n))
        loader._work()  # a reader now, on this thread, until the queue is empty
        for n in names[3:]:
            _same_as_readers(loader.get(n), n, names.index(n))
        assert loader.inline_reads == 3
    finally:
        loader.close()


def test_concurrent_get_from_several_threads(tmp_path, rng):
    """24 frames taken by 6 threads at once, each a sixth of a random
    permutation, beside 6 readers (more threads than this host's cores,
    the switch interval shortened; BulkUploader's concurrent consumption
    test): every frame right, and the window's books back at zero, which
    a lost update of the shared counters would break."""
    names = _gen(tmp_path, rng, 24)
    loader = _loader(names, window_bytes=3 * FRAME_BYTES, depth=6)
    results, errors = {}, []

    def worker(sub):
        try:
            for n in sub:
                results[n] = loader.get(n)
        except Exception as e:  # noqa: BLE001 - surfaced in the assertion
            errors.append(e)

    perm = list(rng.permutation(len(names)))
    threads = [threading.Thread(target=worker, args=([names[i] for i in perm[j::6]],))
               for j in range(6)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        books = (loader._ahead_bytes, loader._ahead_frames, len(loader._frames))
    finally:
        sys.setswitchinterval(old)
        loader.close()
    assert not any(t.is_alive() for t in threads) and not errors
    assert books == (0, 0, 0)
    for i, name in enumerate(names):
        _same_as_readers(results[name], name, i)


def test_prefetch_ahead_respects_budget_and_order(tmp_path, rng, monkeypatch):
    """With the window full, prefetch_ahead admits a future batch's frames
    in its order until their raw bytes pass the budget: 4 frames of 4
    frames' budget, as the JAX BulkUploader dispatches 4 with groups of 2;
    a zero budget admits nothing. Every frame then decodes bit for bit."""
    names = _gen(tmp_path, rng, 12)
    batch1, batch2 = names[:6], names[6:]
    up = BulkUploader(list(enumerate(names)), io.StringIO(), frame_bytes=FRAME_BYTES)
    up.GROUP_BYTES = 2 * FRAME_BYTES
    up.reorder(batch1)
    loader = _loader(names, window_bytes=2 * FRAME_BYTES)
    try:
        loader.reorder(batch1)  # the window is full with batch 1's first two
        seen = _admissions(loader, monkeypatch)
        assert loader.prefetch_ahead(batch2, 0) == 0 and seen == []
        n = loader.prefetch_ahead(batch2, 4 * FRAME_BYTES)
        assert n == up.prefetch_ahead(batch2, 4 * FRAME_BYTES) == 4
        assert seen == batch2[:4]
        assert loader.prefetch_ahead(batch2, 4 * FRAME_BYTES) == 2  # the two left
        for nm in batch1 + batch2:
            _same_as_readers(loader.get(nm), nm, names.index(nm))
    finally:
        loader.close()


def test_prefetch_ahead_without_a_byte_window_admits_nothing(tmp_path, rng):
    """The decode-ahead gate (the JAX _DecodePrefetcher) prefetches no next
    batch."""
    names = _gen(tmp_path, rng, 6)
    loader = _loader(names, window_bytes=None, lookahead=1)
    try:
        assert loader.prefetch_ahead(names[3:], 1 << 30) == 0
    finally:
        loader.close()


@pytest.mark.parametrize("case", ["int16", "too_few", "float32_lead", "tiff_lead"])
def test_try_create_gates_equal_bulk_uploaders(tmp_path, rng, case):
    """try_create builds a loader exactly where BulkUploader.try_create
    does: BITPIX 8/16 in the first header, at least 4 frames, not TIFF."""
    names = _gen(tmp_path, rng, 4)
    if case == "too_few":
        names = names[:2]
    elif case == "float32_lead":
        names = [_float_frame(tmp_path, rng, "f32lead.fits", 8, 8)] + names
    elif case == "tiff_lead":
        from PIL import Image as PILImage

        lead = str(tmp_path / "lead.tif")
        PILImage.fromarray(rng.integers(0, 65535, size=(8, 8)).astype(np.uint16)).save(lead)
        names = [lead] + names
    specs = list(enumerate(names))
    loader = ReadAheadLoader.try_create(specs, io.StringIO(), "cpu")
    jax_up = BulkUploader.try_create(specs, io.StringIO())
    assert (loader is None) == (jax_up is None) == (case != "int16")
    if loader is not None:
        loader.close()


def test_mixed_shapes_and_bitpix(tmp_path, rng):
    """A different-shaped int16 frame, a float32 frame and a gzipped int16
    frame among int16 frames: each read as read_file reads it (the float
    one decoded on the host with its statistics), as the JAX
    BulkUploader's fallback does."""
    import gzip
    import shutil

    names = _gen(tmp_path, rng, 4)
    odd = tmp_path / "odd_shape.fits"
    _write_int16(odd, rng.integers(0, 65535, size=(16, 16)).astype(np.uint16))
    gz = str(tmp_path / "zipped.fits.gz")
    _write_int16(tmp_path / "zipped.fits", rng.integers(0, 65535, size=(H, W)).astype(np.uint16))
    with open(tmp_path / "zipped.fits", "rb") as f, gzip.open(gz, "wb") as g:
        shutil.copyfileobj(f, g)
    all_names = names[:2] + [str(odd), _float_frame(tmp_path, rng, "float32.fits"), gz] + names[2:]
    loader = ReadAheadLoader.try_create(list(enumerate(all_names)), io.StringIO(), "cpu")
    up = BulkUploader(list(enumerate(all_names)), io.StringIO(), frame_bytes=FRAME_BYTES)
    try:
        for i, name in enumerate(all_names):
            img = loader.get(name)
            _same_as_readers(img, name, i)
            assert np.array_equal(img.data.numpy(), np.asarray(up.get(name).data))
    finally:
        loader.close()


def _unreadable(tmp_path, rng, kind):
    if kind == "missing":
        return str(tmp_path / "missing.fits")
    p = tmp_path / "truncated.fits"
    _write_int16(p, rng.integers(0, 65535, size=(H, W)).astype(np.uint16))
    with open(p, "r+b") as f:
        f.truncate(2880 + 100)
    return str(p)


@pytest.mark.parametrize("where", ["worker", "inline"])
@pytest.mark.parametrize("kind", ["missing", "truncated"])
def test_unreadable_file_raises_read_files_error(tmp_path, rng, kind, where):
    """A missing or truncated file raises from get the error that a direct
    read_file gives, whether a worker read it or the consumer read it
    inline; the frames after it still load."""
    bad = _unreadable(tmp_path, rng, kind)
    names = [bad] + _gen(tmp_path, rng, 3)
    with pytest.raises(Exception) as direct:
        tfits.read_file(bad, id=0, log=io.StringIO())
    if where == "worker":
        loader = _loader(names)
        loader.reorder(names)  # the readers start
        _run_bounded(loader._frames[bad].done.wait)
    else:
        loader = _loader(names, depth=0)  # no reader: the consumer reads each frame
    try:
        with pytest.raises(type(direct.value)) as got:
            loader.get(bad)
        assert str(got.value) == str(direct.value)
        assert loader.inline_reads == (where == "inline")
        for i, name in enumerate(names[1:], 1):
            _same_as_readers(loader.get(name), name, i)
    finally:
        loader.close()


def test_prefetch_frames_in_order_with_ids(tmp_path, rng):
    """prefetch_frames yields every frame in order with ids 0..n-1, the
    same frames as the JAX package's prefetch_frames."""
    names = []
    for i in range(7):
        img = JImage.from_naxisn([32, 32], rng.normal(i * 10.0, 1, size=(32, 32))
                                 .astype(np.float32))
        names.append(str(tmp_path / f"f{i}.fits"))
        jfits.write_file(img, names[-1])
    names += _gen(tmp_path, rng, 3)
    got = list(ingest.prefetch_frames(names, depth=3))
    want = list(jprefetch_frames(names, depth=3, to_device=False))
    assert [o.id for o in got] == [o.id for o in want] == list(range(10))
    for g, w in zip(got, want):
        assert np.array_equal(g.data.numpy(), np.asarray(w.data))


def test_prefetch_frames_empty_and_errors(tmp_path):
    assert list(ingest.prefetch_frames([], depth=2)) == []
    missing = str(tmp_path / "missing.fits")
    with pytest.raises(FileNotFoundError) as got:
        list(ingest.prefetch_frames([missing]))
    with pytest.raises(FileNotFoundError) as want:
        list(jprefetch_frames([missing], to_device=False))
    assert str(got.value) == str(want.value)


def test_loadmany_builds_the_loader_and_context_close_stops_it(tmp_path, rng, monkeypatch):
    """OpLoadMany gives every load promise the loader of try_create (the
    JAX package's BulkUploader gate), the run's Context owns it, the loaded
    images match read_file, and Context.close() stops its readers;
    NIGHTLIGHT_NO_PREFETCH=1 (which only stops the next-batch prefetch)
    builds it all the same."""
    from nightlight_tpu_torch.pipeline.context import new_context
    from nightlight_tpu_torch.pipeline.operators import OpLoadMany, materialize_all

    names = _gen(tmp_path, rng, 6)
    monkeypatch.chdir(tmp_path)
    c = new_context(log=io.StringIO(), device="cpu")
    ps = OpLoadMany(file_patterns=["bulk*.fits"]).make_promises([], c)
    loader = ps[0].op._prefetcher
    assert isinstance(loader, ReadAheadLoader) and c._owned == [loader]
    assert all(p.op._prefetcher is loader for p in ps)
    # nothing is read before the first load (the batch planner measures
    # the device's memory then)
    assert not loader._running and not loader._frames
    images, err = materialize_all(ps)
    assert err is None
    for i, (img, name) in enumerate(zip(images, names)):
        _same_as_readers(img, name, i)
    c.close()
    assert loader._closed and not any(t.is_alive() for t in loader._threads)
    assert c._owned == []

    monkeypatch.setenv("NIGHTLIGHT_NO_PREFETCH", "1")
    ps = OpLoadMany(file_patterns=["bulk*.fits"]).make_promises([], c)
    assert isinstance(ps[0].op._prefetcher, ReadAheadLoader)
    assert c._owned == [ps[0].op._prefetcher]
    c.close()


@pytest.mark.parametrize("no_prefetch", [False, True])
def test_prefetch_next_matches_jax_and_honours_no_prefetch(monkeypatch, no_prefetch):
    """OpStackBatches._prefetch_next asks the next batch's loader for the
    reserve's bytes and logs the "Prefetched" line as the JAX package's
    does; NIGHTLIGHT_NO_PREFETCH=1 stops it in both."""
    import types

    from nightlight_tpu.pipeline.context import new_context as jnew_context
    from nightlight_tpu.pipeline.ops_stack import OpStackBatches as JOpStackBatches
    from nightlight_tpu_torch.pipeline.context import new_context
    from nightlight_tpu_torch.pipeline.ops_stack import OpStackBatches

    if no_prefetch:
        monkeypatch.setenv("NIGHTLIGHT_NO_PREFETCH", "1")

    class Loader:
        def __init__(self):
            self.calls = []

        def prefetch_ahead(self, names, max_bytes):
            self.calls.append((list(names), max_bytes))
            return len(names) - 1

    got = {}
    for side, stacker, ctx in (("jax", JOpStackBatches, jnew_context),
                               ("port", OpStackBatches, new_context)):
        loader, log = Loader(), io.StringIO()
        batch = [types.SimpleNamespace(op=types.SimpleNamespace(
            file_name=f"light{i:03d}.fits", _prefetcher=loader)) for i in (4, 1, 7)]
        op = stacker()
        op._prefetch_bytes = 3 * FRAME_BYTES
        op._prefetch_next(batch, ctx(log=log, **({} if side == "jax" else {"device": "cpu"})))
        op._prefetch_next([], ctx(log=log, **({} if side == "jax" else {"device": "cpu"})))
        got[side] = (loader.calls, log.getvalue())
    assert got["port"] == got["jax"]
    calls, text = got["port"]
    if no_prefetch:
        assert calls == [] and text == ""
    else:
        assert calls == [(["light004.fits", "light001.fits", "light007.fits"], 3 * FRAME_BYTES)]
        assert text == "Prefetched 2 frames of the next batch during this batch's compute.\n"


def test_planner_counts_the_allocators_cache_as_free(monkeypatch):
    """The batch planner's device memory is the card's free memory plus
    what PyTorch's allocator holds cached and unused, so that the plan
    (the "this fits" and "Using ... random batches" lines, the prefetch
    reserve) does not move with the cache: the same sum split two ways
    plans the same, and the same free memory with the cache left out
    plans fewer frames. On the CPU the JAX package's unbounded answer."""
    from nightlight_tpu_torch import cli
    from nightlight_tpu_torch.models.presets import build_command_seq
    from nightlight_tpu_torch.pipeline.context import new_context
    from nightlight_tpu_torch.pipeline.ops_stack import OpStackBatches

    monkeypatch.setattr(os, "cpu_count", lambda: 8)
    card = torch.device("cuda:0")
    gib = 1 << 30
    memory = {}
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d=None: (memory["free"], 80 * gib))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda d=None: memory["reserved"])
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda d=None: memory["allocated"])

    args = cli.build_parser().parse_args(["-dark", "dark.fits", "stack", "light*.fits"])
    cli.apply_command_defaults(args)
    planner = next(s for s in build_command_seq(args).steps if isinstance(s, OpStackBatches))

    class Frame:
        naxisn = [4096, 4096]
        file_name = "plan"

    def plan(free, reserved, allocated):
        memory.update(free=free, reserved=reserved, allocated=allocated)
        mib = OpStackBatches._device_memory_mb(card)
        log = io.StringIO()
        c = new_context(log=log, st_memory=1 << 20, device=card)
        _, batches, size, threads = planner._partition([Frame] * 48, c)
        return mib, (batches, size, threads, planner._prefetch_bytes), [
            ln for ln in log.getvalue().splitlines() if "fits" in ln or "Using" in ln]

    split_a = plan(12 * gib, 5 * gib, 1 * gib)  # 12 GiB free + 4 GiB cached, unused
    split_b = plan(16 * gib, 1 * gib, 1 * gib)  # 16 GiB free, nothing cached
    assert split_a[0] == split_b[0] == 16 * 1024
    assert split_a[1:] == split_b[1:]
    assert split_a[1][0] > 1 and split_a[1][3] > 0  # out of core, with a reserve
    free_only = plan(12 * gib, 1 * gib, 1 * gib)
    assert free_only[0] == 12 * 1024
    assert free_only[1][1] < split_a[1][1]  # smaller batches
    assert OpStackBatches._device_memory_mb(torch.device("cpu")) == 1 << 30
