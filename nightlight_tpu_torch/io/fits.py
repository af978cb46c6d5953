"""FITS reader/writer of the port.

Mirror of nightlight_tpu/io/fits.py (reference: internal/fits/read.go,
write.go): 2880-byte header blocks of 80-character lines parsed with the
same grammar, BITPIX 8/16/32/64/-32/-64 big-endian payloads with BZERO/
BSCALE folded in, transparent gzip, TIFF input by suffix. Integer payloads
of BITPIX 8 and 16 are read straight into a caller's buffer (`readinto`),
go to the device raw (half or a quarter of the float32 bytes) and are
byte-swapped and scaled there by torch (decode_raw); the wider types are
decoded by numpy on the host. read_raw splits reading from decoding for
the read-ahead loader (io/ingest.py). The writer emits byte-identical
files to the JAX package's writer.

Given a device mesh (parallel/mesh.py, ``Context.mesh``), a 2-D frame
whose rows divide the mesh is read row-sharded: its rows are contiguous
byte ranges of the payload, so each shard's range is copied from the host
buffer straight to that shard's device and decoded there (the JAX
package's ``device_put_sharded_rows``); no such frame passes whole through
the lead device. A float payload, decoded on the host, goes from there to
the shards (``place_on_mesh``). Any other frame arrives on the lead device,
and OpLoad places it.
"""

from __future__ import annotations

import gzip
import re
import sys
from typing import BinaryIO

import numpy as np
import torch

from nightlight_tpu_torch import trace
from nightlight_tpu_torch.image import FITS_BLOCK_SIZE, HEADER_LINE_SIZE, Header, Image
from nightlight_tpu_torch.ops.stats import Stats
from nightlight_tpu_torch.parallel import mesh as pm

# Header line grammar, mirroring compileRE (read.go:525-559).
_WHITE = rb"\s+"
_WHITE_OPT = rb"\s*"
_HIST_LINE = rb"HISTORY" + _WHITE + rb"(?P<H>.*)"
_COMM_LINE = rb"COMMENT" + _WHITE + rb"(?P<C>.*)"
_END_LINE = rb"(?P<E>END)" + _WHITE_OPT
_KEY = rb"(?P<k>[A-Z0-9_-]+)"
_BOOL = rb"(?P<b>[TF])"
_INT = rb"(?P<i>[+-]?[0-9]+)"
_FLOAT = rb"(?P<f>[+-]?[0-9]*\.[0-9]*(?:[ED][-+]?[0-9]+)?)"
_STRING = rb"'(?P<s>[^']*)'"
_DATE = rb"(?P<d>[0-9]{1,4}-?[012][0-9]-?[0123][0-9]T[012][0-9]:?[0-5][0-9]:?[0-5][0-9].?[0-9]*)"
_VAL = rb"(?:" + _BOOL + rb"|" + _INT + rb"|" + _FLOAT + rb"|" + _STRING + rb"|" + _DATE + rb")"
_COMM_OPT = rb"(?:/(?P<c>.*))?"
_KEY_LINE = _KEY + _WHITE_OPT + rb"=" + _WHITE_OPT + _VAL + _WHITE_OPT + _COMM_OPT
_LINE_RE = re.compile(
    rb"^(?:" + _WHITE + rb"|" + _HIST_LINE + rb"|" + _COMM_LINE + rb"|" + _KEY_LINE
    + rb"|" + _END_LINE + rb")$")

_BITPIX_DTYPES = {
    8: np.dtype(">u1"),
    16: np.dtype(">i2"),
    32: np.dtype(">i4"),
    64: np.dtype(">i8"),
    -32: np.dtype(">f4"),
    -64: np.dtype(">f8"),
}


@trace.span("load")
def read_file(file_name: str, id: int = 0, log=None, read_data: bool = True,
              device="cpu", mesh=None) -> Image:
    """Read a FITS (or TIFF) image from a file (read.go:34-73), its pixels
    on `device`. Given `mesh`, a FITS frame that the mesh shards by rows
    has each shard's rows uploaded straight to its device; what else the
    mesh places (a TIFF, integer rows that do not divide) arrives on
    `device` for the caller to place (OpLoad)."""
    lower = file_name.lower()
    if lower.endswith((".tif", ".tiff")):
        from nightlight_tpu_torch.io.tiff import read_tiff

        return read_tiff(file_name, id=id, device=device)
    img = Image(id=id, file_name=file_name)
    opener = gzip.open if lower.endswith((".gz", ".gzip")) else open
    with opener(file_name, "rb") as f:
        read(img, f, read_data=read_data, log=log, device=device, mesh=mesh)
    return img


def read(img: Image, f: BinaryIO, read_data: bool = True, log=None, device="cpu",
         mesh=None) -> Image:
    """Read a FITS stream into an Image (read.go:94-142)."""
    log = log or sys.stdout
    _read_header(img.header, f, img.id, log)

    h = img.header
    if not h.bools.get("SIMPLE", False):
        raise ValueError(f"{img.id}: Not a valid FITS file; SIMPLE=T missing in header")
    h.bools.pop("SIMPLE", None)

    img.bitpix = int(_pop_int(h, "BITPIX", img.id))
    naxis = int(_pop_int(h, "NAXIS", img.id))
    img.naxisn = []
    pixels = 1
    for i in range(1, naxis + 1):
        n = int(_pop_int(h, f"NAXIS{i}", img.id))
        img.naxisn.append(n)
        pixels *= n

    img.bzero = _pop_number(h, "BZERO", 0.0)
    img.bscale = _pop_number(h, "BSCALE", 1.0)
    exposure = _pop_number(h, "EXPOSURE", None)
    if exposure is None:
        exposure = _pop_number(h, "EXPTIME", 0.0)
    img.exposure = float(exposure)

    if not read_data:
        return img
    return _read_payload(img, f, pixels, log, device, mesh)


def _pop_int(h: Header, key: str, id: int) -> int:
    if key in h.ints:
        return h.ints.pop(key)
    raise ValueError(f"{id}: FITS header does not contain key {key}")


def _pop_number(h: Header, key: str, default):
    if key in h.ints:
        return float(h.ints.pop(key))
    if key in h.floats:
        return float(h.floats.pop(key))
    return default


def _read_header(h: Header, f: BinaryIO, id: int, log) -> None:
    """Parse 2880-byte header units until END (read.go:445-469)."""
    h.length = 0
    while not h.end:
        buf = f.read(FITS_BLOCK_SIZE)
        if len(buf) != FITS_BLOCK_SIZE:
            raise ValueError(f"{id}: unexpected EOF in FITS header")
        h.length += len(buf)
        for line_no in range(FITS_BLOCK_SIZE // HEADER_LINE_SIZE):
            if h.end:
                break
            line = buf[line_no * HEADER_LINE_SIZE:(line_no + 1) * HEADER_LINE_SIZE]
            m = _LINE_RE.match(line)
            if m is None:
                print(f"{id}: Warning:Cannot parse '{line.decode('ascii', 'replace')}', ignoring",
                      file=log)
                continue
            _read_line(h, m)


def _read_line(h: Header, m: re.Match) -> None:
    """Apply one parsed header line (read.go:471-511)."""
    g = m.groupdict()
    if g.get("E") is not None:
        h.end = True
        return
    if g.get("H") is not None:
        h.history.append(g["H"].decode("ascii", "replace"))
        return
    if g.get("C") is not None:
        h.comments.append(g["C"].decode("ascii", "replace"))
        return
    key_b = g.get("k")
    if key_b is None:
        return
    key = key_b.decode("ascii")
    if g.get("b") is not None:
        h.bools[key] = g["b"] in (b"t", b"T")
    elif g.get("i") is not None:
        h.ints[key] = int(g["i"])
    elif g.get("f") is not None:
        h.floats[key] = float(g["f"].decode("ascii").replace("D", "E").replace("d", "e"))
    elif g.get("s") is not None:
        h.strings[key] = g["s"].decode("ascii", "replace")
    elif g.get("d") is not None:
        h.dates[key] = g["d"].decode("ascii", "replace")


def _read_payload(img: Image, f: BinaryIO, pixels: int, log, device, mesh=None) -> Image:
    """Decode the payload to float32 (read.go:145-443)."""
    dtype = _payload_dtype(img, log)
    if img.bitpix in (8, 16):
        buf = torch.from_numpy(np.empty(pixels * dtype.itemsize, dtype=np.uint8))
        _read_into(f, buf.numpy(), img.id)
        slices = raw_row_slices(img, buf, mesh)
        if slices is not None:
            return attach_raw_sharded(img, [pm._to(s, dev) for s, dev
                                            in zip(slices, mesh.devices)], mesh)
        return attach_raw(img, trace.upload(buf, device))

    raw = f.read(pixels * dtype.itemsize)
    if len(raw) < pixels * dtype.itemsize:
        raise ValueError(f"{img.id}: unexpected EOF in FITS data")
    data, vmin, vmean, vmax = decode_payload(raw, dtype, pixels, img.bscale, img.bzero)
    img.bzero, img.bscale = 0.0, 1.0  # folded in (read.go:205)
    host = torch.from_numpy(data.reshape(tuple(reversed(img.naxisn))))
    # under a mesh each shard's rows go from the host to their device
    img.data = host.to(device) if mesh is None else pm.place_on_mesh(host, mesh)
    img.stats = Stats.with_mmm(img.data, img.naxisn[0], vmin, vmax, vmean)
    return img


def _payload_dtype(img: Image, log) -> np.dtype:
    """The payload's dtype, with the reference's precision warnings."""
    dtype = _BITPIX_DTYPES.get(img.bitpix)
    if dtype is None:
        raise ValueError(f"{img.id}: Unknown BITPIX value {img.bitpix}")
    if img.bitpix in (32, 64):
        print(f"{img.id}: Warning: loss of precision converting int{img.bitpix} to float32 values",
              file=log)
    elif img.bitpix == -64:
        print(f"{img.id}: Warning: loss of precision converting float64 to float32 values",
              file=log)
    return dtype


def _read_into(f: BinaryIO, buf, id: int) -> None:
    """Fill `buf` (a writable uint8 buffer) from `f`; a short file raises
    the reader's EOF error."""
    view = memoryview(buf).cast("B")
    got = 0
    while got < len(view):
        n = f.readinto(view[got:])
        if not n:
            raise ValueError(f"{id}: unexpected EOF in FITS data")
        got += n


def _host_buffer(nbytes: int) -> torch.Tensor:
    return torch.from_numpy(np.empty(nbytes, dtype=np.uint8))


def read_raw(file_name: str, id: int = 0, log=None, alloc=_host_buffer):
    """Header parse and the UNDECODED payload, for the read-ahead loader
    (io/ingest.py); mirror of nightlight_tpu/io/fits.py:read_raw.

    Returns ``(img, raw)``. For BITPIX 8/16 payloads ``raw`` is a uint8 CPU
    tensor of the big-endian payload bytes, read straight into
    ``alloc(nbytes)`` (a host tensor of exactly that size; a pinned one
    lets the copy to the card run asynchronously), and ``img.data`` is
    unset: attach_raw decodes it once ``raw`` is on its device. Other
    payloads (float, wider integers, TIFF) are decoded on the host as
    read_file does, ``img.data`` a CPU tensor with its min/mean/max, and
    ``raw`` is None. Header semantics and errors are read_file's."""
    lower = file_name.lower()
    if lower.endswith((".tif", ".tiff")):
        from nightlight_tpu_torch.io.tiff import read_tiff

        return read_tiff(file_name, id=id), None
    img = Image(id=id, file_name=file_name)
    opener = gzip.open if lower.endswith((".gz", ".gzip")) else open
    with opener(file_name, "rb") as f:
        read(img, f, read_data=False, log=log)
        pixels = 1
        for n in img.naxisn:
            pixels *= n
        if img.bitpix not in (8, 16):
            return _read_payload(img, f, pixels, log, "cpu"), None
        raw = alloc(pixels * _payload_dtype(img, log).itemsize)
        _read_into(f, raw.numpy(), id)
    return img, raw


def attach_raw(img: Image, raw: torch.Tensor) -> Image:
    """Decode `raw`, a BITPIX 8/16 payload already on its device, into
    img.data, BZERO/BSCALE folded in, with lazy statistics."""
    shape = tuple(reversed(img.naxisn))
    img.data = decode_raw(raw, img.bitpix, img.bscale, img.bzero).reshape(shape)
    img.bzero, img.bscale = 0.0, 1.0
    img.stats = Stats(img.data, img.naxisn[0])
    return img


def raw_row_slices(img: Image, raw: torch.Tensor, mesh):
    """The byte ranges of a raw 2-D payload that hold each mesh shard's rows
    (views of `raw`, in mesh order), or None without a mesh, for a cube, or
    where the rows do not divide the mesh."""
    if mesh is None or len(img.naxisn) != 2 or not pm.divides(mesh, img.naxisn[::-1]):
        return None
    step = raw.numel() // mesh.size
    return [raw[k * step:(k + 1) * step] for k in range(mesh.size)]


def attach_raw_sharded(img: Image, raws: list, mesh) -> Image:
    """attach_raw of a 2-D frame whose shards' raw rows are each on their
    mesh device already: each decoded there, img.data a RowSharded."""
    w, h = img.naxisn
    rows = h // mesh.size
    blocks = [decode_raw(r, img.bitpix, img.bscale, img.bzero).reshape(rows, w) for r in raws]
    img.data = pm.RowSharded(mesh, (h, w), blocks)
    img.bzero, img.bscale = 0.0, 1.0
    img.stats = Stats(img.data, w)
    return img


def decode_raw(raw: torch.Tensor, bitpix: int, bscale: float, bzero: float) -> torch.Tensor:
    """Decode a raw BITPIX 8/16 payload (a uint8 tensor of its bytes) on its
    device: byte swap (16-bit payloads are big-endian), then
    v = int * bscale + bzero in float32 (read.go:205). Flat result."""
    if bitpix == 16:
        v = raw.view(torch.int16).to(torch.int32) & 0xFFFF
        swapped = ((v << 8) | (v >> 8)) & 0xFFFF
        ints = torch.where(swapped >= 0x8000, swapped - 0x10000, swapped)
    else:
        ints = raw
    scale = trace.upload(float(bscale), raw.device, torch.float32)
    zero = trace.upload(float(bzero), raw.device, torch.float32)
    return ints.to(torch.float32) * scale + zero


def decode_payload(raw: bytes, dtype: np.dtype, pixels: int, bscale: float, bzero: float):
    """Host decode of the wider payload types. Returns (float32 array, min,
    mean, max)."""
    arr = np.frombuffer(raw, dtype=dtype, count=pixels).astype(np.float32)
    if bscale != 1.0 or bzero != 0.0:
        arr = arr * np.float32(bscale) + np.float32(bzero)
    return arr, float(arr.min()), float(arr.mean(dtype=np.float64)), float(arr.max())


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


@trace.span("save")
def write_file(img: Image, file_name: str) -> None:
    """Write an Image to a FITS file, gzip if suffixed (write.go:32-50)."""
    lower = file_name.lower()
    opener = gzip.open if lower.endswith((".gz", ".gzip")) else open
    with opener(file_name, "wb") as f:
        write(img, f)


def write(img: Image, f: BinaryIO) -> None:
    """Serialize an Image as FITS (write.go:54-89)."""
    parts: list[str] = []
    _write_bool(parts, "SIMPLE", True, "    FITS standard 4.0")
    _write_int(parts, "BITPIX", -32, "    32-bit floating point")
    _write_int(parts, "NAXIS", len(img.naxisn), "[1] Number of array dimensions")
    for i, n in enumerate(img.naxisn):
        _write_int(parts, f"NAXIS{i + 1}", n, "[1] Array dimension")
    _write_float(parts, "BZERO", img.bzero, "[1] Zero offset")
    _write_float(parts, "BSCALE", img.bscale, "[1] Data scale")
    if img.exposure != 0:
        _write_float(parts, "EXPOSURE", img.exposure, "[s] Exposure duration")
    _write_string(parts, "PROGRAM", "nightlight", "    https://github.com/mlnoga/nightlight")

    h = img.header
    h.strings.pop("PROGRAM", None)
    h.strings.pop("CREATOR", None)
    for k, v in h.bools.items():
        _write_bool(parts, k, v, "")
    for k, v in h.ints.items():
        _write_int(parts, k, v, "")
    for k, v in h.floats.items():
        _write_float(parts, k, v, "")
    for k, v in h.strings.items():
        _write_string(parts, k, v, "")
    for k, v in h.dates.items():
        _write_string(parts, k, v, "")
    parts.append("END" + " " * (HEADER_LINE_SIZE - 3))

    header = "".join(parts)
    pad = len(header) % FITS_BLOCK_SIZE
    if pad > 0:
        header += " " * (FITS_BLOCK_SIZE - pad)

    # payload: float32 big-endian, NaNs replaced with zeros (write.go:182-215)
    with trace.span("save.fetch"):
        data = img.to_numpy().reshape(-1)
    with trace.span("save.encode"):
        data = np.nan_to_num(data, nan=0.0, posinf=None, neginf=None)
        payload = data.astype(">f4").tobytes()
    with trace.span("save.write"):
        f.write(header.encode("ascii"))
        f.write(payload)
        tail = len(payload) % FITS_BLOCK_SIZE
        if tail != 0:
            f.write(b" " * (FITS_BLOCK_SIZE - tail))


def _fmt(key: str, value: str, comment: str) -> str:
    key = key[:8]
    comment = comment[:47]
    return f"{key:<8}= {value:>20} / {comment:<47}"


def _write_bool(parts: list, key: str, value: bool, comment: str) -> None:
    parts.append(_fmt(key, "T" if value else "F", comment))


def _write_int(parts: list, key: str, value: int, comment: str) -> None:
    parts.append(_fmt(key, str(int(value)), comment))


def _write_float(parts: list, key: str, value: float, comment: str) -> None:
    parts.append(_fmt(key, f"{value:g}", comment))


def _write_string(parts: list, key: str, value: str, comment: str) -> None:
    key = key[:8]
    comment = comment[:47]
    value = value.replace("'", "''")
    if len(value) <= 18:
        parts.append(f"{key:<8}= '{value}'{' ' * (18 - len(value))} / {comment:<47}")
    else:
        # CONTINUE long-string convention (write.go:163-171)
        parts.append(f"{key:<8}= '{value[0:17]}&' / {comment:<47}")
        value = value[17:]
        while len(value) > 66:
            parts.append(f"CONTINUE  '{value[0:66]}&' ")
            value = value[66:]
        parts.append(f"CONTINUE  '{value}'{' ' * (50 + (18 - len(value)))}")
