"""The shift-blend warp on the CPU: kernel K7's per-pixel arithmetic
(csrc/warp_shift.cuh, compiled with g++) held bit for bit against the plain
version ops/resample.py _warp_shift, the specification the card is held to;
the wrapper ops/warp_cuda.py warp_shift, which sends a CPU tensor to the
plain version; and warp_shift_batch and project, the callers, bit for bit
the unchanged plain version at the shift buckets 2, 4 and 8, on frames with
NaN and +-inf pixels (on the edges too) and on blocks of rows."""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from nightlight_tpu_torch import kernels
from nightlight_tpu_torch.align import transform as tf
from nightlight_tpu_torch.ops import resample as rs
from nightlight_tpu_torch.ops import warp_cuda

torch.set_num_threads(1)

CSRC = Path(warp_cuda.__file__).resolve().parent.parent / "csrc"
H, W = 120, 152  # rows of 152 floats start on 16 bytes: the aligned reads
NAXISN = [W, H]

# inverse transforms and the shift bucket (n_k, n_m) each plans
INVS = {
    2: np.array([1.0, 0.0, 3.4, 0.0, 1.0, -2.7]),
    4: np.array([1.0001, 0.012, -5.25, -0.010, 0.9999, 1.5]),
    8: np.array([1.0, 0.045, 2.2, -0.036, 1.0, -1.3]),
}

_HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "warp_shift.cuh"

// harness IN OUT MODE h w src_row0 src_h inv0..inv5 fill kmin mmin n_k n_m row0 rows dest_w
// IN: (h, w) float32; OUT: (rows, dest_w) float32, then the groups that
// took the aligned reads as an int64. MODE 0: pixel by pixel; 1: as the
// kernel runs, kGroup pixels at a time, the row's tail pixel by pixel.
int main(int argc, char** argv) {
    if (argc != 22) return 2;
    int mode = std::atoi(argv[3]), a[4], b[7];
    float f[7];
    for (int i = 0; i < 4; ++i) a[i] = std::atoi(argv[4 + i]);
    for (int i = 0; i < 7; ++i) f[i] = std::strtof(argv[8 + i], nullptr);
    for (int i = 0; i < 7; ++i) b[i] = std::atoi(argv[15 + i]);
    warp_shift::Params p{a[0], a[1], a[2], a[3], {f[0], f[1], f[2], f[3], f[4], f[5]},
                         f[6], b[0], b[1], b[2], b[3], b[6]};
    int row0 = b[4], rows = b[5];
    std::vector<float> img((size_t)p.h * p.w), out((size_t)rows * p.dest_w);
    FILE* in = std::fopen(argv[1], "rb");
    if (!in || std::fread(img.data(), 4, img.size(), in) != img.size()) return 3;
    std::fclose(in);
    warp_shift::set_flags(p, img.data());
    long long fast = 0;
    const int g = warp_shift::kGroup;
    for (int r = 0; r < rows; ++r) {
        float* dst = out.data() + (size_t)r * p.dest_w;
        int c = 0;
        for (; mode == 1 && c + g <= p.dest_w; c += g) {
            float v[warp_shift::kGroup];
            warp_shift::group(p, img.data(), row0 + r, c, v);
            for (int q = 0; q < g; ++q) dst[c + q] = v[q];
            warp_shift::Coords c0 = warp_shift::coords(p, row0 + r, c);
            warp_shift::Coords c3 = warp_shift::coords(p, row0 + r, c + g - 1);
            int m = c0.yl - (row0 + r) - p.mmin;
            fast += p.direct && p.aligned && !c0.oob && !c3.oob && c0.yl == c3.yl &&
                    c3.xl == c0.xl + g - 1 && m >= 0 && m + 1 < p.n_m;
        }
        for (; c < p.dest_w; ++c) dst[c] = warp_shift::pixel(p, img.data(), row0 + r, c);
    }
    FILE* o = std::fopen(argv[2], "wb");
    std::fwrite(out.data(), 4, out.size(), o);
    std::fwrite(&fast, 8, 1, o);
    std::fclose(o);
    return 0;
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler (g++) to read csrc/warp_shift.cuh")
    d = tmp_path_factory.mktemp("warp_shift")
    (d / "harness.cpp").write_text(_HARNESS)
    exe = d / "harness"
    subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off",
                    "-D__host__=", "-D__device__=", "-D__forceinline__=inline",
                    "-I", str(CSRC), str(d / "harness.cpp"), "-o", str(exe)],
                   check=True, capture_output=True, timeout=600)

    def run(mode, img, inv, fill, kmin, mmin, n_k, n_m, row0, rows, dest_w, src_row0, src_h):
        src, dst = d / "in.bin", d / "out.bin"
        np.ascontiguousarray(img, dtype=np.float32).tofile(src)
        floats = [float(v).hex() for v in np.asarray(inv, np.float32)]
        floats.append(float(np.float32(fill)).hex())
        ints = [kmin, mmin, n_k, n_m, row0, rows, dest_w]
        subprocess.run([str(exe), str(src), str(dst), str(mode),
                        *map(str, (*img.shape, src_row0, src_h)), *floats, *map(str, ints)],
                       check=True, timeout=120)
        raw = dst.read_bytes()
        out = np.frombuffer(raw[:-8], dtype=np.float32).reshape(rows, dest_w)
        return out, int(np.frombuffer(raw[-8:], dtype=np.int64)[0])

    return run


def frame(seed, h=H, w=W):
    """A sky-like float32 frame with NaN, +inf and -inf pixels, some on
    each edge."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = (1000 + 30 * np.sin(xx / 6.0) * np.cos(yy / 4.0)
           + rng.normal(0, 3, (h, w))).astype(np.float32)
    for value in (np.nan, np.inf, -np.inf):
        img[rng.uniform(size=(h, w)) < 0.004] = value
    img[0, 17], img[h - 1, 40], img[55, 0], img[70, w - 1] = np.nan, np.inf, -np.inf, np.nan
    img[1, w - 2], img[h - 2, 1] = -np.inf, np.inf
    return img


def bits(t) -> np.ndarray:
    return np.asarray(t, dtype=np.float32).view(np.int32)


def plan(bucket, w=W):
    got = rs._shift_plan(INVS[bucket], (H, w), [w, H])
    assert got[2:] == (bucket, bucket)
    return got


def block_call(bucket):
    """A _project_sharded-style block: destination rows 30..60 of 120, the
    source rows the slices read and two more each side."""
    kmin, mmin, n_k, n_m = plan(bucket)
    row0, rows = 30, 30
    src_row0 = max(row0 + mmin - 2, 0)
    end = min(row0 + rows + mmin + n_m - 1 + 2, H)
    return (kmin, mmin, n_k, n_m), dict(row0=row0, rows=rows, src_row0=src_row0, src_h=H), \
        slice(src_row0, end)


def header_against_plain(harness, mode, img, inv, fill, shift, rows_kw=None, src=None):
    """The header's output (pixel by pixel, mode 0, or as the kernel runs,
    mode 1) against the plain version's, as int32 words; returns the plain
    output and the groups that took the aligned reads."""
    rows_kw = rows_kw or {}
    src = src or slice(0, img.shape[0])
    h, w = img.shape
    want = rs._warp_shift(torch.from_numpy(img[src].copy()), inv, fill, *shift[:2], h, w,
                          *shift[2:], **rows_kw).numpy()
    got, fast = harness(mode, img[src], inv, fill, *shift, rows_kw.get("row0", 0),
                        rows_kw.get("rows", h), w, src.start, h)
    np.testing.assert_array_equal(bits(got), bits(want))
    return want, fast


# (bucket, out-of-bounds fill, block call, frame width)
CASES = [(2, float("nan"), False, W), (4, float("nan"), False, W), (8, float("nan"), False, W),
         (8, -7.25, False, W), (4, 12.5, True, W), (8, float("nan"), True, W),
         (4, float("nan"), False, 150)]


@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("bucket,fill,block,width", CASES)
def test_warp_shift_header_matches_plain(harness, mode, bucket, fill, block, width):
    """K7's arithmetic gives the plain version's bits, NaN where a
    non-finite neighbour is read and the fill out of bounds included; as
    the kernel runs, most groups take the aligned reads where the rows
    start on 16 bytes, none where they do not."""
    img = frame(bucket, w=width)
    if block:
        shift, rows_kw, src = block_call(bucket)
    else:
        shift, rows_kw, src = plan(bucket, width), {}, None
    want, fast = header_against_plain(harness, mode, img, INVS[bucket], fill, shift, rows_kw,
                                      src)
    assert np.isnan(want).sum() > np.isnan(img).sum()  # the non-finite pixels spread
    if not np.isnan(fill):
        assert (want == np.float32(fill)).sum() > 0
    groups = want.size // 4
    assert fast > groups // 2 if mode == 1 and width % 4 == 0 else fast == 0


@pytest.mark.parametrize("mode", [0, 1])
def test_warp_shift_header_in_a_shared_bucket(harness, mode):
    """A translated frame warped under the batch's (8, 8) bucket: the extra
    slices of zero weight change nothing."""
    kmin, mmin, _, _ = plan(2)
    header_against_plain(harness, mode, frame(5), INVS[2], float("nan"), (kmin, mmin, 8, 8))


@pytest.mark.parametrize("mode", [0, 1])
def test_warp_shift_header_with_clamped_slices(harness, mode):
    """A shift beyond the padding, which the plan refuses but the plain
    version computes with its slice starts clamped: the same pixels."""
    inv = np.array([1.0, 0.0, -258.6, 0.0, 1.0, -2.2])
    img = frame(6, w=400)
    assert rs._shift_plan(inv, img.shape, [400, H]) is None
    want, fast = header_against_plain(harness, mode, img, inv, float("nan"), (-259, -3, 2, 2))
    assert fast == 0 and np.isfinite(want).sum() > 1000


@pytest.mark.parametrize("bucket,block", [(2, False), (4, False), (8, False), (8, True)])
def test_wrapper_runs_the_plain_version_on_the_cpu(bucket, block):
    """A CPU tensor goes to the plain version, into `out` when given, and
    counts no launch."""
    img = torch.from_numpy(frame(10 + bucket))
    if block:
        (kmin, mmin, n_k, n_m), rows_kw, src = block_call(bucket)
        img = img[src].clone()
    else:
        (kmin, mmin, n_k, n_m), rows_kw = plan(bucket), {}
    args = (img, INVS[bucket], float("nan"), kmin, mmin, H, W, n_k, n_m)
    before = kernels.launch_counts()["warp_shift"]
    want = rs._warp_shift(*args, **rows_kw)
    got = warp_cuda.warp_shift(*args, **rows_kw)
    out = torch.empty_like(want)
    into = warp_cuda.warp_shift(*args, **rows_kw, out=out)
    assert into is out
    np.testing.assert_array_equal(bits(got), bits(want))
    np.testing.assert_array_equal(bits(out), bits(want))
    assert kernels.launch_counts()["warp_shift"] == before


def test_wrapper_refuses_a_block_without_the_rows():
    """The kernel's host-side check: a block that lacks rows the slices
    read raises, as the plain version does; a CPU tensor never reaches the
    kernel."""
    kmin, mmin, n_k, n_m = plan(4)
    img = torch.from_numpy(frame(3))
    block = img[40:60].clone()
    args = (block, INVS[4], float("nan"), kmin, mmin, H, W, n_k, n_m)
    kw = dict(row0=30, rows=30, src_row0=40, src_h=H)
    with pytest.raises(ValueError, match="outside the block"):
        warp_cuda.warp_shift_cuda(*args, **kw)
    with pytest.raises(ValueError, match="outside the block"):
        warp_cuda.warp_shift(*args, **kw)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        warp_cuda.warp_shift_cuda(img, INVS[4], float("nan"), kmin, mmin, H, W, n_k, n_m)


@pytest.mark.parametrize("bucket", [2, 4, 8])
def test_warp_shift_batch_is_the_plain_version(bucket):
    """warp_shift_batch on the CPU, in place, equals the unchanged plain
    version frame by frame under the shared bucket; the reference frame
    (flag False) keeps its pixels."""
    imgs = np.stack([frame(20 + s) for s in range(3)])
    invs = [tf.invert(tf.identity()), INVS[2], INVS[bucket]]
    kmins, mmins, n_k, n_m = rs.plan_batch_shift_warp([i.shape for i in imgs], NAXISN, invs)
    assert (n_k, n_m) == (bucket, bucket)
    flags, oobs = [False, True, True], [float("nan"), -3.5, float("nan")]
    batch = torch.from_numpy(imgs.copy())
    got = rs.warp_shift_batch(batch, invs, oobs, kmins, mmins, flags, n_k, n_m)
    assert got is batch
    np.testing.assert_array_equal(bits(got[0]), bits(imgs[0]))
    for i in (1, 2):
        want = rs._warp_shift(torch.from_numpy(imgs[i]), invs[i], oobs[i], int(kmins[i]),
                              int(mmins[i]), H, W, n_k, n_m)
        np.testing.assert_array_equal(bits(got[i]), bits(want))


@pytest.mark.parametrize("bucket", [2, 4, 8])
def test_project_is_the_plain_version(bucket):
    """project on the CPU takes the shift plan and gives the plain
    version's bits."""
    img = frame(30 + bucket)
    trans = tf.invert(INVS[bucket])
    inv = tf.invert(trans)
    kmin, mmin, n_k, n_m = rs._shift_plan(inv, (H, W), NAXISN)
    assert (n_k, n_m) == (bucket, bucket)
    got = rs.project(torch.from_numpy(img), NAXISN, trans, float("nan"))
    want = rs._warp_shift(torch.from_numpy(img), inv, float("nan"), kmin, mmin, H, W, n_k, n_m)
    np.testing.assert_array_equal(bits(got), bits(want))
