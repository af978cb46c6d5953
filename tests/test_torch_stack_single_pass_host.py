"""K3's per-pixel arithmetic on the host: csrc/single_pass.cuh (the
register design: Batcher network, unrolled median selects, bitonic merge of
the deviations; the memory design: network loop, merge outward from the
median) compiled with g++ and held bit for bit against the plain version
stack_single_pass_plain, the specification the card is held to, on even-
and odd-count, tie-heavy, signed-zero, all-NaN and one-sample columns."""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from nightlight_tpu_torch.ops import stack_cuda

torch.set_num_threads(1)

CSRC = Path(stack_cuda.__file__).resolve().parent.parent / "csrc"

_HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "single_pass.cuh"

struct HostColumn {
    float* base;
    float& operator[](int i) const { return base[i]; }
};

template <int W, bool MAD>
single_pass::Result regs(const float* col, int n, float lo, float hi, float ref) {
    float v[W];
    int cnt0 = 0;
    for (int i = 0; i < W; ++i) {
        float x = i < n ? col[i] : 3.0e38f;
        bool ok = i < n && x == x;
        v[i] = ok ? x : 3.0e38f;
        cnt0 += ok;
    }
    return single_pass::pixel_regs<W, MAD>(v, cnt0, lo, hi, ref);
}

template <bool MAD>
single_pass::Result regs_any(int wires, const float* col, int n, float lo, float hi, float ref) {
    switch (wires) {
        case 8: return regs<8, MAD>(col, n, lo, hi, ref);
        case 16: return regs<16, MAD>(col, n, lo, hi, ref);
        case 32: return regs<32, MAD>(col, n, lo, hi, ref);
        default: return regs<64, MAD>(col, n, lo, hi, ref);
    }
}

template <bool MAD>
single_pass::Result column(int wires, const float* col, int n, float lo, float hi, float ref) {
    std::vector<float> z(n);
    int cnt0 = 0;
    for (int i = 0; i < n; ++i) {
        bool ok = col[i] == col[i];
        z[i] = ok ? col[i] : 3.0e38f;
        cnt0 += ok;
    }
    HostColumn c{z.data()};
    return single_pass::pixel_column<MAD>(c, wires, n, cnt0, lo, hi, ref);
}

// harness IN OUT n p mad design wires sigma_lo sigma_hi ref_loc
// IN: (p, n) float32, one pixel's column a row; OUT: p floats, then the
// low and high clip totals as two int64
int main(int argc, char** argv) {
    if (argc != 11) return 2;
    int n = std::atoi(argv[3]), p = std::atoi(argv[4]), mad = std::atoi(argv[5]);
    int design = std::atoi(argv[6]), wires = std::atoi(argv[7]);
    float lo = std::strtof(argv[8], nullptr), hi = std::strtof(argv[9], nullptr);
    float ref = std::strtof(argv[10], nullptr);
    std::vector<float> in((size_t)n * p), out(p);
    FILE* f = std::fopen(argv[1], "rb");
    if (!f || std::fread(in.data(), 4, in.size(), f) != in.size()) return 3;
    std::fclose(f);
    long long clo = 0, chi = 0;
    for (int i = 0; i < p; ++i) {
        const float* col = in.data() + (size_t)i * n;
        single_pass::Result r =
            design == 0 ? (mad ? regs_any<true>(wires, col, n, lo, hi, ref)
                               : regs_any<false>(wires, col, n, lo, hi, ref))
                        : (mad ? column<true>(wires, col, n, lo, hi, ref)
                               : column<false>(wires, col, n, lo, hi, ref));
        out[i] = r.out;
        clo += r.clo;
        chi += r.chi;
    }
    f = std::fopen(argv[2], "wb");
    std::fwrite(out.data(), 4, out.size(), f);
    std::fwrite(&clo, 8, 1, f);
    std::fwrite(&chi, 8, 1, f);
    std::fclose(f);
    return 0;
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler (g++) to read csrc/single_pass.cuh")
    d = tmp_path_factory.mktemp("single_pass")
    (d / "harness.cpp").write_text(_HARNESS)
    exe = d / "harness"
    subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O1", "-ffp-contract=off",
                    "-D__host__=", "-D__device__=", "-D__forceinline__=inline",
                    "-I", str(CSRC), str(d / "harness.cpp"), "-o", str(exe)],
                   check=True, capture_output=True, timeout=600)

    def run(frames, mad, design, wires, sigma, ref):
        n, p = frames.shape
        src, dst = d / "in.bin", d / "out.bin"
        np.ascontiguousarray(frames.T, dtype=np.float32).tofile(src)
        subprocess.run([str(exe), str(src), str(dst), str(n), str(p), str(int(mad)),
                        str(design), str(wires), repr(sigma), repr(sigma), repr(ref)],
                       check=True, timeout=120)
        raw = dst.read_bytes()
        out = np.frombuffer(raw[:4 * p], dtype=np.float32)
        clo, chi = np.frombuffer(raw[4 * p:], dtype=np.int64)
        return out, int(clo), int(chi)

    return run


def columns(seed, n, p=96):
    """(n, p) frames whose columns cover the cases of the kernels' selects:
    continuous sky with outliers, integer ADUs (many ties), small integers
    with -0.0 and 0.0 among them, an all-NaN column, one and two valid
    samples, and NaN fractions that give both odd and even valid counts."""
    rng = np.random.default_rng(seed)
    f = (rng.normal(1000.0, 10.0, size=(n, p))).astype(np.float32)
    f[rng.uniform(size=(n, p)) < 0.05] += 2000.0
    f[:, 16:48] = np.round(f[:, 16:48])
    zero = rng.integers(-2, 3, size=(n, 16)).astype(np.float32)
    zero[zero == 0] = np.where(rng.uniform(size=int((zero == 0).sum())) < 0.5, -0.0, 0.0)
    f[:, 48:64] = zero
    for j in range(64, p):  # NaN fractions 0..~60%: odd and even counts
        f[rng.uniform(size=n) < (j - 64) / 50.0, j] = np.nan
    f[:, 0] = np.nan
    f[:, 1] = np.nan
    f[n // 2, 1] = 1234.0
    if n > 1:
        f[:, 2] = np.nan
        f[0, 2], f[n - 1, 2] = -0.0, 7.0
    return f


_REG_WIRES = (8, 16, 32, 64)


@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 15, 16, 30, 33, 64, 65, 128, 200, 256])
@pytest.mark.parametrize("mad", [False, True])
def test_single_pass_header_matches_plain(harness, n, mad):
    """Every design the kernels instantiate for n frames (registers at each
    wire count that holds n, the memory design at the network's own power
    of two) gives the plain version's outputs exactly and its clip totals."""
    f = columns(1000 + n, n)
    sigma, ref = 2.5, 42.5
    want = stack_cuda.stack_single_pass_plain(torch.from_numpy(f), ref, sigma, sigma, mad)
    want = (want[0].numpy(), int(want[1]), int(want[2]))
    wires = 1 << max(n - 1, 0).bit_length()
    designs = [(0, w) for w in _REG_WIRES if w >= n] + [(1, wires)]
    for design, w in designs:
        out, clo, chi = harness(f, mad, design, w, sigma, ref)
        np.testing.assert_array_equal(out, want[0], err_msg=f"design {design} wires {w}")
        assert (clo, chi) == want[1:], (design, w)
    assert float(want[0][0]) == ref  # no valid sample
    assert float(want[0][1]) == 1234.0  # one valid sample
    if mad and n >= 8:
        assert want[1] > 0 and want[2] > 0


def test_single_pass_header_keeps_nothing_at_tiny_sigma(harness):
    """At sigma 0.1 many columns keep no sample and give 0.0, not ref_loc;
    both designs agree with the plain version there too."""
    f = columns(7, 30)
    want = stack_cuda.stack_single_pass_plain(torch.from_numpy(f), 42.5, 0.1, 0.1, True)
    assert int((want[0].numpy() == 0.0).sum()) > 10
    for design, w in ((0, 32), (0, 64), (1, 32)):
        out, clo, chi = harness(f, True, design, w, 0.1, 42.5)
        np.testing.assert_array_equal(out, want[0].numpy())
        assert (clo, chi) == (int(want[1]), int(want[2]))
