"""The batch planner of `stack` (pipeline/ops_stack.py OpStackBatches._partition)
with the cards' memory faked, and the tracer's counters of the plan and of
the device mesh (stack.batches, mesh.bytes).

Without a mesh the plan counts the context's device alone, as the JAX
package does: the plans of the benchmark's one-card shapes are held number
for number to the JAX package's planner on the same inputs, and to the
plans made before the planner learned the mesh. Under a
mesh (-shard) it counts each device's memory against its shard of every
frame, so four 80 GB cards take a 100-light 61 MP night in one batch.
"""

import contextlib
import io
import os

import pytest
import torch

from nightlight_tpu_torch import cli, fixtures, trace
from nightlight_tpu_torch.models.presets import build_command_seq
from nightlight_tpu_torch.parallel import mesh as pm
from nightlight_tpu_torch.pipeline import op_from_dict
from nightlight_tpu_torch.pipeline.context import new_context
from nightlight_tpu_torch.pipeline.ops_stack import OpStackBatches

MIB = 1 << 20
CPU = torch.device("cpu")
MONO = ["-dark", "dark.fits", "-flat", "flat.fits", "stack", "light*.fits"]
OSC = ["-dark", "dark.fits", "-debayer", "R", "-cfa", "RGGB", "stack", "light*.fits"]
SERVED = {"type": "seq", "steps": [
    {"type": "loadMany", "filePatterns": ["light*.fits"]},
    {"type": "stackBatches", "perBatch": {"type": "seq", "steps": [
        {"type": "calibrate", "dark": "dark.fits", "flat": "flat.fits"},
        {"type": "badPixel", "sigmaLow": 3.0, "sigmaHigh": 5.0},
        {"type": "starDetect", "radius": 16, "sigma": 15.0, "badPixelSigma": 5.0,
         "inOutRatio": 1.4},
        {"type": "stack", "mode": 6, "sigmaLow": 2.75, "sigmaHigh": 2.75}]}}]}
CASES = {"mono16.n100": (MONO, 100, 4096, 4096), "osc16.rgb.n20": (OSC, 20, 4096, 4096),
         "mono16.served.n24": (None, 24, 4096, 4096), "mono16.n10": (MONO, 10, 4096, 4096),
         "mono61.n100": (MONO, 100, 9576, 6388)}


@pytest.fixture
def cards(monkeypatch):
    """{device index: free MiB} of the faked cards (80 GB H100s by
    default), nothing cached; 8 CPU threads."""
    free = {}
    monkeypatch.setattr(os, "cpu_count", lambda: 8)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda d=None: (free[torch.device(d).index or 0] * MIB, 81559 * MIB))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda d=None: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda d=None: 0)
    return free


def _planner(argv):
    if argv is None:
        return next(s for s in op_from_dict(SERVED).steps if isinstance(s, OpStackBatches))
    args = cli.build_parser().parse_args(argv)
    cli.apply_command_defaults(args)
    return next(s for s in build_command_seq(args).steps if isinstance(s, OpStackBatches))


def _frames(case):
    argv, n, w, h = CASES[case]

    class Frame:
        naxisn = [w, h]
        file_name = "plan"

    return [Frame] * n


def _result(planner, partition, log):
    _, batches, size, threads = partition
    fits = next(ln for ln in log.getvalue().splitlines() if "this fits" in ln)
    return batches, size, threads, planner._prefetch_bytes, fits.split("this fits ")[1]


def _plan(case, mesh_cards=0):
    """(batches, batch size, threads, prefetch bytes, the "this fits" line)
    of a case's planner on cuda:0, or on a mesh of cuda:0 .. mesh_cards-1."""
    planner = _planner(CASES[case][0])
    log = io.StringIO()
    c = new_context(log=log, st_memory=1 << 20, device=torch.device("cuda:0"))
    if mesh_cards:
        c.mesh = pm.make_mesh([torch.device("cuda", k) for k in range(mesh_cards)])
    return _result(planner, planner._partition(_frames(case), c), log)


def _jax_plan(case, free_mib, monkeypatch):
    """The same as _plan without a mesh, from the JAX package's planner
    built from the same argv or served JSON, its device memory faked to
    free_mib."""
    from nightlight_tpu import cli as jcli
    from nightlight_tpu.models.presets import build_command_seq as jbuild
    from nightlight_tpu.pipeline import op_from_dict as jop_from_dict
    from nightlight_tpu.pipeline import ops_stack as jops
    from nightlight_tpu.pipeline.context import new_context as jnew_context

    monkeypatch.setattr(jops.OpStackBatches, "_device_memory_mb",
                        staticmethod(lambda: free_mib))
    argv = CASES[case][0]
    if argv is None:
        seq = jop_from_dict(SERVED)
    else:
        args = jcli.build_parser().parse_args(argv)
        jcli.apply_command_defaults(args)
        seq = jbuild(args)
    planner = next(s for s in seq.steps if isinstance(s, jops.OpStackBatches))
    log = io.StringIO()
    c = jnew_context(log=log, st_memory=1 << 20)
    return _result(planner, planner._partition(_frames(case), c), log)


# the plans before the planner counted the mesh (free MiB of cuda:0, the
# plan, the end of the "this fits" line), which the JAX package's planner
# also makes
ONE_CARD = [
    ("mono16.n100", 12288, (17, 6, 6, 201326592), "18 frames."),
    ("osc16.rgb.n20", 12288, (4, 5, 6, 167772160), "18 frames."),
    ("mono16.served.n24", 12288, (1, 24, 8, 0), "115 frames."),
    ("mono16.n10", 12288, (1, 10, 8, 0), "18 frames."),
    ("mono16.n100", 24576, (3, 34, 8, 1140850688), "66 frames."),
    ("osc16.rgb.n20", 24576, (1, 20, 8, 0), "66 frames."),
    ("mono16.served.n24", 24576, (1, 24, 8, 0), "230 frames."),
    ("mono16.n10", 24576, (1, 10, 8, 0), "66 frames."),
    ("mono61.n100", 24576, (17, 6, 6, 734057856), "18 frames."),
    ("mono16.n100", 81000, (1, 100, 8, 0), "286 frames."),
    ("osc16.rgb.n20", 81000, (1, 20, 8, 0), "286 frames."),
    ("mono16.served.n24", 81000, (1, 24, 8, 0), "759 frames."),
    ("mono16.n10", 81000, (1, 10, 8, 0), "286 frames."),
    ("mono61.n100", 81000, (2, 50, 8, 6117148800), "78 frames."),
]


@pytest.mark.parametrize("case,free_mib,plan,fits", ONE_CARD,
                         ids=[f"{c}-{m}" for c, m, _, _ in ONE_CARD])
def test_one_card_plans_are_unchanged(cards, monkeypatch, case, free_mib, plan, fits):
    """The port's plan and its "this fits" line are the JAX package's on
    the same inputs and memory, and the pinned numbers besides."""
    cards[0] = free_mib
    got = _plan(case)
    assert got == _jax_plan(case, free_mib, monkeypatch)
    assert got == (*plan, fits)


def test_four_80gb_cards_plan_the_61mp_night_in_one_batch(cards):
    """Each card holds 1,597 of the 6,388 rows of every frame, and the
    plan says that it counted the mesh; on the lead card alone the same
    night splits in two."""
    for k in range(4):
        cards[k] = 81000
    batches, size, threads, prefetch, fits = _plan("mono61.n100", mesh_cards=4)
    assert (batches, size, threads, prefetch) == (1, 100, 8, 0)
    assert "on the mesh's 4 devices" in fits and "the least device 81000 MiB" in fits
    assert _plan("mono61.n100")[0] == 2


def test_the_fullest_card_binds(cards):
    """The card with the least free memory sets the plan, wherever it is
    in the mesh."""
    for k in range(4):
        cards[k] = 81000
    one = _plan("mono61.n100", mesh_cards=4)
    cards[2] = 20000
    lean = _plan("mono61.n100", mesh_cards=4)
    assert lean[0] > one[0] == 1 and "the least device 20000 MiB" in lean[4]
    assert int(lean[4].split()[0]) < int(one[4].split()[0])


@pytest.mark.parametrize("free_mib", [16384, 24576])
def test_a_mesh_too_small_for_the_night_still_splits(cards, free_mib):
    for k in range(4):
        cards[k] = free_mib
    batches, size, _, prefetch, _ = _plan("mono61.n100", mesh_cards=4)
    assert batches > 1 and batches * size >= 100 and prefetch > 0


def test_rows_that_do_not_divide_the_mesh_count_the_lead_alone(cards):
    """Frames whose rows do not divide the mesh are replicated on the lead:
    the plan is the one-card plan."""
    for k in range(3):
        cards[k] = 81000
    assert 6388 % 3 != 0
    assert _plan("mono61.n100", mesh_cards=3) == _plan("mono61.n100")


def test_stack_batches_counts_the_plan(cards):
    cards.update({k: 81000 for k in range(4)})
    before = trace.counter("stack.batches")
    _plan("mono61.n100")
    _plan("mono61.n100", mesh_cards=4)
    after = trace.counter("stack.batches")
    assert after.get("device", 0) - before.get("device", 0) == 2
    assert after.get("mesh", 0) - before.get("mesh", 0) == 1


def test_plan_st_memory_finds_the_live_stacking_budget(monkeypatch):
    """fixtures.plan_st_memory searches the -stMemory for a plan: on 4
    threads, 10 frames of 256² in two batches of 5 take 3 MiB, the budget
    of the live-stacking job in tests/test_torch_rest.py, and the planner
    makes that plan under it; no budget makes batches of no frame."""
    monkeypatch.setattr(os, "cpu_count", lambda: 4)
    st = fixtures.plan_st_memory(10, 256, CPU, 2)
    assert st == 3
    planner = next(s for s in op_from_dict(fixtures.live_stacking_job("x.fits")).steps
                   if isinstance(s, OpStackBatches))

    class Frame:
        naxisn = [256, 256]
        file_name = "plan"

    c = new_context(log=io.StringIO(), st_memory=st, device=CPU)
    assert planner._partition([Frame] * 10, c)[1:3] == (2, 5)
    with pytest.raises(ValueError, match="no -stMemory plans"):
        fixtures.plan_st_memory(10, 256, CPU, 20)


def test_live_stacking_job_is_a_served_job():
    """fixtures.live_stacking_job is a job the port's DSL takes: load, a
    stackBatches of detection, two reference selections, the match, the
    alignment and the auto stack, and the save to the name given."""
    job = fixtures.live_stacking_job("out.fits")
    op = op_from_dict(job)
    assert [type(s).__name__ for s in op.steps] == ["OpLoadMany", "OpStackBatches", "OpSave"]
    assert [type(s).__name__ for s in op.steps[1].per_batch.steps] == [
        "OpStarDetect", "OpSelectReference", "OpSelectReference", "OpMatchHistogram",
        "OpAlign", "OpStack"]
    assert job["steps"][-1] == {"type": "save", "filePattern": "out.fits"}


def _bytes():
    return dict(trace.counter("mesh.bytes"))


def _delta(before, after):
    return {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}


def test_mesh_bytes_of_a_gather_are_the_off_lead_rows():
    mesh = pm.make_mesh([CPU] * 4)
    x = pm.shard_rows(mesh, torch.zeros((2, 12, 5)))
    before = _bytes()
    pm.gather(x, "save")
    # 9 of the 12 rows are off the lead, 2 planes of 5 float32 columns
    assert _delta(before, _bytes()) == {"save": 9 * 5 * 4 * 2}
    before = _bytes()
    pm.gather(pm.replicated(mesh, torch.zeros((6, 5))), "save")
    assert _delta(before, _bytes()) == {}


def test_mesh_bytes_of_a_halo_and_a_split():
    mesh = pm.make_mesh([CPU] * 4)
    img = torch.zeros((16, 3))
    before = _bytes()
    x = pm.shard_rows(mesh, img)
    # a tensor on the lead split by rows: three blocks of 4 rows leave it
    assert _delta(before, _bytes()) == {"rows": 3 * 4 * 3 * 4}
    before = _bytes()
    assert pm.shard_rows(mesh, x) is x
    pm.halo(x, 2, 1)
    # shards 1-3 receive 2 rows from above, shards 0-2 one row from below
    assert _delta(before, _bytes()) == {"halo": (3 * 2 + 3 * 1) * 3 * 4}


def test_a_small_sharded_stack_counts_its_plan_and_its_exchanges(tmp_path, monkeypatch):
    """A -shard stack through the CLI on a mesh of four CPU shards: one
    batch planned on the mesh, the stacked frame gathered once for the
    save (3 of its 4 shards' rows), and the halos of detection and the
    warp."""
    from nightlight_tpu_torch import fixtures

    fixtures.gen(str(tmp_path), n_frames=4, size=256, seed=7)
    monkeypatch.chdir(tmp_path)
    mesh = pm.make_mesh([CPU] * 4)
    monkeypatch.setattr(cli, "shard_mesh", lambda device, log: mesh)
    batches0, bytes0, gathers0 = trace.counter("stack.batches"), _bytes(), dict(pm.GATHERS)
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        rc = cli.main(["-out", "out.fits", "-shard", "-dark", "dark.fits", "stack",
                       "light*.fits"], device="cpu")
    assert rc == 0, log.getvalue()[-2000:]
    assert "on the mesh's 4 devices" in log.getvalue()
    assert _delta(batches0, trace.counter("stack.batches")) == {"mesh": 1}
    moved = _delta(bytes0, _bytes())
    saves = pm.GATHERS["save"] - gathers0.get("save", 0)
    assert saves >= 1 and moved["save"] == saves * (256 - 64) * 256 * 4
    assert moved["halo"] > 0
