"""Scan-folded sweep dispatch (SweepConfig.scan_steps).

Folding S sim steps into one executable is a pure dispatch-shape change:
batch k's channel key stays fold_in(fold_in(seed, point), k), so every
counter must be bit-identical to the unfolded sweep when both decode the
same batch set.  This is the same invariant the pipelined window already
guarantees (reference overlap: ``gpu_fixed/main.cpp:271-281`` — stream
count never changes results).
"""

from __future__ import annotations

from ldpcgputegra.sim.sweep import SweepConfig, run_sweep


def _cfg(**kw):
    base = dict(
        code="576x288",
        algo="OMS",
        iters=5,
        snr_min=1.0,
        snr_max=2.0,
        snr_step=1.0,
        batch=128,
        max_fe=10**9,  # frame budget decides the batch set exactly
        auto_fe=False,
        max_frames=512,
        seed=7,
        # depth 1: the stop check runs after every fetch, so both runs
        # decode exactly ceil-to-group the same k range
        pipeline_depth=1,
    )
    base.update(kw)
    return SweepConfig(**base)


def test_scan_steps_counters_identical():
    # 512 frames = 4 batches = exactly one scan_steps=4 group: both runs
    # decode batches k=0..3 -> counters must be bit-identical
    ref = run_sweep(_cfg(), progress=False)
    scan = run_sweep(_cfg(scan_steps=4), progress=False)
    assert len(ref.points) == len(scan.points)
    for a, b in zip(ref.points, scan.points):
        assert a.frames == b.frames == 512
        assert (a.be, a.fe) == (b.be, b.fe)


def test_scan_steps_nondivisible_budget():
    # 4-batch budget with groups of 3: the scan run overshoots to 6
    # batches (2 groups); every decoded batch must be counted exactly
    # once (frames a multiple of the group span, never double-counted)
    ref = run_sweep(_cfg(), progress=False)
    scan = run_sweep(_cfg(scan_steps=3), progress=False)
    for a, b in zip(ref.points, scan.points):
        assert a.frames == 512
        assert b.frames == 768  # 2 groups x 3 batches x 128
        # same keys k=0..3 underlie both; the scan run's extra batches
        # can only ADD errors
        assert b.be >= a.be and b.fe >= a.fe


def test_scan_steps_checkpoint_resume(tmp_path):
    ck = str(tmp_path / "ck.json")
    cfg = _cfg(scan_steps=4, checkpoint=ck)
    res1 = run_sweep(cfg, progress=False)
    res2 = run_sweep(cfg, progress=False)
    for a, b in zip(res1.points, res2.points):
        assert (a.frames, a.be, a.fe) == (b.frames, b.be, b.fe)


def test_scan_steps_coded_path_unaffected():
    # the coded-encoder path ignores scan_steps (bits are host-encoded,
    # so there is nothing to fold); it must run and match its own
    # unfolded counters batch for batch
    kw = dict(encoder="gf2", max_frames=128, snr_max=1.0)
    a = run_sweep(_cfg(**kw), progress=False)
    b = run_sweep(_cfg(scan_steps=4, **kw), progress=False)
    for pa, pb in zip(a.points, b.points):
        assert (pa.frames, pa.be, pa.fe) == (pb.frames, pb.be, pb.fe)
