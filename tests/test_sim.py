"""Simulation-harness tests: analyzer accounting, sweep, checkpoint/resume,
and the statistical BER waterfall (the reference's implicit oracle,
SURVEY §4)."""

import json
import os

import numpy as np
import pytest

from ldpcgputegra.sim.analyzer import ErrorAnalyzer, count_errors
from ldpcgputegra.sim.sweep import SweepConfig, run_sweep


def test_count_errors_matches_numpy():
    rng = np.random.default_rng(0)
    dec = rng.integers(0, 2, size=(16, 100)).astype(np.uint8)
    ref = rng.integers(0, 2, size=(16, 100)).astype(np.uint8)
    be, fe = count_errors(dec, ref)
    err = dec != ref
    assert be == err.sum()
    assert fe == (err.any(axis=1)).sum()
    be0, fe0 = count_errors(np.zeros((4, 10), np.uint8))
    assert be0 == 0 and fe0 == 0


def test_adaptive_fe_limit():
    a = ErrorAnalyzer(n=1000, k=500, max_fe=160, auto_fe=True)
    a.add_counts(frames=10, be=50, fe=5)  # BER 5e-3
    assert a.fe_limit() == 160
    a.reset()
    a.add_counts(frames=10_000_000, be=5000, fe=100)  # BER 5e-7
    assert a.fe_limit() == 80
    a.reset()
    a.add_counts(frames=100_000_000, be=5000, fe=100)  # BER 5e-8
    assert a.fe_limit() == 40
    b = ErrorAnalyzer(n=1000, k=500, max_fe=160, auto_fe=False)
    b.add_counts(frames=100_000_000, be=5000, fe=100)
    assert b.fe_limit() == 160


def test_analyzer_accumulate():
    a = ErrorAnalyzer(n=100, k=50)
    b = ErrorAnalyzer(n=100, k=50)
    a.add_counts(10, 20, 3)
    b.add_counts(5, 7, 1)
    a.accumulate(b)
    assert (a.frames, a.bit_errors, a.frame_errors) == (15, 27, 4)
    assert a.ber == 27 / 1500 and a.fer == 4 / 15


def _tiny_cfg(**kw):
    base = dict(
        code="576x288",
        algo="OMS",
        iters=5,
        snr_min=1.0,
        snr_max=2.0,
        snr_step=1.0,
        batch=128,
        max_fe=30,
        max_frames=512,
        seed=7,
    )
    base.update(kw)
    return SweepConfig(**base)


def test_sweep_ber_decreases_with_snr():
    res = run_sweep(_tiny_cfg(), progress=False)
    assert len(res.points) == 2
    p0, p1 = res.points
    assert p0.snr_db == 1.0 and p1.snr_db == 2.0
    assert p0.frames >= 128 and p1.frames >= 128
    # waterfall: higher SNR -> strictly lower BER at these counts
    assert p1.ber < p0.ber


def test_sweep_checkpoint_resume(tmp_path):
    ck = str(tmp_path / "ck.json")
    met = str(tmp_path / "m.jsonl")
    cfg = _tiny_cfg(checkpoint=ck, metrics=met)
    res1 = run_sweep(cfg, progress=False)
    assert os.path.exists(ck)
    # second run must reuse completed points (identical counters, no rerun)
    res2 = run_sweep(cfg, progress=False)
    for a, b in zip(res1.points, res2.points):
        assert (a.frames, a.be, a.fe) == (b.frames, b.be, b.fe)
    recs = [json.loads(l) for l in open(met)]
    assert sum(r["type"] == "snr_point" for r in recs) == len(res1.points)


def test_sweep_qef_cutoff():
    cfg = _tiny_cfg(snr_min=1.0, snr_max=8.0, snr_step=1.0, qef_fer=1e-6,
                    max_frames=256, max_fe=1000)
    res = run_sweep(cfg, progress=False)
    # at 256 frames/point, a zero-FE point has fer=0 < 1e-6 -> sweep stops
    assert len(res.points) < 8


def test_sweep_real_encoder():
    cfg = _tiny_cfg(encoder="gf2", max_frames=128, snr_max=1.0)
    res = run_sweep(cfg, progress=False)
    assert res.points[0].frames >= 128


def test_sweep_real_encoder_info_count():
    """Regression: encoder + count_bits='info' together (the x86
    analyzer's configuration, CErrorAnalyzer.cpp:131).  The info slice
    inside the jitted counter traced its k argument and crashed the
    first time this path ever ran end-to-end (VERDICT r2 #4)."""
    cfg = _tiny_cfg(encoder="gf2", count_bits="info",
                    max_frames=128, snr_max=1.0)
    res = run_sweep(cfg, progress=False)
    p = res.points[0]
    assert p.frames >= 128
    # info-only counting: be is bounded by frames * K (K=288)
    assert p.be <= p.frames * 288


def test_mid_point_resume_exact(tmp_path):
    """A sweep killed mid-point must resume deterministically: manually
    plant a partial checkpoint equal to batch 0's counters and check the
    final point equals an uninterrupted run."""
    import jax
    import json as _json

    from ldpcgputegra.channel.awgn import AwgnChannel, ChannelSpec
    from ldpcgputegra.codes.registry import load_code
    from ldpcgputegra.decoder import make_decoder
    from ldpcgputegra.ops.layered import LayeredSpec
    from ldpcgputegra.sim.analyzer import count_errors

    cfg = _tiny_cfg(snr_min=1.0, snr_max=1.0, batch=64, max_frames=256,
                    max_fe=10**6)
    # uninterrupted reference run
    ref = run_sweep(cfg, progress=False).points[0]

    # recompute batch 0's counters exactly as the sweep does
    code = load_code(cfg.code)
    chan = AwgnChannel(code.N, code.K, ChannelSpec())
    chan.configure(1.0)
    dec = make_decoder(
        code,
        LayeredSpec(algo=cfg.algo, iters=cfg.iters,
                    early_term=cfg.early_term),
    )
    key = jax.random.fold_in(jax.random.fold_in(jax.random.key(cfg.seed), 0), 0)
    llr = chan.generate_zero_int8(key, cfg.batch)
    be0, fe0 = count_errors(dec(llr)[0])

    ck = tmp_path / "ck.json"
    ck.write_text(_json.dumps({
        "done": {},
        "partial": {"snr": "1.0", "frames": cfg.batch, "be": be0,
                    "fe": fe0, "batches": 1},
    }))
    cfg2 = _tiny_cfg(snr_min=1.0, snr_max=1.0, batch=64, max_frames=256,
                     max_fe=10**6, checkpoint=str(ck))
    resumed = run_sweep(cfg2, progress=False).points[0]
    assert (resumed.frames, resumed.be, resumed.fe) == (
        ref.frames, ref.be, ref.fe
    )


@pytest.mark.slow
def test_cli_kill_and_resume(tmp_path):
    """SIGKILL a running sweep process mid-point; rerunning with the same
    checkpoint must converge to the same counters as an uninterrupted run."""
    import signal
    import subprocess
    import sys
    import time as _time

    ck = str(tmp_path / "ck.json")
    args = [
        sys.executable, "-m", "ldpcgputegra.sim.cli",
        "--code", "576x288", "--min", "1.0", "--max", "1.0",
        "--batch", "64", "--max-frames", "512", "--fer", "1000000",
        "--iters", "4", "--quiet", "--checkpoint", ck,
    ]
    env = dict(os.environ, JAX_PLATFORMS="cpu", LDPC_NO_NATIVE="0")
    # uninterrupted reference (separate checkpoint)
    ck_ref = str(tmp_path / "ref.json")
    ref_args = list(args)
    ref_args[ref_args.index(ck)] = ck_ref
    subprocess.run(ref_args, env=env, check=True, capture_output=True,
                   timeout=240)
    ref = json.load(open(ck_ref))["done"]["1.0"]

    # start, kill mid-run, resume
    p = subprocess.Popen(args, env=env, stdout=subprocess.DEVNULL,
                         stderr=subprocess.DEVNULL)
    deadline = _time.time() + 120
    while _time.time() < deadline and not os.path.exists(ck):
        _time.sleep(0.2)
    _time.sleep(0.5)  # let a couple of batches checkpoint
    p.send_signal(signal.SIGKILL)
    p.wait(timeout=30)
    subprocess.run(args, env=env, check=True, capture_output=True,
                   timeout=240)
    got = json.load(open(ck))["done"]["1.0"]
    assert (got["frames"], got["be"], got["fe"]) == (
        ref["frames"], ref["be"], ref["fe"]
    )


def test_info_mode_ber_denominator():
    """--info-ber counts errors over K bits only, so BER must divide by K
    (CErrorAnalyzer::ber_value divides by _vars in this mode), not N."""
    a = ErrorAnalyzer(n=1000, k=500, counted_bits=500)
    a.add_counts(10, 50, 5)
    assert a.ber == 50 / (10 * 500)
    b = ErrorAnalyzer(n=1000, k=500)  # default: all coded bits counted
    b.add_counts(10, 50, 5)
    assert b.ber == 50 / (10 * 1000)


def test_layered_spec_rejects_wide_quantizers():
    """var/msg widths beyond int8 storage must raise, not silently wrap."""
    import pytest
    from ldpcgputegra.ops.layered import LayeredSpec

    with pytest.raises(ValueError):
        LayeredSpec(sat_var=255)
    with pytest.raises(ValueError):
        LayeredSpec(sat_msg=511)
    LayeredSpec(sat_var=127, sat_msg=31)  # reference defaults stay valid


def test_sweep_native_backend_matches_xla():
    """backend='native' (AVX-512 host decoder) must produce counters
    IDENTICAL to the jitted path on the same channel keys — same llr
    (counter-based threefry), bit-identical decode (enforced again at
    runtime by the sweep's batch-0 cross-check)."""
    from ldpcgputegra.golden.native import simd_available

    if not simd_available():
        import pytest as _pytest

        _pytest.skip("no AVX-512 native build")
    kw = dict(snr_min=2.0, snr_max=2.0, max_frames=256, batch=128,
              max_fe=10**9, auto_fe=False)
    a = run_sweep(_tiny_cfg(backend="native", **kw), progress=False)
    b = run_sweep(_tiny_cfg(backend="auto", **kw), progress=False)
    pa, pb = a.points[0], b.points[0]
    assert (pa.frames, pa.be, pa.fe) == (pb.frames, pb.be, pb.fe)


def test_sweep_native_refuses_staircase_view():
    """QC-view staircase codes decode in a different (permuted) check
    order on the jitted paths; backend='native' must refuse rather than
    extend their curves with different-decoder statistics."""
    from ldpcgputegra.golden.native import simd_available

    if not simd_available():
        import pytest as _pytest

        _pytest.skip("no AVX-512 native build")
    import pytest as _pytest

    with _pytest.raises(AssertionError, match="native"):
        run_sweep(
            _tiny_cfg(code="16200x7560", snr_min=2.0, snr_max=2.0,
                      max_frames=64, batch=64, backend="native"),
            progress=False,
        )


def test_sweep_native_philox_channel():
    """channel_rng='philox' (native counter-based channel): deterministic
    across runs, and statistically consistent with the threefry channel
    at a high-FER point (binomial 5-sigma window)."""
    from ldpcgputegra.golden.native import simd_available

    if not simd_available():
        pytest.skip("no AVX-512 native build")
    kw = dict(snr_min=1.0, snr_max=1.0, max_frames=2048, batch=512,
              max_fe=10**9, auto_fe=False)
    a = run_sweep(_tiny_cfg(backend="native", channel_rng="philox", **kw),
                  progress=False)
    b = run_sweep(_tiny_cfg(backend="native", channel_rng="philox", **kw),
                  progress=False)
    pa, pb = a.points[0], b.points[0]
    assert (pa.frames, pa.be, pa.fe) == (pb.frames, pb.be, pb.fe)
    ref = run_sweep(_tiny_cfg(backend="native", **kw), progress=False)
    pr = ref.points[0]
    p = pr.fe / pr.frames
    sigma = (p * (1 - p) / pr.frames) ** 0.5
    assert abs(pa.fer - pr.fer) < 5 * sigma + 5 / pr.frames, (pa.fer, pr.fer)
