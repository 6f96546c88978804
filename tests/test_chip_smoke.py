"""``chip_smoke.py`` on the CPU: it must refuse to report without a GPU,
and its phase functions must pass at tiny sizes (the kernel in the Pallas
interpreter, the multi-card path on virtual CPU devices)."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def _run(cwd, script):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_exits_nonzero_without_gpu():
    r = _run(REPO, "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


def test_exits_nonzero_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(str(tmp_path), "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


@pytest.mark.parametrize("early_term", [False, True])
def test_decode_phase_qc_kernel_interpreted(early_term):
    r = cs.decode_phase("576x288", batch=24, early_term=early_term,
                        windows=1, backends=("pallas", "xla"),
                        interpret=True)
    assert r["ok"], r
    assert set(r["checks"]) == {"pallas", "xla"}
    assert r["frames_checked"] == 24


def test_decode_phase_non_qc():
    r = cs.decode_phase("4000x2000", batch=8, windows=1)
    assert r["ok"], r
    assert r["auto"] == "xla" and list(r["checks"]) == ["xla"]


def test_decode_phase_staircase_view():
    """DVB-S2 view: golden in the view's schedule, bits in base order."""
    r = cs.decode_phase("16200x7560", batch=4, iters=3, windows=1,
                        ebn0_db=1.5, backends=("xla",))
    assert r["ok"], r


def test_twophase_phase():
    r = cs.twophase_phase("576x288", batch=128, k1=2, ebn0_db=2.0)
    assert r["ok"], r
    assert r["gather_equal"]


def test_sweep_phase():
    r = cs.sweep_phase("576x288", snr=1.5, fer=10, batch=128)
    assert r["ok"], r
    assert r["device"]["frames"] > 0 and r["cpu"]["frames"] > 0


def test_four_card_phase_on_virtual_devices():
    r = cs.four_card_phase("576x288", batch=32, tp_batch=2, iters=4,
                           ebn0_db=2.0, windows=1)
    assert r["ok"], r
    assert {"dp4", "dp2xtp2", "tp4", "one_card"} <= set(r)
    assert all(r[k]["ms"] > 0 for k in ("dp4", "dp2xtp2", "tp4", "one_card"))
