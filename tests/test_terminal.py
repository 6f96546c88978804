"""Terminal reporting format tests (reference M2 line shapes)."""

import io

from ldpcgputegra.sim.analyzer import ErrorAnalyzer
from ldpcgputegra.sim.terminal import Terminal, fmt_hms


def test_fmt_hms():
    assert fmt_hms(0) == "00h00'00"
    assert fmt_hms(3661) == "01h01'01"


def test_temp_and_final_report_lines():
    a = ErrorAnalyzer(n=1000, k=500, max_fe=100)
    a.add_counts(frames=1000, be=50, fe=10)
    out = io.StringIO()
    met = io.StringIO()
    t = Terminal(a, 2.5, metrics=met, out=out)
    t.temp_report(force=True)
    live = out.getvalue()
    assert "(RT)" in live and "FE:  10" in live and "BER" in live
    rec = t.final_report()
    final = out.getvalue()
    assert "SNR = 2.50" in final and "MATRICES" in final
    assert rec["fe"] == 10 and rec["frames"] == 1000
    assert '"type": "snr_point"' in met.getvalue()


def test_temp_report_no_errors_branch():
    a = ErrorAnalyzer(n=1000, k=500)
    a.add_counts(frames=100, be=0, fe=0)
    out = io.StringIO()
    t = Terminal(a, 1.0, out=out)
    t.temp_report(force=True)
    assert "ETR: INF." in out.getvalue()
