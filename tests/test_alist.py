"""alist loader round-trip tests."""

import numpy as np

from ldpcgputegra.codes.alist import load_alist, save_alist
from ldpcgputegra.codes.registry import load_code


def test_alist_roundtrip(tmp_path):
    code = load_code("576x288")
    path = str(tmp_path / "c.alist")
    save_alist(code, path)
    back = load_alist(path)
    assert back.N == code.N and back.K == code.K
    assert back.n_checks == code.n_checks and back.M == code.M
    # same check set (order may differ within degree classes)
    def checkset(c):
        rows = []
        for ci in c.class_idx:
            rows += [tuple(sorted(map(int, r))) for r in ci]
        return sorted(rows)

    assert checkset(back) == checkset(code)
    # QC structure survives the round trip (same order -> same Z)
    assert back.Z == code.Z


def test_registry_loads_alist_path(tmp_path):
    code = load_code("576x288")
    path = str(tmp_path / "x.alist")
    save_alist(code, path)
    back = load_code(path)
    assert back.N == code.N and back.M == code.M
