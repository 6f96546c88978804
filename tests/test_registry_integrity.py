"""Every registry code loads, validates, and has coherent structure."""

import numpy as np
import pytest

from ldpcgputegra.codes.registry import list_codes, load_code


@pytest.mark.slow
def test_all_registry_codes_load_and_validate():
    names = list_codes()
    assert len(names) >= 25
    for name in names:
        code = load_code(name)
        code.check_valid()
        assert code.M == sum(c.deg * c.count for c in code.classes)
        assert 0 < code.K < code.N
        # layers cover every edge exactly once, in order
        total = sum(l.idx.size for l in code.layers if l.qc is None or
                    l.qc.commit_rows is None)
        # (sub-pass layers share their block-row's edges; none exist in
        # registry-loaded codes — only in QC-ified views)
        assert all(
            l.qc is None or l.qc.commit_rows is None for l in code.layers
        )
        assert total == code.M
