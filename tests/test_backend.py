"""Backend choice: ``auto`` routes by what the code shows (QC or not) and
whether JAX runs on a GPU; explicit names are honoured or refused."""

import pytest

from ldpcgputegra.codes.registry import load_code
from ldpcgputegra.decoder import BACKENDS, backend_for, make_decoder
from ldpcgputegra.ops.layered import LayeredSpec


@pytest.mark.parametrize("name", ["576x288", "1944x972", "16200x7560",
                                  "4000x2000"])
def test_auto_is_xla_without_a_gpu(name):
    assert backend_for(load_code(name), LayeredSpec()) == "xla"


@pytest.mark.parametrize("name,qc", [("2304x1152", True),
                                     ("64800x32400-dvbs2", True),
                                     ("4000x2000", False),
                                     ("2048x384", False)])
def test_auto_takes_the_kernel_for_qc_codes_on_a_gpu(monkeypatch, name, qc):
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    want = "pallas" if qc else "xla"
    assert backend_for(load_code(name), LayeredSpec()) == want


def test_auto_keeps_xla_for_colored_schedules(monkeypatch):
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    spec = LayeredSpec(schedule="colored")
    assert backend_for(load_code("576x288"), spec) == "xla"


@pytest.mark.parametrize("name", ["pallas-streamed", "pallas-gather",
                                  "pallas-gather-chunked", "mosaic", "bogus"])
def test_unknown_backend_raises(name):
    with pytest.raises(ValueError, match="unknown backend"):
        make_decoder(load_code("576x288"), LayeredSpec(), backend=name)


def test_explicit_names_pass_through():
    code = load_code("576x288")
    assert backend_for(code, LayeredSpec(), "xla") == "xla"
    assert backend_for(code, LayeredSpec(), "pallas") == "pallas"
    assert BACKENDS == ("auto", "pallas", "xla")
