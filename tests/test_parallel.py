"""Multi-device sharding tests on the 8-way virtual CPU mesh."""

import jax
import numpy as np

from ldpcgputegra.codes.registry import load_code
from ldpcgputegra.ops.layered import LayeredSpec, make_layered_decoder
from ldpcgputegra.parallel import decode_mesh, make_sharded_decoder


def _llrs(n, b, seed=0):
    rng = np.random.default_rng(seed)
    return np.clip(
        8.0 * (-1.0 + 0.8 * rng.normal(size=(b, n))), -31, 31
    ).astype(np.int8)


def test_virtual_mesh_has_8_devices():
    assert len(jax.devices()) == 8


def test_sharded_decode_matches_single_device():
    code = load_code("576x288")
    spec = LayeredSpec(algo="OMS", iters=5)
    mesh = decode_mesh()
    step = make_sharded_decoder(code, spec, mesh)
    llr = _llrs(code.N, 16, seed=3)
    bits_sh, _, be, fe = step(llr)
    single = make_layered_decoder(code, spec)
    bits_1, _ = single(llr)
    np.testing.assert_array_equal(np.asarray(bits_sh), np.asarray(bits_1))
    err = np.asarray(bits_1) != 0
    assert int(be) == err.sum()
    assert int(fe) == err.any(axis=1).sum()


def test_sharded_early_term_vote():
    """Cross-device convergence vote: all-devices-converged stops at iter 1
    on noiseless input even with the batch spread over 8 chips."""
    code = load_code("576x288")
    spec = LayeredSpec(algo="OMS", iters=10, early_term=True)
    mesh = decode_mesh()
    step = make_sharded_decoder(code, spec, mesh)
    llr = np.full((8, code.N), -31, dtype=np.int8)
    bits, iters_used, be, fe = step(llr)
    assert np.asarray(bits).sum() == 0
    assert int(iters_used) == 1
    assert int(be) == 0 and int(fe) == 0


def test_graft_entry_dryrun():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    bits, iters = fn(*args)
    assert np.asarray(bits).shape == args[0].shape
    ge.dryrun_multichip(8)


def test_sharded_ber_sweep_waterfall():
    """BASELINE config 5: a BER-vs-Eb/N0 sweep with the batch sharded over
    the (virtual) mesh and psum'd counters — the pod-slice sweep shape."""
    import jax

    from ldpcgputegra.channel.awgn import AwgnChannel, ChannelSpec
    from ldpcgputegra.sim.analyzer import ErrorAnalyzer

    code = load_code("576x288")
    mesh = decode_mesh()
    step = make_sharded_decoder(
        code, LayeredSpec(algo="OMS", iters=8, early_term=True), mesh
    )
    chan = AwgnChannel(code.N, code.K, ChannelSpec())
    bers = []
    for snr in (1.0, 2.5):
        chan.configure(snr)
        a = ErrorAnalyzer(n=code.N, k=code.K)
        for k in range(3):
            llr = chan.generate_zero_int8(
                jax.random.fold_in(jax.random.key(9), k), 64
            )
            _, _, be, fe = step(llr)
            a.add_counts(64, int(be), int(fe))
        bers.append(a.ber)
    assert bers[1] < bers[0]  # waterfall across the mesh
