"""SNR sweep driver — the reference's L5 main loop, re-expressed.

Covers the simulation drivers' behaviour (``code/gpu_fixed/main.cpp:237-337``,
``code/ldpc_decoder_arm/main.cpp:373-626``): sweep Eb/N0 from min to max in
steps; per point, generate-encode-channel-decode-count batches until the
adaptive FE limit, a frame budget, or a wall-clock budget is reached; stop
the whole sweep at a quasi-error-free FER (``-qef``,
``code/gpu_fixed/main.cpp:331-336``).

Additions over the reference (SURVEY §5.3/5.4): deterministic
checkpoint/resume — per-point counters and the PRNG fold state persist to
JSON after every batch window, so a killed sweep resumes mid-point with
bit-identical results; structured JSONL metrics.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from collections import deque
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..channel.awgn import (
    AwgnChannel,
    ChannelSpec,
    _generate_int8 as _gen_int8,
    _generate_zero_int8 as _gen_zero,
)
from ..channel.bitgen import generate_info_bits
from ..channel.encoder import FakeEncoder, make_encoder
from ..codes.registry import load_code
from ..decoder import make_decoder
from ..ops.layered import LayeredSpec
from ..quant import QuantSpec
from .analyzer import ErrorAnalyzer, count_errors_async
from .terminal import Terminal

__all__ = ["SweepConfig", "SnrPoint", "SweepResult", "run_sweep"]


@dataclasses.dataclass(frozen=True)
class SweepConfig:
    code: str = "1944x972"
    algo: str = "OMS"  # MS | OMS | NMS | 2NMS
    iters: int = 10
    offset: int = 1
    nms_f: int = 24  # NMS factor, 1/32 units (`-NMS <f>`; x86 default 29)
    nms_f2: int = 28  # 2NMS second factor
    early_term: bool = True
    minclamp: str = "pre"
    schedule: str = "auto"

    snr_min: float = 0.5
    snr_max: float = 4.0
    snr_step: float = 0.25
    es_n0: bool = False
    qpsk: bool = False
    norm_channel: bool = False
    fading: str = "none"  # none | rayleigh (-Rayleigh_Fading)
    opt_llr: bool = False  # -ollr: sigma-adaptive LLR quantizer scale
    no_channel: bool = False  # -no-channel: noiseless perfect LLRs
    inject_flip_p: float = 0.0  # LLR sign-flip fault-injection probability
    count_bits: str = "all"  # all (-wc_fer/GPU analyzer) | info (x86 analyzer)

    batch: int = 1024  # frames per decode call (-n)
    max_fe: int = 100  # FE limit (-fer)
    auto_fe: bool = True
    max_frames: int = 10_000_000  # per-point frame budget
    timer_s: Optional[float] = None  # per-point wall budget (-timer)
    qef_fer: Optional[float] = None  # sweep cutoff (-qef)
    pipeline_depth: int = 2  # batches kept in flight (multi-stream analogue)
    # sim steps folded into ONE executable via lax.scan (fake-encoder
    # jitted path only — the coded path stages host-encoded bits and the
    # native path never dispatches); folding S steps amortizes the
    # per-dispatch cost S-fold.  Batch k's channel key stays
    # fold_in(fold_in(seed, point), k), so counters are bit-identical
    # for any scan_steps (tests/test_sweep_scan.py pins this).
    scan_steps: int = 1

    backend: str = "auto"  # auto | pallas | xla | native
    # channel generator for backend='native': 'threefry' replays the jax
    # channel exactly (counters bit-match a backend='auto' sweep);
    # 'philox' uses the native counter-based generator (~7x faster wall
    # clock, statistically identical stream — for deep-tail top-ups)
    channel_rng: str = "threefry"
    encoder: str = "fake"  # fake | table | staircase | gf2 | auto
    random_bits: bool = True  # -random (ignored for fake encoder)
    quant_factor: int = 8
    bits_llr: int = 6
    var_bits: int = 8  # -var: APP quantizer width -> sat 2^(b-1)-1
    msg_bits: int = 6  # -msg: message quantizer width

    seed: int = 1234  # reference channel seed default

    checkpoint: Optional[str] = None
    metrics: Optional[str] = None


@dataclasses.dataclass
class SnrPoint:
    snr_db: float
    frames: int
    be: int
    fe: int
    ber: float
    fer: float
    mbps: float
    runtime_s: float
    batches: int = 0


@dataclasses.dataclass
class SweepResult:
    config: SweepConfig
    points: list[SnrPoint]


def _snr_grid(cfg: SweepConfig) -> list[float]:
    pts = []
    s = cfg.snr_min
    while s <= cfg.snr_max + 1e-9:
        pts.append(round(s, 6))
        s += cfg.snr_step
    return pts


def _load_ckpt(path: Optional[str]) -> dict:
    if path and os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {"done": {}, "partial": None}


def _save_ckpt(path: Optional[str], state: dict) -> None:
    if not path:
        return
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(state, f)
    os.replace(tmp, path)


def run_sweep(
    cfg: SweepConfig,
    progress: bool = True,
    on_point: Optional[Callable[[SnrPoint], None]] = None,
) -> SweepResult:
    code = load_code(cfg.code)
    quant = QuantSpec(factor=cfg.quant_factor, bits_llr=cfg.bits_llr)
    chan_spec = ChannelSpec(
        qpsk=cfg.qpsk, es_n0=cfg.es_n0, normalize=cfg.norm_channel,
        fading=cfg.fading, opt_llr=cfg.opt_llr, no_channel=cfg.no_channel,
        inject_flip_p=cfg.inject_flip_p, quant=quant,
    )
    channel = AwgnChannel(code.N, code.K, chan_spec)
    encoder = make_encoder(code, cfg.encoder)
    spec = LayeredSpec(
        algo=cfg.algo,
        iters=cfg.iters,
        offset=cfg.offset,
        nms_f=cfg.nms_f,
        nms_f2=cfg.nms_f2,
        early_term=cfg.early_term,
        minclamp=cfg.minclamp,
        schedule=cfg.schedule,
        sat_var=(1 << (cfg.var_bits - 1)) - 1,
        sat_msg=(1 << (cfg.msg_bits - 1)) - 1,
    )
    use_native = cfg.backend == "native"
    if use_native:
        # AVX-512 host decoder (golden/native.py): ~20-50x the XLA CPU
        # path, which makes deep-tail Monte-Carlo feasible.  Guard rails:
        # it decodes the ORIGINAL H in the SAME check order as the jitted
        # decoder would (schedule-view code below), and batch 0 of every
        # point is cross-decoded by the jitted path and asserted
        # bit-identical — so native-measured points can extend
        # jitted-path curves without mixing estimators.
        from ..codes.code import DegreeClass
        from ..codes.schedule import build_layers
        from ..decoder import effective_code
        from ..golden import GoldenParams
        from ..golden.native import (
            awgn_quantize_native,
            decode_simd_native,
            simd_available,
        )

        assert simd_available(), (
            "backend='native' needs the AVX-512 liboracle build"
        )
        assert effective_code(code) is code, (
            f"{code.name}: backend='native' is not available for QC-view "
            "staircase codes (the jitted paths decode the permuted QC "
            "view in a different check order; use backend='auto')"
        )
        from ..codes.code import LdpcCode as _LC

        _layers = build_layers(code, spec.schedule)
        sched_view = _LC(
            name=code.name + "-sched", N=code.N, K=code.K,
            classes=tuple(
                DegreeClass(l.deg, l.idx.shape[0]) for l in _layers
            ),
            class_idx=tuple(l.idx for l in _layers),
        )
        gp = GoldenParams(
            algo=cfg.algo, iters=cfg.iters, offset=cfg.offset,
            nms_factor=cfg.nms_f / 32.0, nms_factor2=cfg.nms_f2 / 32.0,
            early_term=cfg.early_term, minclamp=cfg.minclamp,
            sat_var=(1 << (cfg.var_bits - 1)) - 1,
            sat_msg=(1 << (cfg.msg_bits - 1)) - 1,
        )
        decoder = make_decoder(code, spec, backend="auto")  # cross-check

        def native_decode(llr_np):
            return decode_simd_native(sched_view, llr_np, gp)

        # native Philox channel (C2 analogue) wherever the spec allows;
        # jax threefry channel otherwise (fading/normalize/injection).
        # The streams differ but are statistically identical (pinned by
        # tests); either way the decode is bit-checked per point.
        native_chan = (
            cfg.channel_rng == "philox"
            and chan_spec.fading == "none" and not chan_spec.normalize
            and not chan_spec.no_channel and chan_spec.inject_flip_p == 0.0
        )
        native_amp = (1.0 / math.sqrt(2.0)) if cfg.qpsk else 1.0
    else:
        decoder = make_decoder(code, spec, backend=cfg.backend)
    is_fake = isinstance(encoder, FakeEncoder)

    base_key = jax.random.key(cfg.seed)
    metrics_f = open(cfg.metrics, "a") if cfg.metrics else None
    ckpt = _load_ckpt(cfg.checkpoint)

    # The whole batch — channel generation, decode, error count — is ONE
    # jitted function: fused on device (no intermediate materialization)
    # and, crucially for remote backends, a single executable whose
    # persistent-cache key doesn't depend on device-array layouts produced
    # by other jitted calls.  sigma/factor are traced scalars, so one
    # executable serves every SNR point.
    info_only = cfg.count_bits == "info"

    @jax.jit
    def sim_step_fake(key, sigma_t, factor_t):
        llr = _gen_zero(key, (cfg.batch, code.N), sigma_t, factor_t,
                        chan_spec)
        decoded, _ = decoder(llr)
        return count_errors_async(decoded, info_only=info_only, k=code.K)

    scan_n = max(1, cfg.scan_steps)

    @jax.jit
    def sim_step_fake_scan(pkey, k0, sigma_t, factor_t):
        # scan_n batches in ONE executable; pkey = fold_in(seed, point)
        # comes in as an argument so one executable serves every point
        def body(carry, k):
            key = jax.random.fold_in(pkey, k)
            llr = _gen_zero(key, (cfg.batch, code.N), sigma_t, factor_t,
                            chan_spec)
            decoded, _ = decoder(llr)
            be, fe = count_errors_async(
                decoded, info_only=info_only, k=code.K
            )
            return carry, jnp.stack([be, fe])

        _, cs = jax.lax.scan(
            body, 0, k0 + jnp.arange(scan_n, dtype=jnp.int32)
        )
        return cs  # [scan_n, 2]

    @jax.jit
    def sim_step_coded(key, sigma_t, factor_t, coded):
        llr = _gen_int8(key, coded, sigma_t, factor_t, chan_spec)
        decoded, _ = decoder(llr)
        return count_errors_async(
            decoded, reference=coded.astype(jnp.uint8),
            info_only=info_only, k=code.K,
        )

    points: list[SnrPoint] = []
    for pi, snr in enumerate(_snr_grid(cfg)):
        key_snr = str(snr)
        if key_snr in ckpt["done"]:
            d = ckpt["done"][key_snr]
            points.append(SnrPoint(**d))
            continue
        sigma = channel.configure(snr)
        analyzer = ErrorAnalyzer(
            n=code.N, k=code.K, max_fe=cfg.max_fe, auto_fe=cfg.auto_fe,
            counted_bits=code.K if info_only else code.N,
        )
        batch_idx = 0
        resumed_elapsed = 0.0
        part = ckpt.get("partial")
        if part and part.get("snr") == key_snr:
            analyzer.add_counts(part["frames"], part["be"], part["fe"])
            batch_idx = part["batches"]
            # carry the pre-kill wall time so resumed rates/runtime_s stay
            # honest (dividing pre-resume frames by post-resume elapsed
            # would inflate mbps/FPM)
            resumed_elapsed = float(part.get("elapsed_s", 0.0))
        term = Terminal(
            analyzer, snr, metrics=metrics_f, start_elapsed=resumed_elapsed
        )

        # Pipelined dispatch (the reference's omp-sections overlap of
        # error counting with next-batch noise generation, main.cpp:271-281,
        # generalised): keep `pipeline_depth` batches in flight on device
        # and only fetch the oldest batches' counters — one host round trip
        # per fetch window, fully overlapped with compute.  Batch k's
        # channel key is fold_in(fold_in(seed, point), k), so dispatch
        # order never affects results and a resume re-dispatches
        # deterministically.
        xchecked = [False]
        point_key = jax.random.fold_in(base_key, pi)
        # group size per dispatch: scan-folded on the jitted fake path
        grp = scan_n if (is_fake and not use_native) else 1

        def dispatch(k: int):
            key = jax.random.fold_in(jax.random.fold_in(base_key, pi), k)
            if is_fake:
                if not use_native:
                    if grp > 1:
                        return sim_step_fake_scan(
                            point_key, jnp.asarray(k, jnp.int32),
                            channel.sigma, channel.factor,
                        )
                    return sim_step_fake(key, channel.sigma, channel.factor)
                coded = None
                if native_chan:
                    llr = awgn_quantize_native(
                        cfg.seed, (pi << 32) | k, cfg.batch, code.N,
                        sigma=channel.sigma, factor=channel.factor,
                        sat=quant.sat, amp=native_amp,
                    )
                else:
                    llr = np.asarray(_gen_zero(
                        key, (cfg.batch, code.N), channel.sigma,
                        channel.factor, chan_spec,
                    ))
            else:
                rng = np.random.default_rng((cfg.seed, pi, k))
                info = generate_info_bits(
                    rng, cfg.batch, code.K, cfg.random_bits
                )
                coded = encoder.encode(info)
                if not use_native:
                    return sim_step_coded(
                        key, channel.sigma, channel.factor, coded
                    )
                if native_chan:
                    llr = awgn_quantize_native(
                        cfg.seed, (pi << 32) | k, cfg.batch, code.N,
                        sigma=channel.sigma, factor=channel.factor,
                        sat=quant.sat, coded=coded, amp=native_amp,
                    )
                else:
                    llr = np.asarray(_gen_int8(
                        key, coded, channel.sigma, channel.factor, chan_spec
                    ))
            bits, _ = native_decode(llr)
            if not xchecked[0]:
                # once per point: the jitted path must produce EXACTLY
                # these bits, or the native point would extend the curve
                # with a different decoder's statistics
                ref_bits, _ = decoder(llr)
                if not np.array_equal(np.asarray(ref_bits, np.int8), bits):
                    raise AssertionError(
                        f"{code.name}: native decode diverges from the "
                        "jitted path on batch 0 — refusing to measure"
                    )
                xchecked[0] = True
            err = (bits != 0) if coded is None else (bits != coded)
            if info_only:
                err = err[:, : code.K]
            be_pf = err.sum(axis=1)
            return int(be_pf.sum()), int((be_pf != 0).sum())

        debug_t = os.environ.get("LDPC_DEBUG_TIMING") == "1"
        depth = max(1, cfg.pipeline_depth)
        inflight: deque = deque()
        next_k = batch_idx
        stop = False
        while not stop or inflight:
            t_disp = time.perf_counter()
            while not stop and len(inflight) < depth:
                inflight.append(dispatch(next_k))
                next_k += grp
            t_fetch = time.perf_counter()
            # fetch the oldest half of the window in ONE host transfer
            # (each scalar fetch costs a full round trip on remote
            # backends; stacking on device first amortizes it)
            n_fetch = max(1, len(inflight) // 2) if not stop else len(inflight)
            group = [inflight.popleft() for _ in range(n_fetch)]
            if use_native:  # host ints already; nothing to fetch
                stacked = np.asarray(group, dtype=np.int64)
            elif grp > 1:  # scan-folded: each item is already [grp, 2]
                stacked = np.asarray(jnp.concatenate(group, axis=0))
            else:
                stacked = np.asarray(
                    jnp.stack([jnp.stack([be, fe]) for be, fe in group])
                )
            for be_i, fe_i in stacked:
                analyzer.add_counts(cfg.batch, int(be_i), int(fe_i))
                batch_idx += 1
            if debug_t:
                print(
                    f"(DBG) window: dispatch {1e3*(t_fetch-t_disp):.1f} ms, "
                    f"fetch {1e3*(time.perf_counter()-t_fetch):.1f} ms "
                    f"({len(stacked)} batches)"
                )
            if progress:
                term.temp_report()
            ckpt["partial"] = {
                "snr": key_snr,
                "frames": analyzer.frames,
                "be": analyzer.bit_errors,
                "fe": analyzer.frame_errors,
                "batches": batch_idx,
                "elapsed_s": term.elapsed(),
            }
            _save_ckpt(cfg.checkpoint, ckpt)
            if (
                analyzer.fe_limit_achieved()
                or analyzer.frames >= cfg.max_frames
                or (cfg.timer_s is not None and term.elapsed() >= cfg.timer_s)
            ):
                stop = True
        rec = term.final_report()
        point = SnrPoint(
            snr_db=snr,
            frames=analyzer.frames,
            be=analyzer.bit_errors,
            fe=analyzer.frame_errors,
            ber=analyzer.ber,
            fer=analyzer.fer,
            mbps=rec["mbps"],
            runtime_s=rec["runtime_s"],
            batches=batch_idx,
        )
        points.append(point)
        ckpt["done"][key_snr] = dataclasses.asdict(point)
        ckpt["partial"] = None
        _save_ckpt(cfg.checkpoint, ckpt)
        if on_point:
            on_point(point)
        if cfg.qef_fer is not None and point.fer < cfg.qef_fer:
            break
    if metrics_f:
        metrics_f.close()
    return SweepResult(config=cfg, points=points)
