"""CLI argument surface tests (the reference's flag union, SURVEY §5.6)."""

from ldpcgputegra.sim.cli import build_parser, config_from_args


def test_full_flag_surface_parses():
    args = build_parser().parse_args([
        "--code", "2304x1152", "--algo", "NMS", "--iters", "8",
        "--offset", "2", "--no-early-term", "--minclamp", "post",
        "--schedule", "colored", "--backend", "xla",
        "--min", "1.0", "--max", "3.5", "--step", "0.5",
        "--es-n0", "--qpsk", "--norm-channel", "--rayleigh",
        "--batch", "512", "--fer", "50", "--no-auto-fe",
        "--max-frames", "100000", "--timer", "30", "--qef", "1e-7",
        "--pipeline", "4",
        "--encoder", "gf2", "--all-zero-bits",
        "--llr-factor", "4", "--llr-bits", "5",
        "--var-bits", "7", "--msg-bits", "5", "--ollr", "--info-ber",
        "--seed", "99", "--checkpoint", "/tmp/x.json",
        "--metrics", "/tmp/m.jsonl", "--quiet",
    ])
    cfg = config_from_args(args)
    assert cfg.code == "2304x1152" and cfg.algo == "NMS"
    assert cfg.iters == 8 and cfg.offset == 2 and not cfg.early_term
    assert cfg.minclamp == "post" and cfg.schedule == "colored"
    assert cfg.backend == "xla"
    assert (cfg.snr_min, cfg.snr_max, cfg.snr_step) == (1.0, 3.5, 0.5)
    assert cfg.es_n0 and cfg.qpsk and cfg.norm_channel
    assert cfg.fading == "rayleigh" and cfg.opt_llr
    assert cfg.batch == 512 and cfg.max_fe == 50 and not cfg.auto_fe
    assert cfg.max_frames == 100000 and cfg.timer_s == 30
    assert cfg.qef_fer == 1e-7 and cfg.pipeline_depth == 4
    assert cfg.encoder == "gf2" and not cfg.random_bits
    assert cfg.quant_factor == 4 and cfg.bits_llr == 5
    assert cfg.var_bits == 7 and cfg.msg_bits == 5
    assert cfg.count_bits == "info"
    assert cfg.seed == 99


def test_defaults_match_reference_conventions():
    cfg = config_from_args(build_parser().parse_args([]))
    assert cfg.algo == "OMS" and cfg.iters == 10
    assert cfg.quant_factor == 8 and cfg.bits_llr == 6  # FACTEUR_BETA, 6-bit
    assert cfg.var_bits == 8 and cfg.msg_bits == 6
    assert cfg.seed == 1234  # the reference channel seed
    assert cfg.count_bits == "all"


def test_tfer_alias():
    cfg = config_from_args(build_parser().parse_args(["--tfer", "1e-5"]))
    assert cfg.qef_fer == 1e-5


def test_info_and_histo_smoke(capsys):
    from ldpcgputegra.sim.cli import _print_histo, _print_info, config_from_args, build_parser

    cfg = config_from_args(build_parser().parse_args(
        ["--code", "576x288", "--batch", "16"]))
    _print_info(cfg)
    out = capsys.readouterr().out
    assert "backend" in out and "N=576" in out
    _print_histo(cfg)
    out = capsys.readouterr().out
    assert "(HISTO) START" in out and "(HISTO) STOP" in out
