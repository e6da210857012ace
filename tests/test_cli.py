"""CLI end-to-end tests against a locally-created tiny HF checkpoint."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    """A tiny random OPT checkpoint saved in HF format (offline-safe)."""
    from transformers import OPTConfig, OPTForCausalLM

    d = tmp_path_factory.mktemp("opt-tiny")
    cfg = OPTConfig(vocab_size=128, hidden_size=32, ffn_dim=64,
                    num_hidden_layers=2, num_attention_heads=4,
                    max_position_embeddings=64, word_embed_proj_dim=32)
    torch.manual_seed(0)
    OPTForCausalLM(cfg).save_pretrained(d, safe_serialization=True)
    return str(d)


@pytest.fixture(scope="module")
def tokens_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("tokens")
    path = os.path.join(d, "tokens.npy")
    np.save(path, np.random.default_rng(0).integers(0, 128, size=(4096,)).astype(np.int32))
    return path


def test_quantize_bmm_input_flag_tristate():
    # regression (ADVICE r1): the flag used to be store_true with default
    # True — impossible to disable.  Now tri-state with per-arch defaults.
    from smoothquant_tpu.cli.ppl_eval import build_parser

    p = build_parser()
    base = ["--model_path", "x"]
    assert p.parse_args(base).quantize_bmm_input is None
    assert p.parse_args(base + ["--quantize_bmm_input"]).quantize_bmm_input is True
    assert p.parse_args(base + ["--no-quantize_bmm_input"]).quantize_bmm_input is False


def test_hf_import_loads_tiny_opt(tiny_ckpt):
    from smoothquant_tpu.utils.hf_import import detect_arch, load_model

    assert detect_arch(tiny_ckpt) == "opt"
    arch, cfg, params = load_model(tiny_ckpt, dtype="float32")
    assert arch == "opt" and cfg.hidden_size == 32
    assert params["embed_tokens"]["weight"].shape == (128, 32)


def test_hf_import_matches_hf_forward(tiny_ckpt):
    import jax.numpy as jnp
    from transformers import OPTForCausalLM

    from smoothquant_tpu.models import opt as jopt
    from smoothquant_tpu.utils.hf_import import load_model

    _, cfg, params = load_model(tiny_ckpt, dtype="float32")
    hf = OPTForCausalLM.from_pretrained(tiny_ckpt).eval()
    ids = np.random.default_rng(1).integers(0, 128, size=(1, 12))
    with torch.no_grad():
        ref = hf(torch.tensor(ids)).logits.float().numpy()
    got, _ = jopt.forward(params, jnp.asarray(ids), cfg)
    np.testing.assert_allclose(np.asarray(got), ref, atol=2e-4, rtol=2e-3)


def test_ppl_eval_cli(tiny_ckpt, tokens_file, capsys):
    from smoothquant_tpu.cli.ppl_eval import main

    main(["--model_path", tiny_ckpt, "--tokens_path", tokens_file,
          "--n_samples", "2", "--window", "64", "--dtype", "float32",
          "--quantize", "--quant_bits", "8", "--json"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["ppl"] > 0 and np.isfinite(out["ppl"])


def test_generate_act_scales_then_smooth_eval(tiny_ckpt, tokens_file, tmp_path, capsys):
    from smoothquant_tpu.cli.generate_act_scales import main as gen_main
    from smoothquant_tpu.cli.ppl_eval import main as ppl_main

    scales_path = str(tmp_path / "scales.npz")
    gen_main(["--model_path", tiny_ckpt, "--tokens_path", tokens_file,
              "--output_path", scales_path, "--num_samples", "2",
              "--seq_len", "64", "--dtype", "float32"])
    assert os.path.exists(scales_path)

    ppl_main(["--model_path", tiny_ckpt, "--tokens_path", tokens_file,
              "--n_samples", "2", "--window", "64", "--dtype", "float32",
              "--smooth", "--act_scales_path", scales_path, "--json"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["smooth"] is True and np.isfinite(out["ppl"])


def test_export_int8_roundtrip(tiny_ckpt, tokens_file, tmp_path):
    import jax.numpy as jnp

    from smoothquant_tpu.cli.export_int8_model import main as export_main
    from smoothquant_tpu.models import opt_int8
    from smoothquant_tpu.utils.checkpoint import load_int8_opt

    out_path = str(tmp_path / "int8_opt.npz")
    export_main(["--model_path", tiny_ckpt, "--tokens_path", tokens_file,
                 "--output_path", out_path, "--num_samples", "2",
                 "--seq_len", "64"])
    cfg, int8_params = load_int8_opt(out_path)
    assert len(int8_params["int8_layers"]) == cfg.num_hidden_layers
    ids = np.random.default_rng(2).integers(0, 128, size=(1, 8))
    logits, _ = opt_int8.forward(int8_params, jnp.asarray(ids), cfg)
    assert np.all(np.isfinite(np.asarray(logits)))


def test_run_experiments_cli(tiny_ckpt, tokens_file, tmp_path, capsys):
    from smoothquant_tpu.cli.run_experiments import main

    outdir = str(tmp_path / "figs")
    main(["--model_path", tiny_ckpt, "--tokens_path", tokens_file,
          "--group_sizes", "16", "32", "--salient_props", "0.0", "0.1",
          "--n_samples", "1", "--window", "64", "--calib_samples", "2",
          "--calib_seq_len", "64", "--output_dir", outdir,
          "--dtype", "float32"])
    results = json.load(open(os.path.join(outdir, "results.json")))["results"]
    assert len(results) == 4
    assert all(np.isfinite(r["ppl"]) for r in results)
    # size accounting must be monotone in salient_prop
    s0 = [r for r in results if r["salient_prop"] == 0.0][0]["size_mib"]
    s1 = [r for r in results if r["salient_prop"] == 0.1][0]["size_mib"]
    assert s1 > s0
