"""Test configuration: force an 8-device virtual CPU mesh.

The tests run on the CPU.  Kernels run in the Pallas interpreter where a
test passes interpret=True; everything else takes the plain XLA route.
jax.config.update("jax_platforms", ...) forces the CPU backend even when
jax was imported before this file (backends initialize lazily, so XLA_FLAGS
set here is still honored for the device count).  Tests that need a GPU
carry the `gpu` marker and skip here (see the `gpu` fixture below).
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

assert jax.devices()[0].platform == "cpu", (
    "tests must run on the virtual CPU mesh, got " + jax.devices()[0].platform
)

import pytest  # noqa: E402

# ---------------------------------------------------------------------------
# Slow-test tiering: the full suite is ~20 CPU-minutes, dominated by
# model-level integration tests.  Each feature
# keeps a fast representative in the default selection; the heavyweight
# variants are marked `slow` and deselected by default (pyproject addopts
# -m "not slow").  Full suite: pytest -m "slow or not slow".
# Keyed by (module basename, test function name) — all parametrizations.
# ---------------------------------------------------------------------------

_SLOW = {
    # per-arch prefetch-scan sweeps (gate tests stay as fast representatives)
    ("test_prefetch_scan_archs.py", "test_falcon_prefetch_matches_per_layer"),
    ("test_prefetch_scan_archs.py", "test_bloom_prefetch_matches_per_layer"),
    ("test_prefetch_scan_mixtral.py",
     "test_mixtral_prefetch_matches_per_layer"),
    ("test_prefetch_scan.py",
     "test_prefetch_decode_matches_per_layer"),  # [True] kept below
    # model-level decode integrations of opt-in / already-unit-tested kernels
    ("test_fused_projections.py", "test_fused_prefetch_decode"),
    ("test_shared_basis.py", "test_shared_basis_packed_lm_head_and_decode"),
    ("test_identity_pack.py", "test_model_decode_with_identity_o_proj"),
    ("test_sliding_window.py", "test_stacked_scan_decode_respects_window"),
    ("test_opt_prefetch.py", "test_opt_prefetch_decode_parity"),
    ("test_opt_prefetch.py", "test_opt_fused_fold_flat_parity"),
    ("test_fp_decode.py", "test_fp_prefetch_decode_parity"),
    # serving / TP variants (one fast representative each stays)
    ("test_serve.py", "test_mixed_buckets_batched_admission"),
    ("test_serve.py", "test_greedy_matches_full_forward"),
    ("test_serve.py", "test_chunked_matches_oracle_mixed_lengths"),
    ("test_promote_int8.py", "test_generator_with_promoted_prefill_params"),
    ("test_tp_packed.py", "test_tp_decode_with_sharded_kv_cache"),
    ("test_tp_packed.py", "test_generator_over_tp_decode"),
    ("test_tp_packed.py", "test_exact_vs_single_chip_unsorted_groups"),
    ("test_opt_int8.py", "test_int8_cached_decode_matches_teacher_forced"),
}
_SLOW_KEEP_PARAMS = {
    # quant_kv=True is the flagship-bench configuration — keep it fast
    ("test_prefetch_scan.py",
     "test_prefetch_decode_matches_per_layer"): "[True]",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        key = (item.path.name, item.originalname or item.name)
        if key in _SLOW:
            keep = _SLOW_KEEP_PARAMS.get(key)
            if keep is not None and item.name.endswith(keep):
                continue
            item.add_marker(pytest.mark.slow)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Drop compiled-executable caches after every test module.

    The full suite accumulates hundreds of interpret-mode Pallas programs
    and CPU XLA executables in one process; past ~285 tests that state
    made the CPU client segfault.  Per-module cache clearing bounds the
    accumulation; module-scoped fixtures re-jit at worst once per
    module."""
    yield
    jax.clear_caches()


@pytest.fixture
def gpu():
    """Skip unless JAX sees a GPU.  Decided here, at test time, never while
    a module is imported: every pytest-xdist worker must collect the same
    tests.  This suite pins the CPU, so `gpu` tests skip in it; on a card,
    `python chip_smoke.py` runs the same checks compiled."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (compiled Triton kernels)")
