"""tools/fuzz_checkpoint.py (the port's crash-recovery fuzzer) against the
JAX package's scripts/fuzz_checkpoint.py: the same kill modes named by
the same model-checker transitions, the same uninterrupted oracle streams
for the same seed and weights (carried across by params_from_jax), and
one seed of every mode exact, killed and leak-free at the JAX fuzzer's
MODEL_SPEC on the CPU.  The card's run is in tests/test_torch_cuda.py and
chip_smoke.py's fuzz phase."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from burst_attn_tpu.analysis import modelcheck as jax_mc
from burst_attn_tpu.loadgen.worker import build_engine as jax_build_engine
from burst_attn_tpu.models import ModelConfig as JModelConfig
from burst_attn_tpu.models import init_params as j_init_params

from burst_attn_tpu_torch.analysis import modelcheck as mc
from burst_attn_tpu_torch.models.transformer import (
    ModelConfig, params_from_jax,
)

ROOT = Path(__file__).resolve().parents[1]


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


fz = _load("tools/fuzz_checkpoint.py", "port_fuzz_checkpoint")
jfz = _load("scripts/fuzz_checkpoint.py", "jax_fuzz_checkpoint")


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def cpu_model():
    return fz.load_model("cpu")


def test_kill_modes_and_labels_equal_the_jax_fuzzers():
    assert fz.KILL_POINTS == jfz.KILL_POINTS
    assert fz.PIPELINE_KILL_POINTS == jfz.PIPELINE_KILL_POINTS
    assert fz.checker_kill_modes() == jfz.checker_kill_modes()
    assert fz.pipeline_kill_modes() == jfz.pipeline_kill_modes()
    for models in ((mc.pool_model(), jax_mc.pool_model()),):
        vocab, jvocab = (m.event_vocabulary(x) for m, x in
                         zip((mc, jax_mc), models))
        assert set(fz.KILL_POINTS.values()) <= set(vocab) & set(jvocab)
    vocab = mc.event_vocabulary(mc.journal_model())
    jvocab = jax_mc.event_vocabulary(jax_mc.journal_model())
    assert set(fz.PIPELINE_KILL_POINTS.values()) <= set(vocab) & set(jvocab)
    assert fz.MODEL_SPEC == jfz.MODEL_SPEC
    assert fz.ENGINE_SPEC == jfz.ENGINE_SPEC
    assert fz.CACHE_ENGINE_SPEC == jfz.CACHE_ENGINE_SPEC
    assert fz.PIPE_ENGINE_SPEC == jfz.PIPE_ENGINE_SPEC


def test_oracle_streams_equal_the_jax_fuzzers():
    """run_seed's uninterrupted oracle, JAX's engine and the port's on the
    same seed's workload and the same weights (fp32, token-exact)."""
    spec = dict(jfz.MODEL_SPEC)
    seed = spec.pop("seed")
    jcfg = JModelConfig(attn_backend="jnp", remat=False, dtype=jnp.float32,
                        batch_axis=None, head_axis=None, **spec)
    jparams = j_init_params(jax.random.PRNGKey(seed), jcfg)
    cfg = ModelConfig(remat=False, dtype=torch.float32, batch_axis=None,
                      head_axis=None, **spec)
    model = fz.FuzzModel(params_from_jax(jax.tree_util.tree_map(
        np.asarray, jparams), device="cpu"), cfg, torch.device("cpu"))
    prompts, budgets, _ = fz.seed_workload(0, 4)
    want = {}
    jeng = jax_build_engine(jfz.MODEL_SPEC, jfz.ENGINE_SPEC)
    fz.submit_all(jeng, prompts, budgets)
    fz.drive(jeng, len(prompts), want)
    got, _ = fz.oracle_streams(model, prompts, budgets)
    assert got == want and len(got) == 4


def test_one_seed_of_every_mode_on_the_cpu(cpu_model, tmp_path):
    sync = fz.run_seed(0, 4, str(tmp_path), cpu_model)
    cache = fz.run_cache_seed(0, 4, str(tmp_path), cpu_model)
    pipe = fz.run_pipeline_seed(0, 4, str(tmp_path), cpu_model)
    modes = {**{k: sync[k] for k in ("snapshot+journal", "journal-only")},
             **cache, **pipe}
    assert len(modes) == 8
    for name, r in modes.items():
        assert fz.mode_ok(r), (name, r)
    assert sync["snapshot+journal"]["strict"]
    # the kill landed between the token bytes and their scales
    assert cache["mid-scale-scatter"]["torn"] is True
    st = fz.run_transport_seed(0)
    assert st["crc_rejected"] > 0 and st["resent"] > 0


def test_serve_engine_seed_on_the_cpu(cpu_model, tmp_path):
    r = fz.run_seed(0, 4, str(tmp_path), cpu_model, kind="legacy")
    assert all(fz.mode_ok(r[k]) for k in ("snapshot+journal",
                                          "journal-only"))


def test_the_cli_on_the_cpu_and_without_a_card(capsys):
    assert fz.main(["--device", "cpu", "--seeds", "1", "--cache-seeds", "0",
                    "--transport-seeds", "1"]) == 0
    out = capsys.readouterr().out
    assert "seed=0 snapshot+journal: OK" in out
    assert "transport seed=0: OK" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fz.main(["--seeds", "1"])
